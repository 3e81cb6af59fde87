"""LJSpeech fine-tuning recipe: raw corpus -> 16 kHz wavs and train/valid
datalists (counterpart of `tools/prepare_ljspeech.py`; the reference's
`data/LJspeech/src/step{1,2}*.py`).

  python -m emotivoice_tpu_torch.tools.prepare_ljspeech --corpus LJSpeech-1.1 \
      --output data/ljspeech [--lexicon librispeech-lexicon.txt] [--valid-n 3]

  - wavs resampled to 16 kHz through `utils/audio_io.resample` (the native
    windowed-sinc, or scipy's polyphase without it; the summary names
    which), already-resampled ones kept;
  - English g2p with the sentence-final '.' / '?' kept (reference
    step2_get_phoneme.py:75-78), wrapped in `<sos/eos>`;
  - prompt set to the original text (step2:41);
  - the last --valid-n utterances held out (step2:116-123).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def resample_to_16k(src_path: str, dst_path: str):
    from emotivoice_tpu_torch.utils.audio_io import read_wav, resample, write_wav

    sr, wav = read_wav(src_path)
    write_wav(dst_path, np.clip(resample(wav, sr, 16000), -1.0, 1.0), 16000)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--corpus", required=True, help="LJSpeech-1.1 root")
    p.add_argument("--output", required=True)
    p.add_argument("--lexicon", default=None)
    p.add_argument("--speaker", default="0001", help="new voice speaker id")
    p.add_argument("--valid-n", type=int, default=3)
    args = p.parse_args(argv)

    from emotivoice_tpu_torch.frontend.en import get_eng_phoneme, read_lexicon
    from emotivoice_tpu_torch.utils import native

    lexicon = read_lexicon(args.lexicon) if args.lexicon else None
    wav_dir = os.path.join(args.output, "wavs_16k")
    os.makedirs(wav_dir, exist_ok=True)

    records, resampled = [], 0
    with open(os.path.join(args.corpus, "metadata.csv"), encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("|")
            if len(parts) < 3:
                continue
            key, text = parts[0], parts[2]
            src = os.path.join(args.corpus, "wavs", f"{key}.wav")
            if not os.path.exists(src):
                continue
            dst = os.path.join(wav_dir, f"{key}.wav")
            if not os.path.exists(dst):
                resample_to_16k(src, dst)
                resampled += 1
            mark = "?" if text.rstrip().endswith("?") else "."
            phonemes = get_eng_phoneme(text, lexicon, pad_sos_eos=False).split()
            records.append({
                "key": key,
                "wav_path": os.path.abspath(dst),
                "speaker": args.speaker,
                "text": ["<sos/eos>"] + phonemes + [mark, "<sos/eos>"],
                "original_text": text,
                "prompt": text,  # the reference initialises the prompt to the text
            })

    train, valid = records[:-args.valid_n], records[-args.valid_n:]
    for name, recs in (("train", train), ("valid", valid)):
        os.makedirs(os.path.join(args.output, name), exist_ok=True)
        path = os.path.join(args.output, name, "datalist.jsonl")
        with open(path, "w", encoding="utf-8") as f:
            for r in recs:
                f.write(json.dumps(r, ensure_ascii=False) + "\n")
        print(f"wrote {path} ({len(recs)} utterances)")
    summary = {"utterances": len(records), "resampled": resampled,
               "resample_backend": native.backend()}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
