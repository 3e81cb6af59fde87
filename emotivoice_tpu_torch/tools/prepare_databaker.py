"""DataBaker (BZNSYP) Chinese fine-tuning recipe: raw corpus -> 16 kHz
wavs and train/valid datalists (counterpart of `tools/prepare_databaker.py`;
the reference's `data/DataBaker/src/step{1,2}*.py`).

  python -m emotivoice_tpu_torch.tools.prepare_databaker --corpus BZNSYP \
      --output data/databaker [--skip-audio]

  - label pairs of `ProsodyLabeling/000001-010000.txt` parsed: a text line
    with `#N` prosody marks, then its pinyin line (reference step1:27-74);
  - erhua: a 儿 whose syllable is fused into the previous one is dropped
    (step1:57-64), with the reference's two hard-coded corpus fixes
    (005107 `ng1` -> `en1`, 002365 skipped; step1:46-49);
  - `#0..#4` -> `sp0..sp4`, pinyin split into initial and final by the
    frontend's `split_pinyin` (step2 `get_phoneme`), the trailing mark
    dropped and the whole wrapped in `<sos/eos>` (step1:86);
  - wavs resampled to 16 kHz through `utils/audio_io.resample` (the
    summary names the backend), unless --skip-audio;
  - prompt set to the original text; the last 3 utterances held out.
"""

from __future__ import annotations

import argparse
import json
import os
import re

PROSODY = {"#0": "sp0", "#1": "sp1", "#2": "sp2", "#3": "sp3", "#4": "sp4"}
PUNCT_RE = re.compile("[。，、“”？：……！（ ）—；]")


def parse_label_pair(text_line, pinyin_line):
    """One (text, pinyin) label pair -> pinyin syllables and prosody marks,
    with erhua fusion."""
    content = PUNCT_RE.sub("", text_line)
    chars, prosody = [], {}
    j = 0
    while j < len(content):
        if content[j] == "#":
            prosody[len(chars) - 1] = content[j:j + 2]
            j += 2
        else:
            chars.append(content[j])
            j += 1

    syllables = pinyin_line.split()
    s_index = 0
    tokens = []
    for k, ch in enumerate(chars):
        er_flag = False
        if ch == "儿" and (s_index == len(syllables) or not syllables[s_index].startswith("er")):
            er_flag = True  # erhua fused into the previous syllable
        else:
            tokens.append(syllables[s_index])
            s_index += 1
        if k in prosody:
            if er_flag:
                tokens[-1] = prosody[k]
            else:
                tokens.append(prosody[k])
        else:
            tokens.append("#0")
    return tokens


def tokens_to_phonemes(tokens):
    from emotivoice_tpu_torch.frontend.cn import split_pinyin

    phones = []
    for t in tokens:
        if t in PROSODY:
            phones.append(PROSODY[t])
        else:
            phones.extend(p for p in split_pinyin(t) if p)
    return phones


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--corpus", required=True, help="BZNSYP root dir")
    p.add_argument("--output", required=True)
    p.add_argument("--skip-audio", action="store_true", help="labels only (no wav resampling)")
    args = p.parse_args(argv)

    from emotivoice_tpu_torch.tools.prepare_ljspeech import resample_to_16k
    from emotivoice_tpu_torch.utils import native

    wav_dir = os.path.join(args.output, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    for sub in ("train", "valid"):
        os.makedirs(os.path.join(args.output, sub), exist_ok=True)

    with open(os.path.join(args.corpus, "ProsodyLabeling", "000001-010000.txt"),
              encoding="utf-8") as f:
        lines = f.readlines()
    records, resampled = [], 0
    for i in range(0, len(lines) - 1, 2):
        key = lines[i][:6]
        original_text = re.sub(r"#\d", "", lines[i][7:].strip())
        pinyin_line = lines[i + 1].strip()
        if key == "002365":  # corrupt corpus entry (reference step1:49)
            continue
        if key == "005107":
            pinyin_line = pinyin_line.replace(" ng1", " en1")
        try:
            phones = tokens_to_phonemes(parse_label_pair(lines[i][7:].strip(), pinyin_line))
        except (IndexError, KeyError) as e:
            print(f"skip {key}: {e}")
            continue
        src_wav = os.path.join(args.corpus, "Wave", f"{key}.wav")
        dst_wav = os.path.join(wav_dir, f"{key}.wav")
        if not args.skip_audio:
            if not os.path.exists(src_wav):
                print(f"missing wav {src_wav}")
                continue
            if not os.path.exists(dst_wav):
                resample_to_16k(src_wav, dst_wav)
                resampled += 1
        records.append({
            "key": key,
            "wav_path": os.path.abspath(dst_wav),
            "speaker": "BZNSYP",
            "text": ["<sos/eos>"] + phones[:-1] + ["<sos/eos>"],
            "original_text": original_text,
            "prompt": original_text,
        })

    for name, recs in (("train", records[:-3]), ("valid", records[-3:])):
        with open(os.path.join(args.output, name, "datalist.jsonl"), "w", encoding="utf-8") as f:
            for r in recs:
                f.write(json.dumps(r, ensure_ascii=False) + "\n")
    print(f"{len(records)} utterances -> {args.output} (train {len(records) - 3} / valid 3)")
    summary = {"utterances": len(records), "resampled": resampled,
               "resample_backend": native.backend()}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
