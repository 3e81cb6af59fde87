"""Bulk corpus synthesis (counterpart of `tools/synthesize_corpus.py`; the
reference's `inference_tts.py`).

  python -m emotivoice_tpu_torch.tools.synthesize_corpus --text-file lines.txt \
      --output-dir out/ [--checkpoint g_*] [--style-encoder ckpt --tokenizer dir] \
      [--dtype f32|bf16] [--batch-size 16] [--device cuda|cpu]

Takes a plain text file, one sentence per line, and runs the frontend
inline. Line i gets prompt `prompts[i % len(prompts)]` and speaker
`i % len(speakers)` (reference lines 98-101) and is written as
`{i:06d}.txt` (`speaker|prompt|text`, before g2p) and `{i:06d}.wav`. A line
whose wav exists is skipped (reference lines 107-109); a line whose g2p
fails is printed and skipped. Lines go through `SynthesisEngine` in batches
of --batch-size. Without --checkpoint the parameters are random, made from
seed 0; without --style-encoder the embeddings are zero (smoke mode). The
last line printed is a JSON summary: lines, rendered, skipped, audio
seconds, the wall seconds of the run and of its engine calls.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from emotivoice_tpu_torch.config import EmotiVoiceConfig

DEFAULT_PROMPTS = ["Happy", "Excited", "Sad", "Angry"]  # reference line 99


def model_config() -> EmotiVoiceConfig:
    """The model's config before the vocabulary sets its n_vocab."""
    return EmotiVoiceConfig()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--text-file", required=True, help="one sentence per line")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--checkpoint", default=None, help="reference g_* generator checkpoint")
    p.add_argument("--dtype", choices=["f32", "bf16"], default="f32",
                   help="compute dtype (parameters stay f32)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--style-encoder", default=None)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--tokenlist", default=None)
    p.add_argument("--lexicon", default=None)
    p.add_argument("--speakers", default=None)
    p.add_argument("--prompts", nargs="*", default=DEFAULT_PROMPTS)
    p.add_argument("--batch-size", type=int, default=16)
    args = p.parse_args(argv)

    from emotivoice_tpu_torch.frontend.en import read_lexicon
    from emotivoice_tpu_torch.frontend.mixed import g2p_cn_en
    from emotivoice_tpu_torch.frontend.tokens import load_label_list
    from emotivoice_tpu_torch.serving.engine import SynthesisEngine, SynthesisRequest
    from emotivoice_tpu_torch.serving.loading import (
        build_embed_fn,
        build_generator,
        config_and_vocab,
    )
    from emotivoice_tpu_torch.utils.audio_io import write_wav
    from emotivoice_tpu_torch.utils.device import use_exact_f32

    use_exact_f32(args.dtype)
    cfg, vocab = config_and_vocab(model_config(), args.tokenlist)
    lexicon = read_lexicon(args.lexicon) if args.lexicon else None
    speakers = (load_label_list(args.speakers) if args.speakers
                else [str(i) for i in range(cfg.am.n_speaker)])
    model = build_generator(cfg, args.checkpoint, 0)
    engine = SynthesisEngine(cfg, model, vocab, dtype=args.dtype, device=args.device)
    embed_fn = build_embed_fn(cfg, args.style_encoder, args.tokenizer, engine.device)
    os.makedirs(args.output_dir, exist_ok=True)

    stats = dict(lines=0, rendered=0, skipped_existing=0, g2p_failed=0, audio_s=0.0,
                 synth_s=0.0)
    pending, names = [], []

    def flush():
        if not pending:
            return
        t0 = time.perf_counter()
        results = engine.synthesize_batch(pending)
        stats["synth_s"] += time.perf_counter() - t0
        for name, res in zip(names, results):
            write_wav(os.path.join(args.output_dir, f"{name}.wav"), res.wav,
                      cfg.audio.sampling_rate)
            stats["rendered"] += 1
            stats["audio_s"] += len(res.wav) / cfg.audio.sampling_rate
        pending.clear()
        names.clear()

    start = time.perf_counter()
    with open(args.text_file, encoding="utf-8") as f:
        for i, line in enumerate(f):
            text = line.strip()
            if not text:
                continue
            stats["lines"] += 1
            name = f"{i:06d}"
            if os.path.exists(os.path.join(args.output_dir, f"{name}.wav")):
                stats["skipped_existing"] += 1
                continue
            prompt = args.prompts[i % len(args.prompts)]
            speaker = i % len(speakers)
            with open(os.path.join(args.output_dir, f"{name}.txt"), "w", encoding="utf-8") as t:
                t.write(f"{speakers[speaker]}|{prompt}|{text}\n")
            try:
                phonemes = g2p_cn_en(text, lexicon).split()
            except Exception as e:  # per-line fault tolerance (reference :151)
                print(f"skip line {i}: {e}")
                stats["g2p_failed"] += 1
                continue
            pending.append(SynthesisRequest(
                phonemes=phonemes, speaker_id=speaker,
                style_embedding=embed_fn(prompt), content_embedding=embed_fn(text),
            ))
            names.append(name)
            if len(pending) >= args.batch_size:
                flush()
    flush()
    stats["wall_s"] = time.perf_counter() - start
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
