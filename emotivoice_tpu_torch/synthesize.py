"""Batch synthesis CLI of the PyTorch port (counterpart of
`tools/synthesize.py`).

Reads lines of `speaker|prompt|phonemes|content` and writes one int16 wav
per line.

  python -m emotivoice_tpu_torch.synthesize --checkpoint <g_ckpt> \
      --style-encoder <checkpoint_163431> --tokenizer <simbert vocab dir> \
      --test-file lines.txt --output-dir out/ [--dtype f32|bf16] \
      [--device cuda|cpu]

Without --checkpoint the parameters are random, made from `--seed`; without
--style-encoder the style/content embeddings are zero (smoke mode).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", default=None, help="reference g_* generator checkpoint")
    p.add_argument("--style-encoder", default=None, help="reference style-encoder checkpoint")
    p.add_argument("--tokenizer", default=None, help="simbert tokenizer path")
    p.add_argument("--test-file", required=True)
    p.add_argument("--output-dir", default="outputs/test_audio")
    p.add_argument("--dtype", choices=["f32", "bf16"], default="f32",
                   help="compute dtype (parameters stay f32)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tokenlist", default=None)
    args = p.parse_args(argv)

    from emotivoice_tpu_torch.config import EmotiVoiceConfig
    from emotivoice_tpu_torch.serving.engine import SynthesisEngine, SynthesisRequest
    from emotivoice_tpu_torch.serving.loading import (
        build_embed_fn,
        build_generator,
        config_and_vocab,
    )
    from emotivoice_tpu_torch.utils.audio_io import write_wav
    from emotivoice_tpu_torch.utils.device import use_exact_f32

    use_exact_f32(args.dtype)
    cfg, vocab = config_and_vocab(EmotiVoiceConfig(), args.tokenlist)
    model = build_generator(cfg, args.checkpoint, args.seed)
    engine = SynthesisEngine(cfg, model, vocab, dtype=args.dtype, device=args.device)
    embed_fn = build_embed_fn(cfg, args.style_encoder, args.tokenizer, engine.device)

    requests, names = [], []
    with open(args.test_file, encoding="utf-8") as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            speaker, prompt, phonemes, content = line.split("|")
            requests.append(SynthesisRequest(
                phonemes=phonemes.split(),
                speaker_id=int(speaker) if speaker.isdigit() else 0,
                style_embedding=embed_fn(prompt), content_embedding=embed_fn(content),
                alpha=args.alpha,
            ))
            names.append(f"{i:04d}_{speaker}")

    os.makedirs(args.output_dir, exist_ok=True)
    for start in range(0, len(requests), args.batch_size):
        chunk = requests[start:start + args.batch_size]
        for name, res in zip(names[start:], engine.synthesize_batch(chunk)):
            out = os.path.join(args.output_dir, f"{name}.wav")
            write_wav(out, res.wav, cfg.audio.sampling_rate)
            print(f"wrote {out} ({len(res.wav) / cfg.audio.sampling_rate:.2f}s)")


if __name__ == "__main__":
    main()
