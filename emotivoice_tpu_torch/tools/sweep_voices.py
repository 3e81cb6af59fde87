"""Voice-matrix sweep: every speaker x style prompt through the engine
(counterpart of `tools/sweep_voices.py`).

  python -m emotivoice_tpu_torch.tools.sweep_voices [--checkpoint g_* | --train-ckpt DIR] \
      [--limit N] [--dtype bf16|f32] [--batch-size 16] [--min-peak X] [--out rows.jsonl] \
      [--save-wavs DIR] [--compare DIR] [--report summary.md] [--device cuda|cpu]

The reference ships 2,013 speaker IDs and round-robins four style prompts
in bulk synthesis (`inference_tts.py:98-101`), but has no harness over the
whole speaker x prompt matrix. This tool runs it in bucketed batches and
checks:

  - numerical health: every waveform finite, its peak recorded, and a cell
    whose peak is below --min-peak fails (use ~1e-4 with real weights;
    random parameters may be near-silent);
  - embedding-table coverage: every swept speaker id < n_speaker, every
    vocabulary id < n_vocab (on the card an out-of-range id would be a
    device-side assert, not a clear error);
  - per-cell RTF: the wall time of a group's second dispatch (the first,
    untimed, warms whatever bucket the group's durations select) over the
    group, per second of its audio.

--save-wavs keeps every waveform as `<speaker>_<prompt>.wav`; --compare DIR
reports each cell's MAE against the same-named wav in DIR. --train-ckpt
loads the generator of the newest checkpoint pair in a directory that the
port's trainer wrote (`training/loop.py`), with that checkpoint's table
sizes.
Without a style encoder each prompt gets a fixed pseudo-embedding made from
a CRC of its text, so style conditioning is exercised and the same in every
process.

Output: one JSON row per cell (--out) and a summary JSON line on stdout;
the exit code is 1 when a cell failed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib

import numpy as np

from emotivoice_tpu_torch.config import EmotiVoiceConfig

DEFAULT_PROMPTS = ["Happy", "Excited", "Sad", "Angry"]  # reference inference_tts.py:99
# A fixed utterance, so the sweep needs no lexicon or g2p dependency: ARPAbet
# tokens of the default inventory ("Happy new year").
DEFAULT_PHONEMES = (
    "<sos/eos> [HH] [AE1] [P] [IY0] engsp1 [N] [UW1] engsp1 "
    "[Y] [IH1] [R] <sos/eos>"
)


def model_config() -> EmotiVoiceConfig:
    """The model's config before the vocabulary (or a checkpoint's tables)
    sets its table sizes."""
    return EmotiVoiceConfig()


def _pct(v, q):
    if not v:
        return None
    s = sorted(v)
    return s[min(len(s) - 1, int(q * (len(s) - 1) + 0.5))]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", default=None, help="reference g_* generator checkpoint")
    p.add_argument("--train-ckpt", default=None,
                   help="checkpoint directory of the port's trainer (<output-dir>/ckpt); "
                        "loads its newest generator with that checkpoint's table sizes")
    p.add_argument("--dtype", choices=["f32", "bf16"], default="bf16")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--style-encoder", default=None)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--tokenlist", default=None)
    p.add_argument("--speakers", default=None,
                   help="speaker list file (default: every row of the speaker table)")
    p.add_argument("--prompts", nargs="*", default=DEFAULT_PROMPTS)
    p.add_argument("--phonemes", default=DEFAULT_PHONEMES,
                   help="fixed utterance token string for every cell")
    p.add_argument("--text", default=None,
                   help="raw text run through the frontend instead of --phonemes")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--limit", type=int, default=0,
                   help="sweep only the first N speakers (0 = all)")
    p.add_argument("--min-peak", type=float, default=0.0,
                   help="fail a cell whose |wav| peak is below this")
    p.add_argument("--out", default=None, help="JSONL per-cell results path")
    p.add_argument("--save-wavs", default=None, help="save every waveform to this dir")
    p.add_argument("--compare", default=None,
                   help="dir of same-named reference wavs; report MAE")
    p.add_argument("--report", default=None, help="markdown summary path")
    args = p.parse_args(argv)

    from emotivoice_tpu_torch.convert.from_reference import load_checkpoint, load_jets_generator
    from emotivoice_tpu_torch.frontend.tokens import load_label_list
    from emotivoice_tpu_torch.models.jets import JETSGenerator
    from emotivoice_tpu_torch.serving.engine import SynthesisEngine, SynthesisRequest
    from emotivoice_tpu_torch.serving.loading import (
        build_generator,
        config_and_vocab,
        config_with_tables,
    )
    from emotivoice_tpu_torch.training.loop import CheckpointManager
    from emotivoice_tpu_torch.utils.audio_io import read_wav, write_wav
    from emotivoice_tpu_torch.utils.device import use_exact_f32

    use_exact_f32(args.dtype)
    cfg, vocab = config_and_vocab(model_config(), args.tokenlist)
    weights = args.checkpoint or args.train_ckpt or "random-init"
    if args.train_ckpt:
        step = (CheckpointManager(args.train_ckpt).latest_step()
                if os.path.isdir(args.train_ckpt) else None)
        if step is None:
            raise FileNotFoundError(f"no g_/do_ checkpoint pair in {args.train_ckpt}")
        path = os.path.join(args.train_ckpt, f"g_{step:08d}")
        ckpt = load_checkpoint(path)
        cfg = config_with_tables(cfg, ckpt["generator"])
        model = load_jets_generator(JETSGenerator(cfg), ckpt)
        print(f"# loaded {path}", file=sys.stderr)
    else:
        model = build_generator(cfg, args.checkpoint, 0)
    speakers = (load_label_list(args.speakers) if args.speakers
                else [str(i) for i in range(cfg.am.n_speaker)])
    if args.limit:
        speakers = speakers[:args.limit]
    # Embedding-table coverage: every swept id must have a row. A grown
    # speaker table extends n_speaker, so a stale config is a real fault.
    if len(speakers) > cfg.am.n_speaker:
        raise ValueError(f"{len(speakers)} speakers but the embedding table has only "
                         f"{cfg.am.n_speaker} rows")
    if len(vocab) > cfg.am.n_vocab:
        raise ValueError(f"a vocabulary of {len(vocab)} tokens but the token embedding "
                         f"table has only {cfg.am.n_vocab} rows")

    engine = SynthesisEngine(cfg, model, vocab, dtype=args.dtype, device=args.device)
    if args.style_encoder:
        from emotivoice_tpu_torch.serving.style import StyleEmbedder

        embed_fn = StyleEmbedder.from_checkpoint(args.style_encoder, cfg.bert, args.tokenizer,
                                                 engine.device).embed
    else:
        def embed_fn(text):
            r = np.random.RandomState(zlib.crc32(text.encode("utf-8")) % (2 ** 31))
            return r.randn(cfg.am.bert_embedding).astype(np.float32) * 0.1

    if args.text:
        from emotivoice_tpu_torch.frontend.mixed import g2p_cn_en

        phonemes = g2p_cn_en(args.text, None).split()
        content_text = args.text
    else:
        phonemes = args.phonemes.split()
        content_text = "happy new year"
    content_emb = embed_fn(content_text)
    prompt_embs = {pr: embed_fn(pr) for pr in args.prompts}

    if args.save_wavs:
        os.makedirs(args.save_wavs, exist_ok=True)
    cells = [(s, pr) for s in range(len(speakers)) for pr in args.prompts]
    rtfs, peaks, failures, mae_rows = [], [], [], []
    out_f = open(args.out, "w", encoding="utf-8") if args.out else None
    try:
        t_sweep = time.perf_counter()
        for i in range(0, len(cells), args.batch_size):
            group = cells[i:i + args.batch_size]
            reqs = [SynthesisRequest(phonemes=phonemes, speaker_id=s,
                                     style_embedding=prompt_embs[pr],
                                     content_embedding=content_emb) for s, pr in group]
            with engine.capturing():  # untimed: warms the group's bucket (its program)
                engine.synthesize_batch(reqs)
            t0 = time.perf_counter()
            results = engine.synthesize_batch(reqs)
            dt = time.perf_counter() - t0
            for (s, pr), res in zip(group, results):
                audio_s = len(res.wav) / engine.sr
                rtf = (dt / len(group)) / max(audio_s, 1e-9)
                finite = bool(np.isfinite(res.wav).all())
                peak = float(np.abs(res.wav).max()) if len(res.wav) else 0.0
                ok = finite and peak >= args.min_peak and res.n_frames > 0
                row = {"speaker": speakers[s], "prompt": pr, "n_frames": res.n_frames,
                       "audio_s": round(audio_s, 3), "peak": round(peak, 6),
                       "finite": finite, "rtf": round(rtf, 6), "ok": ok}
                rtfs.append(rtf)
                peaks.append(peak)
                if not ok:
                    failures.append(row)
                name = f"{speakers[s]}_{pr}"
                if args.save_wavs:
                    write_wav(os.path.join(args.save_wavs, f"{name}.wav"), res.wav, engine.sr)
                if args.compare:
                    ref_path = os.path.join(args.compare, f"{name}.wav")
                    if os.path.exists(ref_path):
                        _, ref = read_wav(ref_path)
                        n = min(len(ref), len(res.wav))
                        mae = (float(np.abs(res.wav[:n] - ref[:n].astype(np.float32)).mean())
                               if n else float("nan"))
                        row["ref_mae"] = mae
                        row["ref_len_delta"] = len(res.wav) - len(ref)
                        mae_rows.append(mae)
                if out_f:
                    out_f.write(json.dumps(row) + "\n")
            if (i // args.batch_size) % 25 == 0:
                print(f"# {len(rtfs)}/{len(cells)} cells, rtf_p50={_pct(rtfs, 0.5):.4g}",
                      file=sys.stderr, flush=True)
        wall = time.perf_counter() - t_sweep
    finally:
        if out_f:
            out_f.close()

    summary = {
        "speakers": len(speakers),
        "prompts": len(args.prompts),
        "cells": len(rtfs),
        "dispatches": -(-len(cells) // args.batch_size),
        "wall_s": round(wall, 1),
        "rtf": {"p50": _pct(rtfs, 0.5), "p95": _pct(rtfs, 0.95),
                "max": max(rtfs) if rtfs else None},
        "peak": {"min": min(peaks) if peaks else None, "max": max(peaks) if peaks else None},
        "failures": len(failures),
        "weights": weights,
    }
    if mae_rows:
        summary["ref_mae"] = {"mean": float(np.mean(mae_rows)), "max": float(np.max(mae_rows))}
    print(json.dumps(summary))
    if failures:
        print("failures (first 5):", file=sys.stderr)
        for f in failures[:5]:
            print(json.dumps(f), file=sys.stderr)
    if args.report:
        with open(args.report, "w", encoding="utf-8") as r:
            r.write("# Voice sweep\n\n```json\n")
            r.write(json.dumps(summary, indent=2))
            r.write("\n```\n")
    return summary


if __name__ == "__main__":
    sys.exit(1 if main()["failures"] else 0)
