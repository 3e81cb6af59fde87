"""Released-checkpoint gate: load the reference EmotiVoice checkpoints into
the port, synthesize with them, and compare with the reference model
(counterpart of `tools/verify_released_weights.py`).

  python -m emotivoice_tpu_torch.tools.verify_released_weights \
      --generator g_00140000 --style-encoder checkpoint_163431 \
      [--discriminator do_00140000] [--reference <reference repo>] \
      [--texts lines.txt] [--tokenlist tokenlist] [--out-dir outputs/released_parity] \
      [--device cuda|cpu]

Gate 1 loads each checkpoint through `convert/from_reference.py`
(`load_jets_generator`, `load_style_encoder`, `load_discriminator`); a
structure error raises. The generator's token and speaker tables take their
sizes from the checkpoint. Gate 2 runs the port on the texts file
(`speaker|prompt|phonemes|content`, default `<reference>/data/inference/
text`), writes `utt<i>.wav` and requires finite, non-empty waveforms.
Gate 3, when the reference repository is importable (--reference), runs the
reference `JETSGenerator` on the CPU with the same weights and inputs and
requires equal durations, mel MAE < 1e-3 and waveform MAE < 2e-3; without
it the report says "not run". Style and content embeddings are random
vectors shared by both models (seed 0), so the gates isolate the
generator. `report.json` in --out-dir holds every gate and utterance; the
exit code is 0 only when all three gates passed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

import numpy as np

from emotivoice_tpu_torch.config import EmotiVoiceConfig

MEL_MAE_GATE = 1e-3
WAV_MAE_GATE = 2e-3
MAX_FRAMES = 1024  # mel bucket of a gate-2 utterance without the reference's durations


def model_config() -> EmotiVoiceConfig:
    """The released model's config (the defaults); the generator checkpoint
    sets its table sizes."""
    return EmotiVoiceConfig()


def _stub_numba():
    """The reference model imports numba for the training branch's viterbi
    only (modules/alignment.py:92-142); inference never calls it."""
    if "numba" in sys.modules:
        return
    numba = types.ModuleType("numba")
    numba.jit = lambda *a, **k: (lambda f: f)
    sys.modules["numba"] = numba


def _ref_model_config():
    """Full-size model namespace mirroring the reference's
    config/joint/config.yaml."""
    model = types.SimpleNamespace(
        encoder_n_hidden=384, encoder_n_heads=8, encoder_n_layers=4,
        encoder_p_dropout=0.2, encoder_kernel_size_conv_mod=3,
        decoder_n_hidden=384, decoder_n_heads=8, decoder_n_layers=4,
        decoder_p_dropout=0.2, decoder_kernel_size_conv_mod=3,
        duration_n_layers=2, duration_kernel_size=3, duration_p_dropout=0.5,
        variance_n_hidden=384, variance_n_layers=3, variance_kernel_size=3,
        variance_p_dropout=0.1, variance_embed_kernel_size=9,
        variance_embde_p_dropout=0.0,
        bert_embedding=768,
        resblock="1",
        upsample_rates=[8, 8, 2, 2],
        upsample_kernel_sizes=[16, 16, 4, 4],
        initial_channel=80,
        upsample_initial_channel=512,
        resblock_kernel_sizes=[3, 7, 11],
        resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    )
    return types.SimpleNamespace(model=model, n_mels=80, n_vocab=502, n_speaker=2013,
                                 segment_size=32)


def load_reference(root: str, state_dict):
    """The reference repository's JETSGenerator with `state_dict` loaded, on
    the CPU; raises when the repository or its dependencies are missing."""
    if root not in sys.path:
        sys.path.insert(0, root)
    _stub_numba()
    from models.prompt_tts_modified.jets import JETSGenerator as RefJETS

    ref = RefJETS(_ref_model_config()).eval()
    ref.load_state_dict(state_dict)
    return ref


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--generator", required=True, help="g_XXXXXXXX checkpoint")
    ap.add_argument("--style-encoder", required=True, help="style-encoder checkpoint")
    ap.add_argument("--discriminator", default=None, help="do_XXXXXXXX checkpoint")
    ap.add_argument("--reference", default=None,
                    help="root of the reference repository (gate 3 runs only with it)")
    ap.add_argument("--texts", default=None,
                    help="speaker|prompt|phonemes|content file (default: "
                         "<reference>/data/inference/text)")
    ap.add_argument("--tokenlist", default=None)
    ap.add_argument("--speakers", default=None)
    ap.add_argument("--out-dir", default="outputs/released_parity")
    ap.add_argument("--max-utts", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from emotivoice_tpu_torch.convert.from_reference import (
        load_checkpoint,
        load_discriminator,
        load_jets_generator,
        load_style_encoder,
        strip_module_prefix,
    )
    from emotivoice_tpu_torch.frontend.tokens import TokenVocab, load_label_list
    from emotivoice_tpu_torch.models.bert import StyleEncoder
    from emotivoice_tpu_torch.models.discriminator import Discriminator
    from emotivoice_tpu_torch.models.jets import JETSGenerator
    from emotivoice_tpu_torch.serving.loading import config_with_tables
    from emotivoice_tpu_torch.utils.audio_io import write_wav
    from emotivoice_tpu_torch.utils.device import resolve_device, use_exact_f32

    device = resolve_device(args.device)
    use_exact_f32("f32")
    if args.texts is None and args.reference is None:
        ap.error("--texts is needed without --reference")
    os.makedirs(args.out_dir, exist_ok=True)
    report = {"gates": {}, "utterances": []}

    # ---- gate 1: every checkpoint loads into the port's modules ------------
    g_ckpt = load_checkpoint(args.generator)
    sd = strip_module_prefix(g_ckpt.get("generator", g_ckpt))
    cfg = config_with_tables(model_config(), sd)
    model = load_jets_generator(JETSGenerator(cfg), g_ckpt).to(device).eval()
    report["gates"]["convert_generator"] = "ok"
    load_style_encoder(StyleEncoder(cfg.bert), load_checkpoint(args.style_encoder))
    report["gates"]["convert_style_encoder"] = "ok"
    if args.discriminator:
        load_discriminator(Discriminator(cfg.disc), load_checkpoint(args.discriminator))
        report["gates"]["convert_discriminator"] = "ok"

    vocab = TokenVocab.from_file(args.tokenlist) if args.tokenlist else TokenVocab.default()
    if len(vocab) > cfg.am.n_vocab:
        raise ValueError(f"a vocabulary of {len(vocab)} tokens but the checkpoint's token "
                         f"table has {cfg.am.n_vocab} rows")
    ref_root = os.path.abspath(args.reference) if args.reference else None
    texts = args.texts or os.path.join(ref_root, "data", "inference", "text")
    with open(texts, encoding="utf-8") as f:
        lines = [line.strip() for line in f if line.strip()][:args.max_utts]
    speakers = load_label_list(args.speakers) if args.speakers else None

    def speaker_id(s):
        return speakers.index(s) if speakers is not None else int(s) % cfg.am.n_speaker

    # ---- gate 3's model: the reference, when it can be imported ------------
    ref = None
    if ref_root is None:
        report["gates"]["reference_model"] = "not run: no --reference given"
    else:
        try:
            ref = load_reference(ref_root, sd)
            report["gates"]["reference_model"] = "loaded"
        except Exception as e:  # noqa: BLE001 - recorded; the gate then fails
            report["gates"]["reference_model"] = f"not run: unavailable: {e!r}"

    # ---- gates 2 and 3: synthesize, and compare where the reference runs ---
    rng = np.random.RandomState(0)
    synth_ok, parity_ok = True, ref is not None
    for li, line in enumerate(lines):
        spk, _prompt, phonemes, _content = line.split("|")
        ids = vocab.encode(phonemes.split())
        inputs = (np.asarray([ids], np.int64), np.asarray([len(ids)], np.int64),
                  np.asarray([speaker_id(spk)], np.int64),
                  rng.randn(1, cfg.am.bert_embedding).astype(np.float32),
                  rng.randn(1, cfg.am.bert_embedding).astype(np.float32))
        row = {"utt": li, "speaker": spk, "n_tokens": len(ids)}
        with torch.inference_mode():
            if ref is not None:
                out_ref = ref(*map(torch.from_numpy, inputs))
                dur_ref = out_ref["log_duration_predictions"][0].numpy().astype(np.int64)
                max_frames = int(dur_ref.sum())
            else:
                max_frames = MAX_FRAMES
            out = model(*(torch.as_tensor(a, device=device) for a in inputs),
                        max_frames=max_frames)
            out = {k: v.float().cpu().numpy() for k, v in out.items()
                   if k in ("durations", "dec_outputs", "wav_predictions", "output_lengths")}
        n = int(out["output_lengths"][0]) * cfg.vocoder.upsample_factor
        wav = out["wav_predictions"][0][:n]
        row.update(n_frames=int(out["output_lengths"][0]), finite=bool(np.isfinite(wav).all()),
                   peak=float(np.abs(wav).max()) if n else 0.0)
        synth_ok &= row["finite"] and n > 0
        if ref is not None:
            row.update(
                mel_mae=float(np.mean(np.abs(out["dec_outputs"][0]
                                             - out_ref["dec_outputs"][0].numpy()))),
                wav_mae=float(np.mean(np.abs(out["wav_predictions"][0]
                                             - out_ref["wav_predictions"][0, 0].numpy()))),
                durations_equal=bool((out["durations"][0].astype(np.int64) == dur_ref).all()))
            parity_ok &= (row["durations_equal"] and row["mel_mae"] < MEL_MAE_GATE
                          and row["wav_mae"] < WAV_MAE_GATE)
        write_wav(os.path.join(args.out_dir, f"utt{li}.wav"), wav, cfg.audio.sampling_rate)
        report["utterances"].append(row)
        print(json.dumps(row), flush=True)

    report["gates"]["port_synthesis"] = "ok" if synth_ok and lines else "failed"
    if ref is not None:
        report["gates"]["reference_parity"] = "ok" if parity_ok else "failed"
    report["pass"] = bool(synth_ok and lines and parity_ok)
    with open(os.path.join(args.out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({"pass": report["pass"], "gates": report["gates"]}))
    return report


if __name__ == "__main__":
    sys.exit(0 if main()["pass"] else 1)
