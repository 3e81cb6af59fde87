#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

  python3 chip_smoke.py [--report PATH] [--profile]

Phases (any failure exits non-zero and prints no result line):
  1. device   - require a CUDA card; print its name and power limit;
  2. build    - compile the port's kernels from emotivoice_tpu_torch/csrc
                with nvcc for sm_90a; count the tensor-core instructions
                (HMMA / HGMMA; TF32 products show as HMMA.1688.F32.TF32) of
                each kernel instantiation in the SASS (cuobjdump) and fail
                if one, bf16 or f32, has none;
  3. kernels  - each kernel against its plain PyTorch version on the card,
                at the main path's shapes (bench bucket: batch 16, 384 mel
                frames) and at a ragged T, in f32 (TF32 off) and bf16;
                times of kernel, plain version and the cuDNN convolutions
                (TF32 off: the same function; for f32 also with cuDNN's TF32
                on, a less exact function, for context), share of the bound
                and factor against cuDNN. The f32 bound is that of a 3xTF32
                split on the tensor cores, 3 * FLOP / 495 TFLOP/s. Phases 4 and 7
                record every (batch, T, C) their path hands to a kernel and
                hold both kernels against their plain versions at each of
                those shapes too, with the model's own weights;
  4. main     - the full-width EmotiVoiceConfig model (random parameters
                from a seed) behind SynthesisEngine + MicroBatcher answers
                mixed requests; launch counters must read 18 + 2 per
                generator call; xRT at the bench shape in f32 and bf16;
  5. cpu      - the same weights at batch 1, 32 tokens on the card and on
                the CPU (plain versions): equal durations, close waveforms;
  6. style    - the full-width SimBERT style encoder (StyleBertConfig: 12
                layers, 768-d; random parameters from a seed, a stand-in
                tokenizer) on the card and on the CPU with the same
                weights: pooled outputs finite and close; device ms per
                embed_batch at batch 1 and 16;
  7. serve    - text in, wav out over a real socket: TTSService (the port's
                g2p, the style encoder above, the full-width model,
                batching on) behind make_stdlib_server on 127.0.0.1:0, with
                the background warmup running on a cut grid (batch 1 only,
                f32); concurrent, long-form, streamed and failing requests
                through http.client; wavs, metrics, launch counters (18 + 2
                per generator call), warmup failures and shutdown checked;
                served batches replayed on the CPU with the same weights and
                the waveforms compared; latency, RTF and the host split per
                request printed; then the embedding work of one burst is
                timed alone in several arrangements (one thread, 8 threads,
                behind a lock, batched, beside a generator call) to show
                where a burst's embedding time goes;
  8. train    - joint GAN training of the full-width model (EmotiVoiceConfig:
                384-d 4+4-layer acoustic model, HiFi-GAN V1, 5 MPD + 3 MSD
                discriminators; random parameters from a seed, zero
                embeddings) at batch 16, f32, on a synthetic corpus the port
                writes (64 + 8 utterances, 4 speakers): `train()` for 30
                steps with a checkpoint at step 20 and validation at step 30,
                then again from the step-20 checkpoint to step 36. The train
                steps must launch no kernel (the trainer's generator runs the
                plain differentiable convs); validation must launch 18 + 2
                per generator call, and both kernels are held against their
                plain versions at validation's shapes. Losses finite, the
                spectral-norm u moved; one step on the card and on the CPU
                from the same state and batch (2 rows, dropout off, the same
                segment starts): every loss and the gradient norms of named
                parameters compared. Median step wall ms, steps/s, the
                device split of a step (CUDA events), peak memory, mel loss
                at the first and last step, validation ms per generator call.
                The same in bf16 compute (f32 parameters, Adam states and
                losses): steps/s, the device split and peak memory beside
                f32, one bf16 step card vs CPU from the seeded parameters
                (held; from the trained state only printed, since that
                state differs from run to run). Then CURVE_STEPS steps at
                batch 8 on a 48-utterance corpus in each dtype, validation
                every 100 steps (both kernels in the run's dtype, 18 + 2
                launches per call, held against their plain versions): the
                mel loss's trend and steps/s;
  9. dp_serve - a SynthesisEngine with two replicas on the card against
                one replica at the bench bucket, f32 and bf16: durations
                equal, waveforms within 2e-3 x max, 18 + 2 launches per
                replica call, both kernels held against their plain
                versions at each replica's shapes;
  9b. tp_serve - a SynthesisEngine whose one replica is split over the
                model group [cuda:0, cuda:0] ([cuda:0, cuda:1] where the
                machine has two cards; model_parallel=2: vocoder
                channels, attention heads, FFN; the MRF kernels on whole
                weights gathered each call) against the one-device engine
                at the bench bucket, f32 then bf16: durations (bf16: equal
                on some rows, a row's frames within 2%), waveforms within
                2e-3 / 5e-2 x max on the rows whose durations agree and
                through the TP vocoder on the one-device mel, 18 + 2
                launches per generator
                call, ms per call in turns, parameter bytes per shard, both
                kernels held against their plain versions at its shapes;
  10. dp_train - two ranks (this script with --dp-worker, the torchrun
                environment, gloo, both on cuda:0) against one process:
                one step on one global batch of 16 rows (every loss and the
                11 gradient norms to [train]'s tolerances, spectral u, v
                equal on the ranks); then 10 steps of `python -m
                emotivoice_tpu_torch.train --multihost` with rank-0 logging
                and a checkpoint: steps/s, gradient all-reduce ms per step,
                peak memory per rank, 0 kernel launches in the steps. Two
                ranks on one card: no multi-GPU figure;
  10b. tp_train - [train]'s config and corpus at batch 16, f32: a TrainStep
                over models split on the same group against a one-device
                TrainStep from the same seeded state (one step: every loss
                and the 11 gradient norms to [train]'s tolerances), 5 more
                steps of each (median wall ms, peak memory, 0 kernel
                launches), the TP checkpoint restored bit-equal into a
                one-device trainer. Both shards on one card show no
                scaling;
  10c. tp_ranks - tensor parallelism across processes: two ranks (this
                script with --tp-worker, the torchrun environment) as a
                (data, model) mesh of one model group of 2, one shard per
                rank (`RankGroup`); both on cuda:0 over gloo, or cuda:0 and
                cuda:1 over NCCL where the machine has two cards. The bench
                bucket through a SynthesisEngine over the rank group
                against the one-device engine, f32 then bf16, at
                [tp_serve]'s tolerances, both ranks' waveforms equal, 18 +
                2 launches per generator call on each rank, both kernels
                against their plain versions at each rank's shapes; one
                TrainStep over the rank group against one device on
                [tp_train]'s batch (losses, the 11 gradient norms), 5 more
                steps (0 launches), validation through the kernels (18 + 2
                on each rank), the checkpoint restored bit-equal into a
                one-device trainer and back into the ranks; ms per call
                and per step, collectives and their bytes per generator
                call and per step, parameter bytes and peak memory per
                rank, the backend;
  11. style_pretrain - the full-width style encoder: one PretrainStep card
                vs CPU (dropout off), then `pretrain` for 5 steps at batch
                16 (dropout on): ms per step;
  12. fallback - the checkpoint-free fallback vocoder at the full-width
                audio config (80 mels, n_fft 1024, hop 256, 16 kHz):
                mel_to_linear then griffin_lim(32) on the card and on the
                CPU, from the mel of a seeded 2 s two-tone signal and of a
                batch of 16 x 384 frames; mel_to_linear, istft and
                stft_phase card vs CPU, the phase-blind spectral error of
                the reconstructions card vs CPU; ms per griffin_lim call;
  13. corpus  - `tools.synthesize_corpus.main` in this process on 44 lines
                this script writes (40 English, 4 with hanzi, which g2p
                skips without pypinyin), full-width model with random
                parameters, f32 then bf16 at batch 16, then once more on
                the bf16 directory (renders nothing); transcripts, wavs,
                the speaker / prompt round-robin, 18 + 2 launches per
                generator call, both kernels against their plain versions
                at every shape the runs gave them; lines/s and xRT;
  14. sweep   - `tools.sweep_voices.main`: 4 speakers x 4 prompts in f32 on
                the CPU with --save-wavs, the same cells on the card with
                --compare (MAE within 2e-3 x max, equal lengths), then 64 x
                4 = 256 cells in bf16 at batch 16 with --save-wavs; finite
                waveforms, launches and kernels as in [corpus]; RTF p50/p95;
  15. tools   - the native wav codec must be built here; the released-
                weights check on [train]'s newest g_/do_ pair and [style]'s
                encoder (gates 1-2 pass, gate 3 "not run": no reference
                repository), with launches and kernels as above;
                prepare_ljspeech / prepare_databaker on small corpora at
                22.05 / 44.1 kHz this script writes (resampled natively);
                record_frontend_goldens --check;
  16. summary - a `kernels` JSON line, then the result line.

With --report, the detailed numbers are also written to PATH as JSON.
With --profile, torch.profiler also measures the time the card is busy
during one style-encoder forward, during a burst's embedding work and
during one train step in each dtype (with its top kernels).
"""

from __future__ import annotations

import argparse
import http.client
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
import zlib

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SEED = 0
BENCH_B, BENCH_T_TEXT, BENCH_FRAMES = 16, 96, 384
PEAK_BF16 = 989e12  # dense bf16 tensor-core FLOP/s, H100 SXM
PEAK_TF32 = 495e12  # dense TF32 tensor-core FLOP/s
TF32_TERMS = 3  # TF32 products per f32-accurate product (3xTF32 split): the f32 kernels' bound
PEAK_F32_CUDA_CORES = 67e12  # f32 FLOP/s outside the tensor cores: the f32 bound of earlier runs
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
TOL_F32 = 2e-4  # max |kernel - plain| / max |plain|, f32 with TF32 off
TOL_BF16 = 2e-2  # the same in bf16 (roundings at other places)
TOL_CPU = 2e-3  # whole path, card vs CPU, / max |wav|
# bf16, two replicas (8 rows each) vs one call on 16 rows: cuBLAS and cuDNN
# may choose other kernels for 8 rows than for 16, and bf16 rounds those sums
# differently (1.7e-2 of max at the bench bucket on an H100); the replicas are held at
# TOL_CPU against one replica on the same 8-row halves
TOL_DP_BF16 = 5e-2
TP_BF16_FRAMES = 0.02  # bf16 TP(2) vs one device: a row's frames may differ by this share (+1)
REPLAY_MAX_FRAMES = 6144  # batch x mel frames of a served call replayed on the CPU
TRAIN_B, TRAIN_STEPS, TRAIN_CKPT, TRAIN_RESUMED_TO = 16, 30, 20, 36
TOL_TRAIN_LOSS = 2e-3  # one train step, card vs CPU: each loss, relative
TOL_TRAIN_GRAD = 5e-3  # the same for the gradient norm of each named parameter
TRAIN_GRAD_PARAMS = (
    "am.encoder.encoders.0.self_attn.linear_q.weight", "am.alignment_module.f_conv1.weight",
    "am.duration_predictor.linear.weight", "am.decoder.encoders.3.feed_forward.w_2.weight",
    "generator.conv_pre.weight_v", "generator.resblocks.11.convs2.2.weight_v",
    "generator.ups.3.weight_g", "mpd.discriminators.0.convs.0.weight_v",
    "mpd.discriminators.4.conv_post.weight_g", "msd.discriminators.0.convs.3.weight_orig",
    "msd.discriminators.2.convs.5.weight_v")
TOL_TRAIN_LOSS_BF16 = 3e-2  # one bf16 train step, card vs CPU (cuDNN and oneDNN round
TOL_TRAIN_GRAD_BF16 = 1e-1  # bf16 at other places): each loss / gradient norm, relative
CURVE_B, CURVE_STEPS, CURVE_VALID = 8, 200, 100  # the 48-utterance runs in each dtype
DP_RANKS, DP_GLOBAL_B, DP_CLI_STEPS = 2, 16, 10
TOL_STYLE = 1e-4  # style encoder, card vs CPU, max |pooled| difference (tanh outputs, f32)
TOL_PRETRAIN = 1e-4  # one pretraining step, card vs CPU: loss and gradient norms, relative
V1_KS = (3, 7, 11)
V1_DS = ((1, 3, 5),) * 3

report = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def timed(fn, iters: int = 3, warmup: int = 1) -> float:
    """Mean device ms per call (CUDA events over `iters` calls)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    report["card"] = card
    report["torch"] = torch.__version__
    report["cuda"] = torch.version.cuda
    log(f"[device] {torch.cuda.get_device_name(0)} | {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return card


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

KERNEL_SYMBOL = re.compile(
    r"Function : \S*?(residual_unit_kernel|mrf_stage_kernel)ILi(\d+)E(13__nv_bfloat16|f)E")


def parse_sass_mma(sass: str) -> dict:
    """Tensor-core instructions (HMMA / HGMMA) per kernel instantiation in a
    `cuobjdump --dump-sass` listing, keyed (kernel, C, dtype)."""
    counts, key = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = KERNEL_SYMBOL.search(line)
            key = (m.group(1), int(m.group(2)), "f32" if m.group(3) == "f" else "bf16") if m else None
            if key:
                counts[key] = 0
        elif key and ("HMMA" in line or "HGMMA" in line):
            counts[key] += 1
    return counts


def sass_mma_counts(lib_path: str, nvcc: str) -> dict:
    """parse_sass_mma of the kernel library, dumped by the cuobjdump beside nvcc."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    res = subprocess.run([cuobjdump, "--dump-sass", lib_path], capture_output=True, text=True,
                         timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump --dump-sass failed: {res.stderr.strip()[-500:]}")
    return parse_sass_mma(res.stdout)


def phase_build() -> None:
    from emotivoice_tpu_torch.ops.cuda import build

    start = time.perf_counter()
    build.load()
    secs = time.perf_counter() - start
    report["build_seconds"] = secs
    log(f"[build] {build.LIB_NAME} from {build.CSRC_DIR} with {' '.join(build.NVCC_FLAGS)}: "
        f"{secs:.1f} s ({'built' if build.build_seconds else 'reused'})")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line.lower() or "Compiling entry" in line:
            log(f"[build] {line.strip()}")
    counts = sass_mma_counts(os.path.join(build.BUILD_DIR, build.LIB_NAME), build.find_nvcc())
    for (name, c, dname), n in sorted(counts.items()):
        log(f"[build] SASS {name}<C={c}, {dname}>: {n} HMMA/HGMMA instructions")
    report["sass_mma"] = {f"{k[0]}/{k[1]}/{k[2]}": v for k, v in sorted(counts.items())}
    for name in ("residual_unit_kernel", "mrf_stage_kernel"):
        for dname in ("bf16", "f32"):
            found = {c: n for (k, c, dn), n in counts.items() if k == name and dn == dname}
            if not found or not all(found.values()):
                fail(f"{name}: {dname} instantiation without tensor-core instructions: {found}")


# ---------------------------------------------------------------------------
# 3. kernels vs plain
# ---------------------------------------------------------------------------

def _unit_weights(gen, k, c, dtype, dev):
    std = 1.0 / np.sqrt(c * k)

    def r(*shape, s):
        return (torch.randn(*shape, generator=gen) * s).to(dev, dtype).contiguous()

    return (r(k, c, c, s=std), r(c, s=0.05), r(k, c, c, s=std), r(c, s=0.05))


def _conv_ncw(x_ncw, w_oik, b, d):
    k = w_oik.shape[2]
    return torch.nn.functional.conv1d(x_ncw, w_oik, b, padding=(k - 1) // 2 * d, dilation=d)


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _timed_cudnn(fn, dtype):
    """Device ms of the cuDNN convolutions `fn` runs with TF32 off (the same
    function as the kernel: the yardstick) and, in f32, also with cuDNN's
    TF32 on (one TF32 product per f32 product: a less exact function)."""
    lib_ms = timed(fn)
    if dtype != torch.float32:
        return lib_ms, None
    torch.backends.cudnn.allow_tf32 = True
    try:
        return lib_ms, timed(fn)
    finally:
        torch.backends.cudnn.allow_tf32 = False


def _f32_context(r) -> str:
    """For an f32 row: its bound on the f32 CUDA cores, which runs before the
    3xTF32 design printed as bound_ms, and cuDNN with TF32 on (a different
    function)."""
    if not r.get("bound_cuda_cores_ms"):
        return ""
    return (f" bound_cuda_cores_ms={r['bound_cuda_cores_ms']:.4f} "
            f"cudnn_tf32_on_ms={r['library_tf32_ms']:.3f} (a different function)")


def phase_kernels(dev) -> dict:
    from emotivoice_tpu_torch.ops.cuda.mrf_stage import fused_mrf_stage, mrf_stage_plain
    from emotivoice_tpu_torch.ops.cuda.resblock import fused_residual_unit, residual_unit_plain

    gen = torch.Generator().manual_seed(SEED)
    t_mel = BENCH_FRAMES
    rows = []
    totals = {}
    worst = {"fused_residual_unit": 0.0, "fused_mrf_stage": 0.0}
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        dname = "f32" if dtype == torch.float32 else "bf16"
        item = 2 if dtype == torch.bfloat16 else 4
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_TF32 / TF32_TERMS
        # kernel 1: stages 1-2 of the bench bucket, every (k, d) of the MRF
        for c, t in ((256, 8 * t_mel), (128, 64 * t_mel)):
            for k, dils in zip(V1_KS, V1_DS):
                for d in dils:
                    w = _unit_weights(gen, k, c, dtype, dev)
                    for tt in (t, t + 37):
                        x = (torch.randn(BENCH_B, tt, c, generator=gen) * 0.5).to(dev, dtype)
                        got = fused_residual_unit(x, *w, k, d)
                        want = residual_unit_plain(x, *w, k, d)
                        torch.cuda.synchronize()
                        err = _rel_err(got, want)
                        if not np.isfinite(err) or err > tol:
                            fail(f"fused_residual_unit C={c} k={k} d={d} T={tt} {dname}: "
                                 f"rel err {err:.3g} > {tol}")
                        worst["fused_residual_unit"] = max(
                            worst["fused_residual_unit"],
                            float((got.float() - want.float()).abs().max()))
                    # time at the main-path T
                    x = (torch.randn(BENCH_B, t, c, generator=gen) * 0.5).to(dev, dtype)
                    w1t, w2t = (w[0].permute(2, 1, 0).contiguous(),
                                w[2].permute(2, 1, 0).contiguous())
                    xn = x.transpose(1, 2).contiguous()
                    ms = timed(lambda: fused_residual_unit(x, *w, k, d))
                    plain_ms = timed(lambda: residual_unit_plain(x, *w, k, d))
                    lib_ms, lib_tf32_ms = _timed_cudnn(
                        lambda: (_conv_ncw(xn, w1t, w[1], d), _conv_ncw(xn, w2t, w[3], 1)), dtype)
                    flop = 4 * k * c * c * BENCH_B * t
                    nbytes = item * (2 * BENCH_B * t * c + 2 * k * c * c + 2 * c)
                    rows.append(dict(kernel="fused_residual_unit", dtype=dname, C=c, T=t,
                                     k=k, d=d, err=err, ms=ms, plain_ms=plain_ms,
                                     library_ms=lib_ms, library_tf32_ms=lib_tf32_ms,
                                     flop=flop, bytes=nbytes))
        # kernel 2: stages 3-4 of the bench bucket, whole MRF
        for c, t in ((64, 128 * t_mel), (32, 256 * t_mel)):
            ws = [[_unit_weights(gen, k, c, dtype, dev) for _ in dils]
                  for k, dils in zip(V1_KS, V1_DS)]
            for tt in (t, t + 37):
                x = (torch.randn(BENCH_B, tt, c, generator=gen) * 0.5).to(dev, dtype)
                got = fused_mrf_stage(x, ws, V1_KS, V1_DS)
                want = mrf_stage_plain(x, ws, V1_KS, V1_DS)
                torch.cuda.synchronize()
                err = _rel_err(got, want)
                if not np.isfinite(err) or err > tol:
                    fail(f"fused_mrf_stage C={c} T={tt} {dname}: rel err {err:.3g} > {tol}")
                worst["fused_mrf_stage"] = max(
                    worst["fused_mrf_stage"], float((got.float() - want.float()).abs().max()))
            x = (torch.randn(BENCH_B, t, c, generator=gen) * 0.5).to(dev, dtype)
            xn = x.transpose(1, 2).contiguous()
            wn = [[(u[0].permute(2, 1, 0).contiguous(), u[1], u[2].permute(2, 1, 0).contiguous(),
                    u[3]) for u in units] for units in ws]

            def lib_stage():
                for units, dils in zip(wn, V1_DS):
                    for (w1t, b1, w2t, b2), d in zip(units, dils):
                        _conv_ncw(xn, w1t, b1, d)
                        _conv_ncw(xn, w2t, b2, 1)

            ms = timed(lambda: fused_mrf_stage(x, ws, V1_KS, V1_DS))
            plain_ms = timed(lambda: mrf_stage_plain(x, ws, V1_KS, V1_DS))
            lib_ms, lib_tf32_ms = _timed_cudnn(lib_stage, dtype)
            flop = sum(4 * k * c * c * len(dils) for k, dils in zip(V1_KS, V1_DS)) * BENCH_B * t
            nbytes = item * (2 * BENCH_B * t * c
                             + sum(2 * k * c * c + 2 * c for k, dils in zip(V1_KS, V1_DS)
                                   for _ in dils))
            rows.append(dict(kernel="fused_mrf_stage", dtype=dname, C=c, T=t, k=None, d=None,
                             err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             library_tf32_ms=lib_tf32_ms, flop=flop, bytes=nbytes))
        for r in rows:
            if r["dtype"] == dname:
                r["bound_ms"] = 1e3 * max(r["flop"] / peak, r["bytes"] / PEAK_BYTES)
                r["bound_by"] = "operations" if r["flop"] / peak >= r["bytes"] / PEAK_BYTES else "bytes"
                r["bound_cuda_cores_ms"] = (
                    1e3 * max(r["flop"] / PEAK_F32_CUDA_CORES, r["bytes"] / PEAK_BYTES)
                    if dtype == torch.float32 else None)
    for r in rows:
        key = (r["kernel"], r["dtype"])
        t = totals.setdefault(key, dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                                        flop=0, bytes=0, calls=0, err=0.0, library_tf32_ms=0.0,
                                        bound_cuda_cores_ms=0.0))
        for f in ("ms", "plain_ms", "library_ms", "bound_ms", "flop", "bytes"):
            t[f] += r[f]
        if r["dtype"] == "f32":
            t["library_tf32_ms"] += r["library_tf32_ms"]
            t["bound_cuda_cores_ms"] += r["bound_cuda_cores_ms"]
        t["calls"] += 1
        t["err"] = max(t["err"], r["err"])
        log(f"[kernels] {r['kernel']:<19} {r['dtype']:<4} C={r['C']:<3} T={r['T']:<6} "
            f"k={r['k']} d={r['d']} rel_err={r['err']:.2e} ms={r['ms']:.3f} "
            f"plain_ms={r['plain_ms']:.3f} cudnn_ms={r['library_ms']:.3f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"bound_share={r['bound_ms'] / r['ms']:.4f} x_cudnn={r['ms'] / r['library_ms']:.2f} "
            f"TFLOP/s={r['flop'] / r['ms'] / 1e9:.1f}" + _f32_context(r))
    for (name, dname), t in totals.items():
        log(f"[kernels] per generator call at the bench bucket: {name} {dname} "
            f"{t['calls']} launches ms={t['ms']:.2f} plain_ms={t['plain_ms']:.2f} "
            f"cudnn_ms={t['library_ms']:.2f} bound_ms={t['bound_ms']:.3f} "
            f"bound_share={t['bound_ms'] / t['ms']:.4f} x_cudnn={t['ms'] / t['library_ms']:.2f} "
            f"TFLOP/s={t['flop'] / t['ms'] / 1e9:.1f} max_rel_err={t['err']:.2e}"
            + (_f32_context(t) if dname == "f32" else ""))
    report["kernel_rows"] = rows
    report["kernel_totals"] = {f"{k[0]}/{k[1]}": v for k, v in totals.items()}
    return dict(totals=totals, worst=worst)


def watch_stage_shapes(model):
    """Record (B, T, C, dtype) of every tensor the vocoder hands to an MRF
    kernel while `model` runs: each upsampling layer's output is the input
    of its stage's kernel(s). Returns (the set being filled, hook handles)."""
    shapes = set()

    def hook(_module, _args, out):
        shapes.add((*out.shape, out.dtype))

    return shapes, [up.register_forward_hook(hook) for up in model.generator.ups]


def launches_per_call(vc) -> tuple:
    """(fused_residual_unit, fused_mrf_stage) launches of one generator call:
    one per unit of a stage at C >= 128, one per stage below (18 + 2 for V1)."""
    from emotivoice_tpu_torch.models.hifigan import FUSED_UNIT_MIN_CHANNELS

    widths = [vc.upsample_initial_channel // 2 ** (i + 1) for i in range(len(vc.upsample_rates))]
    units = sum(len(d) for d in vc.resblock_dilation_sizes)
    wide = sum(c >= FUSED_UNIT_MIN_CHANNELS for c in widths)
    return wide * units, len(widths) - wide


def check_path_kernels(dev, model, shapes, tag: str) -> dict:
    """Both kernels against their plain versions at every shape a driven
    path gave them, in that path's dtype, with the model's own weights and
    seeded inputs. Fails on a mismatch."""
    from emotivoice_tpu_torch.models.hifigan import FUSED_UNIT_MIN_CHANNELS
    from emotivoice_tpu_torch.ops.cuda.mrf_stage import fused_mrf_stage, mrf_stage_plain
    from emotivoice_tpu_torch.ops.cuda.resblock import fused_residual_unit, residual_unit_plain

    vc = model.generator.cfg
    ks = tuple(vc.resblock_kernel_sizes)
    ds = tuple(tuple(d) for d in vc.resblock_dilation_sizes)
    stage_of = {vc.upsample_initial_channel // 2 ** (i + 1): i
                for i in range(len(vc.upsample_rates))}
    gen = torch.Generator().manual_seed(SEED + 3)
    worst_abs = {"fused_residual_unit": 0.0, "fused_mrf_stage": 0.0}
    worst_rel = dict(worst_abs)
    rows = []
    for b, t, c, dtype in sorted(shapes, key=lambda s: (-s[2], s[0], s[1], str(s[3]))):
        tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
        i = stage_of[c]
        blocks = model.generator.resblocks[i * len(ks):(i + 1) * len(ks)]
        pairs = []
        with torch.inference_mode():
            weights = tuple(blk.unit_weights(dtype) for blk in blocks)
            x = (torch.randn(b, t, c, generator=gen) * 0.5).to(dev, dtype)
            if c >= FUSED_UNIT_MIN_CHANNELS:
                name = "fused_residual_unit"
                for k, dils, units in zip(ks, ds, weights):
                    for d, w in zip(dils, units):
                        pairs.append((fused_residual_unit(x, *w, k, d),
                                      residual_unit_plain(x, *w, k, d)))
            else:
                name = "fused_mrf_stage"
                pairs.append((fused_mrf_stage(x, weights, ks, ds),
                              mrf_stage_plain(x, weights, ks, ds)))
            torch.cuda.synchronize()
            err = max(_rel_err(got, want) for got, want in pairs)
            worst_abs[name] = max(worst_abs[name], max(
                float((got.float() - want.float()).abs().max()) for got, want in pairs))
        dname = "bf16" if dtype == torch.bfloat16 else "f32"
        if not np.isfinite(err) or err > tol:
            fail(f"[{tag}] {name} at the path's shape B={b} T={t} C={c} {dname}: "
                 f"rel err {err:.3g} > {tol}")
        worst_rel[name] = max(worst_rel[name], err)
        rows.append(dict(kernel=name, B=b, T=t, C=c, dtype=dname, launches=len(pairs), err=err))
    for c in sorted({r["C"] for r in rows}, reverse=True):
        sel = [r for r in rows if r["C"] == c]
        log(f"[{tag}] {sel[0]['kernel']} vs plain at the path's own shapes, C={c}: "
            f"{len(sel)} shapes (B x T, {'/'.join(sorted({r['dtype'] for r in sel}))}) "
            + " ".join(f"{r['B']}x{r['T']}" for r in sel)
            + f"; worst rel err {max(r['err'] for r in sel):.2e}")
    if not rows:
        fail(f"[{tag}] the path handed no tensor to a kernel")
    report.setdefault("path_kernel_checks", {})[tag] = rows
    return dict(worst=worst_abs, worst_rel=worst_rel,
                shapes={name: sum(r["kernel"] == name for r in rows) for name in worst_abs})


# ---------------------------------------------------------------------------
# 4. main path
# ---------------------------------------------------------------------------

def _build_model():
    from emotivoice_tpu_torch.config import EmotiVoiceConfig
    from emotivoice_tpu_torch.frontend.tokens import TokenVocab
    from emotivoice_tpu_torch.models.jets import JETSGenerator, init_random_

    vocab = TokenVocab.default()
    cfg = EmotiVoiceConfig()
    cfg = cfg.replace(am=cfg.am.__class__(**{**cfg.am.__dict__, "n_vocab": len(vocab)}))
    return cfg, vocab, init_random_(JETSGenerator(cfg), SEED)


def phase_main(dev, cfg, vocab, model) -> dict:
    from emotivoice_tpu_torch.ops.cuda.mrf_stage import fused_mrf_stage
    from emotivoice_tpu_torch.ops.cuda.resblock import fused_residual_unit
    from emotivoice_tpu_torch.serving.batcher import MicroBatcher
    from emotivoice_tpu_torch.serving.engine import SynthesisEngine, SynthesisRequest

    rng = np.random.RandomState(SEED)
    d = cfg.am.bert_embedding
    phones = vocab.tokens[2:200]

    def req(n_tokens, alpha=1.0):
        return SynthesisRequest(
            phonemes=list(rng.choice(phones, n_tokens)),
            speaker_id=int(rng.randint(cfg.am.n_speaker)),
            style_embedding=rng.randn(d).astype(np.float32),
            content_embedding=rng.randn(d).astype(np.float32), alpha=alpha,
        )

    engine = SynthesisEngine(cfg, model, vocab, device=dev, dtype="f32", frames_per_token=4.0)
    gen_calls = [0]
    run = engine.run

    def counted_run(*a, **kw):
        gen_calls[0] += 1
        return run(*a, **kw)

    engine.run = counted_run
    mixed = [req(n) for n in (7, 20, 33, 50)] + [req(n, 1.3) for n in (12, 40, 64)]
    bench = [req(BENCH_T_TEXT) for _ in range(BENCH_B)]

    fused_residual_unit.launches = 0
    fused_mrf_stage.launches = 0
    batcher = MicroBatcher(engine, max_batch=BENCH_B, max_wait_ms=20.0)
    shapes, hooks = watch_stage_shapes(model)
    try:
        t0 = time.perf_counter()
        results = batcher.submit_many(mixed)
        results += batcher.submit_many(bench)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        batcher.close()
        for h in hooks:
            h.remove()
    launches = {"fused_residual_unit": fused_residual_unit.launches,
                "fused_mrf_stage": fused_mrf_stage.launches}
    calls = gen_calls[0]
    log(f"[main] {len(results)} requests in {batcher.dispatches} batches, {calls} generator "
        f"calls, {wall:.2f} s; launches {launches}; saturation redispatches "
        f"{engine.saturation_redispatches}")
    for r, q in zip(results, mixed + bench):
        if not np.all(np.isfinite(r.wav)):
            fail("non-finite waveform")
        if r.n_frames < 1 or r.wav.shape != (r.n_frames * engine.up,):
            fail(f"waveform length {r.wav.shape} for {r.n_frames} frames")
    if launches["fused_residual_unit"] != 18 * calls or launches["fused_mrf_stage"] != 2 * calls:
        fail(f"launch counters {launches} != 18/2 per generator call x {calls}")
    peak = max(float(np.abs(r.wav).max()) for r in results)
    log(f"[main] waveforms finite, lengths = n_frames * {engine.up}, max |wav| {peak:.3f}")
    path = check_path_kernels(dev, model, shapes, "main")

    # xRT at the bench bucket, and where the time goes
    toks = rng.randint(2, len(vocab), (BENCH_B, BENCH_T_TEXT))
    args = (toks, np.full(BENCH_B, BENCH_T_TEXT), rng.randint(0, cfg.am.n_speaker, BENCH_B),
            rng.randn(BENCH_B, d).astype(np.float32), rng.randn(BENCH_B, d).astype(np.float32))
    audio_s = BENCH_B * BENCH_FRAMES * cfg.audio.hop_length / cfg.audio.sampling_rate
    xrt = {}
    for dname in ("f32", "bf16"):
        eng = SynthesisEngine(cfg, model, vocab, device=dev, dtype=dname)
        eng.run(*args, BENCH_FRAMES, 1.0)  # warm
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run(*args, BENCH_FRAMES, 1.0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        dt = float(np.median(times))
        # split: acoustic model vs vocoder (device time)
        tt = [torch.as_tensor(a, device=dev) for a in args]
        with torch.inference_mode():
            am_ms = timed(lambda: model.am(tt[0], tt[1], tt[2], tt[3].float(), tt[4].float(),
                                           max_frames=BENCH_FRAMES, dtype=eng.dtype), iters=2)
            mel = model.am(tt[0], tt[1], tt[2], tt[3].float(), tt[4].float(),
                           max_frames=BENCH_FRAMES, dtype=eng.dtype)["dec_outputs"]
            voc_ms = timed(lambda: model.generator(mel, dtype=eng.dtype), iters=2)
        xrt[dname] = dict(seconds=dt, xrt=audio_s / dt, am_ms=am_ms, vocoder_ms=voc_ms,
                          runs_s=times)
        log(f"[main] bench bucket B={BENCH_B} T_text={BENCH_T_TEXT} frames={BENCH_FRAMES} "
            f"({audio_s:.1f} s audio) {dname}: {dt * 1e3:.1f} ms/call, xRT {audio_s / dt:.1f}; "
            f"device ms: acoustic {am_ms:.1f}, vocoder {voc_ms:.1f}")
    report["main"] = dict(launches=launches, generator_calls=calls, wall_s=wall, xrt=xrt)
    return dict(launches=launches, xrt=xrt, path=path)


# ---------------------------------------------------------------------------
# 5. card vs CPU
# ---------------------------------------------------------------------------

def phase_cpu(dev, cfg, model):
    from emotivoice_tpu_torch.models.jets import JETSGenerator

    cpu_model = JETSGenerator(cfg)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_model.eval()
    rng = np.random.RandomState(SEED + 1)
    d = cfg.am.bert_embedding
    args = (rng.randint(2, cfg.am.n_vocab, (1, 32)), np.array([32]), np.array([5]),
            rng.randn(1, d).astype(np.float32), rng.randn(1, d).astype(np.float32))
    outs = []
    for m, device in ((model, dev), (cpu_model, torch.device("cpu"))):
        with torch.inference_mode():
            o = m(*(torch.as_tensor(a, device=device) for a in args), max_frames=256)
        outs.append({k: v.cpu().numpy() for k, v in o.items()
                     if k in ("durations", "output_lengths", "wav_predictions")})
    gpu, cpu = outs
    if not np.array_equal(gpu["durations"], cpu["durations"]):
        fail("durations differ between card and CPU")
    scale = float(np.abs(cpu["wav_predictions"]).max())
    err = float(np.abs(gpu["wav_predictions"] - cpu["wav_predictions"]).max())
    log(f"[cpu] batch 1, 32 tokens: durations equal ({int(cpu['output_lengths'][0])} frames), "
        f"wav max |card - cpu| {err:.2e} (max |wav| {scale:.3f}, tol {TOL_CPU} x max)")
    if scale < 1e-3 or err > TOL_CPU * scale:
        fail("card and CPU waveforms disagree")
    report["cpu"] = dict(err=err, scale=scale)
    return cpu_model


# ---------------------------------------------------------------------------
# 6. style encoder
# ---------------------------------------------------------------------------

class StandInTokenizer:
    """A deterministic stand-in for the SimBERT tokenizer (its vocabulary
    file is not in the repository), with the HF call signature the embedder
    uses: [CLS], one id per character from a stable hash into
    [5, vocab_size), [SEP], padded with 0 to `max_length`."""

    CLS, SEP, PAD = 2, 3, 0

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def __call__(self, texts, padding="max_length", truncation=True, max_length=64,
                 return_tensors="np"):
        ids = np.full((len(texts), max_length), self.PAD, np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, text in enumerate(texts):
            body = [5 + zlib.crc32(ch.encode("utf-8")) % (self.vocab_size - 5)
                    for ch in text][: max_length - 2]
            row = [self.CLS] + body + [self.SEP]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return {"input_ids": ids, "token_type_ids": np.zeros_like(ids), "attention_mask": mask}


STYLE_TEXTS = ["Happy", "A calm and slow voice, a little sad.",
               "The quick brown fox jumps over the lazy dog!", "兴奋"]


def device_kernels(fn, top: int = 0):
    """(milliseconds the card spends in kernels and copies while `fn` runs,
    summed from a torch.profiler trace, or None if the trace holds no device
    time; the `top` device entries by time as (name, ms, calls))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # Device-side events only: a host-side operator's entry repeats the time
    # of the kernels it launched.
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events)
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)[:top]
    return (total / 1e3 if total > 0 else None,
            [(e.key[:90], e.self_device_time_total / 1e3, e.count) for e in ranked])


def device_busy_ms(fn):
    """The card's busy milliseconds while `fn` runs (`device_kernels`)."""
    return device_kernels(fn)[0]


def phase_style(dev, profiled: bool):
    from emotivoice_tpu_torch.config import StyleBertConfig
    from emotivoice_tpu_torch.models.bert import StyleEncoder
    from emotivoice_tpu_torch.models.jets import init_random_
    from emotivoice_tpu_torch.serving.style import StyleEmbedder

    cfg = StyleBertConfig()
    tok = StandInTokenizer(cfg.vocab_size)
    cpu_model = init_random_(StyleEncoder(cfg), SEED + 2)
    card_model = StyleEncoder(cfg)
    card_model.load_state_dict(cpu_model.state_dict())
    n_params = sum(p.numel() for p in cpu_model.parameters())
    card = StyleEmbedder(card_model, cfg, tok, max_len=64, device=dev)
    cpu = StyleEmbedder(cpu_model, cfg, tok, max_len=64, device="cpu")
    got, want = card.embed_batch(STYLE_TEXTS), cpu.embed_batch(STYLE_TEXTS)
    if got.shape != (len(STYLE_TEXTS), cfg.hidden_size) or got.dtype != np.float32:
        fail(f"style embeddings {got.shape} {got.dtype}")
    if not np.all(np.isfinite(got)):
        fail("non-finite style embedding")
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    spread = float(np.abs(got[0] - got[1]).max())
    log(f"[style] StyleEncoder {cfg.num_layers} layers, {cfg.hidden_size}-d, {cfg.num_heads} heads, "
        f"FFN {cfg.intermediate_size}, vocab {cfg.vocab_size} ({n_params / 1e6:.1f} M parameters), "
        f"{len(STYLE_TEXTS)} texts at max_len 64: max |card - cpu| {err:.2e} (max |pooled| "
        f"{scale:.3f}, tol {TOL_STYLE}, f32 with TF32 off); two texts differ by {spread:.3f}")
    if err > TOL_STYLE or scale < 1e-2 or spread < 1e-3:
        fail("style encoder: card and CPU disagree, or the output does not depend on the text")
    times = {}
    for b in (1, 16):
        texts = [STYLE_TEXTS[i % len(STYLE_TEXTS)] + "!" * (i // len(STYLE_TEXTS))
                 for i in range(b)]
        dev_ms = timed(lambda: card.embed_batch(texts), iters=10, warmup=2)
        t0 = time.perf_counter()
        for _ in range(10):
            card.embed_batch(texts)
        wall_ms = (time.perf_counter() - t0) * 100
        times[b] = dict(device_ms=dev_ms, wall_ms=wall_ms)
        log(f"[style] embed_batch at batch {b}, max_len 64: {dev_ms:.2f} ms between CUDA events, "
            f"{wall_ms:.2f} ms on the host's clock (tokenizer and copy back included)")
        if profiled:
            card.embed_batch(texts)
            times[b]["device_busy_ms"] = busy = device_busy_ms(lambda: card.embed_batch(texts))
            log(f"[style] embed_batch at batch {b}: the card is busy "
                + (f"{busy:.2f} ms of those" if busy else "for a time the profiler did not see")
                + " (torch.profiler, kernels and copies summed)")
    report["style"] = dict(err=err, scale=scale, params=n_params, embed_batch_ms=times)
    return card


# ---------------------------------------------------------------------------
# 7. text in, wav out over HTTP
# ---------------------------------------------------------------------------

OPTIONAL = ("jieba", "pypinyin", "g2p_en", "fastapi", "transformers")
LEXICON_LINES = "EMOTIVOICE IY0 M OW1 SH IH0 V OY2 S\nSYNTHESIS S IH1 N TH AH0 S AH0 S\n"
ENGLISH = [  # (input, voice, speed); no digits, different lengths
    ("Hello there.", "0", 1.0),
    ("The weather is lovely today, so we are walking to the harbour.", "7", 1.0),
    ("Please speak a little faster than you usually do.", "0", 1.5),
    ("Emotivoice synthesis goes through the lexicon.", "7", 1.0),
    ("Why would anybody say such a thing?", "0", 1.0),
    ("Short one!", "7", 1.0),
    ("A voice can be happy, sad, angry or calm, and the prompt says which.", "0", 1.0),
    ("Nothing special here, just one more sentence for the batch.", "7", 1.0),
]
LONGFORM = ("This is the first sentence of a longer paragraph. The second one follows it at once! "
            "Does the third one ask a question? The fourth one ends the paragraph, and with it "
            "the input goes well above the limit for one piece.")
STREAMED = ("A streamed answer comes in pieces. Each sentence is one piece of audio, and it is "
            "sent as soon as it is ready! The listener hears the beginning while the end is made.")
HANZI = "你好，世界。"
AGAIN = " Once more."  # appended for the second burst
MIXED = ["今天天气不错, let us go outside。", "I have 3 apples and 12 pears."]


def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        data = json.dumps(body).encode() if body is not None else None
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"} if data else {})
        resp = conn.getresponse()
        return resp.status, resp.reason, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _check_wav(data: bytes, what: str) -> np.ndarray:
    from scipy.io import wavfile

    sr, pcm = wavfile.read(io.BytesIO(data))
    if sr != 16000 or pcm.dtype != np.int16 or pcm.ndim != 1:
        fail(f"{what}: not a 16 kHz mono int16 wav ({sr}, {pcm.dtype}, {pcm.shape})")
    if len(pcm) == 0 or len(pcm) % 256:
        fail(f"{what}: {len(pcm)} samples is not n_frames * 256")
    if int(np.abs(pcm.astype(np.int32)).max()) < 100:
        fail(f"{what}: silent")
    return pcm


def replay_on_cpu(cpu_model, served) -> list:
    """Served generator calls (inputs and outputs as recorded on the card)
    through the CPU model with the same weights: the smallest call, and the
    smallest and the largest of those with more than one row, among the
    calls of at most REPLAY_MAX_FRAMES batch x mel frames. Durations must be
    equal and the waveforms within TOL_CPU x max |wav|."""
    by_shape = {}
    for call in served:
        by_shape.setdefault((call["args"][0].shape[0], call["max_frames"]), call)
    keys = sorted((k for k in by_shape if k[0] * k[1] <= REPLAY_MAX_FRAMES),
                  key=lambda k: (k[0] * k[1], k))
    batched = [k for k in keys if k[0] > 1]
    if not batched:
        fail(f"no served call with more than one row is small enough to replay: {sorted(by_shape)}")
    out = []
    for key in dict.fromkeys([keys[0], batched[0], batched[-1]]):
        call = by_shape[key]
        t0 = time.perf_counter()
        with torch.inference_mode():
            cpu = cpu_model(*call["args"], max_frames=call["max_frames"], alpha=call["alpha"],
                            dtype=call["dtype"])
        secs = time.perf_counter() - t0
        rows = int(call["args"][0].shape[0])
        real = int((call["args"][1] > 1).sum())
        if not torch.equal(cpu["durations"], call["durations"]):
            fail(f"replay of served call {key}: durations differ between card and CPU")
        scale = float(cpu["wav_predictions"].abs().max())
        err = float((cpu["wav_predictions"] - call["wav"]).abs().max())
        log(f"[serve] replay on the CPU of a served call, batch {rows} ({real} requests) x "
            f"{call['tokens']} tokens x {call['max_frames']} frames: durations equal, wav max "
            f"|card - cpu| {err:.2e} (max |wav| {scale:.3f}, tol {TOL_CPU} x max), "
            f"{secs:.1f} s on the CPU")
        if scale < 1e-3 or err > TOL_CPU * scale:
            fail(f"replay of served call {key}: card and CPU waveforms disagree")
        out.append(dict(batch=rows, requests=real, tokens=call["tokens"],
                        max_frames=call["max_frames"], err=err, scale=scale, cpu_seconds=secs))
    return out


def embed_contention(embedder, engine, profiled: bool) -> dict:
    """Where a burst's embedding time goes: the embedding work of one burst
    (8 requests, a prompt and a content text each) done alone on the card in
    several arrangements, and once beside a generator call. Median wall ms
    of 3 repetitions, and the median over threads of a thread's own ms."""
    texts = [t for t, _, _ in ENGLISH]
    lock = threading.Lock()

    def twice(text):
        embedder.embed(text)
        embedder.embed(text)

    def twice_locked(text):
        for _ in range(2):
            with lock:
                embedder.embed(text)

    def generator_call():
        engine.warmup(shapes=[(8, 96, 768)])

    def fan_out(work, beside=None):
        spans = [0.0] * len(texts)
        gate = threading.Barrier(len(texts) + 1)

        def one(i):
            gate.wait(timeout=60)
            t0 = time.perf_counter()
            work(texts[i])
            spans[i] = (time.perf_counter() - t0) * 1e3

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(texts))]
        for t in threads:
            t.start()
        side = threading.Thread(target=beside) if beside else None
        torch.cuda.synchronize()
        if side:
            side.start()
            time.sleep(0.03)  # its kernels are queued before the embeddings start
        t0 = time.perf_counter()
        gate.wait(timeout=60)
        for t in threads:
            t.join(timeout=300)
        wall = (time.perf_counter() - t0) * 1e3
        if side:
            side.join(timeout=300)
        if any(t.is_alive() for t in threads) or (side and side.is_alive()):
            fail("an embedding thread did not come back")
        return wall, float(np.median(spans))

    def single(work):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        work()
        return (time.perf_counter() - t0) * 1e3, None

    arrangements = [
        ("one thread, 16 x embed", lambda: single(lambda: [twice(t) for t in texts])),
        ("one thread, 1 x embed_batch of 16", lambda: single(lambda: embedder.embed_batch(texts * 2))),
        ("8 threads, 2 x embed each", lambda: fan_out(twice)),
        ("8 threads, 2 x embed each behind one lock", lambda: fan_out(twice_locked)),
        ("8 threads, 1 x embed_batch of 2 each", lambda: fan_out(lambda t: embedder.embed_batch([t, t]))),
        ("generator call alone, batch 8 x 96 tokens x 768 frames, f32", lambda: single(generator_call)),
        ("8 threads, 2 x embed each, beside that generator call",
         lambda: fan_out(twice, beside=generator_call)),
    ]
    out = {}
    for name, run in arrangements:
        run()  # warm
        reps = [run() for _ in range(3)]
        wall = float(np.median([r[0] for r in reps]))
        per_thread = float(np.median([r[1] for r in reps])) if reps[0][1] is not None else None
        out[name] = dict(wall_ms=wall, thread_ms=per_thread, walls_ms=[r[0] for r in reps])
        line = f"[serve] embedding work of one burst, {name}: {wall:.1f} ms"
        if per_thread is not None:
            line += f", a thread's own {per_thread:.1f} ms"
        if profiled and "generator" not in name:
            out[name]["device_busy_ms"] = busy = device_busy_ms(run)
            line += (f"; card busy {busy:.1f} ms (torch.profiler, its own repetition)" if busy
                     else "; card busy: the profiler saw no device time")
        log(line)
    return out


def phase_serve(dev, cfg, vocab, model, embedder, cpu_model, profiled: bool) -> dict:
    from emotivoice_tpu_torch.frontend.en import read_lexicon
    from emotivoice_tpu_torch.frontend.mixed import g2p_cn_en
    from emotivoice_tpu_torch.ops.cuda.mrf_stage import fused_mrf_stage
    from emotivoice_tpu_torch.ops.cuda.resblock import fused_residual_unit
    from emotivoice_tpu_torch.serving import api
    from emotivoice_tpu_torch.serving.engine import SynthesisEngine

    found = {m: importlib.util.find_spec(m) is not None for m in OPTIONAL}
    log(f"[serve] optional packages: {found}")
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "lexicon.txt"), "w", encoding="utf-8") as f:
            f.write(LEXICON_LINES)
        lexicon = read_lexicon(f.name)

    engine = SynthesisEngine(cfg, model, vocab, device=dev, dtype="f32")
    tl = threading.local()
    records, records_lock = [], threading.Lock()
    calls = [0]  # generator calls; the hook runs inside the engine's serialized run
    served = []  # traffic's generator calls, inputs and outputs, for the replay on the CPU

    def on_call(_module, args, kwargs, out):
        calls[0] += 1
        if bool(args[0].any()):  # the warmup's rows are all pad tokens
            served.append(dict(
                args=[a.cpu() for a in args], tokens=args[0].shape[1], **kwargs,
                wav=out["wav_predictions"].cpu(), durations=out["durations"].cpu()))

    hook = model.register_forward_hook(on_call, with_kwargs=True)
    shapes, shape_hooks = watch_stage_shapes(model)

    def rec():
        return getattr(tl, "rec", None) or {}

    def clocked(fn, key):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                r = rec()
                r[key] = r.get(key, 0.0) + time.perf_counter() - t0
        return wrapper

    def g2p(text):
        out = g2p_cn_en(text, lexicon)
        n = len(vocab.encode(out.split()))
        rec().setdefault("tokens", []).append(n)
        if n < 3:
            raise AssertionError(f"g2p produced an empty sequence for {text!r}")
        return out

    service = api.TTSService(
        engine, g2p_fn=clocked(g2p, "g2p_s"), embed_fn=clocked(embedder.embed, "embed_s"),
        speaker2id={str(i): i for i in range(cfg.am.n_speaker)}, batching=True)
    batcher = service._batcher
    synthesize = service._synthesize

    def synth(reqs):
        t0 = time.perf_counter()
        results = synthesize(reqs)
        r = rec()
        r["synth_s"] = r.get("synth_s", 0.0) + time.perf_counter() - t0
        r["frames"] = r.get("frames", 0) + sum(x.n_frames for x in results)
        r["chunks"] = r.get("chunks", 0) + len(reqs)
        return results

    def around(fn, streamed):
        def wrapper(input_text, *a, **kw):
            tl.rec = r = dict(input=input_text, streamed=streamed)
            t0 = time.perf_counter()
            try:
                return fn(input_text, *a, **kw)
            finally:
                r["total_s"] = time.perf_counter() - t0
                with records_lock:
                    records.append(r)
        return wrapper

    service._synthesize = synth
    service.speech = around(service.speech, False)
    service.speech_stream = around(service.speech_stream, True)
    write_wav = api.write_wav
    api.write_wav = clocked(write_wav, "wav_s")

    server = api.make_stdlib_server(service, "127.0.0.1", 0)
    port = server.server_address[1]
    serving = threading.Thread(target=server.serve_forever, daemon=True, name="http-server")
    serving.start()
    grid = engine.warmup_grid(batches=(1,))
    progress = []
    answers, sent_ok, sent_err = {}, 0, 0
    try:
        # Cut grid: batch 1 only, f32 (the full grid's B=16 shapes at 2048
        # frames are several bench buckets each in f32). The counts are set
        # to 0 before the daemon exists, so nothing can launch in between.
        fused_residual_unit.launches = 0
        fused_mrf_stage.launches = 0
        calls[0] = 0
        warm = engine.warmup_background(batches=(1,),
                                        progress_cb=lambda i, n: progress.append(i))
        t_traffic = time.perf_counter()

        status, _, _, body = _http(port, "GET", "/healthz")
        if status != 200 or json.loads(body) != {"status": "ok"}:
            fail(f"/healthz: {status} {body[:80]!r}")
        status, _, _, body = _http(port, "GET", "/v1/voices")
        if status != 200 or len(json.loads(body)["voices"]) != cfg.am.n_speaker:
            fail(f"/v1/voices: {status}")

        first = [dict(input=t, voice=v, speed=s, response_format="wav") for t, v, s in ENGLISH]
        if found["pypinyin"]:
            first += [dict(input=t, voice="0", response_format="wav") for t in MIXED]
        # The same burst twice: the first meets handler threads that have
        # not touched the card yet, the second shows the steady state.
        bursts = [first, [dict(b, input=b["input"] + AGAIN) for b in first]]
        for posts in bursts:
            start = threading.Barrier(len(posts))

            def post(body):
                start.wait(timeout=60)
                answers[body["input"]] = _http(port, "POST", "/v1/audio/speech", body)

            threads = [threading.Thread(target=post, args=(b,)) for b in posts]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            if any(t.is_alive() for t in threads) or any(b["input"] not in answers for b in posts):
                fail("a concurrent request did not come back")
            for body in posts:
                status, reason, _, _ = answers[body["input"]]
                if status != 200:
                    fail(f"POST {body['input']!r}: {status} {reason}")
            sent_ok += len(posts)

        for text in (LONGFORM, STREAMED):  # the non-streamed twins
            body = dict(input=text, voice="0", response_format="wav")
            answers[text] = _http(port, "POST", "/v1/audio/speech", body)
            if answers[text][0] != 200:
                fail(f"POST {text[:30]!r}: {answers[text][:2]}")
        sent_ok += 2
        status, _, headers, streamed = _http(port, "POST", "/v1/audio/speech",
                                             dict(input=STREAMED, voice="0", stream=True))
        sent_ok += 1
        if status != 200 or headers.get("Transfer-Encoding") != "chunked":
            fail(f"stream: {status} {headers}")
        if (len(streamed) < 44 or streamed[:4] != b"RIFF" or streamed[4:8] != b"\xff" * 4
                or streamed[36:40] != b"data" or streamed[40:44] != b"\xff" * 4):
            fail("stream: not a 44-byte header with 0xFFFFFFFF lengths")
        twin = _check_wav(answers[STREAMED][3], "stream twin")
        n_streamed = (len(streamed) - 44) // 2
        if n_streamed != len(twin):
            fail(f"stream: {n_streamed} samples, the non-streamed answer has {len(twin)}")

        status, reason, _, _ = _http(port, "POST", "/v1/audio/speech",
                                     dict(input="Hello.", voice="nobody", response_format="wav"))
        if status != 400 or "unknown voice" not in reason:
            fail(f"unknown voice: {status} {reason}")
        sent_err += 1
        status, reason, _, data = _http(port, "POST", "/v1/audio/speech",
                                        dict(input="The default format is mp three.", voice="0"))
        has_encoder = found_encoder()
        if has_encoder and status != 200 or not has_encoder and (
                status != 400 or "response_format='wav'" not in reason):
            fail(f"mp3 with{'' if has_encoder else 'out'} an encoder: {status} {reason}")
        sent_ok += 1  # synthesis is observed before the transcode
        if not found["pypinyin"]:
            status, reason, _, _ = _http(port, "POST", "/v1/audio/speech",
                                         dict(input=HANZI, voice="0", response_format="wav"))
            if status != 500 or "pypinyin is required" not in reason:
                fail(f"hanzi without pypinyin: {status} {reason}")
            sent_err += 1
        traffic_s = time.perf_counter() - t_traffic

        warm.join(timeout=600)
        if warm.is_alive():
            fail("background warmup did not finish")
        torch.cuda.synchronize()
        # Every answer is back and the daemon has ended: nothing launches now.
        launches = {"fused_residual_unit": fused_residual_unit.launches,
                    "fused_mrf_stage": fused_mrf_stage.launches}
        gen_calls = calls[0]
        status, _, _, body = _http(port, "GET", "/v1/metrics")
        if status != 200:
            fail(f"/v1/metrics: {status}")
        metrics = json.loads(body)
    finally:
        server.shutdown()
        server.server_close()
        serving.join(timeout=60)
        service.close()
        hook.remove()
        for h in shape_hooks:
            h.remove()
        api.write_wav = write_wav
    if serving.is_alive() or batcher._worker.is_alive():
        fail("the server or the batcher's worker did not stop")

    by_input = {(r["input"], r["streamed"]): r for r in records}
    for r in records:
        log(f"[serve] g2p tokens {r.get('tokens')}, {r.get('frames', 0):>4} frames, "
            f"{r['total_s'] * 1e3:7.1f} ms{' (streamed, first part)' if r['streamed'] else ''}: "
            f"{r['input'][:60]!r}")
    lex = by_input[(ENGLISH[3][0], False)]
    if "[OY2]" not in g2p_cn_en(ENGLISH[3][0], lexicon) or "[OY2]" in g2p_cn_en(ENGLISH[3][0]):
        fail("the lexicon entry did not reach g2p")
    for text, (_, _, _, data) in answers.items():
        n, frames = len(_check_wav(data, text)), by_input[(text, False)]["frames"]
        if n != frames * engine.up:
            fail(f"{text!r}: {n} samples for {frames} frames")
    long_rec = by_input[(LONGFORM, False)]
    if long_rec["chunks"] < 2 or len(long_rec["tokens"]) != long_rec["chunks"]:
        fail(f"long-form input was not chunked: {long_rec}")
    log(f"[serve] long-form: {len(LONGFORM)} chars in {long_rec['chunks']} chunks, tokens "
        f"{long_rec['tokens']}, {long_rec['frames']} frames; stream: {n_streamed} samples in "
        f"{by_input[(STREAMED, True)]['chunks']} chunks, equal to its non-streamed twin; "
        f"lexicon request {lex['tokens'][0]} tokens")

    chunks_sent = sum(r.get("chunks", 0) for r in records)
    want = dict(requests=sent_ok, errors=sent_err)
    b = metrics["batching"]
    if any(metrics[k] != v for k, v in want.items()):
        fail(f"metrics {({k: metrics[k] for k in want})} != sent {want}")
    if b["batched_requests"] != chunks_sent or not b["dispatches"] < b["batched_requests"]:
        fail(f"batching {b}: {chunks_sent} chunks were sent and some must have shared a dispatch")
    overflow = dict(redispatches=engine.saturation_redispatches,
                    truncations=engine.saturation_truncations)
    if metrics["duration_overflow"] != overflow or overflow["truncations"]:
        fail(f"duration_overflow {metrics['duration_overflow']} vs engine {overflow}")
    if gen_calls != b["dispatches"] + overflow["redispatches"] + len(grid):
        fail(f"{gen_calls} generator calls for {b['dispatches']} dispatches + "
             f"{overflow['redispatches']} redispatches + {len(grid)} warmup shapes")
    if launches["fused_residual_unit"] != 18 * gen_calls or launches["fused_mrf_stage"] != 2 * gen_calls:
        fail(f"launch counters {launches} != 18/2 per generator call x {gen_calls}")
    if engine.warmup_failures or progress != list(range(1, len(grid) + 1)):
        fail(f"background warmup: {engine.warmup_failures} failures, progress {progress}")
    log(f"[serve] {sent_ok} answered + {sent_err} refused requests in {traffic_s:.2f} s while the "
        f"background warmup walked {len(grid)} shapes (batch 1, f32; 0 failures); "
        f"{chunks_sent} chunks in {b['dispatches']} dispatches (mean batch {b['mean_batch']}), "
        f"{gen_calls} generator calls, launches {launches}, duration overflow {overflow}")
    lat, rtf = metrics["latency_s"], metrics["rtf"]
    log(f"[serve] /v1/metrics: latency p50 {lat['p50'] * 1e3:.1f} ms, p95 {lat['p95'] * 1e3:.1f} ms; "
        f"RTF p50 {rtf['p50']:.4f}; {metrics['audio_seconds_served']} s of audio")
    split = {}
    for name, posts in zip(("first burst", "second burst"), bursts):
        recs = [by_input[(b["input"], False)] for b in posts]
        split[name] = {}
        for key in ("g2p_s", "embed_s", "synth_s", "wav_s", "total_s"):
            vals = sorted(r[key] * 1e3 for r in recs)
            split[name][key[:-2] + "_ms"] = dict(p50=vals[len(vals) // 2], max=vals[-1])
        log(f"[serve] host split per request, {name} of {len(recs)} at once (time.perf_counter, "
            "p50 / max ms): " + ", ".join(f"{k[:-3]} {v['p50']:.2f} / {v['max']:.2f}"
                                          for k, v in split[name].items())
            + "; synth = wait for the batch + the generator call")
    # The kernels at every shape this phase gave them (traffic's batch
    # buckets and the warmup grid), then whole served calls against the CPU.
    path = check_path_kernels(dev, model, shapes, "serve")
    served_shapes = sorted({(c["args"][0].shape[0], c["tokens"], c["max_frames"]) for c in served})
    log(f"[serve] traffic's generator calls (batch, tokens, frames): {served_shapes}")
    if len(served) != b["dispatches"] + overflow["redispatches"]:
        fail(f"{len(served)} recorded traffic calls for {b['dispatches']} dispatches")
    replays = replay_on_cpu(cpu_model, served)
    contention = embed_contention(embedder, engine, profiled)
    report["serve"] = dict(optional=found, metrics=metrics, launches=launches,
                           generator_calls=gen_calls, warmup_shapes=len(grid),
                           traffic_s=traffic_s, host_split_ms=split,
                           requests=records, served_shapes=served_shapes, replays=replays,
                           embed_contention_ms=contention)
    return dict(launches=launches, path=path)


# ---------------------------------------------------------------------------
# 8. joint GAN training
# ---------------------------------------------------------------------------

def _train_cfg(n_vocab: int, n_speaker: int):
    import dataclasses

    from emotivoice_tpu_torch.config import EmotiVoiceConfig

    cfg = EmotiVoiceConfig()
    return cfg.replace(
        am=dataclasses.replace(cfg.am, n_vocab=n_vocab, n_speaker=n_speaker),
        train=dataclasses.replace(cfg.train, batch_size=TRAIN_B,
                                  iters_per_validation=TRAIN_STEPS,
                                  iters_per_checkpoint=TRAIN_CKPT))


def _parse_log(path: str) -> list:
    """(prefix-less) metric dicts of train_log.txt, in order."""
    rows = []
    for line in open(path).read().splitlines():
        fields = dict(f.split("=", 1) for f in line.split())
        rows.append({k: float(v) for k, v in fields.items()})
    return rows


def step_split_ms(trainer, batch, reps: int = 3) -> dict:
    """Device ms of one train step's parts (CUDA events, median of `reps`):
    the generator's forward (alignment search included), the D step, the G
    step (D forward on the fake, losses, backward, Adam); and alone, on the
    same log_p_attn, the alignment search (MAS) and the CTC loss."""
    from emotivoice_tpu_torch.ops.align import forward_sum_loss, viterbi_decode

    parts = {k: [] for k in ("generator_forward", "d_step", "g_step", "step", "mas", "ctc")}
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        ev[0].record()
        out, y = trainer.generator_forward(batch)
        ev[1].record()
        trainer.discriminator_step(y, out["wav_predictions"])
        ev[2].record()
        trainer.generator_step(out, y)
        ev[3].record()
        trainer.count += 1
        torch.cuda.synchronize()
        for k, (a, b) in zip(("generator_forward", "d_step", "g_step", "step"),
                             ((0, 1), (1, 2), (2, 3), (0, 3))):
            parts[k].append(ev[a].elapsed_time(ev[b]))
        lp = out["log_p_attn"].detach()
        tl, fl = batch["text_lengths"], batch["mel_lengths"]
        with torch.no_grad():
            parts["mas"].append(timed(lambda: viterbi_decode(lp, tl, fl), iters=1, warmup=0))
            parts["ctc"].append(timed(lambda: forward_sum_loss(lp, tl, fl), iters=1, warmup=0))
    return {k: float(np.median(v)) for k, v in parts.items()}


def train_step_card_vs_cpu(cfg, models, batch, dtype=torch.float32) -> dict:
    """One step from the same state (copies of the (generator, discriminator)
    `models`, fresh optimizers) and batch (its first 2 rows) on the batch's
    card and on the CPU, in compute `dtype`, dropout off, the same segment
    starts: every loss and the gradient norms of TRAIN_GRAD_PARAMS, relative
    to the CPU's."""
    from emotivoice_tpu_torch.models.discriminator import Discriminator
    from emotivoice_tpu_torch.models.jets import JETSGenerator
    from emotivoice_tpu_torch.ops.segments import random_starts
    from emotivoice_tpu_torch.training.step import TrainStep

    rows = {k: v[:2] for k, v in batch.items()}
    starts = random_starts(rows["mel_lengths"], cfg.train.segment_size).cpu()
    g_state = {k: v.detach().cpu() for k, v in models[0].state_dict().items()}
    d_state = {k: v.detach().cpu() for k, v in models[1].state_dict().items()}
    got = {}
    card_dev = rows["tokens"].device
    for name, device in (("card", card_dev), ("cpu", torch.device("cpu"))):
        model = JETSGenerator(cfg, kernels=False)
        model.load_state_dict(g_state)
        disc = Discriminator(cfg.disc, dtype)
        disc.load_state_dict(d_state)
        model, disc = model.to(device).eval(), disc.to(device).eval()
        step = TrainStep(cfg, model, disc, dtype=dtype)
        t0 = time.perf_counter()
        metrics = step({k: v.to(device) for k, v in rows.items()}, start_idxs=starts)
        secs = time.perf_counter() - t0
        named = {**dict(model.named_parameters()), **dict(disc.named_parameters())}
        got[name] = dict(metrics={k: float(v) for k, v in metrics.items()},
                         grads={k: float(named[k].grad.norm()) for k in TRAIN_GRAD_PARAMS},
                         seconds=secs)
    card, cpu = got["card"], got["cpu"]
    loss_err = {k: abs(card["metrics"][k] - v) / max(abs(v), 1e-12)
                for k, v in cpu["metrics"].items()}
    grad_err = {k: abs(card["grads"][k] - v) / max(abs(v), 1e-12) for k, v in cpu["grads"].items()}
    return dict(card=card, cpu=cpu, loss_rel_err=loss_err, grad_rel_err=grad_err)


def phase_train(dev, profiled: bool = False) -> dict:
    import contextlib
    import emotivoice_tpu_torch.training.validate as validate_mod
    from emotivoice_tpu_torch.data.dataset import BucketedLoader, PromptTTSDataset
    from emotivoice_tpu_torch.data.synthetic_corpus import main as make_corpus
    from emotivoice_tpu_torch.frontend.tokens import TokenVocab, load_label_list
    from emotivoice_tpu_torch.ops.cuda.mrf_stage import fused_mrf_stage
    from emotivoice_tpu_torch.ops.cuda.resblock import fused_residual_unit
    from emotivoice_tpu_torch.training.loop import build_models, to_device, train

    # The kernels refuse a grad-requiring operand on the card too.
    xg = torch.randn(1, 64, 128, device=dev, requires_grad=True)
    wg = torch.randn(3, 128, 128, device=dev) * 0.05
    bg = torch.zeros(128, device=dev)
    try:
        fused_residual_unit(xg, wg, bg, wg, bg, 3, 1)
        fail("fused_residual_unit accepted an operand that requires grad")
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        corpus, out = os.path.join(tmp, "corpus"), os.path.join(tmp, "out")
        t0 = time.perf_counter()
        make_corpus(["--out", corpus, "--n-train", "64", "--n-valid", "8", "--n-speakers", "4",
                     "--seed", str(SEED)])
        vocab = TokenVocab.from_file(os.path.join(corpus, "tokenlist"))
        speakers = load_label_list(os.path.join(corpus, "speakers"))
        cfg = _train_cfg(len(vocab), len(speakers))
        zeros = np.zeros(cfg.am.bert_embedding, np.float32)
        datasets = [PromptTTSDataset(os.path.join(corpus, name), cfg, vocab, speakers,
                                     lambda text: zeros, cache_dir=os.path.join(tmp, "cache"),
                                     device=dev)
                    for name in ("datalist.jsonl", "valid.jsonl")]
        for ds in datasets:  # features on the card, into the cache
            for i in range(len(ds)):
                ds[i]
        prep_s = time.perf_counter() - t0
        train_ds, valid_ds = datasets
        loader = lambda: BucketedLoader(train_ds, TRAIN_B, seed=SEED)  # noqa: E731
        valid_calls = []  # one generator call per validation batch

        def valid_loader():
            valid_calls.append(dict(snapshot=(fused_residual_unit.launches,
                                              fused_mrf_stage.launches), batches=0))
            for b in BucketedLoader(valid_ds, TRAIN_B, shuffle=False, drop_last=False,
                                    pad_to_batch=True):
                valid_calls[-1]["batches"] += 1
                yield b

        steps_per_epoch = len(train_ds) // TRAIN_B
        model, disc = build_models(cfg, dev)
        n_params = (sum(p.numel() for p in model.parameters()),
                    sum(p.numel() for p in disc.parameters()))
        u0 = disc.msd.discriminators[0].convs[0].weight_u.clone()
        shapes = set()  # (B, T, C, dtype) handed to the kernels (validation only)

        def on_up(_module, _args, y):
            if model.generator.kernels:
                shapes.add((*y.shape, y.dtype))

        hooks = [up.register_forward_hook(on_up) for up in model.generator.ups]
        fused_residual_unit.launches = 0
        fused_mrf_stage.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            trainer = train(cfg, loader, out, total_steps=TRAIN_STEPS,
                            steps_per_epoch=steps_per_epoch, valid_batch_iter_fn=valid_loader,
                            log_every=1, device=dev, models=(model, disc))
            torch.cuda.synchronize()
        finally:
            for h in hooks:
                h.remove()
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        launches = {"fused_residual_unit": fused_residual_unit.launches,
                    "fused_mrf_stage": fused_mrf_stage.launches}
        if len(valid_calls) != 1 or valid_calls[0]["batches"] != 1:
            fail(f"[train] validation ran {valid_calls}, expected one pass over one batch")
        in_steps = dict(zip(launches, valid_calls[0]["snapshot"]))
        in_valid = {k: launches[k] - in_steps[k] for k in launches}
        gen_calls = valid_calls[0]["batches"]
        log(f"[train] corpus 64 + 8 utterances, 4 speakers, features on the card: {prep_s:.1f} s; "
            f"model {n_params[0] / 1e6:.1f} M + discriminator {n_params[1] / 1e6:.1f} M "
            f"parameters, batch {TRAIN_B}, f32, {steps_per_epoch} steps per epoch")
        log(f"[train] {trainer.count} steps + validation in {train_s:.1f} s; kernel launches in "
            f"the train steps {in_steps}, in validation {in_valid} over {gen_calls} generator "
            f"call(s); peak memory {peak / 2**30:.2f} GiB")
        if any(in_steps.values()):
            fail(f"[train] the train steps launched kernels: {in_steps}")
        if (in_valid["fused_residual_unit"] != 18 * gen_calls
                or in_valid["fused_mrf_stage"] != 2 * gen_calls):
            fail(f"[train] validation launches {in_valid} != 18/2 per generator call x {gen_calls}")
        rows = _parse_log(os.path.join(out, "log", "train_log.txt"))
        steps = [r for r in rows if "g_loss" in r]
        valid = [r for r in rows if "mel_l1" in r]
        if [int(r["step"]) for r in steps] != list(range(1, TRAIN_STEPS + 1)) or len(valid) != 1:
            fail(f"[train] log holds steps {[r['step'] for r in steps]} and {len(valid)} validations")
        for r in steps + valid:
            if not all(np.isfinite(v) for v in r.values()):
                fail(f"[train] non-finite loss at step {r['step']}: {r}")
        u1 = disc.msd.discriminators[0].convs[0].weight_u
        u_moved = float((u1 - u0).abs().max())
        if not u_moved > 0:
            fail("[train] the spectral-norm u did not change over the D steps")
        sps = [r["steps_per_sec"] for r in steps]
        log(f"[train] mel_loss step 1 {steps[0]['mel_loss']:.4f} -> step {TRAIN_STEPS} "
            f"{steps[-1]['mel_loss']:.4f}; g_loss {steps[0]['g_loss']:.3f} -> "
            f"{steps[-1]['g_loss']:.3f}, d_loss {steps[0]['d_loss']:.3f} -> "
            f"{steps[-1]['d_loss']:.3f}; validation {({k: round(v, 4) for k, v in valid[0].items()})}; "
            f"spectral u moved by {u_moved:.3g}; loop's steps/s median {np.median(sps):.2f}")
        ckpts = sorted(os.listdir(os.path.join(out, "ckpt")))
        want = [f"{k}_{s:08d}" for k in ("do", "g") for s in (TRAIN_CKPT, TRAIN_STEPS)]
        if ckpts != want:
            fail(f"[train] checkpoints {ckpts} != {want}")

        path = check_path_kernels(dev, model, shapes, "train")

        # Steady-state step time, and its split, on a fixed batch.
        batch = to_device(next(iter(loader())), dev)
        from emotivoice_tpu_torch.training.step import TrainStep

        steady = {}
        for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            disc.dtype = dtype  # the same weights; bf16 gets its own (fresh) Adam states
            tr = trainer if dtype == torch.float32 else TrainStep(cfg, model, disc,
                                                                  steps_per_epoch, dtype=dtype)
            torch.cuda.reset_peak_memory_stats(dev)
            walls = []
            for i in range(8):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr(batch)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            peak_step = torch.cuda.max_memory_allocated(dev)
            # the first bf16 steps pay cuDNN's choice of kernels for new shapes
            wall_ms = float(np.median(walls[2:]))
            split = step_split_ms(tr, batch)
            steady[dname] = dict(walls=walls, wall_ms=wall_ms, split=split, peak_bytes=peak_step)
            if profiled:
                busy, top = device_kernels(lambda: tr(batch), top=8)
                steady[dname].update(device_busy_ms=busy, top_kernels=top)
                log(f"[train] {dname} step, torch.profiler: the card is busy "
                    + (f"{busy:.1f} ms" if busy else "for a time the profiler did not see")
                    + "; most device time: " + "; ".join(
                        f"{name} {ms:.1f} ms x{n}" for name, ms, n in top))
            t_feats = int(batch["mel"].shape[1])
            log(f"[train] {dname} step at batch {TRAIN_B} x {int(batch['tokens'].shape[1])} tokens "
                f"x {t_feats} frames: median wall of runs 3-8 {wall_ms:.1f} ms "
                f"({1e3 / wall_ms:.2f} steps/s; runs " + ", ".join(f"{w:.1f}" for w in walls)
                + f"); peak memory over these "
                f"steps {peak_step / 2**30:.2f} GiB")
            log(f"[train] {dname} device ms of a step (CUDA events, median of 3): generator "
                f"forward {split['generator_forward']:.1f} (alignment search inside), D step "
                f"{split['d_step']:.1f}, G step (D on the fake, losses, backward, Adam) "
                f"{split['g_step']:.1f}, whole {split['step']:.1f}; alone on the same log_p_attn: "
                f"MAS {split['mas']:.1f} ({t_feats} frames), CTC {split['ctc']:.2f}")
        disc.dtype = torch.float32
        walls, wall_ms, split = (steady["f32"][k] for k in ("walls", "wall_ms", "split"))

        # Validation time per generator call (kernels on, inference mode).
        vbatch = to_device(next(iter(BucketedLoader(valid_ds, TRAIN_B, shuffle=False,
                                                    drop_last=False, pad_to_batch=True))), dev)
        model.generator.kernels = True
        try:
            model.eval()
            valid_ms = timed(lambda: validate_mod.eval_step(model, vbatch), iters=3)
        finally:
            model.generator.kernels = False
            model.train()
        log(f"[train] validation eval step (batch {TRAIN_B} x {int(vbatch['mel'].shape[1])} frames, "
            f"one generator call with the kernels): {valid_ms:.1f} ms")

        # Resume from the step-20 checkpoint: the final pair (step 30) goes,
        # so step 20's is the newest; the second call runs past the first's end.
        for k in ("g", "do"):
            os.remove(os.path.join(out, "ckpt", f"{k}_{TRAIN_STEPS:08d}"))
        fused_residual_unit.launches = 0
        fused_mrf_stage.launches = 0
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            resumed = train(cfg, loader, out, total_steps=TRAIN_RESUMED_TO,
                            steps_per_epoch=steps_per_epoch, log_every=1, device=dev)
        torch.cuda.synchronize()
        said = printed.getvalue().strip()
        log(f"[train] second call, total_steps {TRAIN_RESUMED_TO}: printed {said!r}")
        after = [int(r["step"]) for r in _parse_log(os.path.join(out, "log", "train_log.txt"))
                 if "g_loss" in r][TRAIN_STEPS:]
        if (f"resumed from step {TRAIN_CKPT}" not in said or resumed.count != TRAIN_RESUMED_TO
                or after != list(range(TRAIN_CKPT + 1, TRAIN_RESUMED_TO + 1))):
            fail(f"[train] resume: printed {said!r}, count {resumed.count}, logged steps {after}")
        if fused_residual_unit.launches or fused_mrf_stage.launches:
            fail("[train] the resumed train steps launched kernels")

        cmp = train_step_card_vs_cpu(cfg, (trainer.model, trainer.disc), batch)
        worst_loss = max(cmp["loss_rel_err"].items(), key=lambda kv: kv[1])
        worst_grad = max(cmp["grad_rel_err"].items(), key=lambda kv: kv[1])
        log(f"[train] one step card vs CPU (2 rows, dropout off, the same segment starts): "
            f"worst loss rel err {worst_loss[1]:.2e} ({worst_loss[0]}; tol {TOL_TRAIN_LOSS}), "
            f"worst grad-norm rel err {worst_grad[1]:.2e} ({worst_grad[0]}; tol {TOL_TRAIN_GRAD}) "
            f"over {len(TRAIN_GRAD_PARAMS)} parameters; {cmp['cpu']['seconds']:.1f} s on the CPU")
        if not (worst_loss[1] <= TOL_TRAIN_LOSS and worst_grad[1] <= TOL_TRAIN_GRAD):
            fail(f"[train] card and CPU disagree: {cmp['loss_rel_err']} {cmp['grad_rel_err']}")
        # bf16 from the seeded parameters, which every run starts from: the
        # trained state differs from run to run (the card's f32 sums are not
        # bit-reproducible), and from it the bf16 roundings of the two
        # devices reach several 1e-2 of some gradient norms, an amount that
        # moves with the state; that comparison is printed, not held.
        cmp16 = train_step_card_vs_cpu(cfg, build_models(cfg, torch.device("cpu")), batch,
                                       torch.bfloat16)
        cmp16_trained = train_step_card_vs_cpu(cfg, (trainer.model, trainer.disc), batch,
                                               torch.bfloat16)
        for what, c in (("from the seeded parameters", cmp16),
                        (f"from the trained state (after {trainer.count} steps; not held)",
                         cmp16_trained)):
            worst_loss = max(c["loss_rel_err"].items(), key=lambda kv: kv[1])
            worst_grad = max(c["grad_rel_err"].items(), key=lambda kv: kv[1])
            log(f"[train] one bf16 step card vs CPU {what} (both in bf16, 2 rows, dropout off, "
                f"the same segment starts): worst loss rel err {worst_loss[1]:.2e} "
                f"({worst_loss[0]}; tol {TOL_TRAIN_LOSS_BF16}), worst grad-norm rel err "
                f"{worst_grad[1]:.2e} ({worst_grad[0]}; tol {TOL_TRAIN_GRAD_BF16}); "
                f"{c['cpu']['seconds']:.1f} s on the CPU")
        worst_loss = max(cmp16["loss_rel_err"].values())
        worst_grad = max(cmp16["grad_rel_err"].values())
        if not (worst_loss <= TOL_TRAIN_LOSS_BF16 and worst_grad <= TOL_TRAIN_GRAD_BF16):
            fail(f"[train] bf16: card and CPU disagree: {cmp16['loss_rel_err']} "
                 f"{cmp16['grad_rel_err']}")
        # [tools] loads the newest pair, in the reference's format, with its tokenlist
        keep = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        for kind in ("g", "do"):
            shutil.move(os.path.join(out, "ckpt", f"{kind}_{TRAIN_RESUMED_TO:08d}"), keep)
        shutil.copy(os.path.join(corpus, "tokenlist"), keep)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["train"] = dict(
        steps=TRAIN_STEPS, batch=TRAIN_B, params=n_params, prep_s=prep_s, train_s=train_s,
        launches_steps=in_steps, launches_valid=in_valid, valid_generator_calls=gen_calls,
        peak_bytes=peak, log=rows, u_moved=u_moved, step_wall_ms=walls,
        step_wall_ms_median=wall_ms, steps_per_s=1e3 / wall_ms, split_ms=split,
        valid_ms=valid_ms, resumed_said=said, card_vs_cpu=cmp, steady=steady,
        card_vs_cpu_bf16=cmp16, card_vs_cpu_bf16_trained=cmp16_trained)
    return dict(launches=in_valid, launches_steps=in_steps, path=path, ckpt_dir=keep)


def phase_train_curves(dev) -> dict:
    """CURVE_STEPS steps at batch CURVE_B on a 48-utterance corpus (the size
    of the JAX package's recorded run, docs/runs/TRAINING_RUN.md) in f32 and
    in bf16 from the same seeded parameters, validation every CURVE_VALID
    steps: losses finite, the mel loss's trend, steps/s; no kernel launch in
    the steps, 18 + 2 per validation call, both kernels held against their
    plain versions at validation's shapes in the run's dtype."""
    import dataclasses

    from emotivoice_tpu_torch.data.dataset import BucketedLoader, PromptTTSDataset
    from emotivoice_tpu_torch.data.synthetic_corpus import main as make_corpus
    from emotivoice_tpu_torch.frontend.tokens import TokenVocab, load_label_list
    from emotivoice_tpu_torch.ops.cuda.mrf_stage import fused_mrf_stage
    from emotivoice_tpu_torch.ops.cuda.resblock import fused_residual_unit
    from emotivoice_tpu_torch.training.loop import build_models, train

    tmp = tempfile.mkdtemp(prefix="chip_smoke_curves_")
    out, paths = {}, {}
    try:
        corpus = os.path.join(tmp, "corpus")
        make_corpus(["--out", corpus, "--n-train", "48", "--n-valid", "8", "--n-speakers", "4",
                     "--seed", str(SEED)])
        vocab = TokenVocab.from_file(os.path.join(corpus, "tokenlist"))
        speakers = load_label_list(os.path.join(corpus, "speakers"))
        cfg = _train_cfg(len(vocab), len(speakers))
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, batch_size=CURVE_B, iters_per_validation=CURVE_VALID,
            iters_per_checkpoint=CURVE_STEPS))
        zeros = np.zeros(cfg.am.bert_embedding, np.float32)
        train_ds, valid_ds = (
            PromptTTSDataset(os.path.join(corpus, name), cfg, vocab, speakers, lambda t: zeros,
                             cache_dir=os.path.join(tmp, "cache"), device=dev)
            for name in ("datalist.jsonl", "valid.jsonl"))
        for ds in (train_ds, valid_ds):
            for i in range(len(ds)):
                ds[i]
        for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            valid_calls = []

            def valid_loader():
                valid_calls.append(dict(snapshot=(fused_residual_unit.launches,
                                                  fused_mrf_stage.launches), batches=0))
                for b in BucketedLoader(valid_ds, CURVE_B, shuffle=False, drop_last=False,
                                        pad_to_batch=True):
                    valid_calls[-1]["batches"] += 1
                    yield b

            model, disc = build_models(cfg, dev, dtype)
            shapes = set()  # (B, T, C, dtype) handed to the kernels (validation only)

            def on_up(_module, _args, y, _model=model, _shapes=shapes):
                if _model.generator.kernels:
                    _shapes.add((*y.shape, y.dtype))

            hooks = [up.register_forward_hook(on_up) for up in model.generator.ups]
            fused_residual_unit.launches = 0
            fused_mrf_stage.launches = 0
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            try:
                train(cfg, lambda: BucketedLoader(train_ds, CURVE_B, seed=SEED),
                      os.path.join(tmp, dname), total_steps=CURVE_STEPS,
                      steps_per_epoch=len(train_ds) // CURVE_B, valid_batch_iter_fn=valid_loader,
                      log_every=1, device=dev, models=(model, disc), dtype=dtype)
                torch.cuda.synchronize()
            finally:
                for h in hooks:
                    h.remove()
            wall = time.perf_counter() - t0
            rows = _parse_log(os.path.join(tmp, dname, "log", "train_log.txt"))
            steps = [r for r in rows if "g_loss" in r]
            valid = [r for r in rows if "mel_l1" in r]
            if len(steps) != CURVE_STEPS or len(valid) != CURVE_STEPS // CURVE_VALID:
                fail(f"[train] {dname} curve: {len(steps)} steps, {len(valid)} validations")
            for r in steps + valid:
                if not all(np.isfinite(v) for v in r.values()):
                    fail(f"[train] {dname} curve: non-finite loss at step {r['step']}: {r}")
            in_steps = (valid_calls[0]["snapshot"][0], valid_calls[0]["snapshot"][1])
            total = (fused_residual_unit.launches, fused_mrf_stage.launches)
            gen_calls = sum(v["batches"] for v in valid_calls)
            per_valid = (total[0] - in_steps[0], total[1] - in_steps[1])
            per_call = launches_per_call(cfg.vocoder)
            # the first CURVE_VALID steps ran before any validation
            if in_steps != (0, 0) or per_valid != tuple(n * gen_calls for n in per_call):
                fail(f"[train] {dname} curve: launches before validation {in_steps}, "
                     f"in validation {per_valid} over {gen_calls} generator calls")

            def mean_at(step, key="mel_loss", w=5):
                return float(np.mean([r[key] for r in steps if step - w < r["step"] <= step]))

            marks = (10, 50, 100, 150, 200)
            curve = {k: [mean_at(s, k) for s in marks if s <= CURVE_STEPS]
                     for k in ("mel_loss", "g_loss", "d_loss", "dur_loss")}
            sps = float(np.median([r["steps_per_sec"] for r in steps[1:]]))
            peak = torch.cuda.max_memory_allocated(dev)
            out[dname] = dict(wall_s=wall, steps_per_s=sps, curve=curve, marks=marks,
                              valid=[r["mel_l1"] for r in valid], peak_bytes=peak,
                              launches_valid=dict(zip(("fused_residual_unit", "fused_mrf_stage"),
                                                      per_valid)), valid_calls=gen_calls)
            log(f"[train] {dname} curve, 48 utterances, batch {CURVE_B}, {CURVE_STEPS} steps in "
                f"{wall:.1f} s ({sps:.2f} steps/s, log median), peak {peak / 2**30:.2f} GiB; "
                f"mel_loss (mean of 5 steps) at steps {'/'.join(map(str, marks))}: "
                + " -> ".join(f"{v:.3f}" for v in curve["mel_loss"])
                + "; g_loss " + " -> ".join(f"{v:.1f}" for v in curve["g_loss"])
                + "; d_loss " + " -> ".join(f"{v:.2f}" for v in curve["d_loss"])
                + f"; valid mel_l1 {[round(r['mel_l1'], 4) for r in valid]}; validation "
                f"launches {per_valid} over {gen_calls} generator calls")
            if {s[3] for s in shapes} != {dtype}:
                fail(f"[train] {dname} curve: validation handed the kernels {shapes}")
            paths[dname] = check_path_kernels(dev, model, shapes, f"train_curve_{dname}")
            del model, disc
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["train_curves"] = out
    return dict(launches={k: v["launches_valid"] for k, v in out.items()}, paths=paths)


# ---------------------------------------------------------------------------
# 9. data-parallel serving: two engine replicas on the one card
# ---------------------------------------------------------------------------

def phase_dp_serve(dev, cfg, vocab, model) -> dict:
    """A two-replica SynthesisEngine on the one card against the one-replica
    engine, at the bench bucket, in f32 and bf16: equal durations, waveforms
    within TOL_CPU x max, 18 + 2 launches per replica call, both kernels
    held against their plain versions at every shape a replica gave them.
    Both replicas share one card, so this shows the engine is right on the
    device, not how it scales over cards."""
    from emotivoice_tpu_torch.ops.cuda.mrf_stage import fused_mrf_stage
    from emotivoice_tpu_torch.ops.cuda.resblock import fused_residual_unit
    from emotivoice_tpu_torch.serving.engine import SynthesisEngine

    rng = np.random.RandomState(SEED + 7)
    d = cfg.am.bert_embedding
    lengths = rng.randint(BENCH_T_TEXT // 2, BENCH_T_TEXT + 1, BENCH_B)
    toks = rng.randint(2, len(vocab), (BENCH_B, BENCH_T_TEXT))
    args = (toks, lengths, rng.randint(0, cfg.am.n_speaker, BENCH_B),
            rng.randn(BENCH_B, d).astype(np.float32), rng.randn(BENCH_B, d).astype(np.float32))
    audio_s = BENCH_B * BENCH_FRAMES * cfg.audio.hop_length / cfg.audio.sampling_rate
    out, shapes, launches_total = {}, set(), {"fused_residual_unit": 0, "fused_mrf_stage": 0}
    for dname in ("f32", "bf16"):
        one = SynthesisEngine(cfg, model, vocab, device=dev, dtype=dname)
        two = SynthesisEngine(cfg, model, vocab, devices=[dev, dev], dtype=dname)
        wav1, n1 = one.run(*args, BENCH_FRAMES, 1.0)
        half = BENCH_B // len(two.replicas)  # one replica on each replica's rows alone
        parts = [one.run(*(a[i * half:(i + 1) * half] for a in args), BENCH_FRAMES, 1.0)
                 for i in range(len(two.replicas))]
        wav_h, n_h = np.concatenate([w for w, _ in parts]), np.concatenate([n for _, n in parts])
        hooks, recorded = [], []
        for replica in two.replicas:
            s, h = watch_stage_shapes(replica)
            recorded.append(s)
            hooks += h
        fused_residual_unit.launches = 0
        fused_mrf_stage.launches = 0
        try:
            wav2, n2 = two.run(*args, BENCH_FRAMES, 1.0)
            torch.cuda.synchronize()
        finally:
            for h in hooks:
                h.remove()
        launches = {"fused_residual_unit": fused_residual_unit.launches,
                    "fused_mrf_stage": fused_mrf_stage.launches}
        calls = len(two.replicas)
        for k in launches_total:
            launches_total[k] += launches[k]
        per_call = launches_per_call(cfg.vocoder)
        if tuple(launches.values()) != tuple(n * calls for n in per_call):
            fail(f"[dp_serve] {dname}: launches {launches} != {per_call} per replica call x "
                 f"{calls}")
        for s in recorded:
            shapes |= s
        if not (np.array_equal(n1, n2) and np.array_equal(n_h, n2)):
            fail(f"[dp_serve] {dname}: durations differ: {n2} vs {n1} (one call) and {n_h} "
                 "(one replica on each half)")
        scale = float(np.abs(wav1).max())
        err = float(np.abs(wav2 - wav1).max())
        err_h = float(np.abs(wav2 - wav_h).max())
        err_batch = float(np.abs(wav_h - wav1).max())
        tol = TOL_CPU if dname == "f32" else TOL_DP_BF16
        if (not np.all(np.isfinite(wav2)) or scale < 1e-3 or err_h > TOL_CPU * scale
                or err > tol * scale):
            fail(f"[dp_serve] {dname}: two replicas vs one on the same rows: max err "
                 f"{err_h:.3g}, vs one call on all {BENCH_B}: {err:.3g} (max {scale:.3g})")
        times = {}
        for name, eng in (("one", one), ("two", two), ("two_again", two), ("one_again", one)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run(*args, BENCH_FRAMES, 1.0)
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t0) * 1e3
        one_ms = min(times["one"], times["one_again"])
        two_ms = min(times["two"], times["two_again"])
        out[dname] = dict(err=err, err_same_rows=err_h, err_one_by_batch=err_batch, scale=scale,
                          launches=launches, one_ms=one_ms, two_ms=two_ms, runs_ms=times,
                          xrt_one=audio_s * 1e3 / one_ms, xrt_two=audio_s * 1e3 / two_ms)
        log(f"[dp_serve] {dname}, bench bucket B={BENCH_B} ({half} rows per replica), {calls} "
            f"replicas on {dev}: durations equal; max |2 replicas - 1 replica on the same "
            f"{half}-row halves| {err_h:.2e} (tol {TOL_CPU} x max), - 1 replica on all "
            f"{BENCH_B} rows {err:.2e} (tol {tol} x max; the one replica alone, {half} rows vs "
            f"{BENCH_B}: {err_batch:.2e}), max |wav| {scale:.3f}; launches {launches} over "
            f"{calls} replica calls; "
            f"{one_ms:.1f} ms one replica (xRT {audio_s * 1e3 / one_ms:.1f}), {two_ms:.1f} ms "
            f"two on one card (xRT {audio_s * 1e3 / two_ms:.1f}; one card, so no scaling figure)")
    path = check_path_kernels(dev, model, shapes, "dp_serve")
    report["dp_serve"] = out
    return dict(launches=launches_total, path=path)


# ---------------------------------------------------------------------------
# 9b. tensor-parallel serving: one replica split over [card, card]
# ---------------------------------------------------------------------------

def shard_bytes(module) -> dict:
    """Parameter bytes of a (possibly tensor-parallel) module: the parts of
    the split parameters per shard index, the whole ones (on the group's
    first device), and all of them."""
    from emotivoice_tpu_torch.parallel.tensor_parallel import full_parameters

    per_shard, whole = {}, 0
    for _, parts, dim in full_parameters(module):
        if dim is None:
            whole += parts[0].numel() * parts[0].element_size()
            continue
        for i, p in enumerate(parts):
            per_shard[i] = per_shard.get(i, 0) + p.numel() * p.element_size()
    return dict(per_shard=[per_shard[i] for i in sorted(per_shard)], whole=whole,
                total=whole + sum(per_shard.values()))


def tp_group(dev) -> list:
    """The model group of the TP phases: two cards where the machine has
    them, else two shards on `dev`. On one card the collectives cost
    nothing, so the phases show correctness and the launch cost of the
    split, not its scaling."""
    if dev.type == "cuda" and torch.cuda.device_count() >= 2:
        return [torch.device("cuda", 0), torch.device("cuda", 1)]
    return [dev, dev]


def _group_str(group) -> str:
    return "[" + ", ".join(str(d) for d in group) + "]"


def _group_note(group) -> str:
    if group[0] == group[1]:
        return "two shards on one card, so no scaling figure"
    return f"on two cards {_group_str(group)}"


def phase_tp_serve(dev, cfg, vocab, model) -> dict:
    """A SynthesisEngine whose one replica is split over the model group
    `tp_group(dev)` (model_parallel=2) against the one-device engine on the same
    seeded weights, at the bench bucket, f32 (TF32 off) then bf16: equal
    durations (in bf16 on some rows, a row's frames within TP_BF16_FRAMES),
    waveforms within TOL_CPU (f32) / TOL_DP_BF16 (bf16) x max on the rows
    whose durations agree and through the TP vocoder on the one-device mel,
    18 + 2 launches per generator call (the MRF kernels run on whole
    weights gathered to the group's first device), ms per call (median of
    3, the two engines in turns), parameter bytes per shard, both kernels
    held against their plain versions at the path's shapes."""
    import copy

    from emotivoice_tpu_torch.ops.cuda.mrf_stage import fused_mrf_stage
    from emotivoice_tpu_torch.ops.cuda.resblock import fused_residual_unit
    from emotivoice_tpu_torch.serving.engine import SynthesisEngine

    rng = np.random.RandomState(SEED + 8)
    d = cfg.am.bert_embedding
    lengths = rng.randint(BENCH_T_TEXT // 2, BENCH_T_TEXT + 1, BENCH_B)
    toks = rng.randint(2, len(vocab), (BENCH_B, BENCH_T_TEXT))
    args = (toks, lengths, rng.randint(0, cfg.am.n_speaker, BENCH_B),
            rng.randn(BENCH_B, d).astype(np.float32), rng.randn(BENCH_B, d).astype(np.float32))
    audio_s = BENCH_B * BENCH_FRAMES * cfg.audio.hop_length / cfg.audio.sampling_rate
    out, shapes = {}, set()
    launches_total = {"fused_residual_unit": 0, "fused_mrf_stage": 0}
    bytes_one = shard_bytes(model)["total"]
    group = tp_group(dev)
    for dname in ("f32", "bf16"):
        one = SynthesisEngine(cfg, model, vocab, device=dev, dtype=dname)
        tp = SynthesisEngine(cfg, copy.deepcopy(model), vocab, devices=group,
                             model_parallel=2, dtype=dname)
        if type(tp.model.generator.conv_post).__name__ != "RowParallel":
            fail(f"[tp_serve] the engine did not split the model: {tp.model.generator.conv_post}")
        _, n1 = one.run(*args, BENCH_FRAMES, 1.0)
        recorded, hooks = watch_stage_shapes(tp.model)
        fused_residual_unit.launches = 0
        fused_mrf_stage.launches = 0
        try:
            _, n2 = tp.run(*args, BENCH_FRAMES, 1.0)
            torch.cuda.synchronize()
        finally:
            for h in hooks:
                h.remove()
        launches = {"fused_residual_unit": fused_residual_unit.launches,
                    "fused_mrf_stage": fused_mrf_stage.launches}
        for k in launches_total:
            launches_total[k] += launches[k]
        shapes |= recorded
        per_call = launches_per_call(cfg.vocoder)
        if tuple(launches.values()) != per_call:
            fail(f"[tp_serve] {dname}: launches {launches} != {per_call} per generator call")
        # The same inputs through both models, for durations per token and the
        # vocoder alone on the one-device mel. bf16 rounds each shard's partial
        # sum before the reduction (as XLA's bf16 all-reduce under a model axis
        # does), one rounding more than one device, so a predicted duration near
        # a rounding edge may move by a frame and shift the rest of its row: in
        # bf16 the whole path is held on the rows whose durations all agree, the
        # vocoder on every row, and a row's frames may differ by TP_BF16_FRAMES
        # (+1).
        dtype = torch.float32 if dname == "f32" else torch.bfloat16
        inputs = [torch.as_tensor(a, device=dev) for a in args]
        with torch.inference_mode():
            o1 = one.model(*inputs, max_frames=BENCH_FRAMES, dtype=dtype)
            o2 = tp.model(*inputs, max_frames=BENCH_FRAMES, dtype=dtype)
            voc = tp.model.generator(o1["dec_outputs"], dtype=dtype)
        torch.cuda.synchronize()
        same = (o1["durations"] == o2["durations"]).all(dim=1).cpu().numpy()
        off = np.abs(n2.astype(np.int64) - n1)
        w1, w2 = o1["wav_predictions"].cpu().numpy(), o2["wav_predictions"].cpu().numpy()
        if dname == "f32" and not (same.all() and np.array_equal(n1, n2)):
            fail(f"[tp_serve] {dname}: durations differ: {n2} vs {n1}")
        if not same.any() or np.any(off > 1 + TP_BF16_FRAMES * n1):
            fail(f"[tp_serve] {dname}: durations differ beyond rounding: {n2} vs {n1}, "
                 f"{int(same.sum())} rows with equal durations")
        scale = float(np.abs(w1).max())
        err = float(np.abs(w2[same] - w1[same]).max())
        err_voc = float(np.abs(voc.float().cpu().numpy() - w1).max())
        tol = TOL_CPU if dname == "f32" else TOL_DP_BF16
        if (not np.all(np.isfinite(w2)) or scale < 1e-3 or err > tol * scale
                or err_voc > tol * scale):
            fail(f"[tp_serve] {dname}: TP(2) vs one device: max err {err:.3g} (rows with equal "
                 f"durations), {err_voc:.3g} (the vocoder on one mel) > {tol} x max {scale:.3g}")
        runs = {"one": [], "tp": []}
        for _ in range(3):
            for name, eng in (("one", one), ("tp", tp)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.run(*args, BENCH_FRAMES, 1.0)
                torch.cuda.synchronize()
                runs[name].append((time.perf_counter() - t0) * 1e3)
        one_ms, tp_ms = float(np.median(runs["one"])), float(np.median(runs["tp"]))
        sb = shard_bytes(tp.model)
        out[dname] = dict(err=err, scale=scale, launches=launches, one_ms=one_ms, tp_ms=tp_ms,
                          err_vocoder=err_voc, rows_same_durations=int(same.sum()),
                          frames_off=off.tolist(),
                          runs_ms=runs, xrt_one=audio_s * 1e3 / one_ms,
                          xrt_tp=audio_s * 1e3 / tp_ms, bytes_per_shard=sb["per_shard"],
                          bytes_whole=sb["whole"], bytes_tp_total=sb["total"],
                          bytes_one=bytes_one)
        mib = 2 ** 20
        log(f"[tp_serve] {dname}, bench bucket B={BENCH_B} x {BENCH_T_TEXT} tokens x "
            f"{BENCH_FRAMES} frames, one replica over the model group {_group_str(group)}: "
            f"durations "
            f"equal on {int(same.sum())} of {BENCH_B} rows (frames off by "
            f"{sorted(int(o) for o in off[~same])} on the others); max |TP(2) - one device| "
            f"{err:.2e} on those rows, the TP vocoder on the one-device mel {err_voc:.2e} "
            f"(tol {tol} x max), max |wav| "
            f"{scale:.3f}; launches {launches} in one generator call; {tp_ms:.1f} ms TP(2) vs "
            f"{one_ms:.1f} ms one device (median of 3, in turns; xRT {audio_s * 1e3 / tp_ms:.1f}"
            f" vs {audio_s * 1e3 / one_ms:.1f}); parameter MiB per shard "
            + " / ".join(f"{b / mib:.2f}" for b in sb["per_shard"])
            + f" + {sb['whole'] / mib:.2f} whole on the first device = "
            f"{sb['total'] / mib:.2f} (one device {bytes_one / mib:.2f}); {_group_note(group)}")
        tp_model = tp.model
        del one, tp
    # the kernels against their plain versions on the split model's gathered weights
    path = check_path_kernels(dev, tp_model, shapes, "tp_serve")
    report["tp_serve"] = out
    return dict(launches=launches_total, path=path)


# ---------------------------------------------------------------------------
# 10. data-parallel training: two ranks on the one card over gloo
# ---------------------------------------------------------------------------

def _dp_setup(corpus: str, cache: str, dev):
    """The full-width training config of the corpus, its training dataset
    (features on `dev`, cached) and the fixed global batch: the first batch
    of the seeded loader, on `dev`. The same in the parent and in each rank."""
    from emotivoice_tpu_torch.data.dataset import BucketedLoader, PromptTTSDataset
    from emotivoice_tpu_torch.frontend.tokens import TokenVocab, load_label_list
    from emotivoice_tpu_torch.training.loop import to_device

    vocab = TokenVocab.from_file(os.path.join(corpus, "tokenlist"))
    speakers = load_label_list(os.path.join(corpus, "speakers"))
    cfg = _train_cfg(len(vocab), len(speakers))
    zeros = np.zeros(cfg.am.bert_embedding, np.float32)
    ds = PromptTTSDataset(os.path.join(corpus, "datalist.jsonl"), cfg, vocab, speakers,
                          lambda text: zeros, cache_dir=cache, device=dev)
    batch = next(iter(BucketedLoader(ds, DP_GLOBAL_B, seed=SEED)))
    return cfg, ds, to_device(batch, dev)


def dp_one_step(cfg, batch, dev, dp) -> dict:
    """One TrainStep from build_models' seeded parameters, dropout off, on
    this rank's rows of `batch`: every loss, the gradient norms of
    TRAIN_GRAD_PARAMS (the ranks' mean gradients) and the spectral-norm u, v."""
    from emotivoice_tpu_torch.training.loop import build_models
    from emotivoice_tpu_torch.training.step import TrainStep

    model, disc = build_models(cfg, dev)
    model.eval()
    disc.eval()
    trainer = TrainStep(cfg, model, disc, dp=dp)
    metrics = trainer(dp.shard_batch(batch))
    named = {**dict(model.named_parameters()), **dict(disc.named_parameters())}
    uv = torch.cat([b.flatten() for k, b in disc.named_buffers()
                    if k.endswith(("weight_u", "weight_v"))])
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                grads={k: float(named[k].grad.norm()) for k in TRAIN_GRAD_PARAMS},
                uv=uv.cpu().numpy().tolist())


def _dp_env(rank: int, port: int) -> dict:
    env = dict(os.environ)
    path = [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(DP_RANKS),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), PYTHONPATH=os.pathsep.join(path))
    return env


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_cmd() -> list:
    """How a rank starts: this script in worker mode."""
    return [sys.executable, os.path.abspath(__file__)]


def _spawn_ranks(worker_args, tmp: str, tag: str, timeout: float = 600.0):
    """DP_RANKS processes of this script in worker mode, with the torchrun
    environment; waits for all, kills any left on the way out; fails on a
    non-zero exit. Returns each rank's output."""
    port = _free_port()
    procs = []
    try:
        for r in range(DP_RANKS):
            log_path = os.path.join(tmp, f"{tag}_rank{r}.log")
            procs.append((subprocess.Popen(
                _worker_cmd() + ["--dp-worker", *worker_args(r)],
                env=_dp_env(r, port), cwd=ROOT, stdout=open(log_path, "w"),
                stderr=subprocess.STDOUT), log_path))
        deadline = time.time() + timeout
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.time(), 1))
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    texts = [open(path).read() for _, path in procs]
    for r, ((p, _), text) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            fail(f"[dp_train] {tag} rank {r} exited {p.returncode}: {text[-3000:]}")
    return texts


def dp_worker(argv) -> None:
    """One rank of `[dp_train]` (this script run with --dp-worker): `step`
    runs dp_one_step on the fixed batch; `cli` runs the training CLI's own
    main() and records its kernel launches, the time of its gradient
    all-reduces and its peak memory. Writes JSON to --dp-out."""
    import emotivoice_tpu_torch.parallel.data_parallel as dpm
    from emotivoice_tpu_torch.ops.cuda.mrf_stage import fused_mrf_stage
    from emotivoice_tpu_torch.ops.cuda.resblock import fused_residual_unit
    from emotivoice_tpu_torch.parallel.multihost import initialize_multihost

    p = argparse.ArgumentParser(allow_abbrev=False)
    p.add_argument("--dp-worker", choices=["step", "cli"], required=True)
    p.add_argument("--dp-out", required=True)
    p.add_argument("--dp-dir", default=None)
    p.add_argument("--dp-device", default="cuda:0")
    args, rest = p.parse_known_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.dp_device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
    out = {}
    if args.dp_worker == "step":
        rank, world = initialize_multihost(dev, "gloo")
        try:
            cfg, _, batch = _dp_setup(os.path.join(args.dp_dir, "corpus"),
                                      os.path.join(args.dp_dir, "cache"), dev)
            out = dp_one_step(cfg, batch, dev, dpm.DataParallel(rank, world, dev))
        finally:
            torch.distributed.destroy_process_group()
    else:
        from emotivoice_tpu_torch import train as train_cli

        reduce_ms = []
        mean_grads = dpm.DataParallel.mean_grads

        def sync():
            if on_card:
                torch.cuda.synchronize(dev)

        def timed_mean_grads(self, params):
            sync()
            t0 = time.perf_counter()
            mean_grads(self, params)
            sync()
            reduce_ms.append((time.perf_counter() - t0) * 1e3)

        dpm.DataParallel.mean_grads = timed_mean_grads
        fused_residual_unit.launches = 0
        fused_mrf_stage.launches = 0
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        train_cli.main(rest)
        sync()
        out = dict(wall_s=time.perf_counter() - t0, reduce_ms=reduce_ms,
                   peak_bytes=torch.cuda.max_memory_allocated(dev) if on_card else 0,
                   launches={"fused_residual_unit": fused_residual_unit.launches,
                             "fused_mrf_stage": fused_mrf_stage.launches})
    with open(args.dp_out, "w") as f:
        json.dump(out, f)


def phase_dp_train(dev) -> dict:
    """Two ranks (processes with the torchrun environment, gloo, both on
    cuda:0) against one process: one step on one global batch of 16 rows,
    then DP_CLI_STEPS steps of the training CLI with --multihost."""
    from emotivoice_tpu_torch.data.synthetic_corpus import main as make_corpus
    from emotivoice_tpu_torch.parallel.data_parallel import DataParallel

    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)  # the ranks name their card

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        corpus, cache = os.path.join(tmp, "corpus"), os.path.join(tmp, "cache")
        make_corpus(["--out", corpus, "--n-train", "64", "--n-valid", "8", "--n-speakers", "4",
                     "--seed", str(SEED)])
        cfg, ds, batch = _dp_setup(corpus, cache, dev)
        for i in range(len(ds)):  # every feature on the card into the cache, for the ranks
            ds[i]
        t0 = time.perf_counter()
        one = dp_one_step(cfg, batch, dev, DataParallel(device=dev))
        one_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        _spawn_ranks(lambda r: ["step", "--dp-dir", tmp, "--dp-device", str(dev), "--dp-out",
                                os.path.join(tmp, f"step{r}.json")], tmp, "step")
        ranks_s = time.perf_counter() - t0
        ranks = [json.load(open(os.path.join(tmp, f"step{r}.json"))) for r in range(DP_RANKS)]
        loss_err = {k: max(abs(r["metrics"][k] - v) for r in ranks) / max(abs(v), 1e-12)
                    for k, v in one["metrics"].items()}
        grad_err = {k: max(abs(r["grads"][k] - v) for r in ranks) / max(abs(v), 1e-12)
                    for k, v in one["grads"].items()}
        worst_loss = max(loss_err.items(), key=lambda kv: kv[1])
        worst_grad = max(grad_err.items(), key=lambda kv: kv[1])
        uv_equal = all(r["uv"] == ranks[0]["uv"] for r in ranks)
        uv_err = float(np.abs(np.array(ranks[0]["uv"]) - np.array(one["uv"])).max())
        log(f"[dp_train] one step, global batch {DP_GLOBAL_B} x {int(batch['tokens'].shape[1])} "
            f"tokens x {int(batch['mel'].shape[1])} frames, dropout off: {DP_RANKS} ranks (gloo, "
            f"{DP_GLOBAL_B // DP_RANKS} rows each, both on {dev}) vs one process: worst loss "
            f"rel err {worst_loss[1]:.2e} ({worst_loss[0]}; tol {TOL_TRAIN_LOSS}), worst "
            f"grad-norm rel err {worst_grad[1]:.2e} ({worst_grad[0]}; tol {TOL_TRAIN_GRAD}) over "
            f"{len(TRAIN_GRAD_PARAMS)} parameters; spectral u, v equal on the ranks: {uv_equal}, "
            f"vs one process max {uv_err:.2e}; {one_s:.1f} s one process, {ranks_s:.1f} s the "
            f"ranks (start-up included)")
        if not (worst_loss[1] <= TOL_TRAIN_LOSS and worst_grad[1] <= TOL_TRAIN_GRAD and uv_equal):
            fail(f"[dp_train] ranks and one process disagree: {loss_err} {grad_err}")

        out = os.path.join(tmp, "out")
        cli_args = ["--datalist", os.path.join(corpus, "datalist.jsonl"),
                    "--tokenlist", os.path.join(corpus, "tokenlist"),
                    "--speakers", os.path.join(corpus, "speakers"), "--output-dir", out,
                    "--cache-dir", cache, "--multihost", "--backend", "gloo",
                    "--device", str(dev), "--batch-size", str(DP_GLOBAL_B),
                    "--total-steps", str(DP_CLI_STEPS), "--log-every", "1",
                    "--iters-per-checkpoint", str(DP_CLI_STEPS)]
        t0 = time.perf_counter()
        texts = _spawn_ranks(lambda r: ["cli", "--dp-device", str(dev), "--dp-out",
                                        os.path.join(tmp, f"cli{r}.json")] + cli_args, tmp, "cli")
        cli_s = time.perf_counter() - t0
        cli = [json.load(open(os.path.join(tmp, f"cli{r}.json"))) for r in range(DP_RANKS)]
        rows = [r for r in _parse_log(os.path.join(out, "log", "train_log.txt")) if "g_loss" in r]
        ckpts = sorted(os.listdir(os.path.join(out, "ckpt")))
        for r, text in enumerate(texts):
            if f"multihost: rank {r} of {DP_RANKS} on {dev}" not in text:
                fail(f"[dp_train] rank {r} did not report its place: {text[-2000:]}")
        if [int(r["step"]) for r in rows] != list(range(1, DP_CLI_STEPS + 1)):
            fail(f"[dp_train] rank 0's log holds steps {[r['step'] for r in rows]}")
        if ckpts != [f"do_{DP_CLI_STEPS:08d}", f"g_{DP_CLI_STEPS:08d}"]:
            fail(f"[dp_train] checkpoints {ckpts}")
        for r in rows:
            if not all(np.isfinite(v) for v in r.values()):
                fail(f"[dp_train] non-finite loss at step {r['step']}: {r}")
        launches = {k: sum(c["launches"][k] for c in cli) for k in cli[0]["launches"]}
        if any(launches.values()):
            fail(f"[dp_train] the train steps launched kernels: {launches}")
        # two all-reduces (D, then G) per step; the first step's include start-up
        per_step = [sum(c["reduce_ms"][2 * i:2 * i + 2]) for c in cli
                    for i in range(1, DP_CLI_STEPS)]
        reduce_ms = float(np.median(per_step))
        sps = float(np.median([r["steps_per_sec"] for r in rows[1:]]))
        peaks = [c["peak_bytes"] for c in cli]
        log(f"[dp_train] `python -m emotivoice_tpu_torch.train --multihost --backend gloo "
            f"--device {dev}` on {DP_RANKS} ranks, global batch {DP_GLOBAL_B}: {DP_CLI_STEPS} "
            f"steps in {cli_s:.1f} s (start-up included), rank 0's log {sps:.2f} steps/s "
            f"(median of steps 2-{DP_CLI_STEPS}); gradient all-reduce {reduce_ms:.1f} ms per step "
            f"(D + G, one flat buffer each; gloo stages the card's tensors through the host); "
            f"peak memory per rank " + ", ".join(f"{b / 2**30:.2f} GiB" for b in peaks)
            + f"; mel_loss {rows[0]['mel_loss']:.4f} -> {rows[-1]['mel_loss']:.4f}; kernel "
            f"launches in the steps {launches}; checkpoints {ckpts}; two ranks on one card: no "
            f"multi-GPU figure")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["dp_train"] = dict(
        step=dict(one=one, ranks=ranks, loss_rel_err=loss_err, grad_rel_err=grad_err,
                  uv_equal=uv_equal, uv_err=uv_err, one_s=one_s, ranks_s=ranks_s),
        cli=dict(steps=DP_CLI_STEPS, wall_s=cli_s, log=rows, ranks=cli, reduce_ms=reduce_ms,
                 steps_per_s=sps, peak_bytes=peaks, launches=launches))
    return dict(launches_steps=launches)


# ---------------------------------------------------------------------------
# 10b. tensor-parallel training: one process, the models split over [card, card]
# ---------------------------------------------------------------------------

TP_STEPS = 5


def whole_grad_norms(model, disc, names) -> dict:
    """The gradient norm of each named parameter, a split parameter's parts
    gathered (the one-device and the tensor-parallel layouts alike)."""
    from emotivoice_tpu_torch.parallel.tensor_parallel import full_parameters

    found = {}
    for module in (model, disc):
        for name, parts, dim in full_parameters(module):
            if name in names:
                g = parts[0].grad if dim is None else torch.cat([p.grad.to(parts[0].device)
                                                                 for p in parts], dim)
                found[name] = float(g.norm())
    return {k: found[k] for k in names}


def phase_tp_train(dev) -> dict:
    """`[train]`'s config and corpus at batch 16, f32 (TF32 off): a
    TrainStep over models split on the model group `tp_group(dev)` against a
    one-device TrainStep from the same seeded state, dropout off: one step
    (every loss and the 11 gradient norms to [train]'s tolerances), then
    TP_STEPS more steps of each (median wall ms, peak memory, 0 kernel
    launches), then the TP trainer's checkpoint restored into a fresh
    one-device trainer: parameters and Adam moments bit-equal."""
    from emotivoice_tpu_torch.data.synthetic_corpus import main as make_corpus
    from emotivoice_tpu_torch.ops.cuda.mrf_stage import fused_mrf_stage
    from emotivoice_tpu_torch.ops.cuda.resblock import fused_residual_unit
    from emotivoice_tpu_torch.parallel.tensor_parallel import tensor_parallel
    from emotivoice_tpu_torch.training.loop import CheckpointManager, build_models
    from emotivoice_tpu_torch.training.step import TrainStep

    def trainer(cfg, group):
        model, disc = build_models(cfg, dev)
        model.eval()
        disc.eval()
        return TrainStep(cfg, tensor_parallel(model, group), tensor_parallel(disc, group))

    group = tp_group(dev)
    cards = sorted(set(group), key=str)

    def steps(tr, batch, n):
        """n steps: the last metrics, wall ms per step, and the peak memory
        above what was allocated before them (both trainers' state), summed
        over the group's cards."""
        resident = 0
        for d in cards:
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
            resident += torch.cuda.memory_allocated(d)
        ms = []
        for _ in range(n):
            t0 = time.perf_counter()
            metrics = tr(batch)
            for d in cards:
                torch.cuda.synchronize(d)
            ms.append((time.perf_counter() - t0) * 1e3)
        return metrics, ms, sum(torch.cuda.max_memory_allocated(d) for d in cards) - resident

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        corpus, cache = os.path.join(tmp, "corpus"), os.path.join(tmp, "cache")
        make_corpus(["--out", corpus, "--n-train", "64", "--n-valid", "8", "--n-speakers", "4",
                     "--seed", str(SEED)])
        cfg, _, batch = _dp_setup(corpus, cache, dev)
        one, tp = trainer(cfg, [dev]), trainer(cfg, group)
        if type(tp.model.generator.conv_post).__name__ != "RowParallel":
            fail("[tp_train] the trainer's generator is not split")
        fused_residual_unit.launches = 0
        fused_mrf_stage.launches = 0
        got = {}
        for name, tr in (("one", one), ("tp", tp)):
            metrics, ms, _ = steps(tr, batch, 1)
            got[name] = dict(metrics={k: float(v) for k, v in metrics.items()},
                             grads=whole_grad_norms(tr.model, tr.disc, TRAIN_GRAD_PARAMS),
                             first_ms=ms[0])
        loss_err = {k: abs(got["tp"]["metrics"][k] - v) / max(abs(v), 1e-12)
                    for k, v in got["one"]["metrics"].items()}
        grad_err = {k: abs(got["tp"]["grads"][k] - v) / max(abs(v), 1e-12)
                    for k, v in got["one"]["grads"].items()}
        worst_loss = max(loss_err.items(), key=lambda kv: kv[1])
        worst_grad = max(grad_err.items(), key=lambda kv: kv[1])
        timing = {}
        for name, tr in (("one", one), ("tp", tp)):
            _, ms, peak = steps(tr, batch, TP_STEPS)
            timing[name] = dict(ms=ms, median_ms=float(np.median(ms)), peak_bytes=peak)
        launches = {"fused_residual_unit": fused_residual_unit.launches,
                    "fused_mrf_stage": fused_mrf_stage.launches}
        ckpt = CheckpointManager(os.path.join(tmp, "ckpt"))
        ckpt.save(tp)
        back = trainer(cfg, [dev])
        restored = ckpt.restore(back)
        same = all(torch.equal(a, b) for m, n in ((tp.model, back.model), (tp.disc, back.disc))
                   for a, b in zip(m.state_dict().values(), n.state_dict().values()))
        adam = [tp.state_dict()[k]["state"] for k in ("optim_g", "optim_d")]
        adam_back = [back.state_dict()[k]["state"] for k in ("optim_g", "optim_d")]
        same_adam = all(torch.equal(a[i][k], b[i][k]) for a, b in zip(adam, adam_back)
                        for i in a for k in a[i])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gib = 2 ** 30
    log(f"[tp_train] one step, batch {DP_GLOBAL_B} x {int(batch['tokens'].shape[1])} tokens x "
        f"{int(batch['mel'].shape[1])} frames, f32, dropout off: models split over "
        f"{_group_str(group)}"
        f" vs one device from the same seeded state: worst loss rel err {worst_loss[1]:.2e} "
        f"({worst_loss[0]}; tol {TOL_TRAIN_LOSS}), worst grad-norm rel err {worst_grad[1]:.2e} "
        f"({worst_grad[0]}; tol {TOL_TRAIN_GRAD}) over {len(TRAIN_GRAD_PARAMS)} parameters; "
        f"{TP_STEPS} more steps each: {timing['tp']['median_ms']:.1f} ms TP(2) vs "
        f"{timing['one']['median_ms']:.1f} ms one device (median wall ms), peak memory above "
        f"both trainers' resident state {timing['tp']['peak_bytes'] / gib:.2f} vs "
        f"{timing['one']['peak_bytes'] / gib:.2f} GiB; "
        f"kernel launches in the steps {launches}; the TP checkpoint of step {restored} in a "
        f"one-device trainer: parameters bit-equal {same}, Adam moments bit-equal {same_adam}; "
        f"{_group_note(group)}")
    if not (worst_loss[1] <= TOL_TRAIN_LOSS and worst_grad[1] <= TOL_TRAIN_GRAD):
        fail(f"[tp_train] TP and one device disagree: {loss_err} {grad_err}")
    if any(launches.values()):
        fail(f"[tp_train] the train steps launched kernels: {launches}")
    if not (same and same_adam and restored == 1 + TP_STEPS):
        fail(f"[tp_train] the TP checkpoint did not load bit-equal into one device: "
             f"step {restored}, parameters {same}, Adam {same_adam}")
    report["tp_train"] = dict(step=dict(got, loss_rel_err=loss_err, grad_rel_err=grad_err),
                              timing=timing, launches=launches, checkpoint_step=restored)
    return dict(launches_steps=launches)


# ---------------------------------------------------------------------------
# 10c. tensor parallelism over ranks: two processes, one shard each
# ---------------------------------------------------------------------------

TP_RANKS = 2


def _tp_rank_places() -> list:
    """(device, backend) of each rank of `[tp_ranks]`: one card each over
    NCCL where the machine has two, else both on cuda:0 over gloo (NCCL
    refuses two ranks on one card)."""
    if torch.cuda.device_count() >= TP_RANKS:
        return [(f"cuda:{r}", "nccl") for r in range(TP_RANKS)]
    return [("cuda:0", "gloo")] * TP_RANKS


def _bench_args(cfg, vocab, seed: int):
    """A seeded bench bucket's engine inputs (numpy)."""
    rng = np.random.RandomState(seed)
    d = cfg.am.bert_embedding
    lengths = rng.randint(BENCH_T_TEXT // 2, BENCH_T_TEXT + 1, BENCH_B)
    toks = rng.randint(2, len(vocab), (BENCH_B, BENCH_T_TEXT))
    return (toks, lengths, rng.randint(0, cfg.am.n_speaker, BENCH_B),
            rng.randn(BENCH_B, d).astype(np.float32), rng.randn(BENCH_B, d).astype(np.float32))


def _rank_collectives(group, n: int = 1) -> dict:
    """A RankGroup's collectives since its counters were cleared, per one of
    `n` calls: {kind: [calls, bytes]}."""
    return {k: [group.calls[k] / n, group.bytes[k] / n] for k in sorted(group.calls)}


def _collectives_str(c: dict) -> str:
    return ", ".join(f"{k} {v[0]:.0f} x ({v[1] / 2**20:.1f} MiB)" for k, v in c.items())


def rank_grad_norms(model, disc, names, group) -> dict:
    """The gradient norm of each named parameter over the model group: a
    split parameter's square sums added over the ranks."""
    from emotivoice_tpu_torch.parallel.tensor_parallel import full_parameters

    found = {}
    for module in (model, disc):
        for name, parts, dim in full_parameters(module):
            if name in names:
                sq = parts[0].grad.double().pow(2).sum().reshape(1)
                if dim is not None:
                    sq = group.all_reduce(sq)
                found[name] = float(sq.sqrt())
    return {k: found[k] for k in names}


def tp_rank_serve(dev, group, tmp: str) -> dict:
    """One rank's share of `[tp_ranks]`' serving: the bench bucket through a
    SynthesisEngine split over the rank group, f32 then bf16."""
    import copy

    from emotivoice_tpu_torch.ops.cuda.mrf_stage import fused_mrf_stage
    from emotivoice_tpu_torch.ops.cuda.resblock import fused_residual_unit
    from emotivoice_tpu_torch.serving.engine import SynthesisEngine

    cfg, vocab, base = _build_model()
    args = _bench_args(cfg, vocab, SEED + 9)
    inputs = [torch.as_tensor(a, device=dev) for a in args]
    out, shapes, paths = {}, {}, []
    for dname in ("f32", "bf16"):
        dtype = torch.float32 if dname == "f32" else torch.bfloat16
        torch.cuda.reset_peak_memory_stats(dev)
        eng = SynthesisEngine(cfg, copy.deepcopy(base), vocab, model_group=group, dtype=dname)
        if type(eng.model.generator.conv_post).__name__ != "RowParallel":
            fail(f"[tp_ranks] the engine did not split the model: {eng.model.generator.conv_post}")
        recorded, hooks = watch_stage_shapes(eng.model)
        torch.cuda.synchronize(dev)
        fused_residual_unit.launches = 0
        fused_mrf_stage.launches = 0
        group.calls.clear()
        group.bytes.clear()
        try:
            _, n2 = eng.run(*args, BENCH_FRAMES, 1.0)
            torch.cuda.synchronize(dev)
        finally:
            for h in hooks:
                h.remove()
        launches = {"fused_residual_unit": fused_residual_unit.launches,
                    "fused_mrf_stage": fused_mrf_stage.launches}
        collectives = _rank_collectives(group)
        mel1 = torch.load(os.path.join(tmp, f"mel_{dname}.pt")).to(dev)
        with torch.inference_mode():
            o2 = eng.model(*inputs, max_frames=BENCH_FRAMES, dtype=dtype)
            voc = eng.model.generator(mel1, dtype=dtype)
        ms = []
        for _ in range(3):
            torch.distributed.barrier()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            eng.run(*args, BENCH_FRAMES, 1.0)
            torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        np.savez(os.path.join(tmp, f"serve_{dname}_rank{group.index}.npz"), n2=n2,
                 durations=o2["durations"].cpu().numpy(),
                 wav=o2["wav_predictions"].float().cpu().numpy(),
                 voc=voc.float().cpu().numpy())
        sb = shard_bytes(eng.model)
        out[dname] = dict(launches=launches, collectives=collectives, ms=ms,
                          median_ms=float(np.median(ms)), bytes_shard=sb["per_shard"],
                          bytes_whole=sb["whole"], peak_bytes=torch.cuda.max_memory_allocated(dev))
        shapes[dname] = recorded
        # both kernels against their plain versions at this path's shapes, on
        # the weights the rank gathered (every rank checks the same shapes)
        paths.append(check_path_kernels(dev, eng.model, recorded, f"tp_ranks_{dname}"))
        del eng, o2, voc
        torch.cuda.empty_cache()
    return dict(serve=out, path=_merge_paths(*paths))


def tp_rank_train(dev, group, mesh, tmp: str) -> dict:
    """One rank's share of `[tp_ranks]`' training: a TrainStep over models
    split on the rank group, dropout off, on [tp_train]'s batch: one step
    (losses, gradient norms), TP_STEPS more, a validation pass through the
    kernels, and the checkpoint both ways."""
    from emotivoice_tpu_torch.ops.cuda.mrf_stage import fused_mrf_stage
    from emotivoice_tpu_torch.ops.cuda.resblock import fused_residual_unit
    from emotivoice_tpu_torch.parallel.data_parallel import DataParallel
    from emotivoice_tpu_torch.parallel.sharding import shard_tensor
    from emotivoice_tpu_torch.parallel.tensor_parallel import full_parameters, tensor_parallel
    from emotivoice_tpu_torch.training.loop import CheckpointManager, build_models
    from emotivoice_tpu_torch.training.step import TrainStep
    from emotivoice_tpu_torch.training.validate import make_validate_fn

    cfg, _, batch = _dp_setup(os.path.join(tmp, "corpus"), os.path.join(tmp, "cache"), dev)
    dp = DataParallel.from_mesh(mesh, dev)

    def trainer(split: bool):
        model, disc = build_models(cfg, dev)
        model.eval()
        disc.eval()
        if split:
            model, disc = tensor_parallel(model, group), tensor_parallel(disc, group)
        return TrainStep(cfg, model, disc, dp=dp if split else None)

    tr = trainer(True)
    fused_residual_unit.launches = 0
    fused_mrf_stage.launches = 0
    metrics = tr(batch)
    first = dict(metrics={k: float(v) for k, v in metrics.items()},
                 grads=rank_grad_norms(tr.model, tr.disc, TRAIN_GRAD_PARAMS, group))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    group.calls.clear()
    group.bytes.clear()
    ms = []
    for _ in range(TP_STEPS):
        torch.distributed.barrier()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        tr(batch)
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    step_collectives = _rank_collectives(group, TP_STEPS)
    peak = torch.cuda.max_memory_allocated(dev) - resident
    launches_steps = {"fused_residual_unit": fused_residual_unit.launches,
                      "fused_mrf_stage": fused_mrf_stage.launches}

    # validation through the kernels, on the train batch's 16 whole mels
    recorded, hooks = watch_stage_shapes(tr.model)
    fused_residual_unit.launches = 0
    fused_mrf_stage.launches = 0
    group.calls.clear()
    group.bytes.clear()
    try:
        t0 = time.perf_counter()
        valid = make_validate_fn(cfg, tr.model, lambda: [batch], None)(tr.count)
        torch.cuda.synchronize(dev)
        valid_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for h in hooks:
            h.remove()
    launches_valid = {"fused_residual_unit": fused_residual_unit.launches,
                      "fused_mrf_stage": fused_mrf_stage.launches}
    valid_collectives = _rank_collectives(group)
    path = check_path_kernels(dev, tr.model, recorded, "tp_ranks_valid")

    # the checkpoint: gathered by both ranks, written by the first; restored
    # into a one-device trainer (each rank holds its cut of it against its
    # own parts) and into a fresh rank-group trainer (against the live one)
    ckpt = CheckpointManager(os.path.join(tmp, "ckpt"))
    ckpt.save(tr, write=group.index == 0)
    torch.distributed.barrier()

    def held(t):
        """{name: (split dim, part, exp_avg, exp_avg_sq)} of both models."""
        out = {}
        for prefix, module, opt in (("g", t.model, t.opt_g), ("d", t.disc, t.opt_d)):
            for name, parts, dim in full_parameters(module):
                st = opt.state.get(parts[0], {})
                out[f"{prefix}.{name}"] = (dim, parts[0], st.get("exp_avg"),
                                           st.get("exp_avg_sq"))
        return out

    live = held(tr)
    one = trainer(False)
    step_one = ckpt.restore(one)
    whole = held(one)
    same_one = True
    for k, (dim, part, m1, m2) in live.items():
        cut = (lambda t: t) if dim is None else (
            lambda t: shard_tensor(t, dim, group.size)[group.index].to(part.device))
        _, w, w1, w2 = whole[k]
        same_one &= bool(torch.equal(cut(w.detach()), part.detach())
                         and torch.equal(cut(w1), m1) and torch.equal(cut(w2), m2))
    del one, whole
    back = trainer(True)
    step_back = ckpt.restore(back)
    same_back = all(torch.equal(p.detach(), live[k][1].detach()) and torch.equal(m1, live[k][2])
                    and torch.equal(m2, live[k][3])
                    for k, (_, p, m1, m2) in held(back).items())
    return dict(first=first, ms=ms, median_ms=float(np.median(ms)), peak_bytes=peak,
                collectives_step=step_collectives, launches_steps=launches_steps,
                valid={k: float(v) for k, v in valid.items()}, valid_ms=valid_ms,
                launches_valid=launches_valid, collectives_valid=valid_collectives, path=path,
                checkpoint=dict(step=tr.count, one_step=step_one, back_step=step_back,
                                one_bit_equal=same_one, back_bit_equal=same_back,
                                n_params=len(live)))


def tp_worker(argv) -> None:
    """One rank of `[tp_ranks]` (this script run with --tp-worker): joins
    the process group of the torchrun environment, lays the ranks out as a
    (data, model) mesh of one model group, runs tp_rank_serve and
    tp_rank_train and writes their numbers to --tp-dir."""
    from emotivoice_tpu_torch.parallel.mesh import make_rank_mesh
    from emotivoice_tpu_torch.parallel.multihost import initialize_multihost
    from emotivoice_tpu_torch.parallel.tensor_parallel import RankGroup

    p = argparse.ArgumentParser(allow_abbrev=False)
    p.add_argument("--tp-worker", action="store_true", required=True)
    p.add_argument("--tp-dir", required=True)
    p.add_argument("--tp-device", required=True)
    p.add_argument("--tp-backend", required=True)
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.tp_device)
    torch.cuda.set_device(dev)
    rank, world = initialize_multihost(dev, args.tp_backend, timeout_s=300)
    try:
        mesh = make_rank_mesh(TP_RANKS)
        group = RankGroup(mesh.model_group, dev)
        out = dict(rank=rank, world=world, device=str(dev), backend=args.tp_backend,
                   data_index=mesh.data_index, model_index=mesh.model_index,
                   model_ranks=torch.distributed.get_process_group_ranks(mesh.model_group))
        out.update(tp_rank_serve(dev, group, args.tp_dir))
        out["train"] = tp_rank_train(dev, group, mesh, args.tp_dir)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(args.tp_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _spawn_tp_ranks(tmp: str, timeout: float = 720.0) -> list:
    """TP_RANKS processes of this script with --tp-worker and the torchrun
    environment; fails (and kills the others) as soon as one exits non-zero,
    or at `timeout`. Returns each rank's log."""
    port = _free_port()
    procs = []
    try:
        for r, (d, backend) in enumerate(_tp_rank_places()):
            log_path = os.path.join(tmp, f"tp_rank{r}.log")
            env = _dp_env(r, port)
            env["WORLD_SIZE"] = str(TP_RANKS)
            procs.append((subprocess.Popen(
                _worker_cmd() + ["--tp-worker", "--tp-dir", tmp, "--tp-device", d,
                                 "--tp-backend", backend],
                env=env, cwd=ROOT, stdout=open(log_path, "w"), stderr=subprocess.STDOUT),
                log_path))
        deadline = time.time() + timeout
        while any(p.poll() is None for p, _ in procs):
            if time.time() > deadline or any(p.poll() not in (None, 0) for p, _ in procs):
                break
            time.sleep(1.0)
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    texts = [open(path).read() for _, path in procs]
    for r, ((p, _), text) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            fail(f"[tp_ranks] rank {r} exited {p.returncode}: {text[-3000:]}")
    return texts


def phase_tp_ranks(dev, cfg, vocab, model) -> dict:
    """Tensor parallelism over two processes, one shard each (the 'model'
    axis across processes; the ranks from this script with --tp-worker):
    the bench bucket through a SynthesisEngine over the rank group against
    the one-device engine, f32 (TF32 off) then bf16, at `[tp_serve]`'s
    tolerances, both ranks' waveforms equal, 18 + 2 launches per generator
    call on each rank and both kernels held against their plain versions
    at the shapes each rank gave them; then a TrainStep over the rank group
    against one device on `[tp_train]`'s batch (losses, the 11 gradient
    norms, 0 kernel launches), TP_STEPS more steps, validation through the
    kernels (18 + 2 per rank) and the checkpoint restored bit-equal into a
    one-device trainer and back into the ranks. Prints ms per call and per
    step, the collectives per generator call and per step and the bytes
    they move, parameter bytes and peak memory per rank, and the backend."""
    from emotivoice_tpu_torch.data.synthetic_corpus import main as make_corpus
    from emotivoice_tpu_torch.serving.engine import SynthesisEngine
    from emotivoice_tpu_torch.training.loop import build_models
    from emotivoice_tpu_torch.training.step import TrainStep

    places = _tp_rank_places()
    backend = places[0][1]
    args = _bench_args(cfg, vocab, SEED + 9)
    inputs = [torch.as_tensor(a, device=dev) for a in args]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tpr_")
    try:
        # the one-device references, before the ranks share the card
        ref = {}
        for dname in ("f32", "bf16"):
            dtype = torch.float32 if dname == "f32" else torch.bfloat16
            one = SynthesisEngine(cfg, model, vocab, device=dev, dtype=dname)
            _, n1 = one.run(*args, BENCH_FRAMES, 1.0)
            with torch.inference_mode():
                o1 = one.model(*inputs, max_frames=BENCH_FRAMES, dtype=dtype)
            torch.save(o1["dec_outputs"].cpu(), os.path.join(tmp, f"mel_{dname}.pt"))
            ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                one.run(*args, BENCH_FRAMES, 1.0)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            ref[dname] = dict(n1=n1, durations=o1["durations"].cpu().numpy(),
                              wav=o1["wav_predictions"].float().cpu().numpy(),
                              median_ms=float(np.median(ms)))
            del one, o1
        make_corpus(["--out", os.path.join(tmp, "corpus"), "--n-train", "64", "--n-valid", "8",
                     "--n-speakers", "4", "--seed", str(SEED)])
        tcfg, ds, batch = _dp_setup(os.path.join(tmp, "corpus"), os.path.join(tmp, "cache"), dev)
        for i in range(len(ds)):  # every feature on the card into the cache, for the ranks
            ds[i]
        m, d = build_models(tcfg, dev)
        m.eval()
        d.eval()
        tr = TrainStep(tcfg, m, d)
        metrics = tr(batch)
        one_step = dict(metrics={k: float(v) for k, v in metrics.items()},
                        grads=whole_grad_norms(tr.model, tr.disc, TRAIN_GRAD_PARAMS))
        one_ms = []
        for _ in range(TP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr(batch)
            torch.cuda.synchronize()
            one_ms.append((time.perf_counter() - t0) * 1e3)
        del tr, m, d, metrics
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        texts = _spawn_tp_ranks(tmp)
        ranks_s = time.perf_counter() - t0
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(TP_RANKS)]
        serve = {dname: [dict(np.load(os.path.join(tmp, f"serve_{dname}_rank{r}.npz")))
                         for r in range(TP_RANKS)] for dname in ("f32", "bf16")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for r, text in enumerate(texts):
        for line in text.splitlines():
            if line.startswith("[tp_ranks"):
                log(f"  rank {r}: {line}")

    mib, gib = 2 ** 20, 2 ** 30
    per_call = launches_per_call(cfg.vocoder)
    out = dict(backend=backend, devices=[p[0] for p in places], ranks_s=ranks_s, serve={})
    audio_s = BENCH_B * BENCH_FRAMES * cfg.audio.hop_length / cfg.audio.sampling_rate
    for dname in ("f32", "bf16"):
        want, got = ref[dname], serve[dname]
        r0 = got[0]
        for r, g in enumerate(got[1:], 1):
            for k in ("n2", "durations", "wav", "voc"):
                if not np.array_equal(g[k], r0[k]):
                    fail(f"[tp_ranks] {dname}: rank {r}'s {k} differs from rank 0's: max "
                         f"{float(np.abs(g[k].astype(np.float64) - r0[k]).max()):.3g}")
        for r, rk in enumerate(ranks):
            if tuple(rk["serve"][dname]["launches"].values()) != per_call:
                fail(f"[tp_ranks] {dname}: rank {r} launched {rk['serve'][dname]['launches']} "
                     f"!= {per_call} per generator call")
        same = (r0["durations"] == want["durations"]).all(axis=1)
        off = np.abs(r0["n2"].astype(np.int64) - want["n1"])
        if dname == "f32" and not (same.all() and np.array_equal(r0["n2"], want["n1"])):
            fail(f"[tp_ranks] f32: durations differ: {r0['n2']} vs {want['n1']}")
        if not same.any() or np.any(off > 1 + TP_BF16_FRAMES * want["n1"]):
            fail(f"[tp_ranks] {dname}: durations differ beyond rounding: {r0['n2']} vs "
                 f"{want['n1']}, {int(same.sum())} rows with equal durations")
        scale = float(np.abs(want["wav"]).max())
        err = float(np.abs(r0["wav"][same] - want["wav"][same]).max())
        err_voc = float(np.abs(r0["voc"] - want["wav"]).max())
        tol = TOL_CPU if dname == "f32" else TOL_DP_BF16
        if (not np.all(np.isfinite(r0["wav"])) or scale < 1e-3 or err > tol * scale
                or err_voc > tol * scale):
            fail(f"[tp_ranks] {dname}: ranks vs one device: max err {err:.3g} (rows with equal "
                 f"durations), {err_voc:.3g} (the vocoder on one mel) > {tol} x max {scale:.3g}")
        s0 = ranks[0]["serve"][dname]
        out["serve"][dname] = dict(err=err, err_vocoder=err_voc, scale=scale,
                                   rows_same_durations=int(same.sum()), frames_off=off.tolist(),
                                   one_ms=want["median_ms"],
                                   ranks=[rk["serve"][dname] for rk in ranks])
        log(f"[tp_ranks] {dname}, bench bucket B={BENCH_B} x {BENCH_T_TEXT} tokens x "
            f"{BENCH_FRAMES} frames, one replica split over {TP_RANKS} ranks ({backend}, "
            f"{', '.join(out['devices'])}): durations equal on {int(same.sum())} of {BENCH_B} rows "
            f"(frames off by {sorted(int(o) for o in off[~same])} on the others); max |ranks - "
            f"one device| {err:.2e} on those rows, the vocoder on the one-device mel "
            f"{err_voc:.2e} (tol {tol} x max {scale:.3f}); the ranks' waveforms equal; launches "
            f"{s0['launches']} per generator call on each rank; "
            f"{s0['median_ms']:.1f} / {ranks[1]['serve'][dname]['median_ms']:.1f} ms per run "
            f"on rank 0 / 1 vs {want['median_ms']:.1f} ms one device (median of 3; xRT "
            f"{audio_s * 1e3 / s0['median_ms']:.1f} vs {audio_s * 1e3 / want['median_ms']:.1f}); "
            f"collectives per generator call on each rank: {_collectives_str(s0['collectives'])}; "
            f"parameter MiB per rank {s0['bytes_shard'][0] / mib:.2f} split + "
            f"{s0['bytes_whole'] / mib:.2f} whole; peak memory per rank "
            + ", ".join(f"{rk['serve'][dname]['peak_bytes'] / gib:.2f}" for rk in ranks)
            + " GiB")

    t0 = ranks[0]["train"]
    per_call_valid = launches_per_call(tcfg.vocoder)
    for r, rk in enumerate(ranks):
        t = rk["train"]
        if t["first"]["metrics"] != t0["first"]["metrics"]:
            fail(f"[tp_ranks] the ranks' metrics differ: {t['first']['metrics']} vs "
                 f"{t0['first']['metrics']}")
        if any(t["launches_steps"].values()):
            fail(f"[tp_ranks] rank {r}'s train steps launched kernels: {t['launches_steps']}")
        if tuple(t["launches_valid"].values()) != per_call_valid:
            fail(f"[tp_ranks] rank {r}'s validation launched {t['launches_valid']} != "
                 f"{per_call_valid} per generator call")
        ck = t["checkpoint"]
        if not (ck["one_bit_equal"] and ck["back_bit_equal"]
                and ck["one_step"] == ck["back_step"] == ck["step"] == 1 + TP_STEPS):
            fail(f"[tp_ranks] rank {r}: the checkpoint did not restore bit-equal: {ck}")
        if not all(np.isfinite(v) for v in t["valid"].values()) or t["valid"] != t0["valid"]:
            fail(f"[tp_ranks] validation losses not finite or not equal on the ranks: "
                 f"{t['valid']} vs {t0['valid']}")
    loss_err = {k: abs(t0["first"]["metrics"][k] - v) / max(abs(v), 1e-12)
                for k, v in one_step["metrics"].items()}
    grad_err = {k: abs(t0["first"]["grads"][k] - v) / max(abs(v), 1e-12)
                for k, v in one_step["grads"].items()}
    worst_loss = max(loss_err.items(), key=lambda kv: kv[1])
    worst_grad = max(grad_err.items(), key=lambda kv: kv[1])
    one_med = float(np.median(one_ms))
    log(f"[tp_ranks] one train step, batch {DP_GLOBAL_B} x {int(batch['tokens'].shape[1])} tokens "
        f"x {int(batch['mel'].shape[1])} frames, f32, dropout off: models split over "
        f"{TP_RANKS} ranks ({backend}) vs one device from the same seeded state: worst loss rel "
        f"err {worst_loss[1]:.2e} ({worst_loss[0]}; tol {TOL_TRAIN_LOSS}), worst grad-norm rel "
        f"err {worst_grad[1]:.2e} ({worst_grad[0]}; tol {TOL_TRAIN_GRAD}); {TP_STEPS} more "
        f"steps: {t0['median_ms']:.1f} / {ranks[1]['train']['median_ms']:.1f} ms on rank 0 / 1 "
        f"vs {one_med:.1f} ms one device (median wall ms); collectives per step on each rank: "
        f"{_collectives_str(t0['collectives_step'])}; peak memory above the resident state "
        + ", ".join(f"{rk['train']['peak_bytes'] / gib:.2f}" for rk in ranks)
        + f" GiB per rank; kernel launches in the steps {t0['launches_steps']}; validation "
        f"through the kernels {t0['valid_ms']:.0f} ms, launches {t0['launches_valid']} on each "
        f"rank, mel_l1 {t0['valid']['mel_l1']:.4f} on both; the checkpoint of step "
        f"{t0['checkpoint']['step']} ({t0['checkpoint']['n_params']} parameters) bit-equal in a "
        f"one-device trainer and back in the ranks; {ranks_s:.1f} s the ranks (start-up "
        f"included)")
    if not (worst_loss[1] <= TOL_TRAIN_LOSS and worst_grad[1] <= TOL_TRAIN_GRAD):
        fail(f"[tp_ranks] ranks and one device disagree: {loss_err} {grad_err}")
    out["train"] = dict(one=one_step, one_ms=one_ms, loss_rel_err=loss_err,
                        grad_rel_err=grad_err, ranks=[rk["train"] for rk in ranks])
    report["tp_ranks"] = out
    launches = {name: sum(rk["serve"][dn]["launches"][name] for rk in ranks
                          for dn in ("f32", "bf16"))
                + sum(rk["train"]["launches_valid"][name] for rk in ranks)
                for name in ("fused_residual_unit", "fused_mrf_stage")}
    path = _merge_paths(*(p for rk in ranks for p in (rk["path"], rk["train"]["path"])))
    return dict(launches=launches, launches_steps=t0["launches_steps"], path=path)


# ---------------------------------------------------------------------------
# 11. style-encoder pretraining
# ---------------------------------------------------------------------------

PRETRAIN_B, PRETRAIN_CPU_B, PRETRAIN_STEPS = 16, 4, 5


def _pretrain_batch(cfg, tok, n: int, seed: int) -> dict:
    """n stand-in-tokenized prompts (max_len 64) with seeded attribute labels."""
    from emotivoice_tpu_torch.training.style_pretrain import ATTRIBUTES

    rng = np.random.RandomState(seed)
    texts = [STYLE_TEXTS[i % len(STYLE_TEXTS)] + " again" * (i // len(STYLE_TEXTS))
             for i in range(n)]
    enc = tok(texts, padding="max_length", truncation=True, max_length=64, return_tensors="np")
    batch = {k: torch.as_tensor(v) for k, v in enc.items()}
    for a in ATTRIBUTES:
        batch[a] = torch.as_tensor(rng.randint(0, getattr(cfg, f"{a}_n_labels"), n))
    return batch


def phase_style_pretrain(dev) -> dict:
    """The full-width StyleBertConfig encoder (random parameters from a seed,
    the stand-in tokenizer): one PretrainStep on the card and on the CPU
    from the same weights (dropout off, PRETRAIN_CPU_B prompts): the losses
    and the gradient norms of three parameters; then PRETRAIN_STEPS steps of
    `pretrain` at batch PRETRAIN_B with dropout on: device ms per step."""
    from emotivoice_tpu_torch.config import StyleBertConfig
    from emotivoice_tpu_torch.models.bert import StyleEncoder
    from emotivoice_tpu_torch.models.jets import init_random_
    from emotivoice_tpu_torch.training.style_pretrain import PretrainStep, pretrain

    cfg = StyleBertConfig()
    tok = StandInTokenizer(cfg.vocab_size)
    state = init_random_(StyleEncoder(cfg), SEED + 4).state_dict()
    names = ("bert.encoder.layer.0.attention.self.query.weight", "bert.pooler.dense.weight",
             "emotion_clf.classifier.weight")
    got = {}
    batch = _pretrain_batch(cfg, tok, PRETRAIN_CPU_B, SEED)
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model = StyleEncoder(cfg)
        model.load_state_dict(state)
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        step = PretrainStep(model.to(device))
        t0 = time.perf_counter()
        metrics = step({k: v.to(device) for k, v in batch.items()})
        named = dict(model.named_parameters())
        got[where] = dict(metrics={k: float(v) for k, v in metrics.items()},
                          grads={k: float(named[k].grad.norm()) for k in names},
                          seconds=time.perf_counter() - t0)
    card, cpu = got["card"], got["cpu"]
    errs = {k: abs(card["metrics"][k] - v) / max(abs(v), 1e-12)
            for k, v in cpu["metrics"].items() if k.endswith("loss")}
    errs.update({k: abs(card["grads"][k] - v) / max(abs(v), 1e-12)
                 for k, v in cpu["grads"].items()})
    worst = max(errs.items(), key=lambda kv: kv[1])
    log(f"[style_pretrain] StyleEncoder {cfg.num_layers} layers, {cfg.hidden_size}-d, one "
        f"PretrainStep on {PRETRAIN_CPU_B} prompts, dropout off, card vs CPU: loss "
        f"{card['metrics']['loss']:.5f} vs {cpu['metrics']['loss']:.5f}; worst rel err over the "
        f"5 losses and {len(names)} gradient norms {worst[1]:.2e} ({worst[0]}; tol "
        f"{TOL_PRETRAIN}, f32 with TF32 off); {cpu['seconds']:.1f} s on the CPU")
    if worst[1] > TOL_PRETRAIN or not np.isfinite(card["metrics"]["loss"]):
        fail(f"[style_pretrain] card and CPU disagree: {errs}")

    model = StyleEncoder(cfg)
    model.load_state_dict(state)
    batches = [_pretrain_batch(cfg, tok, PRETRAIN_B, SEED + 1 + i)
               for i in range(PRETRAIN_STEPS)]

    class Lines:
        rows = []

        def log(self, step, metrics, prefix):
            self.rows.append(dict(step=step, prefix=prefix, **metrics))

    lines = Lines()
    torch.backends.cudnn.allow_tf32 = True  # pretrain() must turn it off itself
    t0 = time.perf_counter()
    pretrain(model, batches, total_steps=PRETRAIN_STEPS, log_every=1, logger=lines, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("[style_pretrain] pretrain() left TF32 on")
    if [r["step"] for r in lines.rows] != list(range(1, PRETRAIN_STEPS + 1)) or not all(
            np.isfinite(r["loss"]) for r in lines.rows):
        fail(f"[style_pretrain] pretrain logged {lines.rows}")
    step = PretrainStep(model)
    dev_batch = {k: v.to(dev) for k, v in batches[0].items()}
    ms = timed(lambda: step(dev_batch), iters=PRETRAIN_STEPS, warmup=1)
    log(f"[style_pretrain] pretrain(): {PRETRAIN_STEPS} steps at batch {PRETRAIN_B} x 64 tokens, "
        f"dropout on, AdamW(2e-5, wd 1e-4): {wall:.2f} s (first step included); loss "
        + " -> ".join(f"{r['loss']:.4f}" for r in lines.rows)
        + f"; {ms:.1f} ms per PretrainStep (CUDA events, {PRETRAIN_STEPS} steps)")
    report["style_pretrain"] = dict(card_vs_cpu=got, rel_err=errs, pretrain_wall_s=wall,
                                    log=lines.rows, step_ms=ms)
    return dict(step_ms=ms)


# ---------------------------------------------------------------------------
# 12. the fallback vocoder; 13-15. the user tools
# ---------------------------------------------------------------------------

FALLBACK_B, FALLBACK_FRAMES, FALLBACK_ITERS = 16, 384, 32
TOL_FALLBACK = 1e-4  # istft, stft_phase (as |X| e^{i phase}), mel_to_linear: card vs CPU, of max
TOL_FALLBACK_SPECTRAL = 1e-3  # |spectral error on the card - on the CPU| after 32 rounds
CORPUS_B, SWEEP_B, SWEEP_SPEAKERS, SWEEP_CHECKED = 16, 16, 64, 4
CORPUS_WORDS = ("the quick brown fox jumps over a lazy dog while morning light falls on quiet "
                "river water and children sing happy songs near old stone bridges where "
                "gentle voices call home every evening before dinner").split()
CORPUS_HANZI = ["今天天气不错。", "我们用Python做TTS。", "你好，世界。", "请打开App然后点击开始。"]


class PathWatch:
    """Counts the calls of every HiFi-GAN generator that runs inside the
    `with` block with its kernels on (the tools build their own models) and
    records the (B, T, C, dtype) each hands to a kernel; the launch counters
    are set to 0 on entry and read on exit."""

    def __enter__(self):
        from emotivoice_tpu_torch.models.hifigan import HiFiGANGenerator
        from emotivoice_tpu_torch.ops.cuda.mrf_stage import fused_mrf_stage
        from emotivoice_tpu_torch.ops.cuda.resblock import fused_residual_unit

        self.kernels = {"fused_residual_unit": fused_residual_unit,
                        "fused_mrf_stage": fused_mrf_stage}
        self.calls, self.seen, self._hooks = 0, {}, []
        self._cls, self._forward = HiFiGANGenerator, HiFiGANGenerator.forward
        watch = self

        def forward(gen, *args, **kwargs):
            if gen.kernels:
                if id(gen) not in watch.seen:
                    shapes, hooks = watch_stage_shapes(types.SimpleNamespace(generator=gen))
                    watch.seen[id(gen)] = (gen, shapes)
                    watch._hooks += hooks
                watch.calls += 1
            return watch._forward(gen, *args, **kwargs)

        for k in self.kernels.values():
            k.launches = 0
        HiFiGANGenerator.forward = forward
        return self

    def __exit__(self, *exc):
        self._cls.forward = self._forward
        for h in self._hooks:
            h.remove()
        self.launches = {name: k.launches for name, k in self.kernels.items()}
        return False

    def check(self, dev, tag: str) -> dict:
        """Launches of 18 + 2 (V1) per generator call, then both kernels
        against their plain versions at every recorded shape."""
        if not self.calls:
            fail(f"[{tag}] no generator call ran with the kernels")
        per = None
        for gen, _ in self.seen.values():
            p = launches_per_call(gen.cfg)
            if per not in (None, p):
                fail(f"[{tag}] generators of two vocoder configs ran")
            per = p
        want = {"fused_residual_unit": per[0] * self.calls, "fused_mrf_stage": per[1] * self.calls}
        if self.launches != want:
            fail(f"[{tag}] launch counters {self.launches} != {per[0]} + {per[1]} per generator "
                 f"call x {self.calls}")
        merged = dict(worst={}, worst_rel={}, shapes={})
        for i, (gen, shapes) in enumerate(self.seen.values()):
            r = check_path_kernels(dev, types.SimpleNamespace(generator=gen), shapes, f"{tag}{i}")
            for key, fold in (("worst", max), ("worst_rel", max),
                              ("shapes", lambda a, b: a + b)):
                for name, v in r[key].items():
                    merged[key][name] = fold(merged[key].get(name, 0), v)
        return merged


def _add_launches(*watches) -> dict:
    return {name: sum(w.launches[name] for w in watches) for name in watches[0].launches}


def _merge_paths(*paths) -> dict:
    return {key: {name: (max if key != "shapes" else sum)(p[key][name] for p in paths)
                  for name in paths[0][key]} for key in ("worst", "worst_rel", "shapes")}


def _two_tone(sr: int, n: int, f1: float, f2: float, seed: int) -> np.ndarray:
    t = np.arange(n) / sr
    noise = np.random.RandomState(seed).randn(n)
    return (0.3 * np.sin(2 * np.pi * f1 * t) + 0.2 * np.sin(2 * np.pi * f2 * t)
            + 0.01 * noise).astype(np.float32)


def spectral_error(rec: torch.Tensor, ref: np.ndarray, a) -> float:
    """The phase-blind error of tests/test_dsp.py's Griffin-Lim test: sum
    |STFT magnitude difference| / sum |STFT magnitude of the reference|, on
    the CPU, over every row, one hop cut off at each end."""
    from emotivoice_tpu_torch.ops.stft import stft_magnitude

    n, hop = ref.shape[-1], a.hop_length
    ma = stft_magnitude(rec.float().cpu()[:, hop:n - hop], a.n_fft, hop, a.win_length)
    mb = stft_magnitude(torch.from_numpy(ref[:, hop:n - hop]), a.n_fft, hop, a.win_length)
    return float((ma - mb).abs().sum() / mb.abs().sum())


def phase_fallback(dev) -> dict:
    from emotivoice_tpu_torch.config import AudioConfig
    from emotivoice_tpu_torch.ops.mel import mel_spectrogram, mel_to_linear
    from emotivoice_tpu_torch.ops.stft import griffin_lim, istft, stft_magnitude, stft_phase

    a = AudioConfig()  # the full-width model's: 80 mels, n_fft 1024, hop 256, 16 kHz
    fft = (a.n_fft, a.hop_length, a.win_length)
    cpu = torch.device("cpu")
    n = a.hop_length * (FALLBACK_FRAMES - 1)  # FALLBACK_FRAMES centred frames
    inputs = {
        "2 s two-tone": _two_tone(a.sampling_rate, 2 * a.sampling_rate, 220.0, 1200.0, SEED)[None],
        f"batch {FALLBACK_B} x {FALLBACK_FRAMES} frames": np.stack([
            _two_tone(a.sampling_rate, n, 110.0 * (1 + i % 8), 900.0 + 150.0 * i, SEED + 1 + i)
            for i in range(FALLBACK_B)]),
    }
    out = {}
    for name, wav in inputs.items():
        mel = mel_spectrogram(torch.from_numpy(wav), a.sampling_rate, *fft, a.n_mels, a.fmin,
                              a.fmax)
        lin, rec = {}, {}
        for key, d in (("card", dev), ("cpu", cpu)):
            lin[key] = mel_to_linear(mel.to(d), a.sampling_rate, a.n_fft, a.n_mels, a.fmin, a.fmax)
            rec[key] = griffin_lim(lin[key], FALLBACK_ITERS, *fft).cpu()
        want = lin["cpu"]
        lin_err = float((lin["card"].cpu() - want).abs().max() / want.abs().max())
        # one istft and one analysis, seeded phases / the input signal
        phase = torch.from_numpy(np.random.RandomState(SEED).uniform(
            -np.pi, np.pi, tuple(want.shape)).astype(np.float32))
        got_i, want_i = istft(lin["card"], phase.to(dev), *fft).cpu(), istft(want, phase, *fft)
        istft_err = float((got_i - want_i).abs().max() / want_i.abs().max())
        x = torch.from_numpy(wav)
        ph_card, ph_cpu = stft_phase(x.to(dev), *fft).cpu().double(), stft_phase(x, *fft).double()
        mag = stft_magnitude(x, *fft).double()
        phase_err = float((mag * (torch.polar(torch.ones_like(ph_card), ph_card)
                                  - torch.polar(torch.ones_like(ph_cpu), ph_cpu)).abs()).max()
                          / mag.max())
        errs = {d: spectral_error(rec[d], wav, a) for d in rec}
        finite = all(r.shape == wav.shape and bool(torch.isfinite(r).all()) for r in rec.values())
        log(f"[fallback] {name}: mel_to_linear card vs CPU {lin_err:.2e}, istft {istft_err:.2e}, "
            f"stft_phase (as |X| e^(i phase)) {phase_err:.2e} of max (tol {TOL_FALLBACK}); "
            f"after griffin_lim({FALLBACK_ITERS}) the spectral error against the input is "
            f"{errs['card']:.5f} on the card, {errs['cpu']:.5f} on the CPU (tol "
            f"{TOL_FALLBACK_SPECTRAL} apart)")
        if not finite or max(lin_err, istft_err, phase_err) > TOL_FALLBACK:
            fail(f"[fallback] {name}: card and CPU disagree, or the waveform is not finite")
        if abs(errs["card"] - errs["cpu"]) > TOL_FALLBACK_SPECTRAL:
            fail(f"[fallback] {name}: spectral errors {errs} differ by more than "
                 f"{TOL_FALLBACK_SPECTRAL}")
        out[name] = dict(mel_to_linear_err=lin_err, istft_err=istft_err, stft_phase_err=phase_err,
                         spectral_error=errs)
    lin_b = lin["card"]
    ms = timed(lambda: griffin_lim(lin_b, FALLBACK_ITERS, *fft), iters=3)
    log(f"[fallback] griffin_lim at {FALLBACK_B} x {FALLBACK_FRAMES} frames x {FALLBACK_ITERS} "
        f"rounds on the card: {ms:.2f} ms per call ({ms / FALLBACK_ITERS:.3f} ms per round)")
    report["fallback"] = dict(inputs=out, griffin_lim_ms=ms)
    return dict(griffin_lim_ms=ms)


def _corpus_lines() -> list:
    rng = np.random.RandomState(SEED)
    lines = []
    for i in range(40):
        words = list(rng.choice(CORPUS_WORDS, 3 + i % 16))
        lines.append(" ".join(words).capitalize() + ".?!"[i % 3])
    for i, text in enumerate(CORPUS_HANZI):  # g2p needs pypinyin for these
        lines.insert(10 * i + 9, text)
    return lines


def phase_corpus(dev) -> dict:
    from emotivoice_tpu_torch.tools import synthesize_corpus
    from emotivoice_tpu_torch.utils.audio_io import read_wav

    lines = _corpus_lines()
    hanzi_ok = importlib.util.find_spec("pypinyin") is not None
    n_wavs = sum(hanzi_ok or t not in CORPUS_HANZI for t in lines)
    prompts = synthesize_corpus.DEFAULT_PROMPTS
    n_speaker = synthesize_corpus.model_config().am.n_speaker  # no --speakers: every row
    tmp = tempfile.mkdtemp(prefix="chip_smoke_corpus_")
    runs, watches, paths = {}, [], []
    try:
        text_file = os.path.join(tmp, "lines.txt")
        with open(text_file, "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
        for dname in ("f32", "bf16", "bf16 again"):
            out_dir = os.path.join(tmp, dname.split()[0])
            with PathWatch() as w:  # no --device: the card, as a user runs it
                stats = synthesize_corpus.main(["--text-file", text_file, "--output-dir", out_dir,
                                                "--dtype", dname.split()[0],
                                                "--batch-size", str(CORPUS_B)])
            torch.cuda.synchronize()
            runs[dname] = dict(stats=stats, generator_calls=w.calls, launches=w.launches)
            if dname == "bf16 again":
                if stats["rendered"] or stats["skipped_existing"] != n_wavs or w.calls:
                    fail(f"[corpus] a second run on the same directory rendered again: {stats}")
                log(f"[corpus] the same file again into the bf16 directory: {stats['rendered']} "
                    f"lines rendered, {stats['skipped_existing']} skipped as done")
                continue
            watches.append(w)
            paths.append(w.check(dev, f"corpus_{dname}"))
            names = sorted(os.listdir(out_dir))
            txts = [n for n in names if n.endswith(".txt")]
            wavs = [n for n in names if n.endswith(".wav")]
            if len(txts) != len(lines) or len(wavs) != n_wavs or stats["rendered"] != n_wavs:
                fail(f"[corpus] {dname}: {len(txts)} transcripts, {len(wavs)} wavs for "
                     f"{len(lines)} lines ({n_wavs} renderable): {stats}")
            for i, text in enumerate(lines):
                with open(os.path.join(out_dir, f"{i:06d}.txt"), encoding="utf-8") as f:
                    spk, prompt, said = f.read().rstrip("\n").split("|")
                if (int(spk) != i % n_speaker or prompt != prompts[i % len(prompts)]
                        or said != text):
                    fail(f"[corpus] line {i}: {spk}|{prompt}|{said} breaks the round-robin")
            audio = [read_wav(os.path.join(out_dir, n))[1] for n in wavs]
            if not all(len(x) and np.all(np.isfinite(x)) for x in audio):
                fail(f"[corpus] {dname}: an empty or non-finite wav")
            log(f"[corpus] {dname}: {len(lines)} lines ({stats['g2p_failed']} failed g2p, "
                f"hanzi without pypinyin), {stats['rendered']} wavs in {w.calls} generator calls "
                f"at batch {CORPUS_B}, {stats['wall_s']:.2f} s ({stats['synth_s']:.2f} s of it in "
                f"SynthesisEngine.synthesize_batch): "
                f"{stats['rendered'] / stats['wall_s']:.2f} lines/s, xRT "
                f"{stats['audio_s'] / stats['wall_s']:.1f} ({stats['audio_s']:.1f} s of audio); "
                f"launches {w.launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["corpus"] = runs
    return dict(launches=_add_launches(*watches), path=_merge_paths(*paths),
                path_f32=paths[0], runs=runs)


def phase_sweep(dev) -> dict:
    from emotivoice_tpu_torch.tools import sweep_voices

    tmp = tempfile.mkdtemp(prefix="chip_smoke_sweep_")
    try:
        cpu_wavs, big_wavs = os.path.join(tmp, "cpu_wavs"), os.path.join(tmp, "wavs")
        rows_cpu, rows_card, rows_big = (os.path.join(tmp, f"{n}.jsonl")
                                         for n in ("cpu", "card", "big"))
        base = ["--batch-size", str(SWEEP_B)]
        t0 = time.perf_counter()
        cpu = sweep_voices.main(base + ["--device", "cpu", "--dtype", "f32", "--limit",
                                        str(SWEEP_CHECKED), "--save-wavs", cpu_wavs,
                                        "--out", rows_cpu])
        cpu_s = time.perf_counter() - t0
        with PathWatch() as w32:
            card = sweep_voices.main(base + ["--dtype", "f32", "--limit", str(SWEEP_CHECKED),
                                             "--compare", cpu_wavs, "--out", rows_card])
        path32 = w32.check(dev, "sweep_f32")
        rows = [json.loads(line) for line in open(rows_card)]
        scale = max(json.loads(line)["peak"] for line in open(rows_cpu))
        mae = max(r["ref_mae"] for r in rows)
        log(f"[sweep] {card['cells']} cells ({SWEEP_CHECKED} speakers x {card['prompts']} "
            f"prompts) f32 on the CPU ({cpu_s:.1f} s) then on the card with --compare: worst MAE "
            f"{mae:.2e} (max |wav| {scale:.3f}, tol {TOL_CPU} x max), length deltas "
            f"{sorted({r['ref_len_delta'] for r in rows})}; launches {w32.launches} over "
            f"{w32.calls} generator calls")
        if (len(rows) != cpu["cells"] or any(r["ref_len_delta"] for r in rows)
                or scale < 1e-3 or mae > TOL_CPU * scale or card["failures"] or cpu["failures"]):
            fail("[sweep] the card's cells disagree with the CPU's")
        with PathWatch() as w16:
            big = sweep_voices.main(base + ["--dtype", "bf16", "--limit", str(SWEEP_SPEAKERS),
                                            "--save-wavs", big_wavs, "--out", rows_big])
        path16 = w16.check(dev, "sweep_bf16")
        rows = [json.loads(line) for line in open(rows_big)]
        cells = SWEEP_SPEAKERS * len(sweep_voices.DEFAULT_PROMPTS)
        if (big["cells"] != cells or len(rows) != cells or big["failures"]
                or not all(r["finite"] for r in rows) or len(os.listdir(big_wavs)) != cells):
            fail(f"[sweep] bf16 sweep: {big}")
        log(f"[sweep] {cells} cells ({SWEEP_SPEAKERS} speakers x {big['prompts']} prompts) bf16 at "
            f"batch {SWEEP_B}: every waveform finite, peak {big['peak']['min']:.3f}-"
            f"{big['peak']['max']:.3f}; per-cell RTF p50 {big['rtf']['p50']:.3g}, p95 "
            f"{big['rtf']['p95']:.3g}, max {big['rtf']['max']:.3g}; {big['wall_s']} s; launches "
            f"{w16.launches} over {w16.calls} generator calls (probe + timed dispatch per group)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["sweep"] = dict(cpu=cpu, card=card, big=big, cpu_s=cpu_s)
    return dict(launches=_add_launches(w32, w16), path=_merge_paths(path32, path16),
                path_f32=path32, rtf=big["rtf"])


def _lj_corpus(root: str, sr: int) -> int:
    from scipy.io import wavfile

    os.makedirs(os.path.join(root, "wavs"))
    texts = ["Printing, in the only sense with which we are concerned.", "Is this the way?",
             "Hello world.", "The quick brown fox jumps.", "Speech synthesis at last!"]
    with open(os.path.join(root, "metadata.csv"), "w", encoding="utf-8") as f:
        for i, text in enumerate(texts):
            f.write(f"LJ001-{i + 1:04d}|{text}|{text}\n")
            wavfile.write(os.path.join(root, "wavs", f"LJ001-{i + 1:04d}.wav"), sr,
                          (_two_tone(sr, sr // 2, 220.0, 1700.0, i) * 32767).astype(np.int16))
    return len(texts)


def _databaker_corpus(root: str, sr: int) -> int:
    from scipy.io import wavfile

    pairs = [("000001", "你#1去哪儿#3。", "ni3 qu4 na3r"), ("000002", "我#2爱#1中国#4。",
              "wo3 ai4 zhong1 guo2"), ("002365", "坏#4。", "huai4"),
             ("005107", "生嗯#4。", "sheng1 ng1"), ("000005", "小孩儿#1玩#4。", "xiao3 har2 wan2")]
    os.makedirs(os.path.join(root, "ProsodyLabeling"))
    os.makedirs(os.path.join(root, "Wave"))
    with open(os.path.join(root, "ProsodyLabeling", "000001-010000.txt"), "w",
              encoding="utf-8") as f:
        for i, (key, text, pinyin) in enumerate(pairs):
            f.write(f"{key}\t{text}\n\t{pinyin}\n")
            wavfile.write(os.path.join(root, "Wave", f"{key}.wav"), sr,
                          (_two_tone(sr, sr // 2, 220.0, 1700.0, i) * 32767).astype(np.int16))
    return len(pairs) - 1  # 002365 is skipped by the recipe


def phase_tools(dev, train_out: dict, embedder) -> dict:
    from scipy.io import wavfile

    from emotivoice_tpu_torch.tools import (
        prepare_databaker,
        prepare_ljspeech,
        record_frontend_goldens,
        verify_released_weights,
    )
    from emotivoice_tpu_torch.utils import native

    backend = native.backend()
    log(f"[tools] native codec: {backend} (built into {native.BUILD_DIR})")
    if backend != "native":
        fail("[tools] the native codec was not built on the card's machine")
    ckpt, tmp = train_out["ckpt_dir"], tempfile.mkdtemp(prefix="chip_smoke_tools_")
    try:
        style = os.path.join(tmp, "style_encoder")
        torch.save({"model": {k: v.cpu() for k, v in embedder.model.state_dict().items()}}, style)
        texts = os.path.join(tmp, "texts")
        with open(texts, "w", encoding="utf-8") as f:
            for i, ph in enumerate(("a s e sp i f o", "u x a sp e", "o f i s u sp a e x",
                                    "i e a")):
                f.write(f"{i}|Happy|<sos/eos> {ph} <sos/eos>|utterance {i}\n")
        step = f"{TRAIN_RESUMED_TO:08d}"
        with PathWatch() as w:
            rep = verify_released_weights.main([
                "--generator", os.path.join(ckpt, f"g_{step}"),
                "--discriminator", os.path.join(ckpt, f"do_{step}"),
                "--style-encoder", style, "--texts", texts,
                "--tokenlist", os.path.join(ckpt, "tokenlist"),
                "--out-dir", os.path.join(tmp, "released")])
        gates = rep["gates"]
        log(f"[tools] verify_released_weights on [train]'s step-{TRAIN_RESUMED_TO} checkpoints and "
            f"[style]'s encoder: gates {gates}; {len(rep['utterances'])} utterances, frames "
            f"{[u['n_frames'] for u in rep['utterances']]}; launches {w.launches} over {w.calls} "
            f"generator calls")
        if (any(gates[g] != "ok" for g in ("convert_generator", "convert_style_encoder",
                                            "convert_discriminator", "port_synthesis"))
                or not gates["reference_model"].startswith("not run") or rep["pass"]):
            fail(f"[tools] verify_released_weights: {gates}")
        path = w.check(dev, "verify")

        recipes = {}
        for name, tool, make, sr in (("ljspeech", prepare_ljspeech, _lj_corpus, 22050),
                                     ("databaker", prepare_databaker, _databaker_corpus, 44100)):
            corpus, out = os.path.join(tmp, f"{name}_corpus"), os.path.join(tmp, name)
            n = make(corpus, sr)
            got = tool.main(["--corpus", corpus, "--output", out])
            wav_dir = os.path.join(out, "wavs_16k" if name == "ljspeech" else "wavs")
            wavs = [wavfile.read(os.path.join(wav_dir, f)) for f in os.listdir(wav_dir)]
            rates, sizes = sorted({r for r, _ in wavs}), sorted({len(x) for _, x in wavs})
            log(f"[tools] prepare_{name} on {n} utterances of 0.5 s at {sr} Hz: {got}; wavs at "
                f"{rates} Hz, {sizes} samples each")
            if (got != {"utterances": n, "resampled": n, "resample_backend": "native"}
                    or rates != [16000] or sizes != [8000]):
                fail(f"[tools] prepare_{name}: {got}")
            recipes[name] = got
        goldens = record_frontend_goldens.main(["--check"])
        log(f"[tools] record_frontend_goldens --check: {goldens}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(ckpt, ignore_errors=True)
    report["tools"] = dict(native=backend, verify=rep, recipes=recipes, goldens=goldens)
    return dict(launches=w.launches, path=path)


def found_encoder() -> bool:
    return importlib.util.find_spec("pydub") is not None or shutil.which("ffmpeg") is not None


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--report", default=None, help="write the detailed numbers here (JSON)")
    p.add_argument("--profile", action="store_true",
                   help="also measure the card's busy time with torch.profiler ([style], "
                        "[serve], the [train] step in each dtype)")
    if "--dp-worker" in sys.argv:  # one rank of [dp_train], started by phase_dp_train
        return dp_worker(sys.argv[1:])
    if "--tp-worker" in sys.argv:  # one rank of [tp_ranks], started by phase_tp_ranks
        return tp_worker(sys.argv[1:])
    args = p.parse_args()
    card = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    phase_build()
    kern = phase_kernels(dev)
    cfg, vocab, model = _build_model()
    main_out = phase_main(dev, cfg, vocab, model)
    cpu_model = phase_cpu(dev, cfg, model)
    embedder = phase_style(dev, args.profile)
    serve_out = phase_serve(dev, cfg, vocab, model, embedder, cpu_model, args.profile)
    dp_serve_out = phase_dp_serve(dev, cfg, vocab, model)
    tp_serve_out = phase_tp_serve(dev, cfg, vocab, model)
    train_out = phase_train(dev, args.profile)
    curves_out = phase_train_curves(dev)
    dp_train_out = phase_dp_train(dev)
    tp_train_out = phase_tp_train(dev)
    tp_ranks_out = phase_tp_ranks(dev, cfg, vocab, model)
    phase_style_pretrain(dev)
    phase_fallback(dev)
    corpus_out = phase_corpus(dev)
    sweep_out = phase_sweep(dev)
    tools_out = phase_tools(dev, train_out, embedder)

    kernels = []
    paths = [main_out["path"], serve_out["path"], train_out["path"], dp_serve_out["path"],
             tp_serve_out["path"], tp_ranks_out["path"],
             curves_out["paths"]["f32"], curves_out["paths"]["bf16"], corpus_out["path"],
             sweep_out["path"], tools_out["path"]]
    src = {"fused_residual_unit": ("emotivoice_tpu_torch/csrc/resblock.cu",
                                   "emotivoice_tpu/ops/pallas/resblock.py:124"),
           "fused_mrf_stage": ("emotivoice_tpu_torch/csrc/mrf_stage.cu",
                               "emotivoice_tpu/ops/pallas/packed_stage.py:329")}
    for name, (source, replaces) in src.items():
        t = kern["totals"][(name, "bf16")]
        t32 = kern["totals"][(name, "f32")]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=main_out["launches"][name],
            launches_serve=serve_out["launches"][name],
            launches_train_steps=train_out["launches_steps"][name],
            launches_train_validation=train_out["launches"][name],
            launches_dp_serve=dp_serve_out["launches"][name],
            launches_dp_train_steps=dp_train_out["launches_steps"][name],
            launches_tp_serve=tp_serve_out["launches"][name],
            launches_tp_train_steps=tp_train_out["launches_steps"][name],
            # both ranks: the engine's two counted generator calls and validation's one
            launches_tp_ranks=tp_ranks_out["launches"][name],
            launches_tp_ranks_train_steps=tp_ranks_out["launches_steps"][name],
            launches_train_curve_validation_f32=curves_out["launches"]["f32"][name],
            launches_train_curve_validation_bf16=curves_out["launches"]["bf16"][name],
            launches_corpus=corpus_out["launches"][name],
            launches_sweep=sweep_out["launches"][name],
            launches_verify_released_weights=tools_out["launches"][name],
            max_abs_err=max(kern["worst"][name], *(p["worst"][name] for p in paths)),
            path_shapes_checked=sum(p["shapes"][name] for p in paths),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by="operations" if t["flop"] / PEAK_BF16 >= t["bytes"] / PEAK_BYTES else "bytes",
            library_ms=t["library_ms"], bound_share=t["bound_ms"] / t["ms"],
            x_cudnn=t["ms"] / t["library_ms"], tflops=t["flop"] / t["ms"] / 1e9,
            dtype="bf16", shape="bench bucket, one generator call",
            ms_f32=t32["ms"], plain_ms_f32=t32["plain_ms"], library_ms_f32=t32["library_ms"],
            bound_ms_f32=t32["bound_ms"], bound_share_f32=t32["bound_ms"] / t32["ms"],
            bound_by_f32=("operations" if TF32_TERMS * t32["flop"] / PEAK_TF32
                          >= t32["bytes"] / PEAK_BYTES else "bytes"),
            bound_cuda_cores_ms_f32=t32["bound_cuda_cores_ms"],
            x_cudnn_f32=t32["ms"] / t32["library_ms"], tflops_f32=t32["flop"] / t32["ms"] / 1e9,
            library_tf32_on_ms_f32=t32["library_tf32_ms"],
            # f32 on every path driven in f32: worst |kernel - plain| / max |plain|
            max_rel_err_f32=max(t32["err"], main_out["path"]["worst_rel"][name],
                                serve_out["path"]["worst_rel"][name],
                                train_out["path"]["worst_rel"][name],
                                curves_out["paths"]["f32"]["worst_rel"][name],
                                corpus_out["path_f32"]["worst_rel"][name],
                                sweep_out["path_f32"]["worst_rel"][name],
                                tools_out["path"]["worst_rel"][name]),
            # both dtypes (two replicas), bf16 (validation of the bf16 run)
            max_rel_err_dp_serve=dp_serve_out["path"]["worst_rel"][name],
            max_rel_err_tp_serve=tp_serve_out["path"]["worst_rel"][name],
            max_rel_err_tp_ranks=tp_ranks_out["path"]["worst_rel"][name],
            max_rel_err_train_bf16=curves_out["paths"]["bf16"]["worst_rel"][name],
        ))
    report["kernels"] = kernels
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
