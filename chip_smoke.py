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
  8. summary  - a `kernels` JSON line, then the result line.

With --report, the detailed numbers are also written to PATH as JSON.
With --profile, torch.profiler also measures the time the card is busy
during one style-encoder forward and during a burst's embedding work.
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
REPLAY_MAX_FRAMES = 6144  # batch x mel frames of a served call replayed on the CPU
TOL_STYLE = 1e-4  # style encoder, card vs CPU, max |pooled| difference (tanh outputs, f32)
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


def device_busy_ms(fn):
    """Milliseconds the card spends in kernels and copies while `fn` runs,
    summed from a torch.profiler trace (None if the trace holds no device
    time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # Device-side events only: a host-side operator's entry repeats the time
    # of the kernels it launched.
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / 1e3 if total > 0 else None


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


def found_encoder() -> bool:
    return importlib.util.find_spec("pydub") is not None or shutil.which("ffmpeg") is not None


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--report", default=None, help="write the detailed numbers here (JSON)")
    p.add_argument("--profile", action="store_true",
                   help="also measure the card's busy time with torch.profiler ([style], [serve])")
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

    kernels = []
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
            max_abs_err=max(kern["worst"][name], main_out["path"]["worst"][name],
                            serve_out["path"]["worst"][name]),
            path_shapes_checked=(main_out["path"]["shapes"][name]
                                 + serve_out["path"]["shapes"][name]),
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
            # f32 on both driven paths: worst |kernel - plain| / max |plain|
            max_rel_err_f32=max(t32["err"], main_out["path"]["worst_rel"][name],
                                serve_out["path"]["worst_rel"][name]),
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
