#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

  python3 chip_smoke.py [--report PATH]

Phases (any failure exits non-zero and prints no result line):
  1. device   - require a CUDA card; print its name and power limit;
  2. build    - compile the port's kernels from emotivoice_tpu_torch/csrc
                with nvcc for sm_90a; count the tensor-core instructions
                (HMMA / HGMMA) of each kernel instantiation in the SASS
                (cuobjdump) and fail if a bf16 one has none;
  3. kernels  - each kernel against its plain PyTorch version on the card,
                at the main path's shapes (bench bucket: batch 16, 384 mel
                frames) and at a ragged T, in f32 (TF32 off) and bf16;
                times of kernel, plain version and the cuDNN convolutions,
                share of the bound and factor against cuDNN;
  4. main     - the full-width EmotiVoiceConfig model (random parameters
                from a seed) behind SynthesisEngine + MicroBatcher answers
                mixed requests; launch counters must read 18 + 2 per
                generator call; xRT at the bench shape in f32 and bf16;
  5. cpu      - the same weights at batch 1, 32 tokens on the card and on
                the CPU (plain versions): equal durations, close waveforms;
  6. summary  - a `kernels` JSON line, then the result line.

With --report, the detailed numbers are also written to PATH as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SEED = 0
BENCH_B, BENCH_T_TEXT, BENCH_FRAMES = 16, 96, 384
PEAK_BF16 = 989e12  # dense bf16 tensor-core FLOP/s, H100 SXM
PEAK_F32 = 67e12  # f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
TOL_F32 = 2e-4  # max |kernel - plain| / max |plain|, f32 with TF32 off
TOL_BF16 = 2e-2  # the same in bf16 (roundings at other places)
TOL_CPU = 2e-3  # whole path, card vs CPU, / max |wav|
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
        bf16 = {c: n for (k, c, dname), n in counts.items() if k == name and dname == "bf16"}
        if not bf16 or not all(bf16.values()):
            fail(f"{name}: bf16 instantiation without tensor-core instructions: {bf16}")


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
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
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
                    lib_ms = timed(lambda: (_conv_ncw(xn, w1t, w[1], d),
                                            _conv_ncw(xn, w2t, w[3], 1)))
                    flop = 4 * k * c * c * BENCH_B * t
                    nbytes = item * (2 * BENCH_B * t * c + 2 * k * c * c + 2 * c)
                    rows.append(dict(kernel="fused_residual_unit", dtype=dname, C=c, T=t,
                                     k=k, d=d, err=err, ms=ms, plain_ms=plain_ms,
                                     library_ms=lib_ms, flop=flop, bytes=nbytes))
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
            lib_ms = timed(lib_stage)
            flop = sum(4 * k * c * c * len(dils) for k, dils in zip(V1_KS, V1_DS)) * BENCH_B * t
            nbytes = item * (2 * BENCH_B * t * c
                             + sum(2 * k * c * c + 2 * c for k, dils in zip(V1_KS, V1_DS)
                                   for _ in dils))
            rows.append(dict(kernel="fused_mrf_stage", dtype=dname, C=c, T=t, k=None, d=None,
                             err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             flop=flop, bytes=nbytes))
        for r in rows:
            if r["dtype"] == dname:
                r["bound_ms"] = 1e3 * max(r["flop"] / peak, r["bytes"] / PEAK_BYTES)
                r["bound_by"] = "operations" if r["flop"] / peak >= r["bytes"] / PEAK_BYTES else "bytes"
    for r in rows:
        key = (r["kernel"], r["dtype"])
        t = totals.setdefault(key, dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                                        flop=0, bytes=0, calls=0, err=0.0))
        for f in ("ms", "plain_ms", "library_ms", "bound_ms", "flop", "bytes"):
            t[f] += r[f]
        t["calls"] += 1
        t["err"] = max(t["err"], r["err"])
        log(f"[kernels] {r['kernel']:<19} {r['dtype']:<4} C={r['C']:<3} T={r['T']:<6} "
            f"k={r['k']} d={r['d']} rel_err={r['err']:.2e} ms={r['ms']:.3f} "
            f"plain_ms={r['plain_ms']:.3f} cudnn_ms={r['library_ms']:.3f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"bound_share={r['bound_ms'] / r['ms']:.4f} x_cudnn={r['ms'] / r['library_ms']:.2f} "
            f"TFLOP/s={r['flop'] / r['ms'] / 1e9:.1f}")
    for (name, dname), t in totals.items():
        log(f"[kernels] per generator call at the bench bucket: {name} {dname} "
            f"{t['calls']} launches ms={t['ms']:.2f} plain_ms={t['plain_ms']:.2f} "
            f"cudnn_ms={t['library_ms']:.2f} bound_ms={t['bound_ms']:.3f} "
            f"bound_share={t['bound_ms'] / t['ms']:.4f} x_cudnn={t['ms'] / t['library_ms']:.2f} "
            f"TFLOP/s={t['flop'] / t['ms'] / 1e9:.1f} max_rel_err={t['err']:.2e}")
    report["kernel_rows"] = rows
    report["kernel_totals"] = {f"{k[0]}/{k[1]}": v for k, v in totals.items()}
    return dict(totals=totals, worst=worst)


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
    try:
        t0 = time.perf_counter()
        results = batcher.submit_many(mixed)
        results += batcher.submit_many(bench)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        batcher.close()
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
    return dict(launches=launches, xrt=xrt)


# ---------------------------------------------------------------------------
# 5. card vs CPU
# ---------------------------------------------------------------------------

def phase_cpu(dev, cfg, model) -> None:
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


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--report", default=None, help="write the detailed numbers here (JSON)")
    args = p.parse_args()
    card = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    phase_build()
    kern = phase_kernels(dev)
    cfg, vocab, model = _build_model()
    main_out = phase_main(dev, cfg, vocab, model)
    phase_cpu(dev, cfg, model)

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
            launches=main_out["launches"][name], max_abs_err=kern["worst"][name],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by="operations" if t["flop"] / PEAK_BF16 >= t["bytes"] / PEAK_BYTES else "bytes",
            library_ms=t["library_ms"], bound_share=t["bound_ms"] / t["ms"],
            x_cudnn=t["ms"] / t["library_ms"], tflops=t["flop"] / t["ms"] / 1e9,
            dtype="bf16", shape="bench bucket, one generator call",
            ms_f32=t32["ms"], plain_ms_f32=t32["plain_ms"], library_ms_f32=t32["library_ms"],
            bound_ms_f32=t32["bound_ms"], bound_share_f32=t32["bound_ms"] / t32["ms"],
            x_cudnn_f32=t32["ms"] / t32["library_ms"],
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
