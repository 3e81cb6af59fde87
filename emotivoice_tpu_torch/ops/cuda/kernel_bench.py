"""Build, check and time the two MRF kernels alone on the card.

  python -m emotivoice_tpu_torch.ops.cuda.kernel_bench [--dtype f32] [--only unit256 stage64]
      [--cfg "256:1,8,4;64:3,16,4"] [--tiles "stage64:168,240"] [--no-check] [--sass]
      [--skip epilogue chain-sum]

The short call to make after a change to a kernel, before the full
`chip_smoke.py`: it builds the library, prints `ptxas -v` registers and
spills per instantiation, holds each kernel against its plain version at the
bench bucket's shapes (batch 16, 384 mel frames; T and T + 37) and times it
beside the cuDNN convolutions of the same function (TF32 off), per shape and
summed per generator call, and the f32 wrappers' K-major weight relayout
per generator call apart from kernel time. `--cfg` times a variant of the
tiling instead: for f32 `C:kMT,kKC,kStages` replaces `WgCfg<C>`
(wgmma_conv_f32.cuh), for bf16 `C:kMT,kKC,kStages,kWait` replaces
`WgCfgBf16<C>` (wgmma_conv_bf16.cuh), in a copy of the sources (under
build/torch_kernels/variants/) and in the wrappers' mirror (`WG_CFG`,
`WG_CFG_BF16`), so two configurations can be compared within one call on one
card. `--tiles` times given tiles in place of the planners' (each shape's
planner is replaced while it runs). `--skip epilogue chain-sum` builds
the bf16 kernels without their epilogues or without the MRF stage's
chain sum, for timing only (their results are wrong, so nothing is
checked): what a part costs, on a card with no profiler. `--sass` adds
each instantiation's tensor-core and TMA instruction counts (HMMA, HGMMA,
UTMALDG) and its most frequent SASS opcodes. The ptxas summary lists every
instantiation, bf16 and f32. Needs a CUDA card and nvcc; prints the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import os
import re
import shutil
import subprocess
import sys
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from emotivoice_tpu_torch.ops.cuda import build
from emotivoice_tpu_torch.ops.cuda import resblock as rb
from emotivoice_tpu_torch.ops.cuda import mrf_stage as ms
from emotivoice_tpu_torch.ops.cuda.mrf_stage import fused_mrf_stage, mrf_stage_plain, pack_stage_f32

BATCH, FRAMES = 16, 384  # the bench bucket
KS, DS = (3, 7, 11), ((1, 3, 5),) * 3  # HiFi-GAN V1 MRF
UNIT_SHAPES = ((256, 8 * FRAMES), (128, 64 * FRAMES))  # (C, T) of stages 1-2
STAGE_SHAPES = ((64, 128 * FRAMES), (32, 256 * FRAMES))  # stages 3-4
DTYPES = {"f32": (torch.float32, "float", "f"), "bf16": (torch.bfloat16, "bf16", "13__nv_bfloat16")}
CFG_LINE = {  # per dtype: the header holding the config struct, its line
    torch.bfloat16: ("wgmma_conv_bf16.cuh", "template <> struct WgCfgBf16<%d> { static constexpr int "
                     "kMT = %d, kKC = %d, kStages = %d, kWait = %d; };"),
    torch.float32: ("wgmma_conv_f32.cuh", "template <> struct WgCfg<%d> { static constexpr int "
                    "kMT = %d, kKC = %d, kStages = %d; };"),
}
# Timing-only variants of the bf16 kernels (--skip): the file, a source line
# and what replaces it, so that the part is left out
SKIPS = {
    "epilogue": ("wgmma_conv_bf16.cuh", "      if (rw >= n_out) continue;",
                 "      if (rw >= -1) continue;"),
    "chain-sum": ("mrf_stage.cu", "        if (g >= T_len) continue;\n        uint4 v =",
                  "        if (g >= -1) continue;\n        uint4 v ="),
}
SYMBOL = re.compile(r"(residual_unit_kernel|mrf_stage_kernel)ILi(\d+)E(13__nv_bfloat16|f)E")

Cfg = Dict[int, Tuple[int, ...]]


def parse_cfg(text: str, dtype: torch.dtype = torch.float32) -> Cfg:
    """'256:1,8,4;64:3,16,4' -> {256: (1, 8, 4), 64: (3, 16, 4)}: 3 values a C
    for f32 (kMT, kKC, kStages), 4 for bf16 (kMT, kKC, kStages, kWait)."""
    want = 3 if dtype == torch.float32 else 4
    out = {}
    for part in filter(None, text.split(";")):
        c, vals = part.split(":")
        vals = tuple(int(v) for v in vals.split(","))
        if int(c) not in rb.CHANNELS or len(vals) != want:
            raise ValueError(f"--cfg wants C:{want} values with C in {rb.CHANNELS}: {part!r}")
        out[int(c)] = vals
    return out


def patch_header(header: str, cfg: Cfg, dtype: torch.dtype) -> str:
    """The core's header with its config struct replaced for each C of cfg."""
    line = CFG_LINE[dtype][1]
    for c, vals in cfg.items():
        struct = re.escape(line.split(" {")[0] % c) + r" \{[^\n]*"  # that C's whole line
        header, n = re.subn(struct, line % (c, *vals), header)
        if n != 1:
            raise ValueError(f"no config struct for C={c} to replace")
    return header


def patch_skip(text: str, name: str) -> str:
    """The source of SKIPS[name]'s file with that part left out."""
    _, old, new = SKIPS[name]
    if text.count(old) != 1:
        raise ValueError(f"--skip {name}: the source line to patch is not there once")
    return text.replace(old, new)


def use_variant(cfg: Cfg, dtype: torch.dtype, skip=()) -> None:
    """Point the build at a patched copy of the sources (cfg's config structs,
    the parts in skip left out) and mirror cfg in the wrappers."""
    tag = "_".join([f"{c}-" + "-".join(map(str, v)) for c, v in sorted(cfg.items())] + list(skip))
    root = os.path.join(build.BUILD_DIR, "variants", f"{dtype}_{tag}".replace("torch.", ""))
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, os.path.join(root, "csrc"))
    patches = [(CFG_LINE[dtype][0], lambda t: patch_header(t, cfg, dtype))] if cfg else []
    patches += [(SKIPS[name][0], lambda t, name=name: patch_skip(t, name)) for name in skip]
    for fname, fn in patches:
        path = os.path.join(root, "csrc", fname)
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(fn(text))
    build.CSRC_DIR, build.BUILD_DIR = os.path.join(root, "csrc"), os.path.join(root, "out")
    (rb.WG_CFG if dtype == torch.float32 else rb.WG_CFG_BF16).update(cfg)
    rb.unit_tile.cache_clear()
    ms.stage_tile.cache_clear()


def ptxas_summary(log: str):
    """(kernel, C, mangled type, registers, spill text or '') per instantiation in nvcc's output."""
    rows, key, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            key, spill = SYMBOL.search(m.group(1)), ""
        elif "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
            spill = line.strip()
        elif key and "registers" in line:
            rows.append((key.group(1), int(key.group(2)), key.group(3),
                         int(re.search(r"Used (\d+) registers", line).group(1)), spill))
            key = None
    return rows


def sass_histogram(lib_path: str, mangled: str, top: int = 14):
    """Most frequent opcodes per kernel instantiation of one storage type."""
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    hist, key = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = SYMBOL.search(line)
            key = (m.group(1), int(m.group(2))) if m and m.group(3) == mangled else None
            if key:
                hist[key] = collections.Counter()
        elif key:
            m = re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)?)", line)
            if m:
                hist[key][m.group(1)] += 1
    return {k: (sum(h.values()), {op: sum(n for o, n in h.items() if o.startswith(op))
                                  for op in ("HMMA", "HGMMA", "UTMALDG")}, h.most_common(top))
            for k, h in hist.items()}


def timed(fn, iters: int = 3) -> float:
    """Mean device ms per call (CUDA events), after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _unit_weights(gen, k, c, dtype, dev):
    std = (c * k) ** -0.5
    return tuple((torch.randn(*shape, generator=gen) * s).to(dev, dtype).contiguous()
                 for shape, s in (((k, c, c), std), ((c,), 0.05), ((k, c, c), std), ((c,), 0.05)))


def _oik(unit):
    """A unit's weights as F.conv1d takes them: (C_out, C_in, K), contiguous."""
    w1, b1, w2, b2 = unit
    return w1.permute(2, 1, 0).contiguous(), b1, w2.permute(2, 1, 0).contiguous(), b2


def _convs(x_ncw, unit_oik, d):
    """The two cuDNN convolutions of one residual unit (activations excluded)."""
    w1, b1, w2, b2 = unit_oik
    pad = (w1.shape[2] - 1) // 2
    return (F.conv1d(x_ncw, w1, b1, padding=pad * d, dilation=d),
            F.conv1d(x_ncw, w2, b2, padding=pad, dilation=1))


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def l2_weight_bytes(name: str, c: int, t: int, k: int = 0, d: int = 0, n_sm: int = 132,
                    dtype: torch.dtype = torch.float32) -> int:
    """Weight bytes the kernels' blocks stream from L2 in one call at batch
    BATCH, reckoned from the wrappers' tiles: every block reads each conv's
    K x C x C weights once per pass (the f32 tails are made in shared memory
    and stream nothing)."""
    item = dtype.itemsize
    if name == "unit":
        tile = rb.unit_tile(c, k, d, t, dtype, BATCH, n_sm)
        per_block = sum(-(-n // rb.pass_rows(c, dtype)) * k * c * c * item
                        for n in (tile + 2 * ((k - 1) // 2), tile))
    else:
        tile = ms.stage_tile(c, KS, DS, t, dtype, BATCH, n_sm)
        rows = ms.stage_convs(tile, KS, DS)
        taps = [k for k, dils in zip(KS, DS) for _ in dils for _ in (1, 2)]
        per_block = sum(-(-n // rb.pass_rows(c, dtype)) * k * c * c * item
                        for n, k in zip(rows, taps))
    return BATCH * -(-t // tile) * per_block


def parse_tiles(text: str) -> Dict[str, Tuple[int, ...]]:
    """'unit256:118,128;stage64:168,240' -> {'unit256': (118, 128), 'stage64': (168, 240)}."""
    out = {}
    for part in filter(None, text.split(";")):
        shape, vals = part.split(":")
        if shape not in ("unit256", "unit128", "stage64", "stage32"):
            raise ValueError(f"--tiles wants unit256, unit128, stage64 or stage32: {part!r}")
        out[shape] = tuple(int(v) for v in vals.split(","))
    return out


@contextlib.contextmanager
def forced_tile(name: str, tile):
    """The wrappers plan `tile` rows (None: their own planner's) inside."""
    mod, attr = (rb, "unit_tile") if name == "unit" else (ms, "stage_tile")
    planner = getattr(mod, attr)
    if tile is not None:
        setattr(mod, attr, lambda *a, **kw: tile)
    try:
        yield
    finally:
        setattr(mod, attr, planner)


def bench(dtype: torch.dtype, dname: str, only, check: bool, tiles=None) -> None:
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def rand(t, c):
        return (torch.randn(BATCH, t, c, generator=gen) * 0.5).to(dev, dtype)

    def report(name, c, label, fn, plain, lib, flop, t, relayout, l2):
        errs = [_rel_err(fn(x), plain(x)) for x in (rand(t, c), rand(t + 37, c))] if check else []
        x = rand(t, c)
        xn = x.transpose(1, 2).contiguous()
        ms, lib_ms = timed(lambda: fn(x)), timed(lambda: lib(xn))
        relayout_ms = timed(relayout) if dtype == torch.float32 else 0.0
        print(f"{name} {dname} C={c} {label} rel_err={['%.2e' % e for e in errs]} ms={ms:.3f} "
              f"(relayout {relayout_ms:.3f}) cudnn_ms={lib_ms:.3f} x_cudnn={ms / lib_ms:.2f} "
              f"TFLOP/s={flop / ms / 1e9:.1f}"
              + (f" L2_weight_GB={l2 / 1e9:.2f} ({l2 / ms / 1e9:.2f} TB/s at this ms)" if l2 else ""),
              flush=True)
        return ms, lib_ms, max(errs, default=0.0), relayout_ms

    for name, shapes in (("unit", UNIT_SHAPES), ("stage", STAGE_SHAPES)):
        total = [0.0, 0.0, 0.0, 0.0, 0]
        for c, t in shapes:
            if only and f"{name}{c}" not in only:
                continue
            if name == "unit":
                cases = []
                for k, dils in zip(KS, DS):
                    for d in dils:
                        w = _unit_weights(gen, k, c, dtype, dev)
                        wt = _oik(w)
                        tile = rb.unit_tile(c, k, d, t, dtype, BATCH, rb.sm_count(dev))
                        l2 = l2_weight_bytes(name, c, t, k, d, rb.sm_count(dev), dtype)
                        cases.append((
                            f"k={k} d={d} tile={tile}",
                            lambda x, w=w, k=k, d=d: rb.fused_residual_unit(x, *w, k, d),
                            lambda x, w=w, k=k, d=d: rb.residual_unit_plain(x, *w, k, d),
                            lambda xn, wt=wt, d=d: _convs(xn, wt, d),
                            4 * k * c * c * BATCH * t,
                            lambda w=w: rb.kmajor((w[0], w[2])), l2))
            else:
                ws = [[_unit_weights(gen, k, c, dtype, dev) for _ in dils] for k, dils in zip(KS, DS)]
                wts = [[_oik(u) for u in units] for units in ws]
                cases = [(
                    "V1 MRF",
                    lambda x, ws=ws: fused_mrf_stage(x, ws, KS, DS),
                    lambda x, ws=ws: mrf_stage_plain(x, ws, KS, DS),
                    lambda xn, wts=wts: [_convs(xn, u, d)
                                         for units, dils in zip(wts, DS) for u, d in zip(units, dils)],
                    sum(4 * k * c * c * len(dils) for k, dils in zip(KS, DS)) * BATCH * t,
                    lambda ws=ws: pack_stage_f32(ws),
                    l2_weight_bytes(name, c, t, n_sm=rb.sm_count(dev), dtype=dtype))]
            for tile in (tiles or {}).get(f"{name}{c}", (None,)):
                with forced_tile(name, tile):
                    for label, fn, plain, lib, flop, relayout, l2 in cases:
                        if tile is not None:
                            label, l2 = f"{label} forced tile={tile}", 0
                        ms_, lib_ms, err, rl_ms = report(name, c, label, fn, plain, lib, flop, t,
                                                         relayout, l2)
                        total = [total[0] + ms_, total[1] + lib_ms, max(total[2], err),
                                 total[3] + rl_ms, total[4] + l2]
        if total[0]:
            print(f"{name} {dname} total ms={total[0]:.2f} (relayout {total[3]:.3f}) "
                  f"cudnn_ms={total[1]:.2f} x_cudnn={total[0] / total[1]:.2f} "
                  f"worst_rel_err={total[2]:.2e}"
                  + (f" L2_weight_GB={total[4] / 1e9:.2f}" if total[4] else ""), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dtype", choices=sorted(DTYPES), default="f32")
    p.add_argument("--only", nargs="*", default=[], help="unit256 unit128 stage64 stage32")
    p.add_argument("--cfg", default="", help="variant of the config struct: f32 C:kMT,kKC,kStages, "
                   "bf16 C:kMT,kKC,kStages,kWait[;...]")
    p.add_argument("--tiles", default="", help="time these tiles instead of the planners': "
                   "unit256:118,128;stage64:168,240 (totals then sum every tile)")
    p.add_argument("--no-check", action="store_true", help="time only")
    p.add_argument("--sass", action="store_true", help="opcode histogram per instantiation")
    p.add_argument("--skip", nargs="*", default=[], choices=sorted(SKIPS),
                   help="bf16: leave out a part (timing only, wrong results)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_bench needs a CUDA card", file=sys.stderr)
        return 1
    dtype, type_name, mangled = DTYPES[args.dtype]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.skip and dtype != torch.bfloat16:
        p.error("--skip patches the bf16 kernels")
    if args.cfg or args.skip:
        use_variant(parse_cfg(args.cfg, dtype), dtype, args.skip)
        print(f"variant {args.cfg} of {CFG_LINE[dtype][0]}" + (
            f"; without {', '.join(args.skip)}: timing only, results not checked" if args.skip else ""))
    build.load()
    print(f"build {build.build_seconds:.1f} s")
    for line in build.build_log.splitlines():
        if "warning" in line.lower() or "wgmma" in line.lower():
            print(f"ptxas {line.strip()}")
    names = {m: n for n, m in (v[1:] for v in DTYPES.values())}
    for kernel, c, t, regs, spill in ptxas_summary(build.build_log):
        print(f"ptxas {kernel}<{c}, {names[t]}>: {regs} registers{'; ' + spill if spill else ''}")
    if args.sass:
        lib = os.path.join(build.BUILD_DIR, build.LIB_NAME)
        for (kernel, c), (n, counts, top) in sorted(sass_histogram(lib, mangled).items()):
            print(f"sass {kernel}<{c}, {type_name}>: {n} instructions, {counts}, {top}")
    bench(dtype, args.dtype, set(args.only), not (args.no_check or args.skip), parse_tiles(args.tiles))
    return 0


if __name__ == "__main__":
    sys.exit(main())
