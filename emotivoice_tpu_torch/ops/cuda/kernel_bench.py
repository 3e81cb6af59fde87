"""Build, check and time the two MRF kernels alone on the card.

  python -m emotivoice_tpu_torch.ops.cuda.kernel_bench [--dtype f32] [--only unit256 stage64]
      [--cfg "256:4,8,4,8,3;64:2,4,5,32,2"] [--no-check] [--sass]

The short call to make after a change to a kernel, before the full
`chip_smoke.py`: it builds the library, prints `ptxas -v` registers and
spills per instantiation, holds each kernel against its plain version at the
bench bucket's shapes (batch 16, 384 mel frames; T and T + 37) and times it
beside the cuDNN convolutions of the same function (TF32 off), per shape and
summed per generator call. `--cfg` times a variant of the tiling instead:
`C:kWN,kNT,kMT,kKC,kStages` replaces `MmaCfg<C, T>` of `--dtype` in a copy
of the sources (under build/torch_kernels/variants/) and in the wrappers'
mirror `MMA_CFG`, so two configurations can be compared within one call on
one card. `--sass` adds the most frequent SASS opcodes of each instantiation
of `--dtype`. Needs a CUDA card and nvcc; prints the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import collections
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
from emotivoice_tpu_torch.ops.cuda.mrf_stage import fused_mrf_stage, mrf_stage_plain

BATCH, FRAMES = 16, 384  # the bench bucket
KS, DS = (3, 7, 11), ((1, 3, 5),) * 3  # HiFi-GAN V1 MRF
UNIT_SHAPES = ((256, 8 * FRAMES), (128, 64 * FRAMES))  # (C, T) of stages 1-2
STAGE_SHAPES = ((64, 128 * FRAMES), (32, 256 * FRAMES))  # stages 3-4
DTYPES = {"f32": (torch.float32, "float", "f"), "bf16": (torch.bfloat16, "bf16", "13__nv_bfloat16")}
CFG_LINE = ("template <> struct MmaCfg<%d, %s> { static constexpr int kWN = %d, kNT = %d, "
            "kMT = %d, kKC = %d, kStages = %d; };")
SYMBOL = re.compile(r"(residual_unit_kernel|mrf_stage_kernel)ILi(\d+)E(13__nv_bfloat16|f)E")

Cfg = Dict[int, Tuple[int, int, int, int, int]]


def parse_cfg(text: str) -> Cfg:
    """'256:4,8,4,8,3;64:2,4,5,32,2' -> {256: (4, 8, 4, 8, 3), 64: (2, 4, 5, 32, 2)}."""
    out = {}
    for part in filter(None, text.split(";")):
        c, vals = part.split(":")
        vals = tuple(int(v) for v in vals.split(","))
        if int(c) not in rb.CHANNELS or len(vals) != 5:
            raise ValueError(f"--cfg wants C:kWN,kNT,kMT,kKC,kStages with C in {rb.CHANNELS}: {part!r}")
        out[int(c)] = vals
    return out


def patch_header(header: str, cfg: Cfg, type_name: str) -> str:
    """The conv core's header with MmaCfg<C, type_name> replaced for each C of cfg."""
    for c, vals in cfg.items():
        header, n = re.subn(r"template <> struct MmaCfg<%d, %s> \{[^\n]*" % (c, type_name),
                            CFG_LINE % (c, type_name, *vals), header)
        if n != 1:
            raise ValueError(f"no MmaCfg<{c}, {type_name}> line to replace")
    return header


def use_variant(cfg: Cfg, dtype: torch.dtype, type_name: str) -> None:
    """Point the build at a patched copy of the sources and mirror cfg in MMA_CFG."""
    tag = "_".join(f"{c}-" + "-".join(map(str, v)) for c, v in sorted(cfg.items()))
    root = os.path.join(build.BUILD_DIR, "variants", f"{type_name}_{tag}")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, os.path.join(root, "csrc"))
    name = "mma_conv_f32.cuh" if dtype == torch.float32 else "mma_conv.cuh"
    path = os.path.join(root, "csrc", name)
    with open(path) as f:
        header = f.read()
    with open(path, "w") as f:
        f.write(patch_header(header, cfg, type_name))
    build.CSRC_DIR, build.BUILD_DIR = os.path.join(root, "csrc"), os.path.join(root, "out")
    rb.MMA_CFG[dtype].update(cfg)
    rb.unit_tile.cache_clear()


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
    return {k: (sum(h.values()), h.most_common(top)) for k, h in hist.items()}


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


def bench(dtype: torch.dtype, dname: str, only, check: bool) -> None:
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def rand(t, c):
        return (torch.randn(BATCH, t, c, generator=gen) * 0.5).to(dev, dtype)

    def report(name, c, label, fn, plain, lib, flop, t):
        errs = [_rel_err(fn(x), plain(x)) for x in (rand(t, c), rand(t + 37, c))] if check else []
        x = rand(t, c)
        xn = x.transpose(1, 2).contiguous()
        ms, lib_ms = timed(lambda: fn(x)), timed(lambda: lib(xn))
        print(f"{name} {dname} C={c} {label} rel_err={['%.2e' % e for e in errs]} ms={ms:.3f} "
              f"cudnn_ms={lib_ms:.3f} x_cudnn={ms / lib_ms:.2f} TFLOP/s={flop / ms / 1e9:.1f}", flush=True)
        return ms, lib_ms, max(errs, default=0.0)

    for name, shapes in (("unit", UNIT_SHAPES), ("stage", STAGE_SHAPES)):
        total = [0.0, 0.0, 0.0]
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
                        cases.append((
                            f"k={k} d={d} tile={tile}",
                            lambda x, w=w, k=k, d=d: rb.fused_residual_unit(x, *w, k, d),
                            lambda x, w=w, k=k, d=d: rb.residual_unit_plain(x, *w, k, d),
                            lambda xn, wt=wt, d=d: _convs(xn, wt, d),
                            4 * k * c * c * BATCH * t))
            else:
                ws = [[_unit_weights(gen, k, c, dtype, dev) for _ in dils] for k, dils in zip(KS, DS)]
                wts = [[_oik(u) for u in units] for units in ws]
                cases = [(
                    "V1 MRF",
                    lambda x, ws=ws: fused_mrf_stage(x, ws, KS, DS),
                    lambda x, ws=ws: mrf_stage_plain(x, ws, KS, DS),
                    lambda xn, wts=wts: [_convs(xn, u, d)
                                         for units, dils in zip(wts, DS) for u, d in zip(units, dils)],
                    sum(4 * k * c * c * len(dils) for k, dils in zip(KS, DS)) * BATCH * t)]
            for label, fn, plain, lib, flop in cases:
                ms, lib_ms, err = report(name, c, label, fn, plain, lib, flop, t)
                total = [total[0] + ms, total[1] + lib_ms, max(total[2], err)]
        if total[0]:
            print(f"{name} {dname} total ms={total[0]:.2f} cudnn_ms={total[1]:.2f} "
                  f"x_cudnn={total[0] / total[1]:.2f} worst_rel_err={total[2]:.2e}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dtype", choices=sorted(DTYPES), default="f32")
    p.add_argument("--only", nargs="*", default=[], help="unit256 unit128 stage64 stage32")
    p.add_argument("--cfg", default="", help="variant of MmaCfg<C, T>: C:kWN,kNT,kMT,kKC,kStages[;...]")
    p.add_argument("--no-check", action="store_true", help="time only")
    p.add_argument("--sass", action="store_true", help="opcode histogram per instantiation")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_bench needs a CUDA card", file=sys.stderr)
        return 1
    dtype, type_name, mangled = DTYPES[args.dtype]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.cfg:
        use_variant(parse_cfg(args.cfg), dtype, type_name)
        print(f"variant {args.cfg} of MmaCfg<C, {type_name}>")
    build.load()
    print(f"build {build.build_seconds:.1f} s")
    for kernel, c, t, regs, spill in ptxas_summary(build.build_log):
        if t == mangled:
            print(f"ptxas {kernel}<{c}, {type_name}>: {regs} registers{'; ' + spill if spill else ''}")
    if args.sass:
        lib = os.path.join(build.BUILD_DIR, build.LIB_NAME)
        for (kernel, c), (n, top) in sorted(sass_histogram(lib, mangled).items()):
            print(f"sass {kernel}<{c}, {type_name}>: {n} instructions, {top}")
    bench(dtype, args.dtype, set(args.only), not args.no_check)
    return 0


if __name__ == "__main__":
    sys.exit(main())
