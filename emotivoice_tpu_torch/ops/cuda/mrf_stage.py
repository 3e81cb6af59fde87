"""Fused HiFi-GAN MRF stage: CUDA kernel wrapper and its plain PyTorch
version.

Replaces the TPU kernel `emotivoice_tpu/ops/pallas/packed_stage.py`
(`fused_mrf_stage`) on plain (B, T, C) activations: the TPU's lane packing,
chunk plan and weight rolls are not carried over. The kernel is
`emotivoice_tpu_torch/csrc/mrf_stage.cu`; its header comment states what
bounds it on the H100 (operations: 252*C*C FLOP per row for the V1 stage)
and what its design does about that (all chains run on one tile in shared
memory; the tile is read once per chain and the chain sum kept in y; every
conv runs on the tensor cores with `wgmma`, weights by TMA through a
producer's `mbarrier` ring: bf16 through `csrc/wgmma_conv_bf16.cuh`, one map
per conv over its HIO weight as it is, f32 as a 3xTF32 split through
`csrc/wgmma_conv_f32.cuh`). For f32 the wrapper packs all the stage's conv
weights K-major into one buffer, (taps, C_out, C_in), in the order the
kernel runs them (`pack_stage_f32`).

`fused_mrf_stage` launches the kernel for a CUDA tensor and takes the plain
version for a CPU tensor; any other device, dtype or shape raises, and so
does an operand that requires grad while grad is enabled (no backward).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from emotivoice_tpu_torch.ops.cuda import build
from emotivoice_tpu_torch.ops.cuda.resblock import (
    CHANNELS,
    H100_SMS,
    WGMMA_ROWS,
    _cdiv,
    check_operands,
    kmajor,
    pass_rows,
    refuse_grad,
    residual_unit_3xtf32,
    residual_unit_plain,
    sm_count,
    tile_plan,
    wg_cfg,
)

MAX_TILE = {torch.float32: 1024, torch.bfloat16: 2048}
TILE_STEP = 8  # tiles are whole multiples of this many rows (TMA boxes)
MAX_CHAINS = 4  # kMaxChains in csrc/mrf_stage.cu
MAX_UNITS = 4  # kMaxUnits

# per chain: per unit: (w1_hio (K, C, C), b1 (C,), w2_hio (K, C, C), b2 (C,))
StageWeights = Sequence[Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]]


def mrf_stage_plain(x, weights: StageWeights, kernel_sizes, dilation_sizes) -> torch.Tensor:
    """Plain version: the ResBlock1 chains over the same x, summed, / n."""
    acc = None
    for k, dils, units in zip(kernel_sizes, dilation_sizes, weights):
        xk = x
        for d, (w1, b1, w2, b2) in zip(dils, units):
            xk = residual_unit_plain(xk, w1, b1, w2, b2, k, d)
        acc = xk if acc is None else acc + xk
    return acc / len(kernel_sizes)


def mrf_stage_3xtf32(x, weights: StageWeights, kernel_sizes, dilation_sizes) -> torch.Tensor:
    """mrf_stage_plain with every conv in the f32 kernel's arithmetic
    (residual_unit_3xtf32), for the CPU tests."""
    acc = None
    for k, dils, units in zip(kernel_sizes, dilation_sizes, weights):
        xk = x
        for d, (w1, b1, w2, b2) in zip(dils, units):
            xk = residual_unit_3xtf32(xk, w1, b1, w2, b2, k, d)
        acc = xk if acc is None else acc + xk
    return acc / len(kernel_sizes)


def stage_halo(kernel_sizes, dilation_sizes) -> int:
    """Largest per-side halo of a chain: sum over units of (k-1)/2*(d+1)."""
    return max(
        sum((k - 1) // 2 * (d + 1) for d in dils)
        for k, dils in zip(kernel_sizes, dilation_sizes)
    )


def stage_convs(tile: int, kernel_sizes, dilation_sizes):
    """Output rows of every conv of a tile, in the order the kernels run
    them: each chain's tile + 2 * its halo shrinks by one unit's reach per
    unit, conv1 by 2 * (k-1)/2 * d rows, conv2 by 2 * (k-1)/2."""
    rows = []
    for k, dils in zip(kernel_sizes, dilation_sizes):
        ext = tile + 2 * sum((k - 1) // 2 * (d + 1) for d in dils)
        for d in dils:
            h1, h2 = (k - 1) // 2 * d, (k - 1) // 2
            rows += [ext - 2 * h1, ext - 2 * h1 - 2 * h2]
            ext -= 2 * (h1 + h2)
    return rows


def stage_plan(c: int, halo: int, tile: int, dtype: torch.dtype):
    """`tile_plan` of the kernel at `tile`: chain activation and intermediate,
    tile + 2 * halo rows each. The chain sum stays in y, in device memory."""
    return tile_plan(c, tile + 2 * halo, 2, dtype)


@functools.lru_cache(maxsize=None)
def stage_tile(c: int, kernel_sizes: Tuple[int, ...], dilation_sizes: Tuple[Tuple[int, ...], ...],
               t: int, dtype: torch.dtype = torch.float32, batch: int = 1,
               n_sm: int = H100_SMS) -> int:
    """Time tile of the kernel, a multiple of TILE_STEP rows.

    Of the tiles up to MAX_TILE[dtype] (and T rounded up) that fit beside a
    ring of at least two stages, the one with the least waves * work: waves
    = ceil(blocks / n_sm), work = per conv (the k=11 chain's first, tile +
    110 rows, the largest) its m64 tiles plus one per pass for its weight
    stream.
    """
    if c not in CHANNELS:
        raise ValueError(f"no kernel for C={c}; C must be one of {CHANNELS}")
    if dtype not in MAX_TILE:
        raise TypeError(f"no kernel for {dtype}")
    halo = stage_halo(kernel_sizes, dilation_sizes)
    top = min(MAX_TILE[dtype], _cdiv(t, TILE_STEP) * TILE_STEP)
    best = best_cost = None
    for tile in range(TILE_STEP, top + 1, TILE_STEP):
        if not stage_plan(c, halo, tile, dtype)[2]:
            break
        waves = _cdiv(batch * _cdiv(t, tile), n_sm)
        work = sum(_cdiv(n, WGMMA_ROWS) + _cdiv(n, pass_rows(c, dtype))
                   for n in stage_convs(tile, kernel_sizes, dilation_sizes))
        if best_cost is None or waves * work <= best_cost:
            best, best_cost = tile, waves * work
    if best is None:
        raise ValueError(f"no time tile fits shared memory at C={c}, halo {halo}")
    return best


def pack_stage_f32(weights: StageWeights):
    """The f32 kernel's weights: every conv's HIO weight, chains and units in
    order and w1 before w2, as one K-major buffer (taps, C_out, C_in), with
    the first tap of each unit's w1 and w2."""
    flat, taps1, taps2, tap = [], [], [], 0
    for units in weights:
        for w1, _, w2, _ in units:
            taps1.append(tap)
            taps2.append(tap + w1.shape[0])
            tap += w1.shape[0] + w2.shape[0]
            flat += [w1, w2]
    return kmajor(flat), taps1, taps2


def fused_mrf_stage(x, weights: StageWeights, kernel_sizes: Sequence[int],
                    dilation_sizes: Sequence[Sequence[int]]) -> torch.Tensor:
    """One whole MRF stage on (B, T, C); weights in x's dtype, HIO layout.
    Refuses operands that require grad while grad is enabled."""
    refuse_grad("fused_mrf_stage", [x] + [t for units in weights for u in units for t in u])
    if x.device.type == "cpu":
        return mrf_stage_plain(x, weights, kernel_sizes, dilation_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mrf_stage: unsupported device {x.device}")
    n_chains = len(kernel_sizes)
    if not 1 <= n_chains <= MAX_CHAINS or len(weights) != n_chains or len(dilation_sizes) != n_chains:
        raise ValueError("fused_mrf_stage: 1-4 chains, one weight set per chain")
    bsz, t, c = x.shape
    ptrs, dils, n_units = [], [], []
    tensors, shapes = [], []
    for k, ds, units in zip(kernel_sizes, dilation_sizes, weights):
        if not 1 <= len(ds) <= MAX_UNITS or len(units) != len(ds):
            raise ValueError("fused_mrf_stage: 1-4 units per chain, one weight set per unit")
        n_units.append(len(ds))
        for d, unit in zip(ds, units):
            dils.append(int(d))
            for tns, shape in zip(unit, ((k, c, c), (c,), (k, c, c), (c,))):
                tensors.append(tns)
                shapes.append(shape)
                ptrs.append(tns.data_ptr())
    check_operands("fused_mrf_stage", x, tensors, shapes)
    tile = stage_tile(c, tuple(kernel_sizes), tuple(map(tuple, dilation_sizes)), t, x.dtype, bsz,
                      sm_count(x.device))
    box, n_box, stages, _ = stage_plan(c, stage_halo(kernel_sizes, dilation_sizes), tile, x.dtype)
    kmt, kc = wg_cfg(c, x.dtype)[:2]
    lib = build.load()
    i32 = ctypes.c_int
    with torch.cuda.device(x.device):  # as in fused_residual_unit
        y = torch.empty_like(x)
        stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
        ks = (i32 * n_chains)(*[int(k) for k in kernel_sizes])
        if x.dtype == torch.float32:
            w, taps1, taps2 = pack_stage_f32(weights)
            biases = [u[i].data_ptr() for units in weights for u in units for i in (1, 3)]
            err = lib.evt_mrf_stage_f32(
                x.data_ptr(), y.data_ptr(), w.data_ptr(), w.shape[0],
                (ctypes.c_void_p * len(biases))(*biases), (i32 * len(taps1))(*taps1),
                (i32 * len(taps2))(*taps2), ks, (i32 * n_chains)(*n_units),
                (i32 * len(dils))(*dils), n_chains, bsz, t, c, tile, box, n_box, stages,
                kmt, kc, stream)
        else:
            err = lib.evt_mrf_stage_bf16(
                x.data_ptr(), y.data_ptr(), (ctypes.c_void_p * len(ptrs))(*ptrs), ks,
                (i32 * n_chains)(*n_units), (i32 * len(dils))(*dils),
                n_chains, bsz, t, c, tile, box, n_box, stages, kmt, kc, stream)
        build.check(err, "fused_mrf_stage")
    build.count_launch(fused_mrf_stage)
    return y


fused_mrf_stage.launches = 0  # kernel launches since the last reset
