"""Fused HiFi-GAN MRF stage: CUDA kernel wrapper and its plain PyTorch
version.

Replaces the TPU kernel `emotivoice_tpu/ops/pallas/packed_stage.py`
(`fused_mrf_stage`) on plain (B, T, C) activations: the TPU's lane packing,
chunk plan and weight rolls are not carried over. The kernel is
`emotivoice_tpu_torch/csrc/mrf_stage.cu`; its header comment states what
bounds it on the H100 (operations: 252*C*C FLOP per row for the V1 stage)
and what its design does about that (all chains run on one tile in shared
memory; the tile is read once per chain and written once; every conv runs on
the tensor cores: bf16 through `csrc/mma_conv.cuh`, f32 as a 3xTF32 split
through `csrc/mma_conv_f32.cuh`).

`fused_mrf_stage` launches the kernel for a CUDA tensor and takes the plain
version for a CPU tensor; any other device, dtype or shape raises, and so
does an operand that requires grad while grad is enabled (no backward).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from emotivoice_tpu_torch.ops.cuda import build
from emotivoice_tpu_torch.ops.cuda.resblock import (
    CHANNELS,
    SMEM_LIMIT,
    check_operands,
    refuse_grad,
    residual_unit_3xtf32,
    residual_unit_plain,
    ring_rows,
    weight_smem,
)

MAX_TILE = {torch.float32: 512, torch.bfloat16: 768}
TILE_STEP = 64  # tiles are whole multiples of this many rows (4 m16 tiles)
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


def stage_smem(c: int, halo: int, tile: int, dtype: torch.dtype) -> int:
    """Shared memory of one block: chain activation and intermediate (x's
    dtype, haloed), f32 accumulator, weights."""
    return dtype.itemsize * c * 2 * (tile + 2 * halo) + 4 * c * tile + weight_smem(c, dtype)


def stage_tile(c: int, halo: int, t: int, dtype: torch.dtype = torch.float32) -> int:
    """Largest multiple of TILE_STEP rows (at most MAX_TILE[dtype], at most
    T rounded up) whose tiles and weights fit in shared memory. At the V1
    topology every conv of such a tile is one pass of the core's rows."""
    if c not in CHANNELS:
        raise ValueError(f"no kernel for C={c}; C must be one of {CHANNELS}")
    if dtype not in MAX_TILE:
        raise TypeError(f"no kernel for {dtype}")
    tile = min(MAX_TILE[dtype], -(-t // TILE_STEP) * TILE_STEP)
    while tile > 0:
        if stage_smem(c, halo, tile, dtype) <= SMEM_LIMIT:
            return tile
        tile -= TILE_STEP
    raise ValueError(f"no time tile fits shared memory at C={c}, halo {halo}")


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
    tile = stage_tile(c, stage_halo(kernel_sizes, dilation_sizes), t, x.dtype)
    lib = build.load()
    i32 = ctypes.c_int
    with torch.cuda.device(x.device):  # as in fused_residual_unit
        y = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.evt_mrf_stage(
            x.data_ptr(), y.data_ptr(),
            (ctypes.c_void_p * len(ptrs))(*ptrs),
            (i32 * n_chains)(*[int(k) for k in kernel_sizes]),
            (i32 * n_chains)(*n_units),
            (i32 * len(dils))(*dils),
            n_chains, bsz, t, c, tile, ring_rows(c, x.dtype), int(x.dtype == torch.bfloat16),
            ctypes.c_void_p(stream),
        )
        build.check(err, "fused_mrf_stage")
    build.count_launch(fused_mrf_stage)
    return y


fused_mrf_stage.launches = 0  # kernel launches since the last reset
