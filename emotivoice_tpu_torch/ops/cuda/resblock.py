"""Fused HiFi-GAN ResBlock1 residual unit: CUDA kernel wrapper and its plain
PyTorch version.

Replaces the TPU kernel `emotivoice_tpu/ops/pallas/resblock.py`
(`fused_residual_unit`). The kernel is `emotivoice_tpu_torch/csrc/resblock.cu`;
its header comment states what bounds it on the H100 (operations: hundreds
of FLOP per byte moved) and what its design does about that (the
intermediate stays in shared memory, x is read once and y written once).

`fused_residual_unit` launches the kernel for a CUDA tensor and takes the
plain version for a CPU tensor; any other device, dtype or shape raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from emotivoice_tpu_torch.ops.cuda import build

LRELU_SLOPE = 0.1
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on sm_90
ROWS_PER_PASS = 64  # kRowsPerPass in csrc/conv_tile.cuh
CI_CHUNK = 16  # kCiChunk in csrc/conv_tile.cuh
MAX_PASSES = 8


def lrelu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def conv_same(a: torch.Tensor, w_hio: torch.Tensor, bias: torch.Tensor,
              dilation: int) -> torch.Tensor:
    """'Same' zero-padded conv over (B, T, Ci) with an HIO (K, Ci, Co)
    weight; bias added after the conv in the activation dtype."""
    k = w_hio.shape[0]
    y = F.conv1d(a.transpose(1, 2), w_hio.permute(2, 1, 0),
                 padding=(k - 1) // 2 * dilation, dilation=dilation)
    return y.transpose(1, 2) + bias


def residual_unit_plain(x, w1, b1, w2, b2, k: int, d: int) -> torch.Tensor:
    """Plain version: x + conv_{k,1}(lrelu(conv_{k,d}(lrelu(x)) + b1)) + b2."""
    xt = conv_same(lrelu(x), w1, b1, d)
    xt = conv_same(lrelu(xt), w2, b2, 1)
    return x + xt


def unit_tile(c: int, k: int, d: int, t: int) -> int:
    """Time tile of the kernel: conv1 covers tile + 2*(k-1)/2 rows, a whole
    number of 64-row passes, within the shared-memory limit."""
    h1, h2 = (k - 1) // 2 * d, (k - 1) // 2
    best = None
    max_p = min(MAX_PASSES, -(-(t + 2 * h2) // ROWS_PER_PASS))
    for p in range(1, max(1, max_p) + 1):
        tile = ROWS_PER_PASS * p - 2 * h2
        smem = 4 * c * ((tile + 2 * (h1 + h2)) + (tile + 2 * h2) + CI_CHUNK)
        if tile > 0 and smem <= SMEM_LIMIT:
            best = tile
    if best is None:
        raise ValueError(f"no time tile fits shared memory at C={c} k={k} d={d}")
    return best


def check_operands(name: str, x: torch.Tensor, tensors, shapes) -> None:
    """Device, dtype, shape and contiguity checks shared by the wrappers."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or x.shape[2] % 32 or x.shape[2] > 256:
        raise ValueError(
            f"{name}: x must be (B, T, C) with C a multiple of 32 up to 256, "
            f"got {tuple(x.shape)}")
    for t, shape in zip((x, *tensors), (tuple(x.shape), *shapes)):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name}: operands must share x's device and dtype")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def fused_residual_unit(x, w1, b1, w2, b2, k: int, d: int) -> torch.Tensor:
    """One ResBlock1 residual unit on (B, T, C); w1, w2 HIO (K, C, C) with
    weight norm folded, b1, b2 (C,), all in x's dtype."""
    if x.device.type == "cpu":
        return residual_unit_plain(x, w1, b1, w2, b2, k, d)
    if x.device.type != "cuda":
        raise ValueError(f"fused_residual_unit: unsupported device {x.device}")
    bsz, t, c = x.shape
    check_operands("fused_residual_unit", x, (w1, b1, w2, b2),
                   ((k, c, c), (c,), (k, c, c), (c,)))
    tile = unit_tile(c, k, d, t)
    lib = build.load()
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.evt_residual_unit(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        y.data_ptr(), bsz, t, c, k, d, tile, int(x.dtype == torch.bfloat16),
        ctypes.c_void_p(stream),
    )
    build.check(err, "fused_residual_unit")
    fused_residual_unit.launches += 1
    return y


fused_residual_unit.launches = 0  # kernel launches since the last reset
