"""Fused HiFi-GAN ResBlock1 residual unit: CUDA kernel wrapper and its plain
PyTorch version.

Replaces the TPU kernel `emotivoice_tpu/ops/pallas/resblock.py`
(`fused_residual_unit`). The kernel is `emotivoice_tpu_torch/csrc/resblock.cu`;
its header comment states what bounds it on the H100 (operations: hundreds
of FLOP per byte moved) and what its design does about that (the
intermediate stays in shared memory, x is read once and y written once; both
convs run on the tensor cores: bf16 through `csrc/mma_conv.cuh`, f32 as a
3xTF32 split through `csrc/mma_conv_f32.cuh`).

`fused_residual_unit` launches the kernel for a CUDA tensor and takes the
plain version for a CPU tensor; any other device, dtype or shape raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from emotivoice_tpu_torch.ops.cuda import build

LRELU_SLOPE = 0.1
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on sm_90
CHANNELS = (32, 64, 128, 256)  # C the kernels are instantiated for
# the tensor-core conv cores: csrc/mma_conv.cuh (bf16), csrc/mma_conv_f32.cuh (f32)
WARPS = 8  # kWarps
MMA_ROWS = 16  # rows of one mma.sync m16 tile
# MmaCfg<C, T> as (kWN, kNT, kMT, kKC, kStages): warps across C_out, n8 tiles and
# m16 tiles per warp, weight rows (tap x C_in) per ring stage, ring depth
MMA_CFG = {
    torch.bfloat16: {
        32: (1, 4, 8, 128, 2),
        64: (1, 8, 4, 128, 2),
        128: (2, 8, 4, 128, 2),
        256: (4, 8, 4, 64, 2),
    },
    torch.float32: {
        32: (1, 4, 5, 32, 3),
        64: (1, 8, 3, 32, 2),
        128: (2, 8, 4, 16, 3),
        256: (4, 8, 4, 16, 2),
    },
}
RING_PAD = {torch.bfloat16: 0, torch.float32: 8}  # MmaTile<C, T>::kLd - C, values per ring row
# Fewest rows of a tile: each weight byte a block streams from L2 serves that
# many rows, and below them L2 becomes the limit. f32 rows are twice as wide,
# so fewer fit beside the ring.
MMA_MIN_ROWS = {
    torch.bfloat16: {32: 64, 64: 64, 128: 128, 256: 64},
    torch.float32: {32: 64, 64: 64, 128: 96, 256: 48},
}
H100_SMS = 132  # streaming multiprocessors of an H100 SXM


def lrelu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    """max(x, x * slope) with the slope in x's dtype: in bf16 that is
    JAX's rounding (slope bf16(0.1), one rounding of the product), which the
    kernels' bf16 path reproduces; in f32 it equals F.leaky_relu."""
    return torch.maximum(x, x * torch.tensor(slope, dtype=x.dtype))


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


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10-bit mantissa), nearest with ties away
    from zero, as the f32 kernels' split_tf32 (csrc/mma_conv_f32.cuh) does:
    half a TF32 ulp added to the magnitude bits, the low 13 bits dropped."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def conv_same_3xtf32(a, w_hio, bias, dilation: int, terms: int = 3) -> torch.Tensor:
    """conv_same in the f32 kernels' arithmetic, for the CPU tests: both
    operands split into a TF32 head and tail, the conv taken as
    tail*head + head*tail + head*head with f32 sums (tail*tail dropped).
    terms=1 keeps head*head alone: one TF32 product per f32 product."""
    a_head, w_head = tf32_round(a), tf32_round(w_hio)
    zero = torch.zeros_like(bias)
    y = conv_same(a_head, w_head, zero, dilation)
    if terms == 3:
        a_tail, w_tail = tf32_round(a - a_head), tf32_round(w_hio - w_head)
        y = (conv_same(a_tail, w_head, zero, dilation)
             + conv_same(a_head, w_tail, zero, dilation)) + y
    return y + bias


def residual_unit_3xtf32(x, w1, b1, w2, b2, k: int, d: int) -> torch.Tensor:
    """residual_unit_plain with both convs in the f32 kernels' arithmetic."""
    xt = conv_same_3xtf32(lrelu(x), w1, b1, d)
    xt = conv_same_3xtf32(lrelu(xt), w2, b2, 1)
    return x + xt


def ring_rows(c: int, dtype: torch.dtype) -> int:
    """Weight rows per ring stage passed to the kernel (`kc`)."""
    return MMA_CFG[dtype][c][3]


def weight_smem(c: int, dtype: torch.dtype) -> int:
    """Bytes of shared memory the cp.async weight ring takes."""
    _, _, _, kc, stages = MMA_CFG[dtype][c]
    return stages * kc * (c + RING_PAD[dtype]) * dtype.itemsize


def pass_rows(c: int, dtype: torch.dtype) -> int:
    """Output rows one pass of the kernel's conv loop covers."""
    wn, _, mt, _, _ = MMA_CFG[dtype][c]
    return WARPS // wn * mt * MMA_ROWS


def unit_smem(c: int, k: int, d: int, tile: int, dtype: torch.dtype) -> int:
    """Shared memory of one block: haloed x tile, intermediate, weights."""
    h1, h2 = (k - 1) // 2 * d, (k - 1) // 2
    rows = (tile + 2 * (h1 + h2)) + (tile + 2 * h2)
    return dtype.itemsize * c * rows + weight_smem(c, dtype)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def unit_tile(c: int, k: int, d: int, t: int, dtype: torch.dtype = torch.float32,
              batch: int = 1, n_sm: int = H100_SMS) -> int:
    """Time tile of the kernel, within the shared-memory limit.

    conv1 covers at most one pass of the tensor-core core, the tile has at
    least MMA_MIN_ROWS[dtype][c] rows (fewer only where the pass is shorter),
    and the tile or conv1's rows are a whole number of m16 tiles. Of those,
    the tile with the least waves * work: waves = ceil(blocks / n_sm), work =
    the m16 tiles per warp of both convs plus one per conv for its weight
    stream.
    """
    if c not in CHANNELS:
        raise ValueError(f"no kernel for C={c}; C must be one of {CHANNELS}")
    if dtype not in MMA_CFG:
        raise TypeError(f"no kernel for {dtype}")
    h2 = (k - 1) // 2
    warps_m = WARPS // MMA_CFG[dtype][c][0]
    rows = pass_rows(c, dtype)
    hi = rows - 2 * h2
    lo = min(MMA_MIN_ROWS[dtype][c], hi)
    cands = {m * MMA_ROWS for m in range(1, rows // MMA_ROWS + 1)}
    cands |= {m * MMA_ROWS - 2 * h2 for m in range(1, rows // MMA_ROWS + 1)}
    best = best_cost = None
    for tile in sorted(x for x in cands if lo <= x <= hi):
        if unit_smem(c, k, d, tile, dtype) > SMEM_LIMIT:
            break
        waves = _cdiv(batch * _cdiv(t, tile), n_sm)
        work = sum(_cdiv(_cdiv(n, MMA_ROWS), warps_m) + 1 for n in (tile + 2 * h2, tile))
        if best_cost is None or waves * work <= best_cost:
            best, best_cost = tile, waves * work
    if best is None:
        raise ValueError(f"no time tile fits shared memory at C={c} k={k} d={d}")
    return best


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card, which unit_tile fills in waves."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_operands(name: str, x: torch.Tensor, tensors, shapes) -> None:
    """Device, dtype, shape and contiguity checks shared by the wrappers."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or x.shape[2] not in CHANNELS:
        raise ValueError(
            f"{name}: x must be (B, T, C) with C one of {CHANNELS}, got {tuple(x.shape)}")
    for t, shape in zip((x, *tensors), (tuple(x.shape), *shapes)):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name}: operands must share x's device and dtype")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")


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
    tile = unit_tile(c, k, d, t, x.dtype, bsz, sm_count(x.device))
    lib = build.load()
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.evt_residual_unit(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        y.data_ptr(), bsz, t, c, k, d, tile, ring_rows(c, x.dtype),
        int(x.dtype == torch.bfloat16), ctypes.c_void_p(stream),
    )
    build.check(err, "fused_residual_unit")
    fused_residual_unit.launches += 1
    return y


fused_residual_unit.launches = 0  # kernel launches since the last reset
