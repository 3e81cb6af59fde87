"""Fused HiFi-GAN ResBlock1 residual unit: CUDA kernel wrapper and its plain
PyTorch version.

Replaces the TPU kernel `emotivoice_tpu/ops/pallas/resblock.py`
(`fused_residual_unit`). The kernel is `emotivoice_tpu_torch/csrc/resblock.cu`;
its header comment states what bounds it on the H100 (operations: hundreds
of FLOP per byte moved) and what its design does about that (the
intermediate stays in shared memory, x is read once and y written once; both
convs run on the tensor cores with `wgmma`, weights by TMA through a
producer's `mbarrier` ring: bf16 through `csrc/wgmma_conv_bf16.cuh`, which
reads the HIO weights MN-major as they are, f32 as a 3xTF32 split through
`csrc/wgmma_conv_f32.cuh`). For f32 the wrapper hands the kernel both convs'
weights K-major in one buffer, (2K, C_out, C_in): `wgmma` reads tf32 B only
K-major. The wrapper plans the time tile in whole 64-row `wgmma` tiles
against the card's waves (`unit_tile`) and the TMA boxes and ring stages
beside it (`unit_plan`).

`fused_residual_unit` launches the kernel for a CUDA tensor and takes the
plain version for a CPU tensor; any other device, dtype or shape raises, and
so does an operand that requires grad while grad is enabled (no backward).
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
# The wgmma cores' tilings, as (kMT, kKC, kStages, ...): m64 tiles per consumer
# warpgroup and pass, input channels per ring stage, deepest ring a launch takes.
# f32: WgCfg<C> of csrc/wgmma_conv_f32.cuh
WG_CFG = {
    32: (2, 32, 6),
    64: (2, 32, 4),
    128: (1, 32, 4),
    256: (1, 8, 4),
}
# bf16: WgCfgBf16<C> of csrc/wgmma_conv_bf16.cuh, also kWait (wgmma groups left
# in flight at each ring stage)
WG_CFG_BF16 = {
    32: (6, 32, 8, 0),
    64: (2, 64, 6, 1),
    128: (1, 64, 4, 1),
    256: (1, 32, 4, 1),
}
WG_CONSUMERS = 2  # kConsumerWGs
WGMMA_ROWS = 64  # rows of one wgmma m64 tile
BOX_ROWS = 256  # most rows of one TMA box
# most passes of the core over conv1's rows in a unit tile (as timed: PERF.md)
UNIT_PASSES = {torch.float32: 1, torch.bfloat16: 3}
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
    from zero, as the f32 core's split_tf32 (csrc/wgmma_conv_f32.cuh) rounds
    the activations: half a TF32 ulp added to the magnitude bits, the low 13
    bits dropped."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(v: torch.Tensor) -> torch.Tensor:
    """f32 values truncated to TF32: what the tensor cores read of a raw f32
    operand, the f32 core's weight head."""
    return (v.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def weight_split(w: torch.Tensor):
    """The f32 core's weights as the tensor cores read them: head the raw
    tile truncated to TF32, tail w - head rounded to TF32 (made in shared
    memory beside each ring stage, `weight_tail`). head + tail = w within
    2**-22 |w|."""
    head = tf32_trunc(w)
    return head, tf32_round(w - head)


def conv_same_3xtf32(a, w_hio, bias, dilation: int, terms: int = 3) -> torch.Tensor:
    """conv_same in the f32 kernels' arithmetic, for the CPU tests: the
    activation split into a TF32 head and tail (`tf32_round`), the weight as
    `weight_split`, the conv taken as tail*head + head*tail + head*head with
    f32 sums (tail*tail dropped). terms=1 keeps head*head alone: one TF32
    product per f32 product."""
    a_head = tf32_round(a)
    w_head, w_tail = weight_split(w_hio)
    zero = torch.zeros_like(bias)
    y = conv_same(a_head, w_head, zero, dilation)
    if terms == 3:
        a_tail = tf32_round(a - a_head)
        y = (conv_same(a_tail, w_head, zero, dilation)
             + conv_same(a_head, w_tail, zero, dilation)) + y
    return y + bias


def residual_unit_3xtf32(x, w1, b1, w2, b2, k: int, d: int) -> torch.Tensor:
    """residual_unit_plain with both convs in the f32 kernels' arithmetic."""
    xt = conv_same_3xtf32(lrelu(x), w1, b1, d)
    xt = conv_same_3xtf32(lrelu(xt), w2, b2, 1)
    return x + xt


def kmajor(weights) -> torch.Tensor:
    """HIO weights (K_i, C_in, C_out), one after another, as the f32 kernels'
    one K-major buffer (sum K_i, C_out, C_in): two launches on the card
    whatever the count (a cat, then one transposing copy)."""
    return torch.cat(list(weights)).transpose(1, 2).contiguous()


def wg_cfg(c: int, dtype: torch.dtype):
    """The tiling of the core that runs `dtype` at C = c."""
    return WG_CFG[c] if dtype == torch.float32 else WG_CFG_BF16[c]


def pass_rows(c: int, dtype: torch.dtype) -> int:
    """Output rows one pass of the kernel's conv loop covers."""
    return WG_CONSUMERS * wg_cfg(c, dtype)[0] * WGMMA_ROWS


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def act_boxes(rows: int):
    """(box_rows, n_box): TMA boxes of at most BOX_ROWS rows, a multiple of 8,
    that cover an activation tile of `rows` rows."""
    n_box = _cdiv(rows, BOX_ROWS)
    return _cdiv(_cdiv(rows, n_box), 8) * 8, n_box


def stage_bytes(c: int, dtype: torch.dtype) -> int:
    """Shared memory of one ring stage: f32 head and tail tiles and 3
    mbarriers (full, ready, empty); bf16 one tile and 2 (full, empty)."""
    kc = wg_cfg(c, dtype)[1]
    if dtype == torch.float32:
        return 2 * c * kc * 4 + 24
    return c * kc * 2 + 16


def ring_stages(c: int, other: int, dtype: torch.dtype) -> int:
    """Most ring stages (at most kStages) beside `other` bytes of shared
    memory; 0 where fewer than two fit."""
    n = min(wg_cfg(c, dtype)[2], (SMEM_LIMIT - other) // stage_bytes(c, dtype))
    return n if n >= 2 else 0


def tile_plan(c: int, rows: int, n_tiles: int, dtype: torch.dtype):
    """(box_rows, n_box, stages, smem bytes) of a kernel that holds `n_tiles`
    activation tiles of `rows` rows (in whole boxes), 1 KB of alignment
    slack, x's mbarrier and the ring."""
    box, n_box = act_boxes(rows)
    other = 1024 + n_tiles * c * dtype.itemsize * box * n_box + 8
    stages = ring_stages(c, other, dtype)
    return box, n_box, stages, other + stages * stage_bytes(c, dtype)


def unit_plan(c: int, k: int, d: int, tile: int, dtype: torch.dtype):
    """`tile_plan` of the kernel at `tile`: one x tile of tile + 2 * (h1 + h2)
    rows, reused for the intermediate."""
    h1, h2 = (k - 1) // 2 * d, (k - 1) // 2
    return tile_plan(c, tile + 2 * (h1 + h2), 1, dtype)


def _unit_cands(c: int, k: int, dtype: torch.dtype):
    """Tiles the planner weighs: the tile or conv1's rows (tile + 2 * h2)
    whole m64 tiles, conv1 in at most UNIT_PASSES[dtype] passes of the core.
    f32 keeps conv1 in one pass (two, at 128 rows for 3 waves instead of 4 at
    C=256, were slower in every case timed); bf16 rows are half as wide, and
    its tiles take up to three (the nine C=128 launches of a generator call
    took 4.31 ms at 374-row tiles against 4.57 at 246 rows and 4.77 at 510 on
    an H100, which the waves * work count ranks alike: PERF.md)."""
    h2 = (k - 1) // 2
    hi = UNIT_PASSES[dtype] * pass_rows(c, dtype) - 2 * h2
    cands = {m * WGMMA_ROWS for m in range(1, hi // WGMMA_ROWS + 2)}
    cands |= {m * WGMMA_ROWS - 2 * h2 for m in range(1, hi // WGMMA_ROWS + 2)}
    return sorted(x for x in cands if 1 <= x <= hi)


@functools.lru_cache(maxsize=None)
def unit_tile(c: int, k: int, d: int, t: int, dtype: torch.dtype = torch.float32,
              batch: int = 1, n_sm: int = H100_SMS) -> int:
    """Time tile of the kernel, within the shared-memory limit.

    Of the candidates (`_unit_cands`) that fit beside a ring of at least
    two stages, the tile with the least waves * work: waves =
    ceil(blocks / n_sm), work = per conv, the m64 tiles the block runs, plus
    one per pass for its weight stream.
    """
    if c not in CHANNELS:
        raise ValueError(f"no kernel for C={c}; C must be one of {CHANNELS}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"no kernel for {dtype}")
    h2 = (k - 1) // 2
    best = best_cost = None
    for tile in _unit_cands(c, k, dtype):
        if not unit_plan(c, k, d, tile, dtype)[2]:
            break
        waves = _cdiv(batch * _cdiv(t, tile), n_sm)
        work = sum(_cdiv(n, WGMMA_ROWS) + _cdiv(n, pass_rows(c, dtype))
                   for n in (tile + 2 * h2, tile))
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


def refuse_grad(name: str, tensors) -> None:
    """The kernels have no backward (nor have the TPU kernels they replace):
    with grad enabled, an operand that requires grad is an error on every
    device, never an output silently cut from the graph. Training runs the
    differentiable plain convs (`HiFiGANGenerator(kernels=False)`)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad() or "
            "torch.inference_mode(), or build the generator with kernels=False")


def fused_residual_unit(x, w1, b1, w2, b2, k: int, d: int) -> torch.Tensor:
    """One ResBlock1 residual unit on (B, T, C); w1, w2 HIO (K, C, C) with
    weight norm folded, b1, b2 (C,), all in x's dtype. Refuses operands
    that require grad while grad is enabled (`refuse_grad`)."""
    refuse_grad("fused_residual_unit", (x, w1, b1, w2, b2))
    if x.device.type == "cpu":
        return residual_unit_plain(x, w1, b1, w2, b2, k, d)
    if x.device.type != "cuda":
        raise ValueError(f"fused_residual_unit: unsupported device {x.device}")
    bsz, t, c = x.shape
    check_operands("fused_residual_unit", x, (w1, b1, w2, b2),
                   ((k, c, c), (c,), (k, c, c), (c,)))
    tile = unit_tile(c, k, d, t, x.dtype, bsz, sm_count(x.device))
    box, n_box, stages, _ = unit_plan(c, k, d, tile, x.dtype)
    kmt, kc = wg_cfg(c, x.dtype)[:2]
    lib = build.load()
    # the entry point sets the kernel's attributes and launches on the
    # current device: make it x's (an engine replica may not be on it)
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
        if x.dtype == torch.float32:
            w = kmajor((w1, w2))
            err = lib.evt_residual_unit_f32(
                x.data_ptr(), w.data_ptr(), b1.data_ptr(), b2.data_ptr(), y.data_ptr(),
                bsz, t, c, k, d, tile, box, n_box, stages, kmt, kc, stream)
        else:
            err = lib.evt_residual_unit_bf16(
                x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                y.data_ptr(), bsz, t, c, k, d, tile, box, n_box, stages, kmt, kc, stream)
        build.check(err, "fused_residual_unit")
    build.count_launch(fused_residual_unit)
    return y


fused_residual_unit.launches = 0  # kernel launches since the last reset
