"""Fused masked attention of the port's transformer: CUDA kernel wrapper and
its plain PyTorch version.

Replaces no TPU kernel: the JAX package leaves this attention to XLA
(`emotivoice_tpu/models/transformer.py`, MultiHeadedAttention). The kernel is
`emotivoice_tpu_torch/csrc/attention.cu`; its header comment states what
bounds it on the H100 (operations, once the (B, H, T, T) scores stay on
chip) and its design: one block per (query tile, head, batch row) reading
Q, K and V in the linears' (B, T, H * d_k) layout, K and V tiles by TMA
through a producer's `mbarrier` ring, an online softmax in registers, and a
key loop that ends after the row's last valid key tile. bf16
multiplies on `wgmma` with P rounded to bf16 before P V; f32 on the CUDA
cores (FFMA), at f32 accuracy.

`fused_attention` launches the kernel for CUDA tensors and takes the plain
version for CPU tensors; any other device, dtype or shape raises, and so
does an operand that requires grad while grad is enabled (no backward).
Heads narrower than the kernel's d_k are zero-padded to it: zero columns add
nothing to Q K^T, and O's are cut away. `models/transformer.py` `attend`
sends every inference call on a card here.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from emotivoice_tpu_torch.ops.cuda import build
from emotivoice_tpu_torch.ops.cuda.resblock import refuse_grad
from emotivoice_tpu_torch.utils.masks import NEG_INF

# Mirrors of csrc/attention.cu
HEAD_DIM = 48  # kHeadDim: the d_k the kernel is built for
KEY_TILE = 64  # kKeyTile: keys of a ring stage, the unit the key loop skips by


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid_mask: Optional[torch.Tensor], n_heads: int,
                    dropout: Optional[nn.Module] = None) -> torch.Tensor:
    """Attention of (B, T, n_heads * d_k) projections, back to that layout.

    Plain matmul + softmax, the same math as the JAX einsums: masked keys get
    NEG_INF before the softmax and exactly 0 after it; the weights (after
    `dropout`, where given) are cast to v's dtype before their matmul."""
    b, t, d = q.shape
    d_k = d // n_heads

    def split(h):  # (B, T, D) -> (B, H, T, d_k)
        return h.view(b, t, n_heads, d_k).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    scores = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(d_k)
    if valid_mask is not None:
        key_mask = valid_mask[:, None, None, :]
        scores = scores.masked_fill(~key_mask, NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    if valid_mask is not None:
        attn = attn.masked_fill(~key_mask, 0.0)
    if dropout is not None:
        attn = dropout(attn)
    out = torch.matmul(attn.to(v.dtype), v)
    return out.transpose(1, 2).reshape(b, t, d)


def pad_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, T, n_heads * d_k) -> (B, T, n_heads * HEAD_DIM), each head's
    columns followed by zeros."""
    b, t, d = x.shape
    return F.pad(x.view(b, t, n_heads, d // n_heads), (0, HEAD_DIM - d // n_heads)).view(b, t, -1)


def check_operands(q, k, v, valid_mask, n_heads: int) -> None:
    """What the wrapper takes: q, k, v (B, T, n_heads * d_k) with d_k at
    most HEAD_DIM, of one dtype (f32 or bf16) on one device, contiguous and
    16-byte aligned; the mask (B, T) bool on that device, contiguous, or
    None."""
    name = "fused_attention"
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 3 or q.shape[2] % n_heads or not 0 < q.shape[2] // n_heads <= HEAD_DIM:
        raise ValueError(f"{name}: q must be (B, T, {n_heads} * d_k) with d_k at most "
                         f"{HEAD_DIM} (the kernel's), got {tuple(q.shape)}")
    for x in (q, k, v):
        if x.device != q.device or x.dtype != q.dtype or x.shape != q.shape:
            raise ValueError(f"{name}: q, k and v must share shape, device and dtype")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: q, k and v must be contiguous and 16-byte aligned")
    if valid_mask is not None:
        if (valid_mask.dtype != torch.bool or valid_mask.device != q.device
                or tuple(valid_mask.shape) != tuple(q.shape[:2])
                or not valid_mask.is_contiguous()):
            raise ValueError(f"{name}: valid_mask must be a contiguous (B, T) bool tensor on "
                             f"q's device")


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid_mask: Optional[torch.Tensor], n_heads: int) -> torch.Tensor:
    """`attention_plain` without dropout, through the kernel on a card.
    Refuses operands that require grad while grad is enabled (`refuse_grad`)."""
    refuse_grad("fused_attention", (q, k, v))
    if q.device.type == "cpu":
        return attention_plain(q, k, v, valid_mask, n_heads)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    check_operands(q, k, v, valid_mask, n_heads)
    b, t, d = q.shape
    d_k = d // n_heads
    if d_k < HEAD_DIM:
        q, k, v = (pad_heads(x, n_heads) for x in (q, k, v))
    lib = build.load()
    entry = lib.evt_attention_f32 if q.dtype == torch.float32 else lib.evt_attention_bf16
    # the entry point sets the kernel's attributes and launches on the
    # current device: make it q's (an engine replica may not be on it)
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
        mask = None if valid_mask is None else valid_mask.data_ptr()
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask, out.data_ptr(),
                    b, t, n_heads, HEAD_DIM, 1.0 / math.sqrt(d_k), stream)
        build.check(err, "fused_attention")
    build.count_launch(fused_attention)
    return out if d_k == HEAD_DIM else out.view(b, t, n_heads, HEAD_DIM)[..., :d_k].reshape(b, t, d)


fused_attention.launches = 0  # kernel launches since the last reset
