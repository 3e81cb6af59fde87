"""ESPnet-style pre-LN transformer encoder (counterpart of
`emotivoice_tpu/models/transformer.py`).

Parameter names follow the reference checkpoint
(`encoder.embed.0.alpha`, `encoder.encoders.{i}.self_attn.linear_q.weight`,
`...feed_forward.w_1.weight`, `...norm1.weight`, `encoder.after_norm.weight`),
so a port `state_dict()` converts unchanged through
`emotivoice_tpu/convert/from_torch.py`.

Conventions shared by every module of the port:
  - activations are feature-last (B, T, C), masks are valid masks;
  - parameters are stored f32 and cast to the activation dtype at use, so a
    bf16 input runs bf16 compute without touching the checkpoint
    (LayerNorm statistics stay f32);
  - dropout sits where the JAX package's does (positional encoding,
    attention weights, both residual branches, inside the FFN), at the
    rate the caller gives; it acts in `train()` mode only, so an `eval()`
    model (serving) is deterministic.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from emotivoice_tpu_torch.parallel.tensor_parallel import (
    ColumnParallel,
    RowParallel,
    as_group,
    conv1d,
)
from emotivoice_tpu_torch.utils.masks import NEG_INF

LN_EPS = 1e-12


class Linear(nn.Linear):
    """nn.Linear whose f32 parameters follow the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)

    def op(self):
        """This layer's function of (input, weight, bias), for its parallel versions."""
        return F.linear


class LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-12) with f32 statistics, output in the input dtype."""

    def __init__(self, n: int):
        super().__init__(n, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(x.dtype)


class Conv1dSame(nn.Conv1d):
    """Conv1d over (B, T, C) with symmetric 'same' padding (k-1)//2*d."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, dilation: int = 1):
        super().__init__(c_in, c_out, kernel_size, dilation=dilation,
                         padding=(kernel_size - 1) // 2 * dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x.transpose(1, 2), self.weight.to(x.dtype), None,
                     padding=self.padding, dilation=self.dilation)
        return y.transpose(1, 2) + self.bias.to(x.dtype)

    def op(self):
        return conv1d(self.padding, self.dilation)


def sinusoid_table(max_len: int, d_model: int) -> np.ndarray:
    """Sinusoidal PE table (reference encoder.py:216-237), f64 math -> f32."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64) * -(np.log(10000.0) / d_model)
    )
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)


class ScaledPositionalEncoding(nn.Module):
    """x + alpha * PE with a learned scalar alpha (reference encoder.py:246-261)."""

    def __init__(self, d_model: int, max_len: int = 5000, dropout: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.max_len = max_len
        self.alpha = nn.Parameter(torch.ones(()))
        self.dropout = nn.Dropout(dropout)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoid_table(max_len, d_model)),
            persistent=False,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[1]
        pe = self.pe
        if t > pe.shape[0]:
            pe = torch.from_numpy(sinusoid_table(t, self.d_model)).to(x.device)
        return self.dropout(x + self.alpha.to(x.dtype) * pe[None, :t].to(x.dtype))


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           valid_mask: Optional[torch.Tensor], n_heads: int, dropout: nn.Module) -> torch.Tensor:
    """Attention of (B, T, n_heads * d_k) projections, back to that layout.

    Plain matmul + softmax, the same math as the JAX einsums: masked keys get
    NEG_INF before the softmax and exactly 0 after it."""
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
    out = torch.matmul(dropout(attn).to(v.dtype), v)
    return out.transpose(1, 2).reshape(b, t, d)


class MultiHeadedAttention(nn.Module):
    """Full (non-causal) attention, reference encoder.py:55-109."""

    def __init__(self, n_heads: int, d_model: int, dropout: float = 0.0):
        super().__init__()
        self.n_heads = n_heads
        self.dropout = nn.Dropout(dropout)
        self.linear_q = Linear(d_model, d_model)
        self.linear_k = Linear(d_model, d_model)
        self.linear_v = Linear(d_model, d_model)
        self.linear_out = Linear(d_model, d_model)

    def forward(self, x: torch.Tensor, valid_mask: Optional[torch.Tensor]) -> torch.Tensor:
        out = attend(self.linear_q(x), self.linear_k(x), self.linear_v(x), valid_mask,
                     self.n_heads, self.dropout)
        return self.linear_out(out)


class HeadParallelAttention(nn.Module):
    """MultiHeadedAttention over a model group (`parallel/tensor_parallel.py`):
    shard i runs heads [i H/N, (i+1) H/N) with d_k unchanged (linear_q/k/v
    column-parallel), and linear_out reduces the shards' partial sums.
    Each shard draws its own dropout masks, so it equals the one-device
    module only with dropout off (as the tests run it)."""

    def __init__(self, attn: MultiHeadedAttention, group):
        super().__init__()
        self.group = as_group(group)
        self.n_heads = attn.n_heads // self.group.size  # per shard
        self.dropout = attn.dropout
        self.linear_q = ColumnParallel(attn.linear_q, self.group)
        self.linear_k = ColumnParallel(attn.linear_k, self.group)
        self.linear_v = ColumnParallel(attn.linear_v, self.group)
        self.linear_out = RowParallel(attn.linear_out, self.group)

    def forward(self, x: torch.Tensor, valid_mask: Optional[torch.Tensor]) -> torch.Tensor:
        xs = self.group.enter(x)
        q, k, v = (lin.forward_shards(xs) for lin in (self.linear_q, self.linear_k, self.linear_v))
        heads = [attend(*qkv, m, self.n_heads, self.dropout)
                 for *qkv, m in zip(q, k, v, self.group.enter(valid_mask))]
        return self.linear_out.forward_partials(heads)


class ConvFFN(nn.Module):
    """MultiLayeredConv1d: conv k -> exact-erf GELU -> dropout -> conv k."""

    def __init__(self, d_model: int, d_hidden: int, kernel_size: int, dropout: float = 0.0):
        super().__init__()
        self.w_1 = Conv1dSame(d_model, d_hidden, kernel_size)
        self.w_2 = Conv1dSame(d_hidden, d_model, kernel_size)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_2(self.dropout(F.gelu(self.w_1(x), approximate="none")))


class ParallelConvFFN(nn.Module):
    """ConvFFN over a model group: w_1 column-parallel, w_2 row-parallel,
    reduced once; GELU and dropout per shard (own masks, as above)."""

    def __init__(self, ffn: ConvFFN, group):
        super().__init__()
        self.group = as_group(group)
        self.w_1 = ColumnParallel(ffn.w_1, self.group)
        self.w_2 = RowParallel(ffn.w_2, self.group)
        self.dropout = ffn.dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hidden = self.w_1.forward_shards(self.group.enter(x))
        return self.w_2.forward_partials(
            [self.dropout(F.gelu(h, approximate="none")) for h in hidden])


class EncoderLayer(nn.Module):
    """Pre-LN block (reference encoder.py:129-200, normalize_before=True)."""

    def __init__(self, d_model: int, n_heads: int, d_ffn: int, kernel_size: int,
                 dropout: float = 0.0):
        super().__init__()
        self.self_attn = MultiHeadedAttention(n_heads, d_model, dropout)
        self.feed_forward = ConvFFN(d_model, d_ffn, kernel_size, dropout)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, valid_mask: Optional[torch.Tensor]) -> torch.Tensor:
        x = x + self.dropout(self.self_attn(self.norm1(x), valid_mask))
        return x + self.dropout(self.feed_forward(self.norm2(x)))


class TransformerEncoder(nn.Module):
    """Reference `Encoder` (encoder.py:263-324): ScaledPE -> N blocks -> LN."""

    def __init__(self, d_model: int, n_heads: int, n_layers: int,
                 kernel_size: int = 3, max_len: int = 5000, dropout: float = 0.0):
        super().__init__()
        self.embed = nn.Sequential(ScaledPositionalEncoding(d_model, max_len, dropout))
        self.encoders = nn.ModuleList(
            EncoderLayer(d_model, n_heads, d_model * 4, kernel_size, dropout)
            for _ in range(n_layers)
        )
        self.after_norm = LayerNorm(d_model)

    def forward(self, x: torch.Tensor,
                valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.embed(x)
        for layer in self.encoders:
            x = layer(x, valid_mask)
        return self.after_norm(x)
