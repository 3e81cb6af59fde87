"""Variance adaptor: duration / pitch / energy predictors, the variance
embeddings and the text-mel alignment scorer (counterpart of
`emotivoice_tpu/models/variance.py`).

Key layout follows the reference: `{name}.conv.{i}.0` (Conv1d),
`{name}.conv.{i}.2` (LayerNorm), `{name}.linear`, `pitch_embed.0`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from emotivoice_tpu_torch.models.transformer import Conv1dSame, LayerNorm, Linear
from emotivoice_tpu_torch.utils.masks import NEG_INF


class _ConvReluLnStack(nn.ModuleList):
    """n x (conv k -> ReLU -> LayerNorm -> dropout), the reference's
    Sequential: the LayerNorm sits at `.2`."""

    def __init__(self, n_layers: int, c_in: int, n_chans: int, kernel_size: int,
                 dropout: float = 0.0):
        super().__init__(
            nn.Sequential(
                Conv1dSame(c_in if i == 0 else n_chans, n_chans, kernel_size),
                nn.ReLU(),
                LayerNorm(n_chans),
                nn.Dropout(dropout),
            )
            for i in range(n_layers)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self:
            x = layer(x)
        return x


class VariancePredictor(nn.Module):
    """Pitch / energy predictor (reference variance.py:68-123)."""

    def __init__(self, c_in: int, n_layers: int, n_chans: int, kernel_size: int,
                 dropout: float = 0.0):
        super().__init__()
        self.conv = _ConvReluLnStack(n_layers, c_in, n_chans, kernel_size, dropout)
        self.linear = Linear(n_chans, 1)

    def forward(self, x: torch.Tensor,
                valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if valid_mask is not None:
            x = x * valid_mask[..., None].to(x.dtype)
        out = self.linear(self.conv(x))[..., 0]
        if valid_mask is not None:
            out = out * valid_mask.to(out.dtype)
        return out


class DurationPredictor(VariancePredictor):
    """Log-domain duration predictor (reference variance.py:9-64)."""

    @staticmethod
    def to_durations(log_d: torch.Tensor, offset: float = 1.0) -> torch.Tensor:
        """clamp(round(exp(x) - offset), 0) in f32 (round half to even, as
        jnp.round)."""
        return torch.clamp(torch.round(torch.exp(log_d.float()) - offset), min=0.0)


class VarianceEmbedding(nn.Sequential):
    """Conv1d k9 embedding of a scalar track back into the hidden dim, then
    dropout (reference model_open_source.py:63-70 pitch_embed / energy_embed)."""

    def __init__(self, features: int, kernel_size: int = 9, dropout: float = 0.0):
        super().__init__(Conv1dSame(1, features, kernel_size), nn.Dropout(dropout))

    def forward(self, track: torch.Tensor) -> torch.Tensor:
        return self[1](self[0](track[..., None]))  # (B, T) -> (B, T, features)


class AlignmentModule(nn.Module):
    """Text/mel projections + negative-L2 log-attention scores (reference
    alignment.py:13-57). Returns log_p_attn (B, T_feats, T_text)."""

    def __init__(self, adim: int, odim: int):
        super().__init__()
        self.t_conv1 = Conv1dSame(adim, adim, 3)
        self.t_conv2 = Conv1dSame(adim, adim, 1)
        self.f_conv1 = Conv1dSame(odim, adim, 3)
        self.f_conv2 = Conv1dSame(adim, adim, 3)
        self.f_conv3 = Conv1dSame(adim, adim, 1)

    def forward(self, text: torch.Tensor, feats: torch.Tensor,
                text_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        t = self.t_conv2(F.relu(self.t_conv1(text)))
        f = self.f_conv3(F.relu(self.f_conv2(F.relu(self.f_conv1(feats)))))
        f2 = torch.sum(f * f, dim=-1)
        t2 = torch.sum(t * t, dim=-1)
        cross = torch.bmm(f.float(), t.float().transpose(1, 2))
        sq = f2[:, :, None] - 2.0 * cross + t2[:, None, :]
        score = -torch.sqrt(torch.clamp(sq, min=1e-12))
        if text_valid is not None:
            score = score.masked_fill(~text_valid[:, None, :], NEG_INF)
        return torch.log_softmax(score, dim=-1)
