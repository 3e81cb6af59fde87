"""Gaussian-upsampling length regulator as a masked, static-shape matmul
(counterpart of `emotivoice_tpu/ops/upsample.py`; reference
`GaussianUpsampling`, `modules/alignment.py:175-211`):

  c_n  = cumsum(d)_n - d_n / 2
  w_tn = softmax_n( -delta * (t - c_n)^2 )
  out  = w @ hs

The caller supplies a static ``max_frames`` bucket; frames beyond each
utterance's sum(d) are masked.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from emotivoice_tpu_torch.utils.masks import NEG_INF, sequence_mask


def gaussian_upsample(
    hs: torch.Tensor,  # (B, T_text, D)
    ds: torch.Tensor,  # (B, T_text) durations (float)
    text_valid: torch.Tensor,  # (B, T_text) bool
    max_frames: int,
    feat_valid: Optional[torch.Tensor] = None,  # (B, max_frames) or None
    delta: float = 0.1,
    alpha: Union[float, torch.Tensor] = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (upsampled (B, max_frames, D), mel_lengths (B,) int64).
    `alpha` (duration scale) may be a 0-d tensor on hs's device: a bucket
    program's traced input, read without a host sync."""
    valid_f = text_valid.float()
    ds = ds.float() * alpha * valid_f

    # Degenerate all-zero utterance: fall back to duration 1 per token
    # (reference alignment.py:188-193).
    degenerate = ds.sum(dim=1) <= 0
    ds = torch.where(degenerate[:, None], valid_f, ds)
    totals = ds.sum(dim=1)

    mel_lengths = torch.clamp(totals.to(torch.int64), min=1, max=max_frames)
    if feat_valid is None:
        feat_valid = sequence_mask(mel_lengths, max_frames)

    t = torch.arange(max_frames, device=hs.device, dtype=torch.float32)[None, :]
    t = t * feat_valid.float()  # reference multiplies t by h_masks
    c = torch.cumsum(ds, dim=1) - ds / 2.0

    energy = -delta * (t[:, :, None] - c[:, None, :]) ** 2
    energy = energy.masked_fill(~text_valid[:, None, :], NEG_INF)
    w = torch.softmax(energy, dim=2)
    out = torch.bmm(w, hs.float())
    out = out.to(hs.dtype) * feat_valid[..., None].to(hs.dtype)
    return out, mel_lengths
