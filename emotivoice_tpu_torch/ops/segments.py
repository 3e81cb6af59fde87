"""Random segment cropping for GAN training (counterpart of
`emotivoice_tpu/ops/segments.py`; reference
`models/hifigan/get_random_segments.py:8-27`), batched as one gather.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def get_segments(x: torch.Tensor, start_idxs: torch.Tensor, segment_size: int) -> torch.Tensor:
    """x (B, T, C) or (B, T): rows [start, start + segment_size) of each
    item, indices clamped into range (x zero-padded to segment_size first)."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[..., None]
    t = x.shape[1]
    if t < segment_size:
        x = F.pad(x, (0, 0, 0, segment_size - t))
        t = segment_size
    idx = start_idxs.to(x.device, torch.int64)[:, None] + torch.arange(
        segment_size, device=x.device)[None, :]
    idx = idx.clamp(0, t - 1)
    out = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))
    return out[..., 0] if squeeze else out


def random_starts(lengths: torch.Tensor, segment_size: int,
                  generator: Optional[torch.Generator] = None,
                  rows: Optional[slice] = None, n_draw: Optional[int] = None) -> torch.Tensor:
    """int32 start indices floor(u * max(lengths - segment_size, 0)), u ~
    U[0, 1) from `generator` (on lengths' device). With `rows`, `n_draw`
    uniforms are drawn (a global batch's) and `lengths` are those of its
    `rows`: a data-parallel rank cuts what one process cuts from the
    concatenated batch."""
    max_start = torch.clamp(lengths - segment_size, min=0).float()
    u = torch.rand(n_draw or lengths.shape[0], generator=generator, device=lengths.device)
    if rows is not None:
        u = u[rows]
    return (u * max_start).to(torch.int32)


def get_random_segments(
    x: torch.Tensor,  # (B, T, C)
    lengths: torch.Tensor,  # (B,)
    segment_size: int,
    generator: Optional[torch.Generator] = None,
    start_idxs: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (segments (B, segment_size, C), start_idxs (B,) int32).
    Given `start_idxs` (e.g. to replay another run's draw) are used as they
    are; otherwise they are drawn from `generator`."""
    if start_idxs is None:
        start_idxs = random_starts(lengths, segment_size, generator)
    start_idxs = start_idxs.to(x.device, torch.int32)
    return get_segments(x, start_idxs, segment_size), start_idxs
