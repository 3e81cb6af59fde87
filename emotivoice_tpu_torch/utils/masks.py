"""Length/mask helpers (counterpart of `emotivoice_tpu/utils/masks.py`).

Masks are *valid* masks (True = real token / frame, False = padding), so
`x * mask` zeroes padding directly.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths -> (B, max_len) bool valid mask."""
    ids = torch.arange(max_len, device=lengths.device, dtype=lengths.dtype)
    return ids[None, :] < lengths[:, None]
