"""Device selection for the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU: a
missing card is an error, never a silent fallback.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """None -> 'cuda' (raises without a card); otherwise the given device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev


def resolve_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """'f32' / 'bf16' / torch.float32 / torch.bfloat16 -> the torch dtype."""
    out = {"f32": torch.float32, "bf16": torch.bfloat16}.get(dtype, dtype)
    if out not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be f32 or bf16, got {dtype!r}")
    return out


def use_exact_f32(dtype: Union[str, torch.dtype]) -> None:
    """An f32 compute dtype means f32: PyTorch lets cuDNN convolutions (and,
    when asked, cuBLAS matmuls) run in TF32, a 10-bit mantissa, so turn both
    off. bf16 leaves the flags as they are."""
    if resolve_dtype(dtype) == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
