"""The H100's published peaks and the roofline bound of a launch. A model's
operations are its reference module's `request_flops`, its kernels' launches
the `kernel_launches` of its "launches" module (see `spec.named_module`).
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense, at 700 W (data sheet)
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
TF32_TERMS = 3  # the f32 kernels' 3xTF32 split: three TF32 products per f32 one
PEAK_BYTES = 3.35e12


def peak_flops(dtype: str) -> float:
    """The peak a configuration's compute dtype is held to: bf16 on the
    tensor cores; f32 as the 3xTF32 split the port's f32 kernels run."""
    return {"bf16": PEAK_BF16, "f32": PEAK_TF32 / TF32_TERMS}[dtype]


def bound_seconds(flop: int, nbytes: int, dtype: str) -> float:
    """The least time the card could take: operations at the peak or bytes
    at the memory's rate, whichever is longer."""
    return max(flop / peak_flops(dtype), nbytes / PEAK_BYTES)
