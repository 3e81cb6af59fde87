"""Plain convolutions over feature-last (B, T, C) activations, and the
functions of (input, weight, bias) that the port's conv layers return from
`op()`: the one-device forward calls them, and so does each shard of a
parallel layer (`parallel/tensor_parallel.py`)."""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.nn.functional as F


# cuDNN's bf16 dilated conv1d falls to a CUDA-core kernel (implicit_convolve_sgemm),
# 10-20x slower, once C >= 192 and the kernel spans (k - 1) d >= 30 samples (BigVGAN-v2's
# AMP blocks); elsewhere, and in f32, it beats the phase form by up to 2.4x (PERF.md §6,
# measured on an H100).
PHASE_MIN_CHANNELS = 192
PHASE_MIN_SPAN = 30


def conv1d_over_phases(h, w, padding, dilation):
    """F.conv1d(h, w, padding=padding, dilation=dilation) over (B, C, T) as
    an undilated (K, 1) conv2d over the d phases of time: the zero-padded
    memory, its length a multiple of d, viewed as (B, C, T' / d, d)."""
    d = dilation
    t = h.shape[-1]
    n = t + 2 * padding - d * (w.shape[-1] - 1)  # output samples
    tp = -(-(t + 2 * padding) // d) * d
    h = F.pad(h, (padding, tp - t - padding))
    y = F.conv2d(h.reshape(*h.shape[:2], tp // d, d), w.unsqueeze(-1))
    return y.reshape(*y.shape[:2], -1)[..., :n]


def conv1d_btc(x, w, b, padding, dilation=1):
    """Conv1d over feature-last (B, T, C); `b` may be None. A dilated bf16
    one that cuDNN would run on the CUDA cores runs over the phases of
    time instead (`conv1d_over_phases`, the same function)."""
    h = x.transpose(1, 2)
    if (dilation > 1 and x.dtype == torch.bfloat16 and w.shape[1] >= PHASE_MIN_CHANNELS
            and (w.shape[-1] - 1) * dilation >= PHASE_MIN_SPAN):
        y = conv1d_over_phases(h, w, padding, dilation)
    else:
        y = F.conv1d(h, w, padding=padding, dilation=dilation)
    y = y.transpose(1, 2)
    return y if b is None else y + b


def conv_transpose1d_btc(x, w, b, stride, padding):
    """ConvTranspose1d over feature-last (B, T, C); `b` may be None."""
    y = F.conv_transpose1d(x.transpose(1, 2), w, stride=stride, padding=padding).transpose(1, 2)
    return y if b is None else y + b


def conv2d(stride, padding) -> Callable:
    return functools.partial(F.conv2d, stride=stride, padding=padding)


def conv1d(padding, dilation=1) -> Callable:
    return functools.partial(conv1d_btc, padding=padding, dilation=dilation)


def conv_transpose1d(stride, padding) -> Callable:
    return functools.partial(conv_transpose1d_btc, stride=stride, padding=padding)
