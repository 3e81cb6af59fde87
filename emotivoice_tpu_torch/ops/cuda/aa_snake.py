"""BigVGAN-v2's anti-aliased SnakeBeta (`Activation1d`): CUDA kernel wrapper
and its plain PyTorch version.

Replaces no TPU kernel: the JAX package has no BigVGAN. The kernel is
`emotivoice_tpu_torch/csrc/aa_snake.cu`; its header comment states what
bounds it on the H100 (bytes) and its design: x read once with its halo,
the doubled signal kept in registers, y written once, f32 arithmetic.

Per channel c of x (B, T, C), with 12-tap filters f_up and f_down
(`kaiser_sinc_filter1d`, BigVGAN's `alias_free_activation/torch/filter.py`):
  1. up x2: replicate-pad x by 5, u = 2 conv_transpose1d(x, f_up, stride 2),
     5 * 2 + 5 = 15 samples cut from each end: 2T samples;
  2. SnakeBeta: s = u + 1 / (exp(beta_log) + 1e-9) sin^2(exp(alpha_log) u);
  3. down x2: replicate-pad s by 5 on the left and 6 on the right,
     y = conv1d(s, f_down, stride 2): T samples.

`fused_aa_snake` launches the kernel for CUDA tensors and takes the plain
version for CPU tensors; any other device, dtype or shape raises, and so
does an operand that requires grad while grad is enabled (no backward).
The kernel reads each (b, c) row of x as contiguous samples: a (B, T, C)
tensor whose memory is (B, C, T), as the generator's convolutions leave
their outputs, goes in as it is; one laid out otherwise is first copied to
that layout. y comes back in that layout.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from emotivoice_tpu_torch.ops.cuda import build
from emotivoice_tpu_torch.ops.cuda.resblock import refuse_grad

RATIO = 2  # up- and down-sampling ratio of BigVGAN's Activation1d
TAPS = 12  # kTaps of csrc/aa_snake.cu: the filters' length
BETA_EPS = 1e-9  # SnakeBeta's no_div_by_zero


def kaiser_sinc_filter1d(cutoff: float = 0.5 / RATIO, half_width: float = 0.6 / RATIO,
                         kernel_size: int = TAPS) -> torch.Tensor:
    """BigVGAN's low-pass filter (1, 1, kernel_size): a Kaiser-windowed sinc
    at `cutoff` (of the sampling rate), normalised to sum 1."""
    even = kernel_size % 2 == 0
    half = kernel_size // 2
    atten = 2.285 * (half - 1) * math.pi * 4 * half_width + 7.95
    if atten > 50.0:
        beta = 0.1102 * (atten - 8.7)
    elif atten >= 21.0:
        beta = 0.5842 * (atten - 21) ** 0.4 + 0.07886 * (atten - 21.0)
    else:
        beta = 0.0
    window = torch.kaiser_window(kernel_size, periodic=False, beta=beta)
    t = (torch.arange(-half, half) + 0.5) if even else (torch.arange(kernel_size) - half)
    f = 2 * cutoff * window * torch.sinc(2 * cutoff * t)
    return (f / f.sum()).view(1, 1, kernel_size)


def aa_snake_plain(x: torch.Tensor, alpha_log: torch.Tensor, beta_log: torch.Tensor,
                   up_taps: torch.Tensor, down_taps: torch.Tensor) -> torch.Tensor:
    """The plain chain of BigVGAN's Activation1d(SnakeBeta) over (B, T, C),
    in f32 whatever x's dtype (as the kernel computes), returned in x's
    dtype."""
    c = x.shape[2]
    k = up_taps.numel()
    pad = k // RATIO - 1
    crop = pad * RATIO + (k - RATIO) // 2
    h = x.float().transpose(1, 2)
    fu = up_taps.float().reshape(1, 1, k).expand(c, 1, k)
    fd = down_taps.float().reshape(1, 1, k).expand(c, 1, k)
    u = RATIO * F.conv_transpose1d(F.pad(h, (pad, pad), mode="replicate"), fu,
                                   stride=RATIO, groups=c)
    u = u[..., crop:u.shape[-1] - crop]
    alpha = torch.exp(alpha_log.float())[:, None]
    beta = torch.exp(beta_log.float())[:, None]
    s = u + (1.0 / (beta + BETA_EPS)) * torch.sin(u * alpha) ** 2
    s = F.pad(s, (k // 2 - 1, k // 2), mode="replicate")
    y = F.conv1d(s, fd, stride=RATIO, groups=c)
    return y.transpose(1, 2).to(x.dtype)


def check_operands(x, alpha_log, beta_log, up_taps, down_taps) -> None:
    """What the kernel takes: x (B, T, C) in f32 or bf16 with T, C >= 1;
    alpha_log, beta_log (C,) and both filters (TAPS,) elements, f32 and
    contiguous, all on x's device."""
    name = "fused_aa_snake"
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or x.shape[1] < 1 or x.shape[2] < 1:
        raise ValueError(f"{name}: x must be (B, T, C) with T and C at least 1, "
                         f"got {tuple(x.shape)}")
    c = x.shape[2]
    for t, n, what in ((alpha_log, c, "alpha_log"), (beta_log, c, "beta_log"),
                       (up_taps, TAPS, "up_taps"), (down_taps, TAPS, "down_taps")):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: {what} must be float32 on x's device")
        if t.numel() != n or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be {n} contiguous elements, got "
                             f"{tuple(t.shape)}")


def fused_aa_snake(x: torch.Tensor, alpha_log: torch.Tensor, beta_log: torch.Tensor,
                   up_taps: torch.Tensor, down_taps: torch.Tensor) -> torch.Tensor:
    """`aa_snake_plain` through the kernel on a card. Refuses operands that
    require grad while grad is enabled (`refuse_grad`)."""
    refuse_grad("fused_aa_snake", (x, alpha_log, beta_log))
    if x.device.type == "cpu":
        return aa_snake_plain(x, alpha_log, beta_log, up_taps, down_taps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_aa_snake: unsupported device {x.device}")
    check_operands(x, alpha_log, beta_log, up_taps, down_taps)
    b, t, c = x.shape
    rows = x.transpose(1, 2).contiguous()  # (B, C, T): free for the generator's tensors
    lib = build.load()
    entry = lib.evt_aa_snake_f32 if x.dtype == torch.float32 else lib.evt_aa_snake_bf16
    with torch.cuda.device(x.device):
        y = torch.empty_like(rows)
        stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
        err = entry(rows.data_ptr(), alpha_log.data_ptr(), beta_log.data_ptr(),
                    up_taps.data_ptr(), down_taps.data_ptr(), y.data_ptr(), b * c, c, t, stream)
        build.check(err, "fused_aa_snake")
    build.count_launch(fused_aa_snake)
    return y.transpose(1, 2)


fused_aa_snake.launches = 0  # kernel launches since the last reset
