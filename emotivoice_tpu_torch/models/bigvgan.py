"""BigVGAN-v2 generator (github.com/NVIDIA/BigVGAN `bigvgan.py`,
`activations.py`, `alias_free_activation/torch/`; arXiv:2206.04658), the
vocoder that `VocoderConfig(activation="snakebeta")` selects behind the
acoustic model. The JAX package has no counterpart.

Module and state-dict names are upstream's: `conv_pre`, `ups.{i}.0`,
`resblocks.{3i+j}` (AMPBlock1: `convs1.{m}`, `convs2.{m}`,
`activations.{a}`), `activation_post`, `conv_post`; an activation holds
`act.alpha`, `act.beta` (log-scale) and the filter buffers
`upsample.filter`, `downsample.lowpass.filter`. Weight norm is the port's
explicit (weight_g, weight_v) of `models/hifigan.py`, as upstream's
checkpoints store it.

  x = conv_pre(mel)
  per stage i: x = ups[i](x) (no activation before it), then the mean of
    its AMPBlock1s, each: per dilation d, x = x + convs2(act(convs1_d(act(x))))
  y = conv_post(act_post(x)) (no bias), then clamp to [-1, 1] (no tanh):
    the published configurations' use_bias_at_final and use_tanh_at_final
    false, the only forms built.

Each act is `Activation1d(SnakeBeta)`: x2 up-sampling, SnakeBeta, x2 down-
sampling, through `fused_aa_snake` (`ops/cuda/aa_snake.py`): the hand-written
kernel on a card, its plain chain on a CPU tensor. The convolutions are
cuDNN's on a card (`WNConv1d`; its wide, long dilated bf16 convs run over
the phases of time): the MRF kernels are built for HiFi-GAN V1's widths
only. Activations
are (B, T, C) views; the convolutions leave them (B, C, T) in memory, the
layout the kernel reads. Inference only: training and tensor parallelism
do not take this generator.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from emotivoice_tpu_torch.config import VocoderConfig
from emotivoice_tpu_torch.models.hifigan import WNConv1d, WNConvTranspose1d
from emotivoice_tpu_torch.ops.cuda.aa_snake import fused_aa_snake, kaiser_sinc_filter1d

NAME = "BigVGAN-v2"  # the vocoder's name in refusals


class SnakeBeta(nn.Module):
    """Per-channel log-scale alpha and beta (upstream's `alpha_logscale`
    form; both start at 0, so at 1)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))


class _Filter(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("filter", kaiser_sinc_filter1d())


class _DownSample(nn.Module):
    def __init__(self):
        super().__init__()
        self.lowpass = _Filter()


class Activation1d(nn.Module):
    """Anti-aliased SnakeBeta over (B, T, C)."""

    def __init__(self, channels: int):
        super().__init__()
        self.act = SnakeBeta(channels)
        self.upsample = _Filter()
        self.downsample = _DownSample()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_aa_snake(x, self.act.alpha, self.act.beta, self.upsample.filter,
                              self.downsample.lowpass.filter)


class AMPBlock1(nn.Module):
    """Per dilation d: x = x + convs2(act(convs1_d(act(x))))."""

    def __init__(self, channels: int, kernel_size: int, dilations: Sequence[int]):
        super().__init__()
        self.convs1 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, dilation=d) for d in dilations)
        self.convs2 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size) for _ in dilations)
        self.activations = nn.ModuleList(
            Activation1d(channels) for _ in range(2 * len(dilations)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acts = self.activations
        for m, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            x = x + c2(acts[2 * m + 1](c1(acts[2 * m](x))))
        return x


class BigVGANGenerator(nn.Module):
    """Input (B, T, n_mels) mel, output (B, T * prod(upsample_rates)) f32
    waveform in [-1, 1]."""

    def __init__(self, cfg: VocoderConfig):
        super().__init__()
        if (cfg.resblock != "1" or not cfg.snake_logscale or cfg.use_tanh_at_final
                or cfg.use_bias_at_final):
            raise ValueError(f"{NAME}: the port builds AMPBlock1 (resblock '1') with "
                             "log-scale SnakeBeta, no tanh and no final bias only, got "
                             f"resblock {cfg.resblock!r}, snake_logscale {cfg.snake_logscale}, "
                             f"use_tanh_at_final {cfg.use_tanh_at_final}, use_bias_at_final "
                             f"{cfg.use_bias_at_final}")
        self.cfg = cfg
        c = cfg
        self.conv_pre = WNConv1d(c.initial_channel, c.upsample_initial_channel, 7, padding=3)
        self.ups = nn.ModuleList()
        blocks: List[nn.Module] = []
        for i, (u, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            c_in = c.upsample_initial_channel // (2 ** i)
            c_out = c_in // 2
            self.ups.append(nn.ModuleList([WNConvTranspose1d(c_in, c_out, k, u, (k - u) // 2)]))
            for rk, rd in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes):
                blocks.append(AMPBlock1(c_out, rk, rd))
        self.resblocks = nn.ModuleList(blocks)
        self.activation_post = Activation1d(c_out)
        self.conv_post = WNConv1d(c_out, 1, 7, padding=3, bias=False)

    def forward(self, mel: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        nk = len(self.cfg.resblock_kernel_sizes)
        x = self.conv_pre(mel.to(dtype))
        for i, up in enumerate(self.ups):
            x = up[0](x)
            acc = None
            for block in self.resblocks[i * nk:(i + 1) * nk]:
                r = block(x)
                acc = r if acc is None else acc + r
            x = acc / nk
        y = self.conv_post(self.activation_post(x)).float()
        return torch.clamp(y, -1.0, 1.0)[..., 0]
