"""HiFi-GAN multi-period + multi-scale discriminators and the GAN losses
(counterpart of the discriminator half of `emotivoice_tpu/models/hifigan.py`;
reference `models/hifigan/models.py:143-310` and
`pretrained_discriminator.py:21-40`).

Unlike the generator, these modules keep torch's channel-first layout,
(B, C, T) and (B, C, H, W), the reference's own: feature maps are
returned as the reference computes them. Parameter names are the
reference's (`mpd.discriminators.{i}.convs.{j}.weight_g`, ...,
`msd.discriminators.0.convs.{j}.weight_orig` / `weight_u` / `weight_v`), so
a port `state_dict()` converts through `emotivoice_tpu/convert/from_torch.py`
as it is.

Spectral norm follows torch's legacy `spectral_norm` (dim 0): sigma =
u . (W v) from the stored u, v, which one power iteration (v, then u)
updates in place before sigma is taken, only when the caller passes
`update_stats=True` (the D step); the G step reads them as they are.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from emotivoice_tpu_torch.config import DiscriminatorConfig
from emotivoice_tpu_torch.models.hifigan import LRELU_SLOPE, WeightNorm

Conv1dSpec = Tuple[int, int, int, int, int]  # (out_ch, kernel, stride, groups, pad)


class WNConv2d(WeightNorm):
    """Weight-normalised Conv2d over (B, C, H, W)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), padding: Tuple[int, int] = (0, 0)):
        super().__init__((c_out, c_in, *kernel_size), c_out)
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.folded().to(x.dtype), self.bias.to(x.dtype), self.stride,
                        self.padding)


class WNConvNCW(WeightNorm):
    """Weight-normalised (grouped, strided) Conv1d over (B, C, T)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int = 1,
                 groups: int = 1, padding: int = 0):
        super().__init__((c_out, c_in // groups, kernel_size), c_out)
        self.stride, self.groups, self.padding = stride, groups, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.folded().to(x.dtype), self.bias.to(x.dtype), self.stride,
                        self.padding, groups=self.groups)


def _unit(rs: np.random.RandomState, n: int) -> torch.Tensor:
    x = rs.randn(n).astype(np.float32)
    return torch.from_numpy(x / np.linalg.norm(x))


class SNConv1d(nn.Module):
    """Spectral-normalised (grouped, strided) Conv1d over (B, C, T)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int = 1,
                 groups: int = 1, padding: int = 0, eps: float = 1e-12):
        super().__init__()
        self.stride, self.groups, self.padding, self.eps = stride, groups, padding, eps
        self.weight_orig = nn.Parameter(torch.zeros(c_out, c_in // groups, kernel_size))
        self.bias = nn.Parameter(torch.zeros(c_out))
        rs = np.random.RandomState(0)  # the JAX package's initial u, v
        self.register_buffer("weight_u", _unit(rs, c_out))
        self.register_buffer("weight_v", _unit(rs, c_in // groups * kernel_size))

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        w_mat = self.weight_orig.flatten(1)
        if update_stats:
            with torch.no_grad():
                v = F.normalize(torch.mv(w_mat.t(), self.weight_u), dim=0, eps=self.eps)
                u = F.normalize(torch.mv(w_mat, v), dim=0, eps=self.eps)
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        # copies: a later update_stats call rewrites the buffers in place
        # while this call's graph may still need them
        sigma = torch.dot(self.weight_u.clone(), torch.mv(w_mat, self.weight_v.clone()))
        return F.conv1d(x, (self.weight_orig / sigma).to(x.dtype), self.bias.to(x.dtype),
                        self.stride, self.padding, groups=self.groups)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LRELU_SLOPE)


class DiscriminatorP(nn.Module):
    """Period sub-discriminator (reference models.py:143-177): the waveform
    reflect-padded to a multiple of the period, folded to (T/p, p), then
    strided (k, 1) convs."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 channels: Sequence[int] = (32, 128, 512, 1024)):
        super().__init__()
        self.period = period
        pad = (kernel_size - 1) // 2
        widths = list(channels)
        self.convs = nn.ModuleList(
            [WNConv2d(ci, co, (kernel_size, 1), (stride, 1), (pad, 0))
             for ci, co in zip([1] + widths[:-1], widths)]
            + [WNConv2d(widths[-1], widths[-1], (kernel_size, 1), (1, 1), (pad, 0))])
        self.conv_post = WNConv2d(widths[-1], 1, (3, 1), (1, 1), (1, 0))

    def forward(self, wav: torch.Tensor):
        b, t = wav.shape
        p = self.period
        x = wav[:, None, :]
        if t % p:
            x = F.pad(x, (0, p - t % p), mode="reflect")
        x = x.view(b, 1, -1, p)
        fmap = []
        for conv in self.convs:
            x = _lrelu(conv(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class DiscriminatorS(nn.Module):
    """Scale sub-discriminator (reference models.py:206-233)."""

    def __init__(self, use_spectral_norm: bool, layers: Sequence[Conv1dSpec]):
        super().__init__()
        self.use_spectral_norm = use_spectral_norm
        conv = SNConv1d if use_spectral_norm else WNConvNCW
        convs, ci = [], 1
        for co, k, s, g, pad in layers:
            convs.append(conv(ci, co, k, s, g, pad))
            ci = co
        self.convs = nn.ModuleList(convs)
        self.conv_post = conv(ci, 1, 3, 1, 1, 1)

    def forward(self, wav: torch.Tensor, update_stats: bool = False):
        kw = {"update_stats": update_stats} if self.use_spectral_norm else {}
        x = wav[:, None, :]
        fmap = []
        for conv in self.convs:
            x = _lrelu(conv(x, **kw))
            fmap.append(x)
        x = self.conv_post(x, **kw)
        fmap.append(x)
        return x.flatten(1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, cfg: DiscriminatorConfig):
        super().__init__()
        self.discriminators = nn.ModuleList(
            DiscriminatorP(p, cfg.period_kernel_size, cfg.period_stride, cfg.period_channels)
            for p in cfg.periods)


class MultiScaleDiscriminator(nn.Module):
    """Scale 0 (spectral norm) on the waveform, scale i on it average-pooled
    i times (AvgPool1d(4, 2, padding=2), padding counted)."""

    def __init__(self, cfg: DiscriminatorConfig):
        super().__init__()
        self.discriminators = nn.ModuleList(
            DiscriminatorS(i == 0, cfg.scale_layers) for i in range(cfg.n_scales))


def avg_pool1d(x: torch.Tensor) -> torch.Tensor:
    """(B, T) -> (B, T//2 + 1): torch AvgPool1d(4, 2, padding=2) semantics."""
    return F.avg_pool1d(x[:, None, :], 4, 2, padding=2, count_include_pad=True)[:, 0]


class Discriminator(nn.Module):
    """MPD + MSD (reference pretrained_discriminator.py:21-40); topology from
    `DiscriminatorConfig` (defaults: the reference's 5 periods, 3 scales).

    `dtype` is the compute dtype: the waveforms are cast to it on entry and
    every conv follows the activations' dtype; the parameters (and the
    spectral norm's power iteration) stay f32, and the GAN losses below
    accumulate in f32."""

    def __init__(self, cfg: DiscriminatorConfig = DiscriminatorConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.mpd = MultiPeriodDiscriminator(cfg)
        self.msd = MultiScaleDiscriminator(cfg)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor, update_stats: bool = False):
        """y, y_hat: (B, T) waveforms. Returns (real_outs, fake_outs,
        real_fmaps, fake_fmaps) over all sub-discriminators, periods first.
        Each sub-discriminator sees y, then y_hat (two power iterations of
        the spectral norm per call with `update_stats`)."""
        y, y_hat = y.to(self.dtype), y_hat.to(self.dtype)
        real_outs: List[torch.Tensor] = []
        fake_outs: List[torch.Tensor] = []
        real_fmaps: List[List[torch.Tensor]] = []
        fake_fmaps: List[List[torch.Tensor]] = []

        def add(real, fake):
            real_outs.append(real[0])
            fake_outs.append(fake[0])
            real_fmaps.append(real[1])
            fake_fmaps.append(fake[1])

        for d in self.mpd.discriminators:
            add(d(y), d(y_hat))
        ys, yhs = y, y_hat
        for i, d in enumerate(self.msd.discriminators):
            if i:
                ys, yhs = avg_pool1d(ys), avg_pool1d(yhs)
            add(d(ys, update_stats), d(yhs, update_stats))
        return real_outs, fake_outs, real_fmaps, fake_fmaps


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """2 x the sum over every feature map of mean |real - fake|."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.float() - gl.float()))
    return loss * 2.0


def discriminator_loss(real_outs, fake_outs) -> torch.Tensor:
    """LSGAN D loss: sum of mean (1 - D(y))^2 + mean D(y_hat)^2."""
    loss = 0.0
    for dr, dg in zip(real_outs, fake_outs):
        loss = loss + (torch.mean((1.0 - dr.float()) ** 2) + torch.mean(dg.float() ** 2))
    return loss


def generator_loss(fake_outs) -> torch.Tensor:
    """LSGAN G loss: sum of mean (1 - D(y_hat))^2."""
    loss = 0.0
    for dg in fake_outs:
        loss = loss + torch.mean((1.0 - dg.float()) ** 2)
    return loss
