"""HiFi-GAN V1 generator (counterpart of the generator half of
`emotivoice_tpu/models/hifigan.py`; reference `models/hifigan/models.py`).

Weight norm is an explicit (weight_g, weight_v) parametrisation with the
reference's keys and normalisation axes:
  - Conv1d weight (Co, Ci, K): norm per output channel;
  - ConvTranspose1d weight (Ci, Co, K): norm per *input* channel (torch's
    default-dim quirk, kept for parity).
Inference folds W = g * v / ||v|| at each call.

With `kernels=True` (serving, synthesis, validation) the MRF blocks run
through the port's hand-written kernels: a stage with C >= 128 sends each
residual unit through `fused_residual_unit` (3 ResBlock1 x 3 units = 9
launches), a stage with C < 128 sends the whole MRF through
`fused_mrf_stage` (1 launch). Why the split: a whole stage's 18 conv weights
are ~16.5 MB in bf16 at C=256, which no SM holds, while one unit's weights
stream through L2. On a CPU tensor the same calls take the kernels' plain
versions. The kernels have no backward (nor have the TPU kernels, which the
JAX package's training turns off with use_pallas / use_fused_stage), so the
trainer builds the generator with `kernels=False`: every ResBlock1 conv is
then a differentiable `WNConv1d`, the JAX package's default branch.
Activations are feature-last (B, T, C).

Over a model group (`parallel/tensor_parallel.py`) conv_pre and the
transposed convs become column-parallel layers, conv_post row-parallel and
each ResBlock1 a `ParallelResBlock1`; the generator's forward is the same.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from emotivoice_tpu_torch.config import VocoderConfig
from emotivoice_tpu_torch.ops.cuda.mrf_stage import fused_mrf_stage
from emotivoice_tpu_torch.ops.cuda.resblock import fused_residual_unit, lrelu
from emotivoice_tpu_torch.parallel.tensor_parallel import (
    ColumnParallel,
    RowParallel,
    as_group,
    conv1d,
    conv_transpose1d,
)

LRELU_SLOPE = 0.1
FUSED_UNIT_MIN_CHANNELS = 128  # C at or above: per-unit kernel; below: whole stage


def _norm_except_dim0(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())), keepdim=True))


class WeightNorm(nn.Module):
    """weight = weight_g * weight_v / ||weight_v|| (norm over all but dim 0)."""

    def __init__(self, v_shape: Sequence[int], n_out: int):
        super().__init__()
        self.weight_g = nn.Parameter(torch.ones(v_shape[0], *(1,) * (len(v_shape) - 1)))
        self.weight_v = nn.Parameter(torch.zeros(*v_shape))
        self.bias = nn.Parameter(torch.zeros(n_out))

    def folded(self) -> torch.Tensor:
        """Effective torch-layout weight with the norm baked in (f32)."""
        v = self.weight_v
        return self.weight_g * v / torch.clamp(_norm_except_dim0(v), min=1e-12)


class WNConv1d(WeightNorm):
    """Weight-normalised Conv1d over (B, T, C); 'same' padding by default."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int,
                 dilation: int = 1, padding=None):
        super().__init__((c_out, c_in, kernel_size), c_out)
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.padding = (kernel_size - 1) // 2 * dilation if padding is None else padding

    def folded_hio(self, dtype: torch.dtype) -> torch.Tensor:
        """Folded weight in HIO (K, Ci, Co) layout, contiguous, in `dtype`."""
        return self.folded().permute(2, 1, 0).to(dtype).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x.transpose(1, 2), self.folded().to(x.dtype),
                     padding=self.padding, dilation=self.dilation)
        return y.transpose(1, 2) + self.bias.to(x.dtype)

    def op(self):
        """This layer's function of (input, weight, bias), for its parallel versions."""
        return conv1d(self.padding, self.dilation)


class WNConvTranspose1d(WeightNorm):
    """Weight-normalised ConvTranspose1d over (B, T, C), torch semantics:
    out_len = (T-1)*stride - 2*padding + kernel_size."""

    out_dim = 1  # the weight's output-channel dim

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int,
                 padding: int):
        super().__init__((c_in, c_out, kernel_size), c_out)
        self.stride = stride
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose1d(x.transpose(1, 2), self.folded().to(x.dtype),
                               stride=self.stride, padding=self.padding)
        return y.transpose(1, 2) + self.bias.to(x.dtype)

    def op(self):
        return conv_transpose1d(self.stride, self.padding)


class ResBlock1(nn.Module):
    """MRF residual block (reference models.py:26-64): per dilation d,
    x = x + conv_{k,1}(lrelu(conv_{k,d}(lrelu(x)))), each unit one
    `fused_residual_unit` call, or with `kernels=False` two WNConv1d calls."""

    def __init__(self, channels: int, kernel_size: int, dilations: Sequence[int]):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, dilation=d) for d in dilations
        )
        self.convs2 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size) for _ in dilations
        )

    def unit_weights(self, dtype: torch.dtype):
        """Per unit: (w1_hio, b1, w2_hio, b2) in `dtype`, as the kernels take them."""
        return tuple(
            (c1.folded_hio(dtype), c1.bias.to(dtype).contiguous(),
             c2.folded_hio(dtype), c2.bias.to(dtype).contiguous())
            for c1, c2 in zip(self.convs1, self.convs2)
        )

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        if not kernels:
            for c1, c2 in zip(self.convs1, self.convs2):
                x = x + c2(lrelu(c1(lrelu(x))))
            return x
        x = x.contiguous()
        for d, (w1, b1, w2, b2) in zip(self.dilations, self.unit_weights(x.dtype)):
            x = fused_residual_unit(x, w1, b1, w2, b2, self.kernel_size, d)
        return x


class ParallelResBlock1(ResBlock1):
    """ResBlock1 over a model group (`parallel/tensor_parallel.py`): convs1
    column-parallel, convs2 row-parallel, parameters split at rest. With
    `kernels=False` (training) each unit runs both halves on the shards and
    reduces once, before the residual add. With `kernels=True` (serving,
    validation) the folded unit weights are gathered whole on every call,
    to the group's first device or, over ranks, to every rank (whose
    activations are replicated), and the MRF kernels run there on whole
    weights, as the JAX package's `pallas_call` does under a model axis."""

    def __init__(self, block: ResBlock1, group):
        nn.Module.__init__(self)
        self.kernel_size, self.dilations = block.kernel_size, block.dilations
        self.group = as_group(group)
        self.convs1 = nn.ModuleList(ColumnParallel(c, self.group) for c in block.convs1)
        self.convs2 = nn.ModuleList(RowParallel(c, self.group) for c in block.convs2)

    def unit_weights(self, dtype: torch.dtype):
        return tuple(
            (c1.folded_hio(dtype), c1.whole_bias(dtype), c2.folded_hio(dtype),
             c2.whole_bias(dtype))
            for c1, c2 in zip(self.convs1, self.convs2)
        )

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        if kernels:
            return super().forward(x, kernels)
        for c1, c2 in zip(self.convs1, self.convs2):
            hidden = c1.forward_shards(self.group.enter(lrelu(x)))
            x = x + c2.forward_partials([lrelu(h) for h in hidden])
        return x


class ResBlock2(nn.Module):
    """Lighter MRF variant (reference models.py:67-89), plain convs."""

    def __init__(self, channels: int, kernel_size: int, dilations: Sequence[int]):
        super().__init__()
        self.convs = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, dilation=d) for d in dilations
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = x + conv(F.leaky_relu(x, LRELU_SLOPE))
        return x


class HiFiGANGenerator(nn.Module):
    """Reference Generator (models.py:90-140). Input (B, T, n_mels) mel,
    output (B, T * prod(upsample_rates)) f32 waveform in (-1, 1).
    `kernels` picks the MRF's path: the hand-written kernels (inference
    only) or differentiable plain convs (training)."""

    def __init__(self, cfg: VocoderConfig, kernels: bool = True):
        super().__init__()
        self.cfg = cfg
        self.kernels = kernels
        c = cfg
        self.conv_pre = WNConv1d(c.initial_channel, c.upsample_initial_channel, 7, padding=3)
        self.ups = nn.ModuleList()
        blocks: List[nn.Module] = []
        block_cls = ResBlock1 if c.resblock == "1" else ResBlock2
        for i, (u, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            c_in = c.upsample_initial_channel // (2 ** i)
            c_out = c_in // 2
            self.ups.append(WNConvTranspose1d(c_in, c_out, k, u, (k - u) // 2))
            for rk, rd in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes):
                blocks.append(block_cls(c_out, rk, rd))
        self.resblocks = nn.ModuleList(blocks)
        self.conv_post = WNConv1d(c_out, 1, 7, padding=3)

    def _mrf(self, i: int, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        nk = len(c.resblock_kernel_sizes)
        blocks = self.resblocks[i * nk:(i + 1) * nk]
        if self.kernels and c.resblock == "1" and x.shape[-1] < FUSED_UNIT_MIN_CHANNELS:
            weights = tuple(b.unit_weights(x.dtype) for b in blocks)
            return fused_mrf_stage(x.contiguous(), weights, c.resblock_kernel_sizes,
                                   c.resblock_dilation_sizes)
        kw = {"kernels": self.kernels} if c.resblock == "1" else {}
        acc = None
        for block in blocks:
            r = block(x, **kw)
            acc = r if acc is None else acc + r
        return acc / nk

    def forward(self, mel: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        x = self.conv_pre(mel.to(dtype))
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, self.cfg.lrelu_slope))
            x = self._mrf(i, x)
        # The reference's final activation uses torch's default slope 0.01
        # (models.py:133).
        y = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(y.float())[..., 0]
