"""Plain PyTorch inference forward of EmotiVoice's acoustic model feeding
the BigVGAN-v2 generator (github.com/NVIDIA/BigVGAN `bigvgan.py`,
`activations.py`, `alias_free_activation/torch/{act,filter,resample}.py`;
arXiv:2206.04658), written from the model's math for the benchmark's check,
and what else the benchmark reads of the model (the contract of
port_bench/README.md).

The acoustic model, the durations, the control's precisions and the
duration calibration's layer are `model.py`'s, unchanged. Only the vocoder
is this file's: a state dict with upstream's keys under `generator.`
(weight norm as `weight_g` / `weight_v`), a configuration as the plain dict
of the benchmark's configuration file. It imports nothing of the program
under test and uses no kernel: one utterance at a time, float32 with TF32
off unless a lower `Precision` is asked for.

  x = conv_pre(mel)                                   80 -> C0, k 7
  per stage i: x = ups[i](x)                          transposed conv, stride u_i
               x = mean_j AMPBlock1_{i,j}(x)          k in (3, 7, 11)
  AMPBlock1:   per dilation d_m: x = x + convs2_m(act(convs1_m(act(x))))
  wav = clamp(conv_post(act(x)), -1, 1)               no bias, no tanh
  act(x) per channel: replicate-pad 5, u = 2 conv_transpose1d(x, f, stride
    2), 15 samples cut from each end; s = u + sin^2(e^alpha u) / (e^beta +
    1e-9); replicate-pad 5 left and 6 right, y = conv1d(s, f, stride 2).
  f: 12-tap Kaiser-windowed sinc, cutoff 0.25, half width 0.3, sum 1.

Departures from upstream, each shared with the served program or the
benchmark's draw:
- weights are drawn from the seed (`init`) so that the signal keeps near
  unit rms through the six stages, as a trained generator's does: weight_v
  N(0, gain^2 / fan_in) with gain 1 for conv_pre and the transposed convs,
  `amp_conv_gain` for the AMP blocks' convs and `conv_post_gain` for
  conv_post (so that the clamp touches few samples); weight-norm g = ||v||
  (`fixed`); biases 0. Upstream's `init_weights` asks N(0, 0.01^2) of the
  transposed and AMP convs, which shrinks the signal ~1e4-fold over the
  stages to a near-silent waveform where SnakeBeta's sine is idle; at gain
  1 the residual sums grow it to rms ~15 before conv_post, where bf16's
  rounding of the sine's argument alone moves the waveform 10%;
- log-scale alpha and beta N(0, snake_log_std^2) per channel where upstream
  starts both at 0, so that a kernel that mixes channels fails the check;
- the mel is zeroed past the utterance and the acoustic model masked there,
  as `model.py` says (bucketed batched synthesis);
- the control (`Precision("fp8")`) rounds the operands of the learned
  convolutions; the activations' fixed filters stay f32.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference.model import (  # noqa: F401  (the contract's names)
    DURATION_OUT,
    Precision,
    acoustic,
    acoustic_flops,
    fan_in,
    stages,
    to_durations,
)
from port_bench.reference import model

TAPS = 12
RATIO = 2
ACT_FLOPS = 58  # operations an activation spends a sample of one channel (`act_flops`)


def _vocoder_v(cfg: Dict):
    v = cfg["vocoder"]
    c0 = v["upsample_initial_channel"]
    return v, c0, len(v["resblock_kernel_sizes"])


def activations(cfg: Dict):
    """(key prefix, channels) of every Activation1d of the generator, in
    call order: per stage, its AMPBlock1s' 2 per dilation, then
    activation_post."""
    v, c0, nk = _vocoder_v(cfg)
    out = []
    for i in range(len(v["upsample_rates"])):
        c = c0 // 2 ** (i + 1)
        for j, rd in enumerate(v["resblock_dilation_sizes"]):
            out += [(f"generator.resblocks.{i * nk + j}.activations.{a}", c)
                    for a in range(2 * len(rd))]
    return out + [("generator.activation_post", c0 // 2 ** len(v["upsample_rates"]))]


def param_shapes(cfg: Dict) -> Dict[str, tuple]:
    """Every tensor of the inference state dict, by key, with its shape:
    `model.py`'s acoustic model and BigVGAN-v2's generator, the filter
    buffers included."""
    out = {k: s for k, s in model.param_shapes(cfg).items() if not k.startswith("generator.")}
    v, c0, nk = _vocoder_v(cfg)

    def wn(prefix, v_shape, bias=True):
        out[f"{prefix}.weight_g"] = (v_shape[0],) + (1,) * (len(v_shape) - 1)
        out[f"{prefix}.weight_v"] = tuple(v_shape)
        if bias:
            out[f"{prefix}.bias"] = (v_shape[1] if ".ups." in prefix else v_shape[0],)

    wn("generator.conv_pre", (c0, v["initial_channel"], 7))
    for i, (u, k) in enumerate(zip(v["upsample_rates"], v["upsample_kernel_sizes"])):
        ci = c0 // 2 ** i
        co = ci // 2
        wn(f"generator.ups.{i}.0", (ci, co, k))
        for j, (rk, rd) in enumerate(zip(v["resblock_kernel_sizes"], v["resblock_dilation_sizes"])):
            p = f"generator.resblocks.{i * nk + j}"
            for m in range(len(rd)):
                wn(f"{p}.convs1.{m}", (co, co, rk))
                wn(f"{p}.convs2.{m}", (co, co, rk))
    for p, c in activations(cfg):
        out[f"{p}.act.alpha"] = (c,)
        out[f"{p}.act.beta"] = (c,)
        out[f"{p}.upsample.filter"] = (1, 1, TAPS)
        out[f"{p}.downsample.lowpass.filter"] = (1, 1, TAPS)
    wn("generator.conv_post", (1, co, 7), bias=v["use_bias_at_final"])
    return out


def kaiser_sinc_filter(cutoff: float = 0.5 / RATIO, half_width: float = 0.6 / RATIO,
                       kernel_size: int = TAPS) -> torch.Tensor:
    """Upstream's `kaiser_sinc_filter1d` for an even kernel: sample times
    -6.5 ... 5.5 + 1, a non-periodic Kaiser window of beta from the
    attenuation A = 2.285 (half - 1) pi 4 half_width + 7.95 (above 50 here:
    beta = 0.1102 (A - 8.7)), 2 cutoff sinc(2 cutoff t), normalised to sum 1."""
    half = kernel_size // 2
    a = 2.285 * (half - 1) * math.pi * 4 * half_width + 7.95
    beta = 0.1102 * (a - 8.7) if a > 50.0 else (
        0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0) if a >= 21.0 else 0.0)
    window = torch.kaiser_window(kernel_size, periodic=False, beta=beta, dtype=torch.float32)
    t = torch.arange(-half, half, dtype=torch.float32) + 0.5
    f = 2 * cutoff * window * torch.sinc(2 * cutoff * t)
    return (f / f.sum()).view(1, 1, kernel_size)


def init(key: str, shape: tuple, cfg: Dict) -> Tuple[float, float]:
    """(scale, offset) of one tensor of `param_shapes`, drawn as offset +
    scale x N(0, 1): the acoustic model by `model.init`; the generator's
    weight_v N(0, gain^2 / fan_in) (gain `amp_conv_gain` in the AMP blocks,
    `conv_post_gain` in conv_post, else 1), biases 0, alpha and beta
    N(0, snake_log_std^2); weight_g and the filters are left to `fixed`."""
    if not key.startswith("generator."):
        return model.init(key, shape, cfg)
    drawn = cfg["assumed"]["vocoder_init"]
    leaf = key.rsplit(".", 1)[1]
    if leaf in ("alpha", "beta"):
        return drawn["snake_log_std"], 0.0
    if leaf == "weight_v":
        if key == "generator.conv_post.weight_v":
            gain = drawn["conv_post_gain"]
        elif ".convs" in key:
            gain = drawn["amp_conv_gain"]
        else:
            gain = 1.0
        return gain / math.sqrt(fan_in(key, shape, cfg)), 0.0
    return 0.0, 0.0  # bias, weight_g, filter


def fixed(sd: Dict[str, torch.Tensor], cfg: Dict) -> None:
    """Sets in place what the draw leaves: weight-norm g = ||v|| (so the
    folded weight is v) and the filters' taps."""
    model.fixed(sd, cfg)
    taps = None
    for k, t in sd.items():
        if k.endswith(".filter"):
            if taps is None:
                taps = kaiser_sinc_filter().to(t.device)
            t.copy_(taps)


def act(x: torch.Tensor, sd, p: str) -> torch.Tensor:
    """Activation1d(SnakeBeta) over (B, T, C), in f32."""
    c = x.shape[2]
    fu = sd[f"{p}.upsample.filter"].expand(c, 1, TAPS)
    fd = sd[f"{p}.downsample.lowpass.filter"].expand(c, 1, TAPS)
    pad = TAPS // RATIO - 1
    cut = pad * RATIO + (TAPS - RATIO) // 2
    h = F.pad(x.transpose(1, 2), (pad, pad), mode="replicate")
    u = RATIO * F.conv_transpose1d(h, fu, stride=RATIO, groups=c)
    u = u[..., cut:u.shape[-1] - cut]
    alpha = torch.exp(sd[f"{p}.act.alpha"])[:, None]
    beta = torch.exp(sd[f"{p}.act.beta"])[:, None]
    s = u + (1.0 / (beta + 1e-9)) * torch.sin(u * alpha) ** 2
    s = F.pad(s, (TAPS // 2 - 1, TAPS // 2), mode="replicate")
    return F.conv1d(s, fd, stride=RATIO, groups=c).transpose(1, 2)


def vocoder(sd, cfg, mel, pr: Precision = Precision()):
    """BigVGAN-v2 generator: mel (B, T, n_mels) -> waveform (B, T * hop)."""
    v, _, nk = _vocoder_v(cfg)
    g = "generator"
    x = model._conv(mel, model._wn(sd, f"{g}.conv_pre"), sd[f"{g}.conv_pre.bias"], pr, padding=3)
    for i, (u, k) in enumerate(zip(v["upsample_rates"], v["upsample_kernel_sizes"])):
        p = f"{g}.ups.{i}.0"
        x = F.conv_transpose1d(pr.q(x.transpose(1, 2)), pr.q(model._wn(sd, p)), sd[f"{p}.bias"],
                               stride=u, padding=(k - u) // 2).transpose(1, 2)
        acc = None
        for j, (rk, rd) in enumerate(zip(v["resblock_kernel_sizes"], v["resblock_dilation_sizes"])):
            p = f"{g}.resblocks.{i * nk + j}"
            y = x
            for m, d in enumerate(rd):
                h = model._conv(act(y, sd, f"{p}.activations.{2 * m}"),
                                model._wn(sd, f"{p}.convs1.{m}"), sd[f"{p}.convs1.{m}.bias"], pr,
                                dilation=d)
                y = y + model._conv(act(h, sd, f"{p}.activations.{2 * m + 1}"),
                                    model._wn(sd, f"{p}.convs2.{m}"), sd[f"{p}.convs2.{m}.bias"], pr)
            acc = y if acc is None else acc + y
        x = acc / nk
    y = model._conv(act(x, sd, f"{g}.activation_post"), model._wn(sd, f"{g}.conv_post"),
              sd.get(f"{g}.conv_post.bias"), pr, padding=3)
    y = torch.tanh(y) if v["use_tanh_at_final"] else torch.clamp(y, -1.0, 1.0)
    return y[..., 0]


@torch.no_grad()
def synthesize(sd, cfg, tokens, length, speaker, style, content, max_frames, alpha=1.0,
               durations=None, precision: str = "f32"):
    """One utterance through both models; the acoustic outputs and `wav`
    (1, max_frames * hop)."""
    pr = Precision(precision)
    with pr.flags():
        out = acoustic(sd, cfg, tokens, length, speaker, style, content, max_frames, alpha,
                       durations, pr)
        out["wav"] = vocoder(sd, cfg, out["mel"], pr)
    return out


# ---------------------------------------------------------------------------
# Work counters, as `model.py` counts them: a multiply-add is 2 operations.

def act_flops(c: int, t: int) -> int:
    """One activation over t samples of c channels, per input sample: the
    x2 up filter 2 outputs x 6 taps x 2 = 24, the snake on 2 samples
    (multiply, sine, square, multiply, add) 10, the down filter 12 taps x 2
    = 24: ACT_FLOPS = 58."""
    return ACT_FLOPS * c * t


def vocoder_flops(cfg: Dict, n_frames: int) -> int:
    """conv_pre, each transposed conv (each input meets k taps), the AMP
    blocks' convolutions (two of kernel k over C -> C per dilation, 4 k C^2
    t), conv_post, and every activation's filters and snake."""
    v, c0, _ = _vocoder_v(cfg)
    out = 2 * n_frames * 7 * v["initial_channel"] * c0
    t_in, c_in = n_frames, c0
    for (c, t), k in zip(stages(cfg, n_frames), v["upsample_kernel_sizes"]):
        out += 2 * t_in * k * c_in * c
        out += sum(model.mrf_unit_flops(c, t, rk) * len(rd)
                   for rk, rd in zip(v["resblock_kernel_sizes"], v["resblock_dilation_sizes"]))
        out += sum(act_flops(c, t) * 2 * len(rd) for rd in v["resblock_dilation_sizes"])
        t_in, c_in = t, c
    return out + act_flops(c_in, t_in) + 2 * t_in * 7 * c_in


def request_flops(cfg: Dict, n_tokens: int, n_frames: int) -> int:
    """The model's operations for one request at its own tokens and frames,
    no padding."""
    return acoustic_flops(cfg, n_tokens, n_frames) + vocoder_flops(cfg, n_frames)
