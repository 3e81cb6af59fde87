"""Plain PyTorch inference forward of the released EmotiVoice model: the
PromptTTS acoustic model (github.com/netease-youdao/EmotiVoice,
models/prompt_tts_modified/model_open_source.py) and the HiFi-GAN V1
generator (jik876/hifi-gan models.py), written from the model's math for
the benchmark's check; its end holds what else the benchmark reads of it.

It reads a state dict with the upstream checkpoint's keys (`am.*`,
`generator.*`) and a configuration as the plain dict of the benchmark's
configuration file. It imports nothing of the program under test and uses
no kernel, cache, bucket program or batching: one utterance at a time, in
float32 with TF32 off unless a lower `Precision` is asked for (the
benchmark's control).

Inference as served: the text is padded to the engine's text bucket with
token 0, the mel to its frame bucket; masks are valid masks (True = real).
Departures from upstream that the served program shares: the decoder is
masked past the utterance (batched bucketed synthesis needs it), and the
mel is zeroed there before the vocoder.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30
LN_EPS = 1e-12
FP8_MAX = 448.0  # largest finite float8_e4m3fn


class Precision:
    """How the matrix products run. "f32": float32, TF32 off. "tf32": the
    tensor cores' TF32 for matmuls and convolutions. "fp8": every operand of
    a matmul or convolution rounded to float8 e4m3 with a per-tensor scale,
    the product taken in float32."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.name != "fp8":
            return t
        amax = t.detach().abs().max().clamp(min=1e-30)
        s = FP8_MAX / amax
        return (t * s).to(torch.float8_e4m3fn).to(torch.float32) / s

    @contextlib.contextmanager
    def flags(self):
        mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        tf32 = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = mm
            torch.backends.cudnn.allow_tf32 = cd


def param_shapes(cfg: Dict) -> Dict[str, tuple]:
    """Every parameter of the inference checkpoint, by key, with its shape
    (the alignment module's, which training alone uses, included)."""
    a, v = cfg["am"], cfg["vocoder"]
    h, e = a["hidden"], a["bert_embedding"]
    out: Dict[str, tuple] = {
        "am.src_word_emb.weight": (a["n_vocab"], h),
        "am.spk_tokenizer.weight": (a["n_speaker"], h),
    }
    for side in ("encoder", "decoder"):
        p = f"am.{side}"
        k = a[f"{side}_kernel_size"]
        out[f"{p}.embed.0.alpha"] = ()
        for i in range(a[f"{side}_n_layers"]):
            li = f"{p}.encoders.{i}"
            for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
                out[f"{li}.self_attn.{name}.weight"] = (h, h)
                out[f"{li}.self_attn.{name}.bias"] = (h,)
            out[f"{li}.feed_forward.w_1.weight"] = (4 * h, h, k)
            out[f"{li}.feed_forward.w_1.bias"] = (4 * h,)
            out[f"{li}.feed_forward.w_2.weight"] = (h, 4 * h, k)
            out[f"{li}.feed_forward.w_2.bias"] = (h,)
            for n in ("norm1", "norm2"):
                out[f"{li}.{n}.weight"] = (h,)
                out[f"{li}.{n}.bias"] = (h,)
        out[f"{p}.after_norm.weight"] = (h,)
        out[f"{p}.after_norm.bias"] = (h,)
    out["am.embed_projection1.weight"] = (h, 2 * h + 2 * e)
    out["am.embed_projection1.bias"] = (h,)
    vh = a["variance_n_hidden"]
    for name, n_layers, k in (
            ("duration_predictor", a["duration_n_layers"], a["duration_kernel_size"]),
            ("pitch_predictor", a["variance_n_layers"], a["variance_kernel_size"]),
            ("energy_predictor", a["energy_n_layers"], a["energy_kernel_size"])):
        for i in range(n_layers):
            out[f"am.{name}.conv.{i}.0.weight"] = (vh, h if i == 0 else vh, k)
            out[f"am.{name}.conv.{i}.0.bias"] = (vh,)
            out[f"am.{name}.conv.{i}.2.weight"] = (vh,)
            out[f"am.{name}.conv.{i}.2.bias"] = (vh,)
        out[f"am.{name}.linear.weight"] = (1, vh)
        out[f"am.{name}.linear.bias"] = (1,)
    for name in ("pitch_embed", "energy_embed"):
        out[f"am.{name}.0.weight"] = (h, 1, a["variance_embed_kernel_size"])
        out[f"am.{name}.0.bias"] = (h,)
    for name, ci, k in (("t_conv1", h, 3), ("t_conv2", h, 1), ("f_conv1", a["n_mels"], 3),
                        ("f_conv2", h, 3), ("f_conv3", h, 1)):
        out[f"am.alignment_module.{name}.weight"] = (h, ci, k)
        out[f"am.alignment_module.{name}.bias"] = (h,)
    out["am.to_mel.weight"] = (a["n_mels"], h)
    out["am.to_mel.bias"] = (a["n_mels"],)

    def wn(prefix, v_shape, n_out):
        out[f"{prefix}.weight_g"] = (v_shape[0],) + (1,) * (len(v_shape) - 1)
        out[f"{prefix}.weight_v"] = tuple(v_shape)
        out[f"{prefix}.bias"] = (n_out,)

    c0 = v["upsample_initial_channel"]
    wn("generator.conv_pre", (c0, v["initial_channel"], 7), c0)
    nb = 0
    for i, (u, k) in enumerate(zip(v["upsample_rates"], v["upsample_kernel_sizes"])):
        ci = c0 // 2 ** i
        co = ci // 2
        wn(f"generator.ups.{i}", (ci, co, k), co)
        for rk, rd in zip(v["resblock_kernel_sizes"], v["resblock_dilation_sizes"]):
            for j in range(len(rd)):
                wn(f"generator.resblocks.{nb}.convs1.{j}", (co, co, rk), co)
                wn(f"generator.resblocks.{nb}.convs2.{j}", (co, co, rk), co)
            nb += 1
    wn("generator.conv_post", (1, co, 7), 1)
    return out


def _layer_norm(x, sd, p):
    return F.layer_norm(x, (x.shape[-1],), sd[f"{p}.weight"], sd[f"{p}.bias"], LN_EPS)


def _linear(x, sd, p, pr):
    return F.linear(pr.q(x), pr.q(sd[f"{p}.weight"]), sd[f"{p}.bias"])


def _conv(x, w, b, pr, dilation=1, padding=None):
    """Conv1d over (B, T, C) with 'same' padding (k-1)//2*d by default."""
    k = w.shape[-1]
    pad = (k - 1) // 2 * dilation if padding is None else padding
    y = F.conv1d(pr.q(x.transpose(1, 2)), pr.q(w), b, padding=pad, dilation=dilation)
    return y.transpose(1, 2)


def _sinusoid(t: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(t, dtype=torch.float64, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float64, device=device)
                    * -(math.log(10000.0) / d))
    pe = torch.zeros(t, d, dtype=torch.float64, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(torch.float32)


def _encoder(x, valid, sd, p, n_layers, n_heads, pr):
    """ESPnet pre-LN transformer: x + alpha * PE, blocks of masked
    self-attention and a conv FFN (k, exact GELU), a final LayerNorm."""
    b, t, d = x.shape
    x = x + sd[f"{p}.embed.0.alpha"] * _sinusoid(t, d, x.device)[None]
    dk = d // n_heads
    key_ok = valid[:, None, None, :]
    for i in range(n_layers):
        li = f"{p}.encoders.{i}"
        h = _layer_norm(x, sd, f"{li}.norm1")

        def heads(name):
            return _linear(h, sd, f"{li}.self_attn.{name}", pr).view(b, t, n_heads, dk).transpose(1, 2)

        q, k, v = heads("linear_q"), heads("linear_k"), heads("linear_v")
        scores = torch.matmul(pr.q(q), pr.q(k).transpose(-1, -2)) / math.sqrt(dk)
        attn = torch.softmax(scores.masked_fill(~key_ok, NEG_INF), dim=-1).masked_fill(~key_ok, 0.0)
        o = torch.matmul(pr.q(attn), pr.q(v)).transpose(1, 2).reshape(b, t, d)
        x = x + _linear(o, sd, f"{li}.self_attn.linear_out", pr)
        h = _layer_norm(x, sd, f"{li}.norm2")
        h = _conv(h, sd[f"{li}.feed_forward.w_1.weight"], sd[f"{li}.feed_forward.w_1.bias"], pr)
        h = F.gelu(h, approximate="none")
        x = x + _conv(h, sd[f"{li}.feed_forward.w_2.weight"], sd[f"{li}.feed_forward.w_2.bias"], pr)
    return _layer_norm(x, sd, f"{p}.after_norm")


def _predictor(x, valid, sd, p, n_layers, pr):
    """n x (conv -> ReLU -> LayerNorm), then a linear to one value a token."""
    x = x * valid[..., None]
    for i in range(n_layers):
        x = _conv(x, sd[f"{p}.conv.{i}.0.weight"], sd[f"{p}.conv.{i}.0.bias"], pr)
        x = _layer_norm(torch.relu(x), sd, f"{p}.conv.{i}.2")
    return _linear(x, sd, f"{p}.linear", pr)[..., 0] * valid


def to_durations(log_d: torch.Tensor) -> torch.Tensor:
    """Frames a token: clamp(round(exp(log_d) - 1), 0), round half to even."""
    return torch.clamp(torch.round(torch.exp(log_d.float()) - 1.0), min=0.0)


def _upsample(hs, ds, valid, max_frames, delta, alpha, pr):
    """Gaussian upsampling into `max_frames` (upstream GaussianUpsampling):
    centre c_n = cumsum(d)_n - d_n / 2, weights softmax_n(-delta (t - c_n)^2),
    frames past sum(d) masked. Returns (frames, n_frames)."""
    vf = valid.float()
    ds = ds.float() * alpha * vf
    degenerate = ds.sum(dim=1) <= 0
    ds = torch.where(degenerate[:, None], vf, ds)
    n_frames = torch.clamp(ds.sum(dim=1).to(torch.int64), min=1, max=max_frames)
    fvalid = torch.arange(max_frames, device=hs.device)[None, :] < n_frames[:, None]
    t = torch.arange(max_frames, device=hs.device, dtype=torch.float32)[None, :] * fvalid.float()
    c = torch.cumsum(ds, dim=1) - ds / 2.0
    energy = (-delta * (t[:, :, None] - c[:, None, :]) ** 2).masked_fill(~valid[:, None, :], NEG_INF)
    w = torch.softmax(energy, dim=2)
    return torch.bmm(pr.q(w), pr.q(hs)) * fvalid[..., None].float(), n_frames, fvalid


def acoustic(sd, cfg, tokens, length, speaker, style, content, max_frames, alpha=1.0,
             durations: Optional[torch.Tensor] = None, pr: Precision = Precision()):
    """Text (1, t_text) padded with token 0 -> log durations, durations,
    n_frames and the (1, max_frames, n_mels) mel. `durations` given: the
    upsampler takes them instead of its own (the served program's, to check
    what follows them)."""
    a = cfg["am"]
    t_text = tokens.shape[1]
    valid = torch.arange(t_text, device=tokens.device)[None, :] < length[:, None]
    x = F.embedding(tokens, sd["am.src_word_emb.weight"])
    x = _encoder(x, valid, sd, "am.encoder", a["encoder_n_layers"], a["encoder_n_heads"], pr)
    spk = F.embedding(speaker, sd["am.spk_tokenizer.weight"])
    b = tokens.shape[0]

    def tile(e):
        return e[:, None, :].expand(b, t_text, e.shape[-1])

    x = _linear(torch.cat([x, tile(spk), tile(style), tile(content)], dim=-1), sd,
                "am.embed_projection1", pr)
    p_out = _predictor(x, valid, sd, "am.pitch_predictor", a["variance_n_layers"], pr)
    e_out = _predictor(x, valid, sd, "am.energy_predictor", a["energy_n_layers"], pr)
    log_d = _predictor(x, valid, sd, "am.duration_predictor", a["duration_n_layers"], pr)
    own = to_durations(log_d) * valid.float()
    ds = own if durations is None else durations.float()
    for name, track in (("pitch_embed", p_out), ("energy_embed", e_out)):
        x = x + _conv(track[..., None], sd[f"am.{name}.0.weight"], sd[f"am.{name}.0.bias"], pr)
    x, n_frames, fvalid = _upsample(x, ds, valid, max_frames, a["upsample_delta"], alpha, pr)
    x = _encoder(x, fvalid, sd, "am.decoder", a["decoder_n_layers"], a["decoder_n_heads"], pr)
    mel = _linear(x, sd, "am.to_mel", pr) * fvalid[..., None].float()
    return {"log_d": log_d, "durations": ds, "own_durations": own, "n_frames": n_frames,
            "mel": mel}


def _wn(sd, p):
    """Weight-norm fold g * v / ||v||, the norm over all dims but the first."""
    v = sd[f"{p}.weight_v"]
    norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())), keepdim=True))
    return sd[f"{p}.weight_g"] * v / torch.clamp(norm, min=1e-12)


def vocoder(sd, cfg, mel, pr: Precision = Precision()):
    """HiFi-GAN V1 generator: mel (B, T, n_mels) -> waveform (B, T * hop)."""
    v = cfg["vocoder"]
    slope = v["lrelu_slope"]
    x = _conv(mel, _wn(sd, "generator.conv_pre"), sd["generator.conv_pre.bias"], pr, padding=3)
    nk = len(v["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(v["upsample_rates"], v["upsample_kernel_sizes"])):
        p = f"generator.ups.{i}"
        x = F.leaky_relu(x, slope)
        x = F.conv_transpose1d(pr.q(x.transpose(1, 2)), pr.q(_wn(sd, p)), sd[f"{p}.bias"],
                               stride=u, padding=(k - u) // 2).transpose(1, 2)
        acc = None
        for j, (rk, rd) in enumerate(zip(v["resblock_kernel_sizes"], v["resblock_dilation_sizes"])):
            p = f"generator.resblocks.{i * nk + j}"
            y = x
            for n, d in enumerate(rd):
                h = _conv(F.leaky_relu(y, slope), _wn(sd, f"{p}.convs1.{n}"),
                          sd[f"{p}.convs1.{n}.bias"], pr, dilation=d)
                y = y + _conv(F.leaky_relu(h, slope), _wn(sd, f"{p}.convs2.{n}"),
                              sd[f"{p}.convs2.{n}.bias"], pr)
            acc = y if acc is None else acc + y
        x = acc / nk
    # upstream's last activation takes torch's default slope, 0.01
    y = _conv(F.leaky_relu(x, 0.01), _wn(sd, "generator.conv_post"),
              sd["generator.conv_post.bias"], pr, padding=3)
    return torch.tanh(y)[..., 0]


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
# What the benchmark reads of this model through the configuration file's
# "reference" key (port_bench/spec.py `reference`; the contract is listed in
# port_bench/README.md): how the seeded weights are drawn and the model's
# operations a request.

DURATION_OUT = "am.duration_predictor.linear"  # its bias is the duration calibration's


def fan_in(key: str, shape: tuple, cfg: Dict) -> int:
    if key.startswith("generator.ups.") and key.endswith("weight_v"):
        stride = cfg["vocoder"]["upsample_rates"][int(key.split(".")[2])]
        return shape[0] * shape[2] // stride  # (Ci, Co, K): inputs that reach an output
    return math.prod(shape[1:])


def init(key: str, shape: tuple, cfg: Dict) -> Tuple[float, float]:
    """(scale, offset) of one tensor of `param_shapes`: it is drawn as
    offset + scale x N(0, 1). Embeddings N(0, 1), every other weight
    N(0, 1 / fan_in), biases 0, LayerNorm scales and the positional scales
    1; weight-norm g is left to `fixed`. The duration predictor's output
    weight spreads log durations by about the configuration's
    `assumed.durations.log_scale`."""
    leaf = key.rsplit(".", 1)[1]
    if leaf == "bias" or leaf == "weight_g":
        s, o = 0.0, 0.0  # weight_g is set from weight_v by `fixed`
    elif len(shape) <= 1:
        s, o = 0.0, 1.0  # LayerNorm scale, positional alpha
    elif key in ("am.src_word_emb.weight", "am.spk_tokenizer.weight"):
        s, o = 1.0, 0.0
    else:
        s, o = 1.0 / math.sqrt(fan_in(key, shape, cfg)), 0.0
    if key == f"{DURATION_OUT}.weight":
        s = cfg["assumed"]["durations"]["log_scale"] / math.sqrt(shape[1])
    return s, o


def fixed(sd: Dict[str, torch.Tensor], cfg: Dict) -> None:
    """Sets in place the tensors the draw leaves: weight-norm g = ||v||, the
    upstream initialisation's fold."""
    for k in sd:
        if k.endswith("weight_g"):
            v = sd[k[: -len("g")] + "v"]
            sd[k].copy_(torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())), keepdim=True)))


# Work counters. An operation is one multiply or add of a matmul or a
# convolution (a multiply-add counts 2), as `torch.utils.flop_counter` counts
# them; softmax, normalisation and activations are not counted.

def _encoder_flops(t: int, d: int, n_layers: int, k: int) -> int:
    """Per layer: q, k, v, out projections 8 t d^2; scores and weighted sum
    4 t^2 d; the conv FFN d -> 4d -> d at kernel k, 16 k t d^2."""
    return n_layers * (8 * t * d * d + 4 * t * t * d + 16 * k * t * d * d)


def acoustic_flops(cfg: Dict, n_tokens: int, n_frames: int) -> int:
    a = cfg["am"]
    t, f, d, vh = n_tokens, n_frames, a["hidden"], a["variance_n_hidden"]
    out = _encoder_flops(t, d, a["encoder_n_layers"], a["encoder_kernel_size"])
    out += 2 * t * (2 * d + 2 * a["bert_embedding"]) * d  # embed_projection1
    for n_layers, k in ((a["duration_n_layers"], a["duration_kernel_size"]),
                        (a["variance_n_layers"], a["variance_kernel_size"]),
                        (a["energy_n_layers"], a["energy_kernel_size"])):
        out += 2 * t * k * d * vh + (n_layers - 1) * 2 * t * k * vh * vh + 2 * t * vh
    out += 2 * 2 * t * a["variance_embed_kernel_size"] * d  # pitch and energy embeddings
    out += 2 * f * t * d  # Gaussian upsampling's weighted sum
    out += _encoder_flops(f, d, a["decoder_n_layers"], a["decoder_kernel_size"])
    out += 2 * f * d * a["n_mels"]  # to_mel
    return out


def stages(cfg: Dict, frames: int) -> List[Tuple[int, int]]:
    """(channels, length) of each MRF stage for `frames` mel frames."""
    v = cfg["vocoder"]
    out, t = [], frames
    for i, u in enumerate(v["upsample_rates"]):
        t *= u
        out.append((v["upsample_initial_channel"] // 2 ** (i + 1), t))
    return out


def mrf_unit_flops(c: int, t: int, k: int, rows: int = 1) -> int:
    """One residual unit: two convs of kernel k over C -> C."""
    return 4 * k * c * c * rows * t


def vocoder_flops(cfg: Dict, n_frames: int) -> int:
    v = cfg["vocoder"]
    c0 = v["upsample_initial_channel"]
    out = 2 * n_frames * 7 * v["initial_channel"] * c0  # conv_pre
    t_in, c_in = n_frames, c0
    for (c, t), k in zip(stages(cfg, n_frames), v["upsample_kernel_sizes"]):
        out += 2 * t_in * k * c_in * c  # transposed conv: each input meets k taps
        out += sum(mrf_unit_flops(c, t, rk) * len(rd)
                   for rk, rd in zip(v["resblock_kernel_sizes"], v["resblock_dilation_sizes"]))
        t_in, c_in = t, c
    return out + 2 * t_in * 7 * c_in  # conv_post


def request_flops(cfg: Dict, n_tokens: int, n_frames: int) -> int:
    """The model's operations for one request at its own tokens and frames,
    no padding."""
    return acoustic_flops(cfg, n_tokens, n_frames) + vocoder_flops(cfg, n_frames)

