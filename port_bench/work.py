"""Frozen work counters: the model's operations per request, each MRF
kernel launch's operations and bytes, and the H100's published peaks.

An operation is one multiply or add of a matmul or a convolution (a
multiply-add counts 2), as `torch.utils.flop_counter` counts them; softmax,
normalisation and activations are not counted.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM, dense, at 700 W (data sheet)
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
TF32_TERMS = 3  # the f32 kernels' 3xTF32 split: three TF32 products per f32 one
PEAK_BYTES = 3.35e12


def peak_flops(dtype: str) -> float:
    """The peak a configuration's compute dtype is held to: bf16 on the
    tensor cores; f32 as the 3xTF32 split the port's f32 kernels run."""
    return {"bf16": PEAK_BF16, "f32": PEAK_TF32 / TF32_TERMS}[dtype]


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


# Which kernel serves which MRF stage: a residual-unit launch per unit where
# the stage has at least this many channels, one whole-stage launch below.
UNIT_MIN_CHANNELS = 128
KERNELS = {"resblock": "residual_unit_kernel", "mrf_stage": "mrf_stage_kernel"}


def mrf_launches(cfg: Dict, rows: int, frames: int, dtype: str) -> Dict[str, List[Tuple[int, int]]]:
    """The (operations, bytes) of each MRF kernel launch of one generator
    call over `rows` x `frames`: x read once and y written once, each
    weight and bias read once."""
    v = cfg["vocoder"]
    item = 2 if dtype == "bf16" else 4
    out: Dict[str, List[Tuple[int, int]]] = {"resblock": [], "mrf_stage": []}
    for c, t in stages(cfg, frames):
        units = [(k, d) for k, ds in zip(v["resblock_kernel_sizes"], v["resblock_dilation_sizes"])
                 for d in ds]
        act = 2 * rows * t * c
        if c >= UNIT_MIN_CHANNELS:
            for k, _ in units:
                out["resblock"].append((mrf_unit_flops(c, t, k, rows),
                                        item * (act + 2 * k * c * c + 2 * c)))
        else:
            out["mrf_stage"].append((sum(mrf_unit_flops(c, t, k, rows) for k, _ in units),
                                     item * (act + sum(2 * k * c * c + 2 * c for k, _ in units))))
    return out


def bound_seconds(flop: int, nbytes: int, dtype: str) -> float:
    """The least time the card could take: operations at the peak or bytes
    at the memory's rate, whichever is longer."""
    return max(flop / peak_flops(dtype), nbytes / PEAK_BYTES)
