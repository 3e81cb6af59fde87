"""BigVGAN-v2 as the port's second vocoder, on the CPU: the anti-aliased
SnakeBeta chain, the generator and the whole model served through the
engine, each against the benchmark's plain reference
(`port_bench/reference/bigvgan_v2.py`) on seeded weights; the state dict's
names; the default vocoder unchanged; the kernel's wrapper on a CUDA tensor
without a card. Tiny sizes, no JAX."""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from emotivoice_tpu_torch.config import VocoderConfig, tiny_test_config
from emotivoice_tpu_torch.frontend.tokens import TokenVocab
from emotivoice_tpu_torch.models.bigvgan import BigVGANGenerator
from emotivoice_tpu_torch.models.hifigan import HiFiGANGenerator
from emotivoice_tpu_torch.models.jets import JETSGenerator
from emotivoice_tpu_torch.ops.cuda import aa_snake
from emotivoice_tpu_torch.serving.engine import SynthesisEngine
from port_bench.reference import bigvgan_v2 as ref
from port_bench.reference import model as hifigan_ref

torch.set_num_threads(1)

# Two stages, 32 -> 16 -> 8 channels, the published kernels and dilations.
TINY = dict(activation="snakebeta", initial_channel=20, upsample_initial_channel=32,
            upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4), use_tanh_at_final=False,
            use_bias_at_final=False)
VOCODER_INIT = {"snake_log_std": 0.5, "amp_conv_gain": 0.5, "conv_post_gain": 0.2}


def _cfg():
    return tiny_test_config().replace(vocoder=VocoderConfig(**TINY))


def _as_file(cfg) -> dict:
    """The configuration in the benchmark's file form, as the reference reads it."""
    d = lambda x: json.loads(json.dumps(dataclasses.asdict(x)))  # noqa: E731
    return {"am": d(cfg.am), "vocoder": d(cfg.vocoder), "audio": d(cfg.audio),
            "assumed": {"durations": {"log_scale": 0.15}, "vocoder_init": VOCODER_INIT}}


def _state_dict(cfg, seed: int = 3):
    """The reference's seeded draw (`init`, then `fixed`), biases drawn too
    so that they take part."""
    f = _as_file(cfg)
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, shape in ref.param_shapes(f).items():
        scale, offset = ref.init(k, shape, f)
        sd[k] = torch.randn(shape, generator=gen) * scale + offset
    ref.fixed(sd, f)
    for k, t in sd.items():
        if k.startswith("generator.") and k.endswith(".bias"):
            t.copy_(0.1 * torch.randn(t.shape, generator=gen))
    return f, sd


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _direct_act(x, alpha_log, beta_log, f):
    """The activation from its equations, one sample at a time (numpy, f64):
    u[m] = 2 sum_i x[clamp(i)] f[m + 5 - 2i]; s = u + sin^2(e^a u) / (e^b +
    1e-9); y[q] = sum_k f[k] s[clamp(2q + k - 5)], clamps to the row's ends."""
    x = x.double().numpy()
    f = f.double().numpy().ravel()
    b, t, c = x.shape
    a = np.exp(alpha_log.double().numpy())
    ib = 1.0 / (np.exp(beta_log.double().numpy()) + 1e-9)
    u = np.zeros((b, 2 * t, c))
    for m in range(2 * t):
        for i in range(m // 2 - 3, m // 2 + 4):
            k = m + 5 - 2 * i
            if 0 <= k < 12:
                u[:, m] += 2 * f[k] * x[:, min(max(i, 0), t - 1)]
    s = u + ib * np.sin(a * u) ** 2
    y = np.zeros((b, t, c))
    for q in range(t):
        for k in range(12):
            y[:, q] += f[k] * s[:, min(max(2 * q + k - 5, 0), 2 * t - 1)]
    return torch.from_numpy(y)


def _act_operands(b, t, c, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = 3.0 * torch.randn(b, t, c, generator=gen)
    alpha_log, beta_log = (0.5 * torch.randn(c, generator=gen) for _ in range(2))
    taps = ref.kaiser_sinc_filter()
    return x, alpha_log, beta_log, taps


@pytest.mark.parametrize("t", [1, 2, 3, 5, 9, 37])
def test_plain_activation_follows_its_equations_at_both_edges(t):
    """The plain chain, the reference's and the equations written out agree
    at lengths shorter than the filters and at both replicate edges, with
    alpha and beta spread over the channels."""
    x, al, bl, taps = _act_operands(2, t, 3)
    want = _direct_act(x, al, bl, taps)
    plain = aa_snake.aa_snake_plain(x, al, bl, taps, taps)
    sd = {"p.upsample.filter": taps, "p.downsample.lowpass.filter": taps,
          "p.act.alpha": al, "p.act.beta": bl}
    assert _rel(plain.double(), want) <= 1e-6
    assert _rel(ref.act(x, sd, "p").double(), want) <= 1e-6


@pytest.mark.parametrize("t", [4095, 4097, 8203])
def test_plain_activation_matches_the_reference_past_tile_lengths(t):
    """Lengths about the kernel's tile (4096 outputs), channels with their
    own alpha and beta, bf16 in: the plain chain computes in f32 and
    rounds once."""
    x, al, bl, taps = _act_operands(2, t, 5, seed=1)
    sd = {"p.upsample.filter": taps, "p.downsample.lowpass.filter": taps,
          "p.act.alpha": al, "p.act.beta": bl}
    want = ref.act(x, sd, "p")
    assert _rel(aa_snake.aa_snake_plain(x, al, bl, taps, taps), want) <= 1e-6
    xb = x.bfloat16()
    got = aa_snake.aa_snake_plain(xb, al, bl, taps, taps)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref.act(xb.float(), sd, "p").bfloat16())
    # channels are not interchangeable: swapping two channels' alpha shows
    swapped = al.clone()
    swapped[[0, 1]] = al[[1, 0]]
    assert _rel(aa_snake.aa_snake_plain(x, swapped, bl, taps, taps), want) > 1e-3


def _kernel_walk(x, alpha_log, beta_log, taps, per: int, threads: int):
    """csrc/aa_snake.cu's tiling and walk in numpy (f64), at a tile of
    `threads` x `per` outputs: the staged x clamped to the row, the pair
    window, u[0] and u[2T - 1] put in where the padding of s repeats them."""
    b, t, c = x.shape
    rows = x.double().numpy().transpose(0, 2, 1).reshape(b * c, t)
    f = taps.double().numpy().ravel()
    fo, fe = 2 * f[10::-2], 2 * f[11::-2]  # u[2p + 1] from x[p - 2 + j], u[2p] from x[p - 3 + j]
    tile, last = per * threads, 2 * t - 1
    y = np.zeros_like(rows)
    for r in range(b * c):
        a = math.exp(float(alpha_log[r % c]))
        ib = 1.0 / (math.exp(float(beta_log[r % c])) + 1e-9)
        snake = lambda u: u + ib * math.sin(a * u) ** 2  # noqa: E731
        for q0 in range(0, t, tile):
            base = q0 - 6
            xs = rows[r, np.clip(np.arange(base, base + tile + 12), 0, t - 1)]

            def up_at(m):
                p = m >> 1
                if m & 1:
                    return float(fo @ xs[p - 2 - base:p + 4 - base])
                return float(fe @ xs[p - 3 - base:p + 3 - base])

            u_first = up_at(0) if q0 == 0 else 0.0
            u_last = up_at(last) if q0 + tile + 3 > t else 0.0
            for qa in range(q0, min(q0 + tile, t), per):
                xw = list(xs[qa - 6 - base:qa - base])
                sw = [0.0] * 12
                for step in range(per + 5):
                    p = qa - 3 + step
                    xw = xw[1:] + [xs[p + 3 - base]]
                    uo, ue = float(fo @ xw), float(fe @ xw)
                    uo = u_first if 2 * p + 1 < 0 else (u_last if 2 * p + 1 > last else uo)
                    ue = u_first if 2 * p + 2 < 0 else (u_last if 2 * p + 2 > last else ue)
                    sw = sw[2:] + [snake(uo), snake(ue)]
                    q = qa + step - 5
                    if step >= 5 and q < t:
                        y[r, q] = float(f @ np.array(sw))
    return torch.from_numpy(y.reshape(b, c, t).transpose(0, 2, 1).copy())


def _act_f64(x, alpha_log, beta_log, taps):
    """The reference's activation in float64."""
    sd = {"p.upsample.filter": taps.double(), "p.downsample.lowpass.filter": taps.double(),
          "p.act.alpha": alpha_log.double(), "p.act.beta": beta_log.double()}
    return ref.act(x.double(), sd, "p")


@pytest.mark.parametrize("t", [1, 2, 4, 5, 16, 17, 18, 19, 37, 64])
def test_kernel_walk_matches_the_plain_chain(t):
    """The kernel's index arithmetic at a tile of 4 threads x 4 outputs:
    tile seams, rows shorter than a tile or a thread's walk, both ends."""
    x, al, bl, taps = _act_operands(2, t, 3, seed=2)
    assert _rel(_kernel_walk(x, al, bl, taps, per=4, threads=4), _act_f64(x, al, bl, taps)) <= 1e-12


def test_kernel_walk_at_the_kernels_tile():
    import os
    import re

    from emotivoice_tpu_torch.ops.cuda import build

    with open(os.path.join(build.CSRC_DIR, "aa_snake.cu")) as fh:
        consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", fh.read()))
    per, threads = int(consts["kPerThread"]), int(consts["kThreads"])
    x, al, bl, taps = _act_operands(1, per * threads + 37, 1, seed=3)
    assert _rel(_kernel_walk(x, al, bl, taps, per, threads), _act_f64(x, al, bl, taps)) <= 1e-12


def test_filter_is_upstreams_kaiser_sinc():
    taps = aa_snake.kaiser_sinc_filter1d()
    assert taps.shape == (1, 1, 12)
    assert torch.allclose(taps, ref.kaiser_sinc_filter(), rtol=0, atol=1e-7)
    assert torch.equal(taps.flatten(), taps.flatten().flip(0))
    assert float(taps.sum()) == pytest.approx(1.0, abs=1e-6)


def test_tiny_generator_matches_the_reference():
    cfg = _cfg()
    f, sd = _state_dict(cfg)
    gen = BigVGANGenerator(cfg.vocoder)
    gen.load_state_dict({k[len("generator."):]: v for k, v in sd.items()
                         if k.startswith("generator.")}, strict=True)
    mel = torch.randn(2, 13, cfg.vocoder.initial_channel,
                      generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = ref.vocoder(sd, f, mel)
        wav = gen.eval()(mel)
    assert wav.shape == (2, 13 * 4)
    assert _rel(wav, want) <= 1e-5
    assert float(want.abs().max()) < 1.0  # the clamp is not what agrees


@pytest.mark.parametrize("t", [1, 4, 9, 10, 11, 31])
@pytest.mark.parametrize("d", [1, 3, 5])
def test_dilated_conv_over_phases_is_the_dilated_conv(t, d):
    """The phase form (an undilated conv2d over the d phases of time)
    against torch's dilated conv1d, at 'same' padding and at one that is no
    multiple of d."""
    from emotivoice_tpu_torch.ops.conv import conv1d_over_phases

    gen = torch.Generator().manual_seed(t * 10 + d)
    h = torch.randn(2, 6, t, generator=gen)
    w = torch.randn(5, 6, 7, generator=gen)
    for padding in (3 * d, 4 * d + 1):
        if t + 2 * padding < 6 * d + 1:
            continue  # no output sample
        want = F.conv1d(h, w, padding=padding, dilation=d)
        assert _rel(conv1d_over_phases(h, w, padding, d), want) <= 1e-6


@pytest.mark.parametrize("c, k, d, phases", [(192, 7, 5, True), (192, 11, 3, True),
                                             (384, 3, 5, False), (96, 11, 5, False)])
def test_wnconv1d_takes_the_phases_where_cudnn_would_not_use_tensor_cores(monkeypatch, c, k, d,
                                                                          phases):
    """WNConv1d in bf16 goes over the phases of time at C >= 192 and a span
    (k - 1) d >= 30, else to F.conv1d; both give torch's dilated conv1d."""
    from emotivoice_tpu_torch.models.hifigan import WNConv1d
    from emotivoice_tpu_torch.ops import conv as ops_conv

    calls = []
    orig = ops_conv.conv1d_over_phases
    monkeypatch.setattr(ops_conv, "conv1d_over_phases", lambda *a: calls.append(1) or orig(*a))
    gen = torch.Generator().manual_seed(c + k + d)
    conv = WNConv1d(c, 4, k, dilation=d)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
        x = torch.randn(1, 40, c, generator=gen)
        want = F.conv1d(x.transpose(1, 2), conv.folded(), conv.bias, padding=conv.padding,
                        dilation=d).transpose(1, 2)
        assert _rel(conv(x), want) <= 1e-5 and not calls  # f32: F.conv1d
        got = conv(x.bfloat16()).float()
    assert bool(calls) is phases
    assert _rel(got, want) <= 2e-2


def test_state_dict_names_are_bigvgans():
    cfg = _cfg()
    keys = set(JETSGenerator(cfg).state_dict())
    f = _as_file(cfg)
    assert keys == set(ref.param_shapes(f))
    for k in ("generator.conv_pre.weight_v", "generator.ups.1.0.weight_g", "generator.ups.1.0.bias",
              "generator.resblocks.5.convs1.2.weight_v", "generator.resblocks.5.convs2.0.bias",
              "generator.resblocks.5.activations.5.act.alpha",
              "generator.resblocks.0.activations.0.act.beta",
              "generator.resblocks.0.activations.0.upsample.filter",
              "generator.resblocks.0.activations.0.downsample.lowpass.filter",
              "generator.activation_post.act.alpha",
              "generator.activation_post.downsample.lowpass.filter",
              "generator.conv_post.weight_g", "generator.conv_post.weight_v"):
        assert k in keys, k
    assert "generator.conv_post.bias" not in keys
    assert len(ref.activations(f)) == 2 * 3 * 3 * 2 + 1


def test_default_vocoder_is_hifigan_v1_unchanged():
    cfg = tiny_test_config()
    assert cfg.vocoder.activation == "lrelu" and VocoderConfig().activation == "lrelu"
    model = JETSGenerator(cfg)
    assert type(model.generator) is HiFiGANGenerator
    f = _as_file(cfg)
    want = {k: tuple(s) for k, s in hifigan_ref.param_shapes(f).items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    assert "generator.conv_post.bias" in want


def test_unknown_vocoder_and_unsupported_forms_refused():
    """Each generator builds the final forms it runs and refuses the others:
    BigVGAN-v2 no tanh and no final bias, HiFi-GAN both."""
    with pytest.raises(ValueError, match="unknown vocoder activation"):
        JETSGenerator(tiny_test_config().replace(vocoder=VocoderConfig(activation="snake")))
    for key in ("snake_logscale", "use_tanh_at_final", "use_bias_at_final"):
        with pytest.raises(ValueError, match="BigVGAN-v2"):
            BigVGANGenerator(VocoderConfig(**dict(TINY, **{key: not TINY.get(key, True)})))
    for key in ("use_tanh_at_final", "use_bias_at_final"):
        with pytest.raises(ValueError, match="HiFi-GAN"):
            HiFiGANGenerator(VocoderConfig(**{key: False}))
    with pytest.raises(ValueError, match="BigVGAN-v2"):
        JETSGenerator(_cfg(), kernels=False)


def test_training_and_tensor_parallelism_refuse_it():
    from emotivoice_tpu_torch.models.discriminator import Discriminator
    from emotivoice_tpu_torch.parallel.tensor_parallel import tensor_parallel
    from emotivoice_tpu_torch.training.step import TrainStep

    cfg = _cfg()
    model = JETSGenerator(cfg)
    with pytest.raises(ValueError, match="BigVGAN-v2"):
        TrainStep(cfg, model, Discriminator(cfg.disc))
    with pytest.raises(ValueError, match="BigVGAN-v2"):
        tensor_parallel(model, ["cpu", "cpu"])


def test_engine_serves_it_as_the_reference_computes():
    """JETSGenerator with the tiny BigVGAN behind SynthesisEngine on the CPU
    (f32), against the reference's whole model on each row at the row's
    bucket: equal frame counts, waveforms within 1e-5 of max."""
    cfg = _cfg()
    f, sd = _state_dict(cfg, seed=5)
    model = JETSGenerator(cfg)
    model.load_state_dict(sd, strict=True)
    vocab = TokenVocab.from_tokens([f"t{i}" for i in range(cfg.am.n_vocab)])
    engine = SynthesisEngine(cfg, model.eval(), vocab, text_buckets=(8, 16), mel_buckets=(32, 64),
                             batch_buckets=(2,), device="cpu")
    rng = np.random.default_rng(6)
    lengths = np.array([7, 4])
    tokens = np.zeros((2, 8), np.int64)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(1, cfg.am.n_vocab, n)
    speaker = np.array([1, 5])
    style = rng.standard_normal((2, cfg.am.bert_embedding)).astype(np.float32)
    content = rng.standard_normal((2, cfg.am.bert_embedding)).astype(np.float32)
    wav, n_frames = engine.run(tokens, lengths, speaker, style, content, 32, 1.0)
    hop = cfg.vocoder.upsample_factor
    assert wav.shape == (2, 32 * hop)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt)  # noqa: E731
    for i in range(2):
        row = slice(i, i + 1)
        want = ref.synthesize(sd, f, t(tokens[row], torch.long), t(lengths[row], torch.long),
                              t(speaker[row], torch.long), t(style[row], torch.float32),
                              t(content[row], torch.float32), 32)
        n = int(want["n_frames"][0])
        assert int(n_frames[i]) == n and n > 0
        w = want["wav"][0, : n * hop]
        assert _rel(torch.from_numpy(wav[i, : n * hop]), w) <= 1e-5


class _CudaStandIn:
    """What the wrapper reads of a CUDA tensor, on a machine with no card."""

    def __init__(self, *shape):
        self.shape, self.device = torch.Size(shape), torch.device("cuda")
        self.dtype, self.requires_grad = torch.float32, False

    def dim(self):
        return len(self.shape)

    def numel(self):
        return math.prod(self.shape)

    def is_contiguous(self):
        return True

    def transpose(self, *dims):
        return self

    def contiguous(self):
        return self


def test_cuda_tensors_raise_without_a_card(monkeypatch):
    """A CUDA operand goes to the kernel, whose build needs nvcc and a card:
    it raises, never falls back to the plain chain, and counts nothing."""
    def no_fallback(*a):
        raise AssertionError("fell back to the plain chain")

    monkeypatch.setattr(aa_snake, "aa_snake_plain", no_fallback)
    monkeypatch.setattr(aa_snake.build, "find_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(aa_snake.build, "_lib", None)
    before = aa_snake.fused_aa_snake.launches
    x, c = _CudaStandIn(2, 9, 4), _CudaStandIn(4)
    taps = _CudaStandIn(aa_snake.TAPS)
    with pytest.raises(RuntimeError, match="nvcc"):
        aa_snake.fused_aa_snake(x, c, c, taps, taps)
    assert aa_snake.fused_aa_snake.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        aa_snake.fused_aa_snake(*(t.to("meta") for t in _act_operands(1, 4, 4)[:3]),
                                torch.zeros(12, device="meta"), torch.zeros(12, device="meta"))


def test_cpu_takes_the_plain_chain_without_counting():
    x, al, bl, taps = _act_operands(2, 11, 3)
    before = aa_snake.fused_aa_snake.launches
    with torch.no_grad():
        got = aa_snake.fused_aa_snake(x, al, bl, taps, taps)
    assert torch.equal(got, aa_snake.aa_snake_plain(x, al, bl, taps, taps))
    assert aa_snake.fused_aa_snake.launches == before
    al.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        aa_snake.fused_aa_snake(x, al, bl, taps, taps)


def test_kernel_constants_match_the_cuda_source():
    import os
    import re

    from emotivoice_tpu_torch.ops.cuda import build

    with open(os.path.join(build.CSRC_DIR, "aa_snake.cu")) as fh:
        src = fh.read()
    consts = {n: int(v) for n, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kTaps"] == aa_snake.TAPS
    for entry in ("evt_aa_snake_bf16", "evt_aa_snake_f32"):
        assert f'extern "C" int {entry}(' in src
        with open(os.path.join(os.path.dirname(build.__file__), "build.py")) as fh:
            assert f"lib.{entry}.argtypes" in fh.read()
