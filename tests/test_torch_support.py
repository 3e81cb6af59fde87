"""Shared helpers of the PyTorch port's parity tests (no tests of its own).

Parameters and inputs are made from a seed with numpy and handed to both
the JAX package (the reference) and the port, as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

import jax

from emotivoice_tpu import config as jcfg
from emotivoice_tpu_torch import config as tcfg

# Six xdist workers share the host's cores; one intra-op thread each.
torch.set_num_threads(1)

# A small vocoder with one stage at C=128 (per-unit kernel dispatch) and
# one at C=64 (whole-stage kernel dispatch).
SMALL_VOCODER = dict(
    initial_channel=20,
    upsample_initial_channel=256,
    upsample_rates=(4, 2),
    upsample_kernel_sizes=(8, 4),
    resblock_kernel_sizes=(3, 7),
    resblock_dilation_sizes=((1, 3), (1, 5)),
)


def both_configs(vocoder=None):
    """(JAX config, port config) for tiny_test_config, optionally with a
    replaced vocoder (kwargs of VocoderConfig)."""
    j, t = jcfg.tiny_test_config(), tcfg.tiny_test_config()
    if vocoder is not None:
        j = j.replace(vocoder=jcfg.VocoderConfig(**vocoder))
        t = t.replace(vocoder=tcfg.VocoderConfig(**vocoder))
    return j, t


def _fill(path, leaf, rng, mrf_scale):
    shape = np.shape(leaf)
    name = path[-1]
    if name in ("embedding",):
        return rng.randn(*shape)
    if name == "alpha":
        return np.asarray(1.0 + 0.1 * rng.randn())
    if name == "scale":
        return 1.0 + 0.1 * rng.randn(*shape)
    if name in ("bias", "b"):
        return 0.02 * rng.randn(*shape)
    if name == "kernel":  # flax Dense / Conv: (..., in, out)
        return rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
    if name == "w":  # spectral-norm weight, torch layout (Co, Ci/g, K)
        return rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))
    if name == "v":  # weight-norm direction, torch layout
        if any(p.startswith("resblocks") for p in path):
            return rng.randn(*shape) * mrf_scale
        if path[-2].startswith("ups"):  # (Ci, Co, K): Ci*K/stride inputs per output
            return rng.randn(*shape) / np.sqrt(shape[0] * 2)
        return rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))
    raise KeyError(f"no fill rule for {'/'.join(path)}")


def random_params(tree, seed: int, mrf_scale: float = 0.04):
    """A numpy tree of the same structure with seeded values.

    MRF convs are drawn at std 0.04, the scale tests/test_pallas.py:53-67
    explains (activations O(1) through the residual chains); every other
    weight at 1/sqrt(fan_in). Weight-norm g is ||v|| times (1 + 0.1 N), so
    the fold is not the identity."""
    rng = np.random.RandomState(seed)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    vals = {}
    for kp, leaf in flat:
        path = tuple(k.key for k in kp)
        if path[-1] == "g":
            continue
        vals[path] = np.asarray(_fill(path, leaf, rng, mrf_scale), np.float32)
    for kp, leaf in flat:
        path = tuple(k.key for k in kp)
        if path[-1] == "g":
            v = vals[path[:-1] + ("v",)]
            norm = np.sqrt(np.sum(v * v, axis=tuple(range(1, v.ndim)), keepdims=True))
            vals[path] = (norm * (1.0 + 0.1 * rng.randn(*norm.shape))).astype(np.float32)

    def build(kp, leaf):
        return vals[tuple(k.key for k in kp)]

    return jax.tree_util.tree_map_with_path(build, tree)


def jax_jets_params(cfg, seed: int, with_alignment: bool = False):
    """JAX JETSGenerator variables with seeded numpy values. With
    `with_alignment`, the tree is initialised through the training branch so
    it also holds the alignment module."""
    from emotivoice_tpu.models.jets import JETSGenerator

    b, t = 1, 6
    args = (
        np.zeros((b, t), np.int32), np.full((b,), t, np.int32),
        np.zeros((b,), np.int32),
        np.zeros((b, cfg.am.bert_embedding), np.float32),
        np.zeros((b, cfg.am.bert_embedding), np.float32),
    )
    if with_alignment:
        tf = 12
        kw = dict(
            mel_targets=np.zeros((b, tf, cfg.am.n_mels), np.float32),
            feats_lengths=np.full((b,), tf, np.int32),
            pitch_targets=np.zeros((b, tf), np.float32),
            energy_targets=np.zeros((b, tf), np.float32),
            segment_rng=jax.random.PRNGKey(1),
        )
    else:
        kw = dict(max_frames=16)
    shapes = jax.eval_shape(
        lambda: JETSGenerator(cfg).init(jax.random.PRNGKey(0), *args, **kw)
    )
    return random_params(shapes, seed)


def port_jets(tcfg_, params):
    """Port JETSGenerator on the CPU loaded from a JAX params tree."""
    from emotivoice_tpu_torch.convert.from_jax import jax_to_torch_state_dict
    from emotivoice_tpu_torch.models.jets import JETSGenerator

    model = JETSGenerator(tcfg_)
    sd = jax_to_torch_state_dict(params, tcfg_)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected, unexpected
    assert all(k.startswith("am.alignment_module.") for k in missing), missing
    return model.eval()


def assert_close_rel(got, want, rtol_of_max: float):
    """|got - want| <= rtol_of_max * max|want| everywhere, and want is not
    near zero (so the comparison can fail)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.max(np.abs(want))
    assert scale > 1e-3, f"reference output is near zero (max |ref| = {scale})"
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol_of_max * scale)


class StandInTokenizer:
    """A deterministic stand-in for the SimBERT tokenizer, with the HF call
    signature the embedders use: [CLS], one id per character from a stable
    hash into [5, vocab_size), [SEP], padded with 0 to `max_length`."""

    CLS, SEP, PAD = 2, 3, 0

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def __call__(self, texts, padding="max_length", truncation=True, max_length=64,
                 return_tensors="np"):
        import zlib

        assert padding == "max_length" and truncation and return_tensors == "np"
        ids = np.full((len(texts), max_length), self.PAD, np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, text in enumerate(texts):
            body = [5 + zlib.crc32(ch.encode("utf-8")) % (self.vocab_size - 5)
                    for ch in text][: max_length - 2]
            row = [self.CLS] + body + [self.SEP]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return {"input_ids": ids, "token_type_ids": np.zeros_like(ids), "attention_mask": mask}


def jax_style_params(bert_cfg, seed: int):
    """JAX StyleEncoder variables with seeded numpy values."""
    from emotivoice_tpu.models.bert import StyleEncoder

    shapes = jax.eval_shape(
        lambda: StyleEncoder(bert_cfg).init(jax.random.PRNGKey(0), np.zeros((1, 4), np.int32))
    )
    return random_params(shapes, seed)


def port_style_encoder(bert_cfg, params):
    """Port StyleEncoder on the CPU loaded from a JAX params tree."""
    from emotivoice_tpu_torch.convert.from_jax import style_encoder_state_dict
    from emotivoice_tpu_torch.models.bert import StyleEncoder

    model = StyleEncoder(bert_cfg)
    model.load_state_dict(style_encoder_state_dict(params, bert_cfg.num_layers))
    return model.eval()


def train_configs(**train):
    """(JAX config, port config) for the training tests: tiny_test_config
    with every dropout rate 0 and a second MSD scale (weight norm, behind
    the average pool), `train` replacing TrainConfig fields."""
    import dataclasses

    out = []
    for mod in (jcfg, tcfg):
        c = mod.tiny_test_config()
        c = c.replace(
            am=dataclasses.replace(c.am, encoder_p_dropout=0.0, decoder_p_dropout=0.0,
                                   variance_p_dropout=0.0, duration_p_dropout=0.0,
                                   variance_embed_p_dropout=0.0),
            disc=dataclasses.replace(c.disc, n_scales=2),
            train=dataclasses.replace(c.train, **train))
        out.append(c)
    return tuple(out)


def jax_disc_variables(dcfg, seed: int):
    """JAX Discriminator params with seeded numpy values, and the spectral
    collection as the JAX package initialises it (u, v of unit norm from
    RandomState(0), u first)."""
    from emotivoice_tpu.models.hifigan import Discriminator

    y = np.zeros((1, 512), np.float32)
    shapes = jax.eval_shape(lambda: Discriminator(dcfg).init(jax.random.PRNGKey(0), y, y))
    params = random_params(shapes["params"], seed)

    def unit(rs, n):
        x = rs.randn(n).astype(np.float32)
        return x / np.linalg.norm(x)

    spectral = {}
    for name, node in shapes["spectral"]["msd_0"].items():
        rs = np.random.RandomState(0)
        spectral[name] = {"u": unit(rs, node["u"].shape[0]), "v": unit(rs, node["v"].shape[0])}
    return params, {"msd_0": spectral}


def port_discriminator(tcfg_, params, spectral):
    """Port Discriminator on the CPU loaded from JAX variables."""
    from emotivoice_tpu_torch.convert.from_jax import discriminator_state_dict
    from emotivoice_tpu_torch.models.discriminator import Discriminator

    disc = Discriminator(tcfg_.disc)
    disc.load_state_dict(discriminator_state_dict(params, spectral, tcfg_.disc))
    return disc
