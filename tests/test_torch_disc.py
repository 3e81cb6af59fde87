"""Discriminators, GAN losses and the generator's kernel switch of the port
against the JAX package, on the CPU (tiny_test_config with two MSD scales,
so the average pool and both norms are on the path).

Tolerances: outputs and feature maps within 1e-4 of max |ref|, the spectral
u, v after `update_stats` within 1e-6, the three losses within 1e-5
relative; `kernels=False` equals `kernels=True` within 1e-6 of max |wav|.
"""

import numpy as np
import pytest
import torch

import jax

from test_torch_support import (
    assert_close_rel,
    jax_disc_variables,
    port_discriminator,
    train_configs,
)

from emotivoice_tpu.convert.from_torch import convert_discriminator
from emotivoice_tpu.models import hifigan as jh
from emotivoice_tpu_torch.models import discriminator as td


@pytest.fixture(scope="module")
def setup():
    jc, tc = train_configs()
    params, spectral = jax_disc_variables(jc.disc, seed=21)
    rng = np.random.RandomState(22)
    y = (0.3 * rng.randn(2, 2048)).astype(np.float32)
    y_hat = (0.3 * rng.randn(2, 2048)).astype(np.float32)
    return jc, tc, params, spectral, y, y_hat


def _nhwc(f):
    """A port feature map (NCW / NCHW) in the JAX package's layout."""
    return f.permute(0, 2, 3, 1) if f.dim() == 4 else f.transpose(1, 2)


@pytest.mark.parametrize("update_stats", [False, True])
def test_discriminator_matches_jax(setup, update_stats):
    jc, tc, params, spectral, y, y_hat = setup
    (ro, fo, rf, ff), new = jh.Discriminator(jc.disc).apply(
        {"params": params, "spectral": spectral}, y, y_hat, update_stats=update_stats,
        mutable=["spectral"])
    disc = port_discriminator(tc, params, spectral)
    with torch.no_grad():
        gro, gfo, grf, gff = disc(torch.from_numpy(y), torch.from_numpy(y_hat),
                                  update_stats=update_stats)
    n_sub = len(jc.disc.periods) + jc.disc.n_scales
    assert len(gro) == len(gfo) == len(grf) == n_sub
    for got, want in zip(gro + gfo, ro + fo):
        assert got.shape == want.shape
        assert_close_rel(got, want, 1e-4)
    for got_maps, want_maps in zip(grf + gff, rf + ff):
        assert len(got_maps) == len(want_maps)
        for got, want in zip(got_maps, want_maps):
            assert_close_rel(_nhwc(got), want, 1e-4)
    sn = disc.msd.discriminators[0]
    for name, mod in [(f"convs_{i}", c) for i, c in enumerate(sn.convs)] + [("conv_post", sn.conv_post)]:
        want_u = np.asarray(new["spectral"]["msd_0"][name]["u"])
        want_v = np.asarray(new["spectral"]["msd_0"][name]["v"])
        np.testing.assert_allclose(mod.weight_u.numpy(), want_u, atol=1e-6)
        np.testing.assert_allclose(mod.weight_v.numpy(), want_v, atol=1e-6)
        moved = np.abs(want_v - spectral["msd_0"][name]["v"]).max()  # conv_post's u is +-1
        assert (moved > 1e-3) == update_stats


def test_gan_losses_match_jax(setup):
    jc, tc, params, spectral, y, y_hat = setup
    (ro, fo, rf, ff), _ = jh.Discriminator(jc.disc).apply(
        {"params": params, "spectral": spectral}, y, y_hat, mutable=["spectral"])
    disc = port_discriminator(tc, params, spectral)
    with torch.no_grad():
        gro, gfo, grf, gff = disc(torch.from_numpy(y), torch.from_numpy(y_hat))
    for got, want in ((td.discriminator_loss(gro, gfo), jh.discriminator_loss(ro, fo)),
                      (td.generator_loss(gfo), jh.generator_loss(fo)),
                      (td.feature_loss(grf, gff), jh.feature_loss(rf, ff))):
        assert float(want) > 1e-2
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_state_dict_round_trip_through_reference_converter():
    """Port state_dict() -> the JAX package's `convert_discriminator` (which
    hard-codes the reference topology: 5 periods, 3 scales, 7 MSD layers)
    -> `discriminator_state_dict` gives back the port's tensors bit-equal,
    and the JAX tree has the JAX Discriminator's structure and shapes."""
    from emotivoice_tpu.config import DiscriminatorConfig as JDC
    from emotivoice_tpu_torch.config import DiscriminatorConfig as TDC
    from emotivoice_tpu_torch.convert.from_jax import discriminator_state_dict
    from emotivoice_tpu_torch.models.jets import init_random_

    narrow = dict(period_channels=(4, 8, 8, 8),
                  scale_layers=((16, 15, 1, 1, 7), (16, 41, 2, 4, 20), (16, 41, 2, 16, 20),
                                (16, 41, 4, 16, 20), (16, 41, 4, 16, 20), (16, 41, 1, 16, 20),
                                (16, 5, 1, 1, 2)))
    tdc, jdc = TDC(**narrow), JDC(**narrow)
    disc = init_random_(td.Discriminator(tdc), seed=23)
    with torch.no_grad():  # spectral state that is not the initial one
        disc(torch.randn(1, 1024), torch.randn(1, 1024), update_stats=True)
    sd = disc.state_dict()
    tree = convert_discriminator({"discriminator": sd})
    y = np.zeros((1, 512), np.float32)
    shapes = jax.eval_shape(lambda: jh.Discriminator(jdc).init(jax.random.PRNGKey(0), y, y))
    for col in ("params", "spectral"):
        assert (jax.tree_util.tree_structure(tree[col])
                == jax.tree_util.tree_structure(shapes[col]))
        for a, b in zip(jax.tree_util.tree_leaves(tree[col]),
                        jax.tree_util.tree_leaves(shapes[col])):
            assert a.shape == b.shape
    back = discriminator_state_dict(tree["params"], tree["spectral"], tdc)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_load_reference_discriminator_checkpoint(setup):
    """A reference do_* checkpoint: weight norm under the parametrize names,
    spectral norm as weight_orig / weight_u / weight_v; a checkpoint without
    u, v keeps the module's."""
    from emotivoice_tpu_torch.convert.from_reference import load_discriminator
    from emotivoice_tpu_torch.models.jets import init_random_

    _, tc, *_ = setup
    src = init_random_(td.Discriminator(tc.disc), seed=24)
    sd = {}
    for k, v in src.state_dict().items():
        k = k.replace(".weight_g", ".parametrizations.weight.original0")
        if ".msd.discriminators.0." not in f".{k}":
            k = k.replace(".weight_v", ".parametrizations.weight.original1")
        sd[f"module.{k}"] = v
    got = load_discriminator(td.Discriminator(tc.disc), {"discriminator": sd, "optim_d": {}})
    for k, v in src.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    no_uv = {k: v for k, v in sd.items() if not k.endswith(("weight_u", "weight_v"))
             or ".msd.discriminators.0." not in f".{k[len('module.'):]}"}
    fresh = td.Discriminator(tc.disc)
    u0 = fresh.msd.discriminators[0].convs[0].weight_u.clone()
    load_discriminator(fresh, no_uv)
    assert torch.equal(fresh.msd.discriminators[0].convs[0].weight_u, u0)
    assert torch.equal(fresh.msd.discriminators[0].convs[0].weight_orig,
                       src.msd.discriminators[0].convs[0].weight_orig)


@pytest.fixture(scope="module")
def generator():
    from test_torch_support import SMALL_VOCODER, both_configs
    from emotivoice_tpu_torch.models.hifigan import HiFiGANGenerator
    from emotivoice_tpu_torch.models.jets import init_random_

    _, tc = both_configs(SMALL_VOCODER)
    gen = init_random_(HiFiGANGenerator(tc.vocoder), seed=25)
    mel = torch.from_numpy(np.random.RandomState(26).randn(2, 12, 20).astype(np.float32))
    return gen, mel


def test_kernels_false_equals_kernels_true(generator):
    """The trainer's differentiable MRF path gives the kernels' waveform at
    f32 (both dispatches: C=128 per unit, C=64 whole stage)."""
    gen, mel = generator
    with torch.no_grad():
        want = gen(mel)
        gen.kernels = False
        try:
            got = gen(mel)
        finally:
            gen.kernels = True
    assert float(want.abs().max()) > 1e-2
    assert_close_rel(got, want, 1e-6)


def test_kernels_refuse_grad_on_the_cpu(generator):
    """A forward with grad through kernels=True raises instead of returning a
    waveform cut from the graph; with kernels=False the gradient reaches
    every MRF weight."""
    from emotivoice_tpu_torch.ops.cuda.mrf_stage import fused_mrf_stage
    from emotivoice_tpu_torch.ops.cuda.resblock import fused_residual_unit

    gen, mel = generator
    with pytest.raises(RuntimeError, match="no backward"):
        gen(mel)
    x = torch.randn(1, 16, 64, requires_grad=True)
    w = torch.randn(3, 64, 64) * 0.05
    b = torch.zeros(64)
    with pytest.raises(RuntimeError, match="fused_residual_unit has no backward"):
        fused_residual_unit(x, w, b, w, b, 3, 1)
    with pytest.raises(RuntimeError, match="fused_mrf_stage has no backward"):
        fused_mrf_stage(x, [[(w, b, w, b)]], (3,), ((1,),))
    with torch.no_grad():
        fused_residual_unit(x, w, b, w, b, 3, 1)  # allowed without grad
    gen.kernels = False
    try:
        gen(mel).square().sum().backward()
    finally:
        gen.kernels = True
    for block in gen.resblocks:
        for conv in list(block.convs1) + list(block.convs2):
            assert conv.weight_v.grad is not None and conv.weight_v.grad.abs().max() > 0
    gen.zero_grad(set_to_none=True)
