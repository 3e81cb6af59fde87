"""Tensor parallelism in the port (`parallel/sharding.py`, `mesh.py`,
`tensor_parallel.py`) against the JAX package's 'model' mesh axis, on the
CPU (tiny_test_config; a model group is a list of CPU devices).

- Layout: every parameter of the JAX train state on a data 4 x model 2
  mesh (`train_state_shardings`) is split on the dim the port splits it on,
  mapped through the layout transposes (flax (in, out) / (K, Ci, Co) ->
  torch (out, in) / (Co, Ci, K)); the one listed exception is the
  transposed convs' g, which the port keeps whole. On a 3-way axis with
  widths that divide by 3, whatever JAX keeps whole the port keeps whole;
  the port also keeps attention whole where the heads do not divide.
- Inference: a TP(2) JETS over [cpu, cpu] against the JAX model-axis path
  (`JETSGenerator(use_s2d=False)` jitted with `tree_shardings` parameters
  on a model-2 mesh) at the port's single-device parity tolerance (equal
  durations, waveform atol 1e-3), the TP vocoder on JAX's own mel the same;
  and against the port's one-device model within 1e-5 of max.
- Training: one TP(2) `TrainStep` against `make_parallel_train_step` on a
  data 4 x model 2 mesh at tests/test_tp.py's tolerances (metrics rtol
  2e-3 / atol 2e-4; parameters rtol 1e-3 / atol 2.5 lr).
- The weight-norm traps: a row-parallel convs2 and a transposed conv's
  shards fold to slices of the whole folded weight; per-shard norms (the
  negative control) do not.
- Kernels: the TP serving path calls the MRF kernel wrappers 18 + 2 times
  per generator call (the V1 vocoder), on whole weights.
- State: TP state dicts (parameters and Adam moments) round-trip to the
  one-device layout bit-equal and convert through the JAX package's
  `convert_jets_generator`.
- The engine on 4 CPU devices with model_parallel=2 equals the one-device
  engine; two gloo ranks x TP(2) equal one process; `mean_grads` keeps one
  buffer per device.

Dropout is off wherever TP meets one device: each shard draws its own
dropout masks.
"""

import copy
import dataclasses
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_parallel import (
    FLOOR,
    GRAD_TOL,
    LOSS_RTOL,
    LR,
    PARAM_TOL,
    WORKER,
    _env,
    _OnCard,
    _free_port,
    _grad_errors,
    _run_all,
)
from test_torch_support import (
    assert_close_rel,
    both_configs,
    jax_disc_variables,
    jax_jets_params,
    port_discriminator,
    port_jets,
    train_configs,
)
from test_torch_train import jax_models, jax_segment_starts, training_batch

from emotivoice_tpu.convert.from_torch import convert_jets_generator
from emotivoice_tpu.models.hifigan import Discriminator as JDiscriminator
from emotivoice_tpu.models.jets import JETSGenerator as JJETS
from emotivoice_tpu.parallel.mesh import make_mesh as jax_make_mesh
from emotivoice_tpu.parallel.mesh import shard_batch
from emotivoice_tpu.parallel.sharding import tree_shardings
from emotivoice_tpu.training.step import (
    TrainState,
    make_optimizers,
    make_parallel_train_step,
    shard_train_state,
    train_state_shardings,
)
from emotivoice_tpu_torch.config import VocoderConfig
from emotivoice_tpu_torch.convert.from_jax import discriminator_state_dict, jax_to_torch_state_dict
from emotivoice_tpu_torch.models import hifigan
from emotivoice_tpu_torch.models.jets import JETSGenerator, init_random_
from emotivoice_tpu_torch.parallel.data_parallel import DataParallel
from emotivoice_tpu_torch.parallel.mesh import make_mesh, split_rows
from emotivoice_tpu_torch.parallel.sharding import (
    count_partitioned,
    gather_state_dict,
    param_partition_spec,
    partition_dims,
    shard_state_dict,
)
from emotivoice_tpu_torch.parallel.tensor_parallel import (
    ColumnParallel,
    RowParallel,
    full_parameters,
    tensor_parallel,
)
from emotivoice_tpu_torch.training.step import TrainStep

CPU2 = ["cpu", "cpu"]
UPS_G = "the transposed convs' g: whole in the port, split on dim 0 by JAX"
STEP = 2  # the test_torch_parallel_worker steps of the two-rank TP run


def _tp(module, devices=CPU2):
    return tensor_parallel(copy.deepcopy(module), devices)


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the JAX train state both the layout and the train-step tests use
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_state():
    jc, tc = train_configs()
    g_params = jax_jets_params(jc, seed=61, with_alignment=True)
    d_params, spectral = jax_disc_variables(jc.disc, seed=62)
    opt_g, opt_d = make_optimizers(jc, 1000)
    state = TrainState(step=jnp.zeros((), jnp.int32), g_params=g_params["params"],
                       d_params=d_params, d_spectral=spectral,
                       opt_g=opt_g.init(g_params["params"]), opt_d=opt_d.init(d_params),
                       rng=jax.random.PRNGKey(63))
    return jc, tc, g_params, d_params, spectral, state


# ---------------------------------------------------------------------------
# (a) the sharding table, leaf for leaf
# ---------------------------------------------------------------------------

SCALE = 4096  # leaf id x SCALE + the index along the leaf's JAX split dim


def _encoded(tree, jax_dims):
    """Each leaf of `tree` as leaf_id * SCALE + (its index along its JAX
    split dim, or 0), so the converted port tensor tells which JAX leaf it
    came from and along which of its own dims the split runs."""
    flat, treedef = jax.tree_util.tree_flatten(tree)
    leaves = []
    for i, (leaf, dim) in enumerate(zip(flat, jax_dims)):
        shape = np.shape(leaf)
        idx = np.zeros(shape, np.float32)
        if dim is not None:
            view = [1] * len(shape)
            view[dim] = shape[dim]
            idx = idx + np.arange(shape[dim], dtype=np.float32).reshape(view)
        leaves.append((i + 1) * SCALE + idx)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _spec_dims(shardings):
    return [next((d for d, a in enumerate(s.spec) if a is not None), None)
            for s in jax.tree_util.tree_leaves(shardings)]


def _mapped_dims(sd, jax_dims):
    """{port name: the JAX split dim mapped into the port's layout}."""
    out = {}
    for k, v in sd.items():
        v = v.numpy()
        leaf = int(v.flat[0]) // SCALE - 1
        if jax_dims[leaf] is None:
            out[k] = None
            continue
        rem = v % SCALE
        varying = [d for d in range(v.ndim) if np.ptp(rem, axis=d).max() > 0]
        assert len(varying) == 1, (k, varying)
        out[k] = varying[0]
    return out


def _jax_layout(jc, tc, g_tree, d_tree, spectral, shardings_g, shardings_d):
    g_dims, d_dims = _spec_dims(shardings_g), _spec_dims(shardings_d)
    g_sd = jax_to_torch_state_dict(_encoded(g_tree, g_dims), tc)
    d_sd = discriminator_state_dict(_encoded(d_tree, d_dims), spectral, tc.disc)
    d_sd = {k: v for k, v in d_sd.items()  # not the spectral-norm buffers u, v
            if not (k.startswith("msd.discriminators.0.") and k.endswith(("_u", "_v")))}
    return _mapped_dims(g_sd, g_dims), _mapped_dims(d_sd, d_dims)


def _split_dims(module):
    return {name: dim for name, _, dim in full_parameters(module)}


def test_sharding_table_matches_train_state_shardings(jax_state):
    jc, tc, g_params, d_params, spectral, state = jax_state
    mesh = jax_make_mesh(jax.devices()[:8], model_parallel_size=2)
    sh = train_state_shardings(state, mesh, jc)
    want_g, want_d = _jax_layout(jc, tc, state.g_params, state.d_params, spectral,
                                 sh.g_params, sh.d_params)
    model = port_jets(tc, g_params)
    disc = port_discriminator(tc, d_params, spectral)
    differ = []
    for module, want in ((model, want_g), (disc, want_d)):
        names = dict(module.named_parameters())
        assert set(names) <= set(want)
        got = _split_dims(_tp(module))
        assert set(got) == set(names)
        for k, p in names.items():
            spec = param_partition_spec(k, tuple(p.shape), 2)
            assert got[k] == spec, k  # the modules follow the table
            if spec != want[k]:
                differ.append(k)
    ups_g = [f"generator.ups.{i}.weight_g" for i in range(len(tc.vocoder.upsample_rates))]
    assert sorted(differ) == sorted(ups_g), UPS_G
    assert all(want_g[k] == 0 for k in ups_g)
    # the table splits what the JAX rules name: vocoder, attention, FFN, MPD
    for k in ("generator.conv_pre.weight_v", "generator.resblocks.0.convs2.0.weight_v",
              "am.encoder.encoders.0.self_attn.linear_q.weight",
              "am.decoder.encoders.0.feed_forward.w_2.weight"):
        assert want_g[k] is not None, k
    assert want_d["mpd.discriminators.1.convs.2.weight_v"] == 0
    sd = model.state_dict()
    n_split = count_partitioned(sd, 2)
    assert 0 < n_split < sum(v.numel() for v in sd.values())


def _three_way_configs():
    """(JAX, port) tiny configs whose widths divide by 3: 24-d acoustic
    model with 2 heads (attention whole in the port: 2 heads do not split
    3 ways), vocoder 48 -> 24, 12, 6, 3, MPD towers (6, 12, 12, 12)."""
    out = []
    for c in both_configs():
        c = c.replace(
            am=dataclasses.replace(c.am, hidden=24, variance_n_hidden=24,
                                   encoder_p_dropout=0.0, decoder_p_dropout=0.0,
                                   variance_p_dropout=0.0, duration_p_dropout=0.0,
                                   variance_embed_p_dropout=0.0),
            vocoder=dataclasses.replace(c.vocoder, upsample_initial_channel=48),
            disc=dataclasses.replace(c.disc, period_channels=(6, 12, 12, 12)))
        out.append(c)
    return tuple(out)


def test_three_way_axis_keeps_whole_what_jax_keeps_whole():
    jc, tc = _three_way_configs()
    b, t = 1, 6
    args = (np.zeros((b, t), np.int32), np.full((b,), t, np.int32), np.zeros((b,), np.int32),
            np.zeros((b, jc.am.bert_embedding), np.float32),
            np.zeros((b, jc.am.bert_embedding), np.float32))
    g_shapes = jax.eval_shape(lambda: JJETS(jc, use_s2d=False).init(
        jax.random.PRNGKey(0), *args, max_frames=16))["params"]
    y = np.zeros((1, 512), np.float32)
    d_shapes = jax.eval_shape(lambda: JDiscriminator(jc.disc).init(jax.random.PRNGKey(0), y, y))
    spectral = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                      d_shapes["spectral"])
    g_tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), g_shapes)
    d_tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), d_shapes["params"])
    mesh = jax_make_mesh(jax.devices()[:6], model_parallel_size=3)
    want_g, want_d = _jax_layout(jc, tc, {"am": g_tree["am"], "generator": g_tree["generator"]},
                                 d_tree, spectral,
                                 tree_shardings({"am": g_tree["am"],
                                                 "generator": g_tree["generator"]}, mesh),
                                 tree_shardings(d_tree, mesh))
    from emotivoice_tpu_torch.models.discriminator import Discriminator

    model = init_random_(JETSGenerator(tc), seed=5).eval()
    disc = init_random_(Discriminator(tc.disc), seed=6)
    heads = ("linear_q.", "linear_k.", "linear_v.", "linear_out.")
    split = 0
    for module, want in ((model, want_g), (disc, want_d)):
        got = _split_dims(_tp(module, ["cpu"] * 3))
        for k, dim in got.items():
            if want.get(k) is None:
                assert dim is None, k  # JAX keeps it whole: so does the port
            elif dim != want[k]:
                assert ".ups." in k and k.endswith("weight_g") or any(h in k for h in heads), k
            split += dim is not None
    assert split > 20  # the 3-way group does split (FFN, vocoder, MPD)
    assert want_g["am.encoder.encoders.0.self_attn.linear_q.weight"] == 0
    # and the 3-way model computes the one-device model's function
    tp = _tp(model, ["cpu"] * 3)
    inputs = _inference_inputs(tc, b=2, t_text=8)
    with torch.no_grad():
        want_out = model(*inputs, max_frames=32)
        got_out = tp(*inputs, max_frames=32)
    assert torch.equal(got_out["durations"], want_out["durations"])
    assert_close_rel(got_out["wav_predictions"], want_out["wav_predictions"], 1e-5)


def test_shard_and_gather_state_dict_round_trip():
    _, tc = both_configs()
    sd = init_random_(JETSGenerator(tc), seed=7).state_dict()
    dims = partition_dims(sd, 2)
    shards = shard_state_dict(sd, 2)
    back = gather_state_dict(shards, dims)
    assert list(back) == list(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
        if dims[k] is not None:
            assert shards[0][k].shape[dims[k]] * 2 == v.shape[dims[k]]
    assert make_mesh(["cpu"] * 4, 2) == [[torch.device("cpu")] * 2] * 2
    assert split_rows(6, 3) == [slice(0, 2), slice(2, 4), slice(4, 6)]
    with pytest.raises(ValueError):
        make_mesh(["cpu"] * 3, 2)
    with pytest.raises(ValueError):
        split_rows(5, 2)


# ---------------------------------------------------------------------------
# (b) inference against the JAX model-axis path
# ---------------------------------------------------------------------------

def _inference_inputs(cfg, b=3, t_text=10, seed=10):
    rng = np.random.RandomState(seed)
    return tuple(torch.as_tensor(a) for a in (
        rng.randint(0, cfg.am.n_vocab, (b, t_text)), np.array([t_text, t_text - 3, 4][:b]),
        np.array([0, 3, 7][:b]), rng.randn(b, cfg.am.bert_embedding).astype(np.float32),
        rng.randn(b, cfg.am.bert_embedding).astype(np.float32)))


def test_tp_inference_matches_jax_model_axis():
    jc, tc = both_configs()
    params = jax_jets_params(jc, seed=3)
    mesh = jax_make_mesh(jax.devices()[:2], model_parallel_size=2)
    sharded = jax.device_put(params, tree_shardings(params, mesh))
    v = sharded["params"]["generator"]["conv_pre"]["v"]
    assert v.addressable_shards[0].data.shape[0] * 2 == v.shape[0]  # really split
    max_frames = 32
    inputs = _inference_inputs(tc)
    fn = jax.jit(lambda p, *a: JJETS(jc, use_s2d=False).apply(p, *a, max_frames=max_frames))
    want = fn(sharded, *(a.numpy() for a in inputs))

    model = port_jets(tc, params)
    tp = _tp(model)
    with torch.no_grad():
        got = tp(*inputs, max_frames=max_frames)
        one = model(*inputs, max_frames=max_frames)
    np.testing.assert_array_equal(got["durations"].numpy(), np.asarray(want["durations"]))
    np.testing.assert_array_equal(got["output_lengths"].numpy(),
                                  np.asarray(want["output_lengths"]))
    wav_ref = np.asarray(want["wav_predictions"])
    assert np.max(np.abs(wav_ref)) > 1e-2
    np.testing.assert_allclose(got["wav_predictions"].numpy(), wav_ref, atol=1e-3)
    assert torch.equal(got["durations"], one["durations"])
    assert_close_rel(got["wav_predictions"], one["wav_predictions"], 1e-5)

    # the TP vocoder alone on JAX's own mel, through the kernels' path
    # (kernels=True) and the differentiable one (kernels=False)
    mel = torch.from_numpy(np.array(want["dec_outputs"]))
    for kernels in (True, False):
        tp.generator.kernels = model.generator.kernels = kernels
        with torch.no_grad():
            wav = tp.generator(mel)
            np.testing.assert_allclose(wav.numpy(), wav_ref, atol=1e-3)
            assert_close_rel(wav, model.generator(mel), 1e-5)


# ---------------------------------------------------------------------------
# (c) one train step against make_parallel_train_step
# ---------------------------------------------------------------------------

def test_tp_train_step_matches_jax_parallel_step(jax_state):
    jc, tc, g_params, d_params, spectral, state = jax_state
    batch = {k: np.concatenate([a, b]) for (k, a), b in zip(
        training_batch(jc, seed=64).items(), training_batch(jc, seed=65).values())}
    _, starts = jax_segment_starts(state.rng, batch, jc.train.segment_size)
    mesh = jax_make_mesh(jax.devices()[:8], model_parallel_size=2)
    step = make_parallel_train_step(jc, *jax_models(jc), mesh, steps_per_epoch=1000, state=state)
    with mesh:
        new_state, want = step(shard_train_state(state, mesh, jc), shard_batch(batch, mesh))

    model = port_jets(tc, g_params)
    model.generator.kernels = False
    disc = port_discriminator(tc, d_params, spectral)
    trainer = TrainStep(tc, tensor_parallel(model, CPU2), tensor_parallel(disc, CPU2), 1000)
    assert type(model.generator.conv_post).__name__ == "RowParallel"
    got = trainer(_torch_batch(batch), start_idxs=torch.from_numpy(starts))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-3, atol=2e-4,
                                   err_msg=k)
    atol = 2.5 * tc.train.lr
    new_g = jax_to_torch_state_dict(jax.device_get(new_state.g_params), tc)
    new_d = discriminator_state_dict(jax.device_get(new_state.d_params),
                                      jax.device_get(new_state.d_spectral), tc.disc)
    for module, ref in ((model, new_g), (disc, new_d)):
        sd = module.state_dict()
        assert len(sd) > 50
        for k, v in sd.items():
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-3, atol=atol,
                                       err_msg=k)
    before = jax_to_torch_state_dict(g_params, tc)
    assert any(not torch.equal(model.state_dict()[k], before[k]) for k in before)


# ---------------------------------------------------------------------------
# (d) the weight-norm traps
# ---------------------------------------------------------------------------

def _per_shard_fold(layer):
    """The wrong fold: each shard normalised by its own part's norm."""
    g = layer.weight_g
    out = []
    for v in layer.parts("weight_v"):
        norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())), keepdim=True))
        out.append(g * v / norm)
    return out


@pytest.mark.parametrize("which", ["convs2", "ups"])
def test_weight_norm_fold_spans_the_shards(which):
    _, tc = both_configs()
    gen = init_random_(JETSGenerator(tc), seed=8).generator
    with torch.no_grad():  # a g that is not ||v||, so the fold is not the identity
        for p in gen.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    mod = gen.resblocks[0].convs2[1] if which == "convs2" else gen.ups[0]
    layer = (RowParallel if which == "convs2" else ColumnParallel)(mod, CPU2)
    assert layer.dim == 1 and layer.layout["weight_g"] is None
    whole = mod.folded().detach()
    with torch.no_grad():
        shards, wrong = layer.weights(), _per_shard_fold(layer)
    for i, (w, bad) in enumerate(zip(shards, wrong)):
        want = whole.chunk(2, 1)[i]
        assert_close_rel(w, want, 1e-6)
        # the negative control: per-shard norms are another function
        assert float((bad - want).abs().max()) > 1e-2 * float(want.abs().max())
    assert_close_rel(layer.folded().detach(), whole, 1e-6)


def test_column_parallel_fold_is_local():
    _, tc = both_configs()
    gen = init_random_(JETSGenerator(tc), seed=8).generator
    mod = gen.resblocks[0].convs1[0]
    layer = ColumnParallel(mod, CPU2)
    assert layer.dim == 0 and layer.layout["weight_g"] == 0
    with torch.no_grad():
        for i, w in enumerate(layer.weights()):
            assert_close_rel(w, mod.folded().chunk(2, 0)[i], 1e-6)


# ---------------------------------------------------------------------------
# (e) the kernels on the TP serving path
# ---------------------------------------------------------------------------

def test_tp_serving_path_launches_18_plus_2_on_whole_weights(monkeypatch):
    _, tc = both_configs()
    tc = tc.replace(vocoder=VocoderConfig(initial_channel=tc.am.n_mels))  # HiFi-GAN V1
    model = init_random_(JETSGenerator(tc), seed=9).eval()
    tp = _tp(model)
    calls = {"unit": [], "stage": []}
    unit, stage = hifigan.fused_residual_unit, hifigan.fused_mrf_stage

    def count_unit(x, w1, b1, w2, b2, k, d):
        calls["unit"].append((x.shape[-1], tuple(w1.shape), tuple(w2.shape)))
        return unit(x, w1, b1, w2, b2, k, d)

    def count_stage(x, weights, ks, ds):
        calls["stage"].append((x.shape[-1], tuple(weights[0][0][0].shape)))
        return stage(x, weights, ks, ds)

    monkeypatch.setattr(hifigan, "fused_residual_unit", count_unit)
    monkeypatch.setattr(hifigan, "fused_mrf_stage", count_stage)
    mel = torch.randn(1, 4, tc.am.n_mels, generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        ref = model.generator(mel)
        calls["unit"].clear()
        calls["stage"].clear()
        wav = tp.generator(mel)
    assert (len(calls["unit"]), len(calls["stage"])) == (18, 2)
    assert all(w1 == w2 == (k, c, c) for (c, w1, w2), k in
               zip(calls["unit"], [3, 3, 3, 7, 7, 7, 11, 11, 11] * 2))
    assert [c for c, _ in calls["stage"]] == [64, 32]
    assert all(w == (3, c, c) for c, w in calls["stage"])
    assert_close_rel(wav, ref, 1e-5)


# ---------------------------------------------------------------------------
# (f) state dicts: the one-device layout, both ways
# ---------------------------------------------------------------------------

def _trainer(tc, model, disc):
    return TrainStep(tc, model, disc, steps_per_epoch=1000)


def _assert_same_state(a, b, path=""):
    """Equal structure, bit-equal tensors."""
    if torch.is_tensor(a):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_same_state(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_state(x, y, f"{path}/{i}")
    else:
        assert a == b, path


def test_state_dicts_round_trip_to_one_device(jax_state):
    jc, tc, g_params, d_params, spectral, _ = jax_state
    batch = _torch_batch(training_batch(jc, seed=66))
    model = port_jets(tc, g_params)
    model.generator.kernels = False
    disc = port_discriminator(tc, d_params, spectral)
    tp = _trainer(tc, _tp(model), _tp(disc))
    tp(batch)
    g_sd, d_sd, t_sd = tp.model.state_dict(), tp.disc.state_dict(), tp.state_dict()
    assert list(g_sd) == list(model.state_dict()) and list(d_sd) == list(disc.state_dict())
    n_params = len(list(model.parameters()))
    assert sorted(t_sd["optim_g"]["state"]) == list(range(n_params))
    assert len(list(tp.model.parameters())) > n_params  # the optimizer holds the parts

    # TP -> one device: bit-equal, and back
    one = _trainer(tc, copy.deepcopy(model), copy.deepcopy(disc))
    one.model.load_state_dict(g_sd)
    one.disc.load_state_dict(d_sd)
    one.load_state_dict(t_sd)
    _assert_same_state(one.model.state_dict(), g_sd)
    _assert_same_state(one.state_dict()["optim_g"], t_sd["optim_g"])
    _assert_same_state(one.state_dict()["optim_d"], t_sd["optim_d"])
    back = _trainer(tc, _tp(model), _tp(disc))
    back.model.load_state_dict(one.model.state_dict())
    back.disc.load_state_dict(one.disc.state_dict())
    back.load_state_dict(one.state_dict())
    _assert_same_state(back.model.state_dict(), g_sd)
    _assert_same_state(back.state_dict()["optim_g"], t_sd["optim_g"])
    for name, parts, dim in full_parameters(back.model):
        if dim is not None:  # the parts really hold the slices
            whole = one.model.get_parameter(name)
            assert all(torch.equal(p, w) for p, w in zip(parts, whole.chunk(2, dim))), name

    # the next step from either layout is the same step
    a, b = one(batch), back(batch)
    for k in a:
        np.testing.assert_allclose(float(b[k]), float(a[k]), rtol=1e-5, err_msg=k)

    # the TP state dict converts through the JAX package's converter
    tree = convert_jets_generator(_tp(port_jets(tc, g_params)).state_dict(), jc)
    want = jax.tree_util.tree_map(np.asarray, g_params["params"])
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(want)
    for (path, w), t in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(t, w, err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# (g) the engine with model groups
# ---------------------------------------------------------------------------

def test_engine_model_parallel_equals_one_device():
    from emotivoice_tpu_torch.config import tiny_test_config
    from emotivoice_tpu_torch.frontend.tokens import TokenVocab
    from emotivoice_tpu_torch.serving.engine import SynthesisEngine, SynthesisRequest

    cfg = tiny_test_config()
    vocab = TokenVocab.from_tokens(["_", "<sos/eos>", "a", "b", "c"])
    cfg = cfg.replace(am=dataclasses.replace(cfg.am, n_vocab=len(vocab)))
    model = init_random_(JETSGenerator(cfg), seed=0)
    kw = dict(text_buckets=(8, 16), mel_buckets=(64, 128), batch_buckets=(1, 3, 4))
    one = SynthesisEngine(cfg, copy.deepcopy(model), vocab, device="cpu", **kw)
    tp = SynthesisEngine(cfg, model, vocab, devices=["cpu"] * 4, model_parallel=2, **kw)
    assert tp.groups == [[torch.device("cpu")] * 2] * 2 and len(tp.replicas) == 2
    assert tp.replicas[0] is not tp.replicas[1]
    assert type(tp.replicas[1].am.decoder.encoders[0].self_attn).__name__ == \
        "HeadParallelAttention"
    assert tp.padded_rows(3) == 4
    rng = np.random.RandomState(0)
    d = cfg.am.bert_embedding
    reqs = [SynthesisRequest(
        phonemes=["<sos/eos>"] + list(rng.choice(["a", "b", "c"], n)) + ["<sos/eos>"],
        speaker_id=i, style_embedding=rng.randn(d).astype(np.float32),
        content_embedding=rng.randn(d).astype(np.float32)) for i, n in enumerate((3, 7, 5))]
    want, got = one.synthesize_batch(reqs), tp.synthesize_batch(reqs)
    for w, g in zip(want, got):
        assert g.n_frames == w.n_frames > 0
        assert_close_rel(g.wav, w.wav, 1e-5)


# ---------------------------------------------------------------------------
# (h) two gloo ranks x TP(2) against one process
# ---------------------------------------------------------------------------

def test_two_ranks_times_tp2_equal_one_process(tmp_path):
    port = _free_port()
    cmd = [sys.executable, WORKER, "step", "--steps", str(STEP), "--out"]
    tp = ["--tp", "2"]
    res = _run_all([(cmd + [str(tmp_path / "one.npz")], _env()),
                    (cmd + [str(tmp_path / "r0.npz")] + tp, _env(0, 2, port)),
                    (cmd + [str(tmp_path / "r1.npz")] + tp, _env(1, 2, port))],
                   cwd=str(tmp_path))
    for rc, text in res:
        assert rc == 0, text[-3000:]
    one, r0, r1 = (dict(np.load(tmp_path / f)) for f in ("one.npz", "r0.npz", "r1.npz"))
    for got in (r0, r1):
        errs = _grad_errors(one, got)
        assert len(errs) == sum(k.startswith("grad/") for k in one) > 100
        worst = max(errs, key=errs.get)
        assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    metrics = [k for k in one if k.startswith("metric/")]
    assert len(metrics) == STEP * 10
    for k in metrics:
        np.testing.assert_allclose(r0[k], one[k], rtol=LOSS_RTOL, err_msg=k)
    largest = max(np.abs(v).max() for k, v in one.items() if k.startswith("grad/"))
    for k in (k for k in one if k.startswith("param/")):
        grad = one.get("grad/" + k[6:])
        if grad is not None and np.abs(grad).max() < FLOOR * largest:
            atol = 2 * LR * STEP  # round-off gradient: Adam moves it +-lr a step
        else:
            atol = PARAM_TOL * max(np.abs(one[k]).max(), 1e-6)
        np.testing.assert_allclose(r0[k], one[k], rtol=0, atol=atol, err_msg=k)
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


# ---------------------------------------------------------------------------
# (i) mean_grads: one buffer per device
# ---------------------------------------------------------------------------

def test_mean_grads_keeps_one_buffer_per_device(monkeypatch):
    """Gradients on two devices (the second a CPU tensor that says it is on
    cuda:1): one buffer and one all-reduce per device, in the order the
    devices first appear; on one device one buffer, as before."""
    import types

    import torch.distributed as dist

    reduced = []

    def all_reduce(t, op=None, group=None):
        reduced.append(t.numel())
        t.mul_(2)  # two ranks with equal gradients

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    dp = DataParallel(0, 2, device="cpu")
    grads = [torch.full((3,), 1.0), torch.full((4,), 3.0).as_subclass(_OnCard),
             torch.full((5,), 2.0)]
    params = [types.SimpleNamespace(grad=g) for g in grads]
    dp.mean_grads(params)
    assert reduced == [8, 4]
    assert [float(g.max()) for g in grads] == [1.0, 3.0, 2.0]  # the mean of equal ranks
    reduced.clear()
    dp.mean_grads([params[0], params[2]])
    assert reduced == [8]
