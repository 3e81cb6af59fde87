"""The port's two MRF kernels on the CPU: their plain versions against the
JAX package's references (and, for one shape each, its Pallas kernels in
interpret mode), the wrappers' dispatch and checks, and the launch
geometry the CUDA sources rely on. The kernels themselves run only on the
card; `chip_smoke.py` holds each one against its plain version there.

Tolerance: atol 2e-4, as tests/test_pallas.py uses for the same math.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_support  # noqa: F401  (one intra-op thread per worker)
from emotivoice_tpu.ops.pallas import packed_stage as jps
from emotivoice_tpu.ops.pallas import resblock as jrb
from emotivoice_tpu_torch.ops.cuda import build
from emotivoice_tpu_torch.ops.cuda import mrf_stage as tms
from emotivoice_tpu_torch.ops.cuda import resblock as trb

ATOL = 2e-4
V1_KS = (3, 7, 11)
V1_DS = ((1, 3, 5),) * 3


def _unit(rng, k, c, scale=0.1):
    return [rng.randn(*s).astype(np.float32) * f for s, f in
            (((k, c, c), scale), ((c,), 0.05), ((k, c, c), scale), ((c,), 0.05))]


def _stage(rng, ks, ds, c, scale=0.04):
    return [[_unit(rng, k, c, scale) for _ in dils] for k, dils in zip(ks, ds)]


def _t(ws):
    if isinstance(ws, np.ndarray):
        return torch.from_numpy(ws)
    return [_t(w) for w in ws]


def _j(ws):
    if isinstance(ws, np.ndarray):
        return jnp.asarray(ws)
    return tuple(_j(w) for w in ws)


def _assert_nontrivial_close(got, want):
    want = np.asarray(want)
    assert np.max(np.abs(want)) > 0.1
    np.testing.assert_allclose(np.asarray(got), want, atol=ATOL)


@pytest.mark.parametrize("k,d,c", [(3, 1, 32), (7, 3, 64), (11, 5, 32)])
def test_residual_unit_plain_matches_jax_reference(k, d, c):
    rng = np.random.RandomState(k * 10 + d)
    x = rng.randn(2, 203, c).astype(np.float32) * 0.5
    w1, b1, w2, b2 = _unit(rng, k, c)
    want = jrb.fused_residual_unit_reference(*_j([x, w1, b1, w2, b2]), k, d)
    got = trb.fused_residual_unit(*_t([x, w1, b1, w2, b2]), k, d)
    _assert_nontrivial_close(got, want)


@pytest.mark.parametrize("c", [32, 64])
def test_mrf_stage_plain_matches_jax_reference(c):
    rng = np.random.RandomState(c)
    x = rng.randn(2, 301, c).astype(np.float32) * 0.5
    ws = _stage(rng, V1_KS, V1_DS, c)
    want = jps.mrf_stage_reference(jnp.asarray(x), _j(ws), V1_KS, V1_DS)
    got = tms.fused_mrf_stage(torch.from_numpy(x), _t(ws), V1_KS, V1_DS)
    _assert_nontrivial_close(got, want)


def test_residual_unit_plain_matches_pallas_interpret():
    from jax.experimental import pallas as pl

    rng = np.random.RandomState(0)
    k, d, c = 7, 3, 16
    x = rng.randn(1, 300, c).astype(np.float32) * 0.3
    w1, b1, w2, b2 = _unit(rng, k, c)
    orig = pl.pallas_call
    try:
        pl.pallas_call = functools.partial(orig, interpret=True)
        want = jrb.fused_residual_unit.__wrapped__(*_j([x, w1, b1, w2, b2]), k, d, 128)
    finally:
        pl.pallas_call = orig
    got = trb.residual_unit_plain(*_t([x, w1, b1, w2, b2]), k, d)
    _assert_nontrivial_close(got, want)


def test_mrf_stage_plain_matches_pallas_interpret():
    ks, ds = (3, 7), ((1, 3), (1, 5))
    c, s, t = 32, 4, 96
    rng = np.random.RandomState(1)
    x = rng.randn(1, t, c).astype(np.float32)
    ws = _stage(rng, ks, ds, c)
    want = jps.fused_mrf_stage(
        jnp.asarray(x).reshape(1, t // s, s * c), _j(ws), s, ks, ds,
        block_rows=512, interpret=True,
    ).reshape(1, t, c)
    got = tms.mrf_stage_plain(torch.from_numpy(x), _t(ws), ks, ds)
    _assert_nontrivial_close(got, want)


def test_cpu_tensors_take_plain_versions_without_counting():
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(1, 40, 32).astype(np.float32))
    unit = _t(_unit(rng, 3, 32))
    before = (trb.fused_residual_unit.launches, tms.fused_mrf_stage.launches)
    a = trb.fused_residual_unit(x, *unit, 3, 1)
    b = tms.fused_mrf_stage(x, [[unit]], (3,), ((1,),))
    assert torch.equal(a, trb.residual_unit_plain(x, *unit, 3, 1))
    assert torch.equal(b, a)  # one chain of one unit, / 1
    assert (trb.fused_residual_unit.launches, tms.fused_mrf_stage.launches) == before


def test_other_devices_raise():
    x = torch.empty(1, 8, 32, device="meta")
    w = torch.empty(3, 32, 32, device="meta")
    b = torch.empty(32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        trb.fused_residual_unit(x, w, b, w, b, 3, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        tms.fused_mrf_stage(x, [[(w, b, w, b)]], (3,), ((1,),))


@pytest.mark.parametrize("case", ["dtype", "channels", "shape", "contiguous", "mixed"])
def test_operand_checks(case):
    x = torch.zeros(2, 16, 64)
    w, b = torch.zeros(3, 64, 64), torch.zeros(64)
    ops = [w, b, w, b]
    shapes = [(3, 64, 64), (64,), (3, 64, 64), (64,)]
    if case == "dtype":
        x = x.half()
    elif case == "channels":
        x = torch.zeros(2, 16, 48)
    elif case == "shape":
        ops[2] = torch.zeros(5, 64, 64)
    elif case == "contiguous":
        ops[0] = torch.zeros(3, 64, 64).transpose(1, 2)
    elif case == "mixed":
        ops[1] = b.bfloat16()
    with pytest.raises((TypeError, ValueError)):
        trb.check_operands("test", x, ops, shapes)


def test_operand_checks_accept_valid():
    x = torch.zeros(2, 16, 64, dtype=torch.bfloat16)
    w, b = torch.zeros(3, 64, 64, dtype=torch.bfloat16), torch.zeros(64, dtype=torch.bfloat16)
    trb.check_operands("test", x, [w, b, w, b], [(3, 64, 64), (64,), (3, 64, 64), (64,)])


@pytest.mark.parametrize("c", [128, 256])
def test_unit_tile_fits_shared_memory_at_main_path_shapes(c):
    for k in V1_KS:
        for d in (1, 3, 5):
            tile = trb.unit_tile(c, k, d, 3072)
            h1, h2 = (k - 1) // 2 * d, (k - 1) // 2
            smem = 4 * c * ((tile + 2 * (h1 + h2)) + (tile + 2 * h2) + trb.CI_CHUNK)
            assert tile > 0 and smem <= trb.SMEM_LIMIT
            # conv1 covers a whole number of 64-row passes
            assert (tile + 2 * h2) % trb.ROWS_PER_PASS == 0


@pytest.mark.parametrize("c,want_tile", [(64, 192), (32, 512)])
def test_stage_tile_at_main_path_shapes(c, want_tile):
    halo = tms.stage_halo(V1_KS, V1_DS)
    assert halo == 60  # k=11: 5*(1+1) + 5*(3+1) + 5*(5+1)
    tile = tms.stage_tile(c, halo, 49152)
    assert tile == want_tile
    assert 4 * c * (2 * (tile + 2 * halo) + tile + trb.CI_CHUNK) <= trb.SMEM_LIMIT
    assert tms.stage_tile(c, halo, 50) == 64  # short inputs get one pass


def test_stage_tile_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        tms.stage_tile(256, 60, 4096)


def test_find_nvcc_raises_when_absent(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_build_targets_sm90a_and_lists_every_source():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    names = sorted(p.rsplit("/", 1)[-1] for p in build._sources())
    assert names == ["mrf_stage.cu", "resblock.cu"]
    assert build.BUILD_DIR.endswith("build/torch_kernels")
