"""The port's two MRF kernels on the CPU: their plain versions against the
JAX package's references (and, for one shape each, its Pallas kernels in
interpret mode), the wrappers' dispatch and checks, and the launch
geometry the CUDA sources rely on. The kernels themselves run only on the
card; `chip_smoke.py` holds each one against its plain version there.

Tolerance: atol 2e-4 in f32, as tests/test_pallas.py uses for the same
math. In bf16 the plain version (the one the card check holds the kernel's
bf16 path against) must round where the JAX reference rounds: at least 99%
of a residual unit's outputs bit-equal (95% of a whole stage's, whose 18
convs carry a flipped rounding on), the rest within one bf16 step of the
largest value (2**-7 * max |ref|); sums taken in another order flip a few
roundings. Rounding lrelu as F.leaky_relu does fails both shares.
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import test_torch_support  # noqa: F401  (one intra-op thread per worker)
from emotivoice_tpu.ops.pallas import packed_stage as jps
from emotivoice_tpu.ops.pallas import resblock as jrb
from emotivoice_tpu_torch.ops.cuda import build
from emotivoice_tpu_torch.ops.cuda import mrf_stage as tms
from emotivoice_tpu_torch.ops.cuda import resblock as trb

ATOL = 2e-4
BF16_EQUAL_UNIT = 0.99  # outputs bit-equal to the JAX reference in bf16
BF16_EQUAL_STAGE = 0.95
BF16_STEP = 2.0 ** -7  # one bf16 rounding step, relative to max |ref|
V1_KS = (3, 7, 11)
V1_DS = ((1, 3, 5),) * 3
DTYPES = [torch.float32, torch.bfloat16]


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


def _jbf16(ws):
    if isinstance(ws, np.ndarray):
        return jnp.asarray(ws).astype(jnp.bfloat16)
    return tuple(_jbf16(w) for w in ws)


def _tbf16(ws):
    if isinstance(ws, np.ndarray):
        return torch.from_numpy(ws).bfloat16()
    return [_tbf16(w) for w in ws]


def _assert_bf16_rounds_as_jax(got, want, equal_share):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    scale = np.max(np.abs(want))
    assert scale > 0.1
    assert np.mean(got == want) >= equal_share
    assert np.max(np.abs(got - want)) <= BF16_STEP * scale


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


@pytest.mark.parametrize("k,d,c", [(3, 1, 32), (11, 5, 64)])
def test_residual_unit_plain_rounds_as_jax_in_bf16(k, d, c):
    """The bf16 plain version rounds where the kernel's epilogue does: after
    each conv, after its bias add, lrelu as max(v, v * bf16(0.1)) rounded
    once, after the residual add."""
    rng = np.random.RandomState(k * 10 + d + 1)
    x = rng.randn(2, 97, c).astype(np.float32) * 0.5
    unit = _unit(rng, k, c)
    want = jrb.fused_residual_unit_reference(*_jbf16([x, *unit]), k, d)
    got = trb.fused_residual_unit(*_tbf16([x, *unit]), k, d)
    _assert_bf16_rounds_as_jax(got, want, BF16_EQUAL_UNIT)


def test_mrf_stage_plain_rounds_as_jax_in_bf16():
    rng = np.random.RandomState(5)
    c = 32
    x = rng.randn(1, 131, c).astype(np.float32) * 0.5
    ws = _stage(rng, V1_KS, V1_DS, c)
    want = jps.mrf_stage_reference(_jbf16(x), _jbf16(ws), V1_KS, V1_DS)
    got = tms.fused_mrf_stage(_tbf16(x), _tbf16(ws), V1_KS, V1_DS)
    _assert_bf16_rounds_as_jax(got, want, BF16_EQUAL_STAGE)


@pytest.mark.parametrize("dtype", DTYPES)
def test_lrelu_is_bit_exact(dtype):
    """bf16: JAX's max(v, v * 0.1), which the kernel computes with __hmax2 /
    __hmul2 on bf16(0.1); f32: F.leaky_relu."""
    v = torch.from_numpy(np.random.RandomState(6).randn(20000).astype(np.float32) * 3).to(dtype)
    got = trb.lrelu(v)
    if dtype == torch.bfloat16:
        jv = jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
        want = torch.from_numpy(np.array(jrb._lrelu(jv).astype(jnp.float32))).bfloat16()
    else:
        want = torch.nn.functional.leaky_relu(v, 0.1)
    assert torch.equal(got, want)


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


@pytest.mark.parametrize("case", ["dtype", "channels", "shape", "contiguous", "mixed",
                                  "misaligned"])
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
    elif case == "misaligned":
        x = torch.zeros(2 * 16 * 64 + 1)[1:].view(2, 16, 64)
    with pytest.raises((TypeError, ValueError)):
        trb.check_operands("test", x, ops, shapes)


def test_operand_checks_accept_valid():
    x = torch.zeros(2, 16, 64, dtype=torch.bfloat16)
    w, b = torch.zeros(3, 64, 64, dtype=torch.bfloat16), torch.zeros(64, dtype=torch.bfloat16)
    trb.check_operands("test", x, [w, b, w, b], [(3, 64, 64), (64,), (3, 64, 64), (64,)])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [128, 256])
def test_unit_tile_fits_shared_memory_at_main_path_shapes(c, dtype):
    t = {256: 8 * 384, 128: 64 * 384}[c]  # stages 1-2 of the bench bucket
    for k in V1_KS:
        for d in (1, 3, 5):
            h1, h2 = (k - 1) // 2 * d, (k - 1) // 2
            if dtype == torch.float32:
                tile = trb.unit_tile(c, k, d, 3072)
                smem = 4 * c * ((tile + 2 * (h1 + h2)) + (tile + 2 * h2) + trb.CI_CHUNK)
                assert tile > 0 and smem <= trb.SMEM_LIMIT
                # conv1 covers a whole number of 64-row passes
                assert (tile + 2 * h2) % trb.ROWS_PER_PASS == 0
                continue
            tile = trb.unit_tile(c, k, d, t, dtype, batch=16, n_sm=132)
            _, _, _, kc, stages = trb.MMA_CFG[c]
            smem = 2 * c * ((tile + 2 * (h1 + h2)) + (tile + 2 * h2) + stages * kc)
            assert smem <= trb.SMEM_LIMIT
            # either conv2 or conv1 covers whole m16 tiles, conv1 one pass
            assert tile % trb.MMA_ROWS == 0 or (tile + 2 * h2) % trb.MMA_ROWS == 0
            assert tile + 2 * h2 <= trb.pass_rows(c, dtype)
            # rows per weight byte from L2, and the tile covers one side's halo
            assert tile >= {256: 64, 128: 128}[c]
            assert tile >= h1 + h2


def test_unit_tile_bf16_fills_whole_waves():
    """At C=256 of the bench bucket (16 x 3072 rows) 96-row tiles make 512
    blocks, 3.9 waves of 132 SMs, where the largest one-pass tile (118 rows
    at k=11 d=5) makes 432, 3.3 waves, of more m16 tiles each. With one batch
    row every tile fits one wave, so the least work per block wins; with
    enough SMs for every 118-row block, the largest tile does."""
    assert trb.unit_tile(256, 11, 5, 3072, torch.bfloat16, batch=16, n_sm=132) == 96
    assert trb.unit_tile(256, 11, 5, 3072, torch.bfloat16, batch=1, n_sm=132) == 64
    assert trb.unit_tile(256, 11, 5, 3072, torch.bfloat16, batch=16, n_sm=432) == 118


@pytest.mark.parametrize("c,dtype,want_tile", [
    (64, torch.float32, 192), (32, torch.float32, 512),
    (64, torch.bfloat16, 320), (32, torch.bfloat16, 768),
])
def test_stage_tile_at_main_path_shapes(c, dtype, want_tile):
    halo = tms.stage_halo(V1_KS, V1_DS)
    assert halo == 60  # k=11: 5*(1+1) + 5*(3+1) + 5*(5+1)
    tile = tms.stage_tile(c, halo, 49152, dtype)
    assert tile == want_tile
    if dtype == torch.float32:
        assert 4 * c * (2 * (tile + 2 * halo) + tile + trb.CI_CHUNK) <= trb.SMEM_LIMIT
    else:
        _, _, _, kc, stages = trb.MMA_CFG[c]
        smem = 2 * c * 2 * (tile + 2 * halo) + 4 * c * tile + 2 * stages * kc * c
        assert smem <= trb.SMEM_LIMIT
        assert tile % trb.MMA_ROWS == 0 and tile >= 2 * halo
    assert tms.stage_tile(c, halo, 50, dtype) == 64  # short inputs get one pass


@pytest.mark.parametrize("dtype", DTYPES)
def test_stage_tile_refuses_what_does_not_fit(dtype):
    with pytest.raises(ValueError, match="shared memory"):
        tms.stage_tile(256, 60, 4096, dtype)


def test_core_config_matches_the_cuda_header():
    """The wrappers' MMA_CFG and WARPS mirror MmaCfg<C> (mma_conv.cuh) and
    kThreads (conv_tile.cuh), from which the kernels size shared memory."""
    with open(os.path.join(build.CSRC_DIR, "mma_conv.cuh")) as f:
        header = f.read()
    cfg = {
        int(c): tuple(int(v) for v in vals)
        for c, *vals in re.findall(
            r"struct MmaCfg<(\d+)> \{ static constexpr int kWN = (\d+), kNT = (\d+), "
            r"kMT = (\d+), kKC = (\d+), kStages = (\d+); \};", header)
    }
    assert cfg == trb.MMA_CFG
    with open(os.path.join(build.CSRC_DIR, "conv_tile.cuh")) as f:
        threads = int(re.search(r"constexpr int kThreads = (\d+);", f.read()).group(1))
    assert threads == 32 * trb.WARPS
    for c, (wn, nt, _, kc, stages) in cfg.items():
        assert wn * nt * 8 == c and kc % 16 == 0 and stages >= 2


def test_chip_smoke_counts_tensor_core_instructions_per_instantiation():
    sass = "\n".join([
        "\t\tFunction : _ZN3evt20residual_unit_kernelILi256E13__nv_bfloat16EEvPKT0_S4_S4_S4_S4_PS2_iiii",
        "        /*0a30*/                   HMMA.16816.F32.BF16 R4, R12, R20, R4 ;",
        "        /*0a40*/                   HMMA.16816.F32.BF16 R8, R12, R22, R8 ;",
        "\t\tFunction : _ZN3evt20residual_unit_kernelILi256EfEEvPKT0_S3_S3_S3_S3_PS1_iiii",
        "        /*0100*/                   FFMA R4, R5, R6, R4 ;",
        "\t\tFunction : _ZN3evt16mrf_stage_kernelILi32E13__nv_bfloat16EEvPKT0_PS2_NS_9StageArgsEiii",
        "        /*0200*/                   HMMA.16816.F32.BF16 R4, R12, R20, R4 ;",
        "\t\tFunction : some_other_kernel",
        "        /*0300*/                   HMMA.16816.F32.BF16 R4, R12, R20, R4 ;",
    ])
    assert chip_smoke.parse_sass_mma(sass) == {
        ("residual_unit_kernel", 256, "bf16"): 2,
        ("residual_unit_kernel", 256, "f32"): 0,
        ("mrf_stage_kernel", 32, "bf16"): 1,
    }


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
