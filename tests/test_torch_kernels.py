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

The f32 kernels multiply on the tensor cores as a 3xTF32 split. Its
arithmetic is emulated here in PyTorch (`conv_same_3xtf32`): within 5e-6 of
max |ref| of the f32 conv and within 1e-5 of the JAX references, 20x inside
ATOL, where one TF32 product per f32 product misses by more than 1e-4.
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
from emotivoice_tpu_torch.ops.cuda import kernel_bench
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


def test_tf32_round_is_nearest_with_ties_away():
    v = torch.from_numpy(np.random.RandomState(7).randn(50000).astype(np.float32) * 3)
    r = trb.tf32_round(v)
    assert int((r.view(torch.int32) & 0x1FFF).abs().max()) == 0  # 10-bit mantissa
    assert float(((r - v).abs() / v.abs()).max()) <= 2.0 ** -11
    # 1 + 2**-11 lies halfway between two TF32 values: away from zero, both signs
    tie = torch.tensor([1.0 + 2.0 ** -11, -1.0 - 2.0 ** -11])
    assert trb.tf32_round(tie).tolist() == [1.0 + 2.0 ** -10, -1.0 - 2.0 ** -10]
    assert torch.equal(trb.tf32_round(r), r)


def _conv_case(c, k, d=3):
    rng = np.random.RandomState(100 * c + k)
    x = torch.from_numpy(rng.randn(2, 203, c).astype(np.float32) * 0.5)
    w = torch.from_numpy(rng.randn(k, c, c).astype(np.float32) * 0.1)
    b = torch.from_numpy(rng.randn(c).astype(np.float32) * 0.05)
    return x, w, b, d


@pytest.mark.parametrize("c", [32, 64])
@pytest.mark.parametrize("k", [3, 11])
def test_3xtf32_conv_matches_f32_conv(c, k):
    x, w, b, d = _conv_case(c, k)
    want = trb.conv_same(x, w, b, d)
    got = trb.conv_same_3xtf32(x, w, b, d)
    scale = float(want.abs().max())
    assert scale > 0.1
    assert float((got - want).abs().max()) <= 5e-6 * scale


def test_one_tf32_product_is_not_enough():
    """Why three terms are taken: the head*head product alone (what the
    tensor cores give f32 operands as plain TF32) misses the f32 conv by
    more than 1e-4 of max at C=64 k=11, half of ATOL after one conv of 36."""
    x, w, b, d = _conv_case(64, 11)
    want = trb.conv_same(x, w, b, d)
    got = trb.conv_same_3xtf32(x, w, b, d, terms=1)
    assert float((got - want).abs().max()) > 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("k,d,c", [(3, 1, 32), (7, 3, 64), (11, 5, 32)])
def test_residual_unit_3xtf32_matches_jax_reference(k, d, c):
    rng = np.random.RandomState(k * 10 + d)
    x = rng.randn(2, 203, c).astype(np.float32) * 0.5
    w1, b1, w2, b2 = _unit(rng, k, c)
    want = np.asarray(jrb.fused_residual_unit_reference(*_j([x, w1, b1, w2, b2]), k, d))
    got = trb.residual_unit_3xtf32(*_t([x, w1, b1, w2, b2]), k, d).numpy()
    scale = np.max(np.abs(want))
    assert scale > 0.1
    assert np.max(np.abs(got - want)) <= 1e-5 * scale


@pytest.mark.parametrize("c", [32, 64])
def test_mrf_stage_3xtf32_matches_jax_reference(c):
    rng = np.random.RandomState(c)
    x = rng.randn(2, 301, c).astype(np.float32) * 0.5
    ws = _stage(rng, V1_KS, V1_DS, c)
    want = np.asarray(jps.mrf_stage_reference(jnp.asarray(x), _j(ws), V1_KS, V1_DS))
    got = tms.mrf_stage_3xtf32(torch.from_numpy(x), _t(ws), V1_KS, V1_DS).numpy()
    scale = np.max(np.abs(want))
    assert scale > 0.1
    assert np.max(np.abs(got - want)) <= 1e-5 * scale


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
            tile = trb.unit_tile(c, k, d, t, dtype, batch=16, n_sm=132)
            box, n_box, stages, smem = trb.unit_plan(c, k, d, tile, dtype)
            kc, most = trb.wg_cfg(c, dtype)[1:3]
            # x tile (slabs of box rows, reused for the intermediate), slack, barriers, ring:
            # f32 stages hold a head and a tail tile and 3 mbarriers, bf16 one tile and 2
            stage = 2 * c * kc * 4 + 24 if dtype == torch.float32 else c * kc * 2 + 16
            assert smem == 1024 + dtype.itemsize * c * box * n_box + 8 + stages * stage
            assert box * n_box >= tile + 2 * (h1 + h2) and box % 8 == 0 and box <= 256
            assert 2 <= stages <= most and smem <= trb.SMEM_LIMIT
            # the tile or conv1 covers whole m64 wgmma tiles
            assert tile % trb.WGMMA_ROWS == 0 or (tile + 2 * h2) % trb.WGMMA_ROWS == 0
            passes = -(-(tile + 2 * h2) // trb.pass_rows(c, dtype))
            # conv1 in one pass (f32) or up to three (bf16)
            assert passes <= {torch.float32: 1, torch.bfloat16: 3}[dtype]
            assert tile >= h1 + h2  # the tile covers one side's halo


def test_unit_tile_bf16_fills_whole_waves():
    """bf16 rows are 512 bytes at C=256, so a tile holds conv1 over several
    128-row passes. At the bench bucket (16 x 3072 rows) 192-row tiles make
    256 blocks, 1.94 waves of 132 SMs, where one-pass tiles (118 rows at k=11
    d=5) make 432 blocks, 4 waves of less work each; with one batch row every
    tile fits one wave, so the least work per block wins; with enough SMs for
    every 118-row block, that tile does. At C=128 conv1 takes three passes
    (374 rows at k=11: 1056 blocks, 8 waves)."""
    bf = torch.bfloat16
    assert trb.unit_tile(256, 11, 5, 3072, bf, batch=16, n_sm=132) == 192
    assert trb.unit_tile(256, 11, 5, 3072, bf, batch=1, n_sm=132) == 54
    assert trb.unit_tile(256, 11, 5, 3072, bf, batch=16, n_sm=432) == 118
    assert trb.unit_tile(128, 11, 5, 24576, bf, batch=16, n_sm=132) == 374
    assert trb.unit_plan(256, 11, 5, 192, bf) == (256, 1, 4, 197_704)
    assert trb.unit_plan(128, 11, 5, 374, bf) == (224, 2, 4, 181_320)
    # a tile whose x rows leave no room for two 16 KB stages is not taken
    assert trb.unit_plan(256, 11, 5, 374, bf)[2] == 0


def test_unit_tile_f32_is_bounded_by_shared_memory():
    """f32 rows are 1 KB at C=256, and a ring stage is 16 KB (8 input
    channels of 256 outputs, head and tail). At k=11 d=5 the 118-row tile
    (conv1 one 128-row pass) needs 178 x rows, in a 184-row box: 189,448
    bytes beside the ring leave room for 2 stages, where k=3 d=1 keeps 4.
    Every weight byte a block streams then serves 118-126 rows at C=256,
    against 54-94 in the mma.sync core; at C=128 a 32-channel stage (32 KB)
    serves 118-126 rows in one pass of one m64 tile per warpgroup."""
    f32 = torch.float32
    assert trb.stage_bytes(256, f32) == 16_408
    assert trb.unit_plan(256, 11, 5, 118, f32) == (184, 1, 2, 222_264)
    assert trb.unit_plan(256, 3, 1, 126, f32) == (136, 1, 4, 205_928)
    assert trb.unit_tile(256, 11, 5, 3072, f32, batch=16, n_sm=132) == 118
    assert trb.unit_tile(256, 3, 1, 3072, f32, batch=16, n_sm=132) == 126
    assert trb.unit_tile(128, 11, 5, 24576, f32, batch=16, n_sm=132) == 118
    # a tile whose x rows leave no room for two stages is not taken
    assert trb.unit_plan(256, 11, 5, 182, f32)[2] == 0


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_tile_planners_refuse_other_dtypes(dtype):
    with pytest.raises(TypeError, match="no kernel"):
        trb.unit_tile(128, 3, 1, 1024, dtype)
    with pytest.raises(TypeError, match="no kernel"):
        tms.stage_tile(64, V1_KS, V1_DS, 1024, dtype)


@pytest.mark.parametrize("c,dtype,want_tile", [
    (64, torch.float32, 240), (32, torch.float32, 704),
    (64, torch.bfloat16, 680), (32, torch.bfloat16, 1336),
])
def test_stage_tile_at_main_path_shapes(c, dtype, want_tile):
    halo = tms.stage_halo(V1_KS, V1_DS)
    assert halo == 60  # k=11: 5*(1+1) + 5*(3+1) + 5*(5+1)
    t = {64: 128 * 384, 32: 256 * 384}[c]  # stages 3-4 of the bench bucket
    tile = tms.stage_tile(c, V1_KS, V1_DS, t, dtype, batch=16, n_sm=132)
    assert tile == want_tile
    box, n_box, stages, smem = tms.stage_plan(c, halo, tile, dtype)
    kc, most = trb.wg_cfg(c, dtype)[1:3]
    stage = 2 * c * kc * 4 + 24 if dtype == torch.float32 else c * kc * 2 + 16
    # chain activation and intermediate (slabs of box rows each), ring, slack; the
    # chain sum stays in y, in both dtypes
    assert smem == 1024 + dtype.itemsize * c * 2 * box * n_box + stages * stage + 8
    assert box * n_box >= tile + 2 * halo and 2 <= stages <= most and tile % 8 == 0
    assert smem <= trb.SMEM_LIMIT
    assert tms.stage_tile(c, V1_KS, V1_DS, 50, dtype) == 16  # short inputs: small tiles


def _assert_stage_tile_plans_whole_wgmma_tiles(c, t, dtype, least):
    tile = tms.stage_tile(c, V1_KS, V1_DS, t, dtype, batch=16, n_sm=132)
    rows = tms.stage_convs(tile, V1_KS, V1_DS)
    assert len(rows) == 18 and rows[-1] == tile and max(rows) == tile + 110
    m64 = sum(-(-n // trb.WGMMA_ROWS) for n in rows)
    assert 18 * tile / (trb.WGMMA_ROWS * m64) >= least
    passes = sum(-(-n // trb.pass_rows(c, dtype)) for n in rows)
    waves = -(-16 * -(-t // tile) // 132)
    for other in range(8, tms.MAX_TILE[dtype] + 1, 8):  # none does less work for its waves
        if not tms.stage_plan(c, 60, other, dtype)[2]:
            break
        o_rows = tms.stage_convs(other, V1_KS, V1_DS)
        o_work = sum(-(-n // trb.WGMMA_ROWS) + -(-n // trb.pass_rows(c, dtype)) for n in o_rows)
        assert waves * (m64 + passes) <= -(-16 * -(-t // other) // 132) * o_work


@pytest.mark.parametrize("c,t,least", [(64, 128 * 384, 0.80), (32, 256 * 384, 0.91)])
def test_stage_tile_f32_plans_whole_wgmma_tiles(c, t, least):
    """The f32 tile is the one whose 18 convs waste the least of their m64
    wgmma tiles and passes (the k=11 chain's first conv, tile + 110 rows,
    among them), against the waves it makes: at the bench bucket its convs
    run at least 80% (C=64) / 91% (C=32) useful rows in whole m64 tiles.
    Each of them beat the neighbouring tiles on the card (PERF.md)."""
    _assert_stage_tile_plans_whole_wgmma_tiles(c, t, torch.float32, least)


@pytest.mark.parametrize("c,t,least", [(64, 128 * 384, 0.91), (32, 256 * 384, 0.95)])
def test_stage_tile_bf16_plans_whole_wgmma_tiles(c, t, least):
    """The same planner for bf16, whose rows are half as wide and whose
    chain sum left shared memory too: tiles of 680 (C=64) and 1336 (C=32)
    rows, at least 91% / 95% useful rows in whole m64 tiles, 9 waves each.
    The C=64 tile beat 440 and 568 rows on the card (PERF.md)."""
    _assert_stage_tile_plans_whole_wgmma_tiles(c, t, torch.bfloat16, least)


@pytest.mark.parametrize("dtype", DTYPES)
def test_stage_tile_refuses_what_does_not_fit(dtype):
    """A chain of four k=11 d=5 units has a 120-row halo: at C=256 its two
    tiles alone exceed shared memory in either dtype. The V1 stage at C=256
    does not fit in f32; in bf16 (512-byte rows, the chain sum in y) it does."""
    with pytest.raises(ValueError, match="shared memory"):
        tms.stage_tile(256, (11,), ((5, 5, 5, 5),), 4096, dtype)
    if dtype == torch.float32:
        with pytest.raises(ValueError, match="shared memory"):
            tms.stage_tile(256, V1_KS, V1_DS, 4096, dtype)
    else:
        tile = tms.stage_tile(256, V1_KS, V1_DS, 4096, dtype)
        assert tms.stage_plan(256, 60, tile, dtype)[2] >= 2


def test_core_config_matches_the_cuda_header():
    """The wrappers' WG_CFG_BF16 mirrors WgCfgBf16<C> of the bf16 core
    (wgmma_conv_bf16.cuh), from which the bf16 kernels size shared memory and
    plan passes; each keeps its accumulators within the registers (kMT * C /
    2 <= 128), its stage whole k16 steps of one tap and its boxes aligned to
    the swizzle atoms. WG_CONSUMERS mirrors the block shape both cores share
    (conv_tile.cuh), and the mma.sync core is gone."""
    with open(os.path.join(build.CSRC_DIR, "wgmma_conv_bf16.cuh")) as f:
        header = f.read()
    cfg = {
        int(c): tuple(int(v) for v in vals)
        for c, *vals in re.findall(
            r"struct WgCfgBf16<(\d+)> \{ static constexpr int kMT = (\d+), kKC = (\d+), "
            r"kStages = (\d+), kWait = (\d+); \};", header)
    }
    assert cfg == trb.WG_CFG_BF16 and sorted(cfg) == list(trb.CHANNELS)
    for c, (mt, kc, stages, wait) in cfg.items():
        assert mt * c // 2 <= 128 and kc % 16 == 0 and c % kc == 0 and stages >= 2
        assert wait in (0, 1) and kc * min(c, 64) * 2 % 1024 == 0
        assert trb.pass_rows(c, torch.bfloat16) == trb.WG_CONSUMERS * mt * trb.WGMMA_ROWS
    with open(os.path.join(build.CSRC_DIR, "conv_tile.cuh")) as f:
        consts = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", f.read()))
    assert int(consts["kConsumerWGs"]) == trb.WG_CONSUMERS
    assert consts["kWgBlock"] == "kConsumers + 128" and consts["kConsumers"] == "128 * kConsumerWGs"
    for name in os.listdir(build.CSRC_DIR):
        with open(os.path.join(build.CSRC_DIR, name)) as f:
            text = f.read()
        assert "MmaCfg" not in text and "mma.sync.aligned" not in text, name


def test_wg_config_matches_the_cuda_header():
    """WG_CFG mirrors WgCfg<C> of the f32 core (wgmma_conv_f32.cuh), from
    which the f32 kernels size shared memory; each config keeps its
    accumulators within the registers (kMT * C / 2 <= 128) and its stage a
    whole swizzle mode."""
    with open(os.path.join(build.CSRC_DIR, "wgmma_conv_f32.cuh")) as f:
        header = f.read()
    cfg = {
        int(c): tuple(int(v) for v in vals)
        for c, *vals in re.findall(
            r"struct WgCfg<(\d+)> \{ static constexpr int kMT = (\d+), kKC = (\d+), "
            r"kStages = (\d+); \};", header)
    }
    assert cfg == trb.WG_CFG and sorted(cfg) == list(trb.CHANNELS)
    for c, (mt, kc, stages) in cfg.items():
        assert mt * c // 2 <= 128 and kc in (8, 16, 32) and c % kc == 0 and stages >= 2
        assert c * kc * 4 % 1024 == 0  # stages stay aligned to the swizzle atoms
        assert trb.pass_rows(c, torch.float32) == trb.WG_CONSUMERS * mt * trb.WGMMA_ROWS


@pytest.mark.parametrize("k", V1_KS)
def test_f32_relayout_is_exact_and_splits_within_2_pow_minus_22(k):
    """kmajor hands the f32 kernels (K, C_out, C_in) copies of the HIO
    weights, bit-equal; the head (truncated to TF32, as the tensor cores read
    the raw tile) plus the tail (made beside each stage) gives w back within
    2**-22 |w|, for the unit's packing and the stage's."""
    rng = np.random.RandomState(k)
    c = 64
    w1, _, w2, _ = _t(_unit(rng, k, c))
    km = trb.kmajor((w1, w2))
    assert km.shape == (2 * k, c, c) and km.is_contiguous()
    assert torch.equal(km[:k].transpose(1, 2), w1) and torch.equal(km[k:].transpose(1, 2), w2)
    ws = _t(_stage(rng, V1_KS, V1_DS, c))
    packed, taps1, taps2 = tms.pack_stage_f32(ws)
    for buf in (km, packed):
        head, tail = trb.weight_split(buf)
        assert int((head.view(torch.int32) & 0x1FFF).abs().max()) == 0  # TF32
        assert int((tail.view(torch.int32) & 0x1FFF).abs().max()) == 0
        assert torch.equal(head, trb.tf32_trunc(buf))
        assert bool(((head + tail - buf).abs() <= 2.0 ** -22 * buf.abs()).all())


def test_stage_weight_buffer_offsets_address_every_conv():
    """pack_stage_f32's taps1 / taps2 are each unit's first tap of w1 and w2
    in the one K-major buffer, chains and units in the order the kernel runs
    them: every conv's weight is found there, and the buffer has no other."""
    rng = np.random.RandomState(5)
    c = 32
    ks, ds = (3, 7, 11), ((1, 3, 5), (1, 3), (2,))
    ws = _t(_stage(rng, ks, ds, c))
    packed, taps1, taps2 = tms.pack_stage_f32(ws)
    assert packed.shape == (sum(2 * k * len(d) for k, d in zip(ks, ds)), c, c)
    q = 0
    for k, units in zip(ks, ws):
        for w1, _, w2, _ in units:
            assert torch.equal(packed[taps1[q]:taps1[q] + k].transpose(1, 2), w1)
            assert torch.equal(packed[taps2[q]:taps2[q] + k].transpose(1, 2), w2)
            q += 1
    assert q == len(taps1) == len(taps2) == 6
    assert taps1[0] == 0 and taps2[-1] + ks[-1] == packed.shape[0]


def test_weight_split_is_truncated_head_and_rounded_tail():
    """The f32 core's B split: head = w with its low 13 bits cleared (what
    the tensor cores read of the raw TMA tile), tail = w - head rounded to
    TF32 (tf32_round, ties away from zero), as weight_tail makes it."""
    w = torch.from_numpy(np.random.RandomState(9).randn(4096).astype(np.float32))
    head, tail = trb.weight_split(w)
    assert torch.equal(head.view(torch.int32), w.view(torch.int32) & -0x2000)
    assert torch.equal(tail, trb.tf32_round(w - head))
    assert float(((w - head) / w.abs()).abs().max()) < 2.0 ** -10  # truncation, not rounding


def test_chip_smoke_counts_tensor_core_instructions_per_instantiation():
    sass = "\n".join([
        "\t\tFunction : _ZN3evt20residual_unit_kernelILi256E13__nv_bfloat16EEv14CUtensorMap_stS2_S2_PKS1_S4_S4_PS1_iiiiiii",
        "        /*0100*/                   UTMALDG.3D [UR8], [UR4] ;",
        "        /*0a30*/                   HGMMA.64x256x16.F32.BF16 R24, R16, gdesc[UR4], R24 ;",
        "        /*0a40*/                   HGMMA.64x256x16.F32.BF16 R24, R20, gdesc[UR8], R24, gsb0 ;",
        "\t\tFunction : _ZN3evt20residual_unit_kernelILi256EfEEv14CUtensorMap_stS1_PKfS3_S3_Pfiiiiiii",
        "        /*0100*/                   UTMALDG.3D [UR8], [UR4] ;",
        "        /*0110*/                   FADD R4, R5, R6 ;",
        "        /*0120*/                   HGMMA.64x256x8.F32.TF32 R24, R16, gdesc[UR4], R24 ;",
        "        /*0130*/                   HGMMA.64x256x8.F32.TF32 R24, R20, gdesc[UR8], R24, gsb0 ;",
        "\t\tFunction : _ZN3evt16mrf_stage_kernelILi64EfEEv14CUtensorMap_stS1_PfNS_12StageArgsF32Eiiiiii",
        "        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;",
        "        /*0110*/                   HGMMA.64x64x8.F32.TF32 R24, R16, gdesc[UR4], R24 ;",
        "\t\tFunction : _ZN3evt16mrf_stage_kernelILi64E13__nv_bfloat16EEv14CUtensorMap_stPS1_NS_13StageArgsBf16Eiiiiii",
        "        /*0200*/                   UTMALDG.2D [UR8], [UR4] ;",
        "        /*0210*/                   HMMA.16816.F32.BF16 R4, R12, R20, R4 ;",
        "        /*0220*/                   HGMMA.64x64x16.F32.BF16 R24, R16, gdesc[UR4], R24 ;",
        "\t\tFunction : _ZN3evt16mrf_stage_kernelILi32E13__nv_bfloat16EEv14CUtensorMap_stPS1_NS_13StageArgsBf16Eiiiiii",
        "        /*0200*/                   HGMMA.64x32x16.F32.BF16 R24, R16, gdesc[UR4], R24 ;",
        "\t\tFunction : _ZN3evt16mrf_stage_kernelILi32EfEEv14CUtensorMap_stS1_PfNS_12StageArgsF32Eiiiiii",
        "        /*0300*/                   FFMA R4, R5, R6, R4 ;",
        "\t\tFunction : _ZN3evt4attn16attention_kernelI13__nv_bfloat16EEv14CUtensorMap_stS3_PKT_PKhPS4_iif",
        "        /*0100*/                   UTMALDG.3D [UR8], [UR4] ;",
        "        /*0200*/                   HGMMA.64x64x16.F32.BF16 R24, R16, gdesc[UR4], R24 ;",
        "\t\tFunction : _ZN3evt4attn16attention_kernelIfEEv14CUtensorMap_stS2_PKT_PKhPS3_iif",
        "        /*0100*/                   UTMALDG.3D [UR8], [UR4] ;",
        "        /*0300*/                   FFMA R4, R5, R6, R4 ;",
        "\t\tFunction : some_other_kernel",
        "        /*0300*/                   HMMA.16816.F32.BF16 R4, R12, R20, R4 ;",
    ])
    counts = chip_smoke.parse_sass_mma(sass)
    zero = dict.fromkeys(("HMMA", "HGMMA", "UTMALDG"), 0)
    assert counts == {
        ("residual_unit_kernel", 256, "bf16"): {**zero, "HGMMA": 2, "UTMALDG": 1},
        ("residual_unit_kernel", 256, "f32"): {**zero, "HGMMA": 2, "UTMALDG": 1},
        ("mrf_stage_kernel", 64, "f32"): {**zero, "HMMA": 1, "HGMMA": 1},
        ("mrf_stage_kernel", 64, "bf16"): {**zero, "HMMA": 1, "HGMMA": 1, "UTMALDG": 1},
        ("mrf_stage_kernel", 32, "bf16"): {**zero, "HGMMA": 1},
        ("mrf_stage_kernel", 32, "f32"): zero,
        ("attention_kernel", 0, "bf16"): {**zero, "HGMMA": 1, "UTMALDG": 1},
        ("attention_kernel", 0, "f32"): {**zero, "UTMALDG": 1},
    }
    faults = chip_smoke.sass_faults(counts)
    # both dtypes: an HMMA beside the HGMMAs (the mma.sync cores), no TMA, or nothing at all
    assert [f.split(":")[0] for f in faults] == [
        "mrf_stage_kernel<32, bf16>", "mrf_stage_kernel<64, bf16>",
        "mrf_stage_kernel<32, f32>", "mrf_stage_kernel<64, f32>"]
    # a kernel of which a dtype has no instantiation at all
    del counts[("residual_unit_kernel", 256, "bf16")]
    assert "residual_unit_kernel: no bf16 instantiation" in chip_smoke.sass_faults(counts)
    good = {("residual_unit_kernel", 256, "bf16"): {**zero, "HGMMA": 2, "UTMALDG": 1},
            ("residual_unit_kernel", 256, "f32"): {**zero, "HGMMA": 2, "UTMALDG": 1},
            ("mrf_stage_kernel", 32, "bf16"): {**zero, "HGMMA": 1, "UTMALDG": 2},
            ("mrf_stage_kernel", 32, "f32"): {**zero, "HGMMA": 1, "UTMALDG": 1},
            ("attention_kernel", 0, "bf16"): {**zero, "HGMMA": 3, "UTMALDG": 2},
            ("attention_kernel", 0, "f32"): {**zero, "UTMALDG": 2}}
    assert chip_smoke.sass_faults(good) == []
    # the attention kernel: bf16 on wgmma, both dtypes through TMA
    for key, n in ((("attention_kernel", 0, "bf16"), {**zero, "UTMALDG": 2}),
                   (("attention_kernel", 0, "f32"), zero)):
        assert [f.split(":")[0] for f in chip_smoke.sass_faults({**good, key: n})] == [
            f"attention_kernel<0, {key[2]}>"]
    # the bf16 mma.sync core's listing, which [build] accepted before, is refused
    old = {**good, ("mrf_stage_kernel", 32, "bf16"): {**zero, "HMMA": 4}}
    assert [f.split(":")[0] for f in chip_smoke.sass_faults(old)] == ["mrf_stage_kernel<32, bf16>"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_bench_patches_one_config_line(dtype):
    """A --cfg variant replaces the config struct of that C and core only."""
    fname, line = kernel_bench.CFG_LINE[dtype]
    with open(os.path.join(build.CSRC_DIR, fname)) as f:
        header = f.read()
    if dtype == torch.float32:
        text, mirror = "256:1,16,3;64:2,16,4", trb.WG_CFG
        cfg = {256: (1, 16, 3), 64: (2, 16, 4)}
        bad = "48:1,2,3"
    else:
        text, mirror = "256:1,64,6,0;64:3,32,5,1", trb.WG_CFG_BF16
        cfg = {256: (1, 64, 6, 0), 64: (3, 32, 5, 1)}
        bad = "48:1,2,3,4"
    assert kernel_bench.parse_cfg(text, dtype) == cfg
    patched = kernel_bench.patch_header(header, cfg, dtype)
    changed = [(a, b) for a, b in zip(header.splitlines(), patched.splitlines()) if a != b]
    assert len(changed) == 2 and len(header.splitlines()) == len(patched.splitlines())
    assert line % (256, *cfg[256]) in patched
    assert line % (128, *mirror[128]) in patched  # untouched
    with pytest.raises(ValueError, match="no config struct"):
        kernel_bench.patch_header(header, {48: cfg[64]}, dtype)
    with pytest.raises(ValueError, match="--cfg wants"):
        kernel_bench.parse_cfg(bad, dtype)
    with pytest.raises(ValueError, match="--cfg wants"):  # the other core's arity
        kernel_bench.parse_cfg(text, torch.bfloat16 if dtype == torch.float32 else torch.float32)


@pytest.mark.parametrize("name", sorted(kernel_bench.SKIPS))
def test_kernel_bench_skip_patches_one_bf16_source_line(name):
    """--skip leaves one part of the bf16 kernels out by patching one line
    of one source: the line must be there exactly once, and nothing else
    changes."""
    fname = kernel_bench.SKIPS[name][0]
    with open(os.path.join(build.CSRC_DIR, fname)) as f:
        text = f.read()
    patched = kernel_bench.patch_skip(text, name)
    changed = [(a, b) for a, b in zip(text.splitlines(), patched.splitlines()) if a != b]
    assert len(changed) == 1 and len(text.splitlines()) == len(patched.splitlines())
    with pytest.raises(ValueError, match="not there once"):
        kernel_bench.patch_skip(patched, name)


def test_kernel_bench_reckons_the_l2_weight_stream():
    """Each f32 block streams each conv's K x C x C weights from L2 once per
    pass: at C=256 k=11 d=5 of the bench bucket 432 blocks of 118 rows read
    2 x 5.77 MB each; the stage's 18 convs at C=64 read their taps once per
    256-row pass. The bf16 blocks of 192 rows read 2 x 1.44 MB twice (conv1's
    202 rows and conv2's 192 in two 128-row passes each)."""
    assert kernel_bench.l2_weight_bytes("unit", 256, 3072, 11, 5) == 432 * 2 * 11 * 256 * 256 * 4
    assert (kernel_bench.l2_weight_bytes("unit", 256, 3072, 11, 5, dtype=torch.bfloat16)
            == 256 * 4 * 11 * 256 * 256 * 2)
    tile = tms.stage_tile(64, V1_KS, V1_DS, 49152, torch.float32, 16, 132)
    rows = tms.stage_convs(tile, V1_KS, V1_DS)
    taps = [k for k in V1_KS for _ in range(6)]
    per_block = sum(-(-n // 256) * k * 64 * 64 * 4 for n, k in zip(rows, taps))
    assert kernel_bench.l2_weight_bytes("stage", 64, 49152) == 16 * -(-49152 // tile) * per_block


def test_kernel_bench_forces_tiles_and_restores_the_planners():
    assert kernel_bench.parse_tiles("unit256:118,128;stage64:168") == {
        "unit256": (118, 128), "stage64": (168,)}
    with pytest.raises(ValueError, match="--tiles wants"):
        kernel_bench.parse_tiles("unit48:64")
    planned = tms.stage_tile(64, V1_KS, V1_DS, 49152, torch.float32, 16, 132)
    with kernel_bench.forced_tile("stage", 144), kernel_bench.forced_tile("unit", 64):
        assert tms.stage_tile(64, V1_KS, V1_DS, 49152, torch.float32, 16, 132) == 144
        assert trb.unit_tile(256, 3, 1, 3072, torch.float32, 16, 132) == 64
    assert tms.stage_tile(64, V1_KS, V1_DS, 49152, torch.float32, 16, 132) == planned
    assert trb.unit_tile(256, 3, 1, 3072, torch.float32, 16, 132) == 126


def test_kernel_bench_reads_registers_and_spills():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN3evt16mrf_stage_kernelILi128EfEEvPKT0_PS1_NS_9StageArgsEiii' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN3evt16mrf_stage_kernelILi128EfEEvPKT0_PS1_NS_9StageArgsEiii",
        "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers, 8 bytes cumulative stack size",
        "ptxas info    : Compiling entry function '_ZN3evt20residual_unit_kernelILi256E13__nv_bfloat16EEvPKT0_S4_S4_S4_S4_PS2_iiii' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 251 registers, used 1 barriers",
    ])
    assert kernel_bench.ptxas_summary(log) == [
        ("mrf_stage_kernel", 128, "f", 255, "8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads"),
        ("residual_unit_kernel", 256, "13__nv_bfloat16", 251, ""),
    ]


def test_kernel_bench_needs_a_card(capsys):
    assert kernel_bench.main([]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err


def test_find_nvcc_raises_when_absent(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_build_targets_sm90a_and_lists_every_source():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    names = sorted(p.rsplit("/", 1)[-1] for p in build._sources())
    assert names == ["aa_snake.cu", "attention.cu", "mrf_stage.cu", "resblock.cu"]
    headers = sorted(p.rsplit("/", 1)[-1] for p in os.listdir(build.CSRC_DIR) if p.endswith(".cuh"))
    # all hashed into the stamp; the mma.sync cores (mma_conv.cuh, mma_conv_f32.cuh) are gone
    assert headers == ["conv_tile.cuh", "hopper.cuh", "wgmma_conv_bf16.cuh", "wgmma_conv_f32.cuh"]
    assert build.BUILD_DIR.endswith("build/torch_kernels")
