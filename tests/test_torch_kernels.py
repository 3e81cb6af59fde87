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
    _, _, _, kc, stages = trb.MMA_CFG[dtype][c]
    ring = stages * kc * (c + trb.RING_PAD[dtype])  # values in the weight ring
    # rows per weight byte from L2: f32 rows are twice as wide
    least = {torch.bfloat16: {256: 64, 128: 128}, torch.float32: {256: 48, 128: 96}}[dtype][c]
    for k in V1_KS:
        for d in (1, 3, 5):
            h1, h2 = (k - 1) // 2 * d, (k - 1) // 2
            tile = trb.unit_tile(c, k, d, t, dtype, batch=16, n_sm=132)
            smem = dtype.itemsize * (c * ((tile + 2 * (h1 + h2)) + (tile + 2 * h2)) + ring)
            assert smem == trb.unit_smem(c, k, d, tile, dtype) <= trb.SMEM_LIMIT
            # either conv2 or conv1 covers whole m16 tiles, conv1 one pass
            assert tile % trb.MMA_ROWS == 0 or (tile + 2 * h2) % trb.MMA_ROWS == 0
            assert tile + 2 * h2 <= trb.pass_rows(c, dtype)
            assert tile >= least
            assert tile >= h1 + h2  # the tile covers one side's halo


def test_unit_tile_bf16_fills_whole_waves():
    """At C=256 of the bench bucket (16 x 3072 rows) 96-row tiles make 512
    blocks, 3.9 waves of 132 SMs, where the largest one-pass tile (118 rows
    at k=11 d=5) makes 432, 3.3 waves, of more m16 tiles each. With one batch
    row every tile fits one wave, so the least work per block wins; with
    enough SMs for every 118-row block, the largest tile does."""
    assert trb.unit_tile(256, 11, 5, 3072, torch.bfloat16, batch=16, n_sm=132) == 96
    assert trb.unit_tile(256, 11, 5, 3072, torch.bfloat16, batch=1, n_sm=132) == 64
    assert trb.unit_tile(256, 11, 5, 3072, torch.bfloat16, batch=16, n_sm=432) == 118


def test_unit_tile_f32_is_bounded_by_shared_memory():
    """f32 rows are 1 KB at C=256. At k=11 d=5 a tile has 70 halo and
    intermediate rows beside it and the ring takes 33,792 bytes: 64 rows do
    not fit (236,544 of 232,448 bytes), so the tile is 54, conv1 covering
    four whole m16 tiles. At k=3 d=1 a 94-row tile takes the limit exactly."""
    assert trb.weight_smem(256, torch.float32) == 33_792
    assert trb.unit_smem(256, 11, 5, 64, torch.float32) == 236_544
    assert trb.unit_tile(256, 11, 5, 3072, torch.float32, batch=16, n_sm=132) == 54
    assert trb.unit_tile(256, 3, 1, 3072, torch.float32, batch=16, n_sm=132) == 94
    assert trb.unit_smem(256, 3, 1, 94, torch.float32) == trb.SMEM_LIMIT
    assert trb.unit_tile(128, 11, 5, 24576, torch.float32, batch=16, n_sm=132) == 166


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_tile_planners_refuse_other_dtypes(dtype):
    with pytest.raises(TypeError, match="no kernel"):
        trb.unit_tile(128, 3, 1, 1024, dtype)
    with pytest.raises(TypeError, match="no kernel"):
        tms.stage_tile(64, 60, 1024, dtype)


@pytest.mark.parametrize("c,dtype,want_tile", [
    (64, torch.float32, 192), (32, torch.float32, 448),
    (64, torch.bfloat16, 320), (32, torch.bfloat16, 768),
])
def test_stage_tile_at_main_path_shapes(c, dtype, want_tile):
    halo = tms.stage_halo(V1_KS, V1_DS)
    assert halo == 60  # k=11: 5*(1+1) + 5*(3+1) + 5*(5+1)
    tile = tms.stage_tile(c, halo, 49152, dtype)
    assert tile == want_tile
    _, _, _, kc, stages = trb.MMA_CFG[dtype][c]
    ring = stages * kc * (c + trb.RING_PAD[dtype])
    smem = dtype.itemsize * (c * 2 * (tile + 2 * halo) + ring) + 4 * c * tile
    assert smem == tms.stage_smem(c, halo, tile, dtype) <= trb.SMEM_LIMIT
    assert tile % trb.MMA_ROWS == 0 and tile >= 2 * halo
    # every conv of the tile (at most tile + 2 * halo rows) is one pass of the core
    assert tile + 2 * halo <= trb.pass_rows(c, dtype)
    assert tms.stage_tile(c, halo, 50, dtype) == 64  # short inputs get one step


@pytest.mark.parametrize("dtype", DTYPES)
def test_stage_tile_refuses_what_does_not_fit(dtype):
    with pytest.raises(ValueError, match="shared memory"):
        tms.stage_tile(256, 60, 4096, dtype)


def test_core_config_matches_the_cuda_header():
    """The wrappers' MMA_CFG, RING_PAD and WARPS mirror MmaCfg<C, T>
    (mma_conv.cuh for bf16, mma_conv_f32.cuh for float), MmaTile<C, T>::kLd
    and kThreads (conv_tile.cuh), from which the kernels size shared memory."""
    names = {torch.bfloat16: ("mma_conv.cuh", "bf16", 16), torch.float32: ("mma_conv_f32.cuh", "float", 8)}
    for dtype, (fname, tname, k_step) in names.items():
        with open(os.path.join(build.CSRC_DIR, fname)) as f:
            header = f.read()
        cfg = {
            int(c): tuple(int(v) for v in vals)
            for c, *vals in re.findall(
                r"struct MmaCfg<(\d+), %s> \{ static constexpr int kWN = (\d+), kNT = (\d+), "
                r"kMT = (\d+), kKC = (\d+), kStages = (\d+); \};" % tname, header)
        }
        assert cfg == trb.MMA_CFG[dtype]
        for c, (wn, nt, _, kc, stages) in cfg.items():
            assert wn * nt * 8 == c and kc % k_step == 0 and stages >= 2
            if dtype == torch.float32:  # a chunk lies within one tap; whole copies per thread
                assert c % kc == 0 and kc * c // 4 % (32 * trb.WARPS) == 0
    with open(os.path.join(build.CSRC_DIR, "conv_tile.cuh")) as f:
        shared = f.read()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", shared).group(1))
    assert threads == 32 * trb.WARPS
    pad = re.search(r"kLd = std::is_same<T, float>::value \? C \+ (\d+) : C;", shared)
    assert trb.RING_PAD == {torch.bfloat16: 0, torch.float32: int(pad.group(1))}


def test_chip_smoke_counts_tensor_core_instructions_per_instantiation():
    sass = "\n".join([
        "\t\tFunction : _ZN3evt20residual_unit_kernelILi256E13__nv_bfloat16EEvPKT0_S4_S4_S4_S4_PS2_iiii",
        "        /*0a30*/                   HMMA.16816.F32.BF16 R4, R12, R20, R4 ;",
        "        /*0a40*/                   HMMA.16816.F32.BF16 R8, R12, R22, R8 ;",
        "\t\tFunction : _ZN3evt20residual_unit_kernelILi256EfEEvPKT0_S3_S3_S3_S3_PS1_iiii",
        "        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;",
        "        /*0110*/                   FADD R4, R5, R6 ;",
        "        /*0120*/                   HMMA.1688.F32.TF32 R16, R8, R14, R16 ;",
        "        /*0130*/                   HMMA.1688.F32.TF32 R20, R8, R14, R20 ;",
        "\t\tFunction : _ZN3evt16mrf_stage_kernelILi64EfEEvPKT0_PS1_NS_9StageArgsEiii",
        "        /*0100*/                   FFMA R4, R5, R6, R4 ;",
        "\t\tFunction : _ZN3evt16mrf_stage_kernelILi32E13__nv_bfloat16EEvPKT0_PS2_NS_9StageArgsEiii",
        "        /*0200*/                   HMMA.16816.F32.BF16 R4, R12, R20, R4 ;",
        "\t\tFunction : some_other_kernel",
        "        /*0300*/                   HMMA.16816.F32.BF16 R4, R12, R20, R4 ;",
    ])
    assert chip_smoke.parse_sass_mma(sass) == {
        ("residual_unit_kernel", 256, "bf16"): 2,
        ("residual_unit_kernel", 256, "f32"): 3,
        ("mrf_stage_kernel", 64, "f32"): 0,
        ("mrf_stage_kernel", 32, "bf16"): 1,
    }


@pytest.mark.parametrize("fname,tname,dtype", [
    ("mma_conv_f32.cuh", "float", torch.float32), ("mma_conv.cuh", "bf16", torch.bfloat16)])
def test_kernel_bench_patches_one_config_line(fname, tname, dtype):
    """A --cfg variant replaces MmaCfg<C, T> of that C and type only."""
    with open(os.path.join(build.CSRC_DIR, fname)) as f:
        header = f.read()
    cfg = kernel_bench.parse_cfg("256:4,8,4,8,3;64:2,4,5,32,2")
    assert cfg == {256: (4, 8, 4, 8, 3), 64: (2, 4, 5, 32, 2)}
    patched = kernel_bench.patch_header(header, cfg, tname)
    changed = [(a, b) for a, b in zip(header.splitlines(), patched.splitlines()) if a != b]
    assert len(changed) == 2 and len(header.splitlines()) == len(patched.splitlines())
    assert kernel_bench.CFG_LINE % (256, tname, 4, 8, 4, 8, 3) in patched
    assert kernel_bench.CFG_LINE % (128, tname, *trb.MMA_CFG[dtype][128]) in patched  # untouched
    with pytest.raises(ValueError, match="no MmaCfg"):
        kernel_bench.patch_header(header, cfg, "double")
    with pytest.raises(ValueError, match="--cfg wants"):
        kernel_bench.parse_cfg("48:1,2,3,4,5")


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
    assert names == ["mrf_stage.cu", "resblock.cu"]
    headers = sorted(p.rsplit("/", 1)[-1] for p in os.listdir(build.CSRC_DIR) if p.endswith(".cuh"))
    assert headers == ["conv_tile.cuh", "mma_conv.cuh", "mma_conv_f32.cuh"]  # all hashed into the stamp
    assert build.BUILD_DIR.endswith("build/torch_kernels")
