"""The port's fused masked-attention kernel on the CPU: its plain version
against the JAX package's attention, the kernel's tiled algorithm (key tiles
skipped after a row's last valid key, online softmax) emulated in PyTorch,
`attend`'s choice of path, the wrapper's dispatch and checks, and the tile
constants the CUDA source relies on. The kernel itself runs only on the
card; `chip_smoke.py` holds it against its plain version there.

Tolerance: f32, 1e-5 of max |ref| (the same f32 math, summed in another
order). bf16, 2e-2 of max |ref|: the JAX reference keeps the scores f32 out
of its einsum where the plain version, as the port's attention always did,
rounds them to bf16 out of its matmul (~2**-9 of a score of up to ~10 moves a
softmax weight by ~1%); both round the weights and the output to bf16.
"""

import math
import os
import re

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

import test_torch_support  # noqa: F401  (one intra-op thread per worker)
from emotivoice_tpu.models import transformer as jt
from emotivoice_tpu_torch.models import transformer as tt
from emotivoice_tpu_torch.ops.cuda import attention as ta
from emotivoice_tpu_torch.ops.cuda import build
from emotivoice_tpu_torch.utils.masks import NEG_INF

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
H = 2
D = H * ta.HEAD_DIM


def _qkv(b, t, dtype=torch.float32, seed=0, d=D):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(b, t, d, generator=gen).to(dtype) for _ in range(3)]


def _mask(lengths, t):
    return torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def key_tiles(valid_mask):
    """(B,) key tiles the kernel visits for each row of a (B, T) valid mask:
    up to and with the last tile that holds a valid key, 0 for a row with
    none. The tiles it skips hold only masked keys, whose softmax weights
    are exactly 0. The kernel counts them on the device."""
    pos = torch.arange(1, valid_mask.shape[1] + 1)
    last = (valid_mask.long() * pos).amax(dim=1)  # 1 + index of the last valid key, or 0
    return -(-last // ta.KEY_TILE)


def _tiled(q, k, v, valid_mask, n_heads, exp2=False, d_k=None):
    """The kernel's algorithm in f32: per row, key tiles of KEY_TILE up to
    key_tiles(); masked keys at NEG_INF for the running max and p = 0; the
    running max and sum rescale O; O / l at the end, 0 where l is 0. exp2:
    the bf16 path's exponent (scale times log2 e, exp2). d_k: the heads'
    width before the wrapper padded them to the kernel's (the scale's)."""
    b, t, d = q.shape
    d_k_run = d // n_heads
    scale = 1.0 / math.sqrt(d_k or d_k_run) * (1.4426950408889634 if exp2 else 1.0)
    d_k = d_k_run
    ex = torch.exp2 if exp2 else torch.exp
    out = torch.zeros(b, t, d)
    tiles = key_tiles(valid_mask)
    for r in range(b):
        for h in range(n_heads):
            cols = slice(h * d_k, (h + 1) * d_k)
            qh = q[r, :, cols].float()
            m, l, o = torch.full((t,), NEG_INF), torch.zeros(t), torch.zeros(t, d_k)
            for i in range(int(tiles[r])):
                keys = torch.arange(i * ta.KEY_TILE, (i + 1) * ta.KEY_TILE)
                inside = keys < t
                kk, vv = torch.zeros(ta.KEY_TILE, d_k), torch.zeros(ta.KEY_TILE, d_k)
                kk[inside], vv[inside] = (x[r, keys[inside], cols].float() for x in (k, v))
                valid = inside.clone()
                valid[inside] = valid_mask[r, keys[inside]]
                s = torch.where(valid[None], (qh @ kk.T) * scale, torch.tensor(NEG_INF))
                m_new = torch.maximum(m, s.amax(dim=1))
                alpha = ex(m - m_new)
                p = torch.where(valid[None], ex(s - m_new[:, None]), torch.tensor(0.0))
                m, l, o = m_new, l * alpha + p.sum(dim=1), o * alpha[:, None] + p @ vv
            inv = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
            out[r, :, cols] = o * inv[:, None]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_matches_jax_attention(dtype):
    """attention_plain on the JAX MultiHeadedAttention's own projections
    (captured) against its output, with an identity linear_out: prefix
    masks with a row of length 0 and one not a multiple of the key tile."""
    b, t = 3, 70
    rng = np.random.RandomState(1)
    x = rng.randn(b, t, D).astype(np.float32)
    lens = [t, 0, 37]
    valid = np.arange(t)[None, :] < np.array(lens)[:, None]
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    mod = jt.MultiHeadedAttention(n_heads=H, d_model=D, dtype=jdtype)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(valid))
    params["params"]["linear_out"]["kernel"] = jnp.eye(D, dtype=jnp.float32)
    params["params"]["linear_out"]["bias"] = jnp.zeros(D, jnp.float32)
    out, state = mod.apply(params, jnp.asarray(x), jnp.asarray(valid),
                           capture_intermediates=True)
    inter = state["intermediates"]
    q, k, v = (torch.from_numpy(np.array(inter[n]["__call__"][0].astype(jnp.float32))).to(dtype)
               for n in ("linear_q", "linear_k", "linear_v"))
    got = ta.attention_plain(q, k, v, torch.from_numpy(valid), H)
    want = torch.from_numpy(np.array(out.astype(jnp.float32)))
    assert got.dtype == dtype
    assert _rel(got, want) <= TOL[dtype]
    assert torch.equal(got[1].float(), torch.zeros(t, D)) and torch.equal(want[1], torch.zeros(t, D))


MASKS = {
    "prefix": ([150, 1, 0, 64, 65, 129], 150),  # a partial tile, a whole one, one key past it
    "short": ([5, 0, 16], 16),  # T below one tile
    "tile_multiple": ([128, 64, 3], 128),
}


def _masks():
    out = {name: _mask(lens, t) for name, (lens, t) in MASKS.items()}
    gen = torch.Generator().manual_seed(5)
    scattered = torch.rand(4, 200, generator=gen) < 0.2
    scattered[1] = False
    scattered[2, :] = False
    scattered[2, 130] = True  # one valid key, in the third tile
    scattered[3, 0] = True
    out["non_prefix"] = scattered
    return out


@pytest.mark.parametrize("exp2", [False, True], ids=["expf", "exp2"])
@pytest.mark.parametrize("name", sorted(_masks()))
def test_kernel_algorithm_matches_plain(name, exp2):
    """The kernel's tiled online softmax, emulated, against the plain
    version: the tiles it skips change nothing, and a row with no valid
    key is exactly 0."""
    mask = _masks()[name]
    q, k, v = _qkv(mask.shape[0], mask.shape[1], seed=2)
    got = _tiled(q, k, v, mask, H, exp2)
    want = ta.attention_plain(q, k, v, mask, H)
    assert _rel(got, want) <= TOL[torch.float32]
    for r in range(mask.shape[0]):
        if not mask[r].any():
            assert torch.equal(got[r], torch.zeros_like(got[r]))
            assert torch.equal(want[r], torch.zeros_like(want[r]))


@pytest.mark.parametrize("name", sorted(_masks()))
def test_plain_over_the_visited_keys_only(name):
    """attention_plain of each row cut to the keys of its visited tiles
    equals the whole row's: the skipped keys carry no weight."""
    mask = _masks()[name]
    q, k, v = _qkv(mask.shape[0], mask.shape[1], seed=3)
    want = ta.attention_plain(q, k, v, mask, H)
    for r, n in enumerate(key_tiles(mask).tolist()):
        keep = min(n * ta.KEY_TILE, mask.shape[1])
        kk, vv, mm = k[r:r + 1, :keep], v[r:r + 1, :keep], mask[r:r + 1, :keep]
        s = torch.einsum("qhd,khd->hqk", q[r].view(-1, H, ta.HEAD_DIM),
                         kk[0].view(-1, H, ta.HEAD_DIM)) / math.sqrt(ta.HEAD_DIM)
        p = torch.softmax(s.masked_fill(~mm[0][None, None], NEG_INF), dim=-1)
        p = p.masked_fill(~mm[0][None, None], 0.0)
        got = torch.einsum("hqk,khd->qhd", p, vv[0].view(-1, H, ta.HEAD_DIM)).reshape(-1, D)
        assert torch.allclose(got, want[r], rtol=0, atol=1e-6), (name, r)


def test_key_tiles_per_row():
    mask = _mask([150, 1, 0, 64, 65, 128, 129], 150)
    assert key_tiles(mask).tolist() == [3, 1, 0, 1, 2, 2, 3]
    gap = torch.zeros(2, 300, dtype=torch.bool)
    gap[0, [3, 200]] = True  # the last valid key sets the count, not the first
    gap[1, 63] = True
    assert key_tiles(gap).tolist() == [4, 1]


def test_cpu_takes_the_plain_version_without_counting():
    q, k, v = _qkv(2, 40)
    mask = _mask([40, 9], 40)
    before = ta.fused_attention.launches
    with torch.no_grad():
        got = ta.fused_attention(q, k, v, mask, H)
    assert torch.equal(got, ta.attention_plain(q, k, v, mask, H))
    assert ta.fused_attention.launches == before


def test_other_devices_raise():
    q, k, v = (x.to("meta") for x in _qkv(2, 8))
    with pytest.raises(ValueError, match="unsupported device"):
        ta.fused_attention(q, k, v, None, H)


def test_grad_is_refused():
    q, k, v = _qkv(1, 8)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ta.fused_attention(q, k, v, None, H)
    with torch.no_grad():
        ta.fused_attention(q, k, v, None, H)


def test_operand_checks():
    q, k, v = _qkv(2, 8)
    mask = _mask([8, 3], 8)
    ta.check_operands(q, k, v, mask, H)
    ta.check_operands(*(x.bfloat16() for x in (q, k, v)), None, H)
    ta.check_operands(*_qkv(2, 8, d=H * 8), mask, H)  # narrower heads: padded
    with pytest.raises(TypeError, match="dtype"):
        ta.check_operands(*(x.half() for x in (q, k, v)), mask, H)
    with pytest.raises(ValueError, match="d_k"):
        ta.check_operands(*_qkv(2, 8, d=H * 64), mask, H)
    with pytest.raises(ValueError, match="d_k"):
        ta.check_operands(q, k, v, mask, 5)  # 96 columns do not split into 5 heads
    with pytest.raises(ValueError, match="share"):
        ta.check_operands(q, k.bfloat16(), v, mask, H)
    with pytest.raises(ValueError, match="share"):
        ta.check_operands(q, k[:, :5], v, mask, H)
    with pytest.raises(ValueError, match="contiguous"):
        ta.check_operands(q, k, v.transpose(0, 1).contiguous().transpose(0, 1), mask, H)
    with pytest.raises(ValueError, match="valid_mask"):
        ta.check_operands(q, k, v, mask.int(), H)
    with pytest.raises(ValueError, match="valid_mask"):
        ta.check_operands(q, k, v, mask[:, :5], H)


def test_attend_keeps_the_plain_path_for_training():
    """Training (dropout in train mode, whatever p) takes the plain path,
    where gradients flow and dropout drops; CPU tensors take it too. Every
    other call goes to the kernel's wrapper, which raises where the kernel
    cannot serve (here: an operand that requires grad, a device other than
    a card) instead of running the plain version."""
    q, k, v = _qkv(2, 16)
    mask = _mask([16, 7], 16)
    off, on = nn.Dropout(0.5).eval(), nn.Dropout(0.5).train()
    qg = q.clone().requires_grad_(True)
    out = tt.attend(qg, k, v, mask, H, nn.Dropout(0.0).train())
    out.sum().backward()
    assert qg.grad is not None and torch.isfinite(qg.grad).all() and qg.grad.abs().sum() > 0
    torch.manual_seed(0)
    dropped = tt.attend(q, k, v, mask, H, on)
    assert not torch.allclose(dropped, tt.attend(q, k, v, mask, H, off))
    assert torch.equal(tt.attend(q, k, v, mask, H, off), ta.attention_plain(q, k, v, mask, H))
    meta = [x.to("meta") for x in (q, k, v)]
    with pytest.raises(ValueError, match="unsupported device"):
        tt.attend(*meta, mask.to("meta"), H, off)
    with pytest.raises(RuntimeError, match="no backward"):
        tt.attend(meta[0].requires_grad_(True), *meta[1:], mask.to("meta"), H, off)
    assert tt.attend(*meta, mask.to("meta"), H, on).shape == q.shape  # training: plain


@pytest.mark.parametrize("d_k", [8, 32])
def test_narrow_heads_padded_to_the_kernels_d_k(d_k):
    """Heads narrower than HEAD_DIM reach the kernel zero-padded
    (`pad_heads`) with the scale of their own d_k: the kernel's algorithm
    on the padded operands, cut back to d_k, equals the plain version."""
    mask = _masks()["prefix"]
    q, k, v = _qkv(mask.shape[0], mask.shape[1], seed=4, d=H * d_k)
    padded = [ta.pad_heads(x, H) for x in (q, k, v)]
    assert padded[0].shape[-1] == H * ta.HEAD_DIM
    assert torch.equal(padded[0].view(*q.shape[:2], H, -1)[..., :d_k],
                       q.view(*q.shape[:2], H, d_k))
    assert not padded[0].view(*q.shape[:2], H, -1)[..., d_k:].any()
    got = _tiled(*padded, mask, H, d_k=d_k).view(*q.shape[:2], H, -1)[..., :d_k]
    want = ta.attention_plain(q, k, v, mask, H)
    assert _rel(got.reshape(q.shape), want) <= TOL[torch.float32]


def test_tile_constants_match_the_cuda_header():
    """The wrapper's HEAD_DIM and KEY_TILE mirror csrc/attention.cu, whose
    entry points build.py declares."""
    with open(os.path.join(build.CSRC_DIR, "attention.cu")) as f:
        src = f.read()
    consts = {name: int(val) for name, val in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kHeadDim"] == ta.HEAD_DIM and consts["kKeyTile"] == ta.KEY_TILE
    assert ta.HEAD_DIM % 16 == 0  # whole bf16 k16 steps
    for entry in ("evt_attention_bf16", "evt_attention_f32"):
        assert f'extern "C" int {entry}(' in src
        with open(os.path.join(os.path.dirname(build.__file__), "build.py")) as f:
            assert f"lib.{entry}.argtypes" in f.read()
