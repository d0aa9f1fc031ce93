"""The port's block-diagonal attention (K5a) against the JAX package's, on
the CPU in fp32: the same numpy inputs through ``vtm``'s
``tome_blockdiag_attention`` (its Pallas kernel in interpret mode) and its
plain ``_blockdiag_reference`` on one side, the port's wrapper (which on a
CPU tensor runs its plain version) on the other; and the port's
``attention_core`` with the CLS-excluded bias on the ``(b t)`` fold against
its own ``tome_blockdiag_attention`` on the ``[B, t*s]`` fold.

Tolerance: 1e-5 of the output's largest entry (fp32 sums in another
order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vtm.models.common import attention_core as j_attention_core
from vtm.ops.flash_attention import _blockdiag_reference as j_reference
from vtm.ops.flash_attention import tome_blockdiag_attention as j_blockdiag

from vtm_torch.models.common import attention_core
from vtm_torch.ops import flash_attention as fa
from vtm_torch.ops.flash_attention import (
    _blockdiag_reference,
    check_blockdiag_kernel_args,
    tome_blockdiag_attention,
)

torch.set_num_threads(2)

TOL = 1e-5

# (frames, s, heads, with_bias, exclude_first_row): tests/test_flash_attention.py's cases
CASES = [
    (8, 197, 4, True, True),    # TimeSformer's shape: CLS-excluded bias
    (8, 197, 4, False, False),  # unbiased
    (4, 50, 3, True, True),     # odd heads
    (5, 8, 4, True, False),     # odd frames; the bias on every row
    (8, 193, 2, True, True),    # ragged s
    (8, 40, 4, False, True),    # the row mask without a bias changes nothing
]


def _inputs(f, s, h, with_bias, seed=0, b=2, d=16):
    n = f * s
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3))
    bias = np.log(rng.uniform(1, 4, (b, n))).astype(np.float32) if with_bias else None
    return q, k, v, bias


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("f,s,h,with_bias,excl", CASES)
def test_matches_vtm_kernel_and_reference(f, s, h, with_bias, excl):
    arrays = _inputs(f, s, h, with_bias)
    want_kernel = np.asarray(j_blockdiag(*_jax(*arrays), 0.25, f, excl))
    want_plain = np.asarray(j_reference(*_jax(*arrays), 0.25, f, excl))
    got = tome_blockdiag_attention(*_torch(*arrays), 0.25, f, excl)
    assert tuple(got.shape) == (2, f * s, h * 16) and got.is_contiguous()
    _close(got.numpy(), want_kernel)
    _close(got.numpy(), want_plain)


def test_odd_heads_wide_head_dim_match_vtm():
    """h = 3 with d = 64: every head's columns are written."""
    q, k, v, _ = _inputs(2, 33, 3, False, seed=7, b=1, d=64)
    want = np.asarray(j_blockdiag(*_jax(q, k, v), None, 0.125, 2))
    got = tome_blockdiag_attention(*_torch(q, k, v), None, 0.125, 2)
    _close(got.numpy(), want)


def test_strided_views_of_a_fused_projection_match_contiguous():
    """q, k, v as the model hands them over: views of the (b t) batch's
    fused qkv output."""
    b, f, s, h, d = 2, 4, 9, 3, 16
    rng = np.random.default_rng(3)
    fused = torch.from_numpy(rng.standard_normal((b * f, s, 3 * h * d)).astype(np.float32))
    q, k, v = (t.transpose(1, 2) for t in fused.view(b, f * s, 3, h, d).unbind(dim=2))
    assert not q.is_contiguous()
    bias = torch.from_numpy(np.log(rng.uniform(1, 4, (b, f * s))).astype(np.float32))
    got = tome_blockdiag_attention(q, k, v, bias, 0.25, f, True)
    want = tome_blockdiag_attention(q.contiguous(), k.contiguous(), v.contiguous(), bias, 0.25, f, True)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)  # another summation order


@pytest.mark.parametrize("excl", [True, False], ids=["cls_excluded", "every_row"])
def test_equals_own_attention_core_on_the_folded_batch(excl):
    """The two formulations the TimeSformer block dispatches between, in
    the port and against the JAX package's ``attention_core``."""
    b, f, h, s, d = 2, 4, 3, 33, 16
    n = f * s
    q, k, v, _ = _inputs(f, s, h, False, seed=4, d=d)
    sizes = np.random.default_rng(5).uniform(1, 4, (b, f, s))
    sizes[:, :, 0] = 1.0  # CLS
    kb = np.log(sizes).astype(np.float32).reshape(b, n)
    got = tome_blockdiag_attention(*_torch(q, k, v, kb), 0.25, f, excl).reshape(b, f, s, h * d)

    def fold(z):
        return z.reshape(b, h, f, s, d).transpose(0, 2, 1, 3, 4).reshape(b * f, h, s, d)

    if excl:
        sb = np.log(sizes[:, :, 1:]).astype(np.float32).reshape(b * f, 1, 1, s - 1)
    else:
        sb = kb.reshape(b * f, 1, 1, s)
    tq, tk, tv, tsb = _torch(fold(q), fold(k), fold(v), sb)
    own = attention_core(tq, tk, tv, 0.25, tsb, bias_excludes_first=excl)
    own = own.transpose(1, 2).reshape(b, f, s, h * d)
    _close(got.numpy(), own.numpy())
    want = j_attention_core(*_jax(fold(q), fold(k), fold(v)), 0.25, jnp.asarray(sb), bias_excludes_first=excl)
    want = np.asarray(jnp.transpose(want, (0, 2, 1, 3)).reshape(b, f, s, h * d))
    _close(got.numpy(), want)


@pytest.mark.parametrize("n", [40, 300], ids=["short", "kernel_length"])
def test_attention_core_cls_excluded_bias_matches_vtm(n):
    """``bias_excludes_first`` alone, at a length below and one inside the
    dense kernel's range (this form is plain products at every length)."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, 3, n, 16)).astype(np.float32) for _ in range(3))
    sb = np.log(rng.uniform(1, 4, (2, 1, 1, n - 1))).astype(np.float32)
    got = attention_core(*_torch(q, k, v), 0.25, torch.from_numpy(sb), bias_excludes_first=True)
    want = np.asarray(j_attention_core(*_jax(q, k, v), 0.25, jnp.asarray(sb), bias_excludes_first=True))
    _close(got.numpy(), want)
    unbiased = attention_core(*_torch(q, k, v), 0.25, None, bias_excludes_first=True)
    _close(unbiased.numpy(), np.asarray(j_attention_core(*_jax(q, k, v), 0.25)))


def test_bf16_follows_the_plain_rounding_points():
    """bf16: q*scale rounded to bf16, fp32 softmax, probabilities rounded
    to bf16 before the product with v; within 2e-2 of the fp32 result."""
    q, k, v, bias = _inputs(4, 21, 2, True, seed=8)
    tq, tk, tv, tb = _torch(q, k, v, bias)
    got = tome_blockdiag_attention(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(), tb, 0.25, 4, True)
    assert got.dtype == torch.bfloat16
    want = _blockdiag_reference(tq, tk, tv, tb, 0.25, 4, True)
    assert (got.float() - want).abs().max().item() <= 2e-2 * want.abs().max().item()


def test_cpu_call_launches_nothing():
    before = fa.BLOCKDIAG_LAUNCHES, fa.BLOCKDIAG_BWD_LAUNCHES
    tome_blockdiag_attention(*_torch(*_inputs(2, 5, 2, True)), 0.25, 2, True)
    assert (fa.BLOCKDIAG_LAUNCHES, fa.BLOCKDIAG_BWD_LAUNCHES) == before


@pytest.mark.parametrize(
    "change,match",
    [
        (dict(frames=3), "does not divide"),
        (dict(frames=0), "does not divide"),
        (dict(dtype=torch.float16), "bfloat16 or float32"),
        (dict(d=24), "head dim"),
        (dict(bias_shape=(2, 7)), "key_bias"),
        (dict(), "CUDA"),
    ],
    ids=["frames", "no_frames", "dtype", "head_dim", "bias_shape", "device"],
)
def test_kernel_argument_check_raises(change, match):
    """What the kernels do not take raises; a CPU tensor that reaches the
    check raises for its device after everything else passed."""
    d = change.get("d", 16)
    q, k, v = (torch.zeros((2, 2, 8, d), dtype=change.get("dtype", torch.float32)) for _ in range(3))
    bias = torch.zeros(change.get("bias_shape", (2, 8)))
    with pytest.raises(ValueError, match=match):
        check_blockdiag_kernel_args(q, k, v, bias, change.get("frames", 4))


# ---- K5a's launch plan (ops/flash_attention.py::blockdiag_plan) ------------

# TimeSformer's frame lengths at r=18 (patches + the broadcast CLS), and the
# edges of the packed form
TS_FRAME_LENS = (197, 179, 161, 143, 125, 107, 89, 71, 53, 35, 18, 10)
PLAN_LENS = TS_FRAME_LENS + (33, 64, 32, 1)


def _plan_blocks(frames, s, hopper):
    """Each block of the plan as (first row, rows, first key, keys) within
    one clip's [F*s] tokens, and the frames it packs (g)."""
    g, tiles, blocks = fa.blockdiag_plan(frames, s, hopper)
    out = []
    for x in range(blocks):
        if g > 1:
            f0 = x * g
            rows = min(g, frames - f0) * s
            out.append((f0 * s, rows, f0 * s, rows))
        else:
            f, t = divmod(x, tiles)
            r0 = f * s + t * 64
            out.append((r0, min(64, (f + 1) * s - r0), f * s, s))
    return g, out


@pytest.mark.parametrize("hopper", [True, False], ids=["hopper_body", "first_body"])
@pytest.mark.parametrize("frames", [8, 7, 1])
@pytest.mark.parametrize("s", PLAN_LENS)
def test_plan_covers_every_row_once_with_whole_frames(s, frames, hopper):
    g, blocks = _plan_blocks(frames, s, hopper)
    assert g == (64 // s if hopper and s <= 32 else 1)
    seen = np.zeros(frames * s, dtype=int)
    for r0, rows, k0, keys in blocks:
        assert 1 <= rows <= 64
        seen[r0:r0 + rows] += 1
        if g > 1:  # whole frames, keys of the same frames, one key tile
            assert r0 % s == 0 and rows % s == 0 and (r0, rows) == (k0, keys) and keys <= 64
        else:  # a tile of one frame's rows walks that frame's keys
            assert k0 == (r0 // s) * s and r0 + rows <= k0 + s and keys == s
    np.testing.assert_array_equal(seen, 1)


@pytest.mark.parametrize("s,frames", [(10, 8), (10, 7), (18, 7), (197, 8), (1, 1)])
def test_plan_grid_is_the_grid_the_argument_check_holds(s, frames, monkeypatch):
    """check_blockdiag_kernel_args bounds the larger of K5a's planned grid
    and K5b's (one block a frame's 64-row tile): exactly at that size the
    check passes the grid and goes on to the device check; one block less
    of room raises."""
    q = torch.zeros((1, 1, frames * s, 64), dtype=torch.bfloat16)
    need = max(fa.blockdiag_plan(frames, s, True)[2], frames * -(-s // 64))
    assert fa.blockdiag_plan(frames, s, True)[2] <= need
    monkeypatch.setattr(fa, "_MAX_GRID_X", need)
    with pytest.raises(ValueError, match="CUDA"):
        check_blockdiag_kernel_args(q, q, q, None, frames)
    monkeypatch.setattr(fa, "_MAX_GRID_X", need - 1)
    with pytest.raises(ValueError, match="grid"):
        check_blockdiag_kernel_args(q, q, q, None, frames)


def test_hopper_body_is_bf16_at_head_dim_64():
    assert fa.hopper_body(torch.zeros((1, 1, 4, 64), dtype=torch.bfloat16))
    assert not fa.hopper_body(torch.zeros((1, 1, 4, 64)))
    assert not fa.hopper_body(torch.zeros((1, 1, 4, 32), dtype=torch.bfloat16))


def _packed_window_emulation(q, k, v, bias, scale, frames, excl):
    """The Hopper body's arithmetic block by block of the plan, in fp32:
    one masked dense attention per block over its rows and keys, the pair
    mask frame(row) == frame(key) and the bias off row 0 of every packed
    frame under ``excl``. Returns token-major [B, N, H*d]."""
    b, h, n, d = q.shape
    s = n // frames
    out = torch.full_like(q, float("nan"))
    for r0, rows, k0, keys in _plan_blocks(frames, s, True)[1]:
        r = torch.arange(r0, r0 + rows)
        j = torch.arange(k0, k0 + keys)
        logits = (q[:, :, r] * scale) @ k[:, :, j].transpose(-2, -1)
        if bias is not None:
            row_gets_bias = ~(excl & (r % s == 0))
            logits = logits + row_gets_bias[:, None].float() * bias[:, None, None, j]
        logits = logits.masked_fill((r[:, None] // s) != (j[None, :] // s), float("-inf"))
        out[:, :, r] = torch.softmax(logits, dim=-1) @ v[:, :, j]
    return out.permute(0, 2, 1, 3).reshape(b, n, h * d)


@pytest.mark.parametrize("mode", [(False, False), (True, False), (True, True)],
                         ids=["unbiased", "biased", "biased_row_mask"])
@pytest.mark.parametrize("frames", [8, 7])
@pytest.mark.parametrize("s", [10, 18, 35])
def test_packed_window_emulation_matches_vtm(s, frames, mode):
    """The packed plan computes vtm's block-diagonal attention: its
    emulation against ``vtm``'s kernel in interpret mode, fp32."""
    with_bias, excl = mode
    q, k, v, bias = _inputs(frames, s, 2, with_bias, seed=9, b=2, d=16)
    if bias is not None:
        bias.reshape(2, frames, s)[:, :, 0] = 0.0  # the CLS token's size is 1
    want = np.asarray(j_blockdiag(*_jax(q, k, v, bias), 0.25, frames, excl))
    got = _packed_window_emulation(*_torch(q, k, v, bias), 0.25, frames, excl)
    assert not torch.isnan(got).any()
    _close(got.numpy(), want)


@pytest.mark.parametrize("mode", [(False, False), (True, False), (True, True)],
                         ids=["unbiased", "biased", "biased_row_mask"])
@pytest.mark.parametrize("frames,s", [(4, 21), (7, 10)])
def test_reference_lse_is_each_rows_logsumexp(frames, s, mode):
    """``_blockdiag_reference(..., want_lse=True)``: the same output, and lse
    fp32 [B, H, N], one a row, equal to torch.logsumexp over its frame's
    keys of the logits, the bias (kept off row 0 of each frame under the
    row mask) included; computed here in float64, within 1e-5. A failure
    names the CPU code path and whether a second evaluation in the same
    process gave the same bits, which tells a transient deviation from one
    of the host's arithmetic, and how far the fp32 q k^T lies from the
    float64 one, which tells the product's error from the logsumexp's."""
    with_bias, excl = mode
    q, k, v, bias = _torch(*_inputs(frames, s, 2, with_bias, seed=10))
    out, lse = _blockdiag_reference(q, k, v, bias, 0.25, frames, excl, want_lse=True)
    assert torch.equal(out, tome_blockdiag_attention(q, k, v, bias, 0.25, frames, excl))
    b, h, n, d = q.shape
    assert lse.shape == (b, h, n) and lse.dtype == torch.float32
    qf, kf = (t.double().reshape(b, h, frames, s, d) for t in (q, k))
    qk = (qf * 0.25) @ kf.transpose(-2, -1)
    logits = qk
    if bias is not None:
        rows = torch.ones(s, dtype=torch.float64)
        if excl:
            rows[0] = 0.0
        logits = logits + rows[:, None] * bias.double().reshape(b, 1, frames, 1, s)
    want = torch.logsumexp(logits, dim=-1).reshape(b, h, n)
    _, again = fa._blockdiag_forward(q, k, v, bias, 0.25, frames, excl, want_lse=True)
    qk32 = torch.matmul((q * 0.25).reshape(b, h, frames, s, d), k.reshape(b, h, frames, s, d).transpose(-2, -1))
    where = (f"CPU capability {torch.backends.cpu.get_cpu_capability()}, {torch.get_num_threads()} threads, "
             f"fp32 matmul precision {torch.get_float32_matmul_precision()}; "
             f"a second evaluation {'gave the same bits' if torch.equal(again, lse) else 'differed'}, "
             f"{(again.double() - want).abs().max().item():.3g} from float64; "
             f"the fp32 q k^T {(qk32.double() - qk).abs().max().item():.3g} from float64")
    np.testing.assert_allclose(lse.double().numpy(), want.numpy(), rtol=0, atol=1e-5, err_msg=where)
    assert torch.equal(again, lse)
