"""The port's block-diagonal attention backward (K5b) against the JAX
package's, on the CPU in fp32: ``jax.grad`` through ``vtm``'s
``tome_blockdiag_attention`` (its Pallas backward in interpret mode) and
through its plain ``_blockdiag_reference`` on one side; on the other the
port's plain backward, called directly and through the
``torch.autograd.Function``, and autograd through the port's plain forward.

Tolerance: 1e-5 of each gradient's largest entry."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vtm.ops.flash_attention import _blockdiag_reference as j_reference
from vtm.ops.flash_attention import tome_blockdiag_attention as j_blockdiag

from vtm_torch.ops import flash_attention as fa
from vtm_torch.ops.flash_attention import (
    _blockdiag_backward_reference,
    _blockdiag_reference,
    tome_blockdiag_attention,
    tome_blockdiag_attention_backward,
)

torch.set_num_threads(2)

TOL = 1e-5
NAMES = ("dq", "dk", "dv", "dbias")
# (frames, s, heads, with_bias, exclude_first_row): tests/test_flash_attention.py's cases
CASES = [
    (8, 40, 4, True, True),
    (4, 50, 3, True, False),  # odd heads
    (8, 40, 4, False, False),
    (5, 8, 4, True, True),    # odd frames
    (2, 67, 2, True, True),   # ragged s over one 64-row tile
]
# the residual form against the Pallas kernel in fp32: both sum in fp32 in
# another order, so each gradient within 1e-5 of its largest entry (K2's
# residual tests' tolerance); bf16: within 5e-2, a few bf16 roundings of
# values of order 1 (K2's bf16 tolerance)
RESIDUAL_FP32_TOL = 1e-5
BF16_TOL = 5e-2
# the residual cases: the CASES above, and frames of at most 32 tokens that
# the Hopper body packs 64 // s to a tile, at a frame count the packing
# does not divide (F 7 at s 10 and 18: 6 and 3 frames a tile)
RESIDUAL_CASES = CASES + [
    (7, 10, 2, True, True),
    (7, 18, 3, True, True),
    (7, 10, 2, False, False),
    (7, 18, 2, True, False),
]


def _inputs(f, s, h, with_bias, seed=3, b=2, d=16):
    n = f * s
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3))
    bias = np.log(rng.uniform(1, 5, (b, n))).astype(np.float32) if with_bias else None
    cot = rng.standard_normal((b, n, h * d)).astype(np.float32)
    return q, k, v, bias, cot


def _jax_grads(fn, q, k, v, bias, cot, f, excl, dtype=jnp.float32):
    argnums = (0, 1, 2) + ((3,) if bias is not None else ())

    def loss(q_, k_, v_, b_):
        return (fn(q_, k_, v_, b_, 0.25, f, excl).astype(jnp.float32) * jnp.asarray(cot)).sum()

    args = [jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
            None if bias is None else jnp.asarray(bias)]
    return [np.asarray(g.astype(jnp.float32)) for g in jax.grad(loss, argnums=argnums)(*args)]


def _close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("f,s,h,with_bias,excl", CASES)
def test_gradients_match_vtm_kernel_and_reference(f, s, h, with_bias, excl):
    q, k, v, bias, cot = _inputs(f, s, h, with_bias)
    want_kernel = _jax_grads(j_blockdiag, q, k, v, bias, cot, f, excl)
    want_plain = _jax_grads(j_reference, q, k, v, bias, cot, f, excl)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias)
    got = tome_blockdiag_attention_backward(tq, tk, tv, tb, torch.from_numpy(cot), 0.25, f, excl)
    assert (got[3] is None) == (bias is None)
    for name, g, wk, wp in zip(NAMES, got, want_kernel, want_plain):
        assert tuple(g.shape) == wk.shape, name
        _close(g.numpy(), wk, name)
        _close(g.numpy(), wp, name)


@pytest.mark.parametrize("f,s,h,with_bias,excl", CASES)
def test_autograd_function_matches_autograd_of_the_plain_forward(f, s, h, with_bias, excl):
    q, k, v, bias, cot = _inputs(f, s, h, with_bias, seed=4)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    if with_bias:
        leaves.append(torch.from_numpy(bias).requires_grad_())
    tb = leaves[3] if with_bias else None
    do = torch.from_numpy(cot)
    got = torch.autograd.grad(tome_blockdiag_attention(*leaves[:3], tb, 0.25, f, excl), leaves, do)
    want = torch.autograd.grad(_blockdiag_reference(*leaves[:3], tb, 0.25, f, excl), leaves, do)
    for name, g, w in zip(NAMES, got, want):
        _close(g.numpy(), w.numpy(), name)


def test_masked_dbias_leaves_out_row_zero():
    """With the row mask the bias never reaches row 0 of a frame: dbias is
    the sum of ds over rows > 0, and differs from the unmasked one."""
    q, k, v, bias, cot = (torch.from_numpy(a) for a in _inputs(3, 6, 2, True, seed=5))
    masked = tome_blockdiag_attention_backward(q, k, v, bias, cot, 0.25, 3, True)[3]
    every = tome_blockdiag_attention_backward(q, k, v, bias, cot, 0.25, 3, False)[3]
    assert not torch.allclose(masked, every, atol=1e-4)
    leaf = bias.clone().requires_grad_()
    (_blockdiag_reference(q, k, v, leaf, 0.25, 3, True) * cot).sum().backward()
    _close(masked.numpy(), leaf.grad.numpy(), "dbias")


def test_strided_cotangent_and_views():
    """do read through its strides; dq, dk, dv are views of one token-major
    buffer, the gradient of the fused projection's split."""
    b, f, s, h, d = 2, 3, 7, 2, 16
    q, k, v, bias, cot = (torch.from_numpy(a) for a in _inputs(f, s, h, True, seed=6))
    do = cot.transpose(0, 1).contiguous().transpose(0, 1)
    assert not do.is_contiguous()
    a = tome_blockdiag_attention_backward(q, k, v, bias, do, 0.25, f, True)
    c = tome_blockdiag_attention_backward(q, k, v, bias, cot, 0.25, f, True)
    for x, y in zip(a, c):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-5)  # another summation order
    assert tuple(a[0].shape) == (b, h, f * s, d)


def test_dbias_only_when_asked_and_when_there_is_a_bias():
    q, k, v, bias, cot = (torch.from_numpy(a) for a in _inputs(2, 5, 2, True, seed=7))
    assert tome_blockdiag_attention_backward(q, k, v, bias, cot, 0.25, 2, True, need_dbias=False)[3] is None
    assert tome_blockdiag_attention_backward(q, k, v, None, cot, 0.25, 2, True)[3] is None
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tome_blockdiag_attention(*leaves, bias, 0.25, 2, True)  # bias needs no gradient
    out.backward(cot)
    assert bias.grad is None and all(t.grad is not None for t in leaves)


def test_bf16_rounding_points():
    """bf16 gradients stay within 3e-2 of the fp32 ones, each relative to
    its largest entry; dbias comes in the bias's fp32."""
    q, k, v, bias, cot = (torch.from_numpy(a) for a in _inputs(4, 21, 2, True, seed=8))
    got = _blockdiag_backward_reference(q.bfloat16(), k.bfloat16(), v.bfloat16(), bias, cot.bfloat16(), 0.25, 4, True)
    want = _blockdiag_backward_reference(q, k, v, bias, cot, 0.25, 4, True)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32]
    for name, g, w in zip(NAMES, got, want):
        assert (g.float() - w).abs().max().item() <= 3e-2 * w.abs().max().item(), name


def test_cpu_backward_launches_nothing():
    before = fa.BLOCKDIAG_BWD_LAUNCHES
    q, k, v, bias, cot = (torch.from_numpy(a) for a in _inputs(2, 5, 2, True))
    tome_blockdiag_attention_backward(q, k, v, bias, cot, 0.25, 2, True)
    assert fa.BLOCKDIAG_BWD_LAUNCHES == before


def _residuals(q, k, v, bias, f, excl):
    return fa._blockdiag_forward(q, k, v, bias, 0.25, f, excl, want_lse=True)


@pytest.mark.parametrize("f,s,h,with_bias,excl", RESIDUAL_CASES)
def test_residual_reference_matches_vtm_kernel(f, s, h, with_bias, excl):
    """The kernel's arithmetic (p = exp(s - lse), delta = rowsum(do * out)
    from K5a's plain residuals) against jax.grad through vtm's K5b, fp32:
    within RESIDUAL_FP32_TOL (1e-5) of each gradient's largest entry."""
    q, k, v, bias, cot = _inputs(f, s, h, with_bias, seed=11)
    if bias is not None:
        bias.reshape(2, f, s)[:, :, 0] = 0.0  # the CLS token's size is 1
    want = _jax_grads(j_blockdiag, q, k, v, bias, cot, f, excl)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias)
    out, lse = _residuals(tq, tk, tv, tb, f, excl)
    assert lse.shape == (2, h, f * s) and lse.dtype == torch.float32
    got = _blockdiag_backward_reference(tq, tk, tv, tb, torch.from_numpy(cot), 0.25, f, excl, out=out, lse=lse)
    assert (got[3] is None) == (bias is None)
    for name, g, w in zip(NAMES, got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=RESIDUAL_FP32_TOL * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("f,s,h,with_bias,excl", [(4, 50, 2, True, True), (7, 10, 2, True, True),
                                                  (7, 18, 2, False, False)])
def test_residual_reference_matches_vtm_kernel_bf16(f, s, h, with_bias, excl):
    """The same in bf16 at d = 64: out is K5a's bf16 output, so delta
    carries its rounding; the gradients stay within BF16_TOL (5e-2) of
    vtm's K5b in bf16."""
    q, k, v, bias, cot = _inputs(f, s, h, with_bias, seed=12, b=1, d=64)
    want = _jax_grads(j_blockdiag, q, k, v, bias, cot, f, excl, jnp.bfloat16)
    tq, tk, tv, tcot = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, cot))
    tb = None if bias is None else torch.from_numpy(bias)
    out, lse = _residuals(tq, tk, tv, tb, f, excl)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    got = _blockdiag_backward_reference(tq, tk, tv, tb, tcot, 0.25, f, excl, out=out, lse=lse)
    for name, g, w in zip(NAMES[:3], got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w, rtol=BF16_TOL, atol=BF16_TOL, err_msg=name)
    if with_bias:
        np.testing.assert_allclose(got[3].numpy(), want[3], atol=BF16_TOL * np.abs(want[3]).max(), err_msg="dbias")


def test_function_saves_the_residuals_and_backward_uses_them(monkeypatch):
    """_BlockdiagAttention keeps (q, k, v, key_bias, out, lse) when a
    gradient is wanted and hands out and lse to the backward: no K5a rerun,
    the residual arithmetic. Without a gradient K5a writes no lse."""
    f, s, h = 3, 10, 2
    q, k, v, bias, cot = (torch.from_numpy(a) for a in _inputs(f, s, h, True, seed=13))
    q.requires_grad_()
    forward_calls = []
    real_forward = fa._blockdiag_forward
    monkeypatch.setattr(fa, "_blockdiag_forward",
                        lambda *a, **kw: forward_calls.append(kw) or real_forward(*a, **kw))
    with torch.no_grad():
        assert tome_blockdiag_attention(q, k, v, bias, 0.25, f, True).grad_fn is None
    assert tome_blockdiag_attention(q.detach(), k, v, bias, 0.25, f, True).grad_fn is None
    out = tome_blockdiag_attention(q, k, v, bias, 0.25, f, True)
    assert forward_calls == [{}, {}, {"want_lse": True}]
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 6 and torch.equal(saved[4], out)
    assert saved[5].shape == (2, h, f * s) and saved[5].dtype == torch.float32
    calls = []
    real = fa._blockdiag_backward_reference
    monkeypatch.setattr(fa, "_blockdiag_backward_reference", lambda *a, **kw: calls.append(a) or real(*a, **kw))
    monkeypatch.setattr(fa, "_blockdiag_forward", lambda *a, **kw: pytest.fail("K5a ran again in the backward"))
    (out * cot).sum().backward()
    assert len(calls) == 1 and calls[0][8] is not None and calls[0][9] is not None


def test_backward_without_residuals_makes_them():
    """tome_blockdiag_attention_backward called alone runs K5a (its plain
    version here) for out and lse: the same gradients as with them, and no
    kernel launched on the CPU."""
    f, s, h = 7, 10, 2
    q, k, v, bias, cot = (torch.from_numpy(a) for a in _inputs(f, s, h, True, seed=14))
    before = fa.BLOCKDIAG_LAUNCHES, fa.BLOCKDIAG_BWD_LAUNCHES
    out, lse = _residuals(q, k, v, bias, f, True)
    alone = tome_blockdiag_attention_backward(q, k, v, bias, cot, 0.25, f, True)
    given = tome_blockdiag_attention_backward(q, k, v, bias, cot, 0.25, f, True, out=out, lse=lse)
    for a, w in zip(alone, given):
        assert torch.equal(a, w)
    assert (fa.BLOCKDIAG_LAUNCHES, fa.BLOCKDIAG_BWD_LAUNCHES) == before
