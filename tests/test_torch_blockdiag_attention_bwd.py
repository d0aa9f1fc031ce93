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


def _inputs(f, s, h, with_bias, seed=3, b=2, d=16):
    n = f * s
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3))
    bias = np.log(rng.uniform(1, 5, (b, n))).astype(np.float32) if with_bias else None
    cot = rng.standard_normal((b, n, h * d)).astype(np.float32)
    return q, k, v, bias, cot


def _jax_grads(fn, q, k, v, bias, cot, f, excl):
    argnums = (0, 1, 2) + ((3,) if bias is not None else ())

    def loss(q_, k_, v_, b_):
        return (fn(q_, k_, v_, b_, 0.25, f, excl) * jnp.asarray(cot)).sum()

    args = [jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None if bias is None else jnp.asarray(bias)]
    return [np.asarray(g) for g in jax.grad(loss, argnums=argnums)(*args)]


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
