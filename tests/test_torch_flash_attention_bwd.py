"""The plain version of the attention backward (K2) against the JAX
package's fused backward, and the autograd.Function around K1/K2 on the
CPU.

``jax.grad`` through ``vtm.ops.flash_attention.tome_flash_attention``
runs the Pallas backward kernel in interpret mode, as the JAX package's
own gradient test does. Inputs are made with numpy from a seed and fed
to both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vtm.ops.flash_attention import tome_flash_attention as jax_flash_attention
from vtm_torch.models.common import split_heads
from vtm_torch.ops import flash_attention as fa
from vtm_torch.ops.flash_attention import (
    _backward_reference,
    _reference,
    tome_flash_attention,
    tome_flash_attention_backward,
)

torch.set_num_threads(2)

# the tolerance of the JAX package's own gradient test
GRAD_TOL = 2e-4
# the residual form against the Pallas kernel in fp32: both sum in fp32 in
# another order, so each gradient within 1e-5 of its largest entry
RESIDUAL_FP32_TOL = 1e-5
# bf16: the plain version may be off an fp32 computation by a few bf16
# roundings of values of order 1 (the forward test's tolerance)
BF16_TOL = 5e-2


def _inputs(b, h, n, d, with_bias, seed):
    rng = np.random.default_rng(seed)
    q, k, v, cot = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(4))
    bias = np.log(rng.uniform(1, 5, (b, n))).astype(np.float32) if with_bias else None
    return q, k, v, bias, cot


def _jax_grads(q, k, v, bias, cot, scale, dtype=jnp.float32):
    argnums = (0, 1, 2) + ((3,) if bias is not None else ())

    def loss(q_, k_, v_, b_):
        out = jax_flash_attention(q_, k_, v_, b_, scale)
        return (out.astype(jnp.float32) * jnp.asarray(cot)).sum()

    grads = jax.grad(loss, argnums=argnums)(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        None if bias is None else jnp.asarray(bias),
    )
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


@pytest.mark.parametrize("n", [64, 200, 300])
@pytest.mark.parametrize("with_bias", [False, True])
def test_backward_reference_matches_vtm_kernel(n, with_bias):
    b, h, d = 1, 2, 64
    q, k, v, bias, cot = _inputs(b, h, n, d, with_bias, seed=1)
    want = _jax_grads(q, k, v, bias, cot, 0.125)
    got = _backward_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias), torch.from_numpy(cot), 0.125,
    )
    assert (got[3] is None) == (bias is None)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), w, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)


def test_backward_reference_matches_vtm_kernel_bf16():
    b, h, n, d = 1, 2, 200, 64
    q, k, v, bias, cot = _inputs(b, h, n, d, True, seed=2)
    want = _jax_grads(q, k, v, bias, cot, 0.125, jnp.bfloat16)
    tq, tk, tv, tcot = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, cot))
    # the JAX cotangent reaches the kernel in bf16 as well
    got = _backward_reference(tq, tk, tv, torch.from_numpy(bias), tcot, 0.125)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), w, rtol=BF16_TOL, atol=BF16_TOL, err_msg=name)
    assert got[3].dtype == torch.float32
    scale = np.abs(want[3]).max()
    np.testing.assert_allclose(got[3].numpy(), want[3], atol=BF16_TOL * scale, err_msg="dbias")


def _residuals(q, k, v, bias, scale):
    return fa._forward(q, k, v, bias, scale, want_lse=True)


@pytest.mark.parametrize("n", [64, 200, 300])
@pytest.mark.parametrize("with_bias", [False, True])
def test_residual_reference_matches_vtm_kernel(n, with_bias):
    """The kernel's arithmetic (p = exp(s - lse), delta = rowsum(do * out)
    from K1's plain residuals) against jax.grad through the Pallas
    backward, fp32: within RESIDUAL_FP32_TOL of each gradient's largest
    entry."""
    b, h, d = 1, 2, 64
    q, k, v, bias, cot = _inputs(b, h, n, d, with_bias, seed=6)
    want = _jax_grads(q, k, v, bias, cot, 0.125)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias)
    out, lse = _residuals(tq, tk, tv, tb, 0.125)
    got = _backward_reference(tq, tk, tv, tb, torch.from_numpy(cot), 0.125, out=out, lse=lse)
    assert (got[3] is None) == (bias is None)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), w, rtol=0, atol=RESIDUAL_FP32_TOL * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("with_bias", [False, True])
def test_residual_reference_matches_vtm_kernel_bf16(with_bias):
    """The same in bf16: out is K1's bf16 output, so delta carries its
    rounding; the gradients stay within BF16_TOL of the Pallas kernel's."""
    b, h, n, d = 1, 2, 200, 64
    q, k, v, bias, cot = _inputs(b, h, n, d, with_bias, seed=7)
    want = _jax_grads(q, k, v, bias, cot, 0.125, jnp.bfloat16)
    tq, tk, tv, tcot = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, cot))
    tb = None if bias is None else torch.from_numpy(bias)
    out, lse = _residuals(tq, tk, tv, tb, 0.125)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    got = _backward_reference(tq, tk, tv, tb, tcot, 0.125, out=out, lse=lse)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), w, rtol=BF16_TOL, atol=BF16_TOL, err_msg=name)
    if with_bias:
        np.testing.assert_allclose(got[3].numpy(), want[3], atol=BF16_TOL * np.abs(want[3]).max(),
                                   err_msg="dbias")


def test_function_saves_the_residuals_and_backward_uses_them(monkeypatch):
    """_FlashAttention keeps (q, k, v, key_bias, out, lse) when a gradient
    is wanted and hands out and lse to the backward: no K1 rerun, the
    residual arithmetic. Without a gradient K1 writes no lse."""
    b, h, n, d = 1, 2, 48, 16
    q, k, v, bias, cot = (torch.from_numpy(x) for x in _inputs(b, h, n, d, True, seed=8))
    q.requires_grad_()
    forward_calls = []
    real_forward = fa._forward
    monkeypatch.setattr(fa, "_forward", lambda *a, **kw: forward_calls.append(kw) or real_forward(*a, **kw))
    with torch.no_grad():
        assert tome_flash_attention(q, k, v, bias, 0.25).grad_fn is None
    assert tome_flash_attention(q.detach(), k, v, bias, 0.25).grad_fn is None
    out = tome_flash_attention(q, k, v, bias, 0.25)
    assert forward_calls == [{}, {}, {"want_lse": True}]
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 6 and torch.equal(saved[4], out)
    assert saved[5].shape == (b, h, n) and saved[5].dtype == torch.float32
    calls = []
    real = fa._backward_reference
    monkeypatch.setattr(fa, "_backward_reference", lambda *a, **kw: calls.append(a) or real(*a, **kw))
    monkeypatch.setattr(fa, "_forward", lambda *a, **kw: pytest.fail("K1 ran again in the backward"))
    (out * cot).sum().backward()
    assert len(calls) == 1 and calls[0][6] is not None and calls[0][7] is not None


def test_backward_without_residuals_makes_them():
    """tome_flash_attention_backward called alone runs K1 (its plain
    version here) for out and lse: the same gradients as with them."""
    b, h, n, d = 1, 2, 40, 16
    q, k, v, bias, cot = (torch.from_numpy(x) for x in _inputs(b, h, n, d, True, seed=9))
    out, lse = _residuals(q, k, v, bias, 0.25)
    alone = tome_flash_attention_backward(q, k, v, bias, cot, 0.25)
    given = tome_flash_attention_backward(q, k, v, bias, cot, 0.25, out=out, lse=lse)
    for a, w in zip(alone, given):
        assert torch.equal(a, w)


@pytest.mark.parametrize("with_bias", [False, True])
def test_function_backward_agrees_with_autograd_of_reference(with_bias):
    """The autograd.Function (forward _reference, backward
    _backward_reference on the CPU) against plain autograd through
    _reference, in fp32 on strided split_heads views."""
    b, h, n, d = 2, 3, 70, 16
    rng = np.random.default_rng(3)
    fused = torch.from_numpy(rng.standard_normal((b, n, 3 * h * d)).astype(np.float32))
    bias = torch.from_numpy(np.log(rng.uniform(1, 5, (b, n))).astype(np.float32)) if with_bias else None
    cot = torch.from_numpy(rng.standard_normal((b, n, h, d)).astype(np.float32)).transpose(1, 2)

    grads = {}
    for name, fn in (("function", tome_flash_attention), ("autograd", _reference)):
        leaf = fused.clone().requires_grad_()
        bleaf = None if bias is None else bias.clone().requires_grad_()
        q, k, v = (split_heads(t, h) for t in leaf.chunk(3, dim=-1))
        out = fn(q, k, v, bleaf, d ** -0.5)
        (out * cot).sum().backward()
        grads[name] = (leaf.grad, None if bleaf is None else bleaf.grad)
    np.testing.assert_allclose(grads["function"][0].numpy(), grads["autograd"][0].numpy(),
                               rtol=1e-4, atol=1e-5)
    if with_bias:
        np.testing.assert_allclose(grads["function"][1].numpy(), grads["autograd"][1].numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_function_skips_dbias_when_bias_needs_no_grad():
    b, h, n, d = 1, 2, 40, 16
    q, k, v, bias, cot = (torch.from_numpy(x) for x in _inputs(b, h, n, d, True, seed=4))
    q.requires_grad_()
    out = tome_flash_attention(q, k, v, bias, 0.25)
    (out * cot).sum().backward()
    assert q.grad is not None and bias.grad is None
    dq, dk, dv, dbias = tome_flash_attention_backward(q.detach(), k, v, bias, cot, 0.25, need_dbias=False)
    assert dbias is None
    np.testing.assert_allclose(dq.numpy(), q.grad.numpy(), rtol=1e-6, atol=1e-6)


def test_cpu_calls_launch_no_kernel():
    before = fa.LAUNCHES, fa.BWD_LAUNCHES
    q, k, v, _, cot = (None if x is None else torch.from_numpy(x) for x in _inputs(1, 1, 8, 16, False, 5))
    q.requires_grad_()
    (tome_flash_attention(q, k, v, None, 0.25) * cot).sum().backward()
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == before


def test_kernel_args_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 1, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.check_kernel_args(q, q, q, None)
    with pytest.raises(ValueError, match="head dim"):
        fa.check_kernel_args(q[..., :8], q[..., :8], q[..., :8], None)
    with pytest.raises(ValueError, match="key_bias"):
        fa.check_kernel_args(q, q, q, torch.zeros(1, 7))
