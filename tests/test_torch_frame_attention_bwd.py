"""The plain version of the per-frame attention backward (K4) against the
JAX package's fused backward, and the autograd.Function around K3/K4 on
the CPU.

``jax.grad`` through ``vtm.ops.flash_attention.tome_frame_attention`` runs
the Pallas backward kernel in interpret mode (for odd head counts and long
rows the JAX package differentiates its dense reference instead), as the
JAX package's own gradient test does. Inputs are made with numpy from a
seed and fed to both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vtm.ops.flash_attention import tome_frame_attention as jax_frame_attention
from vtm_torch.models.common import split_heads
from vtm_torch.ops import flash_attention as fa
from vtm_torch.ops.flash_attention import (
    _frame_backward_reference,
    _frame_reference,
    tome_frame_attention,
    tome_frame_attention_backward,
)

torch.set_num_threads(2)

# the tolerance of the JAX package's own gradient test
GRAD_TOL = 2e-4
# bf16: the plain version may be off the JAX kernel by a few bf16 roundings
# of values of order 1 (the forward test's tolerance)
BF16_TOL = 5e-2

# (frames, keys per frame, heads): the JAX gradient test's cases
CASES = [
    (8, 40, 4),   # even heads: the fused head-pair kernel
    (4, 50, 2),   # exact-divisor q block
    (5, 8, 4),    # odd frame count
    (8, 40, 3),   # odd heads
    (8, 300, 4),  # long rows
]


def _inputs(b, h, f, s, d, with_bias, seed):
    rng = np.random.default_rng(seed)
    n = f * s
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3))
    bias = np.log(rng.uniform(1, 5, (b, n))).astype(np.float32) if with_bias else None
    cot = rng.standard_normal((b, n, f, h, d)).astype(np.float32)
    return q, k, v, bias, cot


def _jax_grads(q, k, v, bias, cot, scale, frames, dtype=jnp.float32):
    argnums = (0, 1, 2) + ((3,) if bias is not None else ())

    def loss(q_, k_, v_, b_):
        out = jax_frame_attention(q_, k_, v_, b_, scale, frames)
        return (out.astype(jnp.float32) * jnp.asarray(cot)).sum()

    grads = jax.grad(loss, argnums=argnums)(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        None if bias is None else jnp.asarray(bias),
    )
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


@pytest.mark.parametrize("f,s,h", CASES)
@pytest.mark.parametrize("with_bias", [False, True])
def test_frame_backward_reference_matches_vtm_kernel(f, s, h, with_bias):
    b, d = 2, 16
    q, k, v, bias, cot = _inputs(b, h, f, s, d, with_bias, seed=3)
    want = _jax_grads(q, k, v, bias, cot, 0.25, f)
    got = _frame_backward_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias), torch.from_numpy(cot), 0.25, f,
    )
    assert (got[3] is None) == (bias is None)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert tuple(a.shape) == w.shape, name
        np.testing.assert_allclose(a.numpy(), w, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)


def test_frame_backward_reference_matches_vtm_kernel_bf16():
    b, h, f, s, d = 1, 2, 4, 50, 64
    q, k, v, bias, cot = _inputs(b, h, f, s, d, True, seed=2)
    want = _jax_grads(q, k, v, bias, cot, 0.125, f, jnp.bfloat16)
    tq, tk, tv, tcot = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, cot))
    # the JAX cotangent reaches the kernel in bf16 as well
    got = _frame_backward_reference(tq, tk, tv, torch.from_numpy(bias), tcot, 0.125, f)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), w, rtol=BF16_TOL, atol=BF16_TOL, err_msg=name)
    assert got[3].dtype == torch.float32
    scale = np.abs(want[3]).max()
    np.testing.assert_allclose(got[3].numpy(), want[3], atol=BF16_TOL * scale, err_msg="dbias")


@pytest.mark.parametrize("with_bias", [False, True])
def test_function_backward_agrees_with_autograd_of_reference(with_bias):
    """The autograd.Function (forward _frame_reference, backward
    _frame_backward_reference on the CPU) against plain autograd through
    _frame_reference, in fp32 on strided split_heads views offset by one
    row (the CLS row), with a ragged frame length."""
    b, h, f, s, d = 2, 3, 4, 19, 16
    n = f * s
    rng = np.random.default_rng(3)
    fused = torch.from_numpy(rng.standard_normal((b, n + 1, 3 * h * d)).astype(np.float32))
    bias = torch.from_numpy(np.log(rng.uniform(1, 5, (b, n))).astype(np.float32)) if with_bias else None
    cot = torch.from_numpy(rng.standard_normal((b, n, f, h, d)).astype(np.float32))

    grads = {}
    for name, fn in (("function", tome_frame_attention), ("autograd", _frame_reference)):
        leaf = fused.clone().requires_grad_()
        bleaf = None if bias is None else bias.clone().requires_grad_()
        q, k, v = (split_heads(t, h)[:, :, 1:] for t in leaf.chunk(3, dim=-1))
        out = fn(q, k, v, bleaf, d ** -0.5, f)
        assert tuple(out.shape) == (b, n, f, h, d)
        (out * cot).sum().backward()
        grads[name] = (leaf.grad, None if bleaf is None else bleaf.grad)
    assert torch.count_nonzero(grads["function"][0][:, 0]) == 0  # the CLS row is not an input
    np.testing.assert_allclose(grads["function"][0].numpy(), grads["autograd"][0].numpy(),
                               rtol=1e-4, atol=1e-5)
    if with_bias:
        np.testing.assert_allclose(grads["function"][1].numpy(), grads["autograd"][1].numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_function_passes_gradcheck_sized_differences():
    """Finite differences of the loss through the autograd.Function on a
    tiny fp32 case agree with its analytic gradients within 2e-2 of each
    gradient's largest entry (fp32 central differences at eps 1e-2)."""
    b, h, f, s, d = 1, 2, 2, 3, 16
    q, k, v, bias, cot = (torch.from_numpy(x) for x in _inputs(b, h, f, s, d, True, seed=8))
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    (tome_frame_attention(*leaves, 0.25, f) * cot).sum().backward()

    def loss(args):
        with torch.no_grad():
            return (tome_frame_attention(*args, 0.25, f).double() * cot.double()).sum().item()

    eps = 1e-2
    rng = np.random.default_rng(9)
    for i, leaf in enumerate(leaves):
        flat = leaf.detach().reshape(-1)
        for j in rng.choice(flat.numel(), size=6, replace=False):
            args = [t.detach().clone() for t in leaves]
            args[i].reshape(-1)[j] += eps
            up = loss(args)
            args[i].reshape(-1)[j] -= 2 * eps
            numeric = (up - loss(args)) / (2 * eps)
            analytic = leaf.grad.reshape(-1)[j].item()
            assert abs(numeric - analytic) <= 2e-2 * leaf.grad.abs().max().item(), (i, j)


def test_function_skips_dbias_when_bias_needs_no_grad():
    b, h, f, s, d = 1, 2, 4, 10, 16
    q, k, v, bias, cot = (torch.from_numpy(x) for x in _inputs(b, h, f, s, d, True, seed=4))
    q.requires_grad_()
    out = tome_frame_attention(q, k, v, bias, 0.25, f)
    (out * cot).sum().backward()
    assert q.grad is not None and bias.grad is None
    dq, dk, dv, dbias = tome_frame_attention_backward(
        q.detach(), k, v, bias, cot, 0.25, f, need_dbias=False)
    assert dbias is None
    np.testing.assert_allclose(dq.numpy(), q.grad.numpy(), rtol=1e-6, atol=1e-6)
    assert tome_frame_attention_backward(q.detach(), k, v, None, cot, 0.25, f)[3] is None
    assert tome_frame_attention_backward(q.detach(), k, v, bias, cot, 0.25, f)[3].shape == (b, f * s)


def test_keys_of_other_frames_get_no_gradient_from_a_frame():
    """A cotangent that is zero outside frame 1 leaves dk and dv zero
    outside frame 1's keys, and dq is that frame's alone."""
    b, h, f, s, d = 1, 2, 3, 7, 16
    q, k, v, bias, cot = (torch.from_numpy(x) for x in _inputs(b, h, f, s, d, True, seed=5))
    cot[:, :, 0] = 0
    cot[:, :, 2] = 0
    dq, dk, dv, dbias = _frame_backward_reference(q, k, v, bias, cot, 0.25, f)
    outside = torch.ones(f * s, dtype=torch.bool)
    outside[s:2 * s] = False
    assert torch.count_nonzero(dk[:, :, outside]) == 0
    assert torch.count_nonzero(dv[:, :, outside]) == 0
    assert torch.count_nonzero(dbias[:, outside]) == 0
    assert torch.count_nonzero(dq) > 0


def test_cpu_calls_launch_no_kernel():
    before = fa.FRAME_LAUNCHES, fa.FRAME_BWD_LAUNCHES
    q, k, v, _, cot = (None if x is None else torch.from_numpy(x) for x in _inputs(1, 1, 2, 4, 16, False, 5))
    q.requires_grad_()
    (tome_frame_attention(q, k, v, None, 0.25, 2) * cot).sum().backward()
    assert (fa.FRAME_LAUNCHES, fa.FRAME_BWD_LAUNCHES) == before


def test_frame_kernel_args_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 1, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.check_frame_kernel_args(q, q, q, None, 2)
    with pytest.raises(ValueError, match="does not divide"):
        fa.check_frame_kernel_args(q, q, q, None, 3)
    long = torch.zeros(1, 1, 2 * (fa.MAX_FRAME_LEN + 1), 16)
    with pytest.raises(ValueError, match="keys per frame"):
        fa.check_frame_kernel_args(long, long, long, None, 2)
