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
