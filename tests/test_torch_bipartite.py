"""The port's matcher and size-weighted merge against the JAX package's.

Same numpy inputs through ``vtm.merge.bipartite`` and
``vtm_torch.merge.bipartite``: the Matching indices must be identical
(random metrics and metrics with exact ties), and merge_wavg must agree
to fp32 rounding (1e-6) in fp32, and to two bf16 ulps in bf16.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vtm.merge import bipartite as jb
from vtm.models.common import aggregate_metric as jax_aggregate
from vtm_torch.merge import bipartite as tb
from vtm_torch.merge.policy import MergePolicy, MergeState, reduce_tokens
from vtm_torch.models.common import aggregate_metric

torch.set_num_threads(2)

B, H, N, HD, C = 2, 3, 48, 8, 16


def _keys(seed, ties):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, H, N, HD)).astype(np.float32)
    if ties:
        # duplicated tokens: exact score ties within the src set and
        # between dst candidates
        k[:, :, 2] = k[:, :, 0]
        k[:, :, 6] = k[:, :, 0]
        k[:, :, 5] = k[:, :, 1]
        k[:, :, 11] = k[:, :, 3]
        k[:, :, 20:30] = k[:, :, 10:20]
    return k


def _metrics(k, aggregation, dtype_jax=jnp.float32, dtype_torch=torch.float32):
    mj = jax_aggregate(jnp.asarray(k, dtype_jax), aggregation)
    mt = aggregate_metric(torch.from_numpy(k).to(dtype_torch), aggregation)
    return mj, mt


def _assert_same_matching(mj, mt):
    assert mj.r == mt.r and mj.n == mt.n
    for name in ("unm_idx", "src_idx", "dst_idx"):
        np.testing.assert_array_equal(np.asarray(getattr(mj, name)), getattr(mt, name).numpy(), err_msg=name)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("aggregation", ["mean", "concat"])
@pytest.mark.parametrize("r", [1, 7, 24, 30])
def test_matching_indices_identical(ties, aggregation, r):
    mj, mt = _metrics(_keys(r, ties), aggregation)
    m_jax = jb.bipartite_soft_matching(mj, r)
    m_torch = tb.bipartite_soft_matching(mt, r)
    _assert_same_matching(m_jax, m_torch)


@pytest.mark.parametrize("class_token", [False, True])
def test_protected_class_token(class_token):
    mj, mt = _metrics(_keys(3, True), "mean")
    _assert_same_matching(
        jb.bipartite_soft_matching(mj, 9, class_token=class_token),
        tb.bipartite_soft_matching(mt, 9, class_token=class_token),
    )


def test_zero_r_is_identity():
    x = torch.randn(B, N, C)
    assert tb.bipartite_soft_matching(x, 0) is None
    y, size = tb.merge_wavg(None, x)
    assert y is x and torch.equal(size, torch.ones(B, N, 1))


@pytest.mark.parametrize("ties", [False, True])
def test_merge_wavg_fp32(ties):
    rng = np.random.default_rng(7)
    k = _keys(7, ties)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    size = rng.integers(1, 6, (B, N, 1)).astype(np.float32)
    mj, mt = _metrics(k, "mean")
    m_jax = jb.bipartite_soft_matching(mj, 13)
    m_torch = tb.bipartite_soft_matching(mt, 13)
    xj, sj = jb.merge_wavg(m_jax, jnp.asarray(x), jnp.asarray(size))
    xt, st = tb.merge_wavg(m_torch, torch.from_numpy(x), torch.from_numpy(size))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6, atol=1e-6)


def test_merge_wavg_bf16():
    rng = np.random.default_rng(8)
    k = _keys(8, False)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    mj, mt = _metrics(k, "mean", jnp.bfloat16, torch.bfloat16)
    m_jax = jb.bipartite_soft_matching(mj, 13)
    m_torch = tb.bipartite_soft_matching(mt, 13)
    _assert_same_matching(m_jax, m_torch)
    # two merge steps, so merged sizes above 1 reach the bf16 mass product
    xj, sj = jb.merge_wavg(m_jax, jnp.asarray(x, jnp.bfloat16))
    xt, st = tb.merge_wavg(m_torch, torch.from_numpy(x).bfloat16())
    m2j = jb.bipartite_soft_matching(jnp.asarray(xj[..., :HD]), 9)
    m2t = tb.bipartite_soft_matching(xt[..., :HD], 9)
    _assert_same_matching(m2j, m2t)
    xj, sj = jb.merge_wavg(m2j, xj, sj)
    xt, st = tb.merge_wavg(m2t, xt, st)
    assert xt.dtype == torch.bfloat16 and st.dtype == torch.float32
    np.testing.assert_allclose(
        xt.float().numpy(), np.asarray(xj.astype(jnp.float32)), rtol=8e-3, atol=8e-3
    )
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_reduce_tokens_merge_and_none():
    x = torch.randn(B, N, C)
    metric = torch.randn(B, N, HD)
    merged, state = reduce_tokens(MergePolicy(rs=(5,), mode="merge"), 0, metric, x, MergeState())
    assert merged.shape == (B, N - 5, C) and state.size.shape == (B, N - 5, 1)
    assert float(state.size.sum()) == B * N
    same, state = reduce_tokens(MergePolicy(rs=(5,), mode="none"), 0, metric, x, MergeState())
    assert same is x and state.size is None
