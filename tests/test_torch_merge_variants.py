"""Every function of the port's ``merge/bipartite.py`` and ``reduce_tokens``
against the JAX package's, on the CPU.

The same numpy inputs go through ``vtm.merge.bipartite`` and
``vtm_torch.merge.bipartite``, with and without class and distillation
tokens, with r clamped: the Matching indices must be identical (the random
modes given JAX's draws, ``torch_variants.put_in_jax_draws``), fp32 outputs
within 1e-6, and bf16 outputs rounded at the same points (identical where
each output is one rounding of the same value, within two bf16 ulps where
a mass product is involved).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtm.merge import bipartite as jb
from vtm.merge import policy as jp
from vtm_torch.merge import bipartite as tb
from vtm_torch.merge.policy import MergePolicy, MergeState, reduce_tokens

from torch_variants import VARIANT_MODES, put_in_jax_draws

torch.set_num_threads(2)

B, N, C, HD = 2, 23, 6, 5
FP32_TOL = 1e-6
TOKENS = [(False, False), (True, False), (True, True)]
TOKEN_IDS = ["plain", "class", "class_distill"]


def _inputs(seed, n=N, c=C):
    rng = np.random.default_rng(seed)
    metric = rng.standard_normal((B, n, HD)).astype(np.float32)
    x = rng.standard_normal((B, n, c)).astype(np.float32)
    return metric, x


def _draws(monkeypatch, seed=0):
    key = jax.random.key(seed)
    put_in_jax_draws(monkeypatch, lambda generator: key)
    return key


def _same_matching(mj, mt):
    assert (mj is None) == (mt is None)
    if mj is None:
        return
    assert (mj.n, mj.r, mj.distill_token) == (mt.n, mt.r, mt.distill_token)
    for name in ("unm_idx", "src_idx", "dst_idx"):
        np.testing.assert_array_equal(getattr(mt, name).numpy(), np.asarray(getattr(mj, name)), err_msg=name)
    np.testing.assert_allclose(mt.src_score.numpy(), np.asarray(mj.src_score), rtol=0, atol=FP32_TOL)
    assert mt.src_score.dtype == torch.float32


def _matchings(mode, metric, r, class_token, distill_token, monkeypatch, threshold=0.0):
    """(vtm's, the port's) Matching of ``mode`` on the same metric; the
    random modes draw the same JAX uniforms in both (vtm's matchers draw
    from the key given, the fake from the key's first split)."""
    key = jax.random.split(_draws(monkeypatch))[1]
    mt_metric = torch.from_numpy(metric)
    args = (r, class_token, distill_token)
    if mode in ("drop", "random_drop"):
        return (jb.bipartite_soft_matching_drop(jnp.asarray(metric), *args, mode, key),
                tb.bipartite_soft_matching_drop(mt_metric, *args, mode, torch.Generator()))
    if mode == "hybrid":
        return (jb.bipartite_soft_matching_hybrid(jnp.asarray(metric), *args, "hybrid", threshold, key),
                tb.bipartite_soft_matching_hybrid(mt_metric, *args, "hybrid", threshold, torch.Generator()))
    return (jb.bipartite_soft_matching(jnp.asarray(metric), *args, mode, key),
            tb.bipartite_soft_matching(mt_metric, *args, mode, torch.Generator()))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("tokens", TOKENS, ids=TOKEN_IDS)
@pytest.mark.parametrize("r", [1, 5, 100], ids=["r1", "r5", "clamped"])
@pytest.mark.parametrize("mode", ["merge", "random_merge", "drop", "random_drop", "hybrid"])
def test_matching_identical(mode, r, tokens, monkeypatch):
    metric, _ = _inputs(r)
    mj, mt = _matchings(mode, metric, r, *tokens, monkeypatch)
    _same_matching(mj, mt)
    assert mt.r == jb._effective_r(N, r, *tokens)


def test_zero_r_is_identity_in_every_function():
    metric, x = _inputs(0)
    m = tb.bipartite_soft_matching(torch.from_numpy(metric), 0)
    xt = torch.from_numpy(x)
    assert m is None
    for fn in (tb.merge, tb.unmerge, tb.drop):
        assert fn(None, xt) is xt
    out, size = tb.merge_wavg(None, xt)
    assert out is xt and bool((size == 1).all())


@pytest.mark.parametrize("mode", ["merge", "drop", "hybrid"])
def test_wrong_mode_raises_value_error_as_vtm_does(mode):
    metric = torch.from_numpy(_inputs(0)[0])
    fn = {"merge": tb.bipartite_soft_matching_drop, "drop": tb.bipartite_soft_matching,
          "hybrid": tb.bipartite_soft_matching_drop}[mode]
    with pytest.raises(ValueError, match="unsupported mode"):
        fn(metric, 2, mode=mode)


def test_random_scores_need_a_generator_and_draw_on_its_device():
    with pytest.raises(ValueError, match="torch.Generator"):
        tb.random_scores((2, 3), None)
    with pytest.raises(ValueError, match="torch.Generator"):
        tb.bipartite_soft_matching(torch.from_numpy(_inputs(0)[0]), 2, mode="random_merge")
    a = tb.random_scores((2, 3, 4), torch.Generator().manual_seed(5))
    b = tb.random_scores((2, 3, 4), torch.Generator().manual_seed(5))
    c = tb.random_scores((2, 3, 4), torch.Generator().manual_seed(6))
    assert a.dtype == torch.float32 and a.device.type == "cpu" and tuple(a.shape) == (2, 3, 4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert bool(((a >= 0) & (a < 1)).all())


@pytest.mark.parametrize("threshold", [None, "median"], ids=["plain", "hybrid"])
@pytest.mark.parametrize("tokens", TOKENS, ids=TOKEN_IDS)
@pytest.mark.parametrize("reduce", ["sum", "mean", "amax", "max", "prod"])
def test_merge_every_reduction(reduce, tokens, threshold, monkeypatch):
    """merge() in fp32 within 1e-6 for every scatter mode, with the hybrid
    dst-zeroing at the median edge score (both sides occur)."""
    metric, x = _inputs(11)
    mj, mt = _matchings("merge", metric, 7, *tokens, monkeypatch)
    if threshold == "median":
        threshold = float(np.median(np.asarray(mj.src_score)))
        below = np.asarray(mj.src_score) < threshold
        assert below.any() and not below.all()
    want = jb.merge(mj, jnp.asarray(x), mode=reduce, threshold=threshold)
    got = tb.merge(mt, torch.from_numpy(x), mode=reduce, threshold=threshold)
    assert tuple(got.shape) == (B, N - mt.r, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("reduce", ["sum", "mean", "amax", "prod"])
def test_scatter_every_mode_with_repeated_destinations(reduce):
    rng = np.random.default_rng(2)
    dst = rng.standard_normal((B, 5, C)).astype(np.float32)
    src = rng.standard_normal((B, 9, C)).astype(np.float32)
    idx = rng.integers(0, 3, (B, 9))  # dsts 3 and 4 get nothing, the others several
    want = jb._scatter(jnp.asarray(dst), jnp.asarray(idx), jnp.asarray(src), reduce)
    got = tb._scatter(torch.from_numpy(dst), torch.from_numpy(idx), torch.from_numpy(src), reduce)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FP32_TOL, atol=FP32_TOL)
    with pytest.raises(ValueError, match="reduce mode"):
        tb._scatter(torch.from_numpy(dst), torch.from_numpy(idx), torch.from_numpy(src), "median")


@pytest.mark.parametrize("reduce", ["sum", "amax"])
def test_scatter_bf16_rounds_where_vtm_does(reduce):
    """bf16 in and out: the sum accumulated in fp32 and rounded once, the
    max exact; identical bits."""
    rng = np.random.default_rng(3)
    dst = rng.standard_normal((B, 5, C)).astype(np.float32)
    src = rng.standard_normal((B, 9, C)).astype(np.float32)
    idx = rng.integers(0, 5, (B, 9))
    want = jb._scatter(jnp.asarray(dst, jnp.bfloat16), jnp.asarray(idx), jnp.asarray(src, jnp.bfloat16), reduce)
    got = tb._scatter(torch.from_numpy(dst).bfloat16(), torch.from_numpy(idx), torch.from_numpy(src).bfloat16(),
                      reduce)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


@pytest.mark.parametrize("tokens", TOKENS, ids=TOKEN_IDS)
@pytest.mark.parametrize("threshold", [None, "median"], ids=["plain", "hybrid"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_wavg_with_threshold(dtype, threshold, tokens, monkeypatch):
    """Sizes exact and fp32; x within 1e-6 in fp32, within two bf16 ulps in
    bf16 (the mass product rounds once in bf16 in both)."""
    metric, x = _inputs(4)
    mj, mt = _matchings("merge", metric, 6, *tokens, monkeypatch)
    if threshold == "median":
        threshold = float(np.median(np.asarray(mj.src_score)))
    size = np.random.default_rng(5).integers(1, 4, (B, N, 1)).astype(np.float32)
    xj, sj = jb.merge_wavg(mj, jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(size), threshold=threshold)
    xt, st = tb.merge_wavg(mt, torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(size),
                           threshold=threshold)
    assert xt.dtype == getattr(torch, dtype) and st.dtype == torch.float32
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    tol = FP32_TOL if dtype == "float32" else 2 * 2.0 ** -8 * float(np.abs(_np(xj)).max())
    np.testing.assert_allclose(xt.float().numpy(), _np(xj), rtol=0, atol=tol)
    if threshold is not None:  # a dropped group keeps its merged srcs' sizes only
        assert (st.numpy() < size.sum(axis=1, keepdims=True)).all()


@pytest.mark.parametrize("tokens", TOKENS, ids=TOKEN_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_drop_and_unmerge(dtype, tokens, monkeypatch):
    metric, x = _inputs(6)
    for mode, fn in (("drop", "drop"), ("merge", "unmerge")):
        mj, mt = _matchings(mode, metric, 8, *tokens, monkeypatch)
        xin = x[:, : mt.out_tokens] if fn == "unmerge" else x
        want = getattr(jb, fn)(mj, jnp.asarray(xin, getattr(jnp, dtype)))
        got = getattr(tb, fn)(mt, torch.from_numpy(xin).to(getattr(torch, dtype)))
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got.float().numpy(), _np(want), err_msg=fn)


@pytest.mark.parametrize("tokens", TOKENS, ids=TOKEN_IDS)
@pytest.mark.parametrize("mode", ["merge", "drop", "hybrid"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sources_over_two_steps(dtype, mode, tokens, monkeypatch):
    """merge_source / drop_source from the identity in x's dtype, then a
    second step on the first's source: the same 0/1 adjacency as vtm's,
    every original token in at most one group."""
    metric, x = _inputs(7)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    sj = st = None
    for step, r in enumerate((6, 4)):
        m_in = metric[:, : N - 6 * step]
        xin = x[:, : N - 6 * step]
        threshold = None
        mj, mt = _matchings("drop" if mode == "drop" else "merge", m_in, r, *tokens, monkeypatch)
        if mode == "hybrid":
            threshold = float(np.median(np.asarray(mj.src_score)))
        if mode == "drop":
            sj = jb.drop_source(mj, jnp.asarray(xin, jdt), sj)
            st = tb.drop_source(mt, torch.from_numpy(xin).to(tdt), st)
        else:
            sj = jb.merge_source(mj, jnp.asarray(xin, jdt), sj, threshold=threshold)
            st = tb.merge_source(mt, torch.from_numpy(xin).to(tdt), st, threshold=threshold)
        assert st.dtype == tdt and tuple(st.shape) == (B, N - 6 * step - r, N)
        np.testing.assert_array_equal(st.float().numpy(), _np(sj))
    assert set(np.unique(st.float().numpy())) <= {0.0, 1.0}
    assert (st.float().numpy().sum(axis=1) <= 1).all()


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("reduce", ["mean", "sum", "amax"])
def test_kth_matching(k, reduce):
    metric, x = _inputs(8, n=24)
    mj, uj = jb.kth_bipartite_soft_matching(jnp.asarray(metric), k)
    mt, ut = tb.kth_bipartite_soft_matching(torch.from_numpy(metric), k)
    want = mj(jnp.asarray(x), mode=reduce)
    got = mt(torch.from_numpy(x), mode=reduce)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(ut(got).numpy(), np.asarray(uj(want)), rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("r", [0, 5, 11])
@pytest.mark.parametrize("reduce", ["mean", "sum", "prod"])
def test_random_partition_matching(r, reduce, monkeypatch):
    """The partition drawn by random_scores (JAX's draws put in)."""
    metric, x = _inputs(9)
    key = _draws(monkeypatch, seed=3)
    mj, uj = jb.random_bipartite_soft_matching(jnp.asarray(metric), r, jax.random.split(key)[1])
    mt, ut = tb.random_bipartite_soft_matching(torch.from_numpy(metric), r, torch.Generator())
    want = mj(jnp.asarray(x), mode=reduce)
    got = mt(torch.from_numpy(x), mode=reduce)
    assert tuple(got.shape) == (B, N - r, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(ut(got).numpy(), np.asarray(uj(want)), rtol=FP32_TOL, atol=FP32_TOL)


def _jax_draws_of_state(monkeypatch, seed):
    """vtm's MergeState with the rng whose splits the port's fake
    random_scores repeats."""
    key = _draws(monkeypatch, seed)
    return jp.MergeState(rng=key)


@pytest.mark.parametrize("trace_source", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("tokens", TOKENS, ids=TOKEN_IDS)
@pytest.mark.parametrize("mode", VARIANT_MODES)
def test_reduce_tokens_over_three_layers(mode, tokens, trace_source, monkeypatch):
    """reduce_tokens through three layers (r 4, 0, 5) in both packages:
    the same x, sizes and sources; drop leaves sizes of ones, fp32."""
    metric, x = _inputs(10)
    kw = dict(rs=(4, 0, 5), mode=mode, threshold=0.3, trace_source=trace_source,
              class_token=tokens[0], distill_token=tokens[1])
    jpol, tpol = jp.MergePolicy(**kw), MergePolicy(**kw)
    jstate = _jax_draws_of_state(monkeypatch, 1)
    tstate = MergeState(generator=torch.Generator())
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    mj_in, mt_in = jnp.asarray(metric), torch.from_numpy(metric)
    for layer in range(3):
        xj, jstate = jp.reduce_tokens(jpol, layer, mj_in[:, : xj.shape[1]], xj, jstate)
        xt, tstate = reduce_tokens(tpol, layer, mt_in[:, : xt.shape[1]], xt, tstate)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=FP32_TOL, atol=FP32_TOL)
    assert xt.shape[1] == tpol.token_counts(N)[-1] == jpol.token_counts(N)[-1]
    np.testing.assert_array_equal(tstate.size.numpy(), np.asarray(jstate.size, np.float32))
    assert tstate.size.dtype == torch.float32
    if mode in ("drop", "random_drop"):
        assert bool((tstate.size == 1).all())
    if trace_source:
        np.testing.assert_array_equal(tstate.source.numpy(), np.asarray(jstate.source))
    else:
        assert tstate.source is None


@pytest.mark.parametrize("mode", ["random_merge", "random_drop"])
def test_random_modes_without_a_generator_raise(mode):
    metric, x = _inputs(0)
    policy = MergePolicy(rs=(2,), mode=mode)
    assert policy.needs_rng and policy.enabled
    with pytest.raises(ValueError, match="torch.Generator"):
        reduce_tokens(policy, 0, torch.from_numpy(metric), torch.from_numpy(x), MergeState())


@pytest.mark.parametrize("mode", VARIANT_MODES + ("none",))
def test_policy_fields_and_token_counts_match_vtm(mode):
    kw = dict(rs=(5, 5, 30), mode=mode, threshold=0.2, trace_source=True, class_token=True, distill_token=True)
    jpol, tpol = jp.MergePolicy(**kw), MergePolicy(**kw)
    for field in ("enabled", "needs_rng", "rs", "threshold", "trace_source", "distill_token"):
        assert getattr(tpol, field) == getattr(jpol, field), field
    assert tpol.token_counts(40) == tuple(jpol.token_counts(40))
    with pytest.raises(ValueError, match="unknown merge mode"):
        MergePolicy(rs=(1,), mode="average")
