"""What the port's merge-variant parity tests share (imported by the
``test_torch_*`` files; collects no test itself).

JAX's threefry and torch's Philox draw different numbers from one seed, so
the random modes are held against ``vtm`` with the JAX package's draws put
in place of ``vtm_torch.merge.bipartite.random_scores``: each call splits
the generator's key as ``vtm``'s ``MergeState.next_rng`` does and draws
``jax.random.uniform`` of the asked shape. The Matchings both packages make
are recorded in order, so a test can demand identical indices layer by
layer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vtm.merge import bipartite as jb
from vtm_torch.merge import bipartite as tb

VARIANT_MODES = ("merge", "drop", "hybrid", "random_merge", "random_drop")


def put_in_jax_draws(monkeypatch, key_of):
    """``random_scores`` draws from JAX from here on: ``key_of(generator)``
    gives a generator's first key, and each draw splits it."""
    keys = {}

    def draws(shape, generator):
        if generator is None:
            raise ValueError("the random merge modes require a torch.Generator")
        key = keys[id(generator)][1] if id(generator) in keys else key_of(generator)
        key, sub = jax.random.split(key)
        keys[id(generator)] = (generator, key)  # the generator kept alive with its key
        return torch.tensor(np.asarray(jax.random.uniform(sub, tuple(shape), dtype=jnp.float32)))

    monkeypatch.setattr(tb, "random_scores", draws)


def record_matchings(monkeypatch) -> dict:
    """Every Matching either package makes from here on, in order:
    {"jax": [...], "torch": [...]}."""
    got = {"jax": [], "torch": []}
    for name, module in (("jax", jb), ("torch", tb)):
        def recording(*args, _match=module._match, _seen=got[name], **kwargs):
            m = _match(*args, **kwargs)
            _seen.append(m)
            return m
        monkeypatch.setattr(module, "_match", recording)
    return got


def assert_same_matchings(got: dict) -> None:
    assert len(got["jax"]) == len(got["torch"]) > 0, (len(got["jax"]), len(got["torch"]))
    for i, (mj, mt) in enumerate(zip(got["jax"], got["torch"])):
        assert (mj is None) == (mt is None), i
        if mj is None:
            continue
        assert (mj.n, mj.r) == (mt.n, mt.r), i
        for name in ("unm_idx", "src_idx", "dst_idx"):
            np.testing.assert_array_equal(getattr(mt, name).numpy(), np.asarray(getattr(mj, name)),
                                          err_msg=f"matching {i}: {name}")


def run_variant(monkeypatch, mode: str, models, video: np.ndarray, base_kw: dict, seed: int = 0):
    """One forward of each package's model in ``mode`` with source
    tracking, the draws of the random modes JAX's; the hybrid threshold
    at the median of the first layer's merge-edge scores, so that both
    sides occur. ``models(kw)`` -> (params, jmodel, tmodel) for policy
    keywords ``kw``. Returns (got, tstate, want, jstate, matchings)."""
    kw = dict(base_kw, mode=mode, trace_source=True)
    if mode == "hybrid":
        scores = run_variant(monkeypatch, "merge", models, video, base_kw, seed)[4]["jax"][0].src_score
        kw["threshold"] = float(np.median(np.asarray(scores)))
    params, jmodel, tmodel = models(kw)
    key = jax.random.key(seed)
    put_in_jax_draws(monkeypatch, lambda generator: key)
    matchings = record_matchings(monkeypatch)
    with jax.default_matmul_precision("highest"):
        want, jstate = jmodel.apply({"params": params}, jnp.asarray(video), rng=key)
    with torch.no_grad():
        got, tstate = tmodel(torch.from_numpy(video), generator=torch.Generator())
    assert_same_matchings(matchings)
    if mode == "hybrid":
        first = np.asarray(matchings["jax"][0].src_score)
        assert (first < kw["threshold"]).any() and (first >= kw["threshold"]).any()
    return got, tstate, want, jstate, matchings


def assert_states_equal(tstate, jstate) -> None:
    """Token sizes and the 0/1 source adjacency exactly as ``vtm``'s."""
    np.testing.assert_array_equal(tstate.size.numpy(), np.asarray(jstate.size, np.float32))
    np.testing.assert_array_equal(tstate.source.numpy(), np.asarray(jstate.source, np.float32))
