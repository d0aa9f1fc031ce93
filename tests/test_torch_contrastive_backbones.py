"""The contrastive branches on the backbones other than Slow (C2D, I3D,
SlowFast with two pathways a clip, MViT) in the port against ``vtm``'s on
the CPU, how both refuse a SlowFast view of one pathway, and the family's
free functions (Sinkhorn, the banks' update, the momentum schedule, the
kNN vote). fp32 within ``TOL`` of the largest entry
(``tests/torch_contrastive_cases.py``)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vtm.models.contrastive as jc
import vtm_torch.models.contrastive as tc

from torch_contrastive_cases import TOL, Case, assert_state_matches, rel_err

torch.set_num_threads(2)

INDEX = np.array([0, 3, 5, 7])


@pytest.mark.parametrize("ctype, arch, extra", [
    ("moco", "c2d", ()),
    ("moco", "i3d", ()),
    ("moco", "slowfast", ("SLOWFAST.BETA_INV", "2")),  # a fast pathway 1 channel wide is fp32 noise
    ("simclr", "mvit", ()),
    ("moco", "mvit", ()),
])
def test_branches_on_other_backbones_match_vtm(ctype, arch, extra):
    """The branches over C2D, I3D, SlowFast (two pathways a clip) and MViT:
    logits, loss and every state entry."""
    case = Case(ctype, *extra, arch=arch)
    clips = case.clips(3 if ctype == "moco" else 2, 4, 10)
    want_logits, want_loss, want_sd = case.jax_forward(clips, INDEX)
    logits, loss = case.port_forward(clips, INDEX)
    assert rel_err(logits, want_logits) <= TOL and abs(loss - want_loss) <= TOL * abs(want_loss)
    assert_state_matches(case.model, want_sd)


def test_slowfast_single_pathway_views_fail_as_in_vtm():
    """``train_contrastive`` gives each view as a one-pathway clip; a
    SlowFast backbone refuses one pathway in both packages (``vtm``: an
    AssertionError; the port: a ValueError that says so)."""
    case = Case("moco", arch="slowfast")
    clips = [[c[1]] for c in case.clips(2, 4, 11)]
    with pytest.raises(AssertionError):
        case.jmodel.forward_train(case.params, case.stats, case.state, [[jnp.asarray(c[0])] for c in clips],
                                  jnp.asarray(INDEX))
    with pytest.raises(ValueError, match="1 pathways given, 2 expected"):
        case.port_forward(clips, INDEX)
def test_free_functions_match_vtm():
    """sinkhorn, memory_update at unique rows, momentum_anneal_cosine,
    l2_normalize, contrastive_loss, knn_predict (labels past the bank's
    end clamped, as JAX gathers)."""
    rng = np.random.default_rng(0)
    scores = np.exp(rng.standard_normal((6, 40)).astype(np.float32) / 0.5)
    assert rel_err(tc.sinkhorn(torch.from_numpy(scores), 3).numpy(), np.asarray(jc.sinkhorn(jnp.asarray(scores), 3))) <= TOL
    bank = rng.standard_normal((12, 8)).astype(np.float32)
    mem = rng.standard_normal((4, 8)).astype(np.float32)
    ind = np.array([5, 0, 11, 3])
    want = np.asarray(jc.memory_update(bank, mem, 0.3, ind))
    got = tc.memory_update(torch.from_numpy(bank.copy()), torch.from_numpy(mem), 0.3, torch.from_numpy(ind))
    assert rel_err(got.numpy(), want) <= TOL
    knobs = ("moco", 0.1, 8, 12, 16, 0.994, True, 10.0, True, "1d", False, False, 0, False, True, 7)
    cc, jcc = tc.ContrastiveConfig(*knobs), jc.ContrastiveConfig(*knobs)
    for e in (0.0, 0.37, 4.5, 9.99):
        assert abs(tc.momentum_anneal_cosine(cc, e) - float(jc.momentum_anneal_cosine(jcc, e))) <= 1e-7
    logits = rng.standard_normal((4, 17)).astype(np.float32)
    assert abs(float(tc.contrastive_loss(torch.from_numpy(logits))) - float(jc.contrastive_loss(logits))) <= 1e-6
    assert rel_err(tc.l2_normalize(torch.from_numpy(mem)).numpy(), np.asarray(jc.l2_normalize(mem))) <= TOL

    case = Case("moco", "CONTRASTIVE.LENGTH", "24")
    q = tc.l2_normalize(torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32)))
    labels = rng.integers(0, 9, 20)  # 20 labels for 24 rows; 9 > 7 classes
    want = np.asarray(jc.knn_predict(case.jmodel, case.state, jnp.asarray(q.numpy()), labels, 7))
    got = tc.knn_predict(case.model, q, labels, 7).numpy()
    assert rel_err(got, want) <= TOL
    yd, yi = case.model.eval_knn(q)
    jyd, jyi = case.jmodel.eval_knn(case.state, jnp.asarray(q.numpy()))
    assert np.array_equal(yi.numpy(), np.asarray(jyi)) and rel_err(yd.numpy(), np.asarray(jyd)) <= TOL


