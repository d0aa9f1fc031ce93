"""The port's contrastive family (``vtm_torch/models/contrastive.py``)
against ``vtm``'s on the CPU: each branch's forward (logits, loss) and
every state entry after it (the momentum encoder's parameters and
statistics, the online BatchNorm statistics, the queues, ``ptr``, ``iter``,
the banks, SwAV's flag), fp32 within ``TOL`` of the largest entry, from the
same weights and state (``tests/torch_contrastive_cases.py``); and the
checks that raise. The MLP heads: ``test_torch_contrastive_heads.py``;
the backbones other than Slow and the free functions:
``test_torch_contrastive_backbones.py``; the steps:
``test_torch_contrastive_train.py``; LARS and ``train_net``:
``test_torch_contrastive_train_net.py``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vtm.models.contrastive as jc
import vtm_torch.models.contrastive as tc

from torch_contrastive_cases import TOL, Case, assert_state_matches, rel_err

torch.set_num_threads(2)

INDEX = np.array([0, 3, 5, 7])


def _parity(case: Case, clips, index=INDEX, **kw) -> dict:
    """One forward in both packages: logits, loss and every state entry
    within TOL; returns the errors."""
    jkw = {k: v for k, v in kw.items() if k != "neg_index"}
    want_logits, want_loss, want_sd = case.jax_forward(clips, index, **jkw)
    logits, loss = case.port_forward(clips, index, **kw)
    errs = {"logits": rel_err(logits, want_logits), "loss": abs(loss - want_loss) / max(abs(want_loss), 1e-30)}
    assert errs["logits"] <= TOL and errs["loss"] <= TOL, errs
    errs.update(assert_state_matches(case.model, want_sd))
    return errs


def _perturbed_history(case: Case, seed: int) -> None:
    """A momentum encoder away from the online one, one update in (``iter``
    1), in both packages."""
    rng = np.random.default_rng(seed)
    case.state["hist_params"] = jax.tree_util.tree_map(
        lambda a: (a * (1 + 0.1 * rng.standard_normal(a.shape))).astype(np.float32), case.state["hist_params"])
    case.state["iter"] = np.int32(1)
    case.load()


@pytest.mark.parametrize("history", ["first", "blended"])
def test_moco_forward_and_state_match_vtm(history):
    """Keys through the momentum encoder (copied at iter 0, blended after)
    in one forward of the two key clips, the queue written at ptr, iter +1,
    the kNN bank at the batch's rows."""
    case = Case("moco", "CONTRASTIVE.MOMENTUM_ANNEALING", "True", "SOLVER.MAX_EPOCH", "4")
    if history == "blended":
        _perturbed_history(case, 11)
    errs = _parity(case, case.clips(3, 4, 1), epoch_exact=1.5)
    assert int(case.model.ptr) == 4 and int(case.model.iter) == (1 if history == "first" else 2)
    print(history, {k: f"{v:.2e}" for k, v in sorted(errs.items(), key=lambda kv: -kv[1])[:4]})


def test_moco_multi_view_queue_and_external_keys_match_vtm():
    """MOCO_MULTI_VIEW_QUEUE writes both keys; keys given from outside
    leave the queue, ptr, iter and the momentum encoder alone."""
    case = Case("moco", "CONTRASTIVE.MOCO_MULTI_VIEW_QUEUE", "True")
    clips = case.clips(3, 4, 2)
    _parity(case, clips)
    assert int(case.model.ptr) == 8
    case = Case("moco")
    keys = [tc.l2_normalize(torch.from_numpy(np.random.default_rng(3).standard_normal((4, 8)).astype(np.float32)))]
    before = {k: v.clone() for k, v in case.model.state_dict().items() if not k.startswith("backbone.")}
    want_logits, want_loss, want_sd = case.jax_forward(clips[:2], INDEX, keys=[jnp.asarray(keys[0].numpy())])
    logits, loss = case.port_forward(clips[:2], INDEX, keys=keys)
    assert rel_err(logits, want_logits) <= TOL and abs(loss - want_loss) <= TOL * abs(want_loss)
    after = case.model.state_dict()
    for k, v in before.items():
        assert k == "knn_mem" or torch.equal(after[k], v), k
    assert_state_matches(case.model, want_sd)


@pytest.mark.parametrize("n_clips", [2, 1])
def test_byol_forward_and_state_match_vtm(n_clips):
    """The symmetric loss over two clips (the online BatchNorm state chained
    from the first query forward into the second), or one clip against its
    own key; the dummy logits."""
    case = Case("byol", "CONTRASTIVE.PREDICTOR_DEPTHS", "[2]", "CONTRASTIVE.BN_MLP", "True",
                "CONTRASTIVE.NUM_MLP_LAYERS", "3")
    _perturbed_history(case, 12)
    errs = _parity(case, case.clips(n_clips, 4, 4))
    logits = case.port_forward(case.clips(n_clips, 4, 5), INDEX)[0]
    assert logits.shape == (4, 17) and (logits[:, 0] == 9999).all() and not logits[:, 1:].any()
    print(n_clips, {k: f"{v:.2e}" for k, v in sorted(errs.items(), key=lambda kv: -kv[1])[:4]})


def test_simclr_forward_and_state_match_vtm():
    case = Case("simclr")
    _parity(case, case.clips(2, 4, 6))
    assert int(case.model.iter) == 1


@pytest.mark.parametrize("queue, epoch", [("none", 0.5), ("empty", 16.0), ("filled", 16.0), ("filled", 0.5)])
def test_swav_forward_and_state_match_vtm(queue, epoch):
    """Prototypes normalised first (as the step does); Sinkhorn's
    assignment, with the queue's rows once it takes part (epoch >= 15 and a
    non-zero last row or the flag), the queue rolled at epoch >= 15 only."""
    extra = () if queue == "none" else ("CONTRASTIVE.SWAV_QEUE_LEN", "8")
    case = Case("swav", *extra)
    case.protos = {"kernel": np.asarray(jc.normalize_swav_prototypes(case.protos)["kernel"])}
    if queue == "filled":
        q = np.random.default_rng(7).standard_normal(case.state["queue_swav"].shape).astype(np.float32)
        case.state["queue_swav"] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    case.load()
    _parity(case, case.clips(3, 4, 8), epoch_exact=epoch)
    if queue != "none":
        flag, rows = bool(case.model.swav_use_the_queue), case.model.queue_swav
        assert flag == (queue == "filled" and epoch >= 15)
        assert torch.equal(rows, torch.tensor(case.state["queue_swav"])) == (epoch < 15)


@pytest.mark.parametrize("mem_type", ["1d", "2d"])
def test_mem_forward_and_state_match_vtm(mem_type):
    """vtm's negatives put in (its draw with no rng); column 0 is the
    sample's own row; the bank blended and re-normalised at the batch's rows
    only."""
    case = Case("mem", "CONTRASTIVE.MEM_TYPE", mem_type)
    cc = case.jmodel.cc
    neg = np.asarray(jax.random.randint(jax.random.fold_in(jax.random.key(0), 17), (4, cc.queue_len + 1), 0,
                                        cc.length))
    before = case.model.memory.clone()
    _parity(case, case.clips(1, 4, 9), neg_index=torch.tensor(neg, dtype=torch.long))
    changed = (case.model.memory != before).any(dim=1).nonzero().flatten().tolist()
    assert changed == sorted(INDEX.tolist())


def test_types_and_queue_checks_raise():
    with pytest.raises(NotImplementedError, match="self"):
        Case("self")
    case = Case("moco")
    with pytest.raises(ValueError, match="QUEUE_LEN"):
        case.port_forward(case.clips(2, 3, 0), np.array([0, 1, 2]))
    with pytest.raises(ValueError, match="multiple"):
        tc.moco_iters_noupdate(case.model.cc, 5)
    assert tc.moco_iters_noupdate(case.model.cc, 4) == jc.moco_iters_noupdate(case.jmodel.cc, 4) == 4
