"""The contrastive train step in the port against ``vtm``'s on the CPU:
three steps of ``make_contrastive_train_step`` (MoCo with SGD, BYOL with
SGD and LARS, SwAV across its first-epoch gate) from the same weights and
state: the losses, every parameter, BatchNorm statistic and state entry
after them; every gradient through the conv backbone; both in fp64 within
``FP64_TOL`` of each tensor's largest entry; MoCo's warm-up step
(``tests/torch_contrastive_cases.py``)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vtm.models.convnet as jax_convnet
import vtm.train.optimizer as jopt
from vtm.models.contrastive import normalize_swav_prototypes
from vtm.train.train_step import make_contrastive_train_step as jax_make_contrastive_train_step

from vtm_torch.checkpoints.convert import contrastive_state_dict_from_vtm, pyslowfast_state_dict_from_vtm
from vtm_torch.models.contrastive import l2_normalize
from vtm_torch.train.optimizer import construct_optimizer, set_lr
from vtm_torch.train.train_step import make_contrastive_train_step

from torch_contrastive_cases import Case, assert_state_matches, rel_err, vtm_bn_over_all_but_channels

torch.set_num_threads(2)

INDEX = np.array([0, 3, 5, 7])
SGD = ("SOLVER.OPTIMIZING_METHOD", "sgd", "SOLVER.BASE_LR", "0.05", "SOLVER.MOMENTUM", "0.9",
       "SOLVER.WEIGHT_DECAY", "1e-3", "BN.WEIGHT_DECAY", "1e-4", "SOLVER.LR_POLICY", "cosine",
       "SOLVER.MAX_EPOCH", "4")
# fp64, both packages: each gradient within FP64_TOL of its tensor's largest
# entry, or of FP64_FLOOR times the largest gradient where its own is below
# that (none is zero analytically here)
FP64_TOL = 1e-9
FP64_FLOOR = 1e-6
# zero analytically: BYOL's loss reads the predictions alone, and the
# projection's last bias reaches them only through the predictor's first
# BatchNorm, which takes the batch's mean away (a bias starting at 0 stays
# within ZERO_MOVES of it in both packages, and so does its momentum copy)
ZERO_GRADIENTS = {"byol": ("backbone.head.projection.fc1.bias", "backbone_hist.head.projection.fc1.bias")}
ZERO_MOVES = 1e-12


class _NumpyFloat32As64:
    """``jax.numpy`` with ``float32`` read as ``float64`` (``vtm``'s conv
    modules pin their BatchNorms and heads to ``jnp.float32``)."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) if np.issubdtype(np.asarray(a).dtype, np.floating) else np.asarray(a),
        tree)


def _three_steps_in_fp64(case: Case, epochs, monkeypatch, seeds=(1, 2, 3)):
    """The same three steps in both packages in fp64 (``vtm`` under x64 with
    its conv modules' fp32 read as fp64, the port's model ``double()``), the
    learning rate of each epoch as ``vtm`` holds it (fp32) in both; returns
    (losses, vtm's losses, vtm's final state as the port's state dict)."""
    cc = case.jmodel.cc
    n_clips = 3 if cc.type == "moco" else 2
    clips = [[[p.astype(np.float64) for p in c] for c in case.clips(n_clips, 4, seed)] for seed in seeds]
    monkeypatch.setattr(jax_convnet, "jnp", _NumpyFloat32As64())
    monkeypatch.setattr(jopt, "jnp", _NumpyFloat32As64())  # LARS's norms
    want, lrs = [], []
    with jax.enable_x64(True), vtm_bn_over_all_but_channels():
        case.params, case.stats, case.state, case.protos = _f64((case.params, case.stats, case.state, case.protos))
        all_params = {"backbone": case.params}
        if case.protos is not None:
            all_params["swav_prototypes"] = case.protos
        tx, lr_at = jopt.construct_optimizer(case.jcfg, all_params)
        opt_state = tx.init(all_params)
        jstep = jax_make_contrastive_train_step(case.jmodel, tx)
        bn, state = case.stats, case.state
        for clip, epoch in zip(clips, epochs):
            opt_state = jopt.set_lr(opt_state, lr_at(epoch))
            lrs.append(float(opt_state.hyperparams["learning_rate"]))
            all_params, bn, state, opt_state, loss, _ = jstep(
                all_params, bn, state, opt_state, [[jnp.asarray(p) for p in c] for c in clip], jnp.asarray(INDEX),
                epoch, None)
            want.append(float(loss))
        all_params, bn, state = _f64((all_params, bn, state))
    model = case.model.double()
    case.load()
    optimizer, _ = construct_optimizer(case.cfg, model)
    step = make_contrastive_train_step(model, optimizer)
    got = []
    for clip, epoch, lr in zip(clips, epochs, lrs):
        set_lr(optimizer, lr)
        got.append(float(step([[torch.from_numpy(p) for p in c] for c in clip], torch.from_numpy(INDEX), epoch)[0]))
    return got, want, contrastive_state_dict_from_vtm(all_params["backbone"], bn, state,
                                                       all_params.get("swav_prototypes"))


@pytest.mark.parametrize("ctype, extra, epochs", [
    ("moco", (), (0.0, 0.25, 0.5)),
    ("byol", ("CONTRASTIVE.PREDICTOR_DEPTHS", "[2]", "CONTRASTIVE.BN_MLP", "True", "SOLVER.LARS_ON", "True",
              "CONTRASTIVE.MOMENTUM_ANNEALING", "True"), (0.0, 0.25, 0.5)),
    ("swav", ("CONTRASTIVE.SWAV_QEUE_LEN", "8"), (0.5, 1.0, 1.5)),
])
def test_three_steps_match_vtm(ctype, extra, epochs, monkeypatch):
    """MoCo (SGD), BYOL (SGD under LARS, the MLP's BatchNorms, the momentum
    annealed) and SwAV across its gate (the prototypes' gradient zero while
    epoch_exact <= 1): the losses, every parameter, BatchNorm statistic and
    state entry after three steps, in fp64 (a parameter after a step is a
    gradient's work, and at these sizes some of the conv stack's gradients
    are fp32 rounding in both packages; ROADMAP.md Queue 3), within
    FP64_TOL of each tensor's largest entry."""
    case = Case(ctype, *SGD, *extra)
    got, want, sd = _three_steps_in_fp64(case, epochs, monkeypatch)
    for g, w in zip(got, want):
        assert abs(g - w) <= FP64_TOL * abs(w), (got, want)
    zero = ZERO_GRADIENTS.get(ctype, ())
    for k in zero:
        assert max(float(case.model.state_dict()[k].abs().max()), float(sd[k].abs().max())) <= ZERO_MOVES, k
    errs = assert_state_matches(case.model, sd, tol=FP64_TOL, names=[k for k in sd if k not in zero])
    assert int(case.model.iter) == 3
    if ctype == "swav":
        assert not case.model.queue_swav.any() and not bool(case.model.swav_use_the_queue)
    print(ctype, got, {k: f"{v:.2e}" for k, v in sorted(errs.items(), key=lambda kv: -kv[1])[:3]})


def test_swav_prototypes_stay_normalised_through_the_gate():
    """Without weight decay a step at epoch 0.5 leaves the prototypes their
    normalised selves bit for bit (their gradient zeroed, no momentum yet);
    a step at 1.5 moves them."""
    case = Case("swav", *SGD, "SOLVER.WEIGHT_DECAY", "0.0")
    protos0 = l2_normalize(torch.from_numpy(case.protos["kernel"].T.copy()), dim=1)
    optimizer, _ = construct_optimizer(case.cfg, case.model)
    step = make_contrastive_train_step(case.model, optimizer)
    step([[torch.from_numpy(p) for p in c] for c in case.clips(2, 4, 5)], torch.from_numpy(INDEX), 0.5)
    assert torch.equal(case.model.swav_prototypes.weight, protos0)
    step([[torch.from_numpy(p) for p in c] for c in case.clips(2, 4, 6)], torch.from_numpy(INDEX), 1.5)
    assert not torch.allclose(case.model.swav_prototypes.weight, protos0)


def test_warmup_step_leaves_parameters():
    """``update_param=False`` (MoCo's queue warm-up): every parameter and
    the optimizer's state bit for bit, the gradients cleared, while the
    queue, ptr, iter, the momentum encoder and the bank advance."""
    case = Case("moco", *SGD)
    optimizer, _ = construct_optimizer(case.cfg, case.model)
    step = make_contrastive_train_step(case.model, optimizer)
    before = {k: v.clone() for k, v in case.model.state_dict().items()}
    step([[torch.from_numpy(p) for p in c] for c in case.clips(3, 4, 7)], torch.from_numpy(INDEX), 0.0,
         update_param=False)
    after = case.model.state_dict()
    for name, p in case.model.named_parameters():
        assert torch.equal(p, before[name]) and p.grad is None, name
    assert not optimizer.state
    assert int(after["ptr"]) == 4 and int(after["iter"]) == 1
    assert not torch.equal(after["queue_x"], before["queue_x"]) and not torch.equal(after["knn_mem"], before["knn_mem"])


@pytest.mark.parametrize("ctype, extra", [
    ("moco", ()),
    ("byol", ("CONTRASTIVE.PREDICTOR_DEPTHS", "[2]")),
    ("swav", ()),
])
def test_gradients_match_vtm_in_fp64(ctype, extra, monkeypatch):
    """Every block's final BatchNorm live: the loss and every parameter's
    gradient (the backbone's, the prototypes') through the branch, fp64 in
    both packages, within FP64_TOL."""
    case = Case(ctype, "RESNET.ZERO_INIT_FINAL_BN", "False", *extra)
    clips = [[p.astype(np.float64) for p in c] for c in case.clips(3 if ctype == "moco" else 2, 4, 8)]
    monkeypatch.setattr(jax_convnet, "jnp", _NumpyFloat32As64())
    with jax.enable_x64(True):
        params, stats, state, protos = _f64((case.params, case.stats, case.state, case.protos))
        if protos is not None:
            protos = jax.tree_util.tree_map(np.asarray, normalize_swav_prototypes(protos))

        def loss_fn(p, proto):
            return case.jmodel.forward_train(p, stats, state, [[jnp.asarray(x) for x in c] for c in clips],
                                             jnp.asarray(INDEX), proto_params=proto)[1]

        loss, (grads, proto_grads) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(params, protos)
        want = {f"backbone.{k}": v.numpy() for k, v in
                pyslowfast_state_dict_from_vtm(jax.tree_util.tree_map(np.asarray, grads)).items()}
        if protos is not None:
            want["swav_prototypes.weight"] = np.asarray(proto_grads["kernel"]).T
            case.protos = protos
        want_loss = float(loss)
    case.state, case.params, case.stats = state, params, stats
    model = case.model.double()
    case.load()  # into the fp64 model: the normalised prototypes keep their fp64 digits
    _, loss = model([[torch.from_numpy(x) for x in c] for c in clips], torch.from_numpy(INDEX))
    loss.backward()
    assert abs(float(loss.detach()) - want_loss) <= FP64_TOL * abs(want_loss)
    got = {k: p.grad.numpy() for k, p in model.named_parameters() if p.requires_grad}
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
    largest = max(float(np.abs(w).max()) for w in want.values())
    for k, g in got.items():
        scale = max(float(np.abs(want[k]).max()), FP64_FLOOR * largest)
        assert float(np.abs(g - want[k]).max()) <= FP64_TOL * scale, (k, float(np.abs(g - want[k]).max()), scale)
    print(ctype, want_loss, max(rel_err(got[k], want[k]) for k in got))
