"""The port's BatchNorm training path against ``vtm``'s on the CPU in fp32:
one SGD step of the BN train step (loss, running statistics, every
parameter, the BatchNorm group's weight decay), every gradient of a
train-mode loss with every BatchNorm live (in fp64 in both packages),
precise BN, a train step on
two gloo ranks with the statistics of the global batch and the dry run's
SlowFast half, each against ``vtm``'s one-device step on the whole batch;
then ``train_net.train`` and ``run_net`` on a tiny SlowFast: precise
statistics and a checkpoint that reloads to the same next loss."""

import datetime
import itertools

import jax  # noqa: F401  (keeps the JAX package's CPU setup first, as the other parity tests do)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import vtm.models.convnet as jax_convnet
import vtm.train.optimizer as jopt
from vtm.checkpoints.convert import convert_pyslowfast
from vtm.models.build import build_model as jax_build_model
from vtm.train.precise_bn import compute_precise_bn_stats as jax_precise_bn
from vtm.train.train_step import make_train_step as jax_make_train_step

from vtm_torch.checkpoints import checkpoint as cu
from vtm_torch.checkpoints.convert import pyslowfast_state_dict_from_vtm
from vtm_torch.models import build_model
from vtm_torch.models.convnet import batchnorms
from vtm_torch.parallel import dryrun
from vtm_torch.parallel.launch import launch_job
from vtm_torch.parallel.probes import train_probe
from vtm_torch.tools import run_net as rn
from vtm_torch.tools import train_net
from vtm_torch.train.optimizer import construct_optimizer, set_lr
from vtm_torch.train.precise_bn import compute_precise_bn_stats
from vtm_torch.train.train_step import make_train_step

from torch_conv_cases import Case, assert_close_to_largest, cfgs, np_tree, stats_tol, tiny_opts

torch.set_num_threads(2)

LOSS_TOL = 1e-5
# a parameter after one step, of its tensor's largest change in the step
STEP_TOL = 1e-5
SGD = ["SOLVER.OPTIMIZING_METHOD", "sgd", "SOLVER.BASE_LR", "0.1", "SOLVER.MOMENTUM", "0.9",
       "SOLVER.WEIGHT_DECAY", "1e-4", "SOLVER.LR_POLICY", "cosine", "SOLVER.MAX_EPOCH", "4",
       "BN.WEIGHT_DECAY", "1e-3", "SOLVER.ZERO_WD_1D_PARAM", "True"]
# zero analytically: a bias added right before a BatchNorm's mean subtraction
BEFORE_BN = ("conv_out.bias",)
# The steps run the shipped configs' init, each block's final BatchNorm at
# zero (RESNET.ZERO_INIT_FINAL_BN), with the running statistics moved, and a
# fast pathway 4 channels wide (BETA_INV 2): there the fp32 gradients of both
# packages are within 3e-6 of the fp64 ones. At the tiny sizes with live
# final BatchNorms, or a fast pathway of 1 channel (BETA_INV 8 at width 8),
# some BatchNorm weights' gradients are 1e-8 of their tensor's scale and
# fp32 rounding (of either package) moves them by more than their size:
# test_gradients_with_live_final_bn_match_vtm_in_fp64 holds those branches'
# gradients to vtm's in fp64.
STEP = ("RESNET.ZERO_INIT_FINAL_BN", "True", "SLOWFAST.BETA_INV", "2")
# fp64, both packages: each gradient within FP64_TOL of its tensor's largest
# entry, or of FP64_FLOOR times the model's largest gradient where its own is
# below that (the analytically zero ones: 1e-19 to 1e-17 there); each
# statistic within FP64_TOL of its largest. Measured at most 1.7e-11 and
# 1.9e-14.
FP64_TOL = 1e-9
FP64_FLOOR = 1e-6
# zero analytically: a bias before a BatchNorm's mean subtraction; under the
# softmax non-local, phi's bias (a constant over the keys) and g's (a
# constant over the positions after the softmax's rows, which sum to 1)
ZERO_GRADIENTS = ("conv_out.bias", "nonlocal0.conv_phi.bias", "nonlocal0.conv_g.bias")
_LAUNCHES = itertools.count()


def _jax_step(jcfg, params, stats, frames, labels):
    """``vtm``'s ``make_train_step(has_batch_stats=True)``, one SGD step at the
    schedule's epoch-0 learning rate: (params, statistics, loss) as numpy."""
    tx, lr_at = jopt.construct_optimizer(jcfg, params)
    opt_state = jopt.set_lr(tx.init(params), lr_at(0.0))
    module = jax_build_model(jcfg, init=False).module
    step = jax_make_train_step(module, tx, "cross_entropy", False, has_batch_stats=True)
    new_params, new_stats, _, loss, _, _ = step(params, stats, opt_state, jnp.asarray(frames), jnp.asarray(labels))
    return np_tree(new_params), np_tree(new_stats), float(loss)


def _assert_step(got_params: dict, got_buffers: dict, got_loss: float, start: dict, want, what: str):
    """Loss within LOSS_TOL; every statistic within ``stats_tol`` of its largest
    entry; every parameter within STEP_TOL of its tensor's largest change,
    plus two fp32 spacings of its largest value (BEFORE_BN's, zero-gradient, move by their weight decay alone; one that
    does not move in ``vtm`` stays as it was)."""
    params, stats, loss = want
    assert abs(got_loss - loss) <= LOSS_TOL, (what, got_loss, loss)
    want_sd = {k: v.numpy() for k, v in pyslowfast_state_dict_from_vtm(params, stats).items()}
    assert set(got_params) | set(got_buffers) == set(want_sd)
    for k, v in got_buffers.items():
        assert_close_to_largest(v, want_sd[k], stats_tol(k), f"{what} {k}")
    for k, v in got_params.items():
        change = np.abs(want_sd[k] - start[k]).max()  # 0 inside a branch whose final BN is 0
        # and the fp32 spacing of the tensor's values: the update lands on it
        tol = (1e-3 if k.endswith(BEFORE_BN) else STEP_TOL) * change + 2 * np.spacing(np.abs(want_sd[k]).max())
        assert np.abs(v - want_sd[k]).max() <= tol, (what, k, float(np.abs(v - want_sd[k]).max()), float(change))


@pytest.mark.parametrize("name", ["slowfast", "x3d"])
def test_bn_train_step_matches_vtm(name):
    """One SGD step (momentum 0.9, weight decay 1e-4, ``BN.WEIGHT_DECAY``
    1e-3 on every BatchNorm parameter ahead of ZERO_WD_1D_PARAM) of the
    port's step against ``vtm``'s ``make_train_step(has_batch_stats=True)``."""
    case = Case(name, *SGD, *STEP, move_weights=False)
    frames = case.video(4, seed=3)
    labels = np.array([1, 5, 0, 6])
    module = build_model(case.cfg, "cpu", fp32_params=True).module
    module.load_state_dict({k: torch.from_numpy(v) for k, v in case.state.items()})
    optimizer, lr_at = construct_optimizer(case.cfg, module, num_layers=module.config.depth)
    bn_params = {id(p) for bn in batchnorms(module) for p in bn.parameters()}
    for group in optimizer.param_groups:
        kinds = {id(p) in bn_params for p in group["params"]}
        assert len(kinds) == 1 and (group["weight_decay"] == 1e-3) == kinds.pop()
    set_lr(optimizer, lr_at(0.0))
    step = make_train_step(module, optimizer, "cross_entropy", False)
    loss, logits, _ = step(torch.from_numpy(frames), torch.from_numpy(labels))
    assert module.training and logits.shape == (4, 7)
    _assert_step({k: p.detach().numpy() for k, p in module.named_parameters()},
                 {k: b.numpy() for k, b in module.named_buffers()}, float(loss), case.state,
                 _jax_step(case.jcfg, case.params, case.stats, frames, labels), name)


class _NumpyFloat32As64:
    """``jax.numpy`` with ``float32`` read as ``float64``. ``vtm``'s conv
    modules pin their BatchNorm arithmetic and their heads to
    ``jnp.float32``; with this as their module's ``jnp`` and x64 on, the
    whole reference runs in fp64, and nothing else in it changes."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.mark.parametrize("name", ["slowfast", "i3d", "slow", "x3d"])
def test_gradients_with_live_final_bn_match_vtm_in_fp64(name, monkeypatch):
    """Every BatchNorm weight about 1 (each block's final one included), so
    that every residual branch carries a gradient: the loss, the logits,
    every parameter's gradient (``jax.grad`` of ``vtm``'s train-mode
    forward) and the running statistics after the forward, in fp64 in both
    packages, within FP64_TOL. Only ZERO_GRADIENTS may be below FP64_FLOOR of
    the model's largest gradient."""
    case = Case(name)
    frames = case.video(4, seed=3).astype(np.float64)
    labels = np.array([1, 5, 0, 6])
    monkeypatch.setattr(jax_convnet, "jnp", _NumpyFloat32As64())
    with jax.enable_x64(True):
        params, stats = convert_pyslowfast({k: v.astype(np.float64) for k, v in case.state.items()})
        module = case.jbundle.module
        x, y = jnp.asarray(frames), jnp.asarray(labels)

        def loss_fn(p):
            (logits, _), mutated = module.apply({"params": p, "batch_stats": stats}, x, train=True,
                                                mutable=["batch_stats"])
            loss = -jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None], axis=1).mean()
            return loss, (logits, mutated["batch_stats"])

        (loss, (logits, new_stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        assert {str(a.dtype) for a in jax.tree_util.tree_leaves((logits, grads, new_stats))} == {"float64"}
        want_loss, want_logits = float(loss), np.asarray(logits)
        want = {k: v.numpy() for k, v in pyslowfast_state_dict_from_vtm(np_tree(grads), np_tree(new_stats)).items()}
    port = case.bundle.module.double().train()
    got_logits, _ = port(torch.from_numpy(frames))
    got_loss = F.cross_entropy(got_logits, torch.from_numpy(labels))
    got_loss.backward()
    assert abs(float(got_loss.detach()) - want_loss) <= FP64_TOL * abs(want_loss)
    assert_close_to_largest(got_logits.detach().numpy(), want_logits, FP64_TOL, "logits")
    grads_got = {k: p.grad.numpy() for k, p in port.named_parameters()}
    assert set(grads_got) | {k for k, _ in port.named_buffers()} == set(want)
    largest = max(float(np.abs(want[k]).max()) for k in grads_got)
    dead = sorted(k for k in grads_got if np.abs(want[k]).max() < FP64_FLOOR * largest)
    assert all(k.endswith(ZERO_GRADIENTS) for k in dead), dead
    for k, g in grads_got.items():
        scale = max(float(np.abs(want[k]).max()), FP64_FLOOR * largest)
        err = float(np.abs(g - want[k]).max())
        assert err <= FP64_TOL * scale, (k, err, scale)
    for k, b in port.named_buffers():
        assert_close_to_largest(b.numpy(), want[k], FP64_TOL, k)


def test_precise_bn_matches_vtm():
    """``compute_precise_bn_stats`` over min(NUM_BATCHES_PRECISE, 3) = 2 of 3
    batches: every statistic the average of the two batches' (momentum 1),
    as ``vtm``'s, within ``stats_tol``; the momentum and the mode come back."""
    case = Case("x3d")
    loader = [{"frames": case.video(2, seed=s)} for s in (4, 5, 6)]
    want = jax_precise_bn(case.jbundle.module, case.params, case.stats, loader, 2)
    module = case.bundle.module
    compute_precise_bn_stats(module, loader, 2, torch.device("cpu"))
    assert not module.training and all(bn.momentum == 0.1 for bn in batchnorms(module))
    want_sd = {k: v.numpy() for k, v in pyslowfast_state_dict_from_vtm({}, np_tree(want)).items()}
    for k, v in module.named_buffers():
        assert_close_to_largest(v.numpy(), want_sd[k], stats_tol(k), k)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in case.state.items()})


def _launch(cfg, fn, tmp_path, ranks, *args):
    return launch_job(cfg, fn, ["cpu"] * ranks, backend="gloo", args=args,
                      init_method=f"file://{tmp_path}/rendezvous_{next(_LAUNCHES)}",
                      timeout=datetime.timedelta(seconds=120), join_timeout=300.0, num_threads=1)


def _from_port_init(sd):
    """``vtm``'s trees of the port's state dict (the seeded init both ranks build)."""
    return convert_pyslowfast({k: v.numpy() for k, v in sd.items()})


@pytest.mark.parametrize("norm_type", ["batchnorm", "sync_batchnorm"])
def test_two_rank_step_matches_vtms_global_step(norm_type, tmp_path):
    """``train_net``'s trainer on two gloo ranks, 2 clips each, DDP over the
    data group and every BatchNorm's statistics over the global batch of 4
    (for every ``BN.NORM_TYPE``, as in ``vtm``), against ``vtm``'s step on the
    whole batch: the loss, the statistics and the parameters, the same on
    both ranks."""
    case = Case("slowfast", *SGD, *STEP, "BN.NORM_TYPE", norm_type, "TRAIN.BATCH_SIZE", "4", "RNG_SEED", "3")
    frames = case.video(4, seed=7)
    labels = np.array([2, 0, 6, 3])
    start_sd = build_model(case.cfg, "cpu", fp32_params=True).module.state_dict()
    params, stats = _from_port_init(start_sd)
    want = _jax_step(case.jcfg, params, stats, frames, labels)
    out = _launch(case.cfg, train_probe, tmp_path, 2, None, frames, labels)
    start = {k: v.numpy() for k, v in start_sd.items()}
    for r in out:
        assert r["mesh"] == {"data": 2, "model": 1}
        _assert_step(r["state"], r["buffers"], r["loss"], start, want, f"rank {r['rank']}")
    for k in out[0]["buffers"]:
        np.testing.assert_array_equal(out[0]["buffers"][k], out[1]["buffers"][k])


def test_dryrun_slowfast_half_matches_vtm():
    """The dry run's SlowFast half (``__graft_entry__.py``'s config) on two
    gloo ranks: the loss and the statistics of ``vtm``'s step on the whole
    batch, the parameters moved, both ranks equal. (Its parameters are not
    held to ``vtm``'s: at a fast pathway of 1 channel some gradients are
    rounding in both packages, see STEP.)"""
    out = dryrun.dryrun_multichip(2, devices=["cpu"] * 2, backend="gloo", join_timeout=300, num_threads=1)
    cfg = dryrun.slowfast_cfg(2)
    _, jcfg = cfgs(dryrun.SLOWFAST_OPTS + ["SOLVER.OPTIMIZING_METHOD", "sgd"])
    start_sd = build_model(cfg, "cpu", fp32_params=True).module.state_dict()
    params, stats = _from_port_init(start_sd)
    _, want_stats, want_loss = _jax_step(jcfg, params, stats, *dryrun.slowfast_batch(2))
    want_sd = {k: v.numpy() for k, v in pyslowfast_state_dict_from_vtm({}, want_stats).items()}
    for r in out:
        sf = r["slowfast"]
        assert abs(sf["loss"] - want_loss) <= LOSS_TOL
        for k, v in sf["buffers"].items():
            assert_close_to_largest(v, want_sd[k], stats_tol(k), k)
        assert any(not np.array_equal(v, start_sd[k].numpy()) for k, v in sf["state"].items()), "nothing moved"
        for k, v in sf["state"].items():
            np.testing.assert_array_equal(v, out[0]["slowfast"]["state"][k])


def _train_opts(tmp_path, *opts):
    return tiny_opts("SlowFast", "slowfast", "MODEL.DROPOUT_RATE", "0.5", *SGD,
                     "TRAIN.DATASET", "synthetic", "TEST.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "4",
                     "TEST.BATCH_SIZE", "4", "SOLVER.MAX_EPOCH", "1", "TRAIN.EVAL_PERIOD", "1",
                     "TRAIN.CHECKPOINT_PERIOD", "1", "BN.USE_PRECISE_STATS", "True", "BN.NUM_BATCHES_PRECISE", "2",
                     "TEST.NUM_ENSEMBLE_VIEWS", "1", "TEST.NUM_SPATIAL_CROPS", "1", "DATA_LOADER.NUM_WORKERS", "0",
                     "TRAIN.AUTO_RESUME", "False", "OUTPUT_DIR", str(tmp_path), *opts)


def test_train_net_precise_bn_and_checkpoint_reload(tmp_path, monkeypatch):
    """``train(cfg)`` on a tiny SlowFast with dropout 0.5, one epoch of
    synthetic clips: precise statistics (``refresh_bn_stats``, called with
    the epoch's loader) before the checkpoint, which holds them; the module
    reloaded from it takes the same next step (loss and statistics bit for
    bit) as the trained one; ``run_net`` trains and then tests the
    checkpoint."""
    cfg, _ = cfgs(_train_opts(tmp_path))
    calls = []
    refresh = train_net.refresh_bn_stats

    def recording(cfg_, module, loader, device, epoch, mesh=train_net.Mesh(), due=True):
        calls.append((epoch, due, len(loader)))
        refresh(cfg_, module, loader, device, epoch, mesh, due)
        calls.append({k: v.clone() for k, v in module.named_buffers()})

    monkeypatch.setattr(train_net, "refresh_bn_stats", recording)
    module = train_net.train(cfg, device="cpu")
    assert calls[0][:2] == (0, True)
    path = cu.get_last_checkpoint(str(tmp_path))
    saved = torch.load(path, map_location="cpu", weights_only=True)["model_state"]
    for k, v in calls[1].items():
        assert torch.equal(saved[k], v), k

    batch = np.random.default_rng(8).standard_normal((4, 8, 32, 32, 3)).astype(np.float32)
    labels = torch.tensor([0, 1, 2, 3])
    optimizer_state = torch.load(path, map_location="cpu", weights_only=True)["optimizer_state"]
    losses, stats = [], []
    for reloaded in (False, True):
        trainer = train_net.build_trainer(cfg, "cpu")
        if reloaded:
            cu.load_checkpoint(path, trainer.module, trainer.optimizer)
        else:  # the trained module as it is in memory
            trainer.module.load_state_dict(module.state_dict())
            trainer.optimizer.load_state_dict(optimizer_state)
        set_lr(trainer.optimizer, trainer.lr_at(1.0))
        loss, _, _ = trainer.train_step(torch.from_numpy(batch), labels, torch.Generator().manual_seed(0))
        losses.append(float(loss))
        stats.append({k: v.clone() for k, v in trainer.module.named_buffers()})
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    assert all(torch.equal(stats[0][k], stats[1][k]) for k in stats[0])

    out = tmp_path / "run_net"
    cfg, _ = cfgs(_train_opts(out, "TRAIN.ENABLE", "True", "TEST.ENABLE", "True"))
    results = rn.run_net(cfg, device="cpu")
    assert results and results[0][0] == 1 and np.isfinite(float(results[0][1]["top1_acc"]))
