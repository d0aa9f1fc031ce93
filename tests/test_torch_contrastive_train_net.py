"""Contrastive pretraining through ``vtm_torch.tools.train_net.train`` on the
CPU at a tiny size (MoCo on a Slow ResNet over the synthetic dataset's two
views a video): MoCo's warm-up iterations, the kNN eval, checkpoints that
carry the whole state, and an auto-resumed run equal to an uninterrupted one
bit for bit; what the loop refuses; and LARS (``SOLVER.LARS_ON``) against
``vtm``'s optax chain over three steps on a small module with a BatchNorm
group, 1-D and zero-norm parameters."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

import vtm.train.optimizer as jopt
import tools.train_net as jax_train_net
from vtm.config import get_cfg as jax_get_cfg

from vtm_torch.checkpoints import checkpoint as cu
from vtm_torch.config import get_cfg
from vtm_torch.models.contrastive import build_contrastive_model
from vtm_torch.tools import train_net
from vtm_torch.train.optimizer import apply_update, construct_optimizer, set_lr

from torch_contrastive_cases import ssl_opts

torch.set_num_threads(2)

RUN = ["TRAIN.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "4", "DATA.TRAIN_CROP_NUM_TEMPORAL", "2",
       "CONTRASTIVE.QUEUE_LEN", "8", "CONTRASTIVE.LENGTH", "16", "CONTRASTIVE.NUM_CLASSES_DOWNSTREAM", "7",
       "SOLVER.OPTIMIZING_METHOD", "sgd", "SOLVER.BASE_LR", "0.01", "SOLVER.MAX_EPOCH", "2",
       "TRAIN.EVAL_PERIOD", "1", "TRAIN.CHECKPOINT_PERIOD", "1", "DATA_LOADER.NUM_WORKERS", "0"]
# of each parameter's largest entry after each step. optax takes Adam's bias
# corrections 1 - 0.999^t in fp32 (1.3e-5 off at t = 1), torch in fp64: an
# Adam step of 0.5 differs by 3.2e-6 between the two, LARS or not
LARS_TOL = 1e-5


def _cfg(tmp, *extra):
    cfg = get_cfg()
    cfg.merge_from_list(ssl_opts("moco", *RUN, "OUTPUT_DIR", str(tmp), *extra))
    return cfg


def _recording(monkeypatch):
    """Record each step's ``update_param`` and loss, and each kNN eval's top-1."""
    seen = {"update": [], "loss": [], "knn": []}
    make, knn = train_net.make_contrastive_train_step, train_net.knn_eval

    def make_recording(model, optimizer):
        step = make(model, optimizer)

        def recorded(*args, update_param=True, **kw):
            seen["update"].append(update_param)
            out = step(*args, update_param=update_param, **kw)
            seen["loss"].append(float(out[0]))
            return out

        return recorded

    def knn_recording(*args):
        seen["knn"].append(knn(*args))
        return seen["knn"][-1]

    monkeypatch.setattr(train_net, "make_contrastive_train_step", make_recording)
    monkeypatch.setattr(train_net, "knn_eval", knn_recording)
    return seen


def test_train_warms_up_evaluates_and_resumes_bit_for_bit(tmp_path, monkeypatch):
    """Two epochs of 4 iterations: the first QUEUE_LEN / batch = 2 of epoch 0
    take no update; a kNN top-1 an epoch in [0, 1]; a checkpoint an epoch
    that holds the parameters and the whole state. A run stopped after
    epoch 0 and auto-resumed equals the uninterrupted one bit for bit
    (losses of epoch 1, every parameter, statistic and state entry)."""
    seen = _recording(monkeypatch)
    whole = train_net.train(_cfg(tmp_path / "whole"), device="cpu")
    assert seen["update"] == [False, False, True, True] + [True] * 4
    assert len(seen["knn"]) == 2 and all(0.0 <= k <= 1.0 for k in seen["knn"])
    assert all(np.isfinite(seen["loss"]))
    assert int(whole.ptr) == 0 and int(whole.iter) == 8  # 8 keys of 4 into a queue of 8
    # the checkpoint of epoch 1 is the module, its state included
    blob = torch.load(cu.get_last_checkpoint(str(tmp_path / "whole")), map_location="cpu", weights_only=True)
    for k, v in whole.state_dict().items():
        assert torch.equal(blob["model_state"][k], v), k
    assert {"queue_x", "ptr", "iter", "knn_mem"} <= set(blob["model_state"]) and any(
        k.startswith("backbone_hist.") and "running_mean" in k for k in blob["model_state"])
    losses = seen["loss"][4:]

    # the same run stopped right after epoch 0's checkpoint, then resumed
    save = cu.save_checkpoint

    def save_then_stop(*args, **kw):
        save(*args, **kw)
        raise _Stopped

    monkeypatch.setattr(cu, "save_checkpoint", save_then_stop)
    with pytest.raises(_Stopped):
        train_net.train(_cfg(tmp_path / "split"), device="cpu")
    monkeypatch.setattr(cu, "save_checkpoint", save)
    path = cu.get_last_checkpoint(str(tmp_path / "split"))
    stopped = torch.load(path, map_location="cpu", weights_only=True)["model_state"]
    same_epoch = torch.load(path.replace(str(tmp_path / "split"), str(tmp_path / "whole")), map_location="cpu",
                            weights_only=True)["model_state"]
    fresh, _ = build_contrastive_model(_cfg(tmp_path / "split"), "cpu")
    assert cu.load_checkpoint(path, fresh)[0] == 0
    for k, v in fresh.state_dict().items():  # the queue, ptr, iter, momentum encoder, bank among them
        assert torch.equal(v, stopped[k]) and torch.equal(v, same_epoch[k]), k
    seen = _recording(monkeypatch)
    resumed = train_net.train(_cfg(tmp_path / "split"), device="cpu")
    assert seen["update"] == [True] * 4 and seen["loss"] == losses
    for (k, v), w in zip(resumed.state_dict().items(), whole.state_dict().values()):
        assert torch.equal(v, w), k


def test_chunked_csv_rotates_in_the_loop(tmp_path, monkeypatch):
    """DATA.LOADER_CHUNK_SIZE (once refused): from the second epoch on, the
    train loader is rebuilt at vtm's next slab (``rotate_chunked_csv``),
    which the synthetic set ignores; the meter keeps its first length."""
    built = []
    construct = train_net.construct_loader

    def recording(cfg, split, *args):
        if split == "train":
            built.append(cfg.DATA.SKIP_ROWS)
        return construct(cfg, split, *args)

    monkeypatch.setattr(train_net, "construct_loader", recording)
    cfg = _cfg(tmp_path, "DATA.LOADER_CHUNK_SIZE", "4", "DATA.LOADER_CHUNK_OVERALL_SIZE", "8",
               "TRAIN.EVAL_PERIOD", "10")
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(["DATA.LOADER_CHUNK_SIZE", "4", "DATA.LOADER_CHUNK_OVERALL_SIZE", "8"])
    monkeypatch.setattr(jax_train_net, "construct_loader", lambda c, split: c.DATA.SKIP_ROWS)
    want = [0] + [jax_train_net.rotate_chunked_csv(jcfg, e) for e in range(1, cfg.SOLVER.MAX_EPOCH)]
    train_net.train(cfg, device="cpu")
    assert built == want and len(built) == cfg.SOLVER.MAX_EPOCH >= 2


class _Stopped(Exception):
    pass


def test_what_the_loop_refuses(tmp_path, monkeypatch):
    """TPU.MODEL_PARALLEL > 1 raises with the reason (contrastive
    pretraining runs in one process); a process group of more than one
    raises (one process, as in vtm); a SlowFast backbone refuses the
    one-pathway views, as vtm's does."""
    with pytest.raises(NotImplementedError, match="contrastive pretraining runs in one process"):
        train_net.train(_cfg(tmp_path, "TPU.MODEL_PARALLEL", "2"), device="cpu")
    with monkeypatch.context() as m:
        m.setattr(torch.distributed, "is_initialized", lambda: True)
        m.setattr(torch.distributed, "get_world_size", lambda *a: 2)
        with pytest.raises(NotImplementedError, match="one process"):
            train_net.train(_cfg(tmp_path), device="cpu")
    cfg = get_cfg()
    cfg.merge_from_list(ssl_opts("moco", *RUN, "OUTPUT_DIR", str(tmp_path / "sf"), arch="slowfast"))
    with pytest.raises(ValueError, match="1 pathways given, 2 expected"):
        train_net.train(cfg, device="cpu")


class _Small(nn.Module):
    """A linear layer, a BatchNorm's affine pair and a matrix at zero."""

    def __init__(self, w, b, s, sb, z):
        super().__init__()
        self.fc = nn.Linear(w.shape[1], w.shape[0])
        self.a_bn = nn.Module()
        self.a_bn.weight, self.a_bn.bias = nn.Parameter(torch.tensor(s)), nn.Parameter(torch.tensor(sb))
        self.zero = nn.Module()
        self.zero.weight = nn.Parameter(torch.tensor(z))
        with torch.no_grad():
            self.fc.weight.copy_(torch.tensor(w))
            self.fc.bias.copy_(torch.tensor(b))


@pytest.mark.parametrize("method", ["sgd", "adamw"])
def test_lars_matches_vtm(method):
    """Three steps, clip then LARS then the optimizer: the matrices
    rescaled by 0.001 |p| / (|g| + |p| wd + 1e-8) with their decay folded
    in, the 1-D and zero-norm ones (and a matrix whose gradient is zero)
    passed through unmodified and undecayed, the BatchNorm group never
    adapted and decayed by BN.WEIGHT_DECAY."""
    opts = ["SOLVER.LARS_ON", "True", "SOLVER.OPTIMIZING_METHOD", method, "SOLVER.BASE_LR", "0.5",
            "SOLVER.WEIGHT_DECAY", "0.01", "BN.WEIGHT_DECAY", "0.001", "SOLVER.MOMENTUM", "0.9",
            "SOLVER.CLIP_GRAD_L2NORM", "5.0", "SOLVER.LR_POLICY", "cosine", "SOLVER.MAX_EPOCH", "4"]
    cfg, jcfg = get_cfg(), jax_get_cfg()
    cfg.merge_from_list(opts)
    jcfg.merge_from_list(opts)
    rng = np.random.default_rng(0)
    f = np.float32
    w, b = rng.standard_normal((4, 5)).astype(f), rng.standard_normal(4).astype(f)
    s, sb, z = (1 + 0.1 * rng.standard_normal(3)).astype(f), (0.1 * rng.standard_normal(3)).astype(f), np.zeros((3, 2), f)
    module = _Small(w, b, s, sb, z)
    params = {"fc": {"kernel": w, "bias": b}, "a_bn": {"scale": s, "bias": sb}, "zero": {"kernel": z}}
    names = {"fc.weight": ("fc", "kernel"), "fc.bias": ("fc", "bias"), "a_bn.weight": ("a_bn", "scale"),
             "a_bn.bias": ("a_bn", "bias"), "zero.weight": ("zero", "kernel")}
    optimizer, lr_at = construct_optimizer(cfg, module)
    assert {g.get("lars", False) for g in optimizer.param_groups} == {True, False}
    tx, jlr_at = jopt.construct_optimizer(jcfg, params)
    opt_state = tx.init(params)
    for i, epoch in enumerate((0.0, 1.0, 2.0)):
        grads = {k: {leaf: (3 * rng.standard_normal(v.shape)).astype(f) for leaf, v in node.items()}
                 for k, node in params.items()}
        if i == 1:
            grads["fc"]["kernel"] = np.zeros_like(w)
        opt_state = jopt.set_lr(opt_state, jlr_at(epoch))
        updates, opt_state = tx.update(jax_tree(grads), opt_state, jax_tree(params))
        params = {k: {leaf: np.asarray(v) for leaf, v in node.items()}
                  for k, node in optax.apply_updates(jax_tree(params), updates).items()}
        set_lr(optimizer, lr_at(epoch))
        for name, p in module.named_parameters():
            node, leaf = names[name]
            p.grad = torch.tensor(grads[node][leaf])
        apply_update(optimizer)
        for name, p in module.named_parameters():
            node, leaf = names[name]
            want = params[node][leaf]
            err = float(np.abs(p.detach().numpy() - want).max()) / max(float(np.abs(want).max()), 1e-30)
            assert err <= LARS_TOL, (method, i, name, err)


def jax_tree(tree):
    return {k: {leaf: jnp.asarray(v) for leaf, v in node.items()} for k, node in tree.items()}
