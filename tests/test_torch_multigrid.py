"""Multigrid in the port (``vtm_torch/train/multigrid.py``, the short
cycle of ``data/loader.py``, the long cycle of ``tools/train_net.py``)
against ``vtm``'s on the CPU: the long-cycle schedule and every epoch's
update, equal exactly; the short cycle's batch sizes and batches, equal
exactly; the re-shape of a tiny R(2+1)D's statistics at each flip against
``vtm``'s ``adapt_batch_stats``, with parameters and optimizer state the same
bits; and ``train`` under the long cycle on a tiny R(2+1)D against
``tools/train_net.py::train`` from the
same weights: every batch's shape, learning rate and loss. The short
cycle's ``train`` is in ``test_torch_multigrid_short.py``. About 45 s."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.train_net as jax_train_net
import vtm.data.loader as jax_loader
import vtm.eval.meters as jax_meters
import vtm.train.multigrid as jax_multigrid
from vtm.checkpoints.convert import convert_pyslowfast
from vtm.models.build import build_model as jax_build_model

import vtm_torch.data.loader as loader
import vtm_torch.eval.meters as meters
from vtm_torch.checkpoints.convert import ptv_state_dict_from_vtm_params
from vtm_torch.data import construct_loader
from vtm_torch.models import build_model
from vtm_torch.models.convnet import batchnorms
from vtm_torch.tools import train_net
from vtm_torch.train import multigrid

from torch_conv_cases import cfgs, moved_state, ptv_opts

torch.set_num_threads(2)

# the losses of the two runs, relative: the same weights, batches and
# learning rates, each package's fp32 convolutions and BatchNorms (with the
# shipped init, each block's final BatchNorm at 0)
LOSS_TOL = 1e-5


def _mg_opts(*extra) -> list:
    """``tests/test_multigrid.py``'s schedule config (SlowFast 32x2 at 224,
    B16, steps [0, 94, 154, 196] of 239 epochs)."""
    return ["TRAIN.BATCH_SIZE", "16", "DATA.NUM_FRAMES", "32", "DATA.SAMPLING_RATE", "2",
            "DATA.TRAIN_CROP_SIZE", "224", "SOLVER.STEPS", "[0, 94, 154, 196]", "SOLVER.LRS", "[1, 0.1, 0.01, 0.001]",
            "SOLVER.GAMMA", "0.1", "SOLVER.MAX_EPOCH", "239", "NUM_GPUS", "1", *extra]


UPDATED = (("DATA", "NUM_FRAMES"), ("DATA", "TRAIN_CROP_SIZE"), ("TRAIN", "BATCH_SIZE"), ("BN", "NORM_TYPE"),
           ("BN", "NUM_SPLITS"), ("BN", "NUM_SYNC_DEVICES"), ("MULTIGRID", "LONG_CYCLE_SAMPLING_RATE"))


def _updated(cfg) -> tuple:
    return tuple(getattr(getattr(cfg, a), b) for a, b in UPDATED)


@pytest.mark.parametrize("short", [False, True])
def test_long_cycle_schedule_matches_vtm(short):
    """``init_multigrid`` (the schedule, ``SOLVER.STEPS`` / ``LRS`` /
    ``MAX_EPOCH``) and ``update_long_cycle`` at every epoch, with and without
    the short cycle, equal to ``vtm``'s; at ``BN_BASE_SIZE`` 32 the BN
    settings run through ``sync_batchnorm``, ``batchnorm`` and
    ``sub_batchnorm``."""
    cfg, jcfg = cfgs(_mg_opts("MULTIGRID.LONG_CYCLE", "True", "MULTIGRID.SHORT_CYCLE", str(short),
                              "MULTIGRID.BN_BASE_SIZE", "32"))
    ours, theirs = multigrid.MultigridSchedule(), jax_multigrid.MultigridSchedule()
    cfg, jcfg = ours.init_multigrid(cfg), theirs.init_multigrid(jcfg)
    assert ours.schedule == theirs.schedule and len(ours.schedule) == 13
    for a, b in (("SOLVER", "STEPS"), ("SOLVER", "LRS"), ("SOLVER", "MAX_EPOCH"), ("MULTIGRID", "DEFAULT_B"),
                 ("MULTIGRID", "DEFAULT_T"), ("MULTIGRID", "DEFAULT_S")):
        assert getattr(getattr(cfg, a), b) == getattr(getattr(jcfg, a), b), (a, b)
    norms = set()
    for epoch in range(cfg.SOLVER.MAX_EPOCH):
        cfg, changed = ours.update_long_cycle(cfg, epoch)
        jcfg, jchanged = theirs.update_long_cycle(jcfg, epoch)
        assert changed == jchanged and _updated(cfg) == _updated(jcfg), epoch
        norms.add(cfg.BN.NORM_TYPE)
    assert norms == {"sync_batchnorm", "batchnorm", "sub_batchnorm"}
    assert multigrid.get_current_long_cycle_shape(ours.schedule, 10**6) == ours.schedule[-1][1]


def test_short_cycle_only_schedule_matches_vtm():
    cfg, jcfg = cfgs(_mg_opts("MULTIGRID.SHORT_CYCLE", "True"))
    cfg = multigrid.MultigridSchedule().init_multigrid(cfg)
    jcfg = jax_multigrid.MultigridSchedule().init_multigrid(jcfg)
    assert (cfg.SOLVER.STEPS, cfg.SOLVER.MAX_EPOCH) == (jcfg.SOLVER.STEPS, jcfg.SOLVER.MAX_EPOCH) == (
        [0, 141, 231, 294], 358)


def _short_opts(*extra):
    return ["TRAIN.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "2", "DATA.NUM_FRAMES", "2",
            "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32", "MODEL.NUM_CLASSES", "5",
            "MULTIGRID.SHORT_CYCLE", "True", "MULTIGRID.DEFAULT_S", "32", "DATA_LOADER.NUM_WORKERS", "1", *extra]


@pytest.mark.parametrize("epoch", [0, 1])
def test_short_cycle_batches_match_vtm(epoch):
    """``construct_loader(cfg, "train")`` under the short cycle: batch sizes
    (8, 4, 2) and crops (16, 23, 32) of the three phases, then the
    remainder; every batch equal to ``vtm``'s bit for bit; ``len`` the
    count of batches; ``drop_last`` walks the same phases."""
    cfg, jcfg = cfgs(_short_opts())
    assert multigrid.short_cycle_batch_sizes(2, cfg) == jax_multigrid.short_cycle_batch_sizes(2, jcfg) == [8, 4, 2]
    ours, theirs = construct_loader(cfg, "train"), jax_loader.construct_loader(jcfg, "train")
    ours.set_epoch(epoch)
    theirs.set_epoch(epoch)
    got, want = list(ours), list(theirs)
    assert [b["frames"].shape[0] for b in got][:3] == [8, 4, 2]
    assert [b["frames"].shape[2] for b in got][:3] == [16, 23, 32]
    assert len(ours) == len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    short = loader.BatchLoader(ours.dataset, batch_size=4, drop_last=True, num_workers=1,
                               short_cycle_batch_sizes=[8, 4, 2])
    assert len(short) == sum(1 for _ in short) == len(jax_loader.BatchLoader(
        theirs.dataset, batch_size=4, drop_last=True, num_workers=1, short_cycle_batch_sizes=[8, 4, 2]))


class _StatInit:
    """``module`` whose ``init`` gives ``vtm``'s BatchNorm statistics at their
    initialisers (``vtm/models/convnet.py``'s ``BatchNorm``: ``mean`` and
    ``split_mean`` 0, ``var`` and ``split_var`` 1) on ``jax.eval_shape``'s
    tree, without ``vtm``'s eager parameter init (half a minute a model);
    ``vtm``'s ``adapt_batch_stats`` runs on it as it is."""

    def __init__(self, module):
        self.module = module

    def init(self, key, sample):
        shapes = jax.eval_shape(self.module.init, key, sample)["batch_stats"]

        def fill(path, s):
            ones = jax.tree_util.keystr(path[-1:]).endswith("var']")
            return (jnp.ones if ones else jnp.zeros)(s.shape, s.dtype)

        return {"batch_stats": jax.tree_util.tree_map_with_path(fill, shapes)}


def _splits(k: int) -> tuple:
    return ("BN.NORM_TYPE", "sub_batchnorm", "BN.NUM_SPLITS", str(k)) if k > 1 else ("BN.NORM_TYPE", "batchnorm")


def test_flip_reshapes_statistics_as_vtm_does():
    """A tiny R(2+1)D trained a step (SGD, momentum) with plain BN, then
    flipped to 2 splits, to 4, back to 1, and to 4 again, each time at a
    new T and crop (``adapt_batch_stats`` against a model built from the new
    cfg): every statistic equal to ``vtm``'s ``adapt_batch_stats`` on the
    same tree bit for bit (eval statistics carried, new splits at their
    init), the head's pool the new cfg's, every parameter the same tensor
    with the same bits, the optimizer's momentum buffers the same bits, and
    the next step runs with the new splits."""
    cfg, jcfg = cfgs(ptv_opts("r2plus1d", "RESNET.ZERO_INIT_FINAL_BN", "True", "DATA.TRAIN_CROP_SIZE", "64"))
    module = build_model(cfg, "cpu", fp32_params=True).module
    module.load_state_dict({k: torch.from_numpy(v) for k, v in moved_state(module, 0).items()})
    optimizer = torch.optim.SGD(module.parameters(), lr=0.1, momentum=0.9)
    module.train()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 8, 64, 64, 3)).astype(np.float32))
    torch.nn.functional.cross_entropy(module(x)[0], torch.tensor([0, 1, 2, 3])).backward()
    optimizer.step()
    stats = convert_pyslowfast({k: v.numpy() for k, v in module.state_dict().items()})[1]
    for k, t, crop in ((2, 4, 48), (4, 8, 32), (1, 4, 64), (4, 8, 48)):
        opts = ("DATA.NUM_FRAMES", str(t), "DATA.TRAIN_CROP_SIZE", str(crop), *_splits(k))
        new_cfg, new_jcfg = cfgs(ptv_opts("r2plus1d", "RESNET.ZERO_INIT_FINAL_BN", "True", *opts))
        params = dict(module.named_parameters())
        bits = {n: p.detach().clone() for n, p in params.items()}
        momenta = {n: optimizer.state[p]["momentum_buffer"].clone() for n, p in params.items()}
        multigrid.adapt_batch_stats(module, build_model(new_cfg, "cpu", fp32_params=True).module)
        jmod = jax_build_model(new_jcfg, init=False).module
        stats = jax_multigrid.adapt_batch_stats(_StatInit(jmod), stats, jnp.zeros((2, t, crop, crop, 3)))
        want = ptv_state_dict_from_vtm_params({}, stats)
        got = dict(module.named_buffers())
        assert set(got) == set(want)
        for n, v in want.items():
            np.testing.assert_array_equal(got[n].numpy(), v.numpy(), err_msg=f"splits {k}: {n}")
        assert {bn.num_splits for bn in batchnorms(module)} == {k}
        assert module.head.pool_size == ((t // 4, crop // 32, crop // 32),) and module.spec.crop_size == crop
        for n, p in module.named_parameters():
            assert p is params[n] and torch.equal(p, bits[n]), n
            assert torch.equal(optimizer.state[p]["momentum_buffer"], momenta[n]), n
        y = torch.from_numpy(np.random.default_rng(k).standard_normal((4, t, crop, crop, 3)).astype(np.float32))
        optimizer.zero_grad()
        torch.nn.functional.cross_entropy(module(y)[0].reshape(4, -1, 7).mean(1), torch.tensor([0, 1, 2, 3])).backward()
        optimizer.step()
        stats = convert_pyslowfast({n: v.numpy() for n, v in module.state_dict().items()}, num_splits=k)[1]


class _Recorder:
    """Every train iteration's (batch shape, learning rate, loss), read from
    each package's ``TrainMeter.update_stats`` and its loader's collate."""

    def __init__(self, monkeypatch, meter_module, loader_module):
        self.rows, self.shapes = [], []
        update, collate = meter_module.TrainMeter.update_stats, loader_module._collate

        def record_update(meter, top1, top5, loss, lr, mb):
            self.rows.append((float(loss), float(lr), int(mb)))
            return update(meter, top1, top5, loss, lr, mb)

        def record_collate(items):
            batch = collate(items)
            self.shapes.append(tuple(np.asarray(batch["frames"]).shape))
            return batch

        monkeypatch.setattr(meter_module.TrainMeter, "update_stats", record_update)
        monkeypatch.setattr(loader_module, "_collate", record_collate)


def _from_port_init(monkeypatch, cfg):
    """``vtm``'s ``build_model`` in its train loop, with the port's seeded
    init as its weights (no eager init)."""
    sd = {k: v.numpy() for k, v in build_model(cfg, "cpu", fp32_params=True).module.state_dict().items()}
    k = cfg.BN.NUM_SPLITS if cfg.BN.NORM_TYPE == "sub_batchnorm" else 1
    params, stats = convert_pyslowfast(sd, num_splits=k)

    def build(jcfg, init: bool = True):
        bundle = jax_build_model(jcfg, init=False)
        if init:
            bundle.params, bundle.batch_stats = params, stats
        return bundle

    monkeypatch.setattr(jax_train_net, "build_model", build)
    monkeypatch.setattr(jax_multigrid, "adapt_batch_stats",
                        lambda module, old, sample, adapt=jax_multigrid.adapt_batch_stats: adapt(
                            _StatInit(module), old, sample))


def both_train(monkeypatch, tmp_path, opts):
    cfg, jcfg = cfgs(opts + ["OUTPUT_DIR", str(tmp_path / "port")])
    jcfg.OUTPUT_DIR = str(tmp_path / "vtm")
    port = _Recorder(monkeypatch, meters, loader)
    ref = _Recorder(monkeypatch, jax_meters, jax_loader)
    _from_port_init(monkeypatch, cfg)  # the schedule changes none of the model's keys
    module = train_net.train(cfg, device="cpu")
    jax_train_net.train(jcfg)
    assert port.shapes == ref.shapes and len(port.rows) == len(ref.rows)
    for (loss, lr, mb), (jloss, jlr, jmb) in zip(port.rows, ref.rows):
        assert lr == jlr and mb == jmb and np.isfinite(loss)
        assert abs(loss - jloss) <= LOSS_TOL * abs(jloss), (loss, jloss)
    return cfg, jcfg, module, port


TRAIN_OPTS = ["TRAIN.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "2", "SOLVER.OPTIMIZING_METHOD", "sgd",
              "SOLVER.BASE_LR", "0.01", "SOLVER.LR_POLICY", "steps_with_relative_lrs", "TRAIN.EVAL_PERIOD", "100",
              "TRAIN.CHECKPOINT_PERIOD", "100", "TRAIN.AUTO_RESUME", "False", "DATA_LOADER.NUM_WORKERS", "0"]


LONG_OPTS = ("RESNET.ZERO_INIT_FINAL_BN", "True", "DATA.TRAIN_CROP_SIZE", "64", "DATA.TEST_CROP_SIZE", "64", *TRAIN_OPTS,
             "SOLVER.STEPS", "[0, 2, 3]", "SOLVER.LRS", "[1, 0.1, 0.01]", "SOLVER.MAX_EPOCH", "3",
             "MULTIGRID.LONG_CYCLE", "True", "MULTIGRID.LONG_CYCLE_FACTORS", "[(0.5, 0.7071067811865476), (1.0, 1.0)]",
             "MULTIGRID.BN_BASE_SIZE", "4")


def test_long_cycle_train_matches_vtm(monkeypatch, tmp_path):
    """``train`` under the long cycle on a tiny R(2+1)D (8 x 64, B2, factors
    (0.5, 0.71) and (1, 1), ``BN_BASE_SIZE`` 4), against ``vtm``'s ``train``
    from the same weights: the shapes T 4 at crop 45 with B8 (``sub_batchnorm``,
    2 splits) and T 8 at 64 with B2 (``sync_batchnorm``), every batch's
    shape, learning rate (the schedule's ``steps_with_relative_lrs``) and
    loss; at the end the port's BatchNorms have the last shape's splits."""
    cfg, jcfg, module, port = both_train(monkeypatch, tmp_path, ptv_opts("r2plus1d", *LONG_OPTS))
    assert {s[:4] for s in port.shapes} == {(8, 4, 45, 45), (2, 8, 64, 64)}
    assert _updated(cfg) == _updated(jcfg)
    assert {bn.num_splits for bn in batchnorms(module)} == {cfg.BN.NUM_SPLITS if cfg.BN.NORM_TYPE == "sub_batchnorm"
                                                            else 1}


def test_long_cycle_resume_matches_an_uninterrupted_run(tmp_path):
    """The run of ``test_long_cycle_train_matches_vtm`` with a checkpoint an
    epoch, and the same run resumed from its epoch-0 checkpoint alone (saved
    with 2 splits a BatchNorm, while a fresh model has 1): the resumed
    ``train`` re-shapes the model to the saved epoch's shape before it loads
    the file, then follows the schedule; its final state dict equals the
    uninterrupted run's bit for bit."""
    opts = ptv_opts("r2plus1d", *LONG_OPTS, "TRAIN.CHECKPOINT_PERIOD", "1", "TRAIN.AUTO_RESUME", "True")
    whole, _ = cfgs(opts + ["OUTPUT_DIR", str(tmp_path / "whole")])
    done = train_net.train(whole, device="cpu").state_dict()
    saved = tmp_path / "whole" / "checkpoints" / "epoch_00000.pyth"
    assert any(".split_bn." in k for k in torch.load(saved, weights_only=True)["model_state"])
    (tmp_path / "part" / "checkpoints").mkdir(parents=True)
    shutil.copy(saved, tmp_path / "part" / "checkpoints")
    part, _ = cfgs(opts + ["OUTPUT_DIR", str(tmp_path / "part")])
    resumed = train_net.train(part, device="cpu").state_dict()
    assert list(resumed) == list(done)
    for k, v in done.items():
        assert torch.equal(resumed[k], v), k
