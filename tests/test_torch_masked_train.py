"""Masked pretraining of the port on the CPU, tiny (``torch_masked_cases``),
against ``vtm``: one MAE and one MaskFeat step (``make_mae_train_step``,
``make_maskfeat_train_step``; SGD with momentum and weight decay) from the
same weights, the loss and each parameter's update; the parameter groups
(zero weight decay by name, layer decay) of both families with a decoder;
``train_net.train`` for one epoch on synthetic clips with the loader's block
masks against ``vtm``'s ``train``, each iteration's loss, and the last
checkpoint; an MViT fine-tune starting from a MaskMViT checkpoint, as
``vtm`` loads one. About 30 s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.train_net as jax_train_net
import vtm.eval.meters as jax_meters
from vtm.checkpoints import checkpoint as jcu
from vtm.checkpoints.convert import convert_maskmvit
from vtm.models import masked as jmasked
from vtm.models.build import build_model as jax_build_model
from vtm.train import optimizer as jopt
from vtm.train.train_step import make_mae_train_step, make_maskfeat_train_step

import vtm_torch.eval.meters as meters
from vtm_torch.checkpoints import checkpoint as cu
from vtm_torch.checkpoints.convert import maskmvit_state_dict_from_vtm_params, mvit_state_dict_from_vtm_params
from vtm_torch.models import build_model
from vtm_torch.tools import train_net
from vtm_torch.train.optimizer import set_lr

from torch_conv_cases import cfgs
from torch_masked_cases import DECODER, MAE, MASKFEAT, Case
from torch_mvit_cases import grad_errors, mvit_opts, template_of

torch.set_num_threads(2)

# each parameter's fp32 update against vtm's, of its tensor's largest
# (tests/test_torch_mvit_train.py's gradient tolerance)
STEP_GRAD_TOL = 2e-5
LOSS_TOL = 1e-5
SGD = ("SOLVER.OPTIMIZING_METHOD", "sgd", "SOLVER.MOMENTUM", "0.9", "SOLVER.WEIGHT_DECAY", "0.05",
       "SOLVER.BASE_LR", "0.1")
TRAIN = ("TRAIN.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "4", "SOLVER.MAX_EPOCH", "1",
         "SOLVER.OPTIMIZING_METHOD", "adamw", "SOLVER.BASE_LR", "0.001", "SOLVER.WEIGHT_DECAY", "0.05",
         "TRAIN.EVAL_PERIOD", "1", "TRAIN.CHECKPOINT_PERIOD", "1", "TRAIN.AUTO_RESUME", "False",
         "AUG.GEN_MASK_LOADER", "True", "AUG.MASK_RATIO", "0.4", "AUG.MASK_WINDOW_SIZE", "[2, 4, 4]",
         "DATA_LOADER.NUM_WORKERS", "0")


def _vtm_tx(case):
    """``vtm``'s optimizer on the case's params, at epoch 0's learning rate."""
    tx, lr_at = jopt.construct_optimizer(case.jcfg, case.params, num_layers=case.cfg.MVIT.DEPTH)
    opt_state = tx.init(case.params)
    jopt.set_lr(opt_state, lr_at(0.0))
    return tx, opt_state


@pytest.mark.parametrize("family", ["mae", "maskfeat"])
def test_train_step_matches_vtm(family):
    """``train_net``'s masked step (its HOG targets made by the port, the
    mask weighting the mse) against ``vtm``'s jitted step from the same
    weights: the loss, the per-depth losses, and each parameter's update
    (new - old) within STEP_GRAD_TOL of its tensor's largest."""
    opts = (MAE + ("MASK.PRETRAIN_DEPTH", "[0, 1]") if family == "mae" else
            MASKFEAT + ("MASK.PRETRAIN_DEPTH", "[1, 3]")) + SGD
    case = Case(*opts)
    trainer = train_net.build_trainer(case.cfg, "cpu")
    module = trainer.module
    before = {k: v.detach().clone() for k, v in module.state_dict().items()}
    for k, v in case.module.state_dict().items():
        assert torch.equal(before[k], v), k
    x = case.video(4, seed=3)
    t, h, w = case.token_grid()
    mask = np.random.default_rng(4).integers(0, 2, (4, t, 4, 4)).astype(np.float32)
    set_lr(trainer.optimizer, trainer.lr_at(0.0))
    loss, multi = trainer.train_step(torch.from_numpy(x), torch.from_numpy(mask), torch.Generator())
    tx, opt_state = _vtm_tx(case)
    if family == "mae":
        step = make_mae_train_step(case.jbundle.module, tx)
        new, _, want_loss, want_multi = step(case.params, opt_state, jnp.asarray(x), jnp.asarray(mask),
                                             jax.random.key(0))
    else:
        labels = [jnp.asarray(lab) for lab in jmasked.maskfeat_hog_labels(
            case.jbundle.module.spec, case.cfg.MASK.PRETRAIN_DEPTH, x)]
        step = make_maskfeat_train_step(case.jbundle.module, tx)
        new, _, want_loss, want_multi = step(case.params, opt_state, jnp.asarray(x), jnp.asarray(mask), labels,
                                             jax.random.key(0))
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL * abs(float(want_loss))
    assert len(multi) == len(want_multi) == 2
    for g, w in zip(multi, want_multi):
        assert abs(float(g) - float(w)) <= LOSS_TOL * abs(float(w))
    want_new = maskmvit_state_dict_from_vtm_params(jax.tree_util.tree_map(np.asarray, new))
    got = {k: (v - before[k]).numpy() for k, v in module.state_dict().items()}
    want = {k: (v - before[k]).numpy() for k, v in want_new.items()}
    errs = grad_errors(got, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= STEP_GRAD_TOL, (worst, errs[worst])


@pytest.mark.parametrize("opts", [
    MAE + DECODER + ("MASK.DECODER_SEP_POS_EMBED", "True", "MVIT.SEP_POS_EMBED", "True"),
    MAE + DECODER + ("MVIT.USE_FIXED_SINCOS_POS", "True", "SOLVER.ZERO_WD_1D_PARAM", "True"),
    MASKFEAT + DECODER + ("MVIT.ZERO_DECAY_POS_CLS", "False",),
], ids=["mae_sep", "mae_sincos_1d", "maskfeat_decoder"])
def test_parameter_groups_match_vtm(opts):
    """Each parameter's weight decay and layer-decay scale against ``vtm``'s
    ``_is_zero_wd`` and ``_layer_id`` on its flax path: ``mask_token``,
    ``decoder_pos_embed`` and ``dec_pos_embed_*`` fall in the same groups by
    the same substring match, as do the head's decoder blocks and norms."""
    case = Case(*opts, "SOLVER.OPTIMIZING_METHOD", "adamw", "SOLVER.WEIGHT_DECAY", "0.05",
                "SOLVER.LAYER_DECAY", "0.75")
    trainer = train_net.build_trainer(case.cfg, "cpu")
    got = {}
    by_id = {id(p): k for k, p in trainer.module.named_parameters()}
    for group in trainer.optimizer.param_groups:
        for p in group["params"]:
            got[by_id[id(p)]] = (group["weight_decay"], group["lr_scale"])
    depth = case.cfg.MVIT.DEPTH
    flat = jax.tree_util.tree_flatten_with_path(case.params)[0]
    tree = jax.tree_util.tree_structure(case.params)

    def per_param(fn):
        values = [np.full(np.shape(x), float(fn(p, x)), np.float64) for p, x in flat]
        return {k: float(v.flatten()[0]) for k, v in
                maskmvit_state_dict_from_vtm_params(jax.tree_util.tree_unflatten(tree, values)).items()}

    jwd = per_param(lambda p, x: 0.0 if jopt._is_zero_wd(case.jcfg, p, x) else 0.05)
    jscale = per_param(lambda p, x: 0.75 ** (depth + 1 - jopt._layer_id(p, depth)))
    assert sorted(got) == sorted(jwd)
    for k, (wd, scale) in got.items():
        assert wd == jwd[k] and abs(scale - jscale[k]) <= 1e-12, (k, wd, jwd[k], scale, jscale[k])
    zero = {k for k, (wd, _) in got.items() if wd == 0.0}
    if case.cfg.MVIT.ZERO_DECAY_POS_CLS:
        assert "mask_token" in zero and any("pos_embed" in k for k in zero)


@pytest.mark.parametrize("family", ["mae", "maskfeat"])
def test_train_net_epoch_matches_vtm(monkeypatch, tmp_path, family):
    """One epoch of ``train_net.train`` on 16 synthetic clips (B4, AdamW,
    the loader's 3-D block masks on one thread, ``random`` seeded alike),
    against ``vtm``'s ``train`` from the port's weights: each iteration's
    loss, learning rate and batch; no eval epoch; the epoch's checkpoint
    holds the trained module."""
    import random

    opts = (MAE if family == "mae" else MASKFEAT + ("MASK.PRETRAIN_DEPTH", "[1]")) + TRAIN
    cfg, jcfg = cfgs(mvit_opts(*opts, "OUTPUT_DIR", str(tmp_path / "port")))
    jcfg.OUTPUT_DIR = str(tmp_path / "vtm")
    sd = {k: v.numpy() for k, v in build_model(cfg, "cpu", fp32_params=True).module.state_dict().items()}
    params = convert_maskmvit(sd, depth=max(cfg.MASK.PRETRAIN_DEPTH) + 1)

    def jax_build(c, init: bool = True):
        bundle = jax_build_model(c, init=False)
        bundle.params = params
        return bundle

    monkeypatch.setattr(jax_train_net, "build_model", jax_build)
    rows = {}
    for name, meter_module in (("port", meters), ("vtm", jax_meters)):
        update = meter_module.TrainMeter.update_stats
        rows[name] = []

        def record(meter, top1, top5, loss, lr, mb, update=update, seen=rows[name]):
            seen.append((float(loss), float(lr), int(mb), top1, top5))
            return update(meter, top1, top5, loss, lr, mb)

        monkeypatch.setattr(meter_module.TrainMeter, "update_stats", record)
    evals = []
    monkeypatch.setattr(train_net, "eval_epoch", lambda *a, **k: evals.append(a))
    random.seed(5)
    module = train_net.train(cfg, device="cpu")
    random.seed(5)
    jax_train_net.train(jcfg)
    assert len(rows["port"]) == len(rows["vtm"]) == 4 and not evals
    for (loss, lr, mb, top1, top5), (jloss, jlr, jmb, _, _) in zip(rows["port"], rows["vtm"]):
        assert lr == jlr and mb == jmb == 4 and (top1, top5) == (0.0, 0.0)
        assert np.isfinite(loss) and abs(loss - jloss) <= LOSS_TOL * abs(jloss), (loss, jloss)
    saved = torch.load(cu.get_last_checkpoint(str(tmp_path / "port")), weights_only=True)["model_state"]
    assert all(torch.equal(saved[k], v) for k, v in module.state_dict().items())


def test_mae_trains_without_loader_masks(tmp_path):
    """Under ``MASK.MAE_RND_MASK`` without ``AUG.GEN_MASK_LOADER`` the batch
    has no mask (``vtm``'s ``train_epoch`` fails there on the missing key):
    ``train`` passes none, the MAE draws its noise from each step's
    generator, and two runs give the same losses."""
    opts = mvit_opts(*MAE, *TRAIN, "MASK.MAE_RND_MASK", "True", "AUG.GEN_MASK_LOADER", "False",
                     "TRAIN.CHECKPOINT_PERIOD", "10")
    runs = []
    for i in range(2):
        cfg, _ = cfgs(opts + ["OUTPUT_DIR", str(tmp_path / str(i))])
        seen = []
        update = meters.TrainMeter.update_stats

        def record(meter, top1, top5, loss, lr, mb, seen=seen):
            seen.append(float(loss))
            return update(meter, top1, top5, loss, lr, mb)

        meters.TrainMeter.update_stats = record
        try:
            train_net.train(cfg, device="cpu")
        finally:
            meters.TrainMeter.update_stats = update
        runs.append(seen)
    assert len(runs[0]) == 4 and np.isfinite(runs[0]).all() and runs[0] == runs[1]
    cfg, _ = cfgs(mvit_opts(*MASKFEAT))
    with pytest.raises(ValueError, match="GEN_MASK_LOADER"):
        build_model(cfg, "cpu").module(torch.zeros(1, 4, 32, 32, 3), None)


def test_masked_training_runs_in_one_process(monkeypatch):
    """``main`` sizes the process group by a batch of one under
    ``MASK.ENABLE``; a tensor-parallel width raises by name, as for MViT."""
    cfg, _ = cfgs(mvit_opts(*MAE, "TRAIN.BATCH_SIZE", "8"))
    assert train_net._process_batch(cfg) == 1
    cfg.TPU.MODEL_PARALLEL = 2
    with pytest.raises(NotImplementedError, match="item 15"):
        train_net.build_trainer(cfg, "cpu")


def test_mvit_fine_tune_loads_a_maskmvit_checkpoint(tmp_path):
    """A MaskFeat state dict saved as a torch file, given to an MViT of the
    same trunk as ``TRAIN.CHECKPOINT_FILE_PATH``: ``train`` loads the trunk
    (blocks, positions, class token) and drops ``mask_token`` and the
    pretraining head, keeping its own ``norm`` and head, and what it loads
    is what ``vtm``'s ``load_test_checkpoint`` loads from the same file."""
    pre = Case(*MASKFEAT)
    path = tmp_path / "maskfeat.pyth"
    torch.save({"model_state": pre.module.state_dict()}, path)
    # one epoch at a learning rate of 0: the loaded weights stay as loaded
    cfg, jcfg = cfgs(mvit_opts("TRAIN.CHECKPOINT_FILE_PATH", str(path), "SOLVER.MAX_EPOCH", "1",
                               "SOLVER.OPTIMIZING_METHOD", "sgd", "SOLVER.LR_POLICY", "steps_with_relative_lrs",
                               "SOLVER.STEPS", "[0]", "SOLVER.LRS", "[0.0]", "TRAIN.BATCH_SIZE", "8",
                               "TRAIN.EVAL_PERIOD", "100", "TRAIN.CHECKPOINT_PERIOD", "100",
                               "TRAIN.DATASET", "synthetic", "OUTPUT_DIR", str(tmp_path / "ft")))
    init = build_model(cfg, "cpu", fp32_params=True).module.state_dict()
    tuned = train_net.train(cfg, device="cpu").state_dict()
    file = pre.module.state_dict()
    loaded = {k for k in tuned if k in file}
    assert loaded and all(torch.equal(tuned[k], file[k]) for k in loaded)
    assert all(torch.equal(tuned[k], init[k]) for k in tuned if k not in file)
    assert {k for k in file if k not in tuned} == {k for k in file if k == "mask_token" or k.startswith("pred_head.")}
    jbundle = jax_build_model(jcfg, init=False)
    t, s = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE
    jbundle.params = template_of(jax.eval_shape(jbundle.module.init, jax.random.key(0),
                                                jnp.zeros((1, t, s, s, 3)))["params"])
    jcfg.TEST.CHECKPOINT_FILE_PATH = str(path)
    jloaded = mvit_state_dict_from_vtm_params(jcu.load_test_checkpoint(jcfg, jbundle).params)
    assert sorted(jloaded) == sorted(tuned)
    for k, v in jloaded.items():  # from the file, or the template's zeros
        assert torch.equal(v, file[k]) if k in loaded else not v.any(), k
