"""The port's VideoMAE training path against the JAX package's, on the CPU
in fp32 at a tiny size: loss, matching, gradients, optimizer steps, the
copied helpers, the dropout sites, and the train entry point end to end.

Inputs and weights are numpy arrays made from a seed and handed to both
packages; the JAX parameter tree reaches the port through
``state_dict_from_vtm_params`` and gradients come back through
``named_arrays_from_vtm_tree``.
"""

import json
import logging
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vtm.config as jcfg
import vtm.data as jdata
import vtm.eval.meters as jmeters
import vtm.eval.metrics as jmetrics
import vtm.train.losses as jlosses
import vtm.train.lr_policy as jlr
import vtm.train.mixup as jmixup
import vtm.train.optimizer as jopt
from vtm.merge import bipartite as jb
from vtm.merge.policy import MergePolicy as JPolicy
from vtm.models.videomae import VideoMAE as JVideoMAE
from vtm.models.videomae import VideoMAEConfig as JConfig
from vtm.train.train_step import make_train_step as jax_make_train_step

import vtm_torch.config as tcfg
import vtm_torch.data as tdata
import vtm_torch.eval.meters as tmeters
import vtm_torch.eval.metrics as tmetrics
import vtm_torch.train.losses as tlosses
import vtm_torch.train.lr_policy as tlr
import vtm_torch.train.mixup as tmixup
import vtm_torch.train.optimizer as topt
from vtm_torch.checkpoints import checkpoint as cu
from vtm_torch.checkpoints.convert import named_arrays_from_vtm_tree, state_dict_from_vtm_params
from vtm_torch.merge import bipartite as tb
from vtm_torch.merge.policy import MergePolicy
from vtm_torch.models import build_model
from vtm_torch.models.common import drop_path, dropout
from vtm_torch.models.videomae import VideoMAE, VideoMAEConfig
from vtm_torch.tools.train_net import train
from vtm_torch.train.train_step import make_eval_step, make_train_step

from torch_conv_cases import ptv_opts

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]

# 3 layers, 64 tokens (4 tubelets x 4x4 patches), r=8
ARCH = dict(
    img_size=64, patch_size=16, num_frames=8, tubelet_size=2, embed_dim=32,
    depth=3, num_heads=2, mlp_ratio=2.0,
)
R = 8
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4   # of the largest entry of each gradient tensor
# After three optimizer steps. Adam divides by sqrt(v): an element whose
# gradient is within GRAD_TOL of zero (of its tensor's largest) steps by
# about lr whatever its size, and fp32 rounding, which differs from machine
# to machine, decides its sign and size. Such an element is held to what
# Adam can move it, 2 * lr * lr_scale summed over the steps, and at most
# NEAR_ZERO_SHARE of all elements may be such; every other element is held
# to PARAM_TOL, and every element of an SGD run.
PARAM_TOL = 1e-5
NEAR_ZERO_SHARE = 0.01


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(num_classes, seed=0):
    """The same tiny VideoMAE in both packages: JAX params drawn by flax,
    q/v biases made non-zero with numpy, bridged into the port."""
    kw = dict(rs=(R,) * ARCH["depth"], mode="merge", prop_attn=False)
    jmodel = JVideoMAE(config=JConfig(num_classes=num_classes, **ARCH), policy=JPolicy(**kw))
    video = _video(2, 9)
    params = _np_tree(jmodel.init(jax.random.key(seed), jnp.asarray(video))["params"])
    rng = np.random.default_rng(seed)
    for i in range(ARCH["depth"]):
        attn = params[f"blocks_{i}"]["attn"]
        for name in ("q_bias", "v_bias"):
            attn[name] = (0.1 * rng.standard_normal(attn[name].shape)).astype(np.float32)
    tmodel = VideoMAE(VideoMAEConfig(num_classes=num_classes, **ARCH), policy=MergePolicy(**kw),
                      fp32_params=True)
    tmodel.load_state_dict(state_dict_from_vtm_params(params))
    return jmodel, params, tmodel


def _video(batch, seed):
    shape = (batch, ARCH["num_frames"], ARCH["img_size"], ARCH["img_size"], 3)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _labels(num_classes, batch, seed):
    rng = np.random.default_rng(seed)
    if isinstance(num_classes, tuple):
        return {"verb": rng.integers(0, num_classes[0], batch), "noun": rng.integers(0, num_classes[1], batch)}
    return rng.integers(0, num_classes, batch)


def _to_torch(labels):
    if isinstance(labels, dict):
        return {k: torch.from_numpy(v) for k, v in labels.items()}
    return torch.from_numpy(labels)


def _to_jax(labels):
    if isinstance(labels, dict):
        return {k: jnp.asarray(v) for k, v in labels.items()}
    return jnp.asarray(labels)


def _jax_loss(jmodel, multi_head):
    def loss(p, frames, labels):
        logits, _ = jmodel.apply({"params": p}, frames)
        if multi_head:
            return 0.5 * (jlosses.cross_entropy(logits[0], labels["verb"])
                          + jlosses.cross_entropy(logits[1], labels["noun"]))
        return jlosses.cross_entropy(logits, labels)

    return loss


def _torch_loss(tmodel, multi_head, frames, labels):
    logits, _ = tmodel(frames)
    if multi_head:
        return tlosses.epic_dual_loss(tlosses.cross_entropy, logits, labels)
    return tlosses.cross_entropy(logits, labels)


@pytest.mark.parametrize("num_classes", [7, (5, 6)], ids=["single_head", "twin_heads"])
def test_loss_matching_and_gradients_match_vtm(num_classes):
    multi_head = isinstance(num_classes, tuple)
    jmodel, params, tmodel = _pair(num_classes)
    video, labels = _video(2, 1), _labels(num_classes, 2, 2)

    with jax.default_matmul_precision("highest"):
        want_loss, want_grads = jax.jit(jax.value_and_grad(_jax_loss(jmodel, multi_head)))(
            params, jnp.asarray(video), _to_jax(labels)
        )
        _, inter = jax.jit(lambda p, v: jmodel.apply({"params": p}, v, capture_intermediates=True))(
            params, jnp.asarray(video))
    metrics = []
    hooks = [b.attn.register_forward_hook(lambda m, i, o: metrics.append(o[1])) for b in tmodel.blocks]
    tmodel.train()  # every drop rate is 0: training mode changes nothing
    loss = _torch_loss(tmodel, multi_head, torch.from_numpy(video), _to_torch(labels))
    loss.backward()
    for hk in hooks:
        hk.remove()

    assert abs(loss.item() - float(want_loss)) <= LOSS_TOL
    for i in range(ARCH["depth"]):
        jmetric = inter["intermediates"][f"blocks_{i}"]["attn"]["__call__"][0][1]
        mj = jb.bipartite_soft_matching(jmetric, R)
        mt = tb.bipartite_soft_matching(metrics[i], R)
        for name in ("unm_idx", "src_idx", "dst_idx"):
            idx = getattr(mt, name)
            assert not idx.requires_grad and not idx.dtype.is_floating_point
            np.testing.assert_array_equal(idx.numpy(), np.asarray(getattr(mj, name)), err_msg=f"{i} {name}")
    want = named_arrays_from_vtm_tree(_np_tree(want_grads))
    named = dict(tmodel.named_parameters())
    assert sorted(want) == sorted(named)
    for name, p in named.items():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        tol = GRAD_TOL * np.abs(want[name]).max()
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=0, atol=tol, err_msg=name)


def _solver_opts(method, extra=()):
    return [
        "MODEL.MODEL_NAME", "VideoMAE", "SOLVER.OPTIMIZING_METHOD", method,
        "SOLVER.BASE_LR", "0.001", "SOLVER.LR_POLICY", "cosine", "SOLVER.MAX_EPOCH", "4",
        "SOLVER.COSINE_END_LR", "1e-6", "SOLVER.WEIGHT_DECAY", "0.05", "SOLVER.LAYER_DECAY", "0.75",
        "SOLVER.ZERO_WD_1D_PARAM", "True", "SOLVER.MOMENTUM", "0.9", *extra,
    ]


def _cfgs(opts):
    jc, tc = jcfg.get_cfg(), tcfg.get_cfg()
    jc.merge_from_list(list(opts))
    tc.merge_from_list(list(opts))
    return jc, tc


@pytest.mark.parametrize(
    "method,num_classes,extra",
    [
        ("adamw", 7, ()),
        ("adamw", (5, 6), ()),
        ("adamw", 7, ("SOLVER.CLIP_GRAD_L2NORM", "0.05")),
        ("adam", 7, ("SOLVER.CLIP_GRAD_VAL", "0.002")),
        ("sgd", 7, ()),
    ],
    ids=["adamw", "adamw_twin_heads", "adamw_clip_norm", "adam_clip_value", "sgd_nesterov"],
)
def test_three_optimizer_steps_match_vtm(method, num_classes, extra):
    """construct_optimizer in both packages (layer decay 0.75, the zero-wd
    grouping, a cosine schedule that changes the lr every step), three
    steps on three batches: parameters within PARAM_TOL, or for Adam's
    near-zero-gradient elements within the step Adam can take."""
    multi_head = isinstance(num_classes, tuple)
    jc, tc = _cfgs(_solver_opts(method, extra))
    jmodel, params, tmodel = _pair(num_classes, seed=1)
    depth = ARCH["depth"]

    tx, jlr_at = jopt.construct_optimizer(jc, params, num_layers=depth)
    opt_state = tx.init(params)
    jstep = jax_make_train_step(jmodel, tx, "cross_entropy", multi_head)
    optimizer, lr_at = topt.construct_optimizer(tc, tmodel, num_layers=depth)
    tstep = make_train_step(tmodel, optimizer, "cross_entropy", multi_head)
    names = {id(p): name for name, p in tmodel.named_parameters()}
    near_zero = {name: torch.zeros_like(p, dtype=torch.bool) for name, p in tmodel.named_parameters()}
    lr_sum = dict.fromkeys(near_zero, 0.0)  # sum over steps of lr * lr_scale

    def mark_near_zero(opt, args, kwargs):
        for group in opt.param_groups:
            for p in group["params"]:
                name = names[id(p)]
                lr_sum[name] += group["lr"]
                if p.grad is not None:
                    g = p.grad.abs()
                    # a gradient that is exactly 0 moves nothing either way
                    near_zero[name] |= (g > 0) & (g <= GRAD_TOL * g.max())

    optimizer.register_step_pre_hook(mark_near_zero)

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    for i in range(3):
        epoch = i / 3.0
        assert lr_at(epoch) == jlr_at(epoch)
        video, labels = _video(2, 10 + i), _labels(num_classes, 2, 20 + i)
        jopt.set_lr(opt_state, jlr_at(epoch))
        with jax.default_matmul_precision("highest"):
            jparams, opt_state, jloss, _, jaux = jstep(
                jparams, opt_state, jnp.asarray(video), _to_jax(labels), jax.random.key(i)
            )
        topt.set_lr(optimizer, lr_at(epoch))
        loss, logits, aux = tstep(torch.from_numpy(video), _to_torch(labels))
        assert abs(loss.item() - float(jloss)) <= 1e-4, i
        assert len(aux) == len(jaux)
    want = named_arrays_from_vtm_tree(_np_tree(jparams))
    moved = 0.0
    start = state_dict_from_vtm_params(params)
    adam = method.startswith("adam")
    flagged = total = 0
    for name, p in tmodel.named_parameters():
        atol = np.full(p.shape, PARAM_TOL, np.float32)
        if adam:
            mask = near_zero[name].numpy()
            atol[mask] = max(PARAM_TOL, 2.0 * lr_sum[name])
            flagged += int(mask.sum())
        total += p.numel()
        err = np.abs(p.detach().numpy() - want[name])
        assert (err <= atol).all(), (name, float(err.max()), int((err > PARAM_TOL).sum()))
        moved = max(moved, (p.detach() - start[name]).abs().max().item())
    assert flagged <= NEAR_ZERO_SHARE * total, (flagged, total)
    assert moved > 1e-4  # the steps did something


def test_set_lr_scales_each_group_by_its_layer_decay():
    _, tc = _cfgs(_solver_opts("adamw"))
    _, _, tmodel = _pair(7)
    depth = ARCH["depth"]
    optimizer, _ = topt.construct_optimizer(tc, tmodel, num_layers=depth)
    topt.set_lr(optimizer, 0.5)
    by_param = {id(p): g for g in optimizer.param_groups for p in g["params"]}
    named = dict(tmodel.named_parameters())
    assert len(by_param) == len(named)
    for name, layer in (("patch_embed.proj.weight", 0), ("blocks.1.mlp.fc1.weight", 2), ("head.weight", depth + 1)):
        g = by_param[id(named[name])]
        assert g["lr_scale"] == pytest.approx(0.75 ** (depth + 1 - layer))
        assert g["lr"] == pytest.approx(0.5 * g["lr_scale"])
        assert g["weight_decay"] == 0.05
    for name in ("blocks.0.attn.q_bias", "blocks.2.norm1.weight", "head.bias", "fc_norm.bias"):
        assert by_param[id(named[name])]["weight_decay"] == 0.0, name


def test_zero_wd_and_layer_id_match_vtm_on_every_parameter():
    jc, tc = _cfgs(_solver_opts("adamw"))
    _, params, tmodel = _pair(7)
    depth = ARCH["depth"]
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    jwd = named_arrays_from_vtm_tree(jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [np.full(np.shape(x), float(jopt._is_zero_wd(jc, p, x)), np.float32) for p, x in flat]))
    jid = named_arrays_from_vtm_tree(jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [np.full(np.shape(x), float(jopt._layer_id(p, depth)), np.float32) for p, x in flat]))
    for name, p in tmodel.named_parameters():
        assert float(topt._is_zero_wd(tc, name, p)) == jwd[name].flat[0], name
        assert float(topt._layer_id(name, depth)) == jid[name].flat[0], name


@pytest.mark.parametrize(
    "opts",
    [
        ("SOLVER.LR_POLICY", "cosine", "SOLVER.BASE_LR", "0.001", "SOLVER.COSINE_END_LR", "2e-06",
         "SOLVER.MAX_EPOCH", "50", "SOLVER.WARMUP_EPOCHS", "5.0", "SOLVER.WARMUP_START_LR", "0.0",
         "SOLVER.COSINE_AFTER_WARMUP", "True"),
        ("SOLVER.LR_POLICY", "steps_with_relative_lrs", "SOLVER.BASE_LR", "0.005", "SOLVER.LRS",
         "[1, 0.1, 0.01]", "SOLVER.STEPS", "[0, 11, 14]", "SOLVER.MAX_EPOCH", "15"),
    ],
    ids=["cosine_after_warmup", "steps"],
)
def test_lr_policy_equals_vtm(opts):
    jc, tc = _cfgs(opts)
    for epoch in np.linspace(0, tc.SOLVER.MAX_EPOCH - 0.01, 97):
        assert tlr.get_lr_at_epoch(tc, float(epoch)) == jlr.get_lr_at_epoch(jc, float(epoch))
    with pytest.raises(NotImplementedError):
        tlr.get_lr_func("nope")


@pytest.mark.parametrize(
    "name",
    ["train/lr_policy.py", "train/mixup.py", "eval/metrics.py", "utils/timer.py"],
)
def test_verbatim_copies_stay_equal(name):
    assert (REPO / "vtm_torch" / name).read_text() == (REPO / "vtm" / name).read_text()


@pytest.mark.parametrize("kw", [dict(), dict(mixup_alpha=0.0), dict(cutmix_alpha=0.0), dict(mix_prob=0.5)],
                         ids=["both", "cutmix_only", "mixup_only", "sometimes"])
def test_mixup_equals_vtm(kw):
    a = tmixup.MixUp(num_classes=10, seed=3, **kw)
    b = jmixup.MixUp(num_classes=10, seed=3, **kw)
    rng = np.random.default_rng(0)
    for _ in range(6):
        frames = rng.standard_normal((4, 2, 16, 16, 3)).astype(np.float32)
        labels = rng.integers(0, 10, 4)
        fa_, ta = a(frames, labels)
        fb, tb_ = b(frames, labels)
        np.testing.assert_array_equal(fa_, fb)
        np.testing.assert_array_equal(ta, tb_)


def test_losses_equal_vtm():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((6, 9)).astype(np.float32) * 3
    labels = rng.integers(0, 9, 6)
    soft = rng.dirichlet(np.ones(9), 6).astype(np.float32)
    multi = (rng.random((6, 9)) < 0.3).astype(np.float32)
    tl, jl = torch.from_numpy(logits), jnp.asarray(logits)
    cases = [
        (tlosses.cross_entropy(tl, torch.from_numpy(labels)), jlosses.cross_entropy(jl, jnp.asarray(labels))),
        (tlosses.cross_entropy(tl, torch.from_numpy(labels), 0.1), jlosses.cross_entropy(jl, jnp.asarray(labels), 0.1)),
        (tlosses.cross_entropy(tl, torch.from_numpy(soft)), jlosses.cross_entropy(jl, jnp.asarray(soft))),
        (tlosses.get_loss_func("soft_cross_entropy")(tl, torch.from_numpy(soft)),
         jlosses.get_loss_func("soft_cross_entropy")(jl, jnp.asarray(soft))),
        (tlosses.get_loss_func("bce_logit")(tl, torch.from_numpy(multi)),
         jlosses.get_loss_func("bce_logit")(jl, jnp.asarray(multi))),
    ]
    logits2 = rng.standard_normal((6, 4)).astype(np.float32)
    labels2 = rng.integers(0, 4, 6)
    cases.append((
        tlosses.epic_dual_loss(tlosses.cross_entropy, (tl, torch.from_numpy(logits2)),
                               {"verb": torch.from_numpy(labels), "noun": torch.from_numpy(labels2)}),
        jlosses.epic_dual_loss(jlosses.cross_entropy, (jl, jnp.asarray(logits2)),
                               {"verb": jnp.asarray(labels), "noun": jnp.asarray(labels2)}),
    ))
    target = rng.standard_normal((6, 9)).astype(np.float32)
    cases.append((tlosses.get_loss_func("mse")(tl, torch.from_numpy(target)),
                  jlosses.get_loss_func("mse")(jl, jnp.asarray(target))))
    for i, (got, want) in enumerate(cases):
        assert abs(got.item() - float(want)) <= 1e-6, i
    with pytest.raises(NotImplementedError):
        tlosses.get_loss_func("nope")


def _data_cfgs(extra=()):
    return _cfgs(["TRAIN.DATASET", "synthetic", "TEST.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "3",
                  "TEST.BATCH_SIZE", "4", "DATA.NUM_FRAMES", "2", "DATA.TRAIN_CROP_SIZE", "8",
                  "DATA.TEST_CROP_SIZE", "8", "MODEL.NUM_CLASSES", "5", "DATA_LOADER.NUM_WORKERS", "2", *extra])


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("extra", [(), ("EPICKITCHENS.NUM_CLASSES", "[3, 4]")], ids=["single", "epic"])
def test_loader_and_synthetic_equal_vtm(split, extra):
    jc, tc = _data_cfgs(extra)
    jl, tl = jdata.construct_loader(jc, split), tdata.construct_loader(tc, split)
    assert len(jl) == len(tl)
    for epoch in range(2):
        jdata.shuffle_dataset(jl, epoch)
        tdata.shuffle_dataset(tl, epoch)
        n = 0
        for bj, bt in zip(jl, tl):
            np.testing.assert_array_equal(bt["frames"], bj["frames"])
            np.testing.assert_array_equal(bt["index"], bj["index"])
            if extra:
                for k in ("verb", "noun"):
                    np.testing.assert_array_equal(bt["label"][k], bj["label"][k])
            else:
                np.testing.assert_array_equal(bt["label"], bj["label"])
            n += 1
        assert n == len(tl)
    # charades is ported too (tests/test_torch_charades.py): without its
    # frame lists it fails as vtm's does
    for build, c in ((jdata.build_dataset, jc), (tdata.build_dataset, tc)):
        with pytest.raises(AssertionError, match="train.csv not found"):
            build("charades", c, "train")


def test_metrics_and_meters_equal_vtm(caplog):
    rng = np.random.default_rng(6)
    preds, labels = rng.standard_normal((16, 9)), rng.integers(0, 9, 16)
    preds2, labels2 = rng.standard_normal((16, 4)), rng.integers(0, 4, 16)
    assert tmetrics.topk_errors(preds, labels, (1, 5)) == jmetrics.topk_errors(preds, labels, (1, 5))
    assert tmetrics.multitask_topk_accuracies((preds, preds2), (labels, labels2), (1, 5)) == \
        jmetrics.multitask_topk_accuracies((preds, preds2), (labels, labels2), (1, 5))
    jc, tc = _data_cfgs(("LOG_PERIOD", "1", "SOLVER.MAX_EPOCH", "3"))
    accs = ((50.0, 75.0), (25.0, 100.0), (12.5, 75.0))
    caplog.set_level(logging.INFO)
    lines = {}
    for key, mod, c in (("jax", jmeters, jc), ("torch", tmeters, tc)):
        caplog.clear()
        tm, vm = mod.TrainMeter(4, c), mod.ValMeter(2, c)
        em, ev = mod.EPICTrainMeter(4, c), mod.EPICValMeter(2, c)
        for i in range(3):
            tm.update_stats(40.0 + i, 10.0, 1.5 - 0.1 * i, 0.01, 4)
            vm.update_stats(30.0, 5.0 + i, 4)
            em.update_stats(accs, (1.0, 2.0 + i, 1.5), 0.01, 4)
            ev.update_stats(accs, 4)
        tm.log_epoch_stats(0)
        em.log_epoch_stats(0)
        stats = (vm.log_epoch_stats(0), ev.log_epoch_stats(0))
        lines[key] = ([r.getMessage() for r in caplog.records if "json_stats" in r.getMessage()], stats)
    assert len(lines["torch"][0]) == 4
    assert lines["torch"][0] == lines["jax"][0]
    assert lines["torch"][1] == lines["jax"][1]


def test_drop_path_masks_whole_samples_and_rescales():
    z = torch.ones(4000, 3, 5)
    gen = torch.Generator().manual_seed(0)
    out = drop_path(z, 0.25, True, gen)
    per_sample = out.flatten(1)
    # each sample is kept whole (scaled by 1 / keep) or dropped whole
    assert bool(((per_sample == 0).all(dim=1) | (per_sample == 1 / 0.75).all(dim=1)).all())
    kept = (per_sample[:, 0] != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.03
    assert abs(out.mean().item() - 1.0) < 0.04
    # the same seed gives the same mask; eval mode and rate 0 are the identity
    again = drop_path(z, 0.25, True, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    assert drop_path(z, 0.25, False, gen) is z and drop_path(z, 0.0, True, gen) is z


def test_dropout_masks_elements_and_rescales():
    x = torch.ones(64, 50, 20)
    gen = torch.Generator().manual_seed(1)
    out = dropout(x, 0.1, True, gen)
    assert bool(((out == 0) | (out == x / 0.9)).all())
    assert abs((out != 0).float().mean().item() - 0.9) < 0.01
    assert abs(out.mean().item() - 1.0) < 0.01
    assert dropout(x, 0.1, False, gen) is x and dropout(x, 0.0, True, gen) is x


def test_model_dropout_sites_follow_mode_and_generator():
    """drop_rate, drop_path_rate and fc_drop_rate act in training mode
    only, with masks from the generator; block i's stochastic-depth rate
    is drop_path_rate * i / (depth - 1)."""
    config = VideoMAEConfig(num_classes=7, drop_rate=0.1, drop_path_rate=0.2, fc_drop_rate=0.5, **ARCH)
    model = VideoMAE(config, policy=MergePolicy(rs=(R,) * 3, mode="merge"), fp32_params=True)
    assert [b.drop_path_rate for b in model.blocks] == pytest.approx([0.0, 0.1, 0.2])
    video = torch.from_numpy(_video(2, 3))
    model.eval()
    with torch.no_grad():
        e1, _ = model(video, generator=torch.Generator().manual_seed(0))
        e2, _ = model(video, generator=torch.Generator().manual_seed(1))
        model.train()
        t1, _ = model(video, generator=torch.Generator().manual_seed(0))
        t1b, _ = model(video, generator=torch.Generator().manual_seed(0))
        t2, _ = model(video, generator=torch.Generator().manual_seed(1))
    assert torch.equal(e1, e2)
    assert torch.equal(t1, t1b)
    assert not torch.equal(t1, t2) and not torch.equal(t1, e1)


@pytest.mark.parametrize("mode", ["random_merge", "random_drop"])
def test_train_step_draws_the_random_modes_from_its_generator(mode):
    """The train step's generator reaches ``MergeState.generator``: one
    seed gives the same loss and logits twice, another seed another
    loss; without a generator the random modes raise ValueError, as vtm's
    do without an rng."""
    config = VideoMAEConfig(num_classes=7, **ARCH)
    video, labels = torch.from_numpy(_video(2, 3)), torch.from_numpy(_labels(7, 2, 4))
    runs = []
    for seed in (0, 0, 1):
        model = VideoMAE(config, policy=MergePolicy(rs=(R,) * 3, mode=mode), fp32_params=True)
        step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0), "cross_entropy", False)
        loss, logits, _ = step(video, labels, torch.Generator().manual_seed(seed))
        runs.append((loss.item(), logits))
    assert runs[0][0] == runs[1][0] and torch.equal(runs[0][1], runs[1][1])
    assert runs[0][0] != runs[2][0]
    with pytest.raises(ValueError, match="torch.Generator"):
        step(video, labels)


def test_fp32_params_forward_equals_cast_weights_forward():
    """Training keeps fp32 parameters and casts at use; serving casts the
    weights once. Same seed, same bf16 forward, bit for bit."""
    config = VideoMAEConfig(num_classes=7, **ARCH)
    policy = MergePolicy(rs=(R,) * 3, mode="merge")
    serve = VideoMAE(config, policy=policy, dtype=torch.bfloat16, seed=5).eval()
    learn = VideoMAE(config, policy=policy, dtype=torch.bfloat16, seed=5, fp32_params=True).eval()
    assert all(p.dtype == torch.float32 for p in learn.parameters())
    assert serve.blocks[0].mlp.fc1.weight.dtype == torch.bfloat16
    video = torch.from_numpy(_video(2, 4))
    with torch.no_grad():
        a, _ = serve(video)
        b, _ = learn(video)
    assert torch.equal(a, b)
    learn.train()
    loss = learn(video)[0].square().mean()
    loss.backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in learn.parameters())


def test_accumulate_steps_equals_one_step_on_the_doubled_batch():
    _, tc = _cfgs(_solver_opts("adamw"))
    video, labels = torch.from_numpy(_video(4, 7)), torch.from_numpy(_labels(7, 4, 8))
    models = []
    for k in (2, 1):
        _, _, tmodel = _pair(7, seed=2)
        optimizer, _ = topt.construct_optimizer(tc, tmodel, num_layers=ARCH["depth"])
        step = make_train_step(tmodel, optimizer, "cross_entropy", False, accumulate_steps=k)
        before = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
        if k == 2:
            step(video[:2], labels[:2])
            # one update every k calls: nothing moved yet
            assert all(torch.equal(p, before[n]) for n, p in tmodel.named_parameters())
            step(video[2:], labels[2:])
        else:
            step(video, labels)
        assert any(not torch.equal(p, before[n]) for n, p in tmodel.named_parameters())
        models.append(tmodel)
    for (n, a), (_, b) in zip(models[0].named_parameters(), models[1].named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=2e-6, err_msg=n)


def _train_opts(out, *extra):
    return [
        "MODEL.MODEL_NAME", "VideoMAE", "MODEL.ARCH", "videomae", "VIDEOMAE.MODEL", "vit_small_patch16_224",
        "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
        "TRAIN.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "4", "TOME.ENABLE", "True", "TOME.R_VALUE", "1",
        "SOLVER.MAX_EPOCH", "2", "SOLVER.OPTIMIZING_METHOD", "adamw", "SOLVER.BASE_LR", "0.001",
        "SOLVER.LR_POLICY", "cosine", "SOLVER.LAYER_DECAY", "0.75", "TRAIN.CHECKPOINT_PERIOD", "1",
        "TRAIN.EVAL_PERIOD", "1", "OUTPUT_DIR", str(out), "MODEL.NUM_CLASSES", "10", "LOG_PERIOD", "1",
        "VIDEOMAE.DROP_PATH_RATE", "0.1", "TPU.COMPUTE_DTYPE", "float32", "DATA_LOADER.NUM_WORKERS", "2",
        *extra,
    ]


def _stats(caplog, split):
    out = []
    for r in caplog.records:
        msg = r.getMessage()
        if msg.startswith("json_stats: "):
            d = json.loads(msg[len("json_stats: "):])
            if d.get("split") == split:
                out.append(d)
    return out


@pytest.mark.parametrize("extra", [(), ("EPICKITCHENS.NUM_CLASSES", "[5, 7]")], ids=["single_head", "twin_heads"])
def test_train_entry_point_two_epochs_and_auto_resume(tmp_path, caplog, monkeypatch, extra):
    """Two epochs on the synthetic dataset; then the same run cut after
    epoch 1 and resumed from its checkpoint ends at the same parameters."""
    caplog.set_level(logging.INFO)
    cfg = tcfg.get_cfg()
    cfg.merge_from_list(_train_opts(tmp_path / "whole", *extra))
    whole = train(cfg, device="cpu")
    iters, epochs, vals = (_stats(caplog, s) for s in ("train_iter", "train_epoch", "val_epoch"))
    assert len(iters) == 8 and len(epochs) == 2 and len(vals) == 2
    assert all(np.isfinite(d["loss"]) for d in iters + epochs)
    assert ("verb_loss" in iters[0]) == bool(extra)
    assert sorted(p.name for p in (tmp_path / "whole" / "checkpoints").iterdir()) == [
        "epoch_00000.pyth", "epoch_00001.pyth"]

    # the same run, stopped when the second epoch is about to start
    import vtm_torch.tools.train_net as tn

    cut = tcfg.get_cfg()
    cut.merge_from_list(_train_opts(tmp_path / "cut", *extra))
    real, calls = tn.train_epoch, []

    class Stopped(Exception):
        pass

    def one_epoch(*a, **kw):
        if calls:
            raise Stopped
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tn, "train_epoch", one_epoch)
    with pytest.raises(Stopped):
        train(cut, device="cpu")
    monkeypatch.setattr(tn, "train_epoch", real)
    last = cu.get_last_checkpoint(str(tmp_path / "cut"))
    assert last.endswith("epoch_00000.pyth")
    caplog.clear()
    resumed = train(cut, device="cpu")
    assert any("Auto-resumed" in r.getMessage() for r in caplog.records)
    assert len(_stats(caplog, "train_epoch")) == 1
    for (n, a), (_, b) in zip(whole.named_parameters(), resumed.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=1e-7, err_msg=n)


def test_train_starts_from_a_foreign_checkpoint(tmp_path, caplog, monkeypatch):
    """TRAIN.CHECKPOINT_FILE_PATH, as tools/train_net.py:473-481 takes it:
    with no checkpoint in OUTPUT_DIR the file (a head of another class
    count, keys under ``student.``, cleared by the name pattern) is loaded
    through the test loader into the parameters the optimizer holds, and
    TEST.CHECKPOINT_FILE_PATH is put back; the first step's loss equals
    that of the same module loaded directly, on the same first batch. With
    a checkpoint in OUTPUT_DIR the run resumes from it and does not read
    the file."""
    from test_torch_model_benchmark import CLEARED, foreign_checkpoint

    import vtm_torch.tools.train_net as tn
    from vtm_torch.checkpoints.checkpoint import load_test_checkpoint

    caplog.set_level(logging.INFO)
    path = tmp_path / "foreign.pyth"
    source_cfg = tcfg.get_cfg()
    source_cfg.merge_from_list(_train_opts(tmp_path / "source", "MODEL.NUM_CLASSES", "6", "RNG_SEED", "5"))
    foreign_checkpoint(path, source_cfg)
    cfg = tcfg.get_cfg()
    cfg.merge_from_list(_train_opts(tmp_path / "run", "TRAIN.CHECKPOINT_FILE_PATH", str(path), *CLEARED,
                                    "SOLVER.MAX_EPOCH", "1"))

    losses, real = [], tn.make_train_step

    def recording(*args, **kwargs):
        step = real(*args, **kwargs)

        def run(*step_args):
            out = step(*step_args)
            losses.append(float(out[0]))
            return out

        return run

    monkeypatch.setattr(tn, "make_train_step", recording)
    train(cfg, device="cpu")
    monkeypatch.setattr(tn, "make_train_step", real)
    assert cfg.TEST.CHECKPOINT_FILE_PATH == ""
    assert any(r.getMessage().startswith("Loaded torch checkpoint") for r in caplog.records)

    trainer = tn.build_trainer(cfg, "cpu")
    direct = cfg.clone()
    direct.merge_from_list(["TEST.CHECKPOINT_FILE_PATH", str(path)])
    load_test_checkpoint(direct, trainer.bundle)
    np.random.seed(cfg.RNG_SEED)
    loader = tdata.construct_loader(cfg, "train")
    tdata.shuffle_dataset(loader, 0)
    batch = next(iter(loader))
    frames, labels = (torch.as_tensor(np.asarray(batch[key])) for key in ("frames", "label"))
    loss, _, _ = trainer.train_step(frames, labels, tn._step_generator(torch.device("cpu"), cfg.RNG_SEED, 0, 0))
    assert float(loss) == losses[0]

    def not_read(*args):
        raise AssertionError("the foreign checkpoint was read though the run resumed")

    monkeypatch.setattr(tn, "load_test_checkpoint", not_read)
    caplog.clear()
    cfg.merge_from_list(["SOLVER.MAX_EPOCH", "2"])
    train(cfg, device="cpu")
    assert any("Auto-resumed" in r.getMessage() for r in caplog.records)
    assert len(_stats(caplog, "train_epoch")) == 1


def test_checkpoint_round_trip_gives_the_same_next_step(tmp_path):
    _, tc = _cfgs(_solver_opts("adamw"))
    video, labels = torch.from_numpy(_video(2, 7)), torch.from_numpy(_labels(7, 2, 8))
    _, _, a = _pair(7, seed=3)
    opt_a, _ = topt.construct_optimizer(tc, a, num_layers=ARCH["depth"])
    step_a = make_train_step(a, opt_a, "cross_entropy", False)
    step_a(video, labels)
    assert cu.get_last_checkpoint(str(tmp_path)) is None
    cu.save_checkpoint(str(tmp_path), a, opt_a, 4, tc)
    cu.save_checkpoint(str(tmp_path), a, None, 11)
    path = cu.get_last_checkpoint(str(tmp_path))
    assert path.endswith("epoch_00011.pyth")

    _, _, b = _pair(7, seed=4)
    opt_b, _ = topt.construct_optimizer(tc, b, num_layers=ARCH["depth"])
    epoch, restored = cu.load_checkpoint(path, b, opt_b)
    assert (epoch, restored) == (11, False)
    epoch, restored = cu.load_checkpoint(str(tmp_path / "checkpoints" / "epoch_00004.pyth"), b, opt_b)
    assert (epoch, restored) == (4, True)
    la, _, _ = step_a(video, labels)
    lb, _, _ = make_train_step(b, opt_b, "cross_entropy", False)(video, labels)
    assert la.item() == lb.item()
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    logits = make_eval_step(b)(video)
    assert not b.training and logits.shape == (2, 7) and not logits.requires_grad


def test_what_is_not_ported_raises(tmp_path):
    cfg = tcfg.get_cfg()
    cfg.merge_from_list(["MODEL.MODEL_NAME", "VideoMAE", "VIDEOMAE.MODEL", "vit_small_patch16_224"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train(cfg)  # no card here, and the CPU was not asked for
    c = cfg.clone()
    c.merge_from_list(["SOLVER.OPTIMIZING_METHOD", "lamb"])
    with pytest.raises(NotImplementedError):
        topt.construct_optimizer(c, torch.nn.Linear(2, 2))
    # LARS is ported (tests/test_torch_contrastive_train_net.py): its groups build
    c = cfg.clone()
    c.merge_from_list(["SOLVER.LARS_ON", "True"])
    assert [g["lars"] for g in topt.construct_optimizer(c, torch.nn.Linear(2, 2))[0].param_groups] == [True]
    # the BatchNorm group is ported: its parameters take BN.WEIGHT_DECAY
    bn = torch.nn.Module()
    bn.a_bn = torch.nn.BatchNorm1d(2)
    c = cfg.clone()
    c.merge_from_list(["BN.WEIGHT_DECAY", "0.5", "SOLVER.ZERO_WD_1D_PARAM", "True"])
    assert [g["weight_decay"] for g in topt.construct_optimizer(c, bn)[0].param_groups] == [0.5]
    # TENSORBOARD.ENABLE is ported (tests/test_torch_vis_tail.py::test_train_writes_vtms_scalars);
    # so is tensor parallelism for Motionformer (tests/test_torch_parallel_tp_motionformer.py):
    # called in one process it needs the model group's processes
    c = cfg.clone()
    c.merge_from_list(["TPU.MODEL_PARALLEL", "2", "MODEL.MODEL_NAME", "Motionformer"])
    with pytest.raises(ValueError, match="needs 2 processes"):
        train(c, device="cpu")
    # detection is ported (tests/test_torch_ava_detection.py): VideoMAE has no
    # detection head, and its build raises as vtm's does
    c = cfg.clone()
    c.merge_from_list(["DETECTION.ENABLE", "True"])
    with pytest.raises(TypeError, match="no detection head"):
        train(c, device="cpu")
    # multigrid is ported (tests/test_torch_multigrid.py): the long cycle
    # builds its schedule and trains one tiny epoch at its shape (T 4, B4)
    c = tcfg.get_cfg()
    c.merge_from_list(ptv_opts(
        "r2plus1d", "TRAIN.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "2", "SOLVER.OPTIMIZING_METHOD", "sgd",
        "SOLVER.LR_POLICY", "steps_with_relative_lrs", "SOLVER.STEPS", "[0, 1]", "SOLVER.LRS", "[1, 0.1]",
        "SOLVER.MAX_EPOCH", "1", "MULTIGRID.LONG_CYCLE", "True", "MULTIGRID.LONG_CYCLE_FACTORS", "[(0.5, 1.0)]",
        "MULTIGRID.EPOCH_FACTOR", "1.0", "TRAIN.EVAL_PERIOD", "100", "TRAIN.CHECKPOINT_PERIOD", "100",
        "TRAIN.AUTO_RESUME", "False", "DATA_LOADER.NUM_WORKERS", "0", "OUTPUT_DIR", str(tmp_path)))
    start = {n: p.detach().clone() for n, p in build_model(c, "cpu", fp32_params=True).module.named_parameters()}
    trained = train(c, device="cpu")
    assert (c.SOLVER.MAX_EPOCH, c.SOLVER.STEPS, c.DATA.NUM_FRAMES, c.TRAIN.BATCH_SIZE) == (1, [0, 1, 1], 4, 4)
    assert trained.head.pool_size == ((1, 1, 1),) and c.BN.NORM_TYPE == "sync_batchnorm"
    assert all(bool(torch.isfinite(p).all()) for p in trained.parameters())
    assert not torch.equal(trained.stem_conv.weight, start["stem_conv.weight"])
    c = cfg.clone()
    c.merge_from_list(["VIDEOMAE.ATTN_DROP_RATE", "0.1"])
    with pytest.raises(NotImplementedError, match="ATTN_DROP_RATE"):
        build_model(c, "cpu", fp32_params=True)
    c = cfg.clone()
    c.merge_from_list(["MODEL.MODEL_NAME", "Motionformer", "MOTIONFORMER.ATTN_LAYER", "divided",
                       "MOTIONFORMER.EMBED_DIM", "32", "MOTIONFORMER.DEPTH", "2", "MOTIONFORMER.NUM_HEADS", "2",
                       "MOTIONFORMER.TEMPORAL_RESOLUTION", "2", "DATA.TRAIN_CROP_SIZE", "32", "MODEL.NUM_CLASSES", "7"])
    divided = build_model(c, "cpu", fp32_params=True).module  # divided attention is ported: it trains
    assert all(p.dtype == torch.float32 for p in divided.parameters())
    before = {n: p.detach().clone() for n, p in divided.named_parameters()}
    opt_d, _ = topt.construct_optimizer(c, divided, num_layers=2)
    loss_d, _, _ = make_train_step(divided, opt_d, "cross_entropy", False)(
        torch.randn(2, 4, 32, 32, 3, generator=torch.Generator().manual_seed(0)), torch.tensor([1, 5]))
    assert np.isfinite(loss_d.item())
    for n in ("blocks.0.timeattn.qkv.weight", "blocks.1.norm3.weight", "blocks.1.attn.proj.weight"):
        assert not torch.equal(dict(divided.named_parameters())[n], before[n]), n
    # the BatchNorm step is ported (tests/test_torch_slowfast_train.py): it builds
    assert callable(make_train_step(torch.nn.Linear(2, 2), None, "cross_entropy", False))
    import vtm_torch.train.train_step as ts

    # the masked steps are ported (tests/test_torch_masked_train.py): they build
    assert callable(ts.make_mae_train_step(torch.nn.Linear(2, 2), None))
    assert callable(ts.make_maskfeat_train_step(torch.nn.Linear(2, 2), None))
    # the contrastive step is ported (tests/test_torch_contrastive_train.py): it builds
    assert callable(ts.make_contrastive_train_step(torch.nn.Linear(2, 2), None))
    # the detection steps are ported (tests/test_torch_ava_detection.py): they
    # build, and an unknown loss raises as in vtm
    assert callable(ts.make_detection_train_step(torch.nn.Linear(2, 2), None, "bce_logit"))
    assert callable(ts.make_detection_eval_step(torch.nn.Linear(2, 2)))
    with pytest.raises(NotImplementedError):
        ts.make_detection_train_step(None, None, "bce")
