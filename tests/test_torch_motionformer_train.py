"""The port's Motionformer training path against the JAX package's, on the
CPU in fp32 at a tiny size: loss, matching, gradients, optimizer steps,
the fp32-parameter layout, and the train entry point end to end.

Weights come from a random upstream-layout state dict made with numpy
(``test_torch_motionformer._upstream_sd``), through ``convert_motionformer`` (JAX params) and back through
``motionformer_state_dict_from_vtm_params`` (the port's state dict);
gradients and updated parameters come back the same way.
"""

import json
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vtm.config as jcfg
import vtm.train.losses as jlosses
import vtm.train.optimizer as jopt
from vtm.checkpoints.convert import convert_motionformer
from vtm.merge import bipartite as jb
from vtm.merge.policy import MergePolicy as JPolicy
from vtm.models.motionformer import Motionformer as JMotionformer
from vtm.models.motionformer import MotionformerConfig as JConfig
from vtm.train.train_step import make_train_step as jax_make_train_step

from test_torch_motionformer import _upstream_sd

import vtm_torch.config as tcfg
import vtm_torch.train.losses as tlosses
import vtm_torch.train.optimizer as topt
from vtm_torch.checkpoints import checkpoint as cu
from vtm_torch.checkpoints.convert import motionformer_state_dict_from_vtm_params
from vtm_torch.merge import bipartite as tb
from vtm_torch.merge.policy import MergePolicy
from vtm_torch.models import build_model
from vtm_torch.models.motionformer import Motionformer, MotionformerConfig
from vtm_torch.tools.train_net import build_trainer, train
from vtm_torch.train.train_step import make_train_step

torch.set_num_threads(2)

# 3 layers, 4 frames after the tubelet, 16 tokens each (8 raw frames of 64x64)
ARCH = dict(
    img_size=64, patch_size=16, patch_size_temp=2, embed_dim=32, depth=3, num_heads=2,
    mlp_ratio=2.0, temporal_resolution=4, use_mlp=True,
)
R = 3  # per pseudo-frame
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4   # of the largest entry of each gradient tensor
# A gradient that is zero analytically (the k half of proj_kv's bias: the
# temporal softmax over frames does not see a shift of its logits) is
# rounding noise of about 1e-11 in both packages.
GRAD_NOISE = 1e-9
PARAM_TOL = 1e-5  # after three optimizer steps


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch, r, train_mode, prop_attn=True, seed=0):
    """The same Motionformer in both packages, fp32 parameters."""
    depth = arch["depth"]
    kw = dict(rs=(r,) * depth, mode="merge" if r else "none", prop_attn=prop_attn)
    params = _np_tree(convert_motionformer(_upstream_sd(arch, seed), depth=depth))
    jmodel = JMotionformer(config=JConfig(**arch), policy=JPolicy(**kw), train_mode=train_mode)
    tmodel = Motionformer(MotionformerConfig(**arch), policy=MergePolicy(**kw), train_mode=train_mode,
                          fp32_params=True)
    tmodel.load_state_dict(motionformer_state_dict_from_vtm_params(params))
    return jmodel, params, tmodel


def _video(arch, batch, seed):
    frames = arch["temporal_resolution"] * arch["patch_size_temp"]
    shape = (batch, frames, arch["img_size"], arch["img_size"], 3)
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
        out, _ = jmodel.apply({"params": p}, frames)
        if multi_head:
            return 0.5 * (jlosses.cross_entropy(out[0], labels["verb"])
                          + jlosses.cross_entropy(out[1], labels["noun"]))
        return jlosses.cross_entropy(out, labels)

    return loss


def _torch_loss(tmodel, multi_head, frames, labels):
    out, _ = tmodel(frames)
    if multi_head:
        return tlosses.epic_dual_loss(tlosses.cross_entropy, out, labels)
    return tlosses.cross_entropy(out, labels)


@pytest.mark.parametrize(
    "train_mode,num_classes,r,overrides",
    [
        (True, 7, R, {}),
        (True, (5, 6), R, {}),
        (True, 7, 0, {}),
        (True, 7, R, dict(use_original_code=False)),
        (True, (5, 6), 0, dict(use_original_code=False)),
        (False, 7, R, {}),
        (False, (5, 6), R, {}),
        (True, 7, R, dict(attn_layer="joint")),
        (True, 7, R, dict(pos_embed_type="joint", head_act="gelu")),
        (True, 7, R, dict(patch_size_temp=1, head_act="relu")),
    ],
    ids=["logits", "logits_twin_heads", "logits_unmerged", "logits_own_values", "twin_unmerged_own_values",
         "probabilities", "probabilities_twin_heads", "joint_attention", "joint_pos_embed_gelu",
         "patch_embed_2d_relu"],
)
def test_loss_matching_and_gradients_match_vtm(train_mode, num_classes, r, overrides):
    """``train_mode=True`` hands logits to the loss; ``False`` is the model
    as ``build_model`` makes it in both packages, which hands it
    probabilities."""
    arch = dict(ARCH, num_classes=num_classes, **overrides)
    multi_head = isinstance(num_classes, tuple)
    jmodel, params, tmodel = _pair(arch, r, train_mode)
    video, labels = _video(arch, 2, 1), _labels(num_classes, 2, 2)

    with jax.default_matmul_precision("highest"):
        want_loss, want_grads = jax.jit(jax.value_and_grad(_jax_loss(jmodel, multi_head)))(
            params, jnp.asarray(video), _to_jax(labels)
        )
        (want_out, _), inter = jax.jit(lambda p, v: jmodel.apply({"params": p}, v, capture_intermediates=True))(
            params, jnp.asarray(video))
    metrics = []
    hooks = [b.attn.register_forward_hook(lambda m, i, o: metrics.append(o[1])) for b in tmodel.blocks]
    tmodel.train()  # no dropout anywhere: training mode changes nothing
    out, _ = tmodel(torch.from_numpy(video))
    loss = _torch_loss(tmodel, multi_head, torch.from_numpy(video), _to_torch(labels))
    loss.backward()
    for hk in hooks:
        hk.remove()

    first = out[0] if multi_head else out
    sums = first.sum(dim=-1).detach().numpy()
    if train_mode:
        assert np.abs(sums - 1).max() > 1e-3  # raw logits
    else:
        np.testing.assert_allclose(sums, 1.0, rtol=1e-5)  # probabilities
    np.testing.assert_allclose(first.detach().numpy(), np.asarray(want_out[0] if multi_head else want_out),
                               rtol=1e-5, atol=1e-5)
    assert abs(loss.item() - float(want_loss)) <= LOSS_TOL
    if r:
        for i in range(arch["depth"]):
            jmetric = inter["intermediates"][f"blocks_{i}"]["attn"]["__call__"][0][1]
            mj = jb.bipartite_soft_matching(jmetric, r)
            mt = tb.bipartite_soft_matching(metrics[i], r)
            for name in ("unm_idx", "src_idx", "dst_idx"):
                idx = getattr(mt, name)
                assert not idx.requires_grad and not idx.dtype.is_floating_point
                np.testing.assert_array_equal(idx.numpy(), np.asarray(getattr(mj, name)), err_msg=f"{i} {name}")
    want = {k: v.numpy() for k, v in motionformer_state_dict_from_vtm_params(_np_tree(want_grads)).items()}
    named = dict(tmodel.named_parameters())
    assert sorted(want) == sorted(named)
    d = arch["embed_dim"]
    for name, p in named.items():
        if name == "pos_embed" and arch.get("pos_embed_type") == "joint":
            # created in both packages, used by neither: no gradient here, zeros there
            assert p.grad is None and not np.any(want[name])
            continue
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        tol = max(GRAD_TOL * np.abs(want[name]).max(), GRAD_NOISE)
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=0, atol=tol, err_msg=name)
        if "proj_kv" in name and arch.get("use_original_code", True):
            # the v half of proj_kv is never used: a zero gradient, not None
            assert torch.count_nonzero(p.grad[d:]) == 0 and not np.any(want[name][d:]), name
            if name == "blocks.0.attn.proj_kv.weight":
                assert torch.count_nonzero(p.grad[:d]) > 0


def _solver_opts(extra=()):
    return [
        "MODEL.MODEL_NAME", "Motionformer", "SOLVER.OPTIMIZING_METHOD", "adamw",
        "SOLVER.BASE_LR", "0.001", "SOLVER.LR_POLICY", "cosine", "SOLVER.MAX_EPOCH", "4",
        "SOLVER.COSINE_END_LR", "1e-6", "SOLVER.WEIGHT_DECAY", "0.05", "SOLVER.LAYER_DECAY", "0.75",
        "SOLVER.ZERO_WD_1D_PARAM", "True", *extra,
    ]


def _cfgs(opts):
    jc, tc = jcfg.get_cfg(), tcfg.get_cfg()
    jc.merge_from_list(list(opts))
    tc.merge_from_list(list(opts))
    return jc, tc


@pytest.mark.parametrize(
    "train_mode,num_classes,r,overrides",
    [
        (True, 7, R, {}),
        (True, (5, 6), R, {}),
        (False, 7, R, {}),
        (True, 7, 0, dict(use_original_code=False)),
    ],
    ids=["logits", "logits_twin_heads", "probabilities", "unmerged_own_values"],
)
def test_three_adamw_steps_match_vtm(train_mode, num_classes, r, overrides):
    """construct_optimizer in both packages (Motionformer's zero-wd name
    set, layer decay 0.75, a cosine schedule that changes the lr every
    step), three steps on three batches: parameters within PARAM_TOL,
    the unused v half of proj_kv included (zero gradient, decayed)."""
    arch = dict(ARCH, num_classes=num_classes, **overrides)
    multi_head = isinstance(num_classes, tuple)
    jc, tc = _cfgs(_solver_opts())
    jmodel, params, tmodel = _pair(arch, r, train_mode, seed=1)
    depth = arch["depth"]

    tx, jlr_at = jopt.construct_optimizer(jc, params, num_layers=depth)
    opt_state = tx.init(params)
    jstep = jax_make_train_step(jmodel, tx, "cross_entropy", multi_head)
    optimizer, lr_at = topt.construct_optimizer(tc, tmodel, num_layers=depth)
    tstep = make_train_step(tmodel, optimizer, "cross_entropy", multi_head)

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    for i in range(3):
        epoch = i / 3.0
        assert lr_at(epoch) == jlr_at(epoch)
        video, labels = _video(arch, 2, 10 + i), _labels(num_classes, 2, 20 + i)
        jopt.set_lr(opt_state, jlr_at(epoch))
        with jax.default_matmul_precision("highest"):
            jparams, opt_state, jloss, _, jaux = jstep(
                jparams, opt_state, jnp.asarray(video), _to_jax(labels), jax.random.key(i)
            )
        topt.set_lr(optimizer, lr_at(epoch))
        loss, _, aux = tstep(torch.from_numpy(video), _to_torch(labels))
        assert abs(loss.item() - float(jloss)) <= 1e-4, i
        assert len(aux) == len(jaux)
    want = {k: v.numpy() for k, v in motionformer_state_dict_from_vtm_params(_np_tree(jparams)).items()}
    start = motionformer_state_dict_from_vtm_params(params)
    moved = 0.0
    d = arch["embed_dim"]
    lr_sum = sum(lr_at(i / 3.0) for i in range(3))
    for name, p in tmodel.named_parameters():
        got = p.detach().numpy()
        diff = np.abs(got - want[name])
        # Adam divides a gradient by its own size: where the gradient is zero
        # analytically (the k third of qkv.bias and the k half of proj_kv.bias:
        # a softmax does not see a shift of its logits) it normalises rounding
        # noise, and each package takes its own walk of at most lr per step
        noise = np.zeros(got.shape, bool)
        if name.endswith("attn.qkv.bias"):
            noise[d:2 * d] = True
        elif name.endswith("attn.proj_kv.bias"):
            noise[:d] = True
        assert diff[noise].max(initial=0.0) <= 2 * lr_sum, name
        # the same holds for a stray entry whose gradient is of the size of
        # its own rounding error: one entry of a tensor, or one in 10,000
        off = (diff > PARAM_TOL) & ~noise
        assert off.sum() <= max(1, got.size // 10_000) and diff[off].max(initial=0.0) <= 2 * lr_sum, (
            name, off.sum())
        moved = max(moved, (p.detach() - start[name]).abs().max().item())
    assert moved > 1e-4  # the steps did something


def test_zero_wd_set_and_layer_ids_match_vtm_on_every_parameter():
    jc, tc = _cfgs(_solver_opts())
    arch = dict(ARCH, num_classes=(5, 6))
    _, params, tmodel = _pair(arch, R, True)
    depth = arch["depth"]
    flat, structure = jax.tree_util.tree_flatten_with_path(params)

    def named(fn):
        tree = jax.tree_util.tree_unflatten(
            structure, [np.full(np.shape(x), float(fn(p, x)), np.float32) for p, x in flat])
        return motionformer_state_dict_from_vtm_params(tree)

    jwd = named(lambda p, x: jopt._is_zero_wd(jc, p, x))
    jid = named(lambda p, x: jopt._layer_id(p, depth))
    for name, p in tmodel.named_parameters():
        assert float(topt._is_zero_wd(tc, name, p)) == jwd[name].flatten()[0].item(), name
        assert float(topt._layer_id(name, depth)) == jid[name].flatten()[0].item(), name
    for name in ("cls_token", "pos_embed", "temp_embed"):
        assert topt._is_zero_wd(tc, name, dict(tmodel.named_parameters())[name])


@pytest.mark.parametrize("original", [True, False], ids=["original_code", "own_values"])
@pytest.mark.parametrize("num_classes", [7, (5, 6)], ids=["single_head", "twin_heads"])
def test_fp32_params_forward_is_bit_identical_to_precast_bf16(original, num_classes):
    """Training keeps fp32 parameters and casts them at use; serving casts
    them once. Same seed, same clip: the bf16 forwards agree bit for bit."""
    arch = dict(ARCH, num_classes=num_classes, use_original_code=original)
    policy = MergePolicy(rs=(R,) * arch["depth"], mode="merge", prop_attn=True)
    kw = dict(policy=policy, dtype=torch.bfloat16, seed=5)
    serve = Motionformer(MotionformerConfig(**arch), **kw).eval()
    fit = Motionformer(MotionformerConfig(**arch), fp32_params=True, **kw).eval()
    assert all(p.dtype == torch.float32 for p in fit.parameters())
    assert serve.blocks[0].attn.proj_kv.weight.dtype == torch.bfloat16
    video = torch.from_numpy(_video(arch, 2, 6))
    with torch.no_grad():
        a, sa = serve(video)
        b, sb = fit(video)
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        assert x.dtype == torch.float32 and torch.equal(x, y)
    assert torch.equal(sa.size, sb.size)


def test_bf16_compute_gives_fp32_gradients_for_every_parameter():
    arch = dict(ARCH, num_classes=7)
    policy = MergePolicy(rs=(R,) * arch["depth"], mode="merge", prop_attn=True)
    model = Motionformer(MotionformerConfig(**arch), policy=policy, dtype=torch.bfloat16,
                         train_mode=True, fp32_params=True)
    logits, _ = model(torch.from_numpy(_video(arch, 2, 3)), generator=torch.Generator().manual_seed(0))
    tlosses.cross_entropy(logits, torch.from_numpy(_labels(7, 2, 4))).backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all(), name


def _train_opts(out, *extra):
    return [
        "MODEL.MODEL_NAME", "Motionformer", "MODEL.ARCH", "motionformer", "MOTIONFORMER.EMBED_DIM", "32",
        "MOTIONFORMER.DEPTH", "2", "MOTIONFORMER.NUM_HEADS", "2", "MOTIONFORMER.MLP_RATIO", "2",
        "MOTIONFORMER.TEMPORAL_RESOLUTION", "2", "MOTIONFORMER.USE_MLP", "True",
        "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
        "TRAIN.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "4", "TOME.ENABLE", "True", "TOME.R_VALUE", "1",
        "TOME.PROP_ATTN", "True", "SOLVER.MAX_EPOCH", "2", "SOLVER.OPTIMIZING_METHOD", "adamw",
        "SOLVER.BASE_LR", "0.001", "SOLVER.LR_POLICY", "steps_with_relative_lrs", "SOLVER.LRS", "[1, 0.1]",
        "SOLVER.STEPS", "[0, 1]", "SOLVER.LAYER_DECAY", "0.75", "TRAIN.CHECKPOINT_PERIOD", "1",
        "TRAIN.EVAL_PERIOD", "1", "OUTPUT_DIR", str(out), "MODEL.NUM_CLASSES", "10", "LOG_PERIOD", "1",
        "TPU.COMPUTE_DTYPE", "float32", "DATA_LOADER.NUM_WORKERS", "2",
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
    """Two epochs of a tiny Motionformer on the synthetic dataset; then the
    same run cut after epoch 1 and resumed from its checkpoint ends at
    the same parameters."""
    caplog.set_level(logging.INFO)
    cfg = tcfg.get_cfg()
    cfg.merge_from_list(_train_opts(tmp_path / "whole", *extra))
    whole = train(cfg, device="cpu")
    assert isinstance(whole, Motionformer) and whole.config.multi_head == bool(extra)
    assert all(p.dtype == torch.float32 for p in whole.parameters())
    iters, epochs, vals = (_stats(caplog, s) for s in ("train_iter", "train_epoch", "val_epoch"))
    assert len(iters) == 8 and len(epochs) == 2 and len(vals) == 2
    assert all(np.isfinite(d["loss"]) for d in iters + epochs)
    assert ("verb_loss" in iters[0]) == bool(extra)
    assert sorted(p.name for p in (tmp_path / "whole" / "checkpoints").iterdir()) == [
        "epoch_00000.pyth", "epoch_00001.pyth"]

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
    assert cu.get_last_checkpoint(str(tmp_path / "cut")).endswith("epoch_00000.pyth")
    caplog.clear()
    resumed = train(cut, device="cpu")
    assert any("Auto-resumed" in r.getMessage() for r in caplog.records)
    assert len(_stats(caplog, "train_epoch")) == 1
    for (n, a), (_, b) in zip(whole.named_parameters(), resumed.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=1e-7, err_msg=n)


def test_build_model_keeps_the_softmax_head_like_vtm(tmp_path):
    """``build_model`` sets no ``train_mode`` (nor does the JAX package's
    build function), so the trainer's loss sees probabilities; layer decay takes
    the depth from the config; the zero-wd name set reaches the groups."""
    cfg = tcfg.get_cfg()
    cfg.merge_from_list(_train_opts(tmp_path, "SOLVER.WEIGHT_DECAY", "0.05"))
    bundle = build_model(cfg, "cpu", fp32_params=True)
    assert bundle.name == "Motionformer" and bundle.module.train_mode is False
    assert all(p.dtype == torch.float32 for p in bundle.module.parameters())
    trainer = build_trainer(cfg, device="cpu")
    video = torch.from_numpy(_video(dict(ARCH, img_size=32, temporal_resolution=2), 4, 0))
    probs = trainer.eval_step(video)
    np.testing.assert_allclose(probs.sum(dim=-1).numpy(), 1.0, rtol=1e-5)
    loss, out, _ = trainer.train_step(video, torch.from_numpy(_labels(10, 4, 1)))
    np.testing.assert_allclose(out.sum(dim=-1).numpy(), 1.0, rtol=1e-5)
    # cross-entropy over probabilities in [0, 1] stays near log(classes)
    assert abs(loss.item() - np.log(10)) < 0.2
    by_param = {id(p): g for g in trainer.optimizer.param_groups for p in g["params"]}
    named = dict(trainer.module.named_parameters())
    depth = cfg.MOTIONFORMER.DEPTH
    assert by_param[id(named["temp_embed"])]["weight_decay"] == 0.0
    assert by_param[id(named["blocks.1.attn.proj_kv.weight"])]["weight_decay"] == 0.05
    assert by_param[id(named["blocks.1.attn.proj_kv.weight"])]["lr_scale"] == pytest.approx(0.75 ** (depth + 1 - 2))
    assert by_param[id(named["patch_embed_3d.proj.weight"])]["lr_scale"] == pytest.approx(0.75 ** (depth + 1))


def test_train_needs_cuda_unless_the_cpu_is_asked_for(tmp_path):
    cfg = tcfg.get_cfg()
    cfg.merge_from_list(_train_opts(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        train(cfg)
