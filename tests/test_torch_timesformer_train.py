"""The port's TimeSformer training path against the JAX package's, on the
CPU in fp32 at a small size: loss, matching, gradients, optimizer steps,
the fp32-parameter layout, and the train entry point.

Weights come from a random HuggingFace-layout state dict made with numpy
(``test_torch_timesformer._hf_sd``), loaded into both packages; gradients
and updated parameters come back through
``timesformer_state_dict_from_vtm_params``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vtm.config as jcfg
import vtm.train.losses as jlosses
import vtm.train.optimizer as jopt
from vtm.merge import bipartite as jb
from vtm.train.train_step import make_train_step as jax_make_train_step

from test_torch_timesformer import ATTENTION_TYPES, _models, _video

import vtm_torch.config as tcfg
import vtm_torch.train.losses as tlosses
import vtm_torch.train.optimizer as topt
from vtm_torch.checkpoints import checkpoint as cu
from vtm_torch.checkpoints.convert import timesformer_state_dict_from_vtm_params
from vtm_torch.merge import bipartite as tb
from vtm_torch.merge.policy import MergePolicy
from vtm_torch.models.timesformer import TimeSformer, TimeSformerConfig
from vtm_torch.tools.train_net import build_trainer, train
from vtm_torch.train.train_step import make_train_step

torch.set_num_threads(2)

# 3 layers, width 64, 4 frames of 16 patches (64x64)
ARCH = dict(img_size=64, patch_size=16, embed_dim=64, depth=3, num_heads=2, mlp_ratio=2.0, num_frames=4)
R = 3  # per frame
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4   # of the largest entry of each gradient tensor
PARAM_TOL = 1e-5  # after three optimizer steps
# The k third of every fused qkv bias has a gradient that is zero
# analytically: q . (k + b) shifts a whole row of logits, which a softmax
# does not see (with the row mask too). It is rounding noise in both packages.
ZERO_GRADIENTS = ("attn.qkv.bias",)  # matches temporal_attn.qkv.bias as well


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch, r, prop_attn=True, seed=0):
    depth = arch["depth"]
    kw = dict(rs=(r,) * depth, mode="merge" if r else "none", prop_attn=prop_attn)
    params, jmodel, tmodel = _models(arch, kw, seed=seed)
    twin = TimeSformer(TimeSformerConfig(**arch), policy=MergePolicy(**kw), fp32_params=True)
    twin.load_state_dict(tmodel.state_dict())
    return jmodel, _np_tree(params), twin


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


@pytest.mark.parametrize(
    "num_classes,r,prop_attn,attention_type",
    [
        (7, R, True, "divided_space_time"),
        ((5, 6), R, True, "divided_space_time"),
        (7, R, False, "divided_space_time"),
        (7, 0, True, "divided_space_time"),
        (7, R, True, "space_only"),
        (7, R, True, "joint_space_time"),
    ],
    ids=["merged", "twin_heads", "no_prop_attn", "unmerged", "space_only", "joint_space_time"],
)
def test_loss_matching_and_gradients_match_vtm(num_classes, r, prop_attn, attention_type):
    arch = dict(ARCH, num_classes=num_classes, attention_type=attention_type)
    divided = attention_type == ATTENTION_TYPES[0]
    multi_head = isinstance(num_classes, tuple)
    jmodel, params, tmodel = _pair(arch, r, prop_attn)
    video, labels = _video(arch, 2, 1), _labels(num_classes, 2, 2)

    with jax.default_matmul_precision("highest"):
        want_loss, want_grads = jax.jit(jax.value_and_grad(_jax_loss(jmodel, multi_head)))(
            params, jnp.asarray(video), _to_jax(labels)
        )
        _, inter = jmodel.apply({"params": params}, jnp.asarray(video), capture_intermediates=True)
    metrics = []
    hooks = [b.attn.register_forward_hook(lambda m, i, o: metrics.append(o)) for b in tmodel.blocks]
    tmodel.train()  # no dropout anywhere: training mode changes nothing
    out, _ = tmodel(torch.from_numpy(video))
    for hk in hooks:
        hk.remove()
    if multi_head:
        loss = tlosses.epic_dual_loss(tlosses.cross_entropy, out, _to_torch(labels))
    else:
        loss = tlosses.cross_entropy(out, _to_torch(labels))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= LOSS_TOL
    if r and divided:
        for i in range(arch["depth"]):
            jmetric = inter["intermediates"][f"blocks_{i}"]["attn"]["__call__"][0][1]
            mj = jb.bipartite_soft_matching(jmetric, r)
            mt = tb.bipartite_soft_matching(metrics[i][1], r)
            for name in ("unm_idx", "src_idx", "dst_idx"):
                idx = getattr(mt, name)
                assert not idx.requires_grad and not idx.dtype.is_floating_point
                np.testing.assert_array_equal(idx.numpy(), np.asarray(getattr(mj, name)), err_msg=f"{i} {name}")
    want = {k: v.numpy() for k, v in timesformer_state_dict_from_vtm_params(_np_tree(want_grads)).items()}
    named = dict(tmodel.named_parameters())
    # the JAX package's converter hands every model the image-ViT rule's
    # temporal entries; a model without temporal attention never reads them
    assert set(named) <= set(want) and (set(named) == set(want)) == divided
    largest = max(np.abs(want[n]).max() for n in named)
    d = arch["embed_dim"]
    for name, p in named.items():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        got, ref = p.grad.numpy(), want[name]
        if any(z in name for z in ZERO_GRADIENTS):
            assert max(np.abs(got[d:2 * d]).max(), np.abs(ref[d:2 * d]).max()) <= 1e-6 * largest, name
            got, ref = np.delete(got, np.s_[d:2 * d]), np.delete(ref, np.s_[d:2 * d])
        np.testing.assert_allclose(got, ref, rtol=0, atol=GRAD_TOL * np.abs(ref).max(), err_msg=name)


def _solver_opts(*extra):
    """The shipped configs' optimizer (SGD, momentum 0.9, weight decay 1e-4,
    ``steps_with_relative_lrs``), here with a step at every epoch."""
    return ["MODEL.MODEL_NAME", "TimeSformer", "SOLVER.OPTIMIZING_METHOD", "sgd", "SOLVER.MOMENTUM", "0.9",
            "SOLVER.BASE_LR", "0.05", "SOLVER.LR_POLICY", "steps_with_relative_lrs", "SOLVER.LRS", "[1, 0.1, 0.01]",
            "SOLVER.STEPS", "[0, 1, 2]", "SOLVER.MAX_EPOCH", "3", "SOLVER.WEIGHT_DECAY", "0.0001", *extra]


def _cfgs(opts):
    jc, tc = jcfg.get_cfg(), tcfg.get_cfg()
    jc.merge_from_list(list(opts))
    tc.merge_from_list(list(opts))
    return jc, tc


@pytest.mark.parametrize("num_classes,r", [(7, R), ((5, 6), R), (7, 0)], ids=["merged", "twin_heads", "unmerged"])
def test_three_sgd_steps_match_vtm(num_classes, r):
    """construct_optimizer in both packages, three steps on three batches
    with the learning rate stepping down each time: losses within 1e-4,
    parameters within PARAM_TOL."""
    arch = dict(ARCH, num_classes=num_classes)
    multi_head = isinstance(num_classes, tuple)
    jc, tc = _cfgs(_solver_opts())
    jmodel, params, tmodel = _pair(arch, r, seed=1)
    depth = arch["depth"]
    tx, jlr_at = jopt.construct_optimizer(jc, params, num_layers=depth)
    opt_state = tx.init(params)
    jstep = jax_make_train_step(jmodel, tx, "cross_entropy", multi_head)
    optimizer, lr_at = topt.construct_optimizer(tc, tmodel, num_layers=depth)
    tstep = make_train_step(tmodel, optimizer, "cross_entropy", multi_head)
    start = {k: v.clone() for k, v in tmodel.state_dict().items()}
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    for i in range(3):
        epoch = float(i)
        assert lr_at(epoch) == jlr_at(epoch) == 0.05 * (1, 0.1, 0.01)[i]
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
    want = {k: v.numpy() for k, v in timesformer_state_dict_from_vtm_params(_np_tree(jparams)).items()}
    moved = 0.0
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0, atol=PARAM_TOL, err_msg=name)
        moved = max(moved, (p.detach() - start[name]).abs().max().item())
    assert moved > 1e-4  # the steps did something


def test_zero_wd_set_and_layer_ids_match_vtm_on_every_parameter():
    """TimeSformer has no no-weight-decay name set: its class token and
    embeddings are decayed; layer ids follow ``blocks.{i}``."""
    jc, tc = _cfgs(_solver_opts("SOLVER.ZERO_WD_1D_PARAM", "True", "SOLVER.LAYER_DECAY", "0.75"))
    arch = dict(ARCH, num_classes=(5, 6))
    _, params, tmodel = _pair(arch, R)
    depth = arch["depth"]
    flat, structure = jax.tree_util.tree_flatten_with_path(params)

    def named(fn):
        tree = jax.tree_util.tree_unflatten(
            structure, [np.full(np.shape(x), float(fn(p, x)), np.float32) for p, x in flat])
        return timesformer_state_dict_from_vtm_params(tree)

    jwd = named(lambda p, x: jopt._is_zero_wd(jc, p, x))
    jid = named(lambda p, x: jopt._layer_id(p, depth))
    for name, p in tmodel.named_parameters():
        assert float(topt._is_zero_wd(tc, name, p)) == jwd[name].flatten()[0].item(), name
        assert float(topt._layer_id(name, depth)) == jid[name].flatten()[0].item(), name
    assert not topt._is_zero_wd(tc, "pos_embed", tmodel.pos_embed)
    assert topt._layer_id("blocks.2.temporal_fc.weight", depth) == 3


@pytest.mark.parametrize("num_classes", [7, (5, 6)], ids=["single_head", "twin_heads"])
def test_fp32_params_forward_is_bit_identical_to_precast_bf16(num_classes):
    """Training keeps fp32 parameters and casts them at use; serving casts
    them once. Same seed, same clip: the bf16 forwards agree bit for bit."""
    arch = dict(ARCH, num_classes=num_classes)
    policy = MergePolicy(rs=(R,) * arch["depth"], mode="merge", prop_attn=True)
    kw = dict(policy=policy, dtype=torch.bfloat16, seed=5)
    serve = TimeSformer(TimeSformerConfig(**arch), **kw).eval()
    fit = TimeSformer(TimeSformerConfig(**arch), fp32_params=True, **kw).eval()
    assert all(p.dtype == torch.float32 for p in fit.parameters())
    assert serve.blocks[0].temporal_attn.qkv.weight.dtype == torch.bfloat16
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
    model = TimeSformer(TimeSformerConfig(**arch), policy=policy, dtype=torch.bfloat16, fp32_params=True)
    logits, _ = model(torch.from_numpy(_video(arch, 2, 3)), generator=torch.Generator().manual_seed(0))
    tlosses.cross_entropy(logits, torch.from_numpy(_labels(7, 2, 4))).backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all(), name


def _train_opts(out, *extra):
    """``build_model`` makes a TimeSformer at ViT-B's width and depth
    whatever the config says: the run is kept short by a 32-pixel crop (4
    patches a frame), 2 frames and one epoch of two steps."""
    return [
        "MODEL.MODEL_NAME", "TimeSformer", "MODEL.ARCH", "timesformer",
        "DATA.NUM_FRAMES", "2", "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
        "TRAIN.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "8", "TOME.ENABLE", "True", "TOME.R_VALUE", "1",
        "TOME.PROP_ATTN", "True", "SOLVER.MAX_EPOCH", "1", "SOLVER.OPTIMIZING_METHOD", "sgd",
        "SOLVER.BASE_LR", "0.005", "SOLVER.LR_POLICY", "steps_with_relative_lrs", "SOLVER.LRS", "[1]",
        "SOLVER.STEPS", "[0]", "TRAIN.CHECKPOINT_PERIOD", "1", "TRAIN.EVAL_PERIOD", "1",
        "OUTPUT_DIR", str(out), "EPICKITCHENS.NUM_CLASSES", "[5, 7]", "LOG_PERIOD", "1",
        "TPU.COMPUTE_DTYPE", "float32", "DATA_LOADER.NUM_WORKERS", "2", *extra,
    ]


def test_train_entry_point_one_epoch_with_twin_heads(tmp_path):
    """``train(cfg, device="cpu")`` on the synthetic dataset: one epoch, its
    checkpoint, finite fp32 parameters that moved; and no CUDA device with
    no request for the CPU raises."""
    cfg = tcfg.get_cfg()
    cfg.merge_from_list(_train_opts(tmp_path / "out"))
    trainer = build_trainer(cfg, device="cpu")
    assert trainer.multi_head and trainer.module.config.depth == 12
    assert all(g["weight_decay"] == 0.0001 for g in trainer.optimizer.param_groups)
    start = trainer.module.blocks[11].temporal_fc.weight.detach().clone()
    del trainer
    module = train(cfg, device="cpu")
    assert isinstance(module, TimeSformer) and module.head1.out_features == 7
    assert all(p.dtype == torch.float32 and bool(torch.isfinite(p).all()) for p in module.parameters())
    assert not torch.equal(module.blocks[11].temporal_fc.weight, start)
    assert cu.get_last_checkpoint(str(tmp_path / "out")).endswith("epoch_00000.pyth")
    with pytest.raises(RuntimeError, match="CUDA"):
        train(cfg)
