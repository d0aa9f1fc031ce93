"""The port's ViViT against the JAX package's, on the CPU in fp32: model,
converter and training step.

Weights come from a random HuggingFace-layout state dict made with numpy
(the names of ``VivitForVideoClassification``; the reference wrapper's
``verb_classifier`` / ``noun_classifier`` for the twin heads), loaded into
the JAX package through ``convert_vivit`` and into the port through
``load_vivit_state_dict``; gradients and updated parameters come back
through ``vivit_state_dict_from_vtm_params``.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vtm.config as jcfg
import vtm.train.losses as jlosses
import vtm.train.optimizer as jopt
from vtm.checkpoints.convert import convert_vivit
from vtm.merge import bipartite as jb
from vtm.merge.policy import MergePolicy as JPolicy
from vtm.merge.policy import MergeState as JState
from vtm.models.vivit import ViViT as JViViT
from vtm.models.vivit import ViViTConfig as JConfig
from vtm.models.vivit import ViViTLayer as JLayer
from vtm.train.train_step import make_train_step as jax_make_train_step

import vtm_torch.config as tcfg
import vtm_torch.train.losses as tlosses
import vtm_torch.train.optimizer as topt
from vtm_torch.checkpoints.checkpoint import load_test_checkpoint
from vtm_torch.checkpoints.convert import load_vivit_state_dict, vivit_state_dict_from_vtm_params
from vtm_torch.merge import bipartite as tb
from vtm_torch.merge.policy import MergePolicy, MergeState
from vtm_torch.models import build_model
from vtm_torch.models.vivit import ViViT, ViViTConfig
from vtm_torch.tools import model_benchmark as mb
from vtm_torch.tools.train_net import build_trainer, train
from vtm_torch.train.train_step import make_train_step

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]

# tests/test_vivit.py's TINY: 2 x 2 x 2 tubelets + CLS = 9 tokens
TINY = dict(image_size=32, num_frames=4, tubelet_size=(2, 16, 16), hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64, num_classes=5)
# 4 layers, width 64, 2 x 4 x 4 tubelets + CLS = 33 tokens
FOUR = dict(TINY, image_size=64, hidden_size=64, num_hidden_layers=4, intermediate_size=128)
VITB = dict(image_size=224, num_frames=8, tubelet_size=(2, 16, 16), hidden_size=768, num_hidden_layers=12,
            num_attention_heads=12, intermediate_size=3072, num_classes=400)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4   # of the largest entry of each gradient tensor
GRAD_NOISE = 1e-9  # a gradient that is zero analytically is rounding noise in both packages
PARAM_TOL = 1e-5  # after three optimizer steps


def _hf_sd(arch, seed=0, std=0.1):
    rng = np.random.default_rng(seed)
    d, hidden = arch["hidden_size"], arch["intermediate_size"]
    t, ph, pw = arch["tubelet_size"]
    tokens = (arch["num_frames"] // t) * (arch["image_size"] // ph) * (arch["image_size"] // pw) + 1

    def w(*shape, std=std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    e = "vivit.embeddings."
    sd = {
        e + "cls_token": w(1, 1, d), e + "position_embeddings": w(1, tokens, d),
        e + "patch_embeddings.projection.weight": w(d, 3, t, ph, pw, std=0.02),
        e + "patch_embeddings.projection.bias": w(d),
        "vivit.layernorm.weight": 1 + w(d), "vivit.layernorm.bias": w(d),
    }
    classes = arch["num_classes"]
    heads = ({"classifier": classes} if isinstance(classes, int)
             else dict(zip(("verb_classifier", "noun_classifier"), classes)))
    for name, n in heads.items():
        sd.update({f"{name}.weight": w(n, d), f"{name}.bias": w(n)})
    linears = {"attention.attention.query": (d, d), "attention.attention.key": (d, d),
               "attention.attention.value": (d, d), "attention.output.dense": (d, d),
               "intermediate.dense": (hidden, d), "output.dense": (d, hidden)}
    for i in range(arch["num_hidden_layers"]):
        pre = f"vivit.encoder.layer.{i}."
        for name, (out_f, in_f) in linears.items():
            sd[pre + name + ".weight"] = w(out_f, in_f)
            sd[pre + name + ".bias"] = w(out_f)
        for name in ("layernorm_before", "layernorm_after"):
            sd[pre + name + ".weight"] = 1 + w(d)
            sd[pre + name + ".bias"] = w(d)
    return sd


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(arch, kw, std=0.1, seed=0, fp32_params=False):
    sd = _hf_sd(arch, seed=seed, std=std)
    params = _np_tree(convert_vivit(sd, depth=arch["num_hidden_layers"]))
    jmodel = JViViT(config=JConfig(**arch), policy=JPolicy(**kw))
    tmodel = ViViT(ViViTConfig(**arch), policy=MergePolicy(**kw), fp32_params=fp32_params).eval()
    tmodel.load_state_dict(load_vivit_state_dict(sd))
    return params, jmodel, tmodel


def _video(arch, batch, seed):
    shape = (batch, arch["num_frames"], arch["image_size"], arch["image_size"], 3)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _policy_kw(arch, r, prop_attn=True):
    depth = arch["num_hidden_layers"]
    return dict(rs=(r,) * depth, mode="merge" if r else "none", prop_attn=prop_attn, class_token=True)


@pytest.mark.parametrize(
    "r,prop_attn,overrides",
    [
        (0, True, {}),
        (2, True, {}),
        (2, False, {}),
        (2, True, dict(num_classes=(5, 7))),
        (2, True, dict(hidden_act="gelu")),
        (2, True, dict(tubelet_size=(2, 16, 8))),
        (2, True, dict(qkv_bias=False)),
    ],
    ids=["unmerged", "merged", "no_prop_attn", "twin_heads", "exact_gelu", "oblong_patch", "no_qkv_bias"],
)
def test_logits_and_sizes_match_vtm(r, prop_attn, overrides):
    """fp32 logits within 1e-5, identical token sizes; the CLS token is
    never merged (its size stays 1)."""
    arch = dict(TINY, **overrides)
    sd = _hf_sd(arch)
    if not arch.get("qkv_bias", True):
        sd = {k: v for k, v in sd.items() if not any(f"attention.attention.{n}.bias" in k for n in ("query", "key", "value"))}
    params = _np_tree(convert_vivit(sd, depth=arch["num_hidden_layers"]))
    kw = _policy_kw(arch, r, prop_attn)
    tmodel = ViViT(ViViTConfig(**arch), policy=MergePolicy(**kw)).eval()
    tmodel.load_state_dict(load_vivit_state_dict(sd))
    video = _video(arch, 2, 0)
    with jax.default_matmul_precision("highest"):
        want, jstate = JViViT(config=JConfig(**arch), policy=JPolicy(**kw)).apply({"params": params}, jnp.asarray(video))
    with torch.no_grad():
        got, tstate = tmodel(torch.from_numpy(video))
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    if r:
        np.testing.assert_array_equal(tstate.size.numpy(), np.asarray(jstate.size))
        assert tstate.size.shape[1] == tmodel.config.tokens - 2 * r and bool((tstate.size[:, 0] == 1).all())


def _teacher_forced(arch, r, batch, tol, std):
    depth = arch["num_hidden_layers"]
    kw = _policy_kw(arch, r)
    params, _, tmodel = _models(arch, kw, std)
    video = _video(arch, batch, 3)
    metrics = []
    for layer in tmodel.layer:
        layer.attention.register_forward_hook(lambda m, i, o: metrics.append(o[1]))
    jconfig = JConfig(**arch)
    with jax.default_matmul_precision("highest"), torch.no_grad():
        x = jnp.asarray(tmodel.embed(torch.from_numpy(video)).numpy())
        size = None
        for i in range(depth):
            (want, jstate), inter = JLayer(jconfig, JPolicy(**kw)).apply(
                {"params": params[f"layer_{i}"]}, x, JState(size=size), layer=i, capture_intermediates=True)
            jmetric = inter["intermediates"]["attention"]["__call__"][0][1]
            metrics.clear()
            got, tstate = tmodel.layer[i](
                torch.from_numpy(np.array(x)),
                MergeState(size=None if size is None else torch.from_numpy(np.array(size))), layer=i)
            mj = jb.bipartite_soft_matching(jmetric, r, True)
            mt = tb.bipartite_soft_matching(metrics[0], r, True)
            for name in ("unm_idx", "src_idx", "dst_idx"):
                np.testing.assert_array_equal(
                    getattr(mt, name).numpy(), np.asarray(getattr(mj, name)), err_msg=f"layer {i} {name}")
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol, err_msg=f"layer {i}")
            np.testing.assert_array_equal(tstate.size.numpy(), np.asarray(jstate.size))
            x, size = want, jstate.size
    return x


def test_four_layer_teacher_forced_matching_and_blocks():
    """33 tokens, r = 5: identical Matching indices with the CLS token
    protected, layer outputs within 1e-4 (fp32)."""
    x = _teacher_forced(FOUR, r=5, batch=2, tol=1e-4, std=0.1)
    assert x.shape[1] == 33 - 4 * 5


@pytest.mark.slow
def test_vitb_teacher_forced_matching_and_blocks():
    """Full width: ViT-B at 8x224 (785 tokens), r = 60, batch 1; layer
    outputs within 1e-4 (fp32, 768-wide sums), weights at std 0.02."""
    _teacher_forced(VITB, r=60, batch=1, tol=1e-4, std=0.02)


def test_hf_state_dict_loads_like_the_bridge_and_round_trips():
    for arch in (TINY, dict(TINY, num_classes=(5, 7))):
        sd = _hf_sd(arch, seed=1)
        params = convert_vivit(sd, depth=2)
        bridged = vivit_state_dict_from_vtm_params(params)
        direct = load_vivit_state_dict({f"module.{k}": v for k, v in sd.items()})
        assert sorted(direct) == sorted(bridged)
        for k in direct:
            assert torch.equal(direct[k], bridged[k]), k
        model = ViViT(ViViTConfig(**arch))
        model.load_state_dict(direct)
        assert sorted(model.state_dict()) == sorted(direct)


def test_fresh_model_starts_cls_token_and_positions_at_zero():
    """A freshly built ViViT has a zero class token and zero position
    embeddings in both packages (``vtm``'s ``init`` uses
    ``nn.initializers.zeros`` for the two), and random weights elsewhere."""
    jmodel = JViViT(config=JConfig(**TINY), policy=JPolicy(**_policy_kw(TINY, 0)))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(_video(TINY, 1, 0)))["params"]
    tmodel = ViViT(ViViTConfig(**TINY), policy=MergePolicy(**_policy_kw(TINY, 0)))
    for name in ("cls_token", "position_embeddings"):
        assert not np.asarray(params[name]).any()
        fresh = getattr(tmodel, name)
        assert fresh.shape == params[name].shape and not fresh.detach().any()
    assert tmodel.layer[0].attention.query.weight.detach().abs().max() > 0
    assert not tmodel.layer[0].attention.query.bias.detach().any()


def test_unknown_activation_raises():
    with pytest.raises(NotImplementedError, match="hidden_act"):
        ViViT(ViViTConfig(**dict(TINY, hidden_act="relu")))


def test_compute_dtype_cast_keeps_norms_and_classifier_fp32():
    model = ViViT(ViViTConfig(**TINY), dtype=torch.bfloat16)
    assert model.layer[0].attention.query.weight.dtype == torch.bfloat16
    assert model.patch_embed.proj.weight.dtype == torch.bfloat16
    assert model.layer[0].layernorm_before.weight.dtype == torch.float32
    assert model.classifier.weight.dtype == torch.float32
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(_video(TINY, 2, 4)))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


def _json(tmp_path, arch):
    path = tmp_path / "vivit.json"
    path.write_text(json.dumps(dict(
        video_size=[arch["num_frames"], arch["image_size"], arch["image_size"]],
        tubelet_size=list(arch["tubelet_size"]), num_channels=3, hidden_size=arch["hidden_size"],
        num_hidden_layers=arch["num_hidden_layers"], num_attention_heads=arch["num_attention_heads"],
        intermediate_size=arch["intermediate_size"], hidden_act="gelu_fast", layer_norm_eps=1e-6, qkv_bias=True)))
    return str(path)


def _cfg(tmp_path, *opts):
    cfg = tcfg.get_cfg()
    cfg.merge_from_list([
        "MODEL.MODEL_NAME", "ViViT", "MODEL.ARCH", "vivit", "VIVIT.CONFIG_PATH", _json(tmp_path, TINY),
        "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
        "MODEL.NUM_CLASSES", "7", "TPU.COMPUTE_DTYPE", "float32", "TEST.BATCH_SIZE", "2",
        "TOME.ENABLE", "True", "TOME.R_VALUE", "2", "TOME.PROP_ATTN", "True", *opts])
    return cfg


def test_config_from_json_matches_vtm_and_the_shipped_files(tmp_path):
    path = _json(tmp_path, TINY)
    mine, theirs = ViViTConfig.from_json(path, 7), JConfig.from_json(path, 7)
    for field in ("image_size", "num_frames", "tubelet_size", "hidden_size", "num_hidden_layers",
                  "num_attention_heads", "intermediate_size", "hidden_act", "layer_norm_eps", "qkv_bias", "tokens"):
        assert getattr(mine, field) == getattr(theirs, field), field
    shipped = ViViTConfig.from_json(str(REPO / "configs/vivit/kinetics/tome_vivit_8x32_224.json"), 400)
    assert (shipped.tokens, shipped.depth, shipped.hidden_size) == (3137, 12, 768)


def test_build_model_and_benchmark_entry_point(tmp_path, capsys):
    """``build_model`` protects the class token; the benchmark entry point
    runs it on the CPU when asked, and a saved checkpoint in HuggingFace
    names loads through ``TEST.CHECKPOINT_FILE_PATH``."""
    cfg = _cfg(tmp_path)
    bundle = build_model(cfg, "cpu")
    assert bundle.name == "ViViT" and bundle.policy.class_token is True and bundle.policy.rs == (2, 2)
    assert bundle.policy.token_counts(9) == (9, 7, 5)
    stats = mb.model_benchmark(cfg, device="cpu")
    assert stats["attention_kernel_launches"] == 0 and stats["clips_per_sec"] > 0
    assert "json_stats: " in capsys.readouterr().out
    sd = {k: torch.from_numpy(v) for k, v in _hf_sd(dict(TINY, num_classes=7), seed=2).items()}
    ckpt = tmp_path / "hf.pyth"
    torch.save({"model_state": sd}, ckpt)
    loaded = load_test_checkpoint(_cfg(tmp_path, "TEST.CHECKPOINT_FILE_PATH", str(ckpt)), build_model(cfg, "cpu"))
    assert torch.equal(loaded.module.layer[1].attention.key.weight, sd["vivit.encoder.layer.1.attention.attention.key.weight"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(_cfg(tmp_path, "TOME.LAYER_QUANTITY", "2"), "cpu")


# ---- training ---------------------------------------------------------------


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


@pytest.mark.parametrize("num_classes,r", [(7, 5), ((5, 6), 5), (7, 0)], ids=["merged", "twin_heads", "unmerged"])
def test_loss_matching_and_gradients_match_vtm(num_classes, r):
    arch = dict(FOUR, num_classes=num_classes, num_hidden_layers=3)
    multi_head = isinstance(num_classes, tuple)
    params, jmodel, tmodel = _models(arch, _policy_kw(arch, r), fp32_params=True)
    video, labels = _video(arch, 2, 1), _labels(num_classes, 2, 2)

    def jloss(p, frames, lab):
        out, _ = jmodel.apply({"params": p}, frames)
        if multi_head:
            return 0.5 * (jlosses.cross_entropy(out[0], lab["verb"]) + jlosses.cross_entropy(out[1], lab["noun"]))
        return jlosses.cross_entropy(out, lab)

    with jax.default_matmul_precision("highest"):
        want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params, jnp.asarray(video), _to_jax(labels))
        _, inter = jmodel.apply({"params": params}, jnp.asarray(video), capture_intermediates=True)
    metrics = []
    hooks = [l.attention.register_forward_hook(lambda m, i, o: metrics.append(o[1])) for l in tmodel.layer]
    tmodel.train()
    out, _ = tmodel(torch.from_numpy(video))
    for hk in hooks:
        hk.remove()
    if multi_head:
        loss = tlosses.epic_dual_loss(tlosses.cross_entropy, out, _to_torch(labels))
    else:
        loss = tlosses.cross_entropy(out, _to_torch(labels))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= LOSS_TOL
    if r:
        for i in range(3):
            jmetric = inter["intermediates"][f"layer_{i}"]["attention"]["__call__"][0][1]
            mj = jb.bipartite_soft_matching(jmetric, r, True)
            mt = tb.bipartite_soft_matching(metrics[i], r, True)
            for name in ("unm_idx", "src_idx", "dst_idx"):
                np.testing.assert_array_equal(getattr(mt, name).numpy(), np.asarray(getattr(mj, name)), err_msg=f"{i} {name}")
    want = {k: v.numpy() for k, v in vivit_state_dict_from_vtm_params(_np_tree(want_grads)).items()}
    named = dict(tmodel.named_parameters())
    assert sorted(want) == sorted(named)
    largest = max(np.abs(g).max() for g in want.values())
    for name, p in named.items():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        if name.endswith("attention.key.bias"):
            # zero analytically (a softmax does not see a shift of its logits):
            # rounding noise in both packages, named instead of compared
            assert max(p.grad.abs().max().item(), np.abs(want[name]).max()) <= 1e-6 * largest, name
            continue
        tol = max(GRAD_TOL * np.abs(want[name]).max(), GRAD_NOISE)
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=0, atol=tol, err_msg=name)


def _solver_opts():
    """The shipped configs' optimizer: SGD with momentum 0.9, weight decay
    1e-4 and the relative step schedule, here changing every step."""
    return ["MODEL.MODEL_NAME", "ViViT", "SOLVER.OPTIMIZING_METHOD", "sgd", "SOLVER.MOMENTUM", "0.9",
            "SOLVER.BASE_LR", "0.05", "SOLVER.LR_POLICY", "steps_with_relative_lrs", "SOLVER.LRS", "[1, 0.1, 0.01]",
            "SOLVER.STEPS", "[0, 1, 2]", "SOLVER.MAX_EPOCH", "3", "SOLVER.WEIGHT_DECAY", "0.0001"]


@pytest.mark.parametrize("num_classes", [7, (5, 6)], ids=["single_head", "twin_heads"])
def test_three_sgd_steps_match_vtm(num_classes):
    arch = dict(FOUR, num_classes=num_classes, num_hidden_layers=3)
    multi_head = isinstance(num_classes, tuple)
    jc, tc = jcfg.get_cfg(), tcfg.get_cfg()
    jc.merge_from_list(_solver_opts())
    tc.merge_from_list(_solver_opts())
    params, jmodel, tmodel = _models(arch, _policy_kw(arch, 5), seed=1, fp32_params=True)
    tx, jlr_at = jopt.construct_optimizer(jc, params, num_layers=3)
    opt_state = tx.init(params)
    jstep = jax_make_train_step(jmodel, tx, "cross_entropy", multi_head)
    optimizer, lr_at = topt.construct_optimizer(tc, tmodel, num_layers=3)
    tstep = make_train_step(tmodel, optimizer, "cross_entropy", multi_head)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    start = {k: v.clone() for k, v in tmodel.state_dict().items()}
    for i in range(3):
        epoch = float(i)
        assert lr_at(epoch) == jlr_at(epoch) == 0.05 * (1, 0.1, 0.01)[i]
        video, labels = _video(arch, 2, 10 + i), _labels(num_classes, 2, 20 + i)
        jopt.set_lr(opt_state, jlr_at(epoch))
        with jax.default_matmul_precision("highest"):
            jparams, opt_state, jloss, _, jaux = jstep(
                jparams, opt_state, jnp.asarray(video), _to_jax(labels), jax.random.key(i))
        topt.set_lr(optimizer, lr_at(epoch))
        loss, _, aux = tstep(torch.from_numpy(video), _to_torch(labels))
        assert abs(loss.item() - float(jloss)) <= 1e-4, i
        assert len(aux) == len(jaux)
    want = {k: v.numpy() for k, v in vivit_state_dict_from_vtm_params(_np_tree(jparams)).items()}
    moved = 0.0
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0, atol=PARAM_TOL, err_msg=name)
        moved = max(moved, (p.detach() - start[name]).abs().max().item())
    assert moved > 1e-4  # the steps did something


def test_zero_wd_set_and_layer_ids_match_vtm_on_every_parameter():
    """No ViT family but Motionformer has a no-weight-decay name set: the
    class token and the position embeddings are decayed; layer ids follow
    ``layer.{i}``."""
    jc, tc = jcfg.get_cfg(), tcfg.get_cfg()
    opts = _solver_opts() + ["SOLVER.ZERO_WD_1D_PARAM", "True"]
    jc.merge_from_list(opts)
    tc.merge_from_list(opts)
    arch = dict(TINY, num_classes=(5, 6))
    params, _, tmodel = _models(arch, _policy_kw(arch, 0))
    flat, structure = jax.tree_util.tree_flatten_with_path(params)

    def named(fn):
        tree = jax.tree_util.tree_unflatten(
            structure, [np.full(np.shape(x), float(fn(p, x)), np.float32) for p, x in flat])
        return vivit_state_dict_from_vtm_params(tree)

    jwd = named(lambda p, x: jopt._is_zero_wd(jc, p, x))
    jid = named(lambda p, x: jopt._layer_id(p, 2))
    for name, p in tmodel.named_parameters():
        assert float(topt._is_zero_wd(tc, name, p)) == jwd[name].flatten()[0].item(), name
        assert float(topt._layer_id(name, 2)) == jid[name].flatten()[0].item(), name
    assert not topt._is_zero_wd(tc, "cls_token", tmodel.cls_token)
    assert topt._layer_id("layer.1.attention.key.weight", 2) == 2 and topt._layer_id("position_embeddings", 2) == 0


def test_train_entry_point_two_epochs(tmp_path):
    """``train(cfg, device="cpu")`` on the synthetic dataset with the twin
    classifiers: two epochs, a checkpoint each, finite parameters; the
    trainer takes the depth from the json."""
    cfg = _cfg(
        tmp_path, "EPICKITCHENS.NUM_CLASSES", "[5, 7]", "TRAIN.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "4",
        "SOLVER.MAX_EPOCH", "2", "SOLVER.OPTIMIZING_METHOD", "sgd", "SOLVER.BASE_LR", "0.01",
        "SOLVER.LR_POLICY", "cosine", "SOLVER.WARMUP_EPOCHS", "1.0", "TRAIN.CHECKPOINT_PERIOD", "1",
        "TRAIN.EVAL_PERIOD", "1", "OUTPUT_DIR", str(tmp_path / "out"), "LOG_PERIOD", "1",
        "DATA_LOADER.NUM_WORKERS", "2")
    trainer = build_trainer(cfg, device="cpu")
    assert trainer.multi_head and all(p.dtype == torch.float32 for p in trainer.module.parameters())
    module = train(cfg, device="cpu")
    assert isinstance(module, ViViT) and module.verb_classifier.out_features == 5
    assert all(bool(torch.isfinite(p).all()) for p in module.parameters())
    assert sorted(p.name for p in (tmp_path / "out" / "checkpoints").iterdir()) == [
        "epoch_00000.pyth", "epoch_00001.pyth"]
    with pytest.raises(RuntimeError, match="CUDA"):
        train(cfg)
