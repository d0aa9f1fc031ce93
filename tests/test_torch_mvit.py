"""The port's MViT (``vtm_torch/models/mvit.py``) against ``vtm/models/mvit.py``
on the CPU, tiny (``torch_mvit_cases``: embed 16, 2 heads, depth 4, 4 or 8
frames at a 32-pixel crop), from the same weights: the four styles of
``tests/test_mvit.py`` in fp32 and v2 in bf16; the block plans, the
``jax.image.resize`` copy and the paths that reach it (relative positions
at a 40-pixel crop, absolute positions on non-square clips); the weight
bridge both ways; checkpoints through both packages' ``load_test_checkpoint``
and ``CHECKPOINT_IN_INIT``; and the refusals (items 15, 19, 20). About 30 s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtm.checkpoints import checkpoint as jax_checkpoint
from vtm.checkpoints.convert import convert_mvit
from vtm.models.mvit import mvit_spec_from_cfg as jax_spec_from_cfg

from vtm_torch.checkpoints import checkpoint as port_checkpoint
from vtm_torch.checkpoints.convert import mvit_state_dict_from_vtm_params
from vtm_torch.models import build_model, mvit
from vtm_torch.models.mvit import MViTModel, linear_resize_weights, mvit_spec_from_cfg, resize_linear
from vtm_torch.parallel.sharding import check_tensor_parallel

import chip_smoke
from torch_conv_cases import assert_close_to_largest, cfgs
from torch_mvit_cases import LOGIT_TOL, REV_STYLES, STYLES, V2, Case, mvit_opts, template_of

torch.set_num_threads(2)

# bf16: the two packages round at the same points, but not in the same
# order inside each operation (a linear layer's bias add, the GELU's steps),
# so their bf16 logits sit as far apart as either's bf16 from its fp32
# (measured 1.18e-2 apart, vtm's own bf16 7.9e-3 from its fp32, of the
# largest fp32 logit). Held: at most twice vtm's bf16-to-fp32 distance.
BF16_FACTOR = 2.0


@pytest.fixture(scope="module")
def cases():
    return {}


def _case(cases, *extra):
    if extra not in cases:
        cases[extra] = Case(*extra)
    return cases[extra]


@pytest.mark.parametrize("style", sorted(STYLES))
def test_styles_match_vtm(style, cases):
    """fp32: train-mode logits (every rate 0) and eval probabilities within
    LOGIT_TOL of the largest, ``vtm``'s param tree equal to ``jax.eval_shape``
    of its init (``Case``)."""
    case = _case(cases, *STYLES[style])
    x = case.video(2, seed=1)
    logits = case.port_apply(x, train=True)
    assert logits.shape == (2, 7)
    assert_close_to_largest(logits, case.jax_apply(x, True), LOGIT_TOL, f"{style} logits")
    probs = case.port_apply(x, train=False)
    assert_close_to_largest(probs, case.jax_apply(x, False), LOGIT_TOL, f"{style} probabilities")
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=0, atol=1e-5)


def test_v2_bf16_matches_vtm(cases):
    """``TPU.COMPUTE_DTYPE bfloat16``: the port's logits within BF16_FACTOR
    times ``vtm``'s own bf16-to-fp32 distance of ``vtm``'s bf16 logits, on
    the same (bf16-cast) weights; and ``vtm``'s rounding points: a pooled
    q, k, v and its LayerNorm in fp32 (the conv promotes), the attention's
    projection and the MLP in bf16, the logits fp32."""
    case = _case(cases, *V2, "TPU.COMPUTE_DTYPE", "bfloat16")
    fp32 = _case(cases, *V2)
    x = case.video(2, seed=2)
    seen = {}
    blk = case.module.blocks[1]
    hooks = [m.register_forward_hook(lambda m, a, out, k=k: seen.__setitem__(k, out[0].dtype if isinstance(
        out, tuple) else out.dtype)) for k, m in (("norm_q", blk.attn.norm_q), ("norm_k", blk.attn.norm_k),
                                                   ("attn", blk.attn), ("fc2", blk.mlp.fc2))]
    try:
        got = case.port_apply(x, train=True)
    finally:
        for h in hooks:
            h.remove()
    assert seen == {"norm_q": torch.float32, "norm_k": torch.float32, "attn": torch.bfloat16, "fc2": torch.bfloat16}
    want = case.jax_apply(x, True)
    want32 = fp32.jax_apply(x, True, params=case.params)  # vtm in fp32 on the same weights
    scale = float(np.abs(want32).max())
    gap = float(np.abs(want - want32).max()) / scale
    err = float(np.abs(got - want).max()) / scale
    assert 0 < gap < 0.05 and err <= BF16_FACTOR * gap, (err, gap)


PLAN_CONFIGS = {**{f"mvit_{k}": mvit_opts(*v) for k, v in STYLES.items()},
                **{f"rev_{k}": mvit_opts(*v) for k, v in REV_STYLES.items()},
                "MVITV2_S": chip_smoke.MVITV2_S_OPTS, "REV_MVIT_B": chip_smoke.REV_MVIT_B_OPTS}


@pytest.mark.parametrize("name", sorted(PLAN_CONFIGS))
def test_plans_equal_vtm(name):
    """``block_plan``, ``rev_block_plan``, ``rev_final_dim`` and the patch
    grid equal ``vtm``'s, for the tests' configs and the two full-width
    lists chip_smoke runs."""
    cfg, jcfg = cfgs(PLAN_CONFIGS[name])
    spec, jspec = mvit_spec_from_cfg(cfg), jax_spec_from_cfg(jcfg)
    assert spec.block_plan() == jspec.block_plan()
    assert spec.rev_block_plan() == jspec.rev_block_plan()
    assert spec.rev_final_dim == jspec.rev_final_dim and spec.patch_dims == jspec.patch_dims


@pytest.mark.parametrize("n_in, n_out", [(5, 3), (10, 4), (9, 5), (3, 5), (4, 9), (7, 13), (1, 4), (5, 5)])
def test_resize_equals_jax_image_resize(n_in, n_out):
    """``resize_linear`` against ``jax.image.resize(..., "linear")`` (its
    antialiasing triangle when shrinking), on [n_in, 6] tables and, along
    two axes at once (n_in -> n_out and 3 -> 5), on a [1, 2, n_in, 3, 4]
    grid; ``arange(10).reshape(5, 2)`` to 3 rows gives 0.857 / 4 / 7.143,
    where ``F.interpolate`` gives 0.667 / 4 / 7.333."""
    rng = np.random.default_rng(n_in * 31 + n_out)
    table = rng.standard_normal((n_in, 6)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(table), (n_out, 6), method="linear"))
    np.testing.assert_allclose(resize_linear(torch.from_numpy(table), (n_out, 6)).numpy(), want, rtol=0, atol=2e-6)
    grid = rng.standard_normal((1, 2, n_in, 3, 4)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(grid), (1, 2, n_out, 5, 4), method="linear"))
    np.testing.assert_allclose(resize_linear(torch.from_numpy(grid), (1, 2, n_out, 5, 4)).numpy(), want,
                               rtol=0, atol=2e-6)
    if (n_in, n_out) == (5, 3):
        got = resize_linear(torch.arange(10.0).reshape(5, 2), (3, 2))[:, 0].numpy()
        np.testing.assert_allclose(got, [0.0 + 6 / 7, 4.0, 7.0 + 1 / 7], atol=1e-5)
        assert np.allclose(linear_resize_weights(5, 3).sum(axis=0), 1.0)


def test_rel_pos_resize_and_non_square_clips_match_vtm(cases, monkeypatch):
    """The two paths that resize: v2 at a 40-pixel crop, 6 frames and kv
    strides 8, 4, 2 (block 3 pools a 5 x 5 grid to 3 x 3 where the table
    was sized for 5 // 2, so ``_get_rel_pos`` resizes 3 rows to 5), and absolute positions (v1, and separate
    tables) on clips wider and narrower than the crop (``to_grid``). fp32
    logits within LOGIT_TOL of ``vtm``'s."""
    calls = []
    real = mvit.resize_linear
    monkeypatch.setattr(mvit, "resize_linear", lambda x, shape: calls.append((tuple(x.shape), shape)) or real(x, shape))
    case = _case(cases, *V2, "DATA.TRAIN_CROP_SIZE", "40", "DATA.TEST_CROP_SIZE", "40", "DATA.NUM_FRAMES", "6",
                 "MVIT.POOL_KV_STRIDE_ADAPTIVE", "[1, 8, 8]")
    x = case.video(2, seed=3)
    assert_close_to_largest(case.port_apply(x, True), case.jax_apply(x, True), LOGIT_TOL, "v2 at 40")
    assert any(shape[0] > old[0] for old, shape in calls), calls
    for style, hw in (("v1", (32, 40)), ("v1", (32, 24)), ("sep_qkv_avg", (40, 32))):
        calls.clear()
        case = _case(cases, *STYLES[style])
        x = case.video(2, seed=4, hw=hw)
        assert_close_to_largest(case.port_apply(x, True), case.jax_apply(x, True), LOGIT_TOL, f"{style} {hw}")
        assert calls, f"{style} {hw} never resized"


@pytest.mark.parametrize("style", ["v1", "v2", "sep_qkv_avg", "rev_ln_fuse"])
def test_bridge_round_trip(style, cases):
    """``mvit_state_dict_from_vtm_params(convert_mvit(sd))`` is the port's
    state dict bit for bit (plain blocks, the reversible layout with the
    ``ln+concat_linear`` fusion); ``vtm``'s tree has every path of its init."""
    extra = STYLES.get(style) or REV_STYLES["conv_respath"] + ("MVIT.REV.RESPATH_FUSE", "ln+concat_linear")
    case = _case(cases, *extra)
    sd = mvit_state_dict_from_vtm_params(case.params)
    assert set(sd) == set(case.state)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), case.state[k], err_msg=k)


def _upstream_file(tmp_path, state, name="upstream.pyth") -> str:
    """The state dict in a DDP-saved PySlowFast layout: ``module.`` keys
    under ``model_state``."""
    path = str(tmp_path / name)
    torch.save({"model_state": {f"module.{k}": torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()},
                "epoch": 3}, path)
    return path


def test_load_test_checkpoint_matches_vtm(cases, tmp_path):
    """An upstream-layout file of one seed's weights through both packages'
    ``load_test_checkpoint`` into a model of another seed: every tensor
    loads, the two trees are equal, and the fp32 logits are the first
    seed's in both."""
    case = _case(cases, *V2)
    path = _upstream_file(tmp_path, case.state)
    cfg, jcfg = cfgs(mvit_opts(*V2, "RNG_SEED", "7", "TEST.CHECKPOINT_FILE_PATH", path))
    bundle = build_model(cfg, "cpu")
    assert not np.array_equal(bundle.module.state_dict()["blocks.0.attn.qkv.weight"].numpy(),
                              case.state["blocks.0.attn.qkv.weight"])
    port_checkpoint.load_test_checkpoint(cfg, bundle)
    jbundle = case.jbundle
    saved = jbundle.params
    jbundle.params = template_of(case.shapes)
    try:
        jax_checkpoint.load_test_checkpoint(jcfg, jbundle)
        jparams = jbundle.params
    finally:
        jbundle.params = saved
    loaded = {k: v.numpy() for k, v in bundle.module.state_dict().items()}
    for k, v in mvit_state_dict_from_vtm_params(jparams).items():
        np.testing.assert_array_equal(v.numpy(), loaded[k], err_msg=k)
        np.testing.assert_array_equal(loaded[k], case.state[k], err_msg=k)
    x = case.video(2, seed=5)
    with torch.no_grad():
        got = bundle.module(torch.from_numpy(x))[0].numpy()
    assert_close_to_largest(got, case.jax_apply(x, False, params=jparams), LOGIT_TOL, "loaded")


def test_ln_concat_linear_pre_q_fusion_loads(tmp_path):
    """A reversible file with an ``ln+concat_linear`` pre-q fusion: the port
    loads every tensor, the fusion's LayerNorm and MLP
    (``pre_q_fuse.fuse_fn.0`` / ``.1``) included. ``vtm``'s ``convert_mvit``
    reads only ``pre_q_fuse.fuse_fn.fc1`` and leaves these out, so its
    loader keeps their random init (ROADMAP.md Queue 3)."""
    opts = mvit_opts(*REV_STYLES["conv_respath"], "MVIT.REV.PRE_Q_FUSION", "ln+concat_linear")
    cfg, _ = cfgs(opts)
    state = {k: v.numpy() for k, v in build_model(cfg, "cpu").module.state_dict().items()}
    fusion = sorted(k for k in state if ".pre_q_fuse.fuse_fn." in k)
    assert fusion and any(".fuse_fn.0." in k for k in fusion)
    params = convert_mvit(state, depth=cfg.MVIT.DEPTH)
    assert all("pre_q_fuse" not in params["rev_backbone"][f"layers_{i}"] for i in (1, 3))
    cfg, _ = cfgs(opts + ["RNG_SEED", "7", "TEST.CHECKPOINT_FILE_PATH", _upstream_file(tmp_path, state)])
    loaded = port_checkpoint.load_test_checkpoint(cfg, build_model(cfg, "cpu")).module.state_dict()
    for k in state:
        np.testing.assert_array_equal(loaded[k].numpy(), state[k], err_msg=k)


def test_checkpoint_in_init_matches_vtm(cases, tmp_path):
    """``TRAIN.CHECKPOINT_IN_INIT``: a file whose patch embedding and pool
    kernels have one frame and whose ``rel_pos`` tables are shorter, into
    both packages: the kernels repeated over time without division, the
    tables interpolated (``image_init_adapt``); the two results equal (the
    tables within 1e-6)."""
    case = _case(cases, *V2)
    image = {}
    for k, v in case.state.items():
        if k == "patch_embed.proj.weight" or k.endswith(("pool_q.weight", "pool_k.weight", "pool_v.weight")):
            v = v[:, :, :1]
        elif "rel_pos" in k:
            v = v[:-2]
        image[k] = v
    path = _upstream_file(tmp_path, image, "image.pyth")
    cfg, jcfg = cfgs(mvit_opts(*V2, "RNG_SEED", "7", "TEST.CHECKPOINT_FILE_PATH", path,
                               "TRAIN.CHECKPOINT_IN_INIT", "True"))
    bundle = port_checkpoint.load_test_checkpoint(cfg, build_model(cfg, "cpu"))
    jbundle = case.jbundle
    saved = jbundle.params
    jbundle.params = template_of(case.shapes)
    try:
        jax_checkpoint.load_test_checkpoint(jcfg, jbundle)
        want = {k: v.numpy() for k, v in mvit_state_dict_from_vtm_params(jbundle.params).items()}
    finally:
        jbundle.params = saved
    got = {k: v.numpy() for k, v in bundle.module.state_dict().items()}
    assert set(got) == set(want)
    rel = [k for k in got if "rel_pos" in k]
    assert rel
    for k in got:
        if k in rel:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
            assert got[k].shape == case.state[k].shape
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    w = got["patch_embed.proj.weight"]
    np.testing.assert_array_equal(w, np.repeat(image["patch_embed.proj.weight"], 3, axis=2))


def test_ptv_alias_and_registry():
    """``PTVMViT`` builds the port's MViT under the PTV name, as ``vtm``'s
    registry builds its own, with the same weights from the same seed."""
    cfg, _ = cfgs(mvit_opts(*V2))
    ptv_cfg, _ = cfgs(mvit_opts(*V2, "MODEL.MODEL_NAME", "PTVMViT"))
    a, b = build_model(cfg, "cpu"), build_model(ptv_cfg, "cpu")
    assert type(b.module) is MViTModel and b.name == "PTVMViT" and a.name == "MViT"
    for (k, v), (k2, w) in zip(a.module.state_dict().items(), b.module.state_dict().items()):
        assert k == k2 and torch.equal(v, w), k


@pytest.mark.parametrize("opts, item", [
    (("TPU.MODEL_PARALLEL", "2"), "item 15"),
])
def test_unported_options_raise_naming_their_item(opts, item):
    cfg, _ = cfgs(mvit_opts(*opts))
    with pytest.raises(NotImplementedError, match=item):
        check_tensor_parallel(cfg)
        build_model(cfg, "cpu")


def test_detection_builds_the_roi_head():
    """``DETECTION.ENABLE`` (it raised before the AVA path was ported) builds
    the ROI head as ``head``, one row a box from ``forward(x, bboxes=...)``,
    a ValueError without boxes; the reversible MViT has no detection path
    (``vtm``'s assertion). The forwards against ``vtm``'s:
    tests/test_torch_ava_detection.py."""
    cfg, _ = cfgs(mvit_opts("DETECTION.ENABLE", "True", "DETECTION.SPATIAL_SCALE_FACTOR", "8"))
    module = build_model(cfg, "cpu").module
    assert type(module.head).__name__ == "ResNetRoIHead" and module.head.projection.out_features == 7
    x = torch.randn(2, 4, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    rows, _ = module(x, bboxes=torch.tensor([[0.0, 1.0, 2.0, 20.0, 30.0], [1.0, 0.0, 0.0, 31.0, 31.0]]))
    assert rows.shape == (2, 7) and bool(torch.isfinite(rows).all())
    with pytest.raises(ValueError, match="boxes"):
        module(x)
    cfg, _ = cfgs(mvit_opts(*REV_STYLES["conv_respath"], "DETECTION.ENABLE", "True"))
    with pytest.raises(AssertionError, match="detection"):
        build_model(cfg, "cpu")


def test_contrastive_mlp_head_matches_vtm():
    """``CONTRASTIVE.NUM_MLP_LAYERS`` 3 (the contrastive family's head):
    ``head.projection`` is the SSL MLP of ``vtm``'s ``_mvit_head``, its
    train-mode logits and eval probabilities within LOGIT_TOL of ``vtm``'s
    from the same weights (``vtm``'s ``convert_mvit`` reads a linear head
    only: the MLP's kernels go over by hand,
    ``torch_contrastive_cases.mvit_vtm_tree``)."""
    from vtm.models.build import build_model as jax_build_model

    from torch_contrastive_cases import mvit_vtm_tree

    cfg, jcfg = cfgs(mvit_opts("CONTRASTIVE.NUM_MLP_LAYERS", "3", "CONTRASTIVE.MLP_DIM", "24"))
    module = build_model(cfg, "cpu").module
    assert [n for n, _ in module.head.projection.named_children()] == ["fc0", "fc1", "fc2"]
    params, stats = mvit_vtm_tree({k: v.float().numpy() for k, v in module.state_dict().items()}, cfg.MVIT.DEPTH)
    assert stats is None
    jmodule = jax_build_model(jcfg, init=False).module
    x = np.random.default_rng(5).standard_normal((2, 4, 32, 32, 3)).astype(np.float32)
    for train in (True, False):
        want = np.asarray(jax.jit(lambda p, v: jmodule.apply({"params": p}, v, train=train)[0])(params, jnp.asarray(x)))
        with torch.no_grad():
            got = module.train(train)(torch.from_numpy(x))[0].numpy()
        assert_close_to_largest(got, want, LOGIT_TOL, f"train={train}")
