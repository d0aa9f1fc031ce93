"""The port's VideoMAE against the JAX package's, on the CPU in fp32.

Weights come from a randomly initialised HuggingFace
VideoMAEForVideoClassification, through ``convert_videomae`` (JAX params)
and back through ``state_dict_from_vtm_params`` (the port's state dict),
so both packages run the same weights on the same numpy clip.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vtm.checkpoints.convert import convert_videomae
from vtm.merge import bipartite as jb
from vtm.merge.policy import MergePolicy as JPolicy
from vtm.merge.policy import MergeState as JState
from vtm.models.common import LayerNorm as JLayerNorm
from vtm.models.common import TubeletEmbed as JTubeletEmbed
from vtm.models.common import sinusoid_encoding_table as jax_sinusoid
from vtm.models.videomae import VideoMAE as JVideoMAE
from vtm.models.videomae import VideoMAEAttention as JAttention
from vtm.models.videomae import VideoMAEBlock as JBlock
from vtm.models.videomae import VideoMAEConfig as JConfig
from vtm_torch.checkpoints.convert import load_videomae_state_dict, state_dict_from_vtm_params
from vtm_torch.merge import bipartite as tb
from vtm_torch.merge.policy import MergePolicy, MergeState
from vtm_torch.models.common import sinusoid_encoding_table
from vtm_torch.models.videomae import VideoMAE, VideoMAEConfig

from torch_variants import VARIANT_MODES, assert_states_equal, run_variant

torch.set_num_threads(2)

TINY = dict(
    img_size=32, patch_size=16, num_frames=4, tubelet_size=2, embed_dim=32,
    depth=2, num_heads=2, mlp_ratio=2.0,
)
TINY_TOKENS = 8  # 2 tubelets x 2x2 patches
# 4 layers, 64 tokens (4 tubelets x 4x4 patches)
FOUR = dict(TINY, img_size=64, num_frames=8, depth=4)
VITB = dict(
    img_size=224, patch_size=16, num_frames=16, tubelet_size=2, embed_dim=768,
    depth=12, num_heads=12, mlp_ratio=4.0,
)


def _hf_state_dict(arch, num_labels=7, use_mean_pooling=True):
    from transformers import VideoMAEConfig as HFConfig
    from transformers import VideoMAEForVideoClassification

    torch.manual_seed(0)
    hf = VideoMAEForVideoClassification(
        HFConfig(
            image_size=arch["img_size"], patch_size=arch["patch_size"],
            num_frames=arch["num_frames"], tubelet_size=arch["tubelet_size"],
            hidden_size=arch["embed_dim"], num_hidden_layers=arch["depth"],
            num_attention_heads=arch["num_heads"],
            intermediate_size=int(arch["embed_dim"] * arch["mlp_ratio"]),
            num_labels=num_labels, use_mean_pooling=use_mean_pooling,
        )
    ).eval()
    # non-zero q/v biases, so their placement is exercised
    sd = dict(hf.state_dict())
    gen = torch.Generator().manual_seed(1)
    for k in sd:
        if k.endswith(("q_bias", "v_bias")):
            sd[k] = 0.1 * torch.randn(sd[k].shape, generator=gen)
    return sd


def _models(arch, num_labels, jpolicy, tpolicy):
    sd = _hf_state_dict(arch, num_labels)
    params = convert_videomae(sd, depth=arch["depth"])
    jmodel = JVideoMAE(config=JConfig(num_classes=num_labels, **arch), policy=jpolicy)
    tmodel = VideoMAE(VideoMAEConfig(num_classes=num_labels, **arch), policy=tpolicy).eval()
    tmodel.load_state_dict(state_dict_from_vtm_params(params))
    return sd, params, jmodel, tmodel


def _video(arch, batch, seed):
    shape = (batch, arch["num_frames"], arch["img_size"], arch["img_size"], 3)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize(
    "mode,prop_attn,aggregation",
    [("none", True, "mean"), ("merge", True, "mean"), ("merge", False, "mean"), ("merge", True, "concat")],
)
def test_logits_match_vtm(mode, prop_attn, aggregation):
    rs = (1, 1) if mode == "merge" else (0, 0)
    kw = dict(rs=rs, mode=mode, prop_attn=prop_attn, head_aggregation=aggregation)
    _, params, jmodel, tmodel = _models(TINY, 7, JPolicy(**kw), MergePolicy(**kw))
    video = _video(TINY, 2, 0)
    with jax.default_matmul_precision("highest"):
        want, jstate = jmodel.apply({"params": params}, jnp.asarray(video))
    with torch.no_grad():
        got, tstate = tmodel(torch.from_numpy(video))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    if mode == "merge":
        np.testing.assert_array_equal(tstate.size.numpy(), np.asarray(jstate.size))


def test_sinusoid_table_matches_vtm():
    np.testing.assert_array_equal(sinusoid_encoding_table(64, 32), jax_sinusoid(64, 32))


def _teacher_forced(arch, r, batch, tol):
    """Each block gets the JAX chain's input; the port's block must make
    the same matching and the same output."""
    depth = arch["depth"]
    kw = dict(rs=(r,) * depth, mode="merge", prop_attn=True)
    _, params, _, tmodel = _models(arch, 7, JPolicy(**kw), MergePolicy(**kw))
    video = _video(arch, batch, 3)
    metrics = []
    for blk in tmodel.blocks:
        blk.attn.register_forward_hook(lambda m, i, o: metrics.append(o[1]))
    jconfig = JConfig(num_classes=7, **arch)
    with jax.default_matmul_precision("highest"), torch.no_grad():
        x = JTubeletEmbed(arch["embed_dim"], tubelet=arch["tubelet_size"], patch=arch["patch_size"]).apply(
            {"params": params["patch_embed"]}, jnp.asarray(video)
        )
        np.testing.assert_allclose(
            tmodel.patch_embed(torch.from_numpy(video)).numpy(), np.asarray(x), rtol=tol, atol=tol
        )
        x = x + jnp.asarray(jax_sinusoid(jconfig.tokens, arch["embed_dim"]))
        size = None
        for i in range(depth):
            p = params[f"blocks_{i}"]
            xn = JLayerNorm(epsilon=1e-6).apply({"params": p["norm1"]}, x)
            _, jmetric = JAttention(arch["embed_dim"], arch["num_heads"], True).apply(
                {"params": p["attn"]}, xn, size
            )
            want, jstate = JBlock(jconfig, JPolicy(**kw)).apply({"params": p}, x, JState(size=size), layer=i)
            metrics.clear()
            got, tstate = tmodel.blocks[i](
                torch.from_numpy(np.array(x)),
                MergeState(size=None if size is None else torch.from_numpy(np.array(size))),
                layer=i,
            )
            mj = jb.bipartite_soft_matching(jmetric, r)
            mt = tb.bipartite_soft_matching(metrics[0], r)
            for name in ("unm_idx", "src_idx", "dst_idx"):
                np.testing.assert_array_equal(
                    getattr(mt, name).numpy(), np.asarray(getattr(mj, name)), err_msg=f"layer {i} {name}"
                )
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol, err_msg=f"layer {i}")
            np.testing.assert_array_equal(tstate.size.numpy(), np.asarray(jstate.size))
            x, size = want, jstate.size


def test_four_layer_teacher_forced_matching_and_blocks():
    _teacher_forced(FOUR, r=8, batch=2, tol=1e-5)


@pytest.mark.slow
def test_vitb_teacher_forced_matching_and_blocks():
    """Full width: ViT-B/16 16x224, 1568 tokens, r=150, batch 1."""
    _teacher_forced(VITB, r=150, batch=1, tol=1e-4)


def test_hf_state_dict_loads_like_the_bridge():
    sd = _hf_state_dict(TINY)
    bridged = state_dict_from_vtm_params(convert_videomae(sd, depth=TINY["depth"]))
    direct = load_videomae_state_dict(sd)
    assert sorted(direct) == sorted(bridged)
    for k in direct:
        torch.testing.assert_close(direct[k], bridged[k], rtol=0, atol=0, msg=k)
    model = VideoMAE(VideoMAEConfig(num_classes=7, **TINY))
    model.load_state_dict(direct)


def test_original_names_with_wrapper_prefix_load():
    model = VideoMAE(VideoMAEConfig(num_classes=7, **TINY), seed=3)
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    loaded = load_videomae_state_dict(sd)
    assert loaded.keys() == model.state_dict().keys()
    VideoMAE(VideoMAEConfig(num_classes=7, **TINY)).load_state_dict(loaded)


def test_prefix_collision_raises():
    w = torch.zeros(3)
    with pytest.raises(KeyError, match="fc_norm.weight"):
        load_videomae_state_dict({"fc_norm.weight": w, "module.fc_norm.weight": w})


def test_compute_dtype_cast_keeps_norms_and_head_fp32():
    model = VideoMAE(VideoMAEConfig(num_classes=7, **TINY), dtype=torch.bfloat16)
    assert model.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert model.patch_embed.proj.weight.dtype == torch.bfloat16
    assert model.blocks[0].norm1.weight.dtype == torch.float32
    assert model.head.weight.dtype == torch.float32
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(_video(TINY, 2, 4)))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


def test_twin_heads_logits_match_vtm():
    """The EPIC-KITCHENS verb/noun heads: same features, two fp32 heads."""
    kw = dict(rs=(1, 1), mode="merge", prop_attn=False)
    classes = (5, 9)
    jmodel = JVideoMAE(config=JConfig(num_classes=classes, **TINY), policy=JPolicy(**kw))
    video = _video(TINY, 2, 6)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.key(2), jnp.asarray(video))["params"])
    tmodel = VideoMAE(VideoMAEConfig(num_classes=classes, **TINY), policy=MergePolicy(**kw)).eval()
    assert tmodel.config.multi_head and not hasattr(tmodel, "head")
    tmodel.load_state_dict(state_dict_from_vtm_params(params))
    with jax.default_matmul_precision("highest"):
        want, _ = jmodel.apply({"params": params}, jnp.asarray(video))
    with torch.no_grad():
        got, _ = tmodel(torch.from_numpy(video))
    assert len(got) == len(want) == 2
    for g, w, n in zip(got, want, classes):
        assert g.shape == (2, n) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_build_from_config_carries_heads_and_drop_rates():
    from vtm_torch.config import get_cfg
    from vtm_torch.models import build_model

    cfg = get_cfg()
    cfg.merge_from_list([
        "MODEL.MODEL_NAME", "VideoMAE", "VIDEOMAE.MODEL", "vit_small_patch16_224", "DATA.NUM_FRAMES", "4",
        "DATA.TRAIN_CROP_SIZE", "32", "EPICKITCHENS.NUM_CLASSES", "[97, 300]", "VIDEOMAE.DROP_PATH_RATE", "0.1",
        "VIDEOMAE.DROP_RATE", "0.05", "VIDEOMAE.FC_DROP_RATE", "0.5", "TPU.COMPUTE_DTYPE", "bfloat16",
    ])
    serve = build_model(cfg, "cpu").module
    assert not serve.training
    assert (serve.head0.out_features, serve.head1.out_features) == (97, 300)
    assert serve.head0.weight.dtype == torch.float32 and serve.head1.weight.dtype == torch.float32
    assert serve.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    c = serve.config
    assert (c.drop_rate, c.drop_path_rate, c.fc_drop_rate) == (0.05, 0.1, 0.5)
    assert serve.blocks[-1].drop_path_rate == pytest.approx(0.1) and serve.blocks[0].drop_path_rate == 0.0
    assert serve.blocks[3].mlp.drop == 0.05
    learn = build_model(cfg, "cpu", fp32_params=True).module
    assert all(p.dtype == torch.float32 for p in learn.parameters())
    cfg.VIDEOMAE.USE_MEAN_POOLING = False
    cls = build_model(cfg, "cpu").module
    assert not cls.config.use_mean_pooling and not hasattr(cls, "fc_norm")
    assert cls.norm.weight.dtype == torch.float32
    last = []
    cls.blocks[-1].register_forward_hook(lambda m, a, o: last.append(o[0]))
    video = torch.from_numpy(_video(dict(TINY, num_frames=4), 2, 9))
    with torch.no_grad():
        (verb, noun), _ = cls(video)
        feats = cls.norm(last[0])[:, 0].float()  # token 0 after norm over every token
    assert torch.equal(verb, cls.head0(feats)) and torch.equal(noun, cls.head1(feats))


@pytest.mark.parametrize("mode", VARIANT_MODES)
def test_merge_variants_match_vtm(mode, monkeypatch):
    """Every merge mode with source tracking (the random modes given JAX's
    draws): identical Matching indices layer by layer, identical sizes and
    sources, logits within 1e-4 as in the merged test above."""
    kw = dict(rs=(1, 2), prop_attn=True)
    video = _video(TINY, 2, 0)
    got, tstate, want, jstate, _ = run_variant(
        monkeypatch, mode, lambda k: _models(TINY, 7, JPolicy(**k), MergePolicy(**k))[1:], video, kw
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert_states_equal(tstate, jstate)
    assert tuple(tstate.source.shape) == (2, TINY_TOKENS - 3, TINY_TOKENS)


def _options_pair(overrides, kw, seed=3):
    """One VideoMAE with the pooling / layer-scale ``overrides`` in both
    packages, from the JAX package's init with its gammas moved off the
    constant (each block's own draw), so every gamma must land in place."""
    arch = dict(TINY, **overrides)
    video = _video(arch, 2, seed)
    jmodel = JVideoMAE(config=JConfig(num_classes=7, **arch), policy=JPolicy(**kw))
    params = jax.tree_util.tree_map(np.array, jmodel.init(jax.random.key(seed), jnp.asarray(video))["params"])
    rng = np.random.default_rng(seed)
    for name, blk in params.items():
        for g in ("gamma_1", "gamma_2"):
            if g in blk:
                blk[g] = (blk[g] + 0.05 * rng.standard_normal(blk[g].shape)).astype(np.float32)
    tmodel = VideoMAE(VideoMAEConfig(num_classes=7, **arch), policy=MergePolicy(**kw)).eval()
    tmodel.load_state_dict(state_dict_from_vtm_params(params))
    return video, params, jmodel, tmodel


OPTIONS = {
    "cls_pooling": dict(use_mean_pooling=False),
    "layer_scale": dict(init_values=0.1),
    "cls_pooling_layer_scale": dict(use_mean_pooling=False, init_values=0.1),
}


@pytest.mark.parametrize("mode", ["merge", "none"], ids=["merged", "unmerged"])
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_cls_pooling_and_layer_scale_match_vtm(option, mode, monkeypatch):
    """Logits within 1e-4 (fp32), identical Matching indices layer by layer
    and identical sizes, for class pooling (``norm`` over every token, then
    token 0) and layer scale at init_values 0.1."""
    from torch_variants import assert_same_matchings, record_matchings

    kw = dict(rs=(1, 1) if mode == "merge" else (0, 0), mode=mode, prop_attn=True)
    video, params, jmodel, tmodel = _options_pair(OPTIONS[option], kw)
    seen = record_matchings(monkeypatch)
    with jax.default_matmul_precision("highest"):
        want, jstate = jmodel.apply({"params": params}, jnp.asarray(video))
    with torch.no_grad():
        got, tstate = tmodel(torch.from_numpy(video))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    if mode == "merge":
        assert len(seen["torch"]) == TINY["depth"]
        assert_same_matchings(seen)
        np.testing.assert_array_equal(tstate.size.numpy(), np.asarray(jstate.size))


def test_layer_scale_starts_at_init_values_and_is_cast_at_use():
    model = VideoMAE(VideoMAEConfig(num_classes=7, init_values=0.1, **TINY), dtype=torch.bfloat16)
    names = {n for n, _ in model.named_parameters() if "gamma" in n}
    assert names == {f"blocks.{i}.gamma_{j}" for i in range(TINY["depth"]) for j in (1, 2)}
    assert all(torch.equal(p, torch.full((32,), 0.1)) for n, p in model.named_parameters() if "gamma" in n)
    assert model.blocks[0].gamma_1.dtype == torch.float32
    plain = VideoMAE(VideoMAEConfig(num_classes=7, **TINY))
    assert plain.blocks[0].gamma_1 is None and not any("gamma" in n for n, _ in plain.named_parameters())
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(_video(TINY, 2, 4)))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


def test_gamma_and_norm_round_trip():
    """port -> vtm -> port is exact with layer scale and class pooling, and
    a HuggingFace class-pooling checkpoint (``videomae.layernorm``) loads
    strictly, like the bridge."""
    model = VideoMAE(VideoMAEConfig(num_classes=7, use_mean_pooling=False, init_values=0.1, **TINY), seed=4)
    sd = model.state_dict()
    assert "norm.weight" in sd and "fc_norm.weight" not in sd and "blocks.1.gamma_2" in sd
    back = state_dict_from_vtm_params(convert_videomae({k: v.numpy() for k, v in sd.items()}, depth=TINY["depth"]))
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    hf = _hf_state_dict(TINY, use_mean_pooling=False)
    direct = load_videomae_state_dict(hf)
    bridged = state_dict_from_vtm_params(convert_videomae(hf, depth=TINY["depth"]))
    assert sorted(direct) == sorted(bridged) and "norm.weight" in direct
    for k in direct:
        torch.testing.assert_close(direct[k], bridged[k], rtol=0, atol=0, msg=k)
    VideoMAE(VideoMAEConfig(num_classes=7, use_mean_pooling=False, **TINY)).load_state_dict(direct)
