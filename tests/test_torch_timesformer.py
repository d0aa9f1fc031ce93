"""The port's TimeSformer against the JAX package's, on the CPU in fp32.

Weights come from a random HuggingFace-layout state dict made with numpy
(the names of ``TimesformerForVideoClassification``), loaded into the JAX
package through ``convert_timesformer`` and into the port through
``load_timesformer_state_dict``, so both packages run the same weights on
the same numpy clip.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vtm.checkpoints.convert import convert_timesformer
from vtm.merge import bipartite as jb
from vtm.merge.policy import MergePolicy as JPolicy
from vtm.merge.policy import MergeState as JState
from vtm.models.timesformer import TimeSformer as JTimeSformer
from vtm.models.timesformer import TimeSformerBlock as JBlock
from vtm.models.timesformer import TimeSformerConfig as JConfig

import vtm_torch.config as tcfg
from vtm_torch.checkpoints.convert import (
    _hf_timesformer_to_original,
    load_timesformer_state_dict,
    timesformer_state_dict_from_vtm_params,
)
from vtm_torch.merge import bipartite as tb
from vtm_torch.merge.policy import MergePolicy, MergeState
from vtm_torch.models import build_model
from vtm_torch.models.timesformer import TimeSformer, TimeSformerAttention, TimeSformerConfig

from torch_variants import VARIANT_MODES, assert_states_equal, run_variant

torch.set_num_threads(2)

# tests/test_timesformer.py's TINY: 4 frames of 4 patches
TINY = dict(img_size=32, patch_size=16, num_classes=5, embed_dim=32, depth=2, num_heads=2,
            mlp_ratio=2.0, num_frames=4)
# 4 layers, width 64, 4 frames of 16 patches
FOUR = dict(TINY, img_size=64, embed_dim=64, depth=4)
VITB = dict(img_size=224, patch_size=16, num_classes=400, embed_dim=768, depth=12, num_heads=12,
            mlp_ratio=4.0, num_frames=8)
ATTENTION_TYPES = ("divided_space_time", "space_only", "joint_space_time")


def _divided(arch):
    return arch.get("attention_type", "divided_space_time") == "divided_space_time"


def _hf_sd(arch, seed=0, std=0.1, temporal=True, pos_tokens=None, frames=None):
    """A random HuggingFace TimeSformer state dict (numpy, fp32) for
    ``arch``: one classifier, or original-layout ``head0`` / ``head1`` for
    the twin heads. ``temporal=False`` leaves the temporal attention out
    (an image ViT); ``pos_tokens`` / ``frames`` give the embeddings another
    length than the model's."""
    rng = np.random.default_rng(seed)
    d = arch["embed_dim"]
    hidden = int(d * arch["mlp_ratio"])
    p = arch["patch_size"]
    s = pos_tokens or (arch["img_size"] // p) ** 2
    divided = _divided(arch)

    def w(*shape, std=std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    e = "timesformer.embeddings."
    sd = {
        e + "cls_token": w(1, 1, d), e + "position_embeddings": w(1, s + 1, d),
        e + "patch_embeddings.projection.weight": w(d, 3, p, p, std=0.02),
        e + "patch_embeddings.projection.bias": w(d),
        "timesformer.layernorm.weight": 1 + w(d), "timesformer.layernorm.bias": w(d),
    }
    if arch.get("attention_type") != "space_only":
        sd[e + "time_embeddings"] = w(1, frames or arch["num_frames"], d)
    classes = arch["num_classes"]
    heads = {"classifier": classes} if isinstance(classes, int) else {f"head{i}": n for i, n in enumerate(classes)}
    for name, n in heads.items():
        sd.update({f"{name}.weight": w(n, d), f"{name}.bias": w(n)})
    linears = {"attention.attention.qkv": (3 * d, d), "attention.output.dense": (d, d),
               "intermediate.dense": (hidden, d), "output.dense": (d, hidden)}
    norms = ["layernorm_before", "layernorm_after"]
    if divided and temporal:
        linears.update({"temporal_attention.attention.qkv": (3 * d, d),
                        "temporal_attention.output.dense": (d, d), "temporal_dense": (d, d)})
        norms.append("temporal_layernorm")
    for i in range(arch["depth"]):
        pre = f"timesformer.encoder.layer.{i}."
        for name, (out_f, in_f) in linears.items():
            sd[pre + name + ".weight"] = w(out_f, in_f)
            sd[pre + name + ".bias"] = w(out_f)
        for name in norms:
            sd[pre + name + ".weight"] = 1 + w(d)
            sd[pre + name + ".bias"] = w(d)
    if not isinstance(classes, int):
        # the twin heads exist only under the original names: the whole dict goes there
        sd = {**_hf_timesformer_to_original(sd), **{k: v for k, v in sd.items() if k.startswith("head")}}
    return sd


def _models(arch, kw, std=0.1, seed=0):
    sd = _hf_sd(arch, seed=seed, std=std)
    s = (arch["img_size"] // arch["patch_size"]) ** 2
    params = convert_timesformer(sd, depth=arch["depth"], num_frames=arch["num_frames"], spatial_tokens=s)
    jmodel = JTimeSformer(config=JConfig(**arch), policy=JPolicy(**kw))
    tmodel = TimeSformer(TimeSformerConfig(**arch), policy=MergePolicy(**kw)).eval()
    tmodel.load_state_dict(load_timesformer_state_dict(
        sd, num_frames=arch["num_frames"], spatial_tokens=s, divided=_divided(arch)))
    return params, jmodel, tmodel


def _video(arch, batch, seed):
    shape = (batch, arch["num_frames"], arch["img_size"], arch["img_size"], 3)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(arch, kw, batch=2, seed=0):
    params, jmodel, tmodel = _models(arch, kw)
    video = _video(arch, batch, seed)
    with jax.default_matmul_precision("highest"):
        want, jstate = jmodel.apply({"params": params}, jnp.asarray(video))
    with torch.no_grad():
        got, tstate = tmodel(torch.from_numpy(video))
    return got, tstate, want, jstate


@pytest.mark.parametrize("attention_type", ATTENTION_TYPES)
def test_unmerged_logits_match_vtm(attention_type):
    arch = dict(TINY, attention_type=attention_type)
    got, _, want, _ = _both(arch, dict(rs=(0, 0), mode="none"))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("prop_attn", [True, False], ids=["prop_attn", "no_prop_attn"])
@pytest.mark.parametrize("num_classes", [5, (5, 7)], ids=["single_head", "twin_heads"])
def test_merged_logits_and_sizes_match_vtm(prop_attn, num_classes):
    """r = 1 per frame in both layers: 4 -> 3 -> 2 patches a frame."""
    arch = dict(TINY, num_classes=num_classes)
    got, tstate, want, jstate = _both(arch, dict(rs=(1, 1), mode="merge", prop_attn=prop_attn))
    if isinstance(num_classes, int):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    assert tuple(tstate.size.shape) == (2 * arch["num_frames"], 2, 1)
    np.testing.assert_array_equal(tstate.size.numpy(), np.asarray(jstate.size))


@pytest.mark.parametrize("attention_type", ATTENTION_TYPES[1:])
def test_other_attention_types_do_not_merge(attention_type):
    """Only the divided block merges, in both packages."""
    arch = dict(TINY, attention_type=attention_type)
    got, tstate, want, jstate = _both(arch, dict(rs=(1, 1), mode="merge", prop_attn=True))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert tstate.size is None and jstate.size is None


def _teacher_forced(arch, r, batch, tol, std, prop_attn=True):
    """Each block gets the JAX chain's input; the port's block must make
    the same matching and the same output."""
    depth, t = arch["depth"], arch["num_frames"]
    kw = dict(rs=(r,) * depth, mode="merge", prop_attn=prop_attn)
    params, _, tmodel = _models(arch, kw, std)
    video = _video(arch, batch, 3)
    metrics = []
    for blk in tmodel.blocks:
        blk.attn.register_forward_hook(lambda m, i, o: metrics.append(o[1]))
    jconfig = JConfig(**arch)
    with jax.default_matmul_precision("highest"), torch.no_grad():
        x = jnp.asarray(tmodel.embed(torch.from_numpy(video)).numpy())
        size = None
        for i in range(depth):
            (want, jstate), inter = JBlock(jconfig, JPolicy(**kw)).apply(
                {"params": params[f"blocks_{i}"]}, x, JState(size=size), layer=i, b=batch, t=t,
                capture_intermediates=True,
            )
            jmetric = inter["intermediates"]["attn"]["__call__"][0][1]
            metrics.clear()
            got, tstate = tmodel.blocks[i](
                torch.from_numpy(np.array(x)),
                MergeState(size=None if size is None else torch.from_numpy(np.array(size))),
                layer=i, b=batch, t=t,
            )
            assert tuple(metrics[0].shape) == jmetric.shape
            mj = jb.bipartite_soft_matching(jmetric, r)
            mt = tb.bipartite_soft_matching(metrics[0], r)
            for name in ("unm_idx", "src_idx", "dst_idx"):
                np.testing.assert_array_equal(
                    getattr(mt, name).numpy(), np.asarray(getattr(mj, name)), err_msg=f"layer {i} {name}"
                )
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol, err_msg=f"layer {i}")
            np.testing.assert_array_equal(tstate.size.numpy(), np.asarray(jstate.size))
            x, size = want, jstate.size
    return x


@pytest.mark.parametrize("prop_attn", [True, False], ids=["prop_attn", "no_prop_attn"])
def test_four_layer_teacher_forced_matching_and_blocks(prop_attn):
    """16 patches a frame, r = 3: identical Matching indices, block outputs
    within 1e-4 (fp32)."""
    x = _teacher_forced(FOUR, r=3, batch=2, tol=1e-4, std=0.1, prop_attn=prop_attn)
    assert x.shape[1] == 1 + 4 * (16 - 4 * 3)


@pytest.mark.slow
def test_vitb_teacher_forced_matching_and_blocks():
    """Full width: ViT-B/16 8x224, 8 frames of 196 patches, r = 18, batch
    1; block outputs within 1e-4 (fp32, 768-wide sums), weights at the
    upstream init's std 0.02."""
    _teacher_forced(VITB, r=18, batch=1, tol=1e-4, std=0.02)


def test_embedding_matches_vtm_token_order():
    """The first block's input: CLS, then the body in (p t) order with the
    position and time embeddings; held through a depth-0 logits check of
    the norm and head on the CLS token, and by shape."""
    params, _, tmodel = _models(TINY, dict(rs=(0, 0), mode="none"))
    video = _video(TINY, 2, 1)
    with torch.no_grad():
        x = tmodel.embed(torch.from_numpy(video))
    assert tuple(x.shape) == (2, 1 + 4 * 4, 32)
    pos, te = np.asarray(params["pos_embed"]), np.asarray(params["time_embed"])
    np.testing.assert_allclose(x[:, 0].numpy(), np.broadcast_to(np.asarray(params["cls_token"])[0] + pos[0, :1], (2, 32)),
                               rtol=1e-6, atol=1e-6)
    # body token (p, t) = patch p of frame t
    kernel = np.asarray(params["patch_embed"]["kernel"])  # [kh, kw, C, D]
    patch = video[1, 2, 16:32, 0:16]  # frame 2, patch row 1 col 0 -> p = 2
    want = np.einsum("hwc,hwcd->d", patch, kernel) + np.asarray(params["patch_embed"]["bias"]) + pos[0, 1 + 2] + te[0, 2]
    np.testing.assert_allclose(x[1, 1 + 2 * 4 + 2].numpy(), want, rtol=1e-4, atol=1e-4)


def test_frames_attention_equals_batch_attention():
    """The block-diagonal formulation of the divided spatial attention (the
    one a CUDA tensor takes) equals ``attention_core`` on the (b t) batch,
    outputs and head-mean keys, with and without token sizes."""
    attn = TimeSformerAttention(32, 2, qkv_bias=True)
    rng = np.random.default_rng(2)
    b, t, n = 2, 4, 7
    qkv = torch.from_numpy(rng.standard_normal((b * t, n, 96)).astype(np.float32))
    size = torch.from_numpy(rng.uniform(1, 4, (b * t, n - 1, 1)).astype(np.float32))
    for sz in (None, size):
        out_f, k_f = attn.frames_attention(qkv, sz, t)
        out_b, k_b = attn.batch_attention(qkv, sz)
        torch.testing.assert_close(out_f, out_b, rtol=1e-5, atol=1e-5)
        assert tuple(k_f.shape) == (b * t, n, 16) and torch.equal(k_f, k_b)


def test_hf_state_dict_loads_like_the_bridge():
    """HF names -> the port's names directly, and through the JAX package's
    converter and back: the same tensors, bit for bit."""
    for arch in (TINY, dict(TINY, num_classes=(5, 7)), dict(TINY, attention_type="space_only")):
        sd = _hf_sd(arch, seed=1)
        bridged = timesformer_state_dict_from_vtm_params(
            convert_timesformer(sd, depth=arch["depth"], num_frames=4, spatial_tokens=4))
        direct = load_timesformer_state_dict(sd, num_frames=4, spatial_tokens=4, divided=_divided(arch))
        # the JAX package's converter gives every model the image-ViT rule's
        # temporal entries; a model without temporal attention ignores them
        assert set(direct) <= set(bridged) and (set(direct) == set(bridged)) == _divided(arch)
        for k in direct:
            assert torch.equal(direct[k], bridged[k]), k
        TimeSformer(TimeSformerConfig(**arch)).load_state_dict(direct)


def test_round_trip_is_exact():
    """port state dict -> vtm params -> port state dict, bit for bit, with
    a wrapper prefix on the way in."""
    sd = TimeSformer(TimeSformerConfig(**TINY), seed=4).state_dict()
    back = timesformer_state_dict_from_vtm_params(
        convert_timesformer({f"module.{k}": v.numpy() for k, v in sd.items()}, depth=TINY["depth"]))
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    loaded = load_timesformer_state_dict({f"model.{k}": v for k, v in sd.items()})
    assert loaded.keys() == sd.keys() and all(torch.equal(loaded[k], sd[k]) for k in sd)


def test_pos_and_time_embed_interpolation_matches_vtm():
    """A checkpoint made for 9 patches and 6 frames, loaded into a model of
    4 patches and 4 frames: nearest-neighbour resize, the CLS position
    kept, as the JAX package's converter does it."""
    sd = _hf_sd(TINY, seed=2, pos_tokens=9, frames=6)
    want = timesformer_state_dict_from_vtm_params(
        convert_timesformer(sd, depth=TINY["depth"], num_frames=4, spatial_tokens=4))
    got = load_timesformer_state_dict(sd, num_frames=4, spatial_tokens=4)
    assert tuple(got["pos_embed"].shape) == (1, 5, 32) and tuple(got["time_embed"].shape) == (1, 4, 32)
    for k in ("pos_embed", "time_embed"):
        assert torch.equal(got[k], want[k]), k
    src = sd["timesformer.embeddings.position_embeddings"]
    np.testing.assert_array_equal(got["pos_embed"][0, 0].numpy(), src[0, 0])
    np.testing.assert_array_equal(got["pos_embed"][0, 1:].numpy(), src[0, 1 + np.array([0, 2, 4, 6])])
    TimeSformer(TimeSformerConfig(**TINY)).load_state_dict(got)


def test_image_vit_init_rule_matches_vtm():
    """An image ViT's blocks (no temporal attention): temporal attention
    and its norm copy the spatial ones, temporal_fc is zero; logits equal
    the JAX package's."""
    sd = _hf_sd(TINY, seed=3, temporal=False)
    params = convert_timesformer(sd, depth=TINY["depth"], num_frames=4, spatial_tokens=4)
    got = load_timesformer_state_dict(sd, num_frames=4, spatial_tokens=4)
    want = timesformer_state_dict_from_vtm_params(params)
    assert sorted(got) == sorted(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert torch.count_nonzero(got["blocks.1.temporal_fc.weight"]) == 0
    assert torch.equal(got["blocks.1.temporal_attn.qkv.weight"], got["blocks.1.attn.qkv.weight"])
    assert torch.equal(got["blocks.0.temporal_norm1.bias"], got["blocks.0.norm1.bias"])
    tmodel = TimeSformer(TimeSformerConfig(**TINY)).eval()
    tmodel.load_state_dict(got)
    video = _video(TINY, 2, 5)
    with jax.default_matmul_precision("highest"):
        logits, _ = JTimeSformer(config=JConfig(**TINY)).apply({"params": params}, jnp.asarray(video))
    with torch.no_grad():
        mine, _ = tmodel(torch.from_numpy(video))
    np.testing.assert_allclose(mine.numpy(), np.asarray(logits), rtol=1e-5, atol=1e-5)


def test_prefix_collision_raises():
    sd = {k: torch.from_numpy(v) for k, v in _hf_sd(TINY).items()}
    orig = load_timesformer_state_dict(sd)
    with pytest.raises(KeyError, match="norm.weight"):
        load_timesformer_state_dict({**orig, "module.norm.weight": orig["norm.weight"]})


def test_wrong_input_size_raises():
    model = TimeSformer(TimeSformerConfig(**TINY))
    with pytest.raises(ValueError, match="spatial tokens"):
        model(torch.zeros(1, 4, 64, 64, 3))
    with pytest.raises(ValueError, match="frames"):
        model(torch.zeros(1, 2, 32, 32, 3))
    with pytest.raises(ValueError, match="attention_type"):
        TimeSformer(TimeSformerConfig(**dict(TINY, attention_type="axial")))


def test_compute_dtype_cast_keeps_norms_and_head_fp32():
    model = TimeSformer(TimeSformerConfig(**TINY), dtype=torch.bfloat16)
    assert model.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert model.blocks[0].temporal_fc.weight.dtype == torch.bfloat16
    assert model.patch_embed.proj.weight.dtype == torch.bfloat16
    assert model.blocks[0].norm1.weight.dtype == torch.float32
    assert model.head.weight.dtype == torch.float32
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(_video(TINY, 2, 4)))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


def _cfg(*opts):
    cfg = tcfg.get_cfg()
    cfg.merge_from_list(["MODEL.MODEL_NAME", "TimeSformer", "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
                         "DATA.NUM_FRAMES", "2", "MODEL.NUM_CLASSES", "7", "TPU.COMPUTE_DTYPE", "float32", *opts])
    return cfg


def test_build_model_reads_the_config():
    """``build_model``: the ViT-B widths, the crop, the frames, the
    attention type and the heads from the config; no class token protected
    in the merge; layer duplication goes on raising."""
    bundle = build_model(_cfg("TOME.ENABLE", "True", "TOME.R_VALUE", "1", "EPICKITCHENS.NUM_CLASSES", "[5, 7]"), "cpu")
    c = bundle.module.config
    assert bundle.name == "TimeSformer" and (c.embed_dim, c.depth, c.num_heads) == (768, 12, 12)
    assert (c.img_size, c.num_frames, c.attention_type) == (32, 2, "divided_space_time")
    assert c.multi_head and bundle.module.head0.out_features == 5 and bundle.module.head1.out_features == 7
    assert bundle.policy.class_token is False and bundle.policy.rs == (1,) * 12
    assert not bundle.module.training
    space = build_model(_cfg("TIMESFORMER.ATTENTION_TYPE", "space_only"), "cpu").module
    assert not hasattr(space, "time_embed") and not hasattr(space.blocks[0], "temporal_attn")
    dup = build_model(_cfg("TOME.ENABLE", "True", "TOME.R_VALUE", "1", "TOME.LAYER_QUANTITY", "2"), "cpu")
    assert dup.module.layer_schedule == (0,) + tuple(range(12)) and dup.policy.rs == (1, 1) + (0,) * 11


@pytest.mark.parametrize("mode", VARIANT_MODES)
def test_merge_variants_match_vtm(mode, monkeypatch):
    """Every merge mode with per-frame source tracking (the random modes
    given JAX's draws): identical Matching indices layer by layer,
    identical sizes and sources, logits within 1e-5."""
    video = _video(TINY, 2, 0)
    got, tstate, want, jstate, _ = run_variant(
        monkeypatch, mode, lambda k: _models(TINY, k), video, dict(rs=(1, 1), prop_attn=True)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert_states_equal(tstate, jstate)
    assert tuple(tstate.source.shape) == (2 * TINY["num_frames"], 2, 4)
