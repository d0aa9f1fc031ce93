"""The port's Motionformer against the JAX package's, on the CPU in fp32.

Weights come from a random upstream-layout state dict made with numpy,
through ``convert_motionformer`` (JAX params) and back through
``motionformer_state_dict_from_vtm_params`` (the port's state dict), so
both packages run the same weights on the same numpy clip.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vtm.checkpoints.convert import convert_motionformer
from vtm.merge import bipartite as jb
from vtm.merge.policy import MergePolicy as JPolicy
from vtm.merge.policy import MergeState as JState
from vtm.models.common import LayerNorm as JLayerNorm
from vtm.models.common import TubeletEmbed as JTubeletEmbed
from vtm.models.motionformer import Motionformer as JMotionformer
from vtm.models.motionformer import MotionformerBlock as JBlock
from vtm.models.motionformer import MotionformerConfig as JConfig
from vtm.models.motionformer import TrajectoryAttention as JAttention
from vtm_torch.checkpoints.convert import (
    load_motionformer_state_dict,
    motionformer_state_dict_from_vtm_params,
)
from vtm_torch.merge import bipartite as tb
from vtm_torch.merge.policy import MergePolicy, MergeState
from vtm_torch.models.motionformer import Motionformer, MotionformerConfig

from torch_variants import VARIANT_MODES, assert_states_equal, run_variant

import jax

torch.set_num_threads(2)

# tests/test_motionformer.py's TINY: 2 frames after the tubelet, 4 tokens each
TINY = dict(
    img_size=32, patch_size=16, patch_size_temp=2, num_classes=5, embed_dim=32,
    depth=2, num_heads=2, mlp_ratio=2.0, temporal_resolution=2, use_mlp=True,
)
# 4 layers, 4 frames of 16 tokens (8 raw frames of 64x64)
FOUR = dict(TINY, img_size=64, temporal_resolution=4, depth=4)
VITB = dict(
    img_size=224, patch_size=16, patch_size_temp=2, num_classes=400, embed_dim=768,
    depth=12, num_heads=12, mlp_ratio=4.0, temporal_resolution=8, use_mlp=True,
)


def _upstream_sd(arch, seed=0, std=0.1):
    """A random upstream Motionformer state dict (numpy, fp32) for ``arch``
    (trajectory or joint attention, either patch embed, either position
    embedding, one head or the verb/noun pair); linear weights and
    embeddings drawn with standard deviation ``std``."""
    rng = np.random.default_rng(seed)
    d = arch["embed_dim"]
    hidden = int(d * arch["mlp_ratio"])
    p, pt = arch["patch_size"], arch["patch_size_temp"]
    s = (arch["img_size"] // p) ** 2
    f = arch["temporal_resolution"]

    def w(*shape, std=std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    if pt > 1:
        sd = {"patch_embed_3d.proj.weight": w(d, 3, pt, p, p, std=0.02), "patch_embed_3d.proj.bias": w(d)}
    else:
        sd = {"patch_embed.proj.weight": w(d, 3, p, p, std=0.02), "patch_embed.proj.bias": w(d)}
    sd.update({"cls_token": w(1, 1, d), "pos_embed": w(1, s + 1, d)})
    if arch.get("pos_embed_type", "separate") == "separate":
        sd["temp_embed"] = w(1, f, d)
    else:
        sd["st_embed"] = w(1, s * f + 1, d)
    sd.update({"norm.weight": 1 + w(d), "norm.bias": w(d)})
    classes = arch["num_classes"]
    heads = {"head": classes} if isinstance(classes, int) else {f"head{i}": n for i, n in enumerate(classes)}
    for name, n in heads.items():
        sd.update({f"{name}.weight": w(n, d), f"{name}.bias": w(n)})
    if arch.get("use_mlp"):
        sd.update({"pre_logits.fc.weight": w(d, d), "pre_logits.fc.bias": w(d)})
    linears = {"attn.qkv": (3 * d, d)}
    if arch.get("attn_layer", "trajectory") == "trajectory":
        linears.update({"attn.proj_q": (d, d), "attn.proj_kv": (2 * d, d)})
    linears.update({"attn.proj": (d, d), "mlp.fc1": (hidden, d), "mlp.fc2": (d, hidden)})
    for i in range(arch["depth"]):
        pre = f"blocks.{i}."
        for name, (out_f, in_f) in linears.items():
            sd[pre + name + ".weight"] = w(out_f, in_f)
            sd[pre + name + ".bias"] = w(out_f)
        for name in ("norm1", "norm2"):
            sd[pre + name + ".weight"] = 1 + w(d)
            sd[pre + name + ".bias"] = w(d)
    return sd


def _models(arch, kw, std=0.1):
    params = convert_motionformer(_upstream_sd(arch, std=std), depth=arch["depth"])
    jmodel = JMotionformer(config=JConfig(**arch), policy=JPolicy(**kw))
    tmodel = Motionformer(MotionformerConfig(**arch), policy=MergePolicy(**kw)).eval()
    tmodel.load_state_dict(motionformer_state_dict_from_vtm_params(params))
    return params, jmodel, tmodel


def _video(arch, batch, seed):
    frames = arch["temporal_resolution"] * arch["patch_size_temp"]
    shape = (batch, frames, arch["img_size"], arch["img_size"], 3)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize(
    "mode,prop_attn,use_mlp,original",
    [
        ("none", True, True, True),
        ("merge", True, True, True),
        ("merge", False, True, True),
        ("merge", True, False, True),
        ("merge", True, True, False),
    ],
)
def test_probabilities_match_vtm(mode, prop_attn, use_mlp, original):
    """fp32 probabilities within 1e-5 (fp32 sums in another order), and
    identical per-pseudo-frame sizes."""
    arch = dict(TINY, use_mlp=use_mlp, use_original_code=original)
    kw = dict(rs=(1, 1) if mode == "merge" else (0, 0), mode=mode, prop_attn=prop_attn)
    params, jmodel, tmodel = _models(arch, kw)
    video = _video(arch, 2, 0)
    with jax.default_matmul_precision("highest"):
        want, jstate = jmodel.apply({"params": params}, jnp.asarray(video))
    with torch.no_grad():
        got, tstate = tmodel(torch.from_numpy(video))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.sum(dim=-1).numpy(), 1.0, rtol=1e-5)
    if mode == "merge":
        assert tuple(tstate.size.shape) == (2 * arch["temporal_resolution"], 4 - 2, 1)
        np.testing.assert_array_equal(tstate.size.numpy(), np.asarray(jstate.size))


def _teacher_forced(arch, r, batch, tol, std):
    """Each block gets the JAX chain's input; the port's block must make
    the same matching and the same output."""
    depth, f = arch["depth"], arch["temporal_resolution"]
    kw = dict(rs=(r,) * depth, mode="merge", prop_attn=True)
    params, _, tmodel = _models(arch, kw, std)
    video = _video(arch, batch, 3)
    metrics = []
    for blk in tmodel.blocks:
        blk.attn.register_forward_hook(lambda m, i, o: metrics.append(o[1]))
    jconfig = JConfig(**arch)
    with jax.default_matmul_precision("highest"), torch.no_grad():
        emb = JTubeletEmbed(arch["embed_dim"], tubelet=arch["patch_size_temp"], patch=arch["patch_size"]).apply(
            {"params": params["patch_embed_3d"]}, jnp.asarray(video)
        )
        pos, temp = np.asarray(params["pos_embed"]), np.asarray(params["temp_embed"])
        s = pos.shape[1] - 1
        total = np.concatenate([pos[:, :1], np.tile(pos[:, 1:], (1, f, 1)) + np.repeat(temp, s, axis=1)], axis=1)
        cls = np.broadcast_to(np.asarray(params["cls_token"]), (batch, 1, arch["embed_dim"]))
        x = jnp.concatenate([jnp.asarray(cls), emb], axis=1) + jnp.asarray(total)
        np.testing.assert_allclose(tmodel.embed(torch.from_numpy(video)).numpy(), np.asarray(x), rtol=tol, atol=tol)
        size = None
        for i in range(depth):
            p = params[f"blocks_{i}"]
            xn = JLayerNorm(epsilon=1e-6).apply({"params": p["norm1"]}, x)
            _, jmetric = JAttention(jconfig).apply({"params": p["attn"]}, xn, f, size)
            want, jstate = JBlock(jconfig, JPolicy(**kw)).apply(
                {"params": p}, x, JState(size=size), layer=i, num_frames=f
            )
            metrics.clear()
            got, tstate = tmodel.blocks[i](
                torch.from_numpy(np.array(x)),
                MergeState(size=None if size is None else torch.from_numpy(np.array(size))),
                layer=i,
                num_frames=f,
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
    """16 tokens per frame, r=3: identical Matching indices, block outputs
    within 1e-5 (fp32)."""
    _teacher_forced(FOUR, r=3, batch=2, tol=1e-5, std=0.1)


@pytest.mark.slow
def test_vitb_teacher_forced_matching_and_blocks():
    """Full width: ViT-B/16 16x224, 8 frames of 196 tokens, r=18, batch 1;
    block outputs within 1e-4 (fp32, 768-wide sums). Weights have the
    upstream init's std 0.02: at this width std 0.1 makes each MLP
    multiply fp32 rounding differences by about 15."""
    _teacher_forced(VITB, r=18, batch=1, tol=1e-4, std=0.02)


def test_upstream_state_dict_loads_like_the_bridge():
    sd = _upstream_sd(TINY, seed=1)
    bridged = motionformer_state_dict_from_vtm_params(convert_motionformer(sd, depth=TINY["depth"]))
    direct = load_motionformer_state_dict(sd)
    assert sorted(direct) == sorted(bridged)
    for k in direct:
        torch.testing.assert_close(direct[k], bridged[k], rtol=0, atol=0, msg=k)
    model = Motionformer(MotionformerConfig(**TINY))
    model.load_state_dict(direct)
    video = torch.from_numpy(_video(TINY, 1, 2))
    with torch.no_grad():
        a, _ = model(video)
        model.load_state_dict(bridged)
        b, _ = model(video)
    assert torch.equal(a, b)


def test_round_trip_is_exact():
    """port state dict -> vtm params -> port state dict, bit for bit."""
    sd = Motionformer(MotionformerConfig(**TINY), seed=4).state_dict()
    back = motionformer_state_dict_from_vtm_params(
        convert_motionformer({k: v.numpy() for k, v in sd.items()}, depth=TINY["depth"])
    )
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_wrapper_prefix_loads():
    model = Motionformer(MotionformerConfig(**TINY), seed=3)
    loaded = load_motionformer_state_dict({f"module.{k}": v for k, v in model.state_dict().items()})
    assert loaded.keys() == model.state_dict().keys()
    Motionformer(MotionformerConfig(**TINY)).load_state_dict(loaded)


def test_prefix_collision_raises():
    w = torch.zeros(3)
    with pytest.raises(KeyError, match="norm.weight"):
        load_motionformer_state_dict({"norm.weight": w, "module.norm.weight": w})


@pytest.mark.parametrize(
    "overrides",
    [dict(attn_layer="divided"), dict(approx_attn_type="nystrom"), dict(approx_attn_type="performer")],
)
def test_unported_options_raise(overrides):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Motionformer(MotionformerConfig(**dict(TINY, **overrides)))


def test_unknown_options_raise():
    with pytest.raises(ValueError, match="head_act"):
        Motionformer(MotionformerConfig(**dict(TINY, head_act="swish")))
    with pytest.raises(ValueError, match="pos_embed_type"):
        Motionformer(MotionformerConfig(**dict(TINY, pos_embed_type="none")))


@pytest.mark.parametrize(
    "overrides,train_mode",
    [
        (dict(num_classes=(5, 7)), False),
        (dict(num_classes=(5, 7)), True),
        ({}, True),
        (dict(head_act="gelu"), False),
        (dict(head_act="relu"), False),
        (dict(pos_embed_type="joint"), False),
        (dict(patch_size_temp=1), False),
        (dict(attn_layer="joint"), False),
    ],
    ids=["twin_heads", "twin_heads_logits", "logits", "gelu", "relu", "joint_pos_embed", "patch_embed_2d",
         "joint_attention"],
)
def test_options_match_vtm(overrides, train_mode):
    """The options beyond the shipped trajectory config, merged with r=1:
    outputs within 1e-5 of the JAX package's, identical sizes, and an
    upstream-layout state dict that loads strictly."""
    arch = dict(TINY, **overrides)
    kw = dict(rs=(1, 1), mode="merge", prop_attn=True)
    sd = _upstream_sd(arch)
    params = convert_motionformer(sd, depth=arch["depth"])
    jmodel = JMotionformer(config=JConfig(**arch), policy=JPolicy(**kw), train_mode=train_mode)
    tmodel = Motionformer(MotionformerConfig(**arch), policy=MergePolicy(**kw), train_mode=train_mode).eval()
    tmodel.load_state_dict(load_motionformer_state_dict(sd))
    bridged = motionformer_state_dict_from_vtm_params(params)
    assert sorted(bridged) == sorted(tmodel.state_dict())
    for k, v in tmodel.state_dict().items():
        assert torch.equal(bridged[k], v), k
    video = _video(arch, 2, 0)
    with jax.default_matmul_precision("highest"):
        want, jstate = jmodel.apply({"params": params}, jnp.asarray(video))
    with torch.no_grad():
        got, tstate = tmodel(torch.from_numpy(video))
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
        if not train_mode:
            np.testing.assert_allclose(g.sum(dim=-1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(tstate.size.numpy(), np.asarray(jstate.size))


def test_compute_dtype_cast_keeps_norms_and_head_fp32():
    model = Motionformer(MotionformerConfig(**TINY), dtype=torch.bfloat16)
    assert model.blocks[0].attn.proj_kv.weight.dtype == torch.bfloat16
    assert model.patch_embed_3d.proj.weight.dtype == torch.bfloat16
    assert model.pre_logits.fc.weight.dtype == torch.bfloat16
    assert model.blocks[0].norm1.weight.dtype == torch.float32
    assert model.head.weight.dtype == torch.float32
    with torch.no_grad():
        probs, _ = model(torch.from_numpy(_video(TINY, 2, 4)))
    assert probs.dtype == torch.float32 and torch.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(dim=-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("mode", VARIANT_MODES)
def test_merge_variants_match_vtm(mode, monkeypatch):
    """Every merge mode with per-pseudo-frame source tracking (the random
    modes given JAX's draws): identical Matching indices layer by layer,
    identical sizes and sources, probabilities within 1e-5."""
    video = _video(TINY, 2, 0)
    got, tstate, want, jstate, _ = run_variant(
        monkeypatch, mode, lambda k: _models(TINY, k), video, dict(rs=(1, 1), prop_attn=True)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert_states_equal(tstate, jstate)
    assert tuple(tstate.source.shape) == (2 * TINY["temporal_resolution"], 2, 4)
