"""The port's divided space-time attention for Motionformer
(``ATTN_LAYER divided``) against the JAX package's, on the CPU in fp32:
the attention module in both directions, a tiny model with token merging
on (which such blocks ignore) and off, gradients, the converter's
``timeattn`` and ``norm3``, and the config path.

Weights come from a random upstream-layout state dict made with numpy
(``test_torch_motionformer._upstream_sd`` plus each block's ``timeattn``
and ``norm3``), through ``convert_motionformer`` and back through
``motionformer_state_dict_from_vtm_params``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vtm.train.losses as jlosses
from vtm.checkpoints.convert import convert_motionformer
from vtm.merge.policy import MergePolicy as JPolicy
from vtm.models.motionformer import DividedAttention as JDivided
from vtm.models.motionformer import Motionformer as JMotionformer
from vtm.models.motionformer import MotionformerConfig as JConfig
import vtm_torch.train.losses as tlosses
from vtm_torch.checkpoints.convert import load_motionformer_state_dict, motionformer_state_dict_from_vtm_params
from vtm_torch.merge.policy import MergePolicy
from vtm_torch.models.motionformer import DividedAttention, Motionformer, MotionformerConfig

from test_torch_motionformer import _upstream_sd
from torch_variants import record_matchings

torch.set_num_threads(2)

# 3 layers, 4 frames after the tubelet, 16 tokens each (8 raw frames of 64x64)
ARCH = dict(
    img_size=64, patch_size=16, patch_size_temp=2, num_classes=7, embed_dim=32, depth=3,
    num_heads=2, mlp_ratio=2.0, temporal_resolution=4, use_mlp=True, attn_layer="divided",
)
TOL = 1e-5  # fp32 module outputs
LOGIT_TOL = 1e-4
GRAD_TOL = 1e-4  # of the largest entry of each gradient tensor
# The k third of each qkv bias has a gradient that is zero analytically:
# every softmax here (the CLS row over all keys, each group over its keys
# and the CLS key) does not see a shift of its logits. It is rounding
# noise below GRAD_NOISE of the largest entry of any gradient.
GRAD_NOISE = 1e-6


def _divided_sd(arch, seed=0, std=0.1):
    """``_upstream_sd`` for a divided model: each block also gets its time
    attention ``timeattn.{qkv,proj}`` and its ``norm3``."""
    sd = _upstream_sd(arch, seed, std)
    rng = np.random.default_rng(seed + 100)
    d = arch["embed_dim"]
    for i in range(arch["depth"]):
        pre = f"blocks.{i}."
        for name, shape in (("timeattn.qkv", (3 * d, d)), ("timeattn.proj", (d, d))):
            sd[pre + name + ".weight"] = (rng.standard_normal(shape) * std).astype(np.float32)
            sd[pre + name + ".bias"] = (rng.standard_normal(shape[0]) * std).astype(np.float32)
        sd[pre + "norm3.weight"] = (1 + rng.standard_normal(d) * std).astype(np.float32)
        sd[pre + "norm3.bias"] = (rng.standard_normal(d) * std).astype(np.float32)
    return sd


def _video(arch, batch, seed):
    frames = arch["temporal_resolution"] * arch["patch_size_temp"]
    shape = (batch, frames, arch["img_size"], arch["img_size"], 3)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(arch, kw, train_mode=False, fp32_params=True, seed=0):
    params = jax.tree_util.tree_map(np.asarray, convert_motionformer(_divided_sd(arch, seed), depth=arch["depth"]))
    jmodel = JMotionformer(config=JConfig(**arch), policy=JPolicy(**kw), train_mode=train_mode)
    tmodel = Motionformer(MotionformerConfig(**arch), policy=MergePolicy(**kw), train_mode=train_mode,
                          fp32_params=fp32_params)
    tmodel.load_state_dict(motionformer_state_dict_from_vtm_params(params))
    return params, jmodel, tmodel


@pytest.mark.parametrize("to_time", [False, True], ids=["space", "time"])
def test_divided_attention_matches_vtm(to_time):
    params = convert_motionformer(_divided_sd(ARCH), depth=ARCH["depth"])["blocks_1"]
    p = params["timeattn" if to_time else "attn"]
    x = np.random.default_rng(2).standard_normal((2, 1 + 4 * 16, 32)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = JDivided(JConfig(**ARCH)).apply({"params": p}, jnp.asarray(x), 4, to_time=to_time)
    module = DividedAttention(MotionformerConfig(**ARCH))
    module.load_state_dict({f"{name}.{leaf}": torch.from_numpy(np.array(
        p[name]["kernel"].T if leaf == "weight" else p[name]["bias"]))
        for name in ("qkv", "proj") for leaf in ("weight", "bias")})
    with torch.no_grad():
        got = module(torch.from_numpy(x), 4, to_time=to_time)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_groups_are_frames_or_positions():
    """A body query sees only its group and the CLS key: moving a token in
    another frame (space) or at another position (time) leaves its output
    unchanged, moving one in its group does not."""
    torch.manual_seed(0)
    module = DividedAttention(MotionformerConfig(**ARCH)).eval()
    x = torch.randn(1, 1 + 4 * 16, 32)
    f, s = 4, 16
    for to_time, same in ((False, lambda a, b: a // s == b // s), (True, lambda a, b: a % s == b % s)):
        base = module(x, f, to_time=to_time)
        probe = 5  # body token 5: frame 0, position 5
        for other in (3, 21, 37):  # frame 0 pos 3; frame 1 pos 5; frame 2 pos 5
            y = x.clone()
            y[0, 1 + other] += 10.0
            moved = (module(y, f, to_time=to_time)[0, 1 + probe] - base[0, 1 + probe]).abs().max().item()
            assert (moved > 1e-4) == same(probe, other), (to_time, other, moved)


@pytest.mark.parametrize("tome", [True, False], ids=["tome_on", "tome_off"])
def test_model_matches_vtm_and_never_merges(tome, monkeypatch):
    """Probabilities within 1e-4; with merging on, no Matching is made in
    either package, no size is kept, and the output equals the unmerged
    model's bit for bit."""
    kw = dict(rs=(2,) * ARCH["depth"], mode="merge", prop_attn=True) if tome else dict()
    params, jmodel, tmodel = _pair(ARCH, kw)
    tmodel.eval()
    video = _video(ARCH, 2, 1)
    seen = record_matchings(monkeypatch)
    with jax.default_matmul_precision("highest"):
        want, jstate = jmodel.apply({"params": params}, jnp.asarray(video))
    with torch.no_grad():
        got, tstate = tmodel(torch.from_numpy(video))
        plain, _ = _pair(ARCH, {})[2].eval()(torch.from_numpy(video))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(got.sum(dim=-1).numpy(), 1.0, rtol=1e-5)
    assert seen == {"jax": [], "torch": []}
    assert tstate.size is None and jstate.size is None
    assert torch.equal(got, plain)


def test_gradients_match_vtm():
    """Loss and every parameter's gradient of one train step (logits,
    cross-entropy) against ``jax.grad``, ``timeattn`` and ``norm3``
    included; the k third of each qkv bias is named and must be noise."""
    params, jmodel, tmodel = _pair(ARCH, dict(rs=(2,) * ARCH["depth"], mode="merge"), train_mode=True)
    video = _video(ARCH, 2, 3)
    labels = np.random.default_rng(4).integers(0, ARCH["num_classes"], 2)

    def loss_fn(p):
        out, _ = jmodel.apply({"params": p}, jnp.asarray(video))
        return jlosses.cross_entropy(out, jnp.asarray(labels))

    with jax.default_matmul_precision("highest"):
        want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tmodel.train()
    out, _ = tmodel(torch.from_numpy(video))
    loss = tlosses.cross_entropy(out, torch.from_numpy(labels))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    want = {k: v.numpy() for k, v in motionformer_state_dict_from_vtm_params(
        jax.tree_util.tree_map(np.asarray, want_grads)).items()}
    named = dict(tmodel.named_parameters())
    assert sorted(want) == sorted(named)
    assert {n for n in named if "timeattn" in n or "norm3" in n} == {
        f"blocks.{i}.{m}.{leaf}" for i in range(3) for m in ("timeattn.qkv", "timeattn.proj", "norm3")
        for leaf in ("weight", "bias")}
    d = ARCH["embed_dim"]
    noise = GRAD_NOISE * max(np.abs(w).max() for w in want.values())
    for name, p in named.items():
        g, w = p.grad.numpy(), want[name]
        if name.endswith("qkv.bias"):
            assert np.abs(g[d:2 * d]).max() <= noise and np.abs(w[d:2 * d]).max() <= noise, name
            keep = np.r_[0:d, 2 * d:3 * d]
            g, w = g[keep], w[keep]
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * np.abs(w).max(), err_msg=name)
        if "timeattn" in name or "norm3" in name:
            assert np.abs(g).max() > 0, name


def test_upstream_state_dict_and_round_trip():
    """An upstream divided state dict loads strictly as it is and like the
    bridge through ``convert_motionformer``; port -> vtm -> port is exact."""
    sd = _divided_sd(ARCH, seed=1)
    direct = load_motionformer_state_dict(sd)
    bridged = motionformer_state_dict_from_vtm_params(convert_motionformer(sd, depth=ARCH["depth"]))
    assert sorted(direct) == sorted(bridged)
    for k in direct:
        assert torch.equal(direct[k], bridged[k]), k
    model = Motionformer(MotionformerConfig(**ARCH), seed=4)
    model.load_state_dict(direct)
    back = motionformer_state_dict_from_vtm_params(
        convert_motionformer({k: v.numpy() for k, v in model.state_dict().items()}, depth=ARCH["depth"]))
    assert back.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


def test_fp32_params_forward_is_bit_identical_to_precast_bf16():
    kw = dict(policy=MergePolicy(), dtype=torch.bfloat16, seed=5)
    serve = Motionformer(MotionformerConfig(**ARCH), **kw).eval()
    fit = Motionformer(MotionformerConfig(**ARCH), fp32_params=True, **kw).eval()
    assert serve.blocks[0].timeattn.qkv.weight.dtype == torch.bfloat16
    assert serve.blocks[0].norm3.weight.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in fit.parameters())
    video = torch.from_numpy(_video(ARCH, 2, 6))
    with torch.no_grad():
        a, _ = serve(video)
        b, _ = fit(video)
    assert a.dtype == torch.float32 and torch.equal(a, b)


def test_build_model_and_layer_duplication():
    """``ATTN_LAYER divided`` from a config; a duplicated block re-runs in
    full, as the trajectory blocks do."""
    from vtm_torch.config import get_cfg
    from vtm_torch.models import build_model

    cfg = get_cfg()
    cfg.merge_from_list([
        "MODEL.MODEL_NAME", "Motionformer", "MOTIONFORMER.EMBED_DIM", "32", "MOTIONFORMER.DEPTH", "2",
        "MOTIONFORMER.NUM_HEADS", "2", "MOTIONFORMER.TEMPORAL_RESOLUTION", "2", "DATA.TRAIN_CROP_SIZE", "32",
        "MOTIONFORMER.ATTN_LAYER", "divided", "TOME.ENABLE", "True", "TOME.R_VALUE", "1",
        "TOME.LAYER_TO_DUPLICATE", "0", "TOME.LAYER_QUANTITY", "2", "TPU.COMPUTE_DTYPE", "float32",
    ])
    bundle = build_model(cfg, "cpu")
    module = bundle.module
    assert module.config.attn_layer == "divided" and module.layer_schedule == (0, 0, 1)
    calls = []
    for i, blk in enumerate(module.blocks):
        blk.timeattn.register_forward_hook(lambda m, a, o, i=i: calls.append(i))
    video = torch.from_numpy(_video(dict(ARCH, img_size=32, temporal_resolution=2), 2, 7))
    with torch.no_grad():
        probs, state = module(video)
    assert calls == [0, 0, 1] and state.size is None and probs.shape == (2, 400)
    cfg.MOTIONFORMER.ATTN_LAYER = "axial"
    with pytest.raises(ValueError, match="attn_layer"):
        build_model(cfg, "cpu")
