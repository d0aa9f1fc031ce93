"""Layer duplication in the port against the JAX package, on the CPU.

``duplication_plan`` and the duplication r schedule, each family's executed
stack (``layer_schedule``) built from the config and by
``patch.duplicate_*``, ``bundle.r`` parsed against the grown stack, and
tiny forwards of all four families with one block run several times:
identical Matching indices at every step (the random mode given JAX's
draws), identical sizes and sources, logits within the families' own
merged-test tolerances.
"""

import json

import jax  # noqa: F401  (the JAX package's CPU setup first, as the other parity tests do)
import numpy as np
import pytest
import torch

import vtm.patch as jax_patch
from vtm.config import get_cfg as jax_get_cfg
from vtm.merge.policy import MergePolicy as JPolicy
from vtm.models import build_model as jax_build_model
from vtm.models.build import duplication_plan as jax_duplication_plan
from vtm.models.build import make_policy as jax_make_policy
from vtm_torch import patch
from vtm_torch.config import get_cfg
from vtm_torch.merge.policy import MergePolicy
from vtm_torch.models import build_model
from vtm_torch.models.build import duplication_plan, make_policy

import test_torch_motionformer as mf
import test_torch_timesformer as ts
import test_torch_videomae as vm
import test_torch_vivit as vv
from torch_variants import assert_states_equal, run_variant

torch.set_num_threads(2)


@pytest.mark.parametrize("enable", [True, False])
@pytest.mark.parametrize("layer,quantity,depth", [(0, 12, 12), (11, 12, 12), (1, 3, 4), (2, 1, 4), (0, 2, 2)])
def test_plan_and_schedule_match_vtm(layer, quantity, depth, enable):
    cfg, jcfg = get_cfg(), jax_get_cfg()
    opts = ["TOME.ENABLE", str(enable), "TOME.R_VALUE", "131", "TOME.LAYER_TO_DUPLICATE", str(layer),
            "TOME.LAYER_QUANTITY", str(quantity), "TOME.MODE", "hybrid", "TOME.THRESHOLD", "0.4",
            "TOME.TRACE_SOURCE", "True"]
    cfg.merge_from_list(opts)
    jcfg.merge_from_list(opts)
    plan = duplication_plan(cfg, depth)
    assert plan == jax_duplication_plan(jcfg, depth)
    if enable and quantity > 1:
        assert len(plan) == depth - 1 + quantity
        assert sum(metric_only for _, metric_only in plan) == quantity - 1
    else:
        assert plan is None
    policy, jpolicy = make_policy(cfg, depth, True), jax_make_policy(jcfg, depth, True)
    for field in ("rs", "mode", "threshold", "trace_source", "class_token", "prop_attn"):
        assert getattr(policy, field) == getattr(jpolicy, field), field


def _vivit_json(tmp_path):
    d = {"video_size": [4, 32, 32], "tubelet_size": [2, 16, 16], "num_channels": 3, "hidden_size": 32,
         "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 64, "hidden_act": "gelu_fast",
         "layer_norm_eps": 1e-6, "qkv_bias": True}
    path = tmp_path / "vivit.json"
    path.write_text(json.dumps(d))
    return str(path)


# family -> (tiny opts, tokens of one clip as the policy counts them, what a
# block's input length becomes in that count, the module's block list)
FAMILIES = {
    "videomae": (lambda p: ["MODEL.MODEL_NAME", "VideoMAE", "VIDEOMAE.MODEL", "vit_small_patch16_224",
                            "DATA.NUM_FRAMES", "4"], 8, lambda n: n, "blocks"),
    "vivit": (lambda p: ["MODEL.MODEL_NAME", "ViViT", "VIVIT.CONFIG_PATH", _vivit_json(p), "DATA.NUM_FRAMES", "4"],
              9, lambda n: n, "layer"),
    "timesformer": (lambda p: ["MODEL.MODEL_NAME", "TimeSformer", "DATA.NUM_FRAMES", "2"],
                    4, lambda n: (n - 1) // 2, "blocks"),
    "motionformer": (lambda p: ["MODEL.MODEL_NAME", "Motionformer", "MOTIONFORMER.EMBED_DIM", "32",
                                "MOTIONFORMER.DEPTH", "2", "MOTIONFORMER.NUM_HEADS", "2",
                                "MOTIONFORMER.TEMPORAL_RESOLUTION", "2", "DATA.NUM_FRAMES", "4"],
                     4, lambda n: (n - 1) // 2, "blocks"),
}
COMMON = ["DATA.TEST_CROP_SIZE", "32", "DATA.TRAIN_CROP_SIZE", "32", "MODEL.NUM_CLASSES", "5",
          "TPU.COMPUTE_DTYPE", "float32"]


def _bundles(family, tmp_path, *opts):
    opts = FAMILIES[family][0](tmp_path) + COMMON + list(opts)
    cfg, jcfg = get_cfg(), jax_get_cfg()
    cfg.merge_from_list(opts)
    jcfg.merge_from_list(opts)
    return cfg, build_model(cfg, "cpu"), jax_build_model(jcfg, init=False)


def _executed_counts(bundle, family, frames):
    """Tokens entering each executed step and leaving the last, counted
    as the policy counts them."""
    _, _, tokens_of, blocks = FAMILIES[family]
    seen = []
    hooks = [b.register_forward_pre_hook(lambda m, a: seen.append(tokens_of(a[0].shape[1])))
             for b in getattr(bundle.module, blocks)]
    video = torch.from_numpy(np.random.default_rng(0).standard_normal((1, frames, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        _, state = bundle.apply(video)
    for h in hooks:
        h.remove()
    return seen, state


@pytest.mark.parametrize("family", list(FAMILIES))
def test_config_duplication_builds_the_grown_stack_as_vtm_does(family, tmp_path):
    """TOME.LAYER_QUANTITY 3 of block 1: the same executed stack and r
    schedule as vtm's, the same weights (no block added), every executed
    step seen by a forward with the tokens ``token_counts`` gives, and
    ``bundle.r`` parsed against the grown stack."""
    dup = ("TOME.ENABLE", "True", "TOME.R_VALUE", "1", "TOME.LAYER_TO_DUPLICATE", "1", "TOME.LAYER_QUANTITY", "3")
    cfg, bundle, jbundle = _bundles(family, tmp_path, *dup)
    _, plain, _ = _bundles(family, tmp_path, "TOME.ENABLE", "True", "TOME.R_VALUE", "1")
    depth = bundle.module.config.depth
    assert bundle.module.layer_schedule == tuple(jbundle.module.layer_schedule)
    assert len(bundle.module.layer_schedule) == depth + 2 and plain.module.layer_schedule is None
    assert bundle.policy.rs == jbundle.policy.rs == (0, 1, 1, 1) + (0,) * (depth - 2)
    assert bundle.module.state_dict().keys() == plain.module.state_dict().keys()
    n0 = FAMILIES[family][1]
    seen, state = _executed_counts(bundle, family, cfg.DATA.NUM_FRAMES)
    want = bundle.policy.token_counts(n0)
    assert tuple(seen) == want[:-1] and want == tuple(jbundle.policy.token_counts(n0))
    assert state.size.shape[1] == want[-1]
    for value in (2, (2, 1.0), [1, 0, 2]):
        bundle.r = value
        jbundle.r = value
        assert bundle.r == jbundle.r and len(bundle.r) == depth + 2
        assert all(m.policy is bundle.policy for m in bundle.module.modules() if hasattr(m, "policy"))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_patch_duplicate_then_r_as_vtm_does(family, tmp_path):
    """``patch.<family>`` then ``patch.duplicate_<family>(layer 0, 3)`` then
    ``bundle.r = 1`` in both packages: the same stack and schedule, and a
    forward through it."""
    cfg, bundle, jbundle = _bundles(family, tmp_path)
    for pkg, b in ((patch, bundle), (jax_patch, jbundle)):
        getattr(pkg, family)(b)
        getattr(pkg, f"duplicate_{family}")(b, layer_to_duplicate=0, quantity=3)
        b.r = 1
    assert bundle.module.layer_schedule == tuple(jbundle.module.layer_schedule)
    assert bundle.r == jbundle.r == (1,) * (bundle.module.config.depth + 2)
    n0 = FAMILIES[family][1]
    seen, _ = _executed_counts(bundle, family, cfg.DATA.NUM_FRAMES)
    assert tuple(seen) == bundle.policy.token_counts(n0)[:-1] == tuple(jbundle.policy.token_counts(n0))[:-1]


def _videomae_models(schedule):
    def models(kw):
        _, params, jmodel, tmodel = vm._models(vm.TINY, 7, JPolicy(**kw), MergePolicy(**kw))
        tmodel.layer_schedule = schedule
        return params, jmodel.clone(layer_schedule=schedule), tmodel
    return models


def _family_models(module, schedule):
    def models(kw):
        params, jmodel, tmodel = module._models(module.TINY, kw)
        tmodel.layer_schedule = schedule
        return params, jmodel.clone(layer_schedule=schedule), tmodel
    return models


# family -> (the models with the schedule, the video, the policy keywords,
# the logits tolerance of the family's merged test)
DUPLICATED = {
    "videomae": lambda: (_videomae_models(((0, True), (0, True), (0, False), (1, False))),
                         vm._video(vm.TINY, 2, 0), dict(rs=(1, 1, 1, 0)), 1e-4),
    "vivit": lambda: (_family_models(vv, ((0, False), (1, True), (1, False))),
                      vv._video(vv.TINY, 2, 0), dict(rs=(0, 2, 2), class_token=True), 1e-5),
    "timesformer": lambda: (_family_models(ts, (0, 1, 1)), ts._video(ts.TINY, 2, 0), dict(rs=(0, 1, 1)), 1e-5),
    "motionformer": lambda: (_family_models(mf, (0, 0, 1)), mf._video(mf.TINY, 2, 0), dict(rs=(1, 1, 0)), 1e-5),
}


@pytest.mark.parametrize("mode", ["merge", "random_drop"])
@pytest.mark.parametrize("family", list(DUPLICATED))
def test_duplicated_forward_matches_vtm(family, mode, monkeypatch):
    """One block run at several steps, shared weights, with source
    tracking: each step merges with its own r, as vtm does."""
    models, video, kw, tol = DUPLICATED[family]()
    got, tstate, want, jstate, matchings = run_variant(monkeypatch, mode, models, video, dict(kw, prop_attn=True))
    assert len(matchings["torch"]) == sum(r > 0 for r in kw["rs"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    assert_states_equal(tstate, jstate)
