"""The port's multi-view evaluation path against the JAX package's on the
CPU: ``test_net.test`` (TestMeter, EPICTestMeter, the result pickles),
``run_net``, the test-checkpoint fallback, ``ModelBundle.r`` and
``vtm_torch.patch``, at tiny sizes on the synthetic dataset."""

import glob
import json
import os
import pathlib
import pickle
import subprocess
import sys

import jax  # noqa: F401  (keeps the JAX package's CPU setup first, as the other parity tests do)
import numpy as np
import pytest
import torch

import tools.test_net as jax_test_net
import vtm.patch as jax_patch
from vtm.config import get_cfg as jax_get_cfg
from vtm.models import build_model as jax_build_model
from vtm_torch import patch
from vtm_torch.checkpoints import checkpoint as cu
from vtm_torch.config import get_cfg
from vtm_torch.eval import meters
from vtm_torch.models import build_model
from vtm_torch.tools import run_net as rn
from vtm_torch.tools import test_net as tn

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]

# every video's clips in a video's prediction: the port's sum of fp32 logits
# against the JAX package's, over at most 6 clips of |logit| < 10
PREDS_ATOL = 1e-4


def _videomae_opts(*opts):
    """A tiny VideoMAE: ViT-S widths, 4 frames at a 32-pixel crop (8 tokens),
    merged with r = 2; 4 synthetic videos of 2 views x 3 crops, batches of 4."""
    return [
        "MODEL.MODEL_NAME", "VideoMAE", "VIDEOMAE.MODEL", "vit_small_patch16_224",
        "DATA.TEST_CROP_SIZE", "32", "DATA.TRAIN_CROP_SIZE", "32", "DATA.NUM_FRAMES", "4",
        "MODEL.NUM_CLASSES", "7", "TEST.DATASET", "synthetic", "TEST.BATCH_SIZE", "4",
        "TEST.NUM_ENSEMBLE_VIEWS", "2", "TEST.NUM_SPATIAL_CROPS", "3",
        "TOME.ENABLE", "True", "TOME.R_VALUE", "2", "TOME.PROP_ATTN", "False",
        "TPU.COMPUTE_DTYPE", "float32", "DATA_LOADER.NUM_WORKERS", "2", *opts,
    ]


def _motionformer_opts(*opts):
    """A tiny Motionformer with the EPIC-KITCHENS verb/noun heads: 2 frames of
    4 tokens, 2 layers, merged with r = 1 a frame and proportional
    attention; 4 synthetic videos of 1 view x 3 crops."""
    return [
        "MODEL.MODEL_NAME", "Motionformer",
        "MOTIONFORMER.EMBED_DIM", "32", "MOTIONFORMER.DEPTH", "2", "MOTIONFORMER.NUM_HEADS", "2",
        "MOTIONFORMER.MLP_RATIO", "2", "MOTIONFORMER.TEMPORAL_RESOLUTION", "2", "MOTIONFORMER.USE_MLP", "True",
        "DATA.TEST_CROP_SIZE", "32", "DATA.TRAIN_CROP_SIZE", "32", "DATA.NUM_FRAMES", "4",
        "EPICKITCHENS.NUM_CLASSES", "[5, 7]", "TEST.DATASET", "synthetic", "TEST.BATCH_SIZE", "4",
        "TEST.NUM_ENSEMBLE_VIEWS", "1", "TEST.NUM_SPATIAL_CROPS", "3",
        "TOME.ENABLE", "True", "TOME.R_VALUE", "1", "TOME.PROP_ATTN", "True",
        "TPU.COMPUTE_DTYPE", "float32", "DATA_LOADER.NUM_WORKERS", "2", *opts,
    ]


def _cfgs(opts):
    cfg, jcfg = get_cfg(), jax_get_cfg()
    cfg.merge_from_list(list(opts))
    jcfg.merge_from_list(list(opts))
    return cfg, jcfg


def _write_checkpoint(path, opts, seed=7):
    """One torch file in the reference's ``model_state`` container: every
    tensor of the model's state dict drawn anew from numpy (layer-norm
    scales about 1), so that it equals neither package's init."""
    cfg = get_cfg()
    cfg.merge_from_list(list(opts))
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in build_model(cfg, "cpu").module.state_dict().items():
        x = rng.standard_normal(tuple(v.shape)) * 0.05
        if "norm" in k and k.endswith("weight"):
            x += 1.0
        sd[k] = torch.from_numpy(x.astype(np.float32))
    torch.save({"model_state": sd}, path)


def _recording(monkeypatch, module, names=("TestMeter", "EPICTestMeter")):
    """Swap the module's meter classes for subclasses that keep every
    meter made; returns that list."""
    made = []
    for name in names:
        base = getattr(module, name)

        class Recording(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        monkeypatch.setattr(module, name, Recording)
    return made


def _preds(meter):
    if hasattr(meter, "video_preds"):
        return [meter.video_preds], [meter.video_labels]
    return [meter.verb_preds, meter.noun_preds], [meter.verb_labels, meter.noun_labels]


CASES = {
    "VideoMAE-sum": _videomae_opts(),
    "VideoMAE-max": _videomae_opts("DATA.ENSEMBLE_METHOD", "max"),
    "Motionformer-EPIC": _motionformer_opts(),
}


@pytest.mark.parametrize("case", list(CASES))
def test_test_matches_vtm(case, tmp_path, monkeypatch):
    """One checkpoint file into both packages through
    TEST.CHECKPOINT_FILE_PATH, then each package's ``test``: the same stats
    strings, clip counts and labels, per-video predictions within
    PREDS_ATOL, and the same result pickles."""
    opts = CASES[case]
    ckpt = tmp_path / "model.pyth"
    _write_checkpoint(ckpt, opts)
    results = {}
    for pkg, module in (("torch", tn), ("jax", jax_test_net)):
        out = tmp_path / pkg
        out.mkdir()
        run_opts = [*opts, "TEST.CHECKPOINT_FILE_PATH", str(ckpt), "OUTPUT_DIR", str(out),
                    "TEST.SAVE_RESULTS_PATH", str(out / "results.pkl")]
        cfg, jcfg = _cfgs(run_opts)
        made = _recording(monkeypatch, module)
        stats = tn.test(cfg, device="cpu") if pkg == "torch" else jax_test_net.test(jcfg)
        assert len(made) == 1
        with open(out / "results.pkl", "rb") as f:
            results[pkg] = (stats, made[0], pickle.load(f))
    (stats, meter, saved), (jstats, jmeter, jsaved) = results["torch"], results["jax"]
    assert stats == jstats
    assert type(meter).__mro__[1].__name__ == type(jmeter).__mro__[1].__name__
    num_clips = 6 if case.startswith("VideoMAE") else 3
    assert meter.num_clips == num_clips
    np.testing.assert_array_equal(meter.clip_count, jmeter.clip_count)
    assert (meter.clip_count == num_clips).all() and meter.clip_count.shape == (4,)
    (preds, labels), (jpreds, jlabels) = _preds(meter), _preds(jmeter)
    for p, jp in zip(preds, jpreds):
        assert p.dtype == np.float64
        np.testing.assert_allclose(p, jp, rtol=0, atol=PREDS_ATOL)
    for lab, jlab in zip(labels, jlabels):
        np.testing.assert_array_equal(lab, jlab)
    assert sorted(saved) == sorted(jsaved)
    for key in saved:
        if "label" in key:
            np.testing.assert_array_equal(saved[key], jsaved[key])
        else:
            np.testing.assert_allclose(saved[key], jsaved[key], rtol=0, atol=PREDS_ATOL)


def _direct_forward(cfg, videos):
    """Each clip of the synthetic test set through the module directly."""
    from vtm_torch.data import construct_loader

    bundle = cu.load_test_checkpoint(cfg, build_model(cfg, "cpu"))
    loader = construct_loader(cfg, "test")
    out = {}
    with torch.inference_mode():
        for batch in loader:
            logits, _ = bundle.module(torch.as_tensor(batch["frames"]))
            for i, idx in enumerate(batch["index"]):
                out.setdefault(int(idx) // loader.dataset._num_clips, []).append(logits[i].double().numpy())
    assert sorted(out) == list(range(videos))
    return out


@pytest.mark.parametrize("method", ["sum", "max"])
def test_ensemble_is_the_sum_or_max_of_each_videos_clips(method, tmp_path, monkeypatch):
    opts = _videomae_opts("DATA.ENSEMBLE_METHOD", method, "OUTPUT_DIR", str(tmp_path))
    cfg, _ = _cfgs(opts)
    made = _recording(monkeypatch, tn)
    tn.test(cfg, device="cpu")
    clips = _direct_forward(_cfgs(opts)[0], 4)
    for vid, rows in clips.items():
        assert len(rows) == 6
        if method == "sum":
            want = np.sum(rows, axis=0)
        else:  # from the zeros the single-label ensemble starts at, as in vtm and the reference
            want = np.maximum(0.0, np.max(rows, axis=0))
        np.testing.assert_allclose(made[0].video_preds[vid], want, rtol=0, atol=1e-5)


def test_views_sweep_and_suffixed_pickles(tmp_path):
    """TEST.NUM_TEMPORAL_CLIPS [1, 2] runs two passes and writes one pickle
    each, suffixed _views{n}; [-1] sweeps 1, 3, 5, 7 and 10 views."""
    opts = _motionformer_opts("TEST.NUM_SPATIAL_CROPS", "1", "OUTPUT_DIR", str(tmp_path),
                              "TEST.SAVE_RESULTS_PATH", str(tmp_path / "r.pkl"))
    cfg, _ = _cfgs(opts)
    cfg.TEST.NUM_TEMPORAL_CLIPS = [1, 2]
    results = tn.test(cfg, device="cpu")
    assert [v for v, _ in results] == [1, 2]
    for views in (1, 2):
        with open(tmp_path / f"r_views{views}.pkl", "rb") as f:
            saved = pickle.load(f)
        assert sorted(saved) == ["noun", "noun_labels", "verb", "verb_labels"]
        assert saved["verb"].shape == (4, 5) and saved["noun"].shape == (4, 7)
    assert not (tmp_path / "r.pkl").exists()

    cfg, _ = _cfgs(opts)
    cfg.TEST.NUM_TEMPORAL_CLIPS = [-1]
    results = tn.test(cfg, device="cpu")
    assert [v for v, _ in results] == [1, 3, 5, 7, 10]
    assert all("action_top1_acc" in s for _, s in results)


def test_run_net_trains_then_tests_the_trained_weights(tmp_path, monkeypatch):
    """TRAIN.ENABLE then TEST.ENABLE with no test checkpoint: the test
    takes the last checkpoint the training wrote, as the JAX package's own
    train-then-test test checks for its run_net."""
    opts = _videomae_opts(
        "TRAIN.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "8", "SOLVER.MAX_EPOCH", "1",
        "SOLVER.OPTIMIZING_METHOD", "sgd", "TRAIN.CHECKPOINT_PERIOD", "1", "TRAIN.EVAL_PERIOD", "10",
        "TEST.NUM_ENSEMBLE_VIEWS", "1", "TEST.NUM_SPATIAL_CROPS", "1", "OUTPUT_DIR", str(tmp_path),
    )
    cfg, _ = _cfgs(opts)
    tested = []

    def recording_load(cfg, bundle):
        bundle = cu.load_test_checkpoint(cfg, bundle)
        tested.append({k: v.clone() for k, v in bundle.module.state_dict().items()})
        return bundle

    monkeypatch.setattr(tn, "load_test_checkpoint", recording_load)
    results = rn.run_net(cfg, device="cpu")
    assert results and "top1_acc" in results[0][1]
    last = cu.get_last_checkpoint(str(tmp_path))
    assert last and last.endswith("epoch_00000.pyth")
    trained = torch.load(last, map_location="cpu", weights_only=True)["model_state"]
    init = build_model(_cfgs(opts)[0], "cpu").module.state_dict()
    assert len(tested) == 1 and sorted(tested[0]) == sorted(trained)
    for k, v in trained.items():
        assert torch.equal(tested[0][k], v), k
    assert not torch.equal(trained["blocks.0.attn.qkv.weight"], init["blocks.0.attn.qkv.weight"])


@pytest.mark.parametrize("present", ["output_dir", "train_file", "neither"])
def test_fallback_order_of_an_empty_test_checkpoint(present, tmp_path, caplog):
    """TEST.CHECKPOINT_FILE_PATH empty: the last checkpoint of OUTPUT_DIR
    (over a TRAIN.CHECKPOINT_FILE_PATH that is also set), then the train
    checkpoint, else the seeded init, logged."""
    out = tmp_path / "out"
    base = _videomae_opts("OUTPUT_DIR", str(out))
    init = build_model(_cfgs(base)[0], "cpu").module.state_dict()
    saved = build_model(_cfgs([*base, "RNG_SEED", "5"])[0], "cpu").module
    train_file = tmp_path / "train.pyth"
    _write_checkpoint(train_file, base, seed=11)
    opts = list(base)
    if present == "output_dir":
        cu.save_checkpoint(str(out), saved, None, 3)
        cu.save_checkpoint(str(out), build_model(_cfgs(base)[0], "cpu").module, None, 1)
    if present != "neither":
        opts += ["TRAIN.CHECKPOINT_FILE_PATH", str(train_file)]
    cfg, _ = _cfgs(opts)
    with caplog.at_level("INFO"):
        got = cu.load_test_checkpoint(cfg, build_model(cfg, "cpu")).module.state_dict()
    want = {
        "output_dir": saved.state_dict(),
        "train_file": torch.load(train_file, weights_only=True)["model_state"],
        "neither": init,
    }[present]
    for k in got:
        assert torch.equal(got[k], want[k]), k
    if present == "neither":
        assert "random init" in caplog.text
    else:
        assert not torch.equal(got["blocks.0.attn.qkv.weight"], init["blocks.0.attn.qkv.weight"])


def _vivit_json(tmp_path):
    d = {"video_size": [4, 32, 32], "tubelet_size": [2, 16, 16], "num_channels": 3, "hidden_size": 32,
         "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 64, "hidden_act": "gelu_fast",
         "layer_norm_eps": 1e-6, "qkv_bias": True}
    path = tmp_path / "vivit.json"
    path.write_text(json.dumps(d))
    return str(path)


# family -> (opts without merging, tokens of one clip as the policy counts
# them: per frame for the per-frame merges, the class token included for
# ViViT; what a block's input length becomes in that count)
FAMILIES = {
    "videomae": (lambda p: _videomae_opts("TOME.ENABLE", "False"), 8, lambda n: n),
    "motionformer": (lambda p: _motionformer_opts("TOME.ENABLE", "False", "EPICKITCHENS.NUM_CLASSES", "None"),
                     4, lambda n: (n - 1) // 2),
    "timesformer": (lambda p: ["MODEL.MODEL_NAME", "TimeSformer", "DATA.TRAIN_CROP_SIZE", "32",
                               "DATA.TEST_CROP_SIZE", "32", "DATA.NUM_FRAMES", "2", "MODEL.NUM_CLASSES", "7",
                               "TPU.COMPUTE_DTYPE", "float32", "TOME.ENABLE", "False"], 4, None),
    "vivit": (lambda p: ["MODEL.MODEL_NAME", "ViViT", "VIVIT.CONFIG_PATH", _vivit_json(p), "DATA.NUM_FRAMES", "4",
                         "DATA.TEST_CROP_SIZE", "32", "DATA.TRAIN_CROP_SIZE", "32", "MODEL.NUM_CLASSES", "5",
                         "TPU.COMPUTE_DTYPE", "float32", "TOME.ENABLE", "False"], 9, lambda n: n),
}


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("r", [1, (2, 1.0), [3, 1]], ids=["int", "inflect", "list"])
def test_patch_and_r_set_every_blocks_policy_as_vtm_does(family, r, tmp_path):
    """``patch.<family>(bundle)`` then ``bundle.r = r`` in both packages:
    the same per-layer schedule and policy fields, the module and every
    block holding the new policy, and the tokens entering each block of a
    forward equal to the JAX package's ``token_counts``."""
    opts_fn, n0, tokens_of = FAMILIES[family]
    cfg, jcfg = _cfgs(opts_fn(tmp_path))
    bundle = build_model(cfg, "cpu")
    jbundle = jax_build_model(jcfg, init=False)
    assert bundle.policy.mode == "none"
    getattr(patch, family)(bundle)
    getattr(jax_patch, family)(jbundle)
    bundle.r = r
    jbundle.r = r
    assert bundle.r == jbundle.r and bundle.policy.mode == jbundle.policy.mode == "merge"
    for field in ("prop_attn", "head_aggregation", "class_token"):
        assert getattr(bundle.policy, field) == getattr(jbundle.policy, field), field
    holders = [m for m in bundle.module.modules() if hasattr(m, "policy")]
    assert len(holders) == bundle.module.config.depth + 1
    assert all(m.policy is bundle.policy for m in holders)
    want = jbundle.policy.token_counts(n0)
    assert tuple(bundle.policy.token_counts(n0)) == tuple(want)
    assert want[-1] < n0
    if tokens_of is None:  # TimeSformer's blocks see [B, 1 + T*s, D]; it merges per frame
        frames = cfg.DATA.NUM_FRAMES
        tokens_of = lambda n: (n - 1) // frames  # noqa: E731
    seen = []
    blocks = list(bundle.module.layer if family == "vivit" else bundle.module.blocks)
    hooks = [b.register_forward_pre_hook(lambda m, a: seen.append(tokens_of(a[0].shape[1]))) for b in blocks]
    hooks.append(blocks[-1].register_forward_hook(lambda m, a, o: seen.append(tokens_of(o[0].shape[1]))))
    video = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, cfg.DATA.NUM_FRAMES, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        bundle.module(video)
    for h in hooks:
        h.remove()
    assert tuple(seen) == tuple(want)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("options", [dict(trace_source=True), dict(mode="hybrid", threshold=0.5),
                                     dict(mode="drop", trace_source=True)], ids=["trace_source", "hybrid", "drop"])
def test_patch_options_set_the_policy_as_vtm_does(family, options, tmp_path):
    """``patch.<family>(bundle, trace_source=, mode=, threshold=)`` then
    ``bundle.r = 1``: the policy's fields equal vtm's, and a forward
    through ``bundle.apply`` carries the source when it is traced, one
    row per token left, the identity's columns."""
    opts_fn, n0, tokens_of = FAMILIES[family]
    cfg, jcfg = _cfgs(opts_fn(tmp_path))
    bundle, jbundle = build_model(cfg, "cpu"), jax_build_model(jcfg, init=False)
    getattr(patch, family)(bundle, **options)
    getattr(jax_patch, family)(jbundle, **options)
    bundle.r = 1
    jbundle.r = 1
    for field in ("mode", "threshold", "trace_source", "prop_attn", "class_token", "rs"):
        assert getattr(bundle.policy, field) == getattr(jbundle.policy, field), field
    video = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, cfg.DATA.NUM_FRAMES, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        _, state = bundle.apply(video)
    left = bundle.policy.token_counts(n0)[-1]
    if options.get("trace_source"):
        assert state.source.shape[1:] == (left, n0)
        assert set(np.unique(state.source.numpy())) <= {0.0, 1.0}
    else:
        assert state.source is None


def test_apply_traces_the_source_for_one_call(tmp_path):
    """``bundle.apply(x, trace_source=True)`` tracks the source for that
    call only, as vtm's ``ModelBundle.apply`` does; each column sums to 1
    and each row to the token's size."""
    cfg, _ = _cfgs(_videomae_opts("OUTPUT_DIR", str(tmp_path)))
    bundle = build_model(cfg, "cpu")
    video = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 4, 32, 32, 3)).astype(np.float32))
    policy = bundle.policy
    with torch.inference_mode():
        _, plain = bundle.apply(video)
        _, traced = bundle.apply(video, trace_source=True)
    assert plain.source is None and bundle.policy is policy and not policy.trace_source
    assert all(m.policy is policy for m in bundle.module.modules() if hasattr(m, "policy"))
    assert tuple(traced.source.shape) == (2, policy.token_counts(8)[-1], 8)
    np.testing.assert_array_equal(traced.source.sum(dim=1).numpy(), 1.0)
    np.testing.assert_array_equal(traced.source.sum(dim=2, keepdim=True).numpy(), traced.size.numpy())


@pytest.mark.parametrize("opts, item", [
    (("TPU.MODEL_PARALLEL", "2", "MODEL.MODEL_NAME", "Motionformer"), "item 15"),
    (("LOG_MODEL_INFO", "True"), "item 4"),
], ids=lambda x: x[0] if isinstance(x, tuple) else x)
def test_unported_options_raise_by_name(opts, item, tmp_path):
    cfg, _ = _cfgs(_videomae_opts("OUTPUT_DIR", str(tmp_path), *opts))
    with pytest.raises(NotImplementedError, match=item):
        tn.test(cfg, device="cpu")


@pytest.mark.parametrize("opts", [
    ("TENSORBOARD.ENABLE", "True", "TENSORBOARD.CONFUSION_MATRIX.ENABLE", "True"),
    ("WANDB.ENABLE", "True"),
], ids=lambda x: x[0])
def test_tensorboard_and_wandb_run(opts, tmp_path, monkeypatch):
    """TENSORBOARD.ENABLE and WANDB.ENABLE (once refused) run as in vtm:
    each sweep entry's stats logged to wandb with its views (here a stand-in
    package records them), and its confusion matrix written to the event
    file; the stats are those of a run without them."""
    import sys
    import types

    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    logged = []
    fake = types.SimpleNamespace(init=lambda **kw: None, log=logged.append, finish=lambda: None)
    monkeypatch.setitem(sys.modules, "wandb", fake)
    base = _videomae_opts("TEST.NUM_TEMPORAL_CLIPS", "[1, 2]")
    plain, _ = _cfgs([*base, "OUTPUT_DIR", str(tmp_path / "plain")])
    cfg, _ = _cfgs([*base, "OUTPUT_DIR", str(tmp_path / "logged"), *opts])
    results = tn.test(cfg, device="cpu")
    assert results == tn.test(plain, device="cpu")
    if opts[0] == "WANDB.ENABLE":
        assert logged == [{"num_views": v, **stats} for v, stats in results]
        return
    assert not logged
    events = glob.glob(str(tmp_path / "logged" / "runs-synthetic" / "events.*"))
    images = EventAccumulator(events[0], size_guidance={"images": 0}).Reload().Images("Confusion Matrix")
    assert len(events) == 1 and len(images) == 2


def test_detection_needs_a_family_with_the_roi_head(tmp_path):
    """``DETECTION.ENABLE`` is ported (tests/test_torch_ava_detection.py); on
    VideoMAE, which has no detection head, ``test`` raises TypeError, as
    ``vtm``'s build fails initialising it with boxes."""
    cfg, _ = _cfgs(_videomae_opts("OUTPUT_DIR", str(tmp_path), "DETECTION.ENABLE", "True"))
    with pytest.raises(TypeError, match="no detection head"):
        tn.test(cfg, device="cpu")


def test_no_cuda_raises_instead_of_running_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, _ = _cfgs(_videomae_opts())
    with pytest.raises(RuntimeError, match="CUDA device"):
        tn.test(cfg)
    with pytest.raises(RuntimeError, match="CUDA device"):
        rn.run_net(cfg)


def test_indivisible_test_set_raises(tmp_path, monkeypatch):
    from vtm_torch.data import synthetic

    monkeypatch.setattr(synthetic.Synthetic, "__len__", lambda self: 7)
    cfg, _ = _cfgs(_videomae_opts("OUTPUT_DIR", str(tmp_path)))
    with pytest.raises(ValueError, match="not divisible"):
        tn.test(cfg, device="cpu")


def test_meters_match_vtm_on_random_streams():
    """TestMeter (sum, max, multi-label) and EPICTestMeter fed the same
    shuffled clip stream in both packages: equal fp64 ensembles, clip
    counts and stats strings; EpochTimer keeps its durations."""
    from vtm.eval import meters as jm

    rng = np.random.default_rng(3)
    videos, clips, classes = 5, 4, 6
    order = rng.permutation(videos * clips)
    logits = rng.standard_normal((videos * clips, classes))
    labels = np.repeat(rng.integers(0, classes, videos), clips)
    multi = np.repeat((rng.random((videos, classes)) < 0.4).astype(np.float64), clips, axis=0)
    for kw, lab in (({}, labels), ({"multi_view_ensemble_method": "max"}, labels), ({"multi_label": True}, multi)):
        pair = [meters.TestMeter(videos, clips, classes, 3, **kw), jm.TestMeter(videos, clips, classes, 3, **kw)]
        for m in pair:
            for chunk in np.array_split(order, 3):
                m.update_stats(logits[chunk], lab[chunk], chunk)
        np.testing.assert_array_equal(pair[0].video_preds, pair[1].video_preds)
        np.testing.assert_array_equal(pair[0].clip_count, pair[1].clip_count)
        assert pair[0].finalize_metrics() == pair[1].finalize_metrics()
    noun = rng.standard_normal((videos * clips, 3))
    nlab = np.repeat(rng.integers(0, 3, videos), clips)
    pair = [meters.EPICTestMeter(videos, clips, (classes, 3), 3), jm.EPICTestMeter(videos, clips, (classes, 3), 3)]
    for m in pair:
        for chunk in np.array_split(order, 3):
            m.update_stats((logits[chunk], noun[chunk]), (labels[chunk], nlab[chunk]), None, chunk)
    np.testing.assert_array_equal(pair[0].verb_preds, pair[1].verb_preds)
    np.testing.assert_array_equal(pair[0].noun_preds, pair[1].noun_preds)
    assert pair[0].finalize_metrics() == pair[1].finalize_metrics()
    with pytest.raises(NotImplementedError):
        meters.TestMeter(1, 1, 2, 1, "mean").update_stats(np.zeros((1, 2)), np.zeros(1), np.zeros(1))
    timer = meters.EpochTimer()
    for _ in range(2):
        timer.epoch_tic()
        timer.epoch_toc()
    assert len(timer.epoch_durations) == 2 and timer.avg_epoch_time() >= 0 and timer.last_epoch_time() >= 0


_NO_CV2_NO_PIL = """
import sys
sys.modules["cv2"] = None
sys.modules["PIL"] = None
import torch
torch.set_num_threads(2)
import vtm_torch
from vtm_torch.config import get_cfg
from vtm_torch.tools.test_net import test
cfg = get_cfg()
cfg.merge_from_list({opts!r})
results = test(cfg, device="cpu")
assert results[0][0] == 2 and "top1_acc" in results[0][1], results
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "vtm", "cv2", "PIL") and sys.modules[m] is not None)
assert not bad, bad
print("ok")
"""


def test_synthetic_test_runs_without_cv2_or_pil(tmp_path):
    """``import vtm_torch`` and the synthetic test need neither cv2 nor PIL
    (nor jax or vtm): both blocked in sys.modules of a fresh process."""
    code = _NO_CV2_NO_PIL.format(opts=_videomae_opts("OUTPUT_DIR", str(tmp_path)))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


class _BatchKey:
    """In place of a batch's torch.Generator: what vtm's test loop keys
    that batch's forward with, fold_in(key(RNG_SEED), batch index)."""

    def __init__(self, seed, cur_iter):
        self.key = jax.random.fold_in(jax.random.key(seed), cur_iter)


@pytest.mark.parametrize("mode", ["random_drop", "random_merge"])
def test_random_modes_repeat_and_match_vtm_given_its_draws(mode, tmp_path, monkeypatch):
    """``TOME.MODE`` random: two runs of the port give the same ensembles,
    another RNG_SEED others; with JAX's draws put in (each batch keyed as
    vtm keys it, each layer's draw split as MergeState.next_rng splits), the
    same stats and ensembles as vtm's ``test`` within PREDS_ATOL."""
    opts = _videomae_opts("TOME.MODE", mode)
    ckpt = tmp_path / "model.pyth"
    _write_checkpoint(ckpt, opts)
    opts = [*opts, "TEST.CHECKPOINT_FILE_PATH", str(ckpt), "OUTPUT_DIR", str(tmp_path)]

    def run(*more):
        made = _recording(monkeypatch, tn)
        stats = tn.test(_cfgs([*opts, *more])[0], device="cpu")
        return stats, made[-1].video_preds.copy()

    (_, first), (_, again), (_, other) = run(), run(), run("RNG_SEED", "5")
    np.testing.assert_array_equal(first, again)
    assert not np.array_equal(first, other)

    from torch_variants import put_in_jax_draws

    monkeypatch.setattr(tn, "_step_generator", lambda device, seed, cur_iter: _BatchKey(seed, cur_iter))
    put_in_jax_draws(monkeypatch, lambda batch: batch.key)
    stats, preds = run()
    jmade = _recording(monkeypatch, jax_test_net)
    jstats = jax_test_net.test(_cfgs(opts)[1])
    assert stats == jstats
    np.testing.assert_allclose(preds, jmade[0].video_preds, rtol=0, atol=PREDS_ATOL)
    assert not np.array_equal(preds, first)


def test_clip_length_histogram_csv_as_vtm_writes_it(tmp_path, monkeypatch):
    """``TEST.CLIP_LENGTH_HISTOGRAM``: each package's ``test`` writes the
    per-video (length, outcome) csv from the cached lengths, the same file."""
    lengths = tmp_path / "annotations"
    lengths.mkdir()
    (lengths / "epickitchens_lengths.csv").write_text(
        "video,length\n" + "".join(f"P01_{i:02d},{1.5 * i + 0.25}\n" for i in range(5)))
    opts = _videomae_opts("TEST.CLIP_LENGTH_HISTOGRAM", "True", "EPICKITCHENS.ANNOTATIONS_DIR", str(lengths),
                          "TOME.R_VALUE", "1")
    ckpt = tmp_path / "model.pyth"
    _write_checkpoint(ckpt, opts)
    written = {}
    for pkg in ("torch", "jax"):
        data = tmp_path / f"data_{pkg}"
        data.mkdir()
        cfg, jcfg = _cfgs([*opts, "TEST.CHECKPOINT_FILE_PATH", str(ckpt), "OUTPUT_DIR", str(tmp_path / pkg),
                           "DATA.PATH_TO_DATA_DIR", str(data)])
        tn.test(cfg, device="cpu") if pkg == "torch" else jax_test_net.test(jcfg)
        written[pkg] = (data / "model_r_1.csv").read_text()
    assert written["torch"] == written["jax"]
    rows = written["torch"].splitlines()
    assert rows[0] == "video,length,outcome" and len(rows) == 1 + 4
