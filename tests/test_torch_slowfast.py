"""The port's conv families (``vtm_torch/models/slowfast.py``,
``convnet.py``) against ``vtm``'s on the CPU in fp32: SlowFast, ResNet
(C2D, I3D, Slow) and X3D from the same weights, outputs in eval and
training mode and the running statistics after a train-mode forward; the
``.pyth`` round trip through ``vtm``'s converter; ``test_net.test`` and
``model_benchmark`` from one checkpoint file against ``vtm``'s, with the
fully convolutional head at a test crop larger than the train crop; and the
shipped SlowFast configs at full width."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.test_net as jax_test_net
from vtm.checkpoints.convert import convert_pyslowfast, load_torch_state_dict as jax_load_torch_state_dict
from vtm.models.build import build_model as jax_build_model

from vtm_torch.checkpoints.checkpoint import load_test_checkpoint
from vtm_torch.checkpoints.convert import pyslowfast_state_dict_from_vtm
from vtm_torch.models import build_model
from vtm_torch.models.slowfast import SlowFastModel
from vtm_torch.ops import flash_attention
from vtm_torch.tools import model_benchmark as mb
from vtm_torch.tools import test_net as tn

from torch_conv_cases import OUT_TOL, Case, assert_close_to_largest, assert_stats_match, cfgs, np_tree

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
SLOWFAST_YAMLS = sorted((REPO / "configs" / "slowfast").glob("*/*.yaml"))


@pytest.fixture(scope="module")
def cases():
    return {}


def _case(cases, name):
    if name not in cases:
        cases[name] = Case(name)
    return cases[name]


@pytest.mark.parametrize("name", ["slowfast", "c2d", "i3d", "slow", "x3d"])
def test_eval_forward_matches_vtm(name, cases):
    """Eval mode on the running statistics: the head's softmax averaged
    over what is left of T, H, W, within OUT_TOL of the largest entry."""
    case = _case(cases, name)
    x = case.video(2, seed=1)
    with torch.no_grad():
        got, state = case.bundle.module(torch.from_numpy(x))
    assert state is None and got.shape == (2, 7)
    assert_close_to_largest(got.numpy(), case.jax_eval(x), OUT_TOL, name)
    np.testing.assert_allclose(got.sum(dim=1).numpy(), 1.0, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["slowfast", "c2d", "i3d", "slow", "x3d"])
def test_train_forward_and_statistics_match_vtm(name, cases):
    """Training mode: the logits within OUT_TOL, every running statistic
    after the forward within ``stats_tol`` of its tensor's largest entry (the
    biased variance, as ``vtm`` stores it); under FROZEN_BN (``slow``) the
    statistics do not move."""
    case = _case(cases, name)
    module = case.bundle.module
    module.load_state_dict({k: torch.from_numpy(v) for k, v in case.state.items()})
    x = case.video(4, seed=2)
    want, stats = case.jax_train(x)
    module.train()
    try:
        with torch.no_grad():
            got, _ = module(torch.from_numpy(x))
    finally:
        module.eval()
    assert_close_to_largest(got.numpy(), want, OUT_TOL, name)
    want_sd = pyslowfast_state_dict_from_vtm(case.params, stats)
    assert_stats_match(module, {k: v.numpy() for k, v in want_sd.items()})
    moved = [k for k, v in module.state_dict().items() if "running" in k and not np.array_equal(v.numpy(), case.state[k])]
    assert (moved == []) == case.cfg.MODEL.FROZEN_BN
    module.load_state_dict({k: torch.from_numpy(v) for k, v in case.state.items()})


@pytest.mark.parametrize("name", ["slowfast", "x3d"])
def test_pyth_round_trip_through_vtms_converter(name, cases, tmp_path):
    """``vtm``'s params and statistics -> ``pyslowfast_state_dict_from_vtm``
    -> a ``.pyth`` file in the upstream container -> each package's loader:
    the port's module takes every tensor, and ``vtm``'s
    ``convert_pyslowfast`` gives back the same arrays."""
    case = _case(cases, name)
    sd = pyslowfast_state_dict_from_vtm(case.params, case.stats)
    assert set(sd) == set(case.bundle.module.state_dict())
    path = tmp_path / "model.pyth"
    torch.save({"model_state": {f"module.{k}": v for k, v in sd.items()}}, path)
    cfg, _ = cfgs(case.opts + ["TEST.CHECKPOINT_FILE_PATH", str(path)])
    bundle = load_test_checkpoint(cfg, build_model(cfg, "cpu"))
    for k, v in bundle.module.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), case.state[k], err_msg=k)
    params, stats = convert_pyslowfast(jax_load_torch_state_dict(str(path)))
    for got, want in ((params, case.params), (stats, case.stats)):
        flat_g = dict(jax.tree_util.tree_flatten_with_path(np_tree(got))[0])
        flat_w = dict(jax.tree_util.tree_flatten_with_path(np_tree(want))[0])
        assert flat_g.keys() == flat_w.keys()
        for k in flat_w:
            np.testing.assert_array_equal(flat_g[k], flat_w[k])


def test_upstream_names_and_counts_are_dropped(cases):
    """An upstream file's ``num_batches_tracked`` and ``module.`` prefix do
    not reach the module; a SubBatchNorm's ``X.bn`` / ``X.split_bn``
    statistics in a file load into the port's plain BatchNorms as ``vtm``'s
    converter takes them (the eval statistics, the ``X.bn`` ones)."""
    from vtm_torch.checkpoints.checkpoint import merge_bn_stats, merge_into_template
    from vtm_torch.checkpoints.convert import load_pyslowfast_state_dict

    case = _case(cases, "c2d")
    sd = {f"module.{k}": torch.from_numpy(v) for k, v in case.state.items()}
    sd["module.s1.pathway0_stem.bn.num_batches_tracked"] = torch.tensor(3)
    got = load_pyslowfast_state_dict(sd)
    assert set(got) == set(case.state)
    name = "s2.pathway0_res0.branch2.a_bn"
    sub = dict(got)
    for leaf in ("running_mean", "running_var"):
        plain = sub.pop(f"{name}.{leaf}")
        sub[f"{name}.bn.{leaf}"] = plain + 1.0
        sub[f"{name}.split_bn.{leaf}"] = torch.cat([plain, plain])
    template = case.bundle.module.state_dict()
    merged, loaded, kept = merge_into_template(template, merge_bn_stats(template, sub))
    assert kept == 0 and loaded == len(template)
    np.testing.assert_array_equal(merged[f"{name}.running_mean"].numpy(), case.state[f"{name}.running_mean"] + 1.0)


def _test_opts(name, *opts):
    return [
        "TEST.DATASET", "synthetic", "TEST.BATCH_SIZE", "4", "TEST.NUM_ENSEMBLE_VIEWS", "2",
        "TEST.NUM_SPATIAL_CROPS", "3", "DATA_LOADER.NUM_WORKERS", "0", *opts,
    ]


def _fast_jax_build(cfg, rng=None, init=True):
    """``vtm``'s ``build_model`` with the init jitted (the checkpoint
    replaces its values; the eager init takes half a minute on the CPU)."""
    bundle = jax_build_model(cfg, init=False)
    if init:
        t, s = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
        variables = jax.jit(bundle.module.init)(jax.random.key(cfg.RNG_SEED), jnp.zeros((1, t, s, s, 3)))
        bundle.params, bundle.batch_stats = variables["params"], variables["batch_stats"]
    return bundle


@pytest.mark.parametrize("crop", [32, 64])
def test_test_net_and_model_benchmark_match_vtm(crop, cases, tmp_path, monkeypatch):
    """One checkpoint file into both packages' ``test`` (2 views x 3 crops,
    4 synthetic videos): the same stats strings, clip counts and labels,
    per-video probability sums within OUT_TOL of the largest. At crop 64
    the head's pool, sized for the train crop of 32, leaves 2 x 2
    positions: the softmax is taken at each and averaged. Then
    ``model_benchmark`` on the same file: its statistics' keys and no
    attention kernel launched."""
    case = _case(cases, "slowfast")
    path = tmp_path / "model.pyth"
    torch.save({"model_state": {k: torch.from_numpy(v) for k, v in case.state.items()}}, path)
    monkeypatch.setattr(jax_test_net, "build_model", _fast_jax_build)
    results = {}
    for pkg in ("torch", "jax"):
        out = tmp_path / pkg
        out.mkdir()
        opts = case.opts + _test_opts("slowfast", "DATA.TEST_CROP_SIZE", str(crop), "OUTPUT_DIR", str(out),
                                      "TEST.CHECKPOINT_FILE_PATH", str(path))
        cfg, jcfg = cfgs(opts)
        made = []
        module = tn if pkg == "torch" else jax_test_net

        class Recording(module.TestMeter):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        monkeypatch.setattr(module, "TestMeter", Recording)
        stats = tn.test(cfg, device="cpu") if pkg == "torch" else jax_test_net.test(jcfg)
        results[pkg] = (stats, made[0])
    (stats, meter), (jstats, jmeter) = results["torch"], results["jax"]
    assert stats == jstats
    np.testing.assert_array_equal(meter.clip_count, jmeter.clip_count)
    assert (meter.clip_count == 6).all()
    np.testing.assert_array_equal(meter.video_labels, jmeter.video_labels)
    assert_close_to_largest(meter.video_preds, jmeter.video_preds, OUT_TOL, "video_preds")
    np.testing.assert_allclose(meter.video_preds.sum(axis=1), 6.0, rtol=0, atol=1e-4)

    cfg, _ = cfgs(case.opts + ["DATA.TEST_CROP_SIZE", str(crop), "TEST.CHECKPOINT_FILE_PATH", str(path),
                                "TEST.BATCH_SIZE", "2", "MODEL_BENCHMARK.ITERATIONS", "1",
                                "MODEL_BENCHMARK.WARMUP_ITERATIONS", "1", "OUTPUT_DIR", str(tmp_path)])
    before = flash_attention.LAUNCHES
    got = mb.model_benchmark(cfg, device="cpu")
    assert got["clips_per_sec"] > 0 and got["batch_size"] == 2 and got["device"] == "cpu"
    assert got["attention_kernel_launches"] == 0 and flash_attention.LAUNCHES == before


def test_bundle_of_a_conv_family_has_no_merge(cases):
    """As in ``vtm``: the policy is ``MergePolicy()``, ``r`` reads (), and
    setting ``r`` or tracing the merge sources raises TypeError."""
    case = _case(cases, "c2d")
    jb = jax_build_model(case.jcfg, init=False)
    assert case.bundle.r == jb.r == ()
    for bundle in (case.bundle, jb):
        with pytest.raises(TypeError):
            bundle.r = 4
    with pytest.raises(TypeError):
        case.bundle.apply(torch.zeros(1, 8, 32, 32, 3), trace_source=True)


def _yaml_cfgs(path):
    from vtm.config import load_config as jax_load_config
    from vtm_torch.config import load_config

    class Args:
        opts = ["TPU.COMPUTE_DTYPE", "float32"]
        cfg_files = [str(path)]

    return load_config(Args(), str(path)), jax_load_config(Args(), str(path))


@pytest.mark.parametrize("path", SLOWFAST_YAMLS, ids=lambda p: p.stem)
def test_shipped_slowfast_configs_build_at_full_width(path):
    """Each shipped SlowFast yaml builds in the port with ``vtm``'s
    parameter and statistics shapes (``jax.eval_shape`` of its init), the
    same parameter count, no merge, fp32 and channels_last_3d weights."""
    cfg, jcfg = _yaml_cfgs(path)
    bundle = build_model(cfg, "cpu")
    assert isinstance(bundle.module, SlowFastModel) and not bundle.policy.enabled
    jb = jax_build_model(jcfg, init=False)
    t, s = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE
    shapes = jax.eval_shape(jb.module.init, jax.random.key(0), jnp.zeros((1, t, s, s, 3)))
    want = pyslowfast_state_dict_from_vtm(
        jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes["params"]),
        jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes["batch_stats"]))
    own = bundle.module.state_dict()
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: tuple(v.shape) for k, v in want.items()}
    count = sum(p.numel() for p in bundle.module.parameters())
    assert count == sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))
    conv = bundle.module.s1.pathway0_stem.conv.weight
    assert conv.dtype == torch.float32 and conv.is_contiguous(memory_format=torch.channels_last_3d)


@pytest.mark.parametrize("path", SLOWFAST_YAMLS, ids=lambda p: p.stem)
def test_shipped_slowfast_configs_run_the_entry_points(path, tmp_path):
    """Each shipped SlowFast yaml, its widths and clips cut (width 8 a
    group, 32-pixel crops, batch 4 of synthetic clips; depth, frames, alpha,
    BatchNorm type, precise BN and the yaml's string weight decay as
    shipped), through ``train_net.train`` (one epoch, precise statistics,
    a checkpoint), ``test_net.test`` on that checkpoint and
    ``model_benchmark``: nothing raises, ``test_net`` with the SSv2 yaml's
    LOG_MODEL_INFO as shipped included."""
    from vtm_torch.config import load_config
    from vtm_torch.tools import train_net

    class Args:
        opts = ["RESNET.WIDTH_PER_GROUP", "8", "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
                "TRAIN.DATASET", "synthetic", "TEST.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "4",
                "TEST.BATCH_SIZE", "4", "SOLVER.MAX_EPOCH", "1", "TRAIN.AUTO_RESUME", "False",
                "TEST.NUM_ENSEMBLE_VIEWS", "1", "DATA_LOADER.NUM_WORKERS", "0", "MODEL_BENCHMARK.ITERATIONS", "1",
                "MODEL_BENCHMARK.WARMUP_ITERATIONS", "1", "TRAIN.CHECKPOINT_PERIOD", "1", "TRAIN.EVAL_PERIOD", "1",
                "OUTPUT_DIR", str(tmp_path)]

    cfg = load_config(Args(), str(path))
    assert cfg.SOLVER.WEIGHT_DECAY == "1e-4" and cfg.BN.USE_PRECISE_STATS
    module = train_net.train(cfg, device="cpu")
    assert all(bool(torch.isfinite(p).all()) for p in module.parameters())
    (views, stats), = tn.test(cfg, device="cpu")  # the SSv2 yaml's LOG_MODEL_INFO as shipped
    assert views == 1 and np.isfinite(float(stats["top1_acc"]))
    assert mb.model_benchmark(cfg, device="cpu")["attention_kernel_launches"] == 0
