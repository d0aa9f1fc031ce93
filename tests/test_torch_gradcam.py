"""The port's Grad-CAM (``vtm_torch/vis/gradcam.py``) against the JAX
package's, on the CPU in fp32 with the same weights and clips: VideoMAE
(spatio-temporal merging), TimeSformer (per-frame merging, CLS stripped)
and SlowFast (a conv stage's slow pathway), merged and unmerged, at
``vtm``'s layer names; the backward stops at the target; the overlay; and
``python -m vtm_torch.tools.visualization`` end to end.

At a block before the last of a merged model the port unrolls the map
through the source that block hands on, where ``vtm`` takes the model's
final source (ROADMAP.md Queue 3): there ``vtm``'s map is taken with the
target's source put in its place, from ``vtm``'s own model cut after the
target (the source after block t depends on blocks 0..t only)."""

import contextlib
import dataclasses
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vtm.vis.gradcam as jax_gradcam
from vtm.merge.policy import MergePolicy as JPolicy
from vtm.models.build import ModelBundle as JBundle
from vtm.models.timesformer import TimeSformerConfig as JTSConfig
from vtm.models.videomae import VideoMAEConfig as JVMConfig
from vtm.vis.gradcam import GradCAM as JGradCAM
from vtm_torch.config import get_cfg
from vtm_torch.merge.policy import MergePolicy
from vtm_torch.models.build import ModelBundle
from vtm_torch.vis.gradcam import GradCAM, resolve_layer

import test_torch_timesformer as ts_cases
import test_torch_videomae as vm_cases
from torch_conv_cases import Case

torch.set_num_threads(2)

# maps in [0, 1] and the logits, port against vtm in fp32: measured within
# 2e-6 at these sizes
MAP_ATOL = 1e-5
PREDS_ATOL = 1e-5

# 3 layers of width 64 (2 heads), 4 frames at 32 px: 8 tubelets
VIDEOMAE = dict(vm_cases.TINY, embed_dim=64, depth=3)
# 2 layers of width 64, 4 frames of 4 patches
TIMESFORMER = dict(ts_cases.TINY, embed_dim=64)


def _videomae(rs):
    kw = dict(rs=rs, mode="merge" if any(rs) else "none")
    _, params, jmodel, tmodel = vm_cases._models(VIDEOMAE, 5, JPolicy(**kw), MergePolicy(**kw))
    jbundle = JBundle(module=jmodel, params=params, config=JVMConfig(num_classes=5, **VIDEOMAE),
                      policy=JPolicy(**kw), name="VideoMAE")
    return jbundle, ModelBundle(module=tmodel, policy=MergePolicy(**kw), name="VideoMAE")


def _timesformer(rs):
    kw = dict(rs=rs, mode="merge" if any(rs) else "none")
    params, jmodel, tmodel = ts_cases._models(TIMESFORMER, kw)
    jbundle = JBundle(module=jmodel, params=params, config=JTSConfig(**TIMESFORMER), policy=JPolicy(**kw),
                      name="TimeSformer")
    return jbundle, ModelBundle(module=tmodel, policy=MergePolicy(**kw), name="TimeSformer")


@contextlib.contextmanager
def _target_source(cut_module):
    """While open, ``vtm``'s Grad-CAM unrolls through the source of
    ``cut_module`` (the model cut after the target, tracing its source)."""
    real = jax_gradcam._apply_with_perturbation

    def patched(module, variables, x, layer_path, eps):
        logits, state, act = real(module, variables, x, layer_path, eps)
        _, cut_state = cut_module.apply(variables, x)
        return logits, dataclasses.replace(state, source=cut_state.source), act

    jax_gradcam._apply_with_perturbation = patched
    try:
        yield
    finally:
        jax_gradcam._apply_with_perturbation = real


def _maps(jbundle, bundle, video, target, cut_module=None):
    with jax.default_matmul_precision("highest"), (
            _target_source(cut_module) if cut_module is not None else contextlib.nullcontext()):
        want_maps, want_preds = JGradCAM(jbundle, target).localization_map(jnp.asarray(video))
    got_maps, got_preds = GradCAM(bundle, target).localization_map(video)
    return (np.asarray(want_maps), np.asarray(want_preds)), (got_maps, got_preds)


def _assert_match(want, got, shape):
    (want_maps, want_preds), (got_maps, got_preds) = want, got
    assert got_maps.shape == want_maps.shape == shape
    assert np.isfinite(got_maps).all() and got_maps.min() >= 0 and got_maps.max() <= 1
    np.testing.assert_allclose(got_maps, want_maps, atol=MAP_ATOL, rtol=0)
    np.testing.assert_allclose(got_preds, want_preds, atol=PREDS_ATOL, rtol=0)


@pytest.mark.parametrize("rs, target", [((0, 0, 0), None), ((2, 2, 1), None), ((2, 2, 1), "blocks_1")],
                         ids=["unmerged-last-block", "merged-last-block", "merged-blocks_1"])
def test_videomae_maps_match_vtm(rs, target):
    """Spatio-temporal merging: the merged map unrolled through the source
    (traced for the call: the policy does not trace) to the 8 tubelets."""
    jbundle, bundle = _videomae(rs)
    video = vm_cases._video(VIDEOMAE, 2, 0)
    cut = None
    if target is not None:
        t = int(target.split("_")[1]) + 1
        cut = jbundle.module.clone(config=JVMConfig(num_classes=5, **dict(VIDEOMAE, depth=t)),
                                   policy=JPolicy(rs=rs[:t], mode="merge", trace_source=True))
    _assert_match(*_maps(jbundle, bundle, video, target, cut), (2, 8))
    assert not bundle.policy.trace_source


@pytest.mark.parametrize("rs, target", [((0, 0), None), ((1, 1), "blocks_0")],
                         ids=["unmerged-last-block", "merged-blocks_0"])
def test_timesformer_maps_match_vtm(rs, target):
    """Per-frame merging (r 1 a frame): the frame-folded source, the CLS
    row stripped, the (p t) order."""
    jbundle, bundle = _timesformer(rs)
    video = ts_cases._video(TIMESFORMER, 2, 1)
    cut = None
    if target is not None:
        cut = jbundle.module.clone(config=JTSConfig(**dict(TIMESFORMER, depth=1)),
                                   policy=JPolicy(rs=(1,), mode="merge", trace_source=True))
    _assert_match(*_maps(jbundle, bundle, video, target, cut), (2, 16))


def test_slowfast_map_matches_vtm():
    """A conv stage's output is its pathways: the map is the slow one's
    [T', H', W'] grid."""
    case = Case("slowfast")
    jbundle = JBundle(module=case.jbundle.module, params=case.params, config=case.jbundle.config,
                      policy=case.jbundle.policy, name=case.jbundle.name, batch_stats=case.stats)
    video = case.video(2, 3)
    want, got = _maps(jbundle, case.bundle, video, None)
    _assert_match(want, got, want[0].shape)
    assert got[0].ndim == 4


def test_layer_names_resolve_both_ways():
    _, bundle = _videomae((0, 0, 0))
    module = bundle.module
    assert resolve_layer(module, "blocks_1") is module.blocks[1] is resolve_layer(module, "blocks.1")
    assert resolve_layer(module, "blocks_0/attn") is module.blocks[0].attn
    with pytest.raises(KeyError, match="not found"):
        resolve_layer(module, "blocks_9")
    with pytest.raises(KeyError, match="not found"):
        GradCAM(bundle, "layer_1")


def test_backward_stops_at_the_target():
    """Blocks below the target run without autograd, those above with it;
    no parameter gets a gradient."""
    _, bundle = _videomae((2, 2, 2))
    modes = {}
    for i, blk in enumerate(bundle.module.blocks):
        blk.register_forward_pre_hook(lambda m, a, i=i: modes.__setitem__(i, torch.is_grad_enabled()))
    GradCAM(bundle, "blocks_1").localization_map(vm_cases._video(VIDEOMAE, 1, 2))
    assert modes == {0: False, 1: False, 2: True}
    assert all(p.grad is None for p in bundle.module.parameters())
    assert torch.is_grad_enabled()  # the caller's mode is restored
    with torch.no_grad():
        GradCAM(bundle, "blocks_1").localization_map(vm_cases._video(VIDEOMAE, 1, 2))
        assert not torch.is_grad_enabled()


@pytest.mark.parametrize("family", ["VideoMAE", "SlowFast"])
def test_overlay_matches_vtm(family):
    """The heat-map overlay (matplotlib's colormap) over [0, 1] frames."""
    rng = np.random.default_rng(4)
    if family == "VideoMAE":
        jbundle, bundle = _videomae((0, 0, 0))
        frames, cam = rng.random((4, 32, 32, 3)), rng.random(8)
    else:
        case = Case("slowfast")
        jbundle, bundle = case.jbundle, case.bundle
        frames, cam = rng.random((8, 32, 32, 3)), rng.random((2, 1, 1))
    got = GradCAM(bundle).overlay(frames, cam)
    want = JGradCAM(jbundle).overlay(frames, cam)
    assert got.dtype == np.uint8 and got.shape == frames.shape
    np.testing.assert_array_equal(got, want)


def test_visualization_driver_writes_every_summary(tmp_path, monkeypatch):
    """``run_visualization`` on a merged VideoMAE over the synthetic test
    set: the input video, Grad-CAM overlays at two layers, the wrongly
    predicted clips (each ``add_video``, which tensorboard writes only with
    moviepy installed), activation histograms, top-k figures and weight
    histograms in the event file, read back with tensorboard's reader."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from vtm_torch.tools.visualization import run_visualization
    from vtm_torch.vis.tensorboard_vis import TensorboardWriter

    videos = {}
    add_video = TensorboardWriter.add_video

    def recorded(self, vid, tag="Video Input", global_step=None, fps=4):
        videos[tag] = np.asarray(vid)
        return add_video(self, vid, tag=tag, global_step=global_step, fps=fps)

    monkeypatch.setattr(TensorboardWriter, "add_video", recorded)
    cfg = get_cfg()
    cfg.merge_from_list([
        "MODEL.MODEL_NAME", "VideoMAE", "VIDEOMAE.MODEL", "vit_small_patch16_224", "MODEL.NUM_CLASSES", "5",
        "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
        "TEST.DATASET", "synthetic", "TEST.BATCH_SIZE", "2", "TEST.NUM_ENSEMBLE_VIEWS", "1",
        "TEST.NUM_SPATIAL_CROPS", "1", "TOME.ENABLE", "True", "TOME.R_VALUE", "1", "TPU.COMPUTE_DTYPE", "float32",
        "DATA_LOADER.NUM_WORKERS", "0", "OUTPUT_DIR", str(tmp_path), "TENSORBOARD.ENABLE", "True",
        "TENSORBOARD.MODEL_VIS.ENABLE", "True", "TENSORBOARD.MODEL_VIS.INPUT_VIDEO", "True",
        "TENSORBOARD.MODEL_VIS.MODEL_WEIGHTS", "True", "TENSORBOARD.MODEL_VIS.MAX_BATCHES", "1",
        "TENSORBOARD.MODEL_VIS.GRAD_CAM.ENABLE", "True",
        "TENSORBOARD.MODEL_VIS.GRAD_CAM.LAYER_LIST", "['blocks_10', 'blocks.11']",
        "TENSORBOARD.MODEL_VIS.ACTIVATIONS", "True",
        "TENSORBOARD.MODEL_VIS.LAYER_LIST", "['blocks_0/attn', 'blocks_1 0;1']",
        "TENSORBOARD.MODEL_VIS.TOPK_PREDS", "3", "TENSORBOARD.WRONG_PRED_VIS.ENABLE", "True",
    ])
    run_visualization(cfg, device="cpu")
    assert {"Video Input", "GradCAM/blocks_10", "GradCAM/blocks.11"} <= set(videos)
    assert videos["GradCAM/blocks_10"].shape == (2, 4, 32, 32, 3)
    assert set(videos) <= {"Video Input", "GradCAM/blocks_10", "GradCAM/blocks.11",
                           cfg.TENSORBOARD.WRONG_PRED_VIS.TAG}
    events = EventAccumulator(glob.glob(str(tmp_path / "runs-synthetic" / "events.*"))[0],
                              size_guidance={"histograms": 0, "images": 0}).Reload()
    tags = events.Tags()
    histograms = set(tags["histograms"])
    assert {"activations/blocks_0/attn", "activations/blocks_1"} <= histograms
    assert any(t.startswith("weights/blocks.0.") for t in histograms)
    assert "topk_preds/batch0" in set(tags["images"])
