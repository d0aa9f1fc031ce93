"""The port's visualisation tail against the JAX package's, on the CPU:
class names, the wandb opt-in, the tensorboard writer (scalars read back
with tensorboard's own reader, the confusion matrix), ``train_net`` and
``test_net`` with ``TENSORBOARD.ENABLE`` and ``WANDB.ENABLE``, the
activations and weights under ``vtm``'s layer names, the layer-index
parsing, the top-k figure, the video visualiser's labels and drawn frames,
and the multiprocess drawing pool."""

import glob
import json
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.train_net as jax_train_net
import vtm.vis.activations as jax_acts
import vtm.vis.async_predictor as jax_async
import vtm.vis.tensorboard_vis as jax_tb
import vtm.vis.video_visualizer as jax_vv
from vtm.config import get_cfg as jax_get_cfg
from vtm.merge.policy import MergePolicy as JPolicy
from vtm.models.build import ModelBundle as JBundle
from vtm.utils import wandb_utils as jax_wandb
from vtm.utils.class_names import get_class_names as jax_get_class_names
from vtm.vis.demo import TaskInfo as JTaskInfo
from vtm_torch.config import get_cfg
from vtm_torch.merge.policy import MergePolicy
from vtm_torch.models.build import ModelBundle
from vtm_torch.tools import train_net
from vtm_torch.utils import wandb_utils
from vtm_torch.utils.class_names import get_class_names
from vtm_torch.vis import activations, async_predictor, tensorboard_vis, video_visualizer
from vtm_torch.vis.demo import TaskInfo

import test_torch_videomae as vm_cases
from test_torch_test_net import _write_checkpoint
from torch_conv_cases import Case

torch.set_num_threads(2)

# the train loss of a tiny VideoMAE in fp32, port against vtm, over 4 steps
LOSS_RTOL = 1e-4


def _events(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    files = glob.glob(str(log_dir / "events.*"))
    assert len(files) == 1, files
    return EventAccumulator(files[0], size_guidance={"scalars": 0, "images": 0}).Reload()


def _scalars(events):
    return {tag: [(e.step, e.value) for e in events.Scalars(tag)] for tag in events.Tags()["scalars"]}


def test_class_names_match_vtm(tmp_path):
    (tmp_path / "classes.json").write_text(json.dumps({"run": 0, "jump": 2, "walk": 1}))
    (tmp_path / "parents.json").write_text(json.dumps({"move": ["run", "walk", "fly"], "leap": ["jump"]}))
    (tmp_path / "subset.txt").write_text("run\njump\nmissing\n")
    paths = [str(tmp_path / n) for n in ("classes.json", "parents.json", "subset.txt")]
    assert get_class_names(*paths) == jax_get_class_names(*paths) == (
        ["run", "walk", "jump"], {"move": [0, 1], "leap": [2]}, [0, 2])
    assert get_class_names(str(tmp_path / "absent.json")) is None is jax_get_class_names(str(tmp_path / "absent.json"))


def test_wandb_is_a_no_op_without_the_package(monkeypatch):
    """As in vtm: WANDB.ENABLE without wandb installed starts nothing."""
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ImportError
    monkeypatch.setattr(jax_wandb, "_wandb", None)
    cfg, jcfg = get_cfg(), jax_get_cfg()
    cfg.WANDB.ENABLE = jcfg.WANDB.ENABLE = True
    assert wandb_utils.init(cfg) is False and jax_wandb.init(jcfg) is False
    wandb_utils.log({"x": 1.0})
    wandb_utils.finish()


def test_wandb_run_with_the_package(monkeypatch):
    """With a package, the run vtm starts: init(project, the config's
    dump), every log, finish; nothing when WANDB.ENABLE is off."""
    calls = []
    fake = types.SimpleNamespace(init=lambda **kw: calls.append(("init", kw)),
                                 log=lambda stats: calls.append(("log", stats)),
                                 finish=lambda: calls.append(("finish",)))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    cfg = get_cfg()
    assert wandb_utils.init(cfg) is False and not calls
    cfg.WANDB.ENABLE, cfg.WANDB.PROJECT = True, "vtm"
    assert wandb_utils.init(cfg) is True
    wandb_utils.log({"top1_acc": 50.0})
    wandb_utils.finish()
    wandb_utils.log({"after": 1.0})
    assert calls == [("init", {"project": "vtm", "config": cfg.dump()}), ("log", {"top1_acc": 50.0}), ("finish",)]


def _tb_cfgs(tmp_path, *opts):
    cfg, jcfg = get_cfg(), jax_get_cfg()
    for c, name in ((cfg, "torch"), (jcfg, "jax")):
        c.merge_from_list(["OUTPUT_DIR", str(tmp_path / name), "MODEL.NUM_CLASSES", "4", *opts])
    return cfg, jcfg


def test_tensorboard_scalars_match_vtm(tmp_path):
    """The same dicts through both writers: the same tags, steps and
    values in the event files."""
    cfg, jcfg = _tb_cfgs(tmp_path, "TENSORBOARD.LOG_DIR", "tb")
    rng = np.random.default_rng(0)
    dicts = [({"Train/loss": float(rng.random()), "Train/lr": 0.1 / (i + 1)}, i) for i in range(5)]
    dicts.append(({"Val/top1_err": 12.5}, None))
    for writer in (tensorboard_vis.TensorboardWriter(cfg), jax_tb.TensorboardWriter(jcfg)):
        for d, step in dicts:
            writer.add_scalars(d, global_step=step)
        writer.close()
    got, want = _scalars(_events(tmp_path / "torch" / "tb")), _scalars(_events(tmp_path / "jax" / "tb"))
    assert got == want and set(got) == {"Train/loss", "Train/lr", "Val/top1_err"}
    assert [s for s, _ in got["Train/lr"]] == [0, 1, 2, 3, 4]


def test_confusion_matrix_matches_vtm(tmp_path):
    rng = np.random.default_rng(1)
    preds, labels = rng.random((30, 4)), rng.integers(0, 4, 30)
    cm = tensorboard_vis.get_confusion_matrix(preds, labels, 4)
    np.testing.assert_array_equal(cm, jax_tb.get_confusion_matrix(preds, labels, 4))
    np.testing.assert_allclose(cm.sum(axis=1)[np.bincount(labels, minlength=4) > 0], 1.0)
    fig = tensorboard_vis.plot_confusion_matrix(cm, 4, ["a", "b", "c", "d", "e"])
    assert [t.get_text() for t in fig.axes[0].get_xticklabels()] == ["a", "b", "c", "d"]
    cfg, _ = _tb_cfgs(tmp_path, "TENSORBOARD.CONFUSION_MATRIX.ENABLE", "True")
    writer = tensorboard_vis.TensorboardWriter(cfg)
    writer.plot_eval(preds, labels, global_step=3)
    writer.close()
    assert "Confusion Matrix" in _events(tmp_path / "torch" / "runs-kinetics").Tags()["images"]


def test_train_writes_vtms_scalars(tmp_path):
    """``train_net.train`` with TENSORBOARD.ENABLE and WANDB.ENABLE (both once
    refused) on a tiny VideoMAE from one checkpoint file in both packages:
    ``Train/loss`` and ``Train/lr`` at the same steps, the lr equal and the
    loss within LOSS_RTOL."""
    opts = ["MODEL.MODEL_NAME", "VideoMAE", "VIDEOMAE.MODEL", "vit_small_patch16_224", "VIDEOMAE.DROP_PATH_RATE",
            "0.0", "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32", "DATA.NUM_FRAMES", "4",
            "MODEL.NUM_CLASSES", "5", "TPU.COMPUTE_DTYPE", "float32", "TRAIN.DATASET", "synthetic",
            "TRAIN.BATCH_SIZE", "4", "SOLVER.MAX_EPOCH", "1", "TRAIN.EVAL_PERIOD", "10", "TRAIN.CHECKPOINT_PERIOD",
            "10", "TRAIN.AUTO_RESUME", "False", "DATA_LOADER.NUM_WORKERS", "0", "TENSORBOARD.ENABLE", "True",
            "WANDB.ENABLE", "True", "SOLVER.BASE_LR", "1e-3", "SOLVER.WARMUP_EPOCHS", "0.0"]
    ckpt = tmp_path / "init.pyth"
    _write_checkpoint(ckpt, opts)
    cfg, jcfg = get_cfg(), jax_get_cfg()
    for c, name in ((cfg, "torch"), (jcfg, "jax")):
        c.merge_from_list(opts + ["TRAIN.CHECKPOINT_FILE_PATH", str(ckpt), "OUTPUT_DIR", str(tmp_path / name)])
    train_net.train(cfg, device="cpu")
    with jax.default_matmul_precision("highest"):
        jax_train_net.train(jcfg)
    got = _scalars(_events(tmp_path / "torch" / "runs-kinetics"))
    want = _scalars(_events(tmp_path / "jax" / "runs-kinetics"))
    assert set(got) == set(want) == {"Train/loss", "Train/lr"}
    assert [s for s, _ in got["Train/loss"]] == [s for s, _ in want["Train/loss"]] == [0, 1, 2, 3]
    np.testing.assert_allclose([v for _, v in got["Train/lr"]], [v for _, v in want["Train/lr"]], rtol=1e-6)
    np.testing.assert_allclose([v for _, v in got["Train/loss"]], [v for _, v in want["Train/loss"]],
                               rtol=LOSS_RTOL)


def test_indexing_parses_match_vtm():
    for s in ("1,2;1,2", "0;3,4;5", "7"):
        for got, want in zip(activations.get_indexing(s), jax_acts.get_indexing(s), strict=True):
            np.testing.assert_array_equal(got, want)
    layers = ["layer1 1,2;2", "layer2", "layer3 0;3,4"]
    got_names, got_idx = activations.process_layer_index_data(layers, "pre/")
    want_names, want_idx = jax_acts.process_layer_index_data(layers, "pre/")
    assert got_names == want_names and set(got_idx) == set(want_idx)
    for k in got_names:
        assert len(got_idx[k]) == len(want_idx[k])
        for a, b in zip(got_idx[k], want_idx[k]):
            np.testing.assert_array_equal(a, b)


# VideoMAE of 2 layers, width 64: the names are vtm's flax paths
VIDEOMAE = dict(vm_cases.TINY, embed_dim=64)
ACT_LAYERS = ["blocks_0/attn", "blocks_1", "blocks_1/mlp/fc1", "patch_embed"]
WEIGHT_LAYERS = ["head", "blocks_0/attn/qkv", "blocks_1/norm1", "patch_embed", "blocks_0/attn/q_bias", "fc_norm",
                 "blocks_7/attn", "nowhere"]


def test_activations_and_weights_match_vtm():
    kw = dict(rs=(1, 1), mode="merge")
    _, params, jmodel, tmodel = vm_cases._models(VIDEOMAE, 5, JPolicy(**kw), MergePolicy(**kw))
    jbundle = JBundle(module=jmodel, params=params, config=None, policy=JPolicy(**kw), name="VideoMAE")
    bundle = ModelBundle(module=tmodel, policy=MergePolicy(**kw), name="VideoMAE")
    frames = vm_cases._video(VIDEOMAE, 2, 5)
    indexing = {"blocks_1": (np.array([1]), np.array([0, 2]))}
    with jax.default_matmul_precision("highest"):
        want, want_preds = jax_acts.get_activations(jbundle, frames, ACT_LAYERS, indexing=indexing)
    got, preds = activations.get_activations(bundle, frames, ACT_LAYERS, indexing=indexing)
    assert set(got) == set(want) == set(ACT_LAYERS)
    for name in ACT_LAYERS:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], atol=1e-5, rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(preds, want_preds, atol=1e-5)
    every, _ = activations.get_activations(bundle, frames, [])
    assert "blocks.0.attn" in every and "blocks.1" in every
    w, jw = activations.get_weights(tmodel, WEIGHT_LAYERS), jax_acts.get_weights(params, WEIGHT_LAYERS)
    assert set(w) == set(jw) == set(WEIGHT_LAYERS[:-2])
    for name in w:
        np.testing.assert_array_equal(w[name], np.asarray(jw[name]), err_msg=name)


def test_conv_activations_are_channels_last_as_vtms():
    """A conv family's 5-D activations and kernels in vtm's layouts."""
    case = Case("slow")
    jbundle = JBundle(module=case.jbundle.module, params=case.params, config=case.jbundle.config,
                      policy=case.jbundle.policy, name=case.jbundle.name, batch_stats=case.stats)
    frames = case.video(1, 6)
    layers = ["s1/pathway0_stem/conv", "s2/pathway0_res0/branch2/c"]
    want, _ = jax_acts.get_activations(jbundle, jnp.asarray(frames), layers)
    got, _ = activations.get_activations(case.bundle, frames, layers)
    for name in layers:
        np.testing.assert_allclose(got[name], np.asarray(want[name]), atol=1e-5, rtol=1e-4, err_msg=name)
    w, jw = activations.get_weights(case.bundle.module, layers), jax_acts.get_weights(case.params, layers)
    for name in layers:
        np.testing.assert_array_equal(w[name], np.asarray(jw[name]), err_msg=name)


def test_topk_histogram_matches_vtm():
    scores = np.random.default_rng(2).random(7)
    got = activations.plot_topk_histogram("p", scores, k=3, class_names=list("abcdefg"))
    want = jax_acts.plot_topk_histogram("p", scores, k=3, class_names=list("abcdefg"))
    heights = [[b.get_height() for b in f.axes[0].patches] for f in (got, want)]
    labels = [[t.get_text() for t in f.axes[0].get_xticklabels()] for f in (got, want)]
    assert heights[0] == heights[1] and labels[0] == labels[1] and len(heights[0]) == 3


@pytest.mark.parametrize("n", [1, 5, 80])
def test_rainbow_is_matplotlibs(n):
    import matplotlib.pyplot as plt

    cmap = plt.get_cmap("rainbow", n)
    np.testing.assert_array_equal(video_visualizer.rainbow_colors(n), np.asarray([cmap(i) for i in range(n)]))


def _visualizers(**kw):
    return video_visualizer.VideoVisualizer(**kw), jax_vv.VideoVisualizer(**kw)


@pytest.mark.parametrize("kw", [
    dict(num_classes=5, top_k=2),
    dict(num_classes=5, mode="thres", thres=0.6, lower_thres=0.2, class_names=list("abcde"),
         common_class_names=["a", "c"]),
    dict(num_classes=5, top_k=1, colormap="viridis"),
], ids=["top-k", "thres-common", "viridis"])
def test_video_visualizer_draws_vtms_frames(kw):
    """Labels, and every pixel of a clip drawn with and without boxes."""
    port, ref = _visualizers(**kw)
    rng = np.random.default_rng(3)
    assert video_visualizer._create_text_labels([1, 3], [0.25, 0.5], list("abcde")) == \
        jax_vv._create_text_labels([1, 3], [0.25, 0.5], list("abcde"))
    assert video_visualizer._create_text_labels([2], None, list("abcde"), ground_truth=True) == \
        jax_vv._create_text_labels([2], None, list("abcde"), ground_truth=True)
    frames = [rng.integers(0, 255, (48, 64, 3), dtype=np.uint8) for _ in range(6)]
    preds = rng.random(5)
    boxes = np.array([[4.0, 5.0, 30.0, 40.0], [20.0, 2.0, 60.0, 44.0]])
    box_preds = rng.random((2, 5))
    for args, kwargs in (((frames, preds), dict(draw_range=[1, 3])),
                         ((frames, box_preds), dict(bboxes=boxes, draw_range=[2, 9]))):
        got, want = port.draw_clip_range(*args, **kwargs), ref.draw_clip_range(*args, **kwargs)
        np.testing.assert_array_equal(np.stack(got), np.stack(want))
        assert not np.array_equal(np.stack(got), np.stack(frames))


def test_async_vis_round_trip_draws_vtms_frames():
    """Two spawned drawing workers: tasks come back in put order, drawn as
    ``vtm``'s ``draw_predictions`` draws them in this process; tensors on
    a task go as numpy."""
    vis = video_visualizer.VideoVisualizer(num_classes=5, top_k=2)
    ref_vis = jax_vv.VideoVisualizer(num_classes=5, top_k=2)
    pool = async_predictor.AsyncVis(vis, n_workers=2)
    want = []
    try:
        for i in range(3):
            frames = [np.full((32, 48, 3), 30 * i, np.uint8) for _ in range(6)]
            preds = np.linspace(0, 1, 5) * (i + 1)
            task = TaskInfo(7 * i, frames)  # gappy ids: put() numbers the tasks itself
            task.add_action_preds(torch.from_numpy(preds))
            task.clip_vis_size, task.num_buffer_frames = 1, i % 2
            ref = JTaskInfo(i, list(frames))
            ref.add_action_preds(preds)
            ref.clip_vis_size, ref.num_buffer_frames = 1, i % 2
            want.append(np.array(jax_async.draw_predictions(ref, ref_vis)))
            pool.put(task)
        got = []
        deadline = time.time() + 60
        while len(got) < 3 and time.time() < deadline:
            try:
                got.append(pool.get())
            except IndexError:
                time.sleep(0.05)
    finally:
        pool.shutdown()
    assert [t.id for t in got] == [0, 1, 2]
    for task, frames in zip(got, want):
        assert isinstance(task.action_preds, np.ndarray)
        np.testing.assert_array_equal(task.frames, frames)
