"""The port's demos and loader benchmark against the JAX package's, on the
CPU: the video manager's clips, the predictor's logits and the drawn
labels (``vis/demo.py``), ``python -m vtm_torch.tools.demo_net`` end to
end (in turn and with the threaded manager and two drawing workers), the
AVA demo's box loading and its per-keyframe detections
(``tools/ava_demo_precomputed_boxes.py``), and the data-loading
benchmark (``tools/benchmark.py``)."""

import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

import tools.ava_demo_precomputed_boxes as jax_ava_demo
import tools.benchmark as jax_benchmark
import vtm.checkpoints.checkpoint as jax_checkpoint
import vtm.models as jax_models
import vtm.vis.demo as jax_demo
import vtm.vis.video_visualizer as jax_vv
from vtm.checkpoints.convert import convert_pyslowfast
from vtm.config import get_cfg as jax_get_cfg
from vtm_torch.config import get_cfg
from vtm_torch.tools import ava_demo_precomputed_boxes as ava_demo
from vtm_torch.tools import benchmark
from vtm_torch.tools.demo_net import run_demo
from vtm_torch.vis import demo, video_visualizer

from test_torch_test_net import _write_checkpoint
from torch_ava_cases import ava_data_opts, conv_opts, write_ava_tree

torch.set_num_threads(2)

cv2 = pytest.importorskip("cv2")

# the demo predictor's logits, port against vtm, fp32 from one checkpoint
LOGITS_ATOL = 1e-4
# the AVA demo's box scores (sigmoid), port against vtm
SCORES_ATOL = 1e-5

# a tiny VideoMAE (ViT-S at 4 frames of 32 px) merged at r 2; the demo's
# clips are 8 frames (4 at sampling rate 2)
DEMO_OPTS = ["MODEL.MODEL_NAME", "VideoMAE", "VIDEOMAE.MODEL", "vit_small_patch16_224", "DATA.TEST_CROP_SIZE", "32",
             "DATA.TRAIN_CROP_SIZE", "32", "DATA.NUM_FRAMES", "4", "DATA.SAMPLING_RATE", "2", "MODEL.NUM_CLASSES",
             "7", "TOME.ENABLE", "True", "TOME.R_VALUE", "2", "TPU.COMPUTE_DTYPE", "float32", "DEMO.ENABLE", "True"]


def _cfgs(opts):
    cfg, jcfg = get_cfg(), jax_get_cfg()
    cfg.merge_from_list(list(opts))
    jcfg.merge_from_list(list(opts))
    return cfg, jcfg


def _video(path: pathlib.Path, frames: int, hw=(40, 56), seed: int = 0) -> pathlib.Path:
    rng = np.random.default_rng(seed)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 30, hw[::-1])
    for _ in range(frames):
        writer.write(rng.integers(0, 255, hw + (3,), dtype=np.uint8))
    writer.release()
    return path


def _read(path) -> list:
    cap, frames = cv2.VideoCapture(str(path)), []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


def test_predictor_and_drawing_match_vtm(tmp_path):
    """One checkpoint file into both packages: every clip the video manager
    cuts (the buffer carried over) equal, the predictor's logits within
    LOGITS_ATOL, the drawn top-k labels pixel for pixel."""
    ckpt = tmp_path / "model.pyth"
    _write_checkpoint(ckpt, DEMO_OPTS)
    opts = DEMO_OPTS + ["DEMO.INPUT_VIDEO", str(_video(tmp_path / "in.avi", 20)), "DEMO.BUFFER_SIZE", "2",
                        "TEST.CHECKPOINT_FILE_PATH", str(ckpt), "OUTPUT_DIR", str(tmp_path)]
    cfg, jcfg = _cfgs(opts)
    predictor, jax_predictor = demo.Predictor(cfg, device="cpu"), jax_demo.Predictor(jcfg)
    manager, jax_manager = demo.VideoManager(cfg), jax_demo.VideoManager(jcfg)
    names = [f"class{i}" for i in range(7)]
    clips = 0
    try:
        for task, ref in zip(manager, jax_manager, strict=True):
            assert task.num_buffer_frames == ref.num_buffer_frames == (2 if clips else 0)
            np.testing.assert_array_equal(np.stack(task.frames), np.stack(ref.frames))
            with jax.default_matmul_precision("highest"):
                jax_predictor(ref)
            predictor(task)
            np.testing.assert_allclose(task.preds, ref.preds, atol=LOGITS_ATOL)
            ref.preds = task.preds  # the same labels to draw
            got = demo.draw_predictions(task, names, k=3)
            want = jax_demo.draw_predictions(ref, names, k=3)
            np.testing.assert_array_equal(np.stack(got.frames), np.stack(want.frames))
            clips += 1
    finally:
        manager.clean()
        jax_manager.clean()
    assert clips == 3  # 8, then 6 new frames a clip: 8 + 6 + 6 of 20


@pytest.mark.parametrize("thread, workers", [(False, 1), (True, 2)], ids=["in-turn", "threaded-2-workers"])
def test_demo_net_writes_every_frame(tmp_path, thread, workers):
    """``run_demo`` on the CPU: a clip every 8 frames of 24, each frame
    written once and drawn, in turn or with the threaded manager and two
    spawned drawing workers."""
    src = _video(tmp_path / "in.avi", 24)
    out = tmp_path / "out.mp4"
    cfg = get_cfg()
    cfg.merge_from_list(DEMO_OPTS + ["DEMO.INPUT_VIDEO", str(src), "DEMO.OUTPUT_FILE", str(out),
                                     "DEMO.THREAD_ENABLE", str(thread), "DEMO.NUM_VIS_INSTANCES", str(workers),
                                     "OUTPUT_DIR", str(tmp_path)])
    assert run_demo(cfg, device="cpu") == 3
    written = _read(out)
    assert len(written) == 24 and written[0].shape == (40, 56, 3)


def _ava(tmp_path):
    """A tiny SlowFast with the ROI head (8 frames at rate 2), one
    checkpoint file of it, and the tree's first video as an avi."""
    root = tmp_path / "ava"
    frame_dir, _, ann_dir = write_ava_tree(root)
    frames = sorted((frame_dir / "vid0").glob("*.jpg"))
    src = tmp_path / "vid0.avi"
    writer = cv2.VideoWriter(str(src), cv2.VideoWriter_fourcc(*"MJPG"), 30, (48, 32))
    for f in frames:
        writer.write(cv2.imread(str(f)))
    writer.release()
    # vid0's predicted boxes at its first two keyframes: one clip each to detect
    boxes = tmp_path / "vid0_boxes.csv"
    boxes.write_text("".join(line for line in open(ann_dir / "ava_val_predicted_boxes.csv")
                             if line.startswith(("vid0,902,", "vid0,903,"))))
    opts = conv_opts("SlowFast", "slowfast") + ava_data_opts(root) + [
        "DEMO.INPUT_VIDEO", str(src), "DEMO.PREDS_BOXES", str(boxes),
        "DEMO.GT_BOXES", str(ann_dir / "ava_val_v2.2.csv"), "DEMO.STARTING_SECOND", "900",
        "OUTPUT_DIR", str(tmp_path)]
    ckpt = tmp_path / "ava.pyth"
    _write_checkpoint(ckpt, opts)
    return opts + ["TEST.CHECKPOINT_FILE_PATH", str(ckpt)], len(frames)


def test_ava_demo_boxes_and_detections_match_vtm(tmp_path, monkeypatch):
    """``load_boxes_labels`` and ``merge_pred_gt_boxes`` equal ``vtm``'s; then
    each package's ``run_demo`` over the video: every keyframe's boxes and
    scores handed to the visualiser within SCORES_ATOL, every frame
    written."""
    opts, n_frames = _ava(tmp_path)
    cfg, jcfg = _cfgs(opts + ["DEMO.OUTPUT_FILE", str(tmp_path / "out.mp4")])
    jcfg.DEMO.OUTPUT_FILE = str(tmp_path / "jax_out.mp4")
    got = ava_demo.load_boxes_labels(cfg, "vid0", 30, 48, 32)
    want = jax_ava_demo.load_boxes_labels(jcfg, "vid0", 30, 48, 32)
    assert set(got[0]) == {60, 90} and len(got[1]) == 4  # predicted at 902, 903; ground truth at all four
    for g, w in zip(got, want, strict=True):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_array_equal(np.asarray(g[k][0]), np.asarray(w[k][0]))
            assert g[k][1] == w[k][1]
    assert ava_demo.merge_pred_gt_boxes(*got) == jax_ava_demo.merge_pred_gt_boxes(*want)

    # vtm's demo builds its model with the file's weights without its eager
    # init (30 s a conv model): the bundle's tree from eval_shape, the
    # weights through convert_pyslowfast
    state = {k: v.numpy() for k, v in torch.load(cfg.TEST.CHECKPOINT_FILE_PATH, weights_only=True)[
        "model_state"].items()}
    params, stats = convert_pyslowfast(state)
    jbundle = dataclasses.replace(jax_models.build_model(jcfg, init=False), params=params, batch_stats=stats)
    monkeypatch.setattr(jax_models, "build_model", lambda c, **kw: jbundle)
    monkeypatch.setattr(jax_checkpoint, "load_test_checkpoint", lambda c, b: b)

    seen = {"torch": [], "jax": []}
    for name, module in (("torch", video_visualizer), ("jax", jax_vv)):
        draw = module.VideoVisualizer.draw_clip_range

        def recorded(self, frames, preds, bboxes=None, *a, _name=name, _draw=draw, **kw):
            seen[_name].append((np.asarray(preds), np.asarray(bboxes)))
            return _draw(self, frames, preds, bboxes, *a, **kw)

        monkeypatch.setattr(module.VideoVisualizer, "draw_clip_range", recorded)
    path = ava_demo.run_demo(cfg, device="cpu")
    with jax.default_matmul_precision("highest"):
        jax_ava_demo.run_demo(jcfg)
    assert len(seen["torch"]) == len(seen["jax"]) == 2
    for (preds, boxes), (jpreds, jboxes) in zip(seen["torch"], seen["jax"]):
        np.testing.assert_array_equal(boxes, jboxes)
        np.testing.assert_allclose(preds, jpreds, atol=SCORES_ATOL)
    assert len(_read(path)) == n_frames


def test_benchmark_counts_vtms_batches(tmp_path):
    """The loader benchmark over the synthetic train set, 2 epochs: the
    batches and clips vtm's counts, and positive rates."""
    opts = DEMO_OPTS + ["TRAIN.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "4", "BENCHMARK.NUM_EPOCHS", "2",
                        "BENCHMARK.LOG_PERIOD", "3", "BENCHMARK.SHUFFLE", "False", "DATA_LOADER.NUM_WORKERS", "1",
                        "OUTPUT_DIR", str(tmp_path)]
    cfg, jcfg = _cfgs(opts)
    got, want = benchmark.benchmark_data_loading(cfg), jax_benchmark.benchmark_data_loading(jcfg)
    assert got["total_batches"] == want["total_batches"] == 8
    assert got["clips_per_sec"] / got["batches_per_sec"] == pytest.approx(4.0)
    assert got["peak_rss_bytes"] > 0 and set(got) == set(want)
