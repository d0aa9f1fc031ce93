"""What the port's AVA tests share (imported by ``tests/test_torch_ava.py``,
``test_torch_ava_eval.py`` and ``test_torch_ava_detection.py``; collects no
test itself).

``write_ava_tree`` writes a small AVA layout from numpy's seed: JPEG frame
folders with their frame lists, ground-truth person boxes with 1-3 labels
each, predicted boxes (the ground truth jittered, scores 0.85-0.99, and
boxes below the detection threshold that the loader drops), a labelmap
that evaluates some of the classes, the val ground truth and one excluded
keyframe. ``ava_opts`` gives both packages' configs for it on a tiny
SlowFast, ResNet or MViT with the ROI head.
"""

from __future__ import annotations

import pathlib

import numpy as np

from torch_conv_cases import tiny_opts

SECS = (902, 903, 904, 905)
CLASSES = 6
EVALUATED = (1, 2, 3, 5, 6)  # the labelmap's ids: class 4 is not evaluated
EXCLUDED = ("vid1", 903)
THRESH = 0.8


def write_ava_tree(root: pathlib.Path, videos: int = 2, frames: int = 160, size=(32, 48), seed: int = 0):
    """The layout under ``root`` (frames/, frame_lists/, annotations/);
    returns (frame_dir, list_dir, ann_dir)."""
    import cv2

    rng = np.random.default_rng(seed)
    frame_dir, list_dir, ann_dir = root / "frames", root / "frame_lists", root / "annotations"
    for d in (frame_dir, list_dir, ann_dir):
        d.mkdir(parents=True, exist_ok=True)
    lines = ["original_vido_id video_id frame_id path labels"]
    names = [f"vid{v}" for v in range(videos)]
    for v, name in enumerate(names):
        (frame_dir / name).mkdir(exist_ok=True)
        for f in range(frames):
            rel = f"{name}/{name}_{f:06d}.jpg"
            cv2.imwrite(str(frame_dir / rel), rng.integers(0, 255, size + (3,), dtype=np.uint8))
            lines.append(f'{name} {v} {f} {rel} ""')
    for split in ("train.csv", "val.csv"):
        (list_dir / split).write_text("\n".join(lines) + "\n")

    gt_rows, pred_rows = [], []
    for name in names:
        for sec in SECS:
            for person in range(int(rng.integers(1, 4))):
                x1, y1 = rng.uniform(0.0, 0.5, 2)
                x2, y2 = x1 + rng.uniform(0.2, 0.5), y1 + rng.uniform(0.2, 0.5)
                box = np.round(np.clip([x1, y1, x2, y2], 0.0, 1.0), 3)
                for label in sorted(rng.choice(CLASSES, int(rng.integers(1, 4)), replace=False) + 1):
                    gt_rows.append(f"{name},{sec},{box[0]:.3f},{box[1]:.3f},{box[2]:.3f},{box[3]:.3f},{label},{person}")
                jit = np.round(np.clip(box + rng.normal(0, 0.02, 4), 0.0, 1.0), 3)
                pred_rows.append(f"{name},{sec},{jit[0]:.3f},{jit[1]:.3f},{jit[2]:.3f},{jit[3]:.3f},,"
                                 f"{rng.uniform(0.85, 0.99):.6f}")
            low = np.round(rng.uniform(0.1, 0.4, 4), 3)
            pred_rows.append(f"{name},{sec},{low[0]:.3f},{low[1]:.3f},{low[2] + 0.5:.3f},{low[3] + 0.5:.3f},,"
                             f"{rng.uniform(0.2, 0.7):.6f}")
    (ann_dir / "ava_train_v2.2.csv").write_text("\n".join(gt_rows) + "\n")
    (ann_dir / "ava_val_v2.2.csv").write_text("\n".join(gt_rows) + "\n")
    (ann_dir / "ava_val_predicted_boxes.csv").write_text("\n".join(pred_rows) + "\n")
    (ann_dir / "ava_train_predicted_boxes.csv").write_text("\n".join(pred_rows) + "\n")
    (ann_dir / "labels.pbtxt").write_text(
        "".join(f'item {{\n  name: "act{i}"\n  id: {i}\n}}\n' for i in EVALUATED))
    (ann_dir / "exclusions.csv").write_text(f"{EXCLUDED[0]},{EXCLUDED[1]:04d}\n")
    return frame_dir, list_dir, ann_dir


def ava_data_opts(root: pathlib.Path) -> list:
    """The AVA keys for a tree written by ``write_ava_tree`` under ``root``."""
    return ["AVA.FRAME_DIR", str(root / "frames"), "AVA.FRAME_LIST_DIR", str(root / "frame_lists"),
            "AVA.ANNOTATION_DIR", str(root / "annotations"), "AVA.LABEL_MAP_FILE", "labels.pbtxt",
            "AVA.GROUNDTRUTH_FILE", "ava_val_v2.2.csv", "AVA.EXCLUSION_FILE", "exclusions.csv",
            "AVA.DETECTION_SCORE_THRESH", str(THRESH), "TRAIN.DATASET", "ava", "TEST.DATASET", "ava",
            "DATA.SAMPLING_RATE", "2", "DATA.TRAIN_JITTER_SCALES", "[32, 40]", "DATA_LOADER.NUM_WORKERS", "1"]


# PySlowFast's AVA SlowFast shape at a tiny width: s5 at 1/16 (stride 1,
# dilation 2), the ROI head at SPATIAL_SCALE_FACTOR 16
DETECTION = ["DETECTION.ENABLE", "True", "DETECTION.SPATIAL_SCALE_FACTOR", "16",
             "DETECTION.ROI_XFORM_RESOLUTION", "7", "MODEL.HEAD_ACT", "sigmoid", "MODEL.NUM_CLASSES", str(CLASSES),
             "MODEL.LOSS_FUNC", "bce_logit"]
AVA_STRIDES = ("RESNET.SPATIAL_STRIDES", "[[1, 1], [2, 2], [2, 2], [1, 1]]",
               "RESNET.SPATIAL_DILATIONS", "[[1, 1], [1, 1], [1, 1], [2, 2]]")
ONE_PATH_STRIDES = ("RESNET.SPATIAL_STRIDES", "[[1], [2], [2], [1]]",
                    "RESNET.SPATIAL_DILATIONS", "[[1], [1], [1], [2]]")


def conv_opts(family: str, arch: str, *extra) -> list:
    """A tiny SlowFast or ResNet (``tiny_opts``) in AVA's shape with the ROI head."""
    strides = AVA_STRIDES if arch == "slowfast" else ONE_PATH_STRIDES
    return tiny_opts(family, arch) + list(strides) + DETECTION + list(extra)


# tests/test_ava.py's tiny MViT with abs positions (which resize to a
# clip that is not square), the ROI head at 1/8
MVIT_OPTS = ["MODEL.MODEL_NAME", "MViT", "MODEL.ARCH", "mvit", "DATA.INPUT_CHANNEL_NUM", "[3]",
             "MVIT.EMBED_DIM", "16", "MVIT.NUM_HEADS", "2", "MVIT.DEPTH", "2", "MVIT.PATCH_KERNEL", "[3, 7, 7]",
             "MVIT.PATCH_STRIDE", "[2, 4, 4]", "MVIT.PATCH_PADDING", "[1, 3, 3]",
             "MVIT.POOL_Q_STRIDE", "[[1, 1, 2, 2]]", "MVIT.POOL_KVQ_KERNEL", "[3, 3, 3]",
             "MVIT.DROPPATH_RATE", "0.0", "MODEL.DROPOUT_RATE", "0.0", "DATA.NUM_FRAMES", "8",
             "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32", "TPU.COMPUTE_DTYPE", "float32",
             ] + DETECTION + ["DETECTION.SPATIAL_SCALE_FACTOR", "8"]


def boxes_for(batch: int, n: int, h: int, w: int, seed: int) -> np.ndarray:
    """[n, 5] boxes (batch index, x1, y1, x2, y2) in pixels of an h x w clip,
    some past the edges, every batch row used."""
    rng = np.random.default_rng(seed)
    idx = np.arange(n) % batch
    x1 = rng.uniform(-4, w - 4, n)
    y1 = rng.uniform(-4, h - 4, n)
    x2 = x1 + rng.uniform(1, w / 2 + 6, n)
    y2 = y1 + rng.uniform(1, h / 2 + 6, n)
    return np.stack([idx, x1, y1, x2, y2], axis=1).astype(np.float32)
