"""AVA demo with precomputed person boxes, in the PyTorch package (port of
``tools/ava_demo_precomputed_boxes.py``).

Functional parity target:
slowfast/visualization/ava_demo_precomputed_boxes.py
(merge_pred_gt_boxes:23-48, load_boxes_labels:51-128; the fork strips
the upstream driver class, so the rendering loop restores the upstream
flow: per-keyframe clip extraction around each box second, detection
forward through the ROI head, annotated video via VideoVisualizer).

    python -m vtm_torch.tools.ava_demo_precomputed_boxes --cfg <ava_cfg>.yaml \
        --opts DEMO.INPUT_VIDEO in.mp4 DEMO.PREDS_BOXES boxes.csv DEMO.OUTPUT_FILE out.mp4

The model is the config's detection model (``DETECTION.ENABLE`` on
SlowFast, ResNet or MViT) with ``load_test_checkpoint``'s weights, run
through ``make_detection_eval_step``. Returns the written video's path.

Runs on the first CUDA device; a machine without one raises. The CPU
(``device="cpu"``) is for tests only.
"""

from __future__ import annotations

import pathlib
from typing import Optional

import numpy as np
import torch

from vtm_torch.config import assert_and_infer_cfg, load_config, parse_args
from vtm_torch.data.ava import parse_bboxes_file
from vtm_torch.parallel.mesh import entry_device
from vtm_torch.utils.logging import get_logger, setup_logging

logger = get_logger(__name__)


def merge_pred_gt_boxes(pred_dict, gt_dict=None):
    """Reference ava_demo_precomputed_boxes.py:23-48: {frame_idx:
    [[is_gt, boxes, labels], ...]}."""
    merged_dict = {}
    for key, item in pred_dict.items():
        merged_dict[key] = [[False, item[0], item[1]]]
    if gt_dict is not None:
        for key, item in gt_dict.items():
            if merged_dict.get(key) is None:
                merged_dict[key] = [[True, item[0], item[1]]]
            else:
                merged_dict[key].append([True, item[0], item[1]])
    return merged_dict


def load_boxes_labels(cfg, video_name, fps, img_width, img_height):
    """Reference ava_demo_precomputed_boxes.py:51-128: parse the AVA
    csv(s), shift labels to 0-based, scale normalised coords to pixels,
    and key by frame index relative to DEMO.STARTING_SECOND."""
    starting_second = cfg.DEMO.STARTING_SECOND

    def sec_to_frameidx(sec):
        return (sec - starting_second) * fps

    def process_bboxes_dict(dictionary):
        new_dict = {}
        for keyframe_sec, boxes_and_labels in dictionary.items():
            if len(boxes_and_labels) == 0:
                continue
            keyframe_idx = sec_to_frameidx(keyframe_sec)
            boxes, labels = list(zip(*boxes_and_labels))
            labels = [[i - 1 for i in box_label] for box_label in labels]
            boxes = np.array(boxes)
            boxes[:, [0, 2]] *= img_width
            boxes[:, [1, 3]] *= img_height
            new_dict[keyframe_idx] = [boxes.tolist(), list(labels)]
        return new_dict

    preds_boxes, _, _ = parse_bboxes_file(
        ann_filenames=[cfg.DEMO.PREDS_BOXES],
        ann_is_gt_box=[False],
        detect_thresh=cfg.AVA.DETECTION_SCORE_THRESH,
        boxes_sample_rate=1,
    )
    preds_boxes = preds_boxes[video_name]
    if cfg.DEMO.GT_BOXES == "":
        gt_boxes = None
    else:
        gt_boxes, _, _ = parse_bboxes_file(
            ann_filenames=[cfg.DEMO.GT_BOXES],
            ann_is_gt_box=[True],
            detect_thresh=cfg.AVA.DETECTION_SCORE_THRESH,
            boxes_sample_rate=1,
        )
        gt_boxes = gt_boxes[video_name]

    preds_boxes = process_bboxes_dict(preds_boxes)
    if gt_boxes is not None:
        gt_boxes = process_bboxes_dict(gt_boxes)
    return preds_boxes, gt_boxes


def run_demo(cfg, device: Optional[torch.device | str] = None) -> str:
    """Upstream-flow driver: read the video, run the detection model on
    keyframe-centred clips with the precomputed boxes, write the
    annotated video."""
    import cv2

    from vtm_torch.checkpoints.checkpoint import load_test_checkpoint
    from vtm_torch.data import transform
    from vtm_torch.models import build_model
    from vtm_torch.train.train_step import make_detection_eval_step
    from vtm_torch.vis.video_visualizer import VideoVisualizer

    device = entry_device(device, "ava_demo_precomputed_boxes", 1)
    setup_logging(cfg.OUTPUT_DIR)
    path = cfg.DEMO.INPUT_VIDEO
    cap = cv2.VideoCapture(path)
    fps = cfg.DEMO.FPS or int(cap.get(cv2.CAP_PROP_FPS))
    width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    video_name = pathlib.Path(path).stem

    pred_boxes, gt_boxes = load_boxes_labels(cfg, video_name, fps, width, height)
    merged = merge_pred_gt_boxes(pred_boxes, gt_boxes)

    bundle = load_test_checkpoint(cfg, build_model(cfg, device))
    detect = make_detection_eval_step(bundle.module)
    vis = VideoVisualizer(
        num_classes=cfg.MODEL.NUM_CLASSES,
        top_k=cfg.DEMO.VIS_TOPK,
        thres=cfg.DEMO.COMMON_CLASS_THRES,
        mode="thres" if cfg.DEMO.VIS_MODE == "thres" else "top-k",
    )

    seq_len = cfg.DATA.NUM_FRAMES * cfg.DATA.SAMPLING_RATE
    out_frames = list(frames)
    for frame_idx, entries in sorted(merged.items()):
        center = int(frame_idx)
        lo = max(center - seq_len // 2, 0)
        clip = frames[lo: lo + seq_len]
        if len(clip) < seq_len:
            continue
        idx = np.linspace(0, len(clip) - 1, cfg.DATA.NUM_FRAMES).astype(int)
        rgb = np.stack([clip[i][:, :, ::-1] for i in idx]).astype(np.float32)
        rgb = transform.tensor_normalize(rgb / 255.0, cfg.DATA.MEAN, cfg.DATA.STD)
        scale = cfg.DATA.TEST_CROP_SIZE / min(height, width)
        rgb = np.stack([
            cv2.resize(f, (int(width * scale), int(height * scale)), interpolation=cv2.INTER_LINEAR)
            for f in rgb
        ])
        for is_gt, boxes, labels in entries:
            if is_gt:
                continue
            boxes_arr = np.asarray(boxes, np.float32) * scale
            padded = np.concatenate([np.zeros((len(boxes_arr), 1), np.float32), boxes_arr], axis=1)
            preds = detect(torch.as_tensor(rgb[None], device=device),
                           torch.as_tensor(padded, device=device)).float().cpu().numpy()
            draw = vis.draw_clip_range([out_frames[i] for i in range(lo, lo + seq_len)], preds,
                                       bboxes=np.asarray(boxes))
            for j, f in zip(range(lo, lo + seq_len), draw):
                out_frames[j] = f

    out_path = cfg.DEMO.OUTPUT_FILE or str(pathlib.Path(cfg.OUTPUT_DIR) / f"{video_name}_ava_demo.mp4")
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height))
    for f in out_frames:
        writer.write(f)
    writer.release()
    logger.info("AVA demo written to %s", out_path)
    return out_path


def main():
    args = parse_args()
    for path in args.cfg_files or [None]:
        cfg = load_config(args, path)
        assert_and_infer_cfg(cfg)
        run_demo(cfg)


if __name__ == "__main__":
    main()
