"""AVA spatio-temporal action detection dataset (copy of ``vtm/data/ava.py``).

Functional parity targets:
  slowfast/datasets/ava_helper.py (load_image_lists:16-66,
  load_boxes_and_labels:69-114, get_keyframe_data:117-160,
  parse_bboxes_file:182-237)
  slowfast/datasets/ava_dataset.py (Ava:18-436, cv2 backend)
  slowfast/datasets/utils.py:get_sequence (58-78)

Clips are centred on annotated keyframes (seconds 902-1798 at 30 fps);
boxes ride through the geometric transforms (the box variants of
vtm_torch/data/transform.py). Items carry variable box counts; the
loader's detection collate (``data/loader.py``) concatenates them with a
batch-index column (reference loader.detection_collate). Every file is
opened through ``utils/pathmgr.py``; frames are read with cv2
(``ssv2.retry_load_images``). The val split keeps the keyframes of every
fourth second (``boxes_sample_rate`` 4) unless ``AVA.FULL_TEST_ON_VAL``:
``AVAMeter``'s val ground truth is the same subset.
"""

from __future__ import annotations

import os
from collections import defaultdict

import numpy as np

from vtm_torch.data import transform
from vtm_torch.data.imagenet import lighting_jitter
from vtm_torch.data.loader import register_dataset
from vtm_torch.data.ssv2 import retry_load_images
from vtm_torch.utils.logging import get_logger
from vtm_torch.utils.pathmgr import pathmgr

logger = get_logger(__name__)

FPS = 30
AVA_VALID_FRAMES = range(902, 1799)


def load_image_lists(cfg, is_train: bool):
    """Reference ava_helper.py:16-66."""
    list_filenames = [
        os.path.join(cfg.AVA.FRAME_LIST_DIR, filename)
        for filename in (cfg.AVA.TRAIN_LISTS if is_train else cfg.AVA.TEST_LISTS)
    ]
    image_paths = defaultdict(list)
    video_name_to_idx = {}
    video_idx_to_name = []
    for list_filename in list_filenames:
        with pathmgr.open(list_filename, "r") as f:
            f.readline()
            for line in f:
                row = line.split()
                assert len(row) == 5
                video_name = row[0]
                if video_name not in video_name_to_idx:
                    video_name_to_idx[video_name] = len(video_name_to_idx)
                    video_idx_to_name.append(video_name)
                image_paths[video_name_to_idx[video_name]].append(
                    os.path.join(cfg.AVA.FRAME_DIR, row[3])
                )
    image_paths = [image_paths[i] for i in range(len(image_paths))]
    logger.info("Finished loading image paths from: %s", ", ".join(list_filenames))
    return image_paths, video_idx_to_name


def parse_bboxes_file(ann_filenames, ann_is_gt_box, detect_thresh,
                      boxes_sample_rate: int = 1):
    """Reference ava_helper.py:182-237."""
    all_boxes = {}
    count = 0
    unique_box_count = 0
    for filename, is_gt_box in zip(ann_filenames, ann_is_gt_box):
        with pathmgr.open(filename, "r") as f:
            for line in f:
                row = line.strip().split(",")
                if not is_gt_box:
                    if float(row[7]) < detect_thresh:
                        continue
                video_name, frame_sec = row[0], int(row[1])
                if frame_sec % boxes_sample_rate != 0:
                    continue
                box_key = ",".join(row[2:6])
                box = list(map(float, row[2:6]))
                label = -1 if row[6] == "" else int(row[6])
                if video_name not in all_boxes:
                    all_boxes[video_name] = {
                        sec: {} for sec in AVA_VALID_FRAMES
                    }
                if box_key not in all_boxes[video_name][frame_sec]:
                    all_boxes[video_name][frame_sec][box_key] = [box, []]
                    unique_box_count += 1
                all_boxes[video_name][frame_sec][box_key][1].append(label)
                if label != -1:
                    count += 1
    for video_name in all_boxes:
        for frame_sec in all_boxes[video_name]:
            all_boxes[video_name][frame_sec] = list(
                all_boxes[video_name][frame_sec].values()
            )
    return all_boxes, count, unique_box_count


def load_boxes_and_labels(cfg, mode: str):
    """Reference ava_helper.py:69-114."""
    gt_lists = cfg.AVA.TRAIN_GT_BOX_LISTS if mode == "train" else []
    pred_lists = (
        cfg.AVA.TRAIN_PREDICT_BOX_LISTS
        if mode == "train"
        else cfg.AVA.TEST_PREDICT_BOX_LISTS
    )
    ann_filenames = [
        os.path.join(cfg.AVA.ANNOTATION_DIR, f) for f in gt_lists + pred_lists
    ]
    ann_is_gt_box = [True] * len(gt_lists) + [False] * len(pred_lists)
    boxes_sample_rate = 4 if mode == "val" and not cfg.AVA.FULL_TEST_ON_VAL else 1
    all_boxes, count, unique_box_count = parse_bboxes_file(
        ann_filenames, ann_is_gt_box, cfg.AVA.DETECTION_SCORE_THRESH,
        boxes_sample_rate,
    )
    logger.info("Finished loading annotations from: %s", ", ".join(ann_filenames))
    logger.info("Number of unique boxes: %d, annotations: %d", unique_box_count, count)
    return all_boxes


def sec_to_frame(sec: int) -> int:
    return (sec - 900) * FPS


def get_keyframe_data(boxes_and_labels):
    """Reference ava_helper.py:117-160."""
    keyframe_indices = []
    keyframe_boxes_and_labels = []
    count = 0
    for video_idx in range(len(boxes_and_labels)):
        sec_idx = 0
        keyframe_boxes_and_labels.append([])
        for sec in boxes_and_labels[video_idx].keys():
            if sec not in AVA_VALID_FRAMES:
                continue
            if len(boxes_and_labels[video_idx][sec]) > 0:
                keyframe_indices.append((video_idx, sec_idx, sec, sec_to_frame(sec)))
                keyframe_boxes_and_labels[video_idx].append(
                    boxes_and_labels[video_idx][sec]
                )
                sec_idx += 1
                count += 1
    logger.info("%d keyframes used.", count)
    return keyframe_indices, keyframe_boxes_and_labels


def get_sequence(center_idx, half_len, sample_rate, num_frames):
    """Reference datasets/utils.py:58-78."""
    seq = list(range(center_idx - half_len, center_idx + half_len, sample_rate))
    return [max(0, min(idx, num_frames - 1)) for idx in seq]


@register_dataset("ava")
class Ava:
    def __init__(self, cfg, split: str):
        self.cfg = cfg
        self._split = split
        self._sample_rate = cfg.DATA.SAMPLING_RATE
        self._video_length = cfg.DATA.NUM_FRAMES
        self._seq_len = self._video_length * self._sample_rate
        self._num_classes = cfg.MODEL.NUM_CLASSES
        self._use_bgr = cfg.AVA.BGR
        self.random_horizontal_flip = cfg.DATA.RANDOM_FLIP
        if split == "train":
            self._crop_size = cfg.DATA.TRAIN_CROP_SIZE
            self._jitter_min_scale = cfg.DATA.TRAIN_JITTER_SCALES[0]
            self._jitter_max_scale = cfg.DATA.TRAIN_JITTER_SCALES[1]
            self._use_color_augmentation = cfg.AVA.TRAIN_USE_COLOR_AUGMENTATION
            self._pca_jitter_only = cfg.AVA.TRAIN_PCA_JITTER_ONLY
        else:
            self._crop_size = cfg.DATA.TEST_CROP_SIZE
            self._test_force_flip = cfg.AVA.TEST_FORCE_FLIP
        self._load_data(cfg)

    def _load_data(self, cfg):
        self._image_paths, self._video_idx_to_name = load_image_lists(
            cfg, is_train=(self._split == "train")
        )
        boxes_and_labels = load_boxes_and_labels(cfg, mode=self._split)
        assert len(boxes_and_labels) == len(self._image_paths)
        boxes_and_labels = [
            boxes_and_labels[self._video_idx_to_name[i]]
            for i in range(len(self._image_paths))
        ]
        (
            self._keyframe_indices,
            self._keyframe_boxes_and_labels,
        ) = get_keyframe_data(boxes_and_labels)
        logger.info(
            "AVA %s: %d videos, %d keyframes",
            self._split, len(self._image_paths), len(self._keyframe_indices),
        )

    def __len__(self) -> int:
        return len(self._keyframe_indices)

    @property
    def num_videos(self) -> int:
        return len(self._keyframe_indices)

    def _preprocess(self, frames: np.ndarray, boxes: np.ndarray):
        """cv2-style preprocessing on [T, H, W, C] RGB uint8 frames
        (reference _images_and_boxes_preprocessing_cv2:113-243)."""
        cfg = self.cfg
        t, height, width, _ = frames.shape
        boxes = boxes.copy()
        boxes[:, [0, 2]] *= width
        boxes[:, [1, 3]] *= height
        boxes = transform.clip_boxes_to_image(boxes, height, width)
        frames = frames.astype(np.float32)

        if self._split == "train":
            frames, boxes = transform.random_short_side_scale_jitter_with_boxes(
                frames, self._jitter_min_scale, self._jitter_max_scale, boxes
            )
            frames, boxes = transform.random_crop_with_boxes(
                frames, self._crop_size, boxes
            )
            if self.random_horizontal_flip:
                frames, boxes = transform.horizontal_flip_with_boxes(
                    0.5, frames, boxes
                )
        else:
            frames, boxes = transform.short_side_scale_with_boxes(
                frames, self._crop_size, boxes
            )
            if self._split == "val":
                frames, boxes = transform.uniform_crop_with_boxes(
                    frames, self._crop_size, 1, boxes
                )
            if self._test_force_flip:
                frames, boxes = transform.horizontal_flip_with_boxes(
                    1.0, frames, boxes
                )

        frames = frames / 255.0
        if self._split == "train" and self._use_color_augmentation:
            if not self._pca_jitter_only:
                frames = transform.color_jitter(frames, 0.4, 0.4, 0.4)
            frames = np.stack(
                [
                    lighting_jitter(
                        f, 0.1, cfg.DATA.TRAIN_PCA_EIGVAL, cfg.DATA.TRAIN_PCA_EIGVEC
                    )
                    for f in frames
                ]
            )
        frames = (
            frames - np.asarray(cfg.DATA.MEAN, np.float32)
        ) / np.asarray(cfg.DATA.STD, np.float32)
        if self._use_bgr:
            frames = frames[..., ::-1]
        boxes = transform.clip_boxes_to_image(
            boxes, frames.shape[1], frames.shape[2]
        )
        return np.ascontiguousarray(frames), boxes

    def __getitem__(self, idx) -> dict:
        if isinstance(idx, tuple):
            idx = idx[0]
        video_idx, sec_idx, sec, center_idx = self._keyframe_indices[idx]
        seq = get_sequence(
            center_idx, self._seq_len // 2, self._sample_rate,
            num_frames=len(self._image_paths[video_idx]),
        )
        clip_label_list = self._keyframe_boxes_and_labels[video_idx][sec_idx]
        assert len(clip_label_list) > 0
        boxes = np.array([bl[0] for bl in clip_label_list])[:, :4].copy()
        labels = [bl[1] for bl in clip_label_list]
        ori_boxes = boxes.copy()

        frames = retry_load_images(
            [self._image_paths[video_idx][f] for f in seq]
        )
        frames, boxes = self._preprocess(frames, boxes)

        label_arrs = np.zeros((len(labels), self._num_classes), dtype=np.int32)
        for i, box_labels in enumerate(labels):
            for label in box_labels:  # AVA labels are 1-indexed
                if label == -1:
                    continue
                assert 1 <= label <= 80
                label_arrs[i][label - 1] = 1

        return {
            "frames": frames,
            "label": label_arrs,
            "index": idx,
            "boxes": boxes.astype(np.float32),
            "ori_boxes": ori_boxes.astype(np.float32),
            "metadata": np.array(
                [[video_idx, sec]] * len(boxes), dtype=np.int64
            ),
        }
