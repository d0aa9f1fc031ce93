"""Charades multi-label video dataset (copy of ``vtm/data/charades.py``,
with ``os.path.exists`` for ``vtm``'s ``pathmgr``).

Functional parity target: slowfast/datasets/charades.py (frame-list
loading :74-113, get_seq_frames :115-152, clip assembly :154-248) and
the label helpers of slowfast/datasets/utils.py (aggregate_labels
:207-219, convert_to_video_level_labels :222-235, as_binary_vector).

Frames are JPEG lists (same csv format as SSv2); labels are per-frame
multi-label sets aggregated over the sampled window into a binary
vector. Output: channels-last [T, H, W, C] float frames.
"""

from __future__ import annotations

import os
import random

import numpy as np

from vtm_torch.data import transform
from vtm_torch.data.loader import register_dataset
from vtm_torch.data.ssv2 import load_image_lists, retry_load_images
from vtm_torch.utils.logging import get_logger

logger = get_logger(__name__)


def aggregate_labels(label_list):
    """Union of the per-frame label lists (utils.py:207-219). Matches
    the reference's list(set(...)) up to ordering; we sort for
    determinism (the binary vector is order-invariant)."""
    all_labels = set()
    for labels in label_list:
        all_labels.update(labels)
    return sorted(all_labels)


def convert_to_video_level_labels(labels):
    """Every frame gets its video's aggregated label set
    (utils.py:222-235)."""
    out = []
    for video_labels in labels:
        video_level = aggregate_labels(video_labels)
        out.append([list(video_level) for _ in video_labels])
    return out


def as_binary_vector(labels, num_classes: int) -> np.ndarray:
    vec = np.zeros(num_classes, dtype=np.float32)
    vec[[int(l) for l in labels]] = 1.0
    return vec


@register_dataset("charades")
class Charades:
    """Multi-label video loader over frame lists."""

    def __init__(self, cfg, mode: str, num_retries: int = 10):
        assert mode in ("train", "val", "test")
        self.cfg = cfg
        self.mode = mode
        self._num_retries = num_retries
        self._num_clips = (
            1
            if mode in ("train", "val")
            else cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        )
        path_to_file = (
            f"{cfg.DATA.PATH_TO_DATA_DIR.rstrip('/')}/"
            f"{'train' if mode == 'train' else 'val'}.csv"
        )
        assert os.path.exists(path_to_file), f"{path_to_file} not found"
        _, self._path_to_videos, self._labels = load_image_lists(
            path_to_file, cfg.DATA.PATH_PREFIX
        )
        if mode != "train":
            self._labels = convert_to_video_level_labels(self._labels)
        # replicate per clip view (reference charades.py:95-106)
        self._path_to_videos = [
            x for x in self._path_to_videos for _ in range(self._num_clips)
        ]
        self._labels = [x for x in self._labels for _ in range(self._num_clips)]
        self._spatial_temporal_idx = [
            i
            for _ in range(len(self._labels) // self._num_clips)
            for i in range(self._num_clips)
        ]
        logger.info(
            "Charades dataloader constructed (size: %d) from %s",
            len(self._path_to_videos),
            path_to_file,
        )

    def get_seq_frames(self, index: int):
        """Reference charades.py:115-152."""
        cfg = self.cfg
        temporal_sample_index = (
            -1
            if self.mode in ("train", "val")
            else self._spatial_temporal_idx[index] // cfg.TEST.NUM_SPATIAL_CROPS
        )
        num_frames = cfg.DATA.NUM_FRAMES
        sampling_rate = cfg.DATA.SAMPLING_RATE
        if cfg.MULTIGRID.LONG_CYCLE_SAMPLING_RATE > 0:
            sampling_rate = random.randint(
                cfg.DATA.SAMPLING_RATE, cfg.MULTIGRID.LONG_CYCLE_SAMPLING_RATE
            )
        video_length = len(self._path_to_videos[index])

        clip_length = (num_frames - 1) * sampling_rate + 1
        if temporal_sample_index == -1:
            if clip_length > video_length:
                start = random.randint(video_length - clip_length, 0)
            else:
                start = random.randint(0, video_length - clip_length)
        else:
            gap = float(max(video_length - clip_length, 0)) / (
                cfg.TEST.NUM_ENSEMBLE_VIEWS - 1
            )
            start = int(round(gap * temporal_sample_index))
        return [
            max(min(start + i * sampling_rate, video_length - 1), 0)
            for i in range(num_frames)
        ]

    def __getitem__(self, index) -> dict:
        cfg = self.cfg
        short_cycle_idx = None
        if isinstance(index, tuple):
            index, short_cycle_idx = index
        if self.mode in ("train", "val"):
            spatial_sample_index = -1
            min_scale, max_scale = cfg.DATA.TRAIN_JITTER_SCALES
            crop_size = cfg.DATA.TRAIN_CROP_SIZE
            if short_cycle_idx in (0, 1):
                crop_size = int(
                    round(
                        cfg.MULTIGRID.SHORT_CYCLE_FACTORS[short_cycle_idx]
                        * cfg.MULTIGRID.DEFAULT_S
                    )
                )
            if cfg.MULTIGRID.DEFAULT_S > 0:
                min_scale = int(
                    round(float(min_scale) * crop_size / cfg.MULTIGRID.DEFAULT_S)
                )
        else:
            spatial_sample_index = (
                self._spatial_temporal_idx[index] % cfg.TEST.NUM_SPATIAL_CROPS
            )
            min_scale = max_scale = crop_size = cfg.DATA.TEST_CROP_SIZE

        seq = self.get_seq_frames(index)
        frames = retry_load_images(
            [self._path_to_videos[index][f] for f in seq], self._num_retries
        ).astype(np.float32)

        label = aggregate_labels(
            [self._labels[index][i] for i in range(seq[0], seq[-1] + 1)]
        )
        label = as_binary_vector(label, cfg.MODEL.NUM_CLASSES)

        frames = transform.tensor_normalize(frames, cfg.DATA.MEAN, cfg.DATA.STD)
        frames = transform.spatial_sampling(
            frames,
            spatial_idx=spatial_sample_index,
            min_scale=min_scale,
            max_scale=max_scale,
            crop_size=crop_size,
            random_horizontal_flip=cfg.DATA.RANDOM_FLIP,
            inverse_uniform_sampling=cfg.DATA.INV_UNIFORM_SAMPLE,
        )
        return {"frames": frames, "label": label, "index": index}

    def __len__(self) -> int:
        return len(self._path_to_videos)

    @property
    def num_videos(self) -> int:
        return len(self._path_to_videos)
