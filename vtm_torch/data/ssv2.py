"""Something-Something v2 dataset (copy of ``vtm/data/ssv2.py``, cv2
imported where frames are read; reference: slowfast/datasets/ssv2.py).

Labels from the official jsons (ssv2.py:83-167); per-video JPEG frame
lists from a PySlowFast-style frame csv; segment-based frame sampling —
random within segment at train, segment centre at test
(get_seq_frames, ssv2.py:169-190).
"""

from __future__ import annotations

import json
import os
import random
from collections import defaultdict

import numpy as np

from vtm_torch.data import transform
from vtm_torch.data.loader import register_dataset
from vtm_torch.utils.logging import get_logger

logger = get_logger(__name__)


def load_image_lists(frame_list_file: str, prefix: str = ""):
    """Parse the PySlowFast frame-list csv: header then rows
    ``original_vido_id video_id frame_id path labels``
    (reference datasets/utils.py:238-281)."""
    image_paths = defaultdict(list)
    labels = defaultdict(list)
    with open(frame_list_file) as f:
        header = f.readline()
        assert header.replace('"', "").split()[:4] == [
            "original_vido_id",
            "video_id",
            "frame_id",
            "path",
        ], f"unexpected frame list header: {header!r}"
        for line in f.read().splitlines():
            if not line:
                continue
            row = line.split()
            video_name = row[0]
            path = os.path.join(prefix, row[3])
            image_paths[video_name].append(path)
            frame_labels = row[-1].replace('"', "")
            labels[video_name].append(
                [int(x) for x in frame_labels.split(",")] if frame_labels != "" else []
            )
    keys = list(image_paths.keys())
    return keys, [image_paths[k] for k in keys], [labels[k] for k in keys]


def retry_load_images(paths, retries: int = 10):
    """(reference datasets/utils.py:26-55)"""
    import cv2

    for r in range(retries):
        imgs = []
        ok = True
        for p in paths:
            img = cv2.imread(p)
            if img is None:
                ok = False
                break
            imgs.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
        if ok:
            return np.stack(imgs)
        logger.warning("Reading failed, retry %d", r)
    raise RuntimeError(f"Failed to load images {paths[:3]}...")


@register_dataset("ssv2")
class Ssv2:
    def __init__(self, cfg, mode: str):
        assert mode in ("train", "val", "test")
        self.cfg = cfg
        self.mode = mode
        if mode in ("train", "val"):
            self._num_clips = 1
        else:
            self._num_clips = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        self._construct_loader()

    def _construct_loader(self):
        cfg = self.cfg
        data_dir = cfg.DATA.PATH_TO_DATA_DIR
        with open(
            os.path.join(data_dir, "something-something-v2-labels.json")
        ) as f:
            label_dict = json.load(f)
        split = "train" if self.mode == "train" else "validation"
        with open(
            os.path.join(data_dir, f"something-something-v2-{split}.json")
        ) as f:
            label_json = json.load(f)

        video_names, labels = [], []
        for video in label_json:
            video_names.append(str(video["id"]))
            template = video["template"].replace("[", "").replace("]", "")
            labels.append(int(label_dict[template]))

        split_name = "train" if self.mode == "train" else "val"
        frame_list = os.path.join(data_dir, f"{split_name}.csv")
        keys, image_paths, _ = load_image_lists(frame_list, cfg.DATA.PATH_PREFIX)
        key_to_paths = dict(zip(keys, image_paths))

        self._video_names, self._labels, self._path_to_videos = [], [], []
        self._spatial_temporal_idx = []
        for name, label in zip(video_names, labels):
            if name not in key_to_paths:
                continue
            for idx in range(self._num_clips):
                self._video_names.append(name)
                self._labels.append(label)
                self._path_to_videos.append(key_to_paths[name])
                self._spatial_temporal_idx.append(idx)
        logger.info("SSv2 %s: %d clips", self.mode, len(self._path_to_videos))

    def __len__(self):
        return len(self._path_to_videos)

    def get_seq_frames(self, index: int):
        """(reference ssv2.py:169-190)"""
        num_frames = self.cfg.DATA.NUM_FRAMES
        video_length = len(self._path_to_videos[index])
        seg_size = float(video_length - 1) / num_frames
        seq = []
        for i in range(num_frames):
            start = int(np.round(seg_size * i))
            end = int(np.round(seg_size * (i + 1)))
            if self.mode == "train":
                seq.append(random.randint(start, end))
            else:
                seq.append((start + end) // 2)
        return seq

    def __getitem__(self, index: int) -> dict:
        cfg = self.cfg
        if self.mode in ("train", "val"):
            spatial_sample_index = -1
            min_scale, max_scale = cfg.DATA.TRAIN_JITTER_SCALES
            crop_size = cfg.DATA.TRAIN_CROP_SIZE
        else:
            spatial_sample_index = (
                self._spatial_temporal_idx[index] % cfg.TEST.NUM_SPATIAL_CROPS
                if cfg.TEST.NUM_SPATIAL_CROPS > 1
                else 1
            )
            min_scale, max_scale = [cfg.DATA.TEST_CROP_SIZE] * 2
            crop_size = cfg.DATA.TEST_CROP_SIZE

        seq = self.get_seq_frames(index)
        frames = retry_load_images([self._path_to_videos[index][i] for i in seq])
        frames = transform.train_augment(cfg, frames, self.mode)
        frames = transform.tensor_normalize(frames, cfg.DATA.MEAN, cfg.DATA.STD)
        frames = transform.spatial_sampling(
            frames,
            spatial_idx=spatial_sample_index,
            min_scale=min_scale,
            max_scale=max_scale,
            crop_size=crop_size,
            random_horizontal_flip=cfg.DATA.RANDOM_FLIP,
            inverse_uniform_sampling=cfg.DATA.INV_UNIFORM_SAMPLE,
            **transform.relative_crop_args(cfg, self.mode),
        )
        frames = transform.train_random_erase(cfg, frames, self.mode)
        return {
            "frames": np.ascontiguousarray(frames, dtype=np.float32),
            "label": self._labels[index],
            "index": index,
        }
