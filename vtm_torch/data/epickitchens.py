"""EPIC-KITCHENS-100 dataset (copy of ``vtm/data/epickitchens.py``;
reference: slowfast/datasets/epickitchens.py
+ epickitchens_record.py + frame_loader.py).

Annotations come as pandas pickles of narration records; timestamps map
to frame ranges at the video's native 50/60 fps
(epickitchens_record.py:18-55); RGB JPEG frames are packed to clips via
the EPIC variant of temporal sampling (frame_loader.py:31-71). Labels
are (verb, noun) pairs; metadata carries the narration id.
"""

from __future__ import annotations

import os
import time
from datetime import timedelta

import numpy as np

from vtm_torch.data import transform
from vtm_torch.data.decoder import get_start_end_idx
from vtm_torch.data.loader import register_dataset
from vtm_torch.data.ssv2 import retry_load_images
from vtm_torch.utils.logging import get_logger

logger = get_logger(__name__)


def timestamp_to_sec(timestamp: str) -> float:
    """(reference epickitchens_record.py:9-15)"""
    x = time.strptime(timestamp, "%H:%M:%S.%f")
    sec = float(
        timedelta(hours=x.tm_hour, minutes=x.tm_min, seconds=x.tm_sec).total_seconds()
    ) + float(timestamp.split(".")[-1]) / 100
    return sec


class EpicKitchensVideoRecord:
    """(reference epickitchens_record.py:18-55)"""

    def __init__(self, tup):
        self._index = str(tup[0])
        self._series = tup[1]

    @property
    def participant(self):
        return self._series["participant_id"]

    @property
    def untrimmed_video_name(self):
        return self._series["video_id"]

    @property
    def fps(self) -> int:
        is_100 = len(self.untrimmed_video_name.split("_")[1]) == 3
        return 50 if is_100 else 60

    @property
    def start_frame(self) -> int:
        return int(round(timestamp_to_sec(self._series["start_timestamp"]) * self.fps))

    @property
    def end_frame(self) -> int:
        return int(round(timestamp_to_sec(self._series["stop_timestamp"]) * self.fps))

    @property
    def num_frames(self) -> int:
        return self.end_frame - self.start_frame

    @property
    def label(self):
        return {
            "verb": self._series["verb_class"] if "verb_class" in self._series else -1,
            "noun": self._series["noun_class"] if "noun_class" in self._series else -1,
        }

    @property
    def metadata(self):
        return {"narration_id": self._index}


def temporal_sampling_epic(num_frames, start_idx, end_idx, num_samples, start_frame=0):
    """EPIC indexing variant: absolute frame numbers offset by the
    segment start (reference frame_loader.py temporal_sampling)."""
    index = np.linspace(start_idx, end_idx, num_samples)
    index = np.clip(index, 0, num_frames - 1).astype(np.int64) + start_frame
    return index


def pack_frames_to_video_clip(cfg, video_record, temporal_sample_index, target_fps=60):
    """(reference frame_loader.py:31-71)"""
    if cfg.EPICKITCHENS.PARTICIPANT_FIRST:
        path_to_video = os.path.join(
            cfg.EPICKITCHENS.VISUAL_DATA_DIR,
            video_record.participant,
            "rgb_frames",
            video_record.untrimmed_video_name,
        )
    else:
        path_to_video = os.path.join(
            cfg.EPICKITCHENS.VISUAL_DATA_DIR,
            "rgb",
            video_record.participant,
            video_record.untrimmed_video_name,
        )
    img_tmpl = "frame_{:010d}.jpg"
    fps = video_record.fps
    start_idx, end_idx, _ = get_start_end_idx(
        video_record.num_frames,
        cfg.DATA.NUM_FRAMES * cfg.DATA.SAMPLING_RATE * fps / target_fps,
        temporal_sample_index,
        cfg.TEST.NUM_ENSEMBLE_VIEWS,
    )
    start_idx, end_idx = start_idx + 1, end_idx + 1
    frame_idx = temporal_sampling_epic(
        video_record.num_frames,
        start_idx,
        end_idx,
        cfg.DATA.NUM_FRAMES,
        start_frame=video_record.start_frame,
    )
    img_paths = [
        os.path.join(path_to_video, img_tmpl.format(int(idx))) for idx in frame_idx
    ]
    return retry_load_images(img_paths)


@register_dataset("epickitchens")
class Epickitchens:
    def __init__(self, cfg, mode: str):
        assert mode in ("train", "val", "test")
        self.cfg = cfg
        self.mode = mode
        if mode in ("train", "val"):
            self._num_clips = 1
        else:
            self._num_clips = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        self._construct_loader()

    def _annotation_files(self):
        cfg = self.cfg
        if self.mode == "train":
            names = (
                [cfg.EPICKITCHENS.TRAIN_LIST, cfg.EPICKITCHENS.VAL_LIST]
                if cfg.EPICKITCHENS.TRAIN_PLUS_VAL
                else [cfg.EPICKITCHENS.TRAIN_LIST]
            )
        elif self.mode == "val":
            names = [cfg.EPICKITCHENS.VAL_LIST]
        else:
            names = [cfg.EPICKITCHENS.TEST_LIST]
        return [os.path.join(cfg.EPICKITCHENS.ANNOTATIONS_DIR, f) for f in names]

    def _construct_loader(self):
        import pandas as pd

        self._video_records = []
        self._spatial_temporal_idx = []
        for file in self._annotation_files():
            for tup in pd.read_pickle(file).iterrows():
                for idx in range(self._num_clips):
                    self._video_records.append(EpicKitchensVideoRecord(tup))
                    self._spatial_temporal_idx.append(idx)
        assert self._video_records, "no EPIC-KITCHENS annotations found"
        logger.info("EPIC-KITCHENS %s: %d clips", self.mode, len(self._video_records))

    @property
    def _verb_labels(self):
        """Per-clip verb ids (reference epickitchens.py:83-91 builds the
        same lists; the splicing analysis datasets index them)."""
        return [r.label["verb"] for r in self._video_records]

    @property
    def _noun_labels(self):
        return [r.label["noun"] for r in self._video_records]

    def __len__(self):
        return len(self._video_records)

    def __getitem__(self, index: int) -> dict:
        cfg = self.cfg
        record = self._video_records[index]
        if self.mode in ("train", "val"):
            temporal_sample_index = -1
            spatial_sample_index = -1
            min_scale, max_scale = cfg.DATA.TRAIN_JITTER_SCALES
            crop_size = cfg.DATA.TRAIN_CROP_SIZE
        else:
            temporal_sample_index = (
                self._spatial_temporal_idx[index] // cfg.TEST.NUM_SPATIAL_CROPS
            )
            spatial_sample_index = (
                self._spatial_temporal_idx[index] % cfg.TEST.NUM_SPATIAL_CROPS
                if cfg.TEST.NUM_SPATIAL_CROPS > 1
                else 1
            )
            min_scale, max_scale = [cfg.DATA.TEST_CROP_SIZE] * 2
            crop_size = cfg.DATA.TEST_CROP_SIZE

        frames = pack_frames_to_video_clip(cfg, record, temporal_sample_index)
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
            "label": record.label,
            "index": index,
            "metadata": record.metadata,
        }
