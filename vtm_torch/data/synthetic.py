"""Synthetic video dataset for smoke tests and benchmarks (copy of
``vtm/data/synthetic.py``): deterministic random clips, no files."""

from __future__ import annotations

import numpy as np

from vtm_torch.data.loader import register_dataset


@register_dataset("synthetic")
class Synthetic:
    """Deterministic random clips: labels derived from the seed so eval
    metrics are reproducible."""

    def __init__(self, cfg, mode: str):
        self.cfg = cfg
        self.mode = mode
        if mode in ("train", "val"):
            self._num_clips = 1
            self._num_videos = 16
        else:
            self._num_clips = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
            self._num_videos = max(4, cfg.TEST.BATCH_SIZE)
        self.num_classes = (
            cfg.MODEL.NUM_CLASSES
            if cfg.EPICKITCHENS.NUM_CLASSES is None
            else tuple(cfg.EPICKITCHENS.NUM_CLASSES)
        )

    @property
    def _labels(self):
        """Per-item labels (used by the clip-splicing wrappers)."""
        n = self.num_classes[0] if isinstance(self.num_classes, (tuple, list)) else self.num_classes
        return [(i // self._num_clips) % n for i in range(len(self))]

    @property
    def _verb_labels(self):
        return self._labels

    @property
    def _noun_labels(self):
        n = self.num_classes[1] if isinstance(self.num_classes, (tuple, list)) else self.num_classes
        return [(i // self._num_clips) % n for i in range(len(self))]

    def __len__(self):
        return self._num_videos * self._num_clips

    def __getitem__(self, index) -> dict:
        short_cycle_idx = None
        if isinstance(index, tuple):  # short-cycle (index, cycle_idx)
            index, short_cycle_idx = index
        cfg = self.cfg
        vid = index // self._num_clips
        rng = np.random.default_rng(vid)
        size = cfg.DATA.TEST_CROP_SIZE if self.mode == "test" else cfg.DATA.TRAIN_CROP_SIZE
        if short_cycle_idx in (0, 1):
            size = int(
                round(
                    cfg.MULTIGRID.SHORT_CYCLE_FACTORS[short_cycle_idx]
                    * cfg.MULTIGRID.DEFAULT_S
                )
            )
        frames = rng.standard_normal(
            (cfg.DATA.NUM_FRAMES, size, size, 3)
        ).astype(np.float32)
        if isinstance(self.num_classes, (tuple, list)):
            label = {
                "verb": vid % self.num_classes[0],
                "noun": vid % self.num_classes[1],
            }
            return {
                "frames": frames,
                "label": label,
                "index": index,
                "metadata": {"narration_id": f"synthetic_{vid}"},
            }
        item = {"frames": frames, "label": vid % self.num_classes, "index": index}
        n_ssl = (
            cfg.DATA.TRAIN_CROP_NUM_TEMPORAL * cfg.DATA.TRAIN_CROP_NUM_SPATIAL
        )
        if self.mode == "train" and n_ssl > 1:
            # SSL multi-view: n independent random clips of the video
            item["clips"] = np.stack(
                [frames]
                + [
                    rng.standard_normal(frames.shape).astype(np.float32)
                    for _ in range(n_ssl - 1)
                ]
            )
        if cfg.AUG.GEN_MASK_LOADER:
            raise NotImplementedError("AUG.GEN_MASK_LOADER: the masked family is not ported yet")
        return item
