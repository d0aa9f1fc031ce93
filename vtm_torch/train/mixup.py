"""MixUp / CutMix batch augmentation (reference:
slowfast/datasets/mixup.py `MixUp`, used in train_net.py:64-72,119-121).

Host-side numpy: the mixed batch + soft targets are produced before
device_put, so the jitted train step always sees dense [B, C] targets
(int labels are one-hot + label-smoothed even when mixing is skipped).
"""

from __future__ import annotations

import numpy as np


def one_hot(labels: np.ndarray, num_classes: int, on: float, off: float) -> np.ndarray:
    out = np.full((len(labels), num_classes), off, dtype=np.float32)
    out[np.arange(len(labels)), labels.astype(int)] = on
    return out


def rand_bbox(h: int, w: int, lam: float, rng) -> tuple:
    """CutMix box with area ratio 1-lam (reference mixup.py rand_bbox)."""
    ratio = np.sqrt(1.0 - lam)
    cut_h, cut_w = int(h * ratio), int(w * ratio)
    cy, cx = int(rng.integers(h)), int(rng.integers(w))
    y1, y2 = np.clip(cy - cut_h // 2, 0, h), np.clip(cy + cut_h // 2, 0, h)
    x1, x2 = np.clip(cx - cut_w // 2, 0, w), np.clip(cx + cut_w // 2, 0, w)
    return y1, y2, x1, x2


class MixUp:
    """Per-batch mixup/cutmix on [B, T, H, W, C] frames."""

    def __init__(
        self,
        mixup_alpha: float = 0.8,
        cutmix_alpha: float = 1.0,
        mix_prob: float = 1.0,
        switch_prob: float = 0.5,
        label_smoothing: float = 0.1,
        num_classes: int = 400,
        seed: int = 0,
    ):
        self.mixup_alpha = mixup_alpha
        self.cutmix_alpha = cutmix_alpha
        self.mix_prob = mix_prob
        self.switch_prob = switch_prob
        self.label_smoothing = label_smoothing
        self.num_classes = num_classes
        self.rng = np.random.default_rng(seed)

    def _smooth_targets(self, labels: np.ndarray) -> np.ndarray:
        off = self.label_smoothing / self.num_classes
        on = 1.0 - self.label_smoothing + off
        return one_hot(labels, self.num_classes, on, off)

    def __call__(self, frames: np.ndarray, labels: np.ndarray):
        targets = self._smooth_targets(labels)
        if self.rng.random() >= self.mix_prob:
            return frames, targets

        use_cutmix = (
            self.cutmix_alpha > 0
            and (self.mixup_alpha <= 0 or self.rng.random() < self.switch_prob)
        )
        alpha = self.cutmix_alpha if use_cutmix else self.mixup_alpha
        lam = float(self.rng.beta(alpha, alpha))

        flipped = frames[::-1].copy()
        if use_cutmix:
            h, w = frames.shape[-3], frames.shape[-2]
            y1, y2, x1, x2 = rand_bbox(h, w, lam, self.rng)
            frames = frames.copy()
            frames[..., y1:y2, x1:x2, :] = flipped[..., y1:y2, x1:x2, :]
            lam = 1.0 - (y2 - y1) * (x2 - x1) / float(h * w)
        else:
            frames = frames * lam + flipped * (1.0 - lam)
        targets = targets * lam + targets[::-1] * (1.0 - lam)
        return frames.astype(np.float32), targets.astype(np.float32)
