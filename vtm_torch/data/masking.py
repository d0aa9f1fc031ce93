"""Block-wise mask generators for masked-video pretraining (copy of
``vtm/data/masking.py``).

Re-derivations of the reference's BEiT-style generators
(slowfast/datasets/transform.py:809-893 MaskingGenerator,
:903-985 MaskingGenerator3D), drawing from the global ``random`` module
in exactly the reference's order so seeded parity holds. Exposed behind
the same AUG.MASK_* keys the reference's kinetics loader reads
(kinetics.py:517-536).

The generators draw from the global ``random``, so which clip gets which
mask depends on the order the loader's threads call them in: a seeded
``random`` with ``DATA_LOADER.NUM_WORKERS 0`` gives ``vtm``'s masks. Kept
as in ``vtm``, faults included: ``gen_mask`` under ``AUG.MASK_TUBE`` sizes
its budget on the 3-D window but draws on one frame's, so most tube masks
come out empty; ``generate_mask`` under ``AUG.MASK_TUBE`` cannot unpack a
3-entry window.
"""

from __future__ import annotations

import math
import random
from typing import Optional, Sequence, Tuple, Union

import numpy as np


class MaskingGenerator:
    """2-D block masking: accumulate random rectangles until
    ``num_masking_patches`` cells are masked."""

    def __init__(
        self,
        mask_window_size: Union[int, Sequence[int]],
        num_masking_patches: int,
        min_num_patches: int = 16,
        max_num_patches: Optional[int] = None,
        min_aspect: float = 0.3,
        max_aspect: Optional[float] = None,
    ):
        if not isinstance(mask_window_size, (list, tuple)):
            mask_window_size = (mask_window_size,) * 2
        self.height, self.width = mask_window_size
        self.num_patches = self.height * self.width
        self.num_masking_patches = num_masking_patches
        self.min_num_patches = min_num_patches
        self.max_num_patches = (
            num_masking_patches if max_num_patches is None else max_num_patches
        )
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))

    def get_shape(self) -> Tuple[int, int]:
        return self.height, self.width

    def _mask(self, mask: np.ndarray, max_mask_patches: int) -> int:
        delta = 0
        for _ in range(10):
            target_area = random.uniform(self.min_num_patches, max_mask_patches)
            aspect_ratio = math.exp(random.uniform(*self.log_aspect_ratio))
            h = int(round(math.sqrt(target_area * aspect_ratio)))
            w = int(round(math.sqrt(target_area / aspect_ratio)))
            if w < self.width and h < self.height:
                top = random.randint(0, self.height - h)
                left = random.randint(0, self.width - w)
                block = mask[top : top + h, left : left + w]
                fresh = h * w - int(block.sum())
                if 0 < fresh <= max_mask_patches:
                    block[:] = 1
                    delta += fresh
                if delta > 0:
                    break
        return delta

    def __call__(self) -> np.ndarray:
        mask = np.zeros(self.get_shape(), dtype=int)
        count = 0
        while count < self.num_masking_patches:
            budget = min(self.num_masking_patches - count, self.max_num_patches)
            delta = self._mask(mask, budget)
            if delta == 0:
                break
            count += delta
        return mask


class MaskingGenerator3D:
    """3-D (tube) block masking over (T, H, W) patch windows."""

    def __init__(
        self,
        mask_window_size: Sequence[int],
        num_masking_patches: int,
        min_num_patches: int = 16,
        max_num_patches: Optional[int] = None,
        min_aspect: float = 0.3,
        max_aspect: Optional[float] = None,
    ):
        self.temporal, self.height, self.width = mask_window_size
        self.num_masking_patches = num_masking_patches
        self.min_num_patches = min_num_patches
        self.max_num_patches = (
            num_masking_patches if max_num_patches is None else max_num_patches
        )
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))

    def get_shape(self) -> Tuple[int, int, int]:
        return self.temporal, self.height, self.width

    def _mask(self, mask: np.ndarray, max_mask_patches: int) -> int:
        delta = 0
        for _ in range(100):
            # NOTE: draws min_num..MAX_num (not the remaining budget) and
            # samples t even when w/h are rejected — reference quirks
            # (transform.py:944-952) kept for RNG parity.
            target_area = random.uniform(self.min_num_patches, self.max_num_patches)
            aspect_ratio = math.exp(random.uniform(*self.log_aspect_ratio))
            h = int(round(math.sqrt(target_area * aspect_ratio)))
            w = int(round(math.sqrt(target_area / aspect_ratio)))
            t = random.randint(1, self.temporal)
            if w < self.width and h < self.height:
                top = random.randint(0, self.height - h)
                left = random.randint(0, self.width - w)
                front = random.randint(0, self.temporal - t)
                block = mask[front : front + t, top : top + h, left : left + w]
                fresh = t * h * w - int(block.sum())
                if 0 < fresh <= max_mask_patches:
                    block[:] = 1
                    delta += fresh
                if delta > 0:
                    break
        return delta

    def __call__(self) -> np.ndarray:
        mask = np.zeros(self.get_shape(), dtype=int)
        count = 0
        while count < self.num_masking_patches:
            delta = self._mask(mask, self.num_masking_patches - count)
            if delta == 0:
                break
            count += delta
        return mask


def generate_mask(cfg) -> Optional[np.ndarray]:
    """Per-clip mask from the AUG.MASK_* keys — exact re-derivation of
    the reference loader's ``_gen_mask`` (kinetics.py:515-552):
    MASK_TUBE -> 2-D mask tiled 8x over time; MASK_FRAMES -> whole
    frames masked; else the 3-D generator capped per block at one
    frame's patch count."""
    if not cfg.AUG.GEN_MASK_LOADER:
        return None
    win = list(cfg.AUG.MASK_WINDOW_SIZE)
    if cfg.AUG.MASK_TUBE:
        num = round(float(np.prod(win)) * cfg.AUG.MASK_RATIO)
        gen = MaskingGenerator(win, num, min_num_patches=num // 5, max_num_patches=None)
        return np.tile(gen(), (8, 1, 1))
    if cfg.AUG.MASK_FRAMES:
        mask = np.zeros(win, dtype=int)
        n_mask = round(win[0] * cfg.AUG.MASK_RATIO)
        idx = random.sample(range(0, win[0]), n_mask)
        mask[idx, :, :] += 1
        return mask
    num = round(float(np.prod(win)) * cfg.AUG.MASK_RATIO)
    max_mask = int(np.prod(win[1:]))
    return MaskingGenerator3D(
        win, num, min_num_patches=max_mask // 5, max_num_patches=max_mask
    )()


def gen_mask(cfg) -> np.ndarray:
    """Per-clip pretraining mask (reference kinetics.py:516-553):
    MASK_TUBE -> 2-D blockwise mask tiled over 8 frames; MASK_FRAMES ->
    whole-frame masking; else 3-D blockwise masking."""
    import random as _random

    window = cfg.AUG.MASK_WINDOW_SIZE
    if cfg.AUG.MASK_TUBE:
        num = round(np.prod(window) * cfg.AUG.MASK_RATIO)
        mask = MaskingGenerator(
            mask_window_size=window[1:],
            num_masking_patches=num,
            max_num_patches=None,
            min_num_patches=num // 5,
        )()
        return np.tile(mask, (8, 1, 1))
    if cfg.AUG.MASK_FRAMES:
        mask = np.zeros(window, dtype=int)
        n_mask = round(window[0] * cfg.AUG.MASK_RATIO)
        idx = _random.sample(range(0, window[0]), n_mask)
        mask[idx, :, :] += 1
        return mask
    num = round(np.prod(window) * cfg.AUG.MASK_RATIO)
    max_mask = int(np.prod(window[1:]))
    return MaskingGenerator3D(
        mask_window_size=window,
        num_masking_patches=num,
        max_num_patches=max_mask,
        min_num_patches=max_mask // 5,
    )()
