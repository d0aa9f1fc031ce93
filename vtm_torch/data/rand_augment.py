"""RandAugment + RandomErasing for video clips (copy of
``vtm/data/rand_augment.py``; PIL is imported where an op runs, so that
the package imports without it; reference:
slowfast/datasets/rand_augment.py + random_erasing.py — timm-vendored;
used by datasets/utils.aug_frame when AUG.ENABLE).

PIL-based ops applied with the SAME sampled transform to every frame
of a clip (temporally consistent, like the reference's per-clip
`create_random_augment`). The policy string follows timm:
``rand-m<magnitude>-n<num_ops>[-mstd<std>][-inc<0|1>]``.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence

import numpy as np

_MAX_LEVEL = 10.0


def _enhance_factor(level: float, inc: bool) -> float:
    if inc:
        return 1.0 + 0.9 * level / _MAX_LEVEL * random.choice([-1, 1])
    return 0.1 + 1.8 * level / _MAX_LEVEL


def _shear(img, level, axis):
    from PIL import Image

    v = 0.3 * level / _MAX_LEVEL * random.choice([-1, 1])
    m = (1, v, 0, 0, 1, 0) if axis == "x" else (1, 0, 0, v, 1, 0)
    return img.transform(img.size, Image.AFFINE, m, resample=Image.BILINEAR)


def _translate(img, level, axis):
    from PIL import Image

    frac = 0.45 * level / _MAX_LEVEL * random.choice([-1, 1])
    pixels = frac * (img.size[0] if axis == "x" else img.size[1])
    m = (1, 0, pixels, 0, 1, 0) if axis == "x" else (1, 0, 0, 0, 1, pixels)
    return img.transform(img.size, Image.AFFINE, m, resample=Image.BILINEAR)


def _ops(level: float, inc: bool):
    from PIL import Image, ImageEnhance, ImageOps

    return {
        "AutoContrast": lambda im: ImageOps.autocontrast(im),
        "Equalize": lambda im: ImageOps.equalize(im),
        "Invert": lambda im: ImageOps.invert(im),
        "Rotate": lambda im: im.rotate(
            30.0 * level / _MAX_LEVEL * random.choice([-1, 1]),
            resample=Image.BILINEAR,
        ),
        "Posterize": lambda im: ImageOps.posterize(
            im, max(1, int(4 - 3 * level / _MAX_LEVEL)) if inc else max(1, int(4 * level / _MAX_LEVEL) or 4)
        ),
        "Solarize": lambda im: ImageOps.solarize(im, int(256 - 256 * level / _MAX_LEVEL)),
        "SolarizeAdd": lambda im: _solarize_add(im, int(110 * level / _MAX_LEVEL)),
        "Color": lambda im: ImageEnhance.Color(im).enhance(_enhance_factor(level, inc)),
        "Contrast": lambda im: ImageEnhance.Contrast(im).enhance(_enhance_factor(level, inc)),
        "Brightness": lambda im: ImageEnhance.Brightness(im).enhance(_enhance_factor(level, inc)),
        "Sharpness": lambda im: ImageEnhance.Sharpness(im).enhance(_enhance_factor(level, inc)),
        "ShearX": lambda im: _shear(im, level, "x"),
        "ShearY": lambda im: _shear(im, level, "y"),
        "TranslateXRel": lambda im: _translate(im, level, "x"),
        "TranslateYRel": lambda im: _translate(im, level, "y"),
    }


def _solarize_add(img, add, thresh=128):
    from PIL import Image

    arr = np.asarray(img).astype(np.int64)
    arr = np.where(arr < thresh, np.clip(arr + add, 0, 255), arr)
    return Image.fromarray(arr.astype(np.uint8))


def parse_policy(aa_type: str):
    """'rand-m7-n4-mstd0.5-inc1' -> (magnitude, num_ops, mstd, inc)."""
    parts = aa_type.split("-")
    assert parts[0] == "rand", f"unsupported AA policy {aa_type!r}"
    magnitude, num_ops, mstd, inc = 10.0, 2, 0.0, False
    for p in parts[1:]:
        if p.startswith("mstd"):
            mstd = float(p[4:])
        elif p.startswith("inc"):
            inc = bool(int(p[3:]))
        elif p.startswith("m"):
            magnitude = float(p[1:])
        elif p.startswith("n"):
            num_ops = int(p[1:])
    return magnitude, num_ops, mstd, inc


def create_random_augment(aa_type: str, seed: Optional[int] = None):
    """Returns clip_aug(frames_uint8 [T,H,W,C]) applying the same
    sampled op sequence to every frame."""
    magnitude, num_ops, mstd, inc = parse_policy(aa_type)

    def clip_aug(frames: np.ndarray) -> np.ndarray:
        if seed is not None:
            random.seed(seed)
        chosen = []
        for _ in range(num_ops):
            level = magnitude
            if mstd > 0:
                level = min(_MAX_LEVEL, max(0.0, random.gauss(magnitude, mstd)))
            name = random.choice(list(_ops(0, inc)))
            chosen.append((name, level))
        from PIL import Image

        from vtm_torch.data.transform import to_uint8_truncate

        out = []
        for f in frames:
            # [0,1] float frames (the reference AA path feeds
            # .float()/255 clips through ToPILImage: mul(255),
            # truncate — kinetics.py:413, _frame_to_list_img)
            img = Image.fromarray(to_uint8_truncate(f))
            for name, level in chosen:
                img = _ops(level, inc)[name](img)
            out.append(np.asarray(img))
        return np.stack(out)

    return clip_aug


class RandomErasing:
    """Per-clip random erasing (reference random_erasing.py): one or
    more random rectangles replaced by noise, the same region for every
    frame of the clip."""

    def __init__(
        self,
        probability: float = 0.25,
        min_area: float = 0.02,
        max_area: float = 1 / 3,
        mode: str = "pixel",
        max_count: int = 1,
        seed: Optional[int] = None,
    ):
        self.probability = probability
        self.min_area = min_area
        self.max_area = max_area
        self.mode = mode
        self.max_count = max_count
        self.rng = np.random.default_rng(seed)

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        """frames: float [T, H, W, C] (normalised)."""
        if self.rng.random() > self.probability:
            return frames
        t, h, w, c = frames.shape
        out = frames.copy()
        count = int(self.rng.integers(1, self.max_count + 1))
        for _ in range(count):
            for _attempt in range(10):
                area = h * w * self.rng.uniform(self.min_area, self.max_area) / count
                ratio = np.exp(self.rng.uniform(np.log(0.3), np.log(1 / 0.3)))
                eh, ew = int(round(np.sqrt(area * ratio))), int(round(np.sqrt(area / ratio)))
                if eh < h and ew < w:
                    y = int(self.rng.integers(0, h - eh))
                    x = int(self.rng.integers(0, w - ew))
                    if self.mode == "pixel":
                        noise = self.rng.standard_normal((t, eh, ew, c))
                    elif self.mode == "const":
                        noise = 0.0
                    else:  # rand: one value per erase
                        noise = self.rng.standard_normal((1, 1, 1, c))
                    out[:, y : y + eh, x : x + ew, :] = noise
                    break
        return out
