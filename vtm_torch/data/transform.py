"""Host-side video transforms, numpy/cv2 (copy of ``vtm/data/transform.py``;
cv2 and PIL are imported where a function resizes or converts, so that
the package imports without them).

Ports the subset of slowfast/datasets/transform.py the ToMe eval/train
paths exercise, with identical geometry math (offsets, scale selection)
so test-mode determinism matches the reference (SURVEY.md §7.5).
Frames are numpy [T, H, W, C] uint8 or float32 throughout (the models take
channels-last; the reference's CHW permutes are dropped).
"""

from __future__ import annotations

import math
import random
from typing import Optional, Sequence, Tuple

import numpy as np


def _resize(frames: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Bilinear resize of [T, H, W, C] (reference uses torch bilinear,
    align_corners=False; cv2 INTER_LINEAR matches that geometry)."""
    import cv2

    out = np.empty((frames.shape[0], new_h, new_w, frames.shape[3]), dtype=frames.dtype)
    for i in range(frames.shape[0]):
        out[i] = cv2.resize(frames[i], (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    return out


def short_side_scale(frames: np.ndarray, size: int) -> np.ndarray:
    """Scale the short side to ``size`` (reference
    random_short_side_scale_jitter with min==max, transform.py:47-90)."""
    t, h, w, c = frames.shape
    if (w <= h and w == size) or (h <= w and h == size):
        return frames
    if w < h:
        new_w = size
        new_h = int(math.floor(float(h) / w * size))
    else:
        new_h = size
        new_w = int(math.floor(float(w) / h * size))
    return _resize(frames, new_h, new_w)


def random_short_side_scale_jitter(
    frames: np.ndarray, min_size: int, max_size: int, inverse_uniform_sampling=False
) -> np.ndarray:
    if inverse_uniform_sampling:
        size = int(round(1.0 / random.uniform(1.0 / max_size, 1.0 / min_size)))
    else:
        size = int(round(random.uniform(min_size, max_size)))
    t, h, w, c = frames.shape
    if (w <= h and w == size) or (h <= w and h == size):
        return frames
    if w < h:
        new_w = size
        new_h = int(math.floor(float(h) / w * size))
    else:
        new_h = size
        new_w = int(math.floor(float(w) / h * size))
    return _resize(frames, new_h, new_w)


def random_crop(frames: np.ndarray, size: int) -> np.ndarray:
    t, h, w, c = frames.shape
    if h == size and w == size:
        return frames
    y = 0 if h == size else int(random.randint(0, h - size))
    x = 0 if w == size else int(random.randint(0, w - size))
    return frames[:, y : y + size, x : x + size, :]


def uniform_crop(frames: np.ndarray, size: int, spatial_idx: int) -> np.ndarray:
    """Left/center/right (or top/center/bottom) crop with the reference's
    ceil-centred offsets (transform.py:194-256)."""
    assert spatial_idx in (0, 1, 2)
    t, h, w, c = frames.shape
    y_offset = int(math.ceil((h - size) / 2))
    x_offset = int(math.ceil((w - size) / 2))
    if h > w:
        if spatial_idx == 0:
            y_offset = 0
        elif spatial_idx == 2:
            y_offset = h - size
    else:
        if spatial_idx == 0:
            x_offset = 0
        elif spatial_idx == 2:
            x_offset = w - size
    return frames[:, y_offset : y_offset + size, x_offset : x_offset + size, :]


def horizontal_flip(prob: float, frames: np.ndarray) -> np.ndarray:
    if random.uniform(0, 1) < prob:
        return frames[:, :, ::-1, :]
    return frames


def _get_param_spatial_crop(
    scale: Tuple[float, float],
    ratio: Tuple[float, float],
    height: int,
    width: int,
    num_repeat: int = 10,
    log_scale: bool = True,
    switch_hw: bool = False,
) -> Tuple[int, int, int, int]:
    """Inception-style crop-box sampling (reference transform.py:502-541),
    preserving the reference's RNG call order exactly (random.uniform x2
    then np.random.uniform) so seeded parity holds."""
    for _ in range(num_repeat):
        area = height * width
        target_area = random.uniform(*scale) * area
        if log_scale:
            log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
            aspect_ratio = math.exp(random.uniform(*log_ratio))
        else:
            aspect_ratio = random.uniform(*ratio)
        w = int(round(math.sqrt(target_area * aspect_ratio)))
        h = int(round(math.sqrt(target_area / aspect_ratio)))
        if np.random.uniform() < 0.5 and switch_hw:
            w, h = h, w
        if 0 < w <= width and 0 < h <= height:
            i = random.randint(0, height - h)
            j = random.randint(0, width - w)
            return i, j, h, w
    # fallback: central crop at the nearest valid aspect ratio
    in_ratio = float(width) / float(height)
    if in_ratio < min(ratio):
        w = width
        h = int(round(w / min(ratio)))
    elif in_ratio > max(ratio):
        h = height
        w = int(round(h * max(ratio)))
    else:
        w, h = width, height
    return (height - h) // 2, (width - w) // 2, h, w


def random_resized_crop(
    frames: np.ndarray,
    target_height: int,
    target_width: int,
    scale: Tuple[float, float] = (0.8, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> np.ndarray:
    """Random-area crop + bilinear resize (reference transform.py:544-576;
    the VideoMAE/ViViT finetune recipe's RandomResizedCrop)."""
    t, h, w, c = frames.shape
    i, j, hh, ww = _get_param_spatial_crop(scale, ratio, h, w)
    cropped = frames[:, i : i + hh, j : j + ww, :]
    return _resize(cropped, target_height, target_width)


def random_resized_crop_with_shift(
    frames: np.ndarray,
    target_height: int,
    target_width: int,
    scale: Tuple[float, float] = (0.8, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> np.ndarray:
    """Motion-shift variant (reference transform.py:579-623): two crop
    boxes sampled for the first/last frame, linearly interpolated for
    the frames between, each resized to the target."""
    t, h, w, c = frames.shape
    i, j, hh, ww = _get_param_spatial_crop(scale, ratio, h, w)
    i2, j2, h2, w2 = _get_param_spatial_crop(scale, ratio, h, w)
    i_s = [int(v) for v in np.linspace(i, i2, num=t)]
    j_s = [int(v) for v in np.linspace(j, j2, num=t)]
    h_s = [int(v) for v in np.linspace(hh, h2, num=t)]
    w_s = [int(v) for v in np.linspace(ww, w2, num=t)]
    out = np.empty((t, target_height, target_width, c), dtype=frames.dtype)
    for ind in range(t):
        box = frames[ind : ind + 1, i_s[ind] : i_s[ind] + h_s[ind], j_s[ind] : j_s[ind] + w_s[ind], :]
        out[ind] = _resize(box, target_height, target_width)[0]
    return out


def blend(frames1: np.ndarray, frames2: np.ndarray, alpha: float) -> np.ndarray:
    return frames1 * alpha + frames2 * (1 - alpha)


def grayscale(frames: np.ndarray) -> np.ndarray:
    """BGR-ordered grayscale broadcast to 3 channels (reference
    transform.py:295-314; channels-last here)."""
    gray = 0.299 * frames[..., 2] + 0.587 * frames[..., 1] + 0.114 * frames[..., 0]
    out = np.array(frames)
    out[..., 0] = gray
    out[..., 1] = gray
    out[..., 2] = gray
    return out


def brightness_jitter(var: float, frames: np.ndarray) -> np.ndarray:
    alpha = 1.0 + np.random.uniform(-var, var)
    return blend(frames, np.zeros_like(frames), alpha)


def contrast_jitter(var: float, frames: np.ndarray) -> np.ndarray:
    alpha = 1.0 + np.random.uniform(-var, var)
    gray = grayscale(frames)
    gray[:] = gray.mean(axis=(1, 2, 3), keepdims=True)
    return blend(frames, gray, alpha)


def saturation_jitter(var: float, frames: np.ndarray) -> np.ndarray:
    alpha = 1.0 + np.random.uniform(-var, var)
    return blend(frames, grayscale(frames), alpha)


def color_jitter(
    frames: np.ndarray,
    img_brightness: float = 0,
    img_contrast: float = 0,
    img_saturation: float = 0,
) -> np.ndarray:
    """Randomly-ordered brightness/contrast/saturation jitter (reference
    transform.py:317-350), channels-last [T, H, W, C]."""
    jitter = []
    if img_brightness != 0:
        jitter.append("brightness")
    if img_contrast != 0:
        jitter.append("contrast")
    if img_saturation != 0:
        jitter.append("saturation")
    if jitter:
        order = np.random.permutation(np.arange(len(jitter)))
        for idx in range(len(jitter)):
            kind = jitter[order[idx]]
            if kind == "brightness":
                frames = brightness_jitter(img_brightness, frames)
            elif kind == "contrast":
                frames = contrast_jitter(img_contrast, frames)
            else:
                frames = saturation_jitter(img_saturation, frames)
    return frames


def tensor_normalize(
    frames: np.ndarray, mean: Sequence[float], std: Sequence[float]
) -> np.ndarray:
    """uint8 [0,255] -> normalized float32 (reference
    datasets/utils.py:283-303)."""
    frames = frames.astype(np.float32)
    if frames.max() > 1.0 + 1e-3:
        frames = frames / 255.0
    return (frames - np.asarray(mean, dtype=np.float32)) / np.asarray(std, dtype=np.float32)


def spatial_sampling(
    frames: np.ndarray,
    spatial_idx: int = -1,
    min_scale: int = 256,
    max_scale: int = 320,
    crop_size: int = 224,
    random_horizontal_flip: bool = True,
    inverse_uniform_sampling: bool = False,
    aspect_ratio: Optional[Sequence[float]] = None,
    scale: Optional[Sequence[float]] = None,
    motion_shift: bool = False,
) -> np.ndarray:
    """Train (spatial_idx==-1) vs deterministic test crops (reference
    datasets/utils.py:117-189). When ``aspect_ratio``/``scale`` are given
    the train path uses Inception-style RandomResizedCrop instead of
    scale-jitter + crop (the VideoMAE/ViViT finetune recipe,
    reference utils.py:415-427)."""
    assert spatial_idx in (-1, 0, 1, 2)
    if spatial_idx == -1:
        if aspect_ratio is None and scale is None:
            frames = random_short_side_scale_jitter(
                frames, min_scale, max_scale, inverse_uniform_sampling
            )
            frames = random_crop(frames, crop_size)
        else:
            rrc = random_resized_crop_with_shift if motion_shift else random_resized_crop
            frames = rrc(
                frames, crop_size, crop_size, scale=tuple(scale), ratio=tuple(aspect_ratio)
            )
        if random_horizontal_flip:
            frames = horizontal_flip(0.5, frames)
    else:
        assert len({min_scale, max_scale}) == 1
        frames = short_side_scale(frames, min_scale)
        frames = uniform_crop(frames, crop_size, spatial_idx)
    return frames


def relative_crop_args(cfg, mode: str) -> dict:
    """Extra spatial_sampling kwargs for the train recipe's relative
    (Inception-style) crop (reference utils.py:408-427): active only in
    train mode when the config sets the relative jitter ranges."""
    scl = list(cfg.DATA.TRAIN_JITTER_SCALES_RELATIVE)
    asp = list(cfg.DATA.TRAIN_JITTER_ASPECT_RELATIVE)
    return dict(
        scale=scl if mode == "train" and scl else None,
        aspect_ratio=asp if mode == "train" and asp else None,
        motion_shift=cfg.DATA.TRAIN_JITTER_MOTION_SHIFT if mode == "train" else False,
    )


def train_augment(cfg, frames: np.ndarray, mode: str) -> np.ndarray:
    """RandAugment on uint8 frames before normalisation (reference
    datasets/utils.aug_frame via AUG.ENABLE)."""
    if mode != "train" or not cfg.AUG.ENABLE:
        return frames
    from vtm_torch.data.rand_augment import create_random_augment

    return create_random_augment(cfg.AUG.AA_TYPE)(frames)


def train_random_erase(cfg, frames: np.ndarray, mode: str) -> np.ndarray:
    """RandomErasing on normalised float frames (reference AUG.RE_*)."""
    if mode != "train" or not cfg.AUG.ENABLE or cfg.AUG.RE_PROB <= 0:
        return frames
    from vtm_torch.data.rand_augment import RandomErasing

    eraser = RandomErasing(
        probability=cfg.AUG.RE_PROB, mode=cfg.AUG.RE_MODE, max_count=cfg.AUG.RE_COUNT
    )
    return eraser(frames)


# ----------------------------------------------------------- SSL augs
# The self-supervised augmentation family (reference transform.py:
# 1089-1216) — temporal difference, MoCo-v2 color pipeline, gaussian
# blur. Python-`random` draws replace the reference's torch-RNG gates
# (same order and distributions; documented per function).


def temporal_difference(
    frames: np.ndarray, use_grayscale: bool = False, absolute: bool = False
) -> np.ndarray:
    """Frame differences, last frame duplicated (reference
    transform.py:1089-1113). [T, H, W, C] float; the grayscale uses the
    reference's channel order (0.299 on channel 2 — its BGR-weighted
    luma quirk, same as ``grayscale``)."""
    frames = np.asarray(frames, np.float32)
    if use_grayscale:
        frames = grayscale(frames)
    out = np.zeros_like(frames)
    t = frames.shape[0]
    dt = frames[: t - 1] - frames[1:t]
    if absolute:
        dt = np.abs(dt)
    out[: t - 1] = dt
    if t <= 1:
        return out
    out[-1] = dt[-1]
    return out


def gaussian_blur_video(
    frames: np.ndarray,
    sigma_min: Sequence[float] = (0.0, 0.1),
    sigma_max: Sequence[float] = (0.0, 2.0),
    rng=random,
) -> np.ndarray:
    """Reference GaussianBlurVideo (transform.py:1205-1216), including
    its axis quirk: sigmas (0, t, y, x) are applied to the [T, H, W, C]
    array as decoded — so "sigma_t" lands on H and "sigma_x" on the
    CHANNEL axis. Dead code in the reference (nothing passes
    gaussian_prob > 0); kept bit-faithful for parity. Draws:
    rng.uniform(sigma_min[1], sigma_max[1]) then
    rng.uniform(sigma_min[0], sigma_max[0])."""
    from scipy.ndimage import gaussian_filter

    sigma_y = sigma_x = rng.uniform(sigma_min[1], sigma_max[1])
    sigma_t = rng.uniform(sigma_min[0], sigma_max[0])
    return gaussian_filter(
        np.asarray(frames, np.float32), sigma=(0.0, sigma_t, sigma_y, sigma_x)
    )


def augment_raw_frames(
    frames: np.ndarray,
    time_diff_prob: float = 0.0,
    gaussian_prob: float = 0.0,
    rng=random,
):
    """Raw-frame (pre-/255) augmentation applied inside decode
    (reference transform.py:1166-1191, called from decoder.py:644).
    Returns (frames float32, time_diff_applied). Draw order matches the
    reference's python-random gate for the time difference; the blur
    gate uses rng.random() where the reference used a torch-RNG
    RandomApply (distributionally identical)."""
    frames = np.asarray(frames, np.float32)
    if gaussian_prob > 0.0 and rng.random() < gaussian_prob:
        frames = gaussian_blur_video(frames, rng=rng)
    time_diff_out = False
    if time_diff_prob > 0.0 and rng.random() < time_diff_prob:
        frames = temporal_difference(frames, use_grayscale=True, absolute=False)
        frames = (frames + 255.0) / 2.0
        time_diff_out = True
    return frames, time_diff_out


def to_uint8_truncate(arr: np.ndarray) -> np.ndarray:
    """[0,1] float -> uint8 with torchvision ToPILImage semantics (mul
    255 then TRUNCATE, no rounding). The single home for this
    bit-sensitive parity quirk — the AA path (rand_augment) and the SSL
    PIL pipeline below both feed float/255 clips through it."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    return arr


def _clip_to_pil(frames: np.ndarray):
    """[T, H, W, C] -> one PIL RGB image of size [T*H, W] — exactly the
    reference's view(c, t*h, w) + ToPILImage."""
    from PIL import Image

    arr = to_uint8_truncate(frames)
    t, h, w, c = arr.shape
    return Image.fromarray(arr.reshape(t * h, w, c)), (t, h)


def _pil_grayscale3(img):
    """torchvision F.to_grayscale(num_output_channels=3)."""
    from PIL import Image

    gray = np.array(img.convert("L"))
    return Image.fromarray(np.dstack([gray] * 3))


def _pil_adjust_hue(img, hue_factor: float):
    """torchvision F_pil.adjust_hue: uint8 H-channel shift with
    wrap-around."""
    from PIL import Image

    if img.mode in ("L", "1", "I", "F"):
        return img
    h, s, v = img.convert("HSV").split()
    np_h = np.array(h, dtype=np.uint8)
    with np.errstate(over="ignore"):
        np_h += np.array(hue_factor * 255).astype(np.uint8)
    return Image.merge(
        "HSV", (Image.fromarray(np_h, "L"), s, v)
    ).convert("RGB")


def _pil_color_jitter(img, brightness, contrast, saturation, hue, rng):
    """torchvision ColorJitter on a PIL image; all params drawn upfront
    (permutation, then brightness/contrast/saturation/hue factors) like
    ColorJitter.get_params, then applied in the drawn order."""
    from PIL import ImageEnhance

    order = list(range(4))
    rng.shuffle(order)
    b = rng.uniform(max(0.0, 1 - brightness), 1 + brightness) if brightness else None
    c = rng.uniform(max(0.0, 1 - contrast), 1 + contrast) if contrast else None
    s = rng.uniform(max(0.0, 1 - saturation), 1 + saturation) if saturation else None
    hf = rng.uniform(-hue, hue) if hue else None
    for fn_id in order:
        if fn_id == 0 and b is not None:
            img = ImageEnhance.Brightness(img).enhance(b)
        elif fn_id == 1 and c is not None:
            img = ImageEnhance.Contrast(img).enhance(c)
        elif fn_id == 2 and s is not None:
            img = ImageEnhance.Color(img).enhance(s)
        elif fn_id == 3 and hf is not None:
            img = _pil_adjust_hue(img, hf)
    return img


def color_jitter_video_ssl(
    frames: np.ndarray,
    bri_con_sat: Sequence[float] = (0.4, 0.4, 0.4),
    hue: float = 0.1,
    p_convert_gray: float = 0.0,
    moco_v2_aug: bool = False,
    gaussan_sigma_min: Sequence[float] = (0.0, 0.1),
    gaussan_sigma_max: Sequence[float] = (0.0, 2.0),
    rng=random,
) -> np.ndarray:
    """SSL color pipeline on a whole clip as one PIL image (reference
    transform.py:1115-1163).

    moco_v2_aug: RandomApply(ColorJitter, p=0.8) -> RandomGrayscale ->
    RandomApply(SimCLR GaussianBlur sigma U[0.1, 2.0], p=0.5); else
    RandomGrayscale -> ColorJitter. The ``gaussan_sigma_*`` args are
    accepted and IGNORED exactly like the reference (its Compose
    hardcodes GaussianBlur([0.1, 2.0]), transform.py:1140). Returns
    uint8 [T, H, W, C] (the PIL ops quantize anyway; tensor_normalize
    restores the reference's /255 floats downstream)."""
    del gaussan_sigma_min, gaussan_sigma_max  # reference quirk: unused
    from PIL import ImageFilter

    img, (t, h) = _clip_to_pil(frames)
    if moco_v2_aug:
        if rng.random() < 0.8:
            img = _pil_color_jitter(
                img, bri_con_sat[0], bri_con_sat[1], bri_con_sat[2], hue, rng
            )
        if rng.random() < p_convert_gray:
            img = _pil_grayscale3(img)
        if rng.random() < 0.5:
            sigma = rng.uniform(0.1, 2.0)
            img = img.filter(ImageFilter.GaussianBlur(radius=sigma))
    else:
        if rng.random() < p_convert_gray:
            img = _pil_grayscale3(img)
        img = _pil_color_jitter(
            img, bri_con_sat[0], bri_con_sat[1], bri_con_sat[2], hue, rng
        )
    out = np.asarray(img, dtype=np.uint8)  # [T*H, W, C]
    return out.reshape(t, h, out.shape[1], out.shape[2])


# --------------------------------------------------------------- boxes
# Box-aware variants used by the AVA detection path (reference
# transform.py:47-276 — boxes ride along with the geometric transforms).


def clip_boxes_to_image(boxes: np.ndarray, height: int, width: int) -> np.ndarray:
    """Reference transform.py:257-276."""
    clipped = boxes.copy()
    clipped[:, [0, 2]] = np.minimum(width - 1.0, np.maximum(0.0, boxes[:, [0, 2]]))
    clipped[:, [1, 3]] = np.minimum(height - 1.0, np.maximum(0.0, boxes[:, [1, 3]]))
    return clipped


def crop_boxes(boxes: np.ndarray, x_offset: int, y_offset: int) -> np.ndarray:
    out = boxes.copy()
    out[:, [0, 2]] = boxes[:, [0, 2]] - x_offset
    out[:, [1, 3]] = boxes[:, [1, 3]] - y_offset
    return out


def flip_boxes(boxes: np.ndarray, width: int) -> np.ndarray:
    out = boxes.copy()
    out[:, [0, 2]] = width - boxes[:, [2, 0]] - 1
    return out


def short_side_scale_with_boxes(frames, size: int, boxes):
    """min==max jitter with box scaling (reference transform.py:47-103)."""
    t, h, w, c = frames.shape
    if (w <= h and w == size) or (h <= w and h == size):
        return frames, boxes
    if w < h:
        new_w = size
        new_h = int(math.floor(float(h) / w * size))
        boxes = boxes * float(new_h) / h
    else:
        new_h = size
        new_w = int(math.floor(float(w) / h * size))
        boxes = boxes * float(new_w) / w
    return _resize(frames, new_h, new_w), boxes


def random_short_side_scale_jitter_with_boxes(frames, min_size, max_size, boxes):
    size = int(round(random.uniform(min_size, max_size)))
    return short_side_scale_with_boxes(frames, size, boxes)


def random_crop_with_boxes(frames, size: int, boxes):
    t, h, w, c = frames.shape
    if h == size and w == size:
        return frames, boxes
    y = 0 if h == size else int(random.randint(0, h - size))
    x = 0 if w == size else int(random.randint(0, w - size))
    return frames[:, y : y + size, x : x + size, :], crop_boxes(boxes, x, y)


def uniform_crop_with_boxes(frames, size: int, spatial_idx: int, boxes):
    t, h, w, c = frames.shape
    y_offset = int(math.ceil((h - size) / 2))
    x_offset = int(math.ceil((w - size) / 2))
    if h > w:
        y_offset = 0 if spatial_idx == 0 else (h - size if spatial_idx == 2 else y_offset)
    else:
        x_offset = 0 if spatial_idx == 0 else (w - size if spatial_idx == 2 else x_offset)
    cropped = frames[:, y_offset : y_offset + size, x_offset : x_offset + size, :]
    return cropped, crop_boxes(boxes, x_offset, y_offset)


def horizontal_flip_with_boxes(prob: float, frames, boxes):
    if random.uniform(0, 1) < prob:
        return frames[:, :, ::-1, :], flip_boxes(boxes, frames.shape[2])
    return frames, boxes
