"""Merge-source visualisation (copy of ``vtm/vis/vis.py``, scipy imported
at the first erosion), numpy/PIL/scipy.

Given the [n_final, n_initial] source adjacency tracked during a
forward pass with ``trace_source=True``, paints each merged group with
its mean colour and a random-colour eroded border — per image
(make_visualization), per frame for the spatial-merging models
(make_spatial_video_visualization), or over full 3D tubelet groups for
the spatio-temporal models (make_spatiotemporal_video_visualization,
including the hybrid-dropped-token group — vis.py:148).
"""

from __future__ import annotations

import random
from typing import List, Tuple

import numpy as np
from PIL import Image


def binary_erosion(mask):
    """scipy's binary erosion, imported at the first call: importing scipy
    loads its libraries, and importing the package loads none."""
    from scipy.ndimage import binary_erosion as erode

    return erode(mask)


def generate_colormap(n: int, seed: int = 0) -> List[Tuple[float, float, float]]:
    """Equidistant-ish random colormap (reference vis.py:22-29)."""
    rnd = random.Random(seed)
    return [(rnd.random(), rnd.random(), rnd.random()) for _ in range(n)]


def _nearest_upsample_2d(mask: np.ndarray, h: int, w: int) -> np.ndarray:
    ph, pw = mask.shape
    return np.repeat(np.repeat(mask, h // ph, axis=0), w // pw, axis=1)


def _nearest_upsample_3d(mask: np.ndarray, t: int, h: int, w: int) -> np.ndarray:
    pt, ph, pw = mask.shape
    out = np.repeat(mask, t // pt, axis=0)
    out = np.repeat(out, h // ph, axis=1)
    return np.repeat(out, w // pw, axis=2)


def _erode_stack(mask: np.ndarray) -> np.ndarray:
    """binary_erosion per leading-axis slice of [T, H, W]."""
    return np.stack([binary_erosion(m) for m in mask]).astype(mask.dtype)


def make_visualization(
    img: Image.Image,
    source: np.ndarray,
    patch_size: int = 16,
    class_token: bool = True,
) -> Image.Image:
    """Single-image version (reference vis.py:32-79). ``source`` is
    [1, n_final, n_initial]."""
    arr = np.array(img.convert("RGB")) / 255.0
    h, w, _ = arr.shape
    ph, pw = h // patch_size, w // patch_size
    source = np.asarray(source)
    if class_token:
        source = source[:, :, 1:]
    vis = source.argmax(axis=1)[0]  # [n_patches]
    num_groups = int(vis.max()) + 1
    cmap = generate_colormap(num_groups)
    vis = vis.reshape(ph, pw)
    vis_img = np.zeros((h, w, 3))
    for i in range(num_groups):
        mask = _nearest_upsample_2d((vis == i).astype(np.float64), h, w)[..., None]
        denom = mask.sum()
        color = (mask * arr).sum(axis=(0, 1)) / denom if denom else np.zeros(3)
        if not np.isfinite(color).all():
            color = np.zeros(3)
        eroded = binary_erosion(mask[..., 0])[..., None].astype(np.float64)
        edge = mask - eroded
        vis_img += eroded * color.reshape(1, 1, 3)
        vis_img += edge * np.array(cmap[i]).reshape(1, 1, 3)
    return Image.fromarray(np.uint8(vis_img * 255))


def make_spatial_video_visualization(
    video: np.ndarray,
    source: np.ndarray,
    patch_size: Tuple[int, int, int] = (16, 16, 2),
    class_token: bool = True,
    average_colour: bool = True,
) -> np.ndarray:
    """Per-frame-group version for TimeSformer/Motionformer
    (reference vis.py:81-130). ``video``: [T, C, H, W] float in [0,1];
    ``source``: [n_frames_folded, n_final, n_initial]."""
    video = np.transpose(np.asarray(video), (0, 2, 3, 1))
    source = np.asarray(source)
    t, h, w, _ = video.shape
    if class_token:
        source = source[:, :, 1:]
    vis_vid = []
    for frame_idx in range(0, t, patch_size[2]):
        local_t = patch_size[2]
        ph, pw = h // patch_size[0], w // patch_size[1]
        vis = source[frame_idx // patch_size[2]].argmax(axis=0)  # [n_patches]
        num_groups = int(vis.max()) + 1
        cmap = generate_colormap(num_groups)
        vis3 = vis.reshape(1, ph, pw)
        vis_img = np.zeros((local_t, h, w, 3))
        clip = video[frame_idx : frame_idx + local_t]
        for i in range(num_groups):
            mask = _nearest_upsample_3d((vis3 == i).astype(np.float64), local_t, h, w)[
                ..., None
            ]
            denom = mask.sum()
            color = (mask * clip).sum(axis=(0, 1, 2)) / denom if denom else np.zeros(3)
            if not np.isfinite(color).all():
                color = np.zeros(3)
            eroded = _erode_stack(mask[..., 0])[..., None]
            edge = mask - eroded
            if average_colour:
                vis_img += eroded * color.reshape(1, 1, 1, 3)
            else:
                vis_img += eroded * clip
            vis_img += edge * np.array(cmap[i]).reshape(1, 1, 1, 3)
        vis_vid.append(vis_img)
    return np.uint8(np.concatenate(vis_vid) * 255)


def make_spatiotemporal_video_visualization(
    video: np.ndarray,
    source: np.ndarray,
    patch_size: Tuple[int, int, int] = (16, 16, 2),
    class_token: bool = True,
    average_colour: bool = True,
    separate: bool = False,
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Full 3D token groups for ViViT/VideoMAE (reference vis.py:132-178).
    Hybrid-dropped tokens (empty source rows) get their own group."""
    video = np.transpose(np.asarray(video), (0, 2, 3, 1))
    source = np.asarray(source)[0] if np.asarray(source).ndim == 3 else np.asarray(source)
    t, h, w, _ = video.shape
    ph, pw, pt = h // patch_size[0], w // patch_size[1], t // patch_size[2]
    if class_token:
        source = source[:, 1:]
    vis = source.argmax(axis=0)  # [n_initial]
    num_groups = int(vis.max()) + 1
    vis = np.where(source.sum(axis=0) == 0, num_groups, vis)
    cmap = generate_colormap(num_groups)
    vis3 = vis.reshape(pt, ph, pw)
    vis_vid = np.zeros((t, h, w, 3))
    separate_tokens: List[np.ndarray] = []
    for i in range(num_groups):
        mask = _nearest_upsample_3d((vis3 == i).astype(np.float64), t, h, w)[..., None]
        denom = mask.sum()
        color = (mask * video).sum(axis=(0, 1, 2)) / denom if denom else np.zeros(3)
        if not np.isfinite(color).all():
            color = np.zeros(3)
        eroded = _erode_stack(mask[..., 0])[..., None]
        edge = mask - eroded
        token = eroded * color.reshape(1, 1, 1, 3) if average_colour else eroded * video
        vis_vid += token
        vis_vid += edge * np.array(cmap[i]).reshape(1, 1, 1, 3)
        if separate:
            separate_tokens.append(np.uint8(token * 225))
    return np.uint8(vis_vid * 255), separate_tokens


def concatenate_images(video: np.ndarray, ncols: int = 8, nrows: int = 4) -> Image.Image:
    """Paste T frames into an ncols x nrows sheet (reference vis.py:180-187)."""
    n, h, w, c = video.shape
    sheet = Image.new("RGB", (w * ncols, h * nrows))
    for y in range(nrows):
        for x in range(ncols):
            sheet.paste(Image.fromarray(video[y * ncols + x]), (x * w, y * h))
    return sheet
