"""ImageNet dataset (copy of ``vtm/data/imagenet.py``; the MViT image
pretraining configs use it, and the AVA dataset's PCA jitter is its
``lighting_jitter``).

Functional parity target: slowfast/datasets/imagenet.py — imdb
construction from per-class dirs (:57-79), the resnet-style path
(random_sized_crop + flip + PCA lighting jitter, :91-123) and the
deterministic val path (resize 1/crop_ratio + center crop, :144-171).

The AUG.ENABLE path maps the timm `transforms_imagenet_train` pipeline
onto the package's own pieces (Inception crop + flip + RandAugment +
random erasing, vtm_torch/data/{transform,rand_augment}.py) — same policy
family, torchvision-free. PIL is imported where an image is read or
resized.

Output: {"frames": [1, H, W, C] float32 (a 1-frame clip, so video
models and loaders work unchanged), "label", "index"}.
"""

from __future__ import annotations

import json
import os
import random
import re

import numpy as np

from vtm_torch.data import transform
from vtm_torch.data.loader import register_dataset
from vtm_torch.utils.logging import get_logger

logger = get_logger(__name__)


def lighting_jitter(im: np.ndarray, alphastd, eigval, eigvec) -> np.ndarray:
    """AlexNet-style PCA jitter on [H, W, C] (reference
    transform.py:410-455; note the reference indexes rgb[2 - idx])."""
    if alphastd == 0:
        return im
    alpha = np.random.normal(0, alphastd, size=(1, 3))
    eig_vec = np.asarray(eigvec)
    eig_val = np.reshape(eigval, (1, 3))
    rgb = np.sum(
        eig_vec * np.repeat(alpha, 3, axis=0) * np.repeat(eig_val, 3, axis=0),
        axis=1,
    )
    out = im.copy()
    for idx in range(im.shape[-1]):
        out[..., idx] = im[..., idx] + rgb[2 - idx]
    return out


def _bicubic_resize(im: np.ndarray, size) -> np.ndarray:
    from PIL import Image

    h, w = (size, size) if isinstance(size, int) else size
    pil = Image.fromarray(np.clip(im * 255.0, 0, 255).astype(np.uint8))
    return np.asarray(pil.resize((w, h), Image.BICUBIC)).astype(np.float32) / 255.0


@register_dataset("imagenet")
class Imagenet:
    def __init__(self, cfg, mode: str, num_retries: int = 10):
        assert mode in ("train", "val", "test")
        self.cfg = cfg
        self.mode = mode
        self.num_retries = num_retries
        self.data_path = cfg.DATA.PATH_TO_DATA_DIR
        if cfg.DATA.PATH_TO_PRELOAD_IMDB:
            with open(
                os.path.join(cfg.DATA.PATH_TO_PRELOAD_IMDB, f"{mode}.json")
            ) as f:
                self._imdb = json.load(f)
        else:
            self._construct_imdb()
        self.num_videos = len(self._imdb)

    def _construct_imdb(self):
        split_path = os.path.join(self.data_path, self.mode)
        split_files = sorted(os.listdir(split_path))
        self._class_ids = sorted(
            f for f in split_files if re.match(r"^n[0-9]+$", f)
        )
        self._class_id_cont_id = {v: i for i, v in enumerate(self._class_ids)}
        self._imdb = []
        for class_id in self._class_ids:
            cont_id = self._class_id_cont_id[class_id]
            im_dir = os.path.join(split_path, class_id)
            for im_name in sorted(os.listdir(im_dir)):
                self._imdb.append(
                    {"im_path": os.path.join(im_dir, im_name), "class": cont_id}
                )
        logger.info(
            "Number of images: %d, classes: %d",
            len(self._imdb),
            len(self._class_ids),
        )

    def load_image(self, im_path: str) -> np.ndarray:
        """[H, W, C] RGB float in [0, 1]."""
        from PIL import Image

        with Image.open(im_path) as im:
            im = im.convert("RGB")
            return np.asarray(im).astype(np.float32) / 255.0

    def _prepare_im_res(self, im_path: str) -> np.ndarray:
        cfg = self.cfg
        im = self.load_image(im_path)
        train_size, test_size = (
            cfg.DATA.TRAIN_CROP_SIZE,
            cfg.DATA.TEST_CROP_SIZE,
        )
        if self.mode == "train":
            frames = im[None]  # [1, H, W, C]
            scl = cfg.DATA.TRAIN_JITTER_SCALES_RELATIVE or (0.08, 1.0)
            asp = cfg.DATA.TRAIN_JITTER_ASPECT_RELATIVE or (3.0 / 4.0, 4.0 / 3.0)
            frames = transform.random_resized_crop(
                frames, train_size, train_size, tuple(scl), tuple(asp)
            )
            frames = transform.horizontal_flip(0.5, frames)
            im = lighting_jitter(
                frames[0], 0.1, cfg.DATA.TRAIN_PCA_EIGVAL, cfg.DATA.TRAIN_PCA_EIGVEC
            )
        else:
            frames = transform.short_side_scale(im[None], train_size)
            im = transform.uniform_crop(frames, test_size, 1)[0]
        return (im - np.asarray(cfg.DATA.MEAN, np.float32)) / np.asarray(
            cfg.DATA.STD, np.float32
        )

    def _prepare_im_tf(self, im_path: str) -> np.ndarray:
        cfg = self.cfg
        im = self.load_image(im_path)
        train_size, test_size = (
            cfg.DATA.TRAIN_CROP_SIZE,
            cfg.DATA.TEST_CROP_SIZE,
        )
        if self.mode == "train":
            frames = transform.random_resized_crop(
                im[None], train_size, train_size, (0.08, 1.0), (3 / 4, 4 / 3)
            )
            frames = transform.horizontal_flip(0.5, frames)
            # RandAugment operates on uint8 images (PIL policies)
            frames = np.clip(frames * 255.0, 0, 255).astype(np.uint8)
            frames = transform.train_augment(cfg, frames, "train")
            frames = transform.tensor_normalize(frames, cfg.DATA.MEAN, cfg.DATA.STD)
            frames = transform.train_random_erase(cfg, frames, "train")
            return frames[0]
        if cfg.DATA.IN_VAL_CROP_RATIO == 0.0:
            im = _bicubic_resize(im, (test_size, test_size))
        else:
            size = int((1.0 / cfg.DATA.IN_VAL_CROP_RATIO) * test_size)
            h, w = im.shape[:2]
            if h < w:
                im = _bicubic_resize(im, (size, int(w * size / h)))
            else:
                im = _bicubic_resize(im, (int(h * size / w), size))
            im = transform.uniform_crop(im[None], test_size, 1)[0]
        return (im - np.asarray(cfg.DATA.MEAN, np.float32)) / np.asarray(
            cfg.DATA.STD, np.float32
        )

    def __getitem__(self, index: int) -> dict:
        cfg = self.cfg
        for _ in range(self.num_retries):
            try:
                path = self._imdb[index]["im_path"]
                im = (
                    self._prepare_im_tf(path)
                    if cfg.AUG.ENABLE
                    else self._prepare_im_res(path)
                )
                break
            except Exception:
                assert self.mode == "train", f"{index} failed loading"
                logger.warning("%d failed. retry", index)
                index = random.randint(0, len(self._imdb) - 1)
        label = self._imdb[index]["class"]
        return {"frames": im[None], "label": label, "index": index}

    def __len__(self) -> int:
        return len(self._imdb)
