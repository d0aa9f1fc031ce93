"""What the example scripts share: their command line, the device and a
first clip."""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from vtm_torch.config import load_config, parse_args


def parse_example_args(argv: Optional[Sequence[str]], default_cfg: Optional[str], **flags):
    """``--cfg`` / ``--opts`` as every entry point takes them, plus the
    example's own ``flags`` (name -> (type, default)), which may stand
    before or after ``--opts``. Returns (cfg, flag values, with
    ``cfg_files`` the ``--cfg`` paths); the config is not yet passed
    through ``assert_and_infer_cfg``."""
    own = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    for name, (kind, default) in flags.items():
        own.add_argument(f"--{name}", type=kind, default=default)
    values, rest = own.parse_known_args(argv)
    args = parse_args(rest)
    values.cfg_files = args.cfg_files
    return load_config(args, (args.cfg_files or [default_cfg])[0]), values


def resolve_device(device: Optional[torch.device | str]) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the examples need a CUDA device and found none")
        device = "cuda"
    return torch.device(device)


def load_clip(cfg) -> np.ndarray:
    """[1, T, H, W, C] float32: the first test clip if a dataset is
    configured, else a random one from seed 0."""
    try:
        from vtm_torch.data import construct_loader

        return construct_loader(cfg, "test").dataset[0]["frames"][None]
    except Exception as e:  # no dataset available
        print(f"(no dataset: {e}; using a random clip)")
        rng = np.random.default_rng(0)
        t, s = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
        return rng.standard_normal((1, t, s, s, 3)).astype(np.float32)


def load_weights(cfg, bundle):
    """The test checkpoint when one is named (not a placeholder), else the
    seeded weights."""
    if cfg.TEST.CHECKPOINT_FILE_PATH and "<" not in cfg.TEST.CHECKPOINT_FILE_PATH:
        from vtm_torch.checkpoints.checkpoint import load_test_checkpoint

        bundle = load_test_checkpoint(cfg, bundle)
    return bundle


def frames_tchw(clip: np.ndarray) -> np.ndarray:
    """The first clip of a batch scaled to [0, 1], as [T, C, H, W]."""
    frames01 = (clip[0] - clip[0].min()) / (np.ptp(clip[0]) + 1e-8)
    return np.transpose(frames01, (0, 3, 1, 2))


def sheet_of(images: np.ndarray):
    """The frames [T, H, W, 3] uint8 on one sheet, 8 (or 4) a row."""
    from vtm_torch.vis.vis import concatenate_images

    t = images.shape[0]
    ncols = 8 if t % 8 == 0 else 4
    return concatenate_images(images, ncols=ncols, nrows=max(1, t // ncols))
