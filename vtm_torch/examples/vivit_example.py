"""ViViT merge-source visualisation (port of ``examples/vivit_example.py``).

Build ViViT from a config, load a checkpoint if one is named, run one clip
with source tracking on, render the spatio-temporal merge groups and save
a frame sheet.

Usage:
  python -m vtm_torch.examples.vivit_example --cfg configs/vivit/kinetics/tome_vivit_8x32_224.yaml \
      [--opts TEST.CHECKPOINT_FILE_PATH /path/ckpt.pyth DATA.PATH_TO_DATA_DIR /data/k400] \
      [--out vivit_vis.png] [--r 300]

Without a dataset or checkpoint it falls back to a random clip and random
weights (the visualisation pipeline still runs end to end).
"""

from __future__ import annotations

import pathlib
from typing import Optional, Sequence

import torch

from vtm_torch.config import assert_and_infer_cfg
from vtm_torch.examples.common import (
    frames_tchw,
    load_clip,
    load_weights,
    parse_example_args,
    resolve_device,
    sheet_of,
)
from vtm_torch.models import build_model
from vtm_torch.vis.vis import make_spatiotemporal_video_visualization

REPO = pathlib.Path(__file__).resolve().parents[2]


def main(argv: Optional[Sequence[str]] = None, device: Optional[torch.device | str] = None) -> str:
    device = resolve_device(device)
    cfg, flags = parse_example_args(
        argv, str(REPO / "configs/vivit/kinetics/tome_vivit_8x32_224.yaml"),
        out=(str, "vivit_vis.png"), r=(int, None),
    )
    assert_and_infer_cfg(cfg)
    cfg.TOME.ENABLE = True
    cfg.TOME.TRACE_SOURCE = True
    if flags.r is not None:
        cfg.TOME.R_VALUE = flags.r

    bundle = load_weights(cfg, build_model(cfg, device))
    clip = load_clip(cfg)
    with torch.inference_mode():
        _, state = bundle.apply(torch.from_numpy(clip).to(device))
    source = state.source.float().cpu().numpy()  # [1, n_final, n_0]
    print(f"final tokens: {source.shape[1]} of {source.shape[2]}")

    pt, ph, pw = bundle.module.config.tubelet_size
    images, _ = make_spatiotemporal_video_visualization(
        frames_tchw(clip), source[0], patch_size=(ph, pw, pt), class_token=True
    )
    sheet_of(images).save(flags.out)
    print(f"wrote {flags.out}")
    return flags.out


if __name__ == "__main__":
    main()
