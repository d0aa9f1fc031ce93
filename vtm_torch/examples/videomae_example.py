"""VideoMAE merge-source visualisation (port of
``examples/videomae_example.py``: r=150, no class token).

Usage:
  python -m vtm_torch.examples.videomae_example --cfg configs/videomae/kinetics/tome_VideoMAE_B_16_224_K400.yaml \
      [--opts TEST.CHECKPOINT_FILE_PATH ... ] [--out videomae_vis.png]

Falls back to a random clip and random weights without a dataset or
checkpoint.
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
        argv, str(REPO / "configs/videomae/kinetics/tome_VideoMAE_B_16_224_K400.yaml"),
        out=(str, "videomae_vis.png"),
    )
    cfg.MODEL.MODEL_NAME = "VideoMAE"
    assert_and_infer_cfg(cfg)
    cfg.TOME.ENABLE = True
    cfg.TOME.TRACE_SOURCE = True

    bundle = load_weights(cfg, build_model(cfg, device))
    clip = load_clip(cfg)
    with torch.inference_mode():
        _, state = bundle.apply(torch.from_numpy(clip).to(device))
    source = state.source.float().cpu().numpy()
    print(f"final tokens: {source.shape[1]} of {source.shape[2]}")

    c = bundle.module.config
    images, _ = make_spatiotemporal_video_visualization(
        frames_tchw(clip),
        source[0],
        patch_size=(c.patch_size, c.patch_size, c.tubelet_size),
        class_token=False,  # VideoMAE has no CLS token
    )
    sheet_of(images).save(flags.out)
    print(f"wrote {flags.out}")
    return flags.out


if __name__ == "__main__":
    main()
