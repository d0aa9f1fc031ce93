"""TimeSformer / Motionformer per-frame merge-source visualisation (port
of ``examples/timesformer_example.py``; the spatial variant of the
visualisation, as the reference's notebooks use for these models).

Usage:
  python -m vtm_torch.examples.timesformer_example --cfg configs/timesformer/kinetics/tome_TimeSformer_divST_8x32_224.yaml \
      [--opts TEST.CHECKPOINT_FILE_PATH ... MODEL.MODEL_NAME Motionformer] [--out timesformer_vis.png]

Falls back to a random clip and random weights without data. ``--out``
defaults to ``<model name>_vis.png``.
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
from vtm_torch.vis.vis import make_spatial_video_visualization

REPO = pathlib.Path(__file__).resolve().parents[2]


def main(argv: Optional[Sequence[str]] = None, device: Optional[torch.device | str] = None) -> str:
    device = resolve_device(device)
    cfg, flags = parse_example_args(
        argv, str(REPO / "configs/timesformer/kinetics/tome_TimeSformer_divST_8x32_224.yaml"),
        out=(str, None),
    )
    assert_and_infer_cfg(cfg)
    cfg.TOME.ENABLE = True
    cfg.TOME.TRACE_SOURCE = True
    if not cfg.TOME.R_VALUE:
        cfg.TOME.R_VALUE = 18

    bundle = load_weights(cfg, build_model(cfg, device))
    clip = load_clip(cfg)
    with torch.inference_mode():
        _, state = bundle.apply(torch.from_numpy(clip).to(device))
    # per-frame source: [(B*T_eff), n_final, n_0] (CLS-free for these models)
    source = state.source.float().cpu().numpy()
    print(f"per-frame final tokens: {source.shape[1]} of {source.shape[2]}")

    frames = frames_tchw(clip)
    # frames per merge group: TimeSformer merges per frame, Motionformer
    # per temporally patched pseudo-frame
    pt = frames.shape[0] // source.shape[0] if source.shape[0] else 1
    c = bundle.module.config
    images = make_spatial_video_visualization(
        frames, source, patch_size=(c.patch_size, c.patch_size, pt), class_token=False
    )
    out = flags.out or f"{bundle.name.lower()}_vis.png"
    sheet_of(images).save(out)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
