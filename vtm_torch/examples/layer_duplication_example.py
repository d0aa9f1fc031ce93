"""Layer-duplication experiment (port of
``examples/layer_duplication_example.py``): run one block
``TOME.LAYER_QUANTITY`` times and merge only inside the duplicated run.

Usage:
  python -m vtm_torch.examples.layer_duplication_example --cfg configs/videomae/kinetics/tome_VideoMAE_B_16_224_K400.yaml \
      --opts TOME.LAYER_TO_DUPLICATE 0 TOME.LAYER_QUANTITY 12 TOME.R_VALUE 131
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from vtm_torch.config import assert_and_infer_cfg
from vtm_torch.examples.common import (
    load_clip,
    load_weights,
    parse_example_args,
    resolve_device,
)
from vtm_torch.models import build_model


def main(argv: Optional[Sequence[str]] = None, device: Optional[torch.device | str] = None):
    """Returns (logits, MergeState) of the one forward."""
    device = resolve_device(device)
    cfg, flags = parse_example_args(argv, None)
    if not flags.cfg_files:
        # bare-default fallback: align crops so fixed pos tables match
        # the synthetic clip (224 train / 256 test defaults differ)
        cfg.DATA.TEST_CROP_SIZE = cfg.DATA.TRAIN_CROP_SIZE
    assert_and_infer_cfg(cfg)
    cfg.TOME.ENABLE = True
    if cfg.TOME.LAYER_QUANTITY <= 1:
        cfg.TOME.LAYER_QUANTITY = 12  # the notebook's default: one layer x12

    bundle = load_weights(cfg, build_model(cfg, device))
    print(
        f"duplicating layer {cfg.TOME.LAYER_TO_DUPLICATE} "
        f"x{cfg.TOME.LAYER_QUANTITY}, rs={bundle.policy.rs}"
    )
    with torch.inference_mode():
        logits, state = bundle.apply(torch.from_numpy(load_clip(cfg)).to(device))
    probs = np.asarray(logits.float().cpu()) if torch.is_tensor(logits) else None
    if probs is not None and probs.ndim == 2:
        print("top-5 classes:", probs[0].argsort()[-5:][::-1].tolist())
    if state.size is not None:
        print("final tokens:", state.size.shape[1])
    return logits, state


if __name__ == "__main__":
    main()
