"""Clip-splicing semantics probe (port of
``examples/clip_splicing_example.py``: the Random and SameClass donor
policies).

Usage:
  python -m vtm_torch.examples.clip_splicing_example --cfg configs/videomae/kinetics/tome_VideoMAE_B_16_224_K400.yaml \
      --opts DATA.PATH_TO_DATA_DIR /data/k400

Falls back to the synthetic dataset without real data.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from vtm_torch.analysis import SplicedDataset
from vtm_torch.data.loader import build_dataset
from vtm_torch.config import assert_and_infer_cfg
from vtm_torch.examples.common import load_weights, parse_example_args, resolve_device
from vtm_torch.models import build_model


def main(argv: Optional[Sequence[str]] = None, device: Optional[torch.device | str] = None) -> dict:
    """Returns {policy: (label, top-1 class)} of the first spliced clip."""
    device = resolve_device(device)
    cfg, flags = parse_example_args(argv, None)
    if not flags.cfg_files:
        # bare-default fallback: align crops so fixed pos tables match
        # the synthetic clip (224 train / 256 test defaults differ)
        cfg.DATA.TEST_CROP_SIZE = cfg.DATA.TRAIN_CROP_SIZE
    assert_and_infer_cfg(cfg)

    try:
        base = build_dataset(cfg.TEST.DATASET, cfg, "test")
        _ = base[0]
    except Exception as e:
        print(f"(no dataset: {e}; using synthetic)")
        base = build_dataset("synthetic", cfg, "test")

    bundle = load_weights(cfg, build_model(cfg, device))
    tubelet = getattr(bundle.module.config, "tubelet_size", 2)
    patch_depth = tubelet[0] if isinstance(tubelet, (tuple, list)) else tubelet
    out = {}
    for policy in ("random", "same_class"):
        item = SplicedDataset(base, policy, patch_depth=patch_depth, num_to_replace=2)[0]
        with torch.inference_mode():
            logits, _ = bundle.apply(torch.from_numpy(item["frames"][None]).to(device))
        first = logits[0] if isinstance(logits, tuple) else logits
        out[policy] = (item["label"], int(first[0].argmax()))
        print(f"{policy}: label={item['label']} top1={out[policy][1]}")
    return out


if __name__ == "__main__":
    main()
