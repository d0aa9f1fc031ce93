"""Tiny cells for the CPU tests: the shipped configurations and mixes with
small widths, run through the same harness and the program's own entry
points (its plain paths on the CPU)."""

from __future__ import annotations

import copy

from portbench.core import spec

VIDEOMAE = {"img_size": 64, "patch_size": 16, "num_frames": 4, "tubelet_size": 2, "embed_dim": 384, "depth": 12,
            "num_heads": 6, "mlp_ratio": 4.0, "num_classes": 10}
MOTIONFORMER = {"img_size": 64, "patch_size": 16, "num_frames": 4, "patch_size_temp": 2, "embed_dim": 64, "depth": 2,
                "num_heads": 2, "mlp_ratio": 4.0, "num_classes": 10, "use_mlp": True}
VIDEO = {"coarse": [2, 2, 2], "noise": 0.25}


def cell(name: str, r: int = None, limits: dict = None) -> spec.Cell:
    """The shipped cell ``name`` at tiny widths (VideoMAE-S layout, since the
    port builds VideoMAE by variant name; Motionformer by its width keys)."""
    real = spec.load_cell(name)
    config, traffic, workload = (copy.deepcopy(x) for x in (real.config, real.traffic, real.workload))
    port = config["port"]
    port["DATA"].update(NUM_FRAMES=4, TRAIN_CROP_SIZE=64, TEST_CROP_SIZE=64)
    port["MODEL"]["NUM_CLASSES"] = 10
    if config["family"] == "videomae":
        config["model"] = dict(VIDEOMAE)
        port["VIDEOMAE"]["MODEL"] = "vit_small_patch16_224"
        traffic.update(batch=4, pool=2, warmup=1)
        if traffic["tome_r"]:
            traffic["tome_r"] = 4
    else:
        config["model"] = dict(MOTIONFORMER)
        port["MOTIONFORMER"].update(EMBED_DIM=64, DEPTH=2, NUM_HEADS=2, TEMPORAL_RESOLUTION=2)
        traffic.update(batch=4, pool=3, warmup=1)
        if traffic["tome_r"]:
            traffic["tome_r"] = 3
    if r is not None:
        traffic["tome_r"] = r
    traffic["video"] = dict(VIDEO)
    workload["trace_iters"] = 2
    if limits:
        workload["limits"] = limits
    return spec.Cell(name, workload, config, traffic)
