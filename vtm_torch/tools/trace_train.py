"""Where a VideoMAE train step's time goes on the card.

    python -m vtm_torch.tools.trace_train [--steps 4] [--opts KEY VALUE ...]

Builds the trainer that ``vtm_torch.tools.train_net`` steps with (ViT-B/16
16x224, batch 8, bf16 compute, fp32 parameters, AdamW, cross-entropy, one
fixed synthetic batch; ``--opts`` change the config), merged at r=150 and
unmerged, and for each:
  * times warm steps untraced, two ways: each step synchronised, as the
    train loop runs them (it reads the loss every iteration), and
    ``--steps`` steps queued back to back with one synchronise at the end;
  * traces ``--steps`` further synchronised steps with ``torch.profiler``
    (CPU and CUDA activities) and sums the device time of every kernel by
    name (annotation spans are left out).
Prints one JSON line per program: step_ms (synchronised), queued_step_ms,
kernel_ms per step, the device idle share of each (1 - kernel time /
wall), kernels launched per step, kernel time by category (K1, K2's two
kernels, linear layers, the optimizer, ...) and the 25 longest kernels by
name. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from vtm_torch.config import get_cfg
from vtm_torch.data import construct_loader
from vtm_torch.tools.train_net import build_trainer
from vtm_torch.train.optimizer import set_lr

# ViT-B/16 16x224 at r=150 without proportional attention, one 400-class
# head, AdamW at a constant 1e-4 with weight decay 0.05.
STEP_OPTS = [
    "MODEL.MODEL_NAME", "VideoMAE", "MODEL.ARCH", "videomae", "MODEL.NUM_CLASSES", "400",
    "VIDEOMAE.MODEL", "vit_base_patch16_224", "DATA.NUM_FRAMES", "16",
    "DATA.TRAIN_CROP_SIZE", "224", "DATA.TEST_CROP_SIZE", "224",
    "TOME.ENABLE", "True", "TOME.R_VALUE", "150", "TOME.PROP_ATTN", "False",
    "TRAIN.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "8", "TPU.COMPUTE_DTYPE", "bfloat16",
    "SOLVER.OPTIMIZING_METHOD", "adamw", "SOLVER.BASE_LR", "0.0001", "SOLVER.WEIGHT_DECAY", "0.05",
    "SOLVER.LR_POLICY", "steps_with_relative_lrs", "SOLVER.LRS", "[1]", "SOLVER.STEPS", "[0]",
]


# (category, substring of the kernel's name), first match wins
_CATEGORIES = (
    ("k2_attention_bwd_dq", "attention_bwd_dq"),
    ("k2_attention_bwd_dkdv", "attention_bwd_dkdv"),
    ("k1_attention_fwd", "attention_fwd"),
    ("linear_layers", "nvjet"),
    ("linear_layers", "gemm"),
    ("linear_layers", "cutlass"),
    ("tubelet_conv", "convolve"),
    ("tubelet_conv", "wgrad"),
    ("tubelet_conv", "nhwcToNchw"),
    ("tubelet_conv", "nchwToNhwc"),
    ("optimizer", "multi_tensor_apply"),
    ("layernorm", "layer_norm"),
    ("layernorm", "GammaBeta"),
    ("copies_and_concats", "copy"),
    ("copies_and_concats", "CatArray"),
    ("copies_and_concats", "Memcpy"),
    ("reductions", "reduce_kernel"),
    ("gathers_sorts_scatters", "gather"),
    ("gathers_sorts_scatters", "scatter"),
    ("gathers_sorts_scatters", "sort"),
    ("gathers_sorts_scatters", "Sort"),
    ("gathers_sorts_scatters", "index"),
    ("elementwise", "elementwise"),
)


def _category(name: str) -> str:
    for category, key in _CATEGORIES:
        if key in name:
            return category
    return "other"


def trace_program(label: str, opts, steps: int, warm: int = 3) -> dict:
    cfg = get_cfg()
    cfg.merge_from_list(STEP_OPTS + list(opts))
    trainer = build_trainer(cfg)
    batch = next(iter(construct_loader(cfg, "train")))
    frames = torch.from_numpy(batch["frames"]).cuda()
    labels = torch.from_numpy(np.asarray(batch["label"])).cuda()
    set_lr(trainer.optimizer, trainer.lr_at(0.0))

    def step():
        trainer.train_step(frames, labels)
        torch.cuda.synchronize()

    for _ in range(warm):
        step()
    walls = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        walls.append(time.perf_counter() - t0)
    step_ms = statistics.median(walls) * 1e3
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_step(frames, labels)
    torch.cuda.synchronize()
    queued_step_ms = (time.perf_counter() - t0) / steps * 1e3

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(steps):
            step()
    by_name, launches = {}, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
            launches += 1
    if not by_name:
        raise RuntimeError("torch.profiler recorded no device time")
    kernel_ms = sum(by_name.values()) / steps
    by_category = {}
    for name, ms in by_name.items():
        by_category[_category(name)] = by_category.get(_category(name), 0.0) + ms / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:25]
    return dict(
        program=label, step_ms=step_ms, train_clips_per_sec=8 / step_ms * 1e3,
        queued_step_ms=queued_step_ms, kernel_ms=kernel_ms,
        device_idle_share=max(0.0, 1 - kernel_ms / step_ms),
        queued_device_idle_share=max(0.0, 1 - kernel_ms / queued_step_ms),
        kernels_per_step=launches / steps, by_category_ms=by_category,
        top_kernels_ms=[[n[:120], ms / steps] for n, ms in top],
    )


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_train needs a CUDA device and found none")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for label, opts in (("merged", ()), ("unmerged", ("TOME.ENABLE", "False"))):
        row = trace_program(label, list(opts) + args.opts, args.steps)
        print(json.dumps(dict(row, nvidia_smi=smi)), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
