"""Where a train step's time goes on the card.

    python -m vtm_torch.tools.trace_train [--model videomae|motionformer|timesformer|vivit]
                                          [--steps 4] [--opts KEY VALUE ...]

Builds the trainer that ``vtm_torch.tools.train_net`` steps with (ViT-B/16
at 224, batch 8, bf16 compute, fp32 parameters, cross-entropy, one fixed
synthetic batch; ``--opts`` change the config), merged (VideoMAE 16 frames
at r=150; Motionformer 16 frames with trajectory attention at r=18 per
pseudo-frame; TimeSformer 8 frames with divided attention at r=18 per
frame; ViViT 32 frames at r=300; the last three with proportional
attention) and unmerged, with AdamW (VideoMAE, Motionformer) or the
shipped configs' SGD with momentum (TimeSformer, ViViT), and for each:
  * times warm steps untraced, two ways: each step synchronised, as the
    train loop runs them (it reads the loss every iteration), and
    ``--steps`` steps queued back to back with one synchronise at the end;
  * traces ``--steps`` further synchronised steps with ``torch.profiler``
    (CPU and CUDA activities) and sums the device time of every kernel by
    name (annotation spans are left out).
Prints one JSON line per program: step_ms (synchronised), queued_step_ms,
kernel_ms per step, the device idle share of each (1 - kernel time /
wall), kernels launched per step, kernel time by category (K1, K3, K5a, the
two kernels each of K2, K4 and K5b, linear layers, the optimizer, ...), the peak
device memory, the 25 longest kernels by name, and for Motionformer
``temporal_chain_ms``: the device time of the temporal attention chain,
forward and backward, from CUDA events around it (``ChainTimer``). Needs
a CUDA device.
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
_COMMON_OPTS = [
    "MODEL.NUM_CLASSES", "400", "DATA.NUM_FRAMES", "16",
    "DATA.TRAIN_CROP_SIZE", "224", "DATA.TEST_CROP_SIZE", "224", "TOME.ENABLE", "True",
    "TRAIN.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "8", "TPU.COMPUTE_DTYPE", "bfloat16",
    "SOLVER.OPTIMIZING_METHOD", "adamw", "SOLVER.BASE_LR", "0.0001", "SOLVER.WEIGHT_DECAY", "0.05",
    "SOLVER.LR_POLICY", "steps_with_relative_lrs", "SOLVER.LRS", "[1]", "SOLVER.STEPS", "[0]",
]
# configs/timesformer and configs/vivit train with SGD: momentum 0.9, weight
# decay 1e-4, base learning rate 0.005
_SGD_OPTS = [
    "SOLVER.OPTIMIZING_METHOD", "sgd", "SOLVER.MOMENTUM", "0.9", "SOLVER.BASE_LR", "0.005",
    "SOLVER.WEIGHT_DECAY", "0.0001",
]
STEP_OPTS = {
    "videomae": _COMMON_OPTS + [
        "MODEL.MODEL_NAME", "VideoMAE", "MODEL.ARCH", "videomae",
        "VIDEOMAE.MODEL", "vit_base_patch16_224", "TOME.R_VALUE", "150", "TOME.PROP_ATTN", "False",
    ],
    # trajectory attention, 8 frames of 196 tokens, the tanh pre-logits layer
    "motionformer": _COMMON_OPTS + [
        "MODEL.MODEL_NAME", "Motionformer", "MODEL.ARCH", "motionformer",
        "MOTIONFORMER.USE_MLP", "True", "TOME.R_VALUE", "18", "TOME.PROP_ATTN", "True",
    ],
    # divided space-time attention, 8 frames of 196 patches; SGD as shipped
    "timesformer": _COMMON_OPTS + _SGD_OPTS + [
        "MODEL.MODEL_NAME", "TimeSformer", "MODEL.ARCH", "timesformer", "DATA.NUM_FRAMES", "8",
        "TOME.R_VALUE", "18", "TOME.PROP_ATTN", "True",
    ],
    # 16 x 14 x 14 tubelets + CLS = 3137 tokens; SGD as shipped
    "vivit": _COMMON_OPTS + _SGD_OPTS + [
        "MODEL.MODEL_NAME", "ViViT", "MODEL.ARCH", "vivit", "DATA.NUM_FRAMES", "32",
        "VIVIT.CONFIG_PATH", "configs/vivit/kinetics/tome_vivit_8x32_224.json",
        "TOME.R_VALUE", "300", "TOME.PROP_ATTN", "True",
    ],
}


# (category, substring of the kernel's name), first match wins
_CATEGORIES = (
    ("k5b_blockdiag_bwd_dq", "blockdiag_bwd_dq"),
    ("k5b_blockdiag_bwd_dkdv", "blockdiag_bwd_dkdv"),
    ("k5a_blockdiag_attention_fwd", "blockdiag_attention_fwd"),
    ("k4_frame_bwd_dq", "frame_bwd_dq"),
    ("k4_frame_bwd_dkdv", "frame_bwd_dkdv"),
    ("k3_frame_attention_fwd", "frame_attention_fwd"),
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


class ChainTimer:
    """Device time of Motionformer's temporal attention chain, forward and
    backward, from CUDA events: around each block's ``attn.temporal`` call,
    and in the backward from the moment the gradient of its output exists
    to the moment the gradient of its input does. The spans include any
    idle gap inside them and overlap the categories by kernel name."""

    def __init__(self, module: torch.nn.Module):
        self.spans = {"forward": [], "backward": []}
        for blk in module.blocks:
            if hasattr(blk.attn, "temporal"):
                blk.attn.temporal = self._wrap(blk.attn.temporal)

    @staticmethod
    def _event() -> torch.cuda.Event:
        evt = torch.cuda.Event(enable_timing=True)
        evt.record()
        return evt

    def _wrap(self, temporal):
        def timed(xq, s):
            start = self._event()
            out = temporal(xq, s)
            self.spans["forward"].append((start, self._event()))
            if out.requires_grad and xq.requires_grad:
                span = []
                out.register_hook(lambda g: span.append(self._event()))
                xq.register_hook(lambda g: self.spans["backward"].append((span[0], self._event())))
            return out

        return timed

    def ms_per_step(self, steps: int) -> dict:
        """Call after a synchronise; clears the spans."""
        out = {k: sum(a.elapsed_time(b) for a, b in v) / steps for k, v in self.spans.items()}
        for v in self.spans.values():
            v.clear()
        return out


def trace_program(model: str, label: str, opts, steps: int, warm: int = 3) -> dict:
    cfg = get_cfg()
    cfg.merge_from_list(STEP_OPTS[model] + list(opts))
    trainer = build_trainer(cfg)
    chain = ChainTimer(trainer.module) if model == "motionformer" else None
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

    if chain is not None:
        chain.ms_per_step(1)  # drop the spans of the untraced steps
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
    extra = {} if chain is None else {"temporal_chain_ms": chain.ms_per_step(steps)}
    return dict(
        model=model, program=label, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, **extra,
        step_ms=step_ms, train_clips_per_sec=8 / step_ms * 1e3,
        queued_step_ms=queued_step_ms, kernel_ms=kernel_ms,
        device_idle_share=max(0.0, 1 - kernel_ms / step_ms),
        queued_device_idle_share=max(0.0, 1 - kernel_ms / queued_step_ms),
        kernels_per_step=launches / steps, by_category_ms=by_category,
        top_kernels_ms=[[n[:120], ms / steps] for n, ms in top],
    )


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=sorted(STEP_OPTS), default="videomae")
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
        torch.cuda.reset_peak_memory_stats()
        row = trace_program(args.model, label, list(opts) + args.opts, args.steps)
        print(json.dumps(dict(row, nvidia_smi=smi)), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
