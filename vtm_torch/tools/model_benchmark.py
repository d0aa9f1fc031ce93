"""Model throughput benchmark on the PyTorch package.

    python -m vtm_torch.tools.model_benchmark --cfg CONFIG.yaml --opts KEY VALUE ...

Random input batches of ``TEST.BATCH_SIZE`` clips, warm-up, then
``MODEL_BENCHMARK.ITERATIONS`` timed forwards (CUDA events). Prints one
``json_stats:`` line with the JAX tool's keys (avg_frame_time_ms, fps,
clips_per_sec, batch_size, iterations) plus the kernel launches per
forward, ``attention_kernel_launches`` (K1, dense attention),
``frame_attention_kernel_launches`` (K3, per-frame attention) and
``blockdiag_attention_kernel_launches`` (K5a, block-diagonal attention),
and ``device``. VideoMAE, Motionformer, TimeSformer and ViViT are ported.

Runs on the first CUDA device; a machine without one raises. The CPU
(``device="cpu"``, plain versions of the kernels) is for tests only.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from vtm_torch.checkpoints.convert import (
    load_motionformer_state_dict,
    load_timesformer_state_dict,
    load_torch_state_dict,
    load_videomae_state_dict,
    load_vivit_state_dict,
)
from vtm_torch.config import assert_and_infer_cfg, load_config, parse_args
from vtm_torch.models import ModelBundle, build_model
from vtm_torch.ops import flash_attention
from vtm_torch.utils.benchmark import device_seconds


def _load_timesformer(sd, config):
    return load_timesformer_state_dict(
        sd, num_frames=config.num_frames, spatial_tokens=config.spatial_tokens,
        divided=config.attention_type == "divided_space_time",
    )


# model name -> f(state dict as loaded, the module's config) -> the port's state dict
CHECKPOINT_LOADERS = {
    "VideoMAE": lambda sd, config: load_videomae_state_dict(sd),
    "Motionformer": lambda sd, config: load_motionformer_state_dict(sd),
    "TimeSformer": _load_timesformer,
    "ViViT": lambda sd, config: load_vivit_state_dict(sd),
}


def load_test_checkpoint(cfg, bundle: ModelBundle) -> ModelBundle:
    """Load ``TEST.CHECKPOINT_FILE_PATH`` into the bundle's module. An
    empty path keeps the random weights drawn from ``RNG_SEED``."""
    path = cfg.TEST.CHECKPOINT_FILE_PATH
    if not path:
        return bundle
    if not os.path.isfile(path):
        raise FileNotFoundError(f"TEST.CHECKPOINT_FILE_PATH {path!r} does not exist")
    if bundle.name not in CHECKPOINT_LOADERS:
        raise NotImplementedError(f"no checkpoint converter for {bundle.name}")
    sd = CHECKPOINT_LOADERS[bundle.name](load_torch_state_dict(path), bundle.module.config)
    bundle.module.load_state_dict(sd)
    return bundle


def _per_forward(x: float):
    return int(x) if x.is_integer() else x


def perform_benchmark(module: torch.nn.Module, cfg, device: torch.device) -> dict:
    batch = cfg.TEST.BATCH_SIZE
    t = cfg.DATA.NUM_FRAMES
    s = cfg.DATA.TEST_CROP_SIZE
    rng = np.random.default_rng(cfg.RNG_SEED)
    video = torch.from_numpy(rng.random((batch, t, s, s, 3), dtype=np.float32)).to(device)
    iters = max(1, cfg.MODEL_BENCHMARK.ITERATIONS)
    warmup = max(1, cfg.MODEL_BENCHMARK.WARMUP_ITERATIONS)

    counters = ("LAUNCHES", "FRAME_LAUNCHES", "BLOCKDIAG_LAUNCHES")
    before = [getattr(flash_attention, c) for c in counters]
    with torch.inference_mode():
        elapsed = device_seconds(lambda: module(video), iters, warmup, device)
    forwards = warmup + iters
    launches, frame_launches, blockdiag_launches = (
        (getattr(flash_attention, c) - n) / forwards for c, n in zip(counters, before)
    )

    frame_time_ms = elapsed / (batch * t * iters) * 1000.0
    return {
        "split": "model_benchmark",
        "avg_frame_time_ms": frame_time_ms,
        "fps": 1000.0 / frame_time_ms,
        "clips_per_sec": batch * iters / elapsed,
        "batch_size": batch,
        "iterations": iters,
        "attention_kernel_launches": _per_forward(launches),
        "frame_attention_kernel_launches": _per_forward(frame_launches),
        "blockdiag_attention_kernel_launches": _per_forward(blockdiag_launches),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }


def model_benchmark(cfg, device: torch.device | str | None = None) -> dict:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("model_benchmark needs a CUDA device and found none")
        device = "cuda"
    device = torch.device(device)
    if cfg.MODEL_BENCHMARK.TRACE_DIR:
        raise NotImplementedError("MODEL_BENCHMARK.TRACE_DIR: profiler traces are not ported yet")
    bundle = load_test_checkpoint(cfg, build_model(cfg, device))
    stats = perform_benchmark(bundle.module, cfg, device)
    print("json_stats: " + json.dumps(stats, sort_keys=True), flush=True)
    return stats


def main():
    args = parse_args()
    for path in args.cfg_files or [None]:
        cfg = load_config(args, path)
        assert_and_infer_cfg(cfg)
        model_benchmark(cfg)


if __name__ == "__main__":
    main()
