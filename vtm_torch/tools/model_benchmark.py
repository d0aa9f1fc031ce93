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
The weights come from ``load_test_checkpoint``: ``TEST.CHECKPOINT_FILE_PATH``,
else the last checkpoint of ``OUTPUT_DIR``, then ``TRAIN.CHECKPOINT_FILE_PATH``,
else the seeded init.

With ``MODEL_BENCHMARK.TRACE_DIR`` set, one more forward runs after the
timed ones under ``torch.profiler`` (CPU activity, and CUDA activity on
the card) and its Chrome trace is written to ``TRACE_FILE`` in that
directory; the statistics then carry ``trace_dir`` and ``trace_file``. The
launch counts do not include that forward. Unlike ``vtm``, which logs a
failed trace and goes on, a failed trace raises here.

Parallelism: ``main`` runs one process per CUDA device the test batch can
use (``parallel.launch.run``), over the ('data', 'model') mesh of
``TPU.MODEL_PARALLEL``, the placement ``test_net`` uses: each data rank
times its rows of the batch (VideoMAE and ViViT cut for tensor
parallelism), and clips/s is the whole batch over the slowest rank's
CUDA-event time. The statistics then also carry ``ranks``,
``data_parallel`` and ``model_parallel``; launches are this process's
per forward, rank 0 prints the line, and a trace is written by each rank
(rank r > 0 suffixes its file with ``_rank{r}``).

Runs on the first CUDA device; a machine without one raises. The CPU
(``device="cpu"``, plain versions of the kernels) is for tests only.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from vtm_torch.checkpoints.checkpoint import load_test_checkpoint
from vtm_torch.config import assert_and_infer_cfg, load_config, parse_args
from vtm_torch.models import build_model
from vtm_torch.ops import flash_attention
from vtm_torch.parallel import launch
from vtm_torch.parallel.mesh import Mesh, all_max, entry_device, make_mesh, replicate, shard_batch
from vtm_torch.parallel.sharding import check_tensor_parallel, shard_module
from vtm_torch.utils.benchmark import device_seconds
from vtm_torch.utils.logging import get_logger

logger = get_logger(__name__)

TRACE_FILE = "model_benchmark_trace.json"


def _per_forward(x: float):
    return int(x) if x.is_integer() else x


def perform_benchmark(module: torch.nn.Module, cfg, device: torch.device, mesh: Mesh = Mesh()) -> dict:
    batch = cfg.TEST.BATCH_SIZE
    t = cfg.DATA.NUM_FRAMES
    s = cfg.DATA.TEST_CROP_SIZE
    rng = np.random.default_rng(cfg.RNG_SEED)
    video = shard_batch(mesh, rng.random((batch, t, s, s, 3), dtype=np.float32))
    video = torch.from_numpy(video).to(device)
    iters = max(1, cfg.MODEL_BENCHMARK.ITERATIONS)
    warmup = max(1, cfg.MODEL_BENCHMARK.WARMUP_ITERATIONS)

    counters = ("LAUNCHES", "FRAME_LAUNCHES", "BLOCKDIAG_LAUNCHES")
    before = [getattr(flash_attention, c) for c in counters]
    with torch.inference_mode():
        elapsed = all_max(device_seconds(lambda: module(video), iters, warmup, device), device)
    forwards = warmup + iters
    launches, frame_launches, blockdiag_launches = (
        (getattr(flash_attention, c) - n) / forwards for c, n in zip(counters, before)
    )

    frame_time_ms = elapsed / (batch * t * iters) * 1000.0
    stats = {
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
    if mesh.world > 1:
        stats.update(ranks=mesh.world, data_parallel=mesh.data, model_parallel=mesh.model)
    if cfg.MODEL_BENCHMARK.TRACE_DIR:
        stats["trace_dir"] = cfg.MODEL_BENCHMARK.TRACE_DIR
        name = TRACE_FILE if mesh.rank == 0 else TRACE_FILE.replace(".json", f"_rank{mesh.rank}.json")
        stats["trace_file"] = trace_forward(module, video, cfg.MODEL_BENCHMARK.TRACE_DIR, name)
    return stats


def trace_forward(module: torch.nn.Module, video: torch.Tensor, trace_dir: str, name: str = TRACE_FILE) -> str:
    """One forward under ``torch.profiler``, written as a Chrome trace
    ``name`` into ``trace_dir`` (made if missing); returns the file's path."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if video.is_cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.inference_mode(), torch.profiler.profile(activities=activities) as prof:
        module(video)
        if video.is_cuda:
            torch.cuda.synchronize(video.device)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, name)
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)
    return path


def model_benchmark(cfg, device: torch.device | str | None = None) -> dict:
    device = entry_device(device, "model_benchmark", cfg.TEST.BATCH_SIZE, cfg.TPU.MODEL_PARALLEL)
    check_tensor_parallel(cfg)
    mesh = make_mesh(cfg.TPU.MODEL_PARALLEL, batch_cap=cfg.TEST.BATCH_SIZE, device_type=device.type)
    bundle = load_test_checkpoint(cfg, build_model(cfg, device))
    if mesh.model > 1:
        shard_module(replicate(mesh, bundle.module), mesh)
    stats = perform_benchmark(bundle.module, cfg, device, mesh)
    if mesh.rank == 0:
        print("json_stats: " + json.dumps(stats, sort_keys=True), flush=True)
    return stats


def main():
    args = parse_args()
    for path in args.cfg_files or [None]:
        cfg = load_config(args, path)
        assert_and_infer_cfg(cfg)
        launch.run(cfg, model_benchmark, cfg.TEST.BATCH_SIZE)


if __name__ == "__main__":
    main()
