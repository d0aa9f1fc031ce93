"""Data-loading throughput benchmark of the PyTorch package (port of
``tools/benchmark.py``; reference: tools/benchmark.py +
slowfast/utils/benchmark.py:20-103).

    python -m vtm_torch.tools.benchmark --cfg CONFIG.yaml --opts KEY VALUE ...

Iterates the train loader (``TRAIN.DATASET``, ``TRAIN.BATCH_SIZE``,
``DATA_LOADER.NUM_WORKERS``) for ``BENCHMARK.NUM_EPOCHS`` with no model,
logging batches/s every ``BENCHMARK.LOG_PERIOD`` iterations, and returns
(and logs as ``json_stats``) the whole run's batches/s and clips/s by the
host clock and the process's peak RSS. It runs no device code: it measures
the host's loader, which feeds the device in ``train_net``.
"""

from __future__ import annotations

import resource
import time

from vtm_torch.config import assert_and_infer_cfg, load_config, parse_args
from vtm_torch.data import construct_loader, shuffle_dataset
from vtm_torch.utils.logging import get_logger, log_json_stats, setup_logging

logger = get_logger(__name__)


def benchmark_data_loading(cfg) -> dict:
    setup_logging(cfg.OUTPUT_DIR)
    loader = construct_loader(cfg, "train")
    if not cfg.BENCHMARK.SHUFFLE:
        loader.shuffle = False
    total_batches = 0
    total_clips = 0  # actual sizes (multigrid short-cycle batches vary)
    start = time.perf_counter()
    for epoch in range(cfg.BENCHMARK.NUM_EPOCHS):
        shuffle_dataset(loader, epoch)
        epoch_start = time.perf_counter()
        for cur_iter, batch in enumerate(loader):
            total_batches += 1
            total_clips += len(batch["index"])
            if (cur_iter + 1) % cfg.BENCHMARK.LOG_PERIOD == 0:
                log_json_stats(
                    {
                        "split": "data_benchmark_iter",
                        "epoch": epoch,
                        "iter": cur_iter + 1,
                        "batches_per_sec": (cur_iter + 1) / (time.perf_counter() - epoch_start),
                    },
                    logger,
                )
    elapsed = time.perf_counter() - start
    # peak RSS in bytes (the reference reports RAM usage, utils/benchmark.py)
    peak_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    stats = {
        "split": "data_benchmark",
        "total_batches": total_batches,
        "batches_per_sec": total_batches / elapsed,
        "clips_per_sec": total_clips / elapsed,
        "peak_rss_bytes": peak_rss,
    }
    log_json_stats(stats, logger)
    return stats


def main():
    args = parse_args()
    for path in args.cfg_files or [None]:
        cfg = load_config(args, path)
        assert_and_infer_cfg(cfg)
        benchmark_data_loading(cfg)


if __name__ == "__main__":
    main()
