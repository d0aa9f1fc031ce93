"""Multi-view test entry point of the PyTorch package (port of ``tools/test_net.py``).

    python -m vtm_torch.tools.test_net --cfg CONFIG.yaml --opts KEY VALUE ...

``test(cfg)``: for each entry of ``TEST.NUM_TEMPORAL_CLIPS`` (``[-1]``
sweeps 1, 3, 5, 7 and 10 views; empty means ``TEST.NUM_ENSEMBLE_VIEWS``)
build the model, load its weights (``load_test_checkpoint``: the test
checkpoint, else the last one of ``OUTPUT_DIR``, then the train
checkpoint, else the seeded init), run every clip of the test set
(``NUM_ENSEMBLE_VIEWS`` x ``NUM_SPATIAL_CROPS`` a video) through the eval
step, and ensemble each video's clips in a ``TestMeter`` (top-1/5) or, for
the EPIC-KITCHENS verb/noun heads, an ``EPICTestMeter`` (verb, noun and
action top-1/5). For ``TOME.MODE`` ``random_merge`` and ``random_drop``
each batch's forward draws from its own generator, seeded from
(``RNG_SEED``, batch index), so a test run repeats. Returns
``[(views, stats), ...]``;
``TEST.SAVE_RESULTS_PATH`` also pickles each sweep entry's per-video
predictions and labels, suffixed ``_views{n}`` when there are several.

One device: no mesh, and a short last batch runs as it is. The logits come
to the host as fp32 numpy after every batch, for the meter. Detection
(AVA), tensor parallelism, model info, tensorboard and wandb are not
ported yet and raise.

Runs on the first CUDA device; a machine without one raises. The CPU
(``device="cpu"``, plain versions of the kernels) is for tests only.
"""

from __future__ import annotations

import pickle
from typing import Optional

import numpy as np
import torch

from vtm_torch.checkpoints.checkpoint import load_test_checkpoint
from vtm_torch.config import assert_and_infer_cfg, load_config, parse_args
from vtm_torch.data import construct_loader
from vtm_torch.eval.meters import EPICTestMeter, TestMeter
from vtm_torch.models import build_model
from vtm_torch.tools.train_net import _host, _step_generator
from vtm_torch.train.train_step import make_eval_step
from vtm_torch.utils.logging import get_logger, setup_logging

logger = get_logger(__name__)

SWEEP_VIEWS = [1, 3, 5, 7, 10]  # TEST.NUM_TEMPORAL_CLIPS [-1]


def _unsupported(cfg) -> None:
    """Raise for what the JAX package's test entry point does and this one does not yet."""
    for on, what in (
        (cfg.DETECTION.ENABLE, "DETECTION.ENABLE: AVA detection testing (ROADMAP.md Queue 1, item 12)"),
        (cfg.TPU.MODEL_PARALLEL > 1, "TPU.MODEL_PARALLEL > 1: tensor parallelism (ROADMAP.md Queue 1, item 10)"),
        (cfg.LOG_MODEL_INFO, "LOG_MODEL_INFO: parameter and FLOP counts (ROADMAP.md Queue 1, item 4)"),
        (cfg.TENSORBOARD.ENABLE, "TENSORBOARD.ENABLE: the tensorboard writer (ROADMAP.md Queue 1, item 12)"),
        (cfg.WANDB.ENABLE, "WANDB.ENABLE: wandb logging (ROADMAP.md Queue 1, item 9b)"),
    ):
        if on:
            raise NotImplementedError(f"{what} is not ported yet")


def _is_epic(cfg) -> bool:
    return cfg.TEST.DATASET.lower() == "epickitchens" or isinstance(
        cfg.EPICKITCHENS.NUM_CLASSES, (list, tuple)
    )


def perform_test(loader, eval_step, meter, cfg, device: torch.device):
    """Every batch of ``loader`` through ``eval_step``, into ``meter``;
    returns the meter's final stats."""
    is_epic = _is_epic(cfg)
    needs_rng = cfg.TOME.ENABLE and cfg.TOME.MODE in ("random_merge", "random_drop")
    meter.iter_tic()
    for cur_iter, batch in enumerate(loader):
        frames = torch.as_tensor(np.asarray(batch["frames"]), device=device)
        meter.data_toc()
        generator = _step_generator(device, cfg.RNG_SEED, cur_iter) if needs_rng else None
        logits = _host(eval_step(frames, generator))
        meter.iter_toc()
        if is_epic:
            metadata = batch.get("metadata")
            meter.update_stats(
                logits,
                (batch["label"]["verb"], batch["label"]["noun"]),
                metadata.get("narration_id") if isinstance(metadata, dict) else None,
                batch["index"],
            )
        else:
            meter.update_stats(logits, batch["label"], batch["index"])
        meter.log_iter_stats(cur_iter)
        meter.iter_tic()
    return meter.finalize_metrics()


def _save_results(meter, save_path: str, num_view: int, sweep: bool) -> None:
    if sweep:  # one file per sweep entry: a bare path would be overwritten
        root, dot, ext = save_path.rpartition(".")
        save_path = f"{root}_views{num_view}.{ext}" if dot else f"{save_path}_views{num_view}"
    if isinstance(meter, EPICTestMeter):
        payload = {
            "verb": meter.verb_preds,
            "noun": meter.noun_preds,
            "verb_labels": meter.verb_labels,
            "noun_labels": meter.noun_labels,
        }
    else:
        payload = {"preds": meter.video_preds, "labels": meter.video_labels}
    with open(save_path, "wb") as f:
        pickle.dump(payload, f)


def test(cfg, device: Optional[torch.device | str] = None):
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("test_net needs a CUDA device and found none")
        device = "cuda"
    device = torch.device(device)
    _unsupported(cfg)
    setup_logging(cfg.OUTPUT_DIR)
    np.random.seed(cfg.RNG_SEED)

    views_list = cfg.TEST.NUM_TEMPORAL_CLIPS or [cfg.TEST.NUM_ENSEMBLE_VIEWS]
    if views_list == [-1]:
        views_list = SWEEP_VIEWS
    results = []
    for num_view in views_list:
        cfg.TEST.NUM_ENSEMBLE_VIEWS = num_view
        bundle = load_test_checkpoint(cfg, build_model(cfg, device))
        eval_step = make_eval_step(bundle.module)

        loader = construct_loader(cfg, "test")
        num_clips = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        if len(loader.dataset) % num_clips != 0:
            raise ValueError(
                f"test dataset size {len(loader.dataset)} is not divisible by "
                f"NUM_ENSEMBLE_VIEWS*NUM_SPATIAL_CROPS={num_clips}; check the "
                "test csv / annotations"
            )
        num_videos = len(loader.dataset) // num_clips
        if _is_epic(cfg):
            ncls = tuple(cfg.EPICKITCHENS.NUM_CLASSES or (97, 300))
            meter = EPICTestMeter(num_videos, num_clips, ncls, len(loader))
        else:
            meter = TestMeter(
                num_videos,
                num_clips,
                cfg.MODEL.NUM_CLASSES,
                len(loader),
                cfg.DATA.ENSEMBLE_METHOD,
                cfg=cfg,
                multi_label=cfg.DATA.MULTI_LABEL,
            )
        stats = perform_test(loader, eval_step, meter, cfg, device)
        results.append((num_view, stats))
        if cfg.TEST.SAVE_RESULTS_PATH:
            _save_results(meter, cfg.TEST.SAVE_RESULTS_PATH, num_view, len(views_list) > 1)
    for num_view, stats in results:
        logger.info("views=%d -> %s", num_view, stats)
    return results


def main():
    args = parse_args()
    for path in args.cfg_files or [None]:
        cfg = load_config(args, path)
        assert_and_infer_cfg(cfg)
        test(cfg)


if __name__ == "__main__":
    main()
