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

One process: a short last batch runs as it is. Under a process group
(``main`` runs one process per CUDA device the test batch can use), the
('data', 'model') mesh of ``TPU.MODEL_PARALLEL``: each data rank evaluates
its rows of each global batch, padded to a multiple of the data width as
``vtm`` pads it; the logits of every rank are gathered in global row
order, the padding dropped, and every rank ensembles the whole batch in
its meter (rank 0 logs and writes the pickles). ``TPU.MODEL_PARALLEL`` > 1
cuts VideoMAE and ViViT (``parallel/sharding.py``; other families raise,
ROADMAP.md Queue 1, item 15). Per-batch generators are then seeded from
(seed, batch, data rank). The logits come to the host as fp32 numpy after
every batch, for the meter. ``WANDB.ENABLE`` logs each sweep entry's stats
with its ``num_views`` (``utils/wandb_utils.py``: a no-op without the
package); ``TENSORBOARD.ENABLE`` opens a ``TensorboardWriter``, which with
``TENSORBOARD.CONFUSION_MATRIX.ENABLE`` adds each sweep entry's confusion
matrix of the per-video predictions; both on rank 0, as in ``vtm``. Model
info is not ported yet and raises.

Detection (``DETECTION.ENABLE``, AVA): one keyframe clip a row (no views),
the batch's boxes through ``make_detection_eval_step``, the per-box scores
with their original boxes and (video, second) into an ``AVAMeter``, which
writes ``detections_latest.csv`` under ``OUTPUT_DIR`` and returns the frame
mAP (``{"split": "test_final", "map": ...}``). It runs in one process, as
``vtm``'s single-device step does.

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
from vtm_torch.eval.meters import AVAMeter, EPICTestMeter, TestMeter
from vtm_torch.models import build_model
from vtm_torch.parallel import launch
from vtm_torch.parallel.mesh import Mesh, entry_device, gather_rows, make_mesh, replicate
from vtm_torch.parallel.sharding import check_tensor_parallel, shard_module
from vtm_torch.tools.train_net import _host, _one_process, _step_generator
from vtm_torch.train.train_step import make_detection_eval_step, make_eval_step
from vtm_torch.utils import wandb_utils
from vtm_torch.utils.logging import get_logger, setup_logging

logger = get_logger(__name__)

SWEEP_VIEWS = [1, 3, 5, 7, 10]  # TEST.NUM_TEMPORAL_CLIPS [-1]


def _unsupported(cfg) -> None:
    """Raise for what the JAX package's test entry point does and this one does not yet."""
    for on, what in (
        (cfg.DETECTION.ENABLE and cfg.TPU.MODEL_PARALLEL > 1,
         "DETECTION.ENABLE with TPU.MODEL_PARALLEL > 1: detection runs in one process, as vtm's "
         "single-device step (ROADMAP.md Queue 1, item 15)"),
        (cfg.LOG_MODEL_INFO, "LOG_MODEL_INFO: parameter and FLOP counts (ROADMAP.md Queue 1, item 4)"),
    ):
        if on:
            raise NotImplementedError(f"{what} is not ported yet")
    check_tensor_parallel(cfg)


def _is_epic(cfg) -> bool:
    return cfg.TEST.DATASET.lower() == "epickitchens" or isinstance(
        cfg.EPICKITCHENS.NUM_CLASSES, (list, tuple)
    )


def perform_test(loader, eval_step, meter, cfg, device: torch.device, mesh: Mesh = Mesh()):
    """Every batch of ``loader`` through ``eval_step``, into ``meter``;
    returns the meter's final stats. Under a data-parallel mesh ``loader``
    yields this rank's rows, and each batch is gathered whole first."""
    is_epic = _is_epic(cfg)
    needs_rng = cfg.TOME.ENABLE and cfg.TOME.MODE in ("random_merge", "random_drop")
    meter.iter_tic()
    for cur_iter, batch in enumerate(loader):
        frames = torch.as_tensor(np.asarray(batch["frames"]), device=device)
        meter.data_toc()
        generator = (_step_generator(device, cfg.RNG_SEED, cur_iter, *mesh.rank_path)
                     if needs_rng else None)
        logits = eval_step(frames, generator)
        if mesh.data > 1:
            logits, batch = gather_rows(mesh, logits, batch)
        else:
            logits = _host(logits)
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


def perform_detection_test(loader, eval_step, meter, device: torch.device):
    """Every batch of the AVA ``loader`` through the detection ``eval_step``
    (frames and the [N, 5] boxes), its per-box scores with the original
    boxes and metadata into the ``AVAMeter``; returns the meter's final
    stats (the frame mAP)."""
    meter.iter_tic()
    for cur_iter, batch in enumerate(loader):
        frames = torch.as_tensor(np.asarray(batch["frames"]), device=device)
        boxes = torch.as_tensor(np.asarray(batch["boxes"], np.float32), device=device)
        meter.data_toc()
        scores = _host(eval_step(frames, boxes))
        meter.iter_toc()
        meter.update_stats(scores, batch["ori_boxes"], batch["metadata"])
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
    detection = cfg.DETECTION.ENABLE
    device = entry_device(device, "test_net", _test_batch(cfg), cfg.TPU.MODEL_PARALLEL)
    _unsupported(cfg)
    if detection:
        _one_process("detection testing")
    # no batch cap: every batch is padded to a multiple of the data width
    mesh = make_mesh(cfg.TPU.MODEL_PARALLEL, device_type=device.type)
    if mesh.rank == 0:
        setup_logging(cfg.OUTPUT_DIR)
    np.random.seed(cfg.RNG_SEED)

    views_list = cfg.TEST.NUM_TEMPORAL_CLIPS or [cfg.TEST.NUM_ENSEMBLE_VIEWS]
    if views_list == [-1]:
        views_list = SWEEP_VIEWS
    tb_writer = None
    if mesh.rank == 0:
        wandb_utils.init(cfg)
        if cfg.TENSORBOARD.ENABLE:
            from vtm_torch.vis.tensorboard_vis import TensorboardWriter

            tb_writer = TensorboardWriter(cfg)
    try:
        results = _test_views(cfg, views_list, device, mesh, tb_writer)
    finally:
        if tb_writer is not None:
            tb_writer.close()
        if mesh.rank == 0:
            wandb_utils.finish()
    for num_view, stats in results:
        logger.info("views=%d -> %s", num_view, stats)
    return results


def _test_views(cfg, views_list, device: torch.device, mesh: Mesh, tb_writer):
    """``test``'s sweep: [(views, stats), ...]."""
    detection = cfg.DETECTION.ENABLE
    results = []
    for num_view in views_list:
        cfg.TEST.NUM_ENSEMBLE_VIEWS = num_view
        bundle = load_test_checkpoint(cfg, build_model(cfg, device))
        if mesh.model > 1:
            shard_module(replicate(mesh, bundle.module), mesh)
        loader = construct_loader(cfg, "test", mesh.data_rank, mesh.data)
        if detection:  # keyframes, not views
            meter = AVAMeter(len(loader), cfg, "test")
            meter.video_idx_to_name = loader.dataset._video_idx_to_name
            stats = perform_detection_test(loader, make_detection_eval_step(bundle.module), meter, device)
            results.append((num_view, stats))
            wandb_utils.log({"num_views": num_view, **stats})
            continue
        eval_step = make_eval_step(bundle.module)
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
                cfg=cfg if mesh.rank == 0 else None,  # it writes TEST.CLIP_LENGTH_HISTOGRAM's file
                multi_label=cfg.DATA.MULTI_LABEL,
            )
        stats = perform_test(loader, eval_step, meter, cfg, device, mesh)
        results.append((num_view, stats))
        if mesh.rank == 0:
            wandb_utils.log({"num_views": num_view, **stats})
        if tb_writer is not None and hasattr(meter, "video_preds"):
            tb_writer.plot_eval(meter.video_preds, meter.video_labels)
        if cfg.TEST.SAVE_RESULTS_PATH and mesh.rank == 0:
            _save_results(meter, cfg.TEST.SAVE_RESULTS_PATH, num_view, len(views_list) > 1)
    return results


def _test_batch(cfg) -> int:
    """The batch that sizes the process group: 1 for detection, which runs
    in one process."""
    return 1 if cfg.DETECTION.ENABLE else cfg.TEST.BATCH_SIZE


def main():
    args = parse_args()
    for path in args.cfg_files or [None]:
        cfg = load_config(args, path)
        assert_and_infer_cfg(cfg)
        launch.run(cfg, test, _test_batch(cfg))


if __name__ == "__main__":
    main()
