"""Webcam / file demo of the PyTorch package (port of ``tools/demo_net.py``),
driven by ``DEMO.*``.

    python -m vtm_torch.tools.demo_net --cfg CONFIG.yaml --opts DEMO.INPUT_VIDEO in.mp4 DEMO.OUTPUT_FILE out.mp4

Reads clips from ``DEMO.INPUT_VIDEO`` or ``DEMO.WEBCAM`` (``ThreadVideoManager``
under ``DEMO.THREAD_ENABLE``), runs the (optionally token-merged) model's
eval step on each (``vis/demo.py::Predictor``), draws top-k predictions on
the frames and writes them to ``DEMO.OUTPUT_FILE`` or the screen. With
``DEMO.NUM_VIS_INSTANCES`` > 1 the drawing fans out to that many spawned
worker processes (``vis/async_predictor.py::AsyncVis``), which get numpy
frames and predictions and never touch CUDA. Returns the clips shown.

Runs on the first CUDA device; a machine without one raises. The CPU
(``device="cpu"``) is for tests only.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from vtm_torch.config import assert_and_infer_cfg, load_config, parse_args
from vtm_torch.parallel.mesh import entry_device
from vtm_torch.utils.logging import get_logger, setup_logging
from vtm_torch.vis.demo import Predictor, ThreadVideoManager, VideoManager, draw_predictions, load_class_names

logger = get_logger(__name__)


def run_demo(cfg, device: Optional[torch.device | str] = None) -> int:
    device = entry_device(device, "demo_net", 1)
    setup_logging(cfg.OUTPUT_DIR)
    predictor = Predictor(cfg, device=device)
    class_names = load_class_names(cfg.DEMO.LABEL_FILE_PATH)
    manager_cls = ThreadVideoManager if cfg.DEMO.THREAD_ENABLE else VideoManager
    manager = manager_cls(cfg).start()

    async_vis = None
    if cfg.DEMO.NUM_VIS_INSTANCES > 1:
        from vtm_torch.vis.async_predictor import AsyncVis
        from vtm_torch.vis.video_visualizer import VideoVisualizer

        video_vis = VideoVisualizer(
            num_classes=cfg.MODEL.NUM_CLASSES,
            class_names=class_names,
            top_k=cfg.DEMO.VIS_TOPK,
            thres=cfg.DEMO.COMMON_CLASS_THRES,
            mode="thres" if cfg.DEMO.VIS_MODE == "thres" else "top-k",
            lower_thres=cfg.DEMO.UNCOMMON_CLASS_THRES,
            common_class_names=cfg.DEMO.COMMON_CLASS_NAMES,
        )
        async_vis = AsyncVis(video_vis, n_workers=cfg.DEMO.NUM_VIS_INSTANCES)

    num_tasks = 0
    try:
        pending = 0
        for task_idx, task in enumerate(manager):
            if cfg.DEMO.NUM_CLIPS_SKIP and task_idx % (cfg.DEMO.NUM_CLIPS_SKIP + 1):
                continue
            task = predictor(task)
            if async_vis is not None:
                task.add_action_preds(task.preds)
                # AsyncVis.put() numbers the tasks itself (NUM_CLIPS_SKIP
                # leaves holes in the manager's ids)
                async_vis.put(task)
                pending += 1
                while pending:
                    try:
                        done = async_vis.get()
                    except IndexError:
                        break
                    manager.display(done)
                    pending -= 1
                    num_tasks += 1
            else:
                task = draw_predictions(task, class_names, k=cfg.DEMO.VIS_TOPK)
                manager.display(task)
                num_tasks += 1
        if async_vis is not None:
            deadline = time.time() + 60
            while pending and time.time() < deadline:
                try:
                    done = async_vis.get()
                except IndexError:
                    time.sleep(0.02)
                    continue
                manager.display(done)
                pending -= 1
                num_tasks += 1
    finally:
        if async_vis is not None:
            async_vis.shutdown()
        manager.join()
        manager.clean()
    logger.info("demo processed %d clips", num_tasks)
    return num_tasks


def main():
    args = parse_args()
    for path in args.cfg_files or [None]:
        cfg = load_config(args, path)
        assert_and_infer_cfg(cfg)
        run_demo(cfg)


if __name__ == "__main__":
    main()
