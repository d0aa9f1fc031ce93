"""Model visualisation driver of the PyTorch package (port of
``tools/visualization.py``; reference: tools/visualization.py:1-185),
driven by ``TENSORBOARD.MODEL_VIS`` and ``WRONG_PRED_VIS``.

    python -m vtm_torch.tools.visualization --cfg CONFIG.yaml --opts KEY VALUE ...

Up to ``MODEL_VIS.MAX_BATCHES`` test batches, each written to TensorBoard
(``vis/tensorboard_vis.py``): the input video (``INPUT_VIDEO``), a Grad-CAM
overlay for each entry of ``GRAD_CAM.LAYER_LIST`` (the last block, or
``s5``, when empty; ``vis/gradcam.py``), the named layers' activation
histograms (``ACTIVATIONS`` with ``LAYER_LIST``; ``vis/activations.py``),
top-k prediction figures (``TOPK_PREDS``) and the wrongly predicted clips
(``WRONG_PRED_VIS``); parameter histograms once (``MODEL_WEIGHTS``, under
the port's parameter names). The weights come from ``load_test_checkpoint``.
Needs the ``tensorboard`` package, and matplotlib for the Grad-CAM overlay
and the top-k figures.

Runs on the first CUDA device; a machine without one raises. The CPU
(``device="cpu"``) is for tests only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vtm_torch.checkpoints.checkpoint import load_test_checkpoint
from vtm_torch.config import assert_and_infer_cfg, load_config, parse_args
from vtm_torch.data import construct_loader
from vtm_torch.models import build_model
from vtm_torch.parallel.mesh import entry_device
from vtm_torch.train.train_step import make_eval_step
from vtm_torch.utils.logging import get_logger, setup_logging
from vtm_torch.vis.activations import get_activations, plot_topk_histogram, process_layer_index_data
from vtm_torch.vis.gradcam import GradCAM
from vtm_torch.vis.tensorboard_vis import TensorboardWriter

logger = get_logger(__name__)


def _to01(frames: np.ndarray) -> np.ndarray:
    lo, hi = frames.min(), frames.max()
    return (frames - lo) / max(hi - lo, 1e-8)


def log_model_weights(module: torch.nn.Module, writer: TensorboardWriter) -> None:
    """Parameter histograms (reference plot_weights_and_activations)."""
    for name, param in module.named_parameters():
        writer.writer.add_histogram(f"weights/{name}", param.detach().float().cpu().numpy())


def run_visualization(cfg, device: Optional[torch.device | str] = None) -> None:
    device = entry_device(device, "visualization", cfg.TEST.BATCH_SIZE)
    setup_logging(cfg.OUTPUT_DIR)
    bundle = load_test_checkpoint(cfg, build_model(cfg, device))
    writer = TensorboardWriter(cfg)
    try:
        _visualize(cfg, bundle, writer, device)
    finally:
        writer.close()
    logger.info("visualization written to tensorboard")


def _visualize(cfg, bundle, writer: TensorboardWriter, device: torch.device) -> None:
    mv = cfg.TENSORBOARD.MODEL_VIS
    if mv.MODEL_WEIGHTS:
        log_model_weights(bundle.module, writer)
    loader = construct_loader(cfg, "test")
    cams = []
    if mv.GRAD_CAM.ENABLE:
        # every entry of GRAD_CAM.LAYER_LIST gets its own overlay pass
        for layer in mv.GRAD_CAM.LAYER_LIST or [None]:
            cams.append((layer, GradCAM(bundle, target_layer=layer, colormap=mv.GRAD_CAM.COLORMAP)))
    act_layers, act_indexing = [], {}
    if mv.ACTIVATIONS:
        act_layers, act_indexing = process_layer_index_data(mv.LAYER_LIST)
    eval_step = make_eval_step(bundle.module)

    wrong_tag = cfg.TENSORBOARD.WRONG_PRED_VIS.TAG
    for bi, batch in enumerate(loader):
        if bi >= mv.MAX_BATCHES:
            break
        frames = np.asarray(batch["frames"])
        if mv.INPUT_VIDEO:
            writer.add_video(_to01(frames), tag="Video Input", global_step=bi)
        preds = None
        for layer, cam in cams:
            maps, preds = cam.localization_map(frames)
            overlays = np.stack([cam.overlay(_to01(frames[i]), maps[i]) for i in range(len(frames))])
            tag = "GradCAM" if layer is None else f"GradCAM/{layer}"
            writer.add_video(overlays.astype(np.float32) / 255.0, tag=tag, global_step=bi)
        if mv.ACTIVATIONS:
            acts, preds = get_activations(bundle, frames, act_layers, indexing=act_indexing)
            for name, arr in acts.items():
                writer.writer.add_histogram(f"activations/{name}", np.asarray(arr), global_step=bi)
        if preds is None:
            logits = eval_step(torch.as_tensor(frames, device=device))
            preds = (logits[0] if isinstance(logits, tuple) else logits).float().cpu().numpy()
        if mv.TOPK_PREDS:
            for i in range(len(preds)):
                fig = plot_topk_histogram("Top-k predictions", preds[i], k=min(mv.TOPK_PREDS, preds.shape[-1]))
                writer.writer.add_figure(f"topk_preds/batch{bi}", fig, global_step=i)
        if cfg.TENSORBOARD.WRONG_PRED_VIS.ENABLE and not isinstance(batch["label"], dict):
            wrong = preds.argmax(axis=-1) != np.asarray(batch["label"])
            if wrong.any():
                writer.add_video(_to01(frames[wrong]), tag=wrong_tag, global_step=bi)


def main():
    args = parse_args()
    for path in args.cfg_files or [None]:
        cfg = load_config(args, path)
        assert_and_infer_cfg(cfg)
        run_visualization(cfg)


if __name__ == "__main__":
    main()
