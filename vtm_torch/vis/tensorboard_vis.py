"""TensorBoard writer (copy of ``vtm/vis/tensorboard_vis.py``; reference:
slowfast/visualization/tensorboard_vis.py TensorboardWriter:20-234 +
visualization/utils.py confusion-matrix helpers). Scalars, per-epoch
confusion matrices, and input-video summaries; everything is host-side
numpy/matplotlib. ``torch.utils.tensorboard`` (the ``tensorboard``
package) is imported when a writer is made, matplotlib when a figure is
drawn: without them those calls raise ImportError, as in ``vtm``."""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from vtm_torch.utils.logging import get_logger

logger = get_logger(__name__)


def get_confusion_matrix(
    preds: np.ndarray, labels: np.ndarray, num_classes: int, normalize: str = "true"
) -> np.ndarray:
    """Row-normalised confusion matrix from [N, C] scores and [N] labels
    (reference visualization/utils.py:18-47)."""
    pred_cls = preds.argmax(axis=-1)
    cm = np.zeros((num_classes, num_classes), dtype=np.float64)
    np.add.at(cm, (labels.astype(int), pred_cls.astype(int)), 1.0)
    if normalize == "true":
        with np.errstate(invalid="ignore", divide="ignore"):
            cm = cm / cm.sum(axis=1, keepdims=True)
        cm = np.nan_to_num(cm)
    return cm


def plot_confusion_matrix(cm: np.ndarray, num_classes: int, class_names=None, figsize=None):
    """matplotlib Figure of a confusion matrix
    (reference visualization/utils.py:50-91)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if class_names is None or not isinstance(class_names, list):
        class_names = [str(i) for i in range(num_classes)]
    elif len(class_names) != num_classes:
        # a mismatched names file (e.g. full-Kinetics names with a
        # subset head) would crash set_xticklabels at the end of a full
        # eval — truncate/pad instead
        class_names = (
            class_names[:num_classes]
            + [str(i) for i in range(len(class_names), num_classes)]
        )
    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(1, 1, 1)
    im = ax.imshow(cm, interpolation="nearest", cmap=plt.cm.Blues)
    fig.colorbar(im)
    ax.set(
        xticks=np.arange(num_classes),
        yticks=np.arange(num_classes),
        xlabel="Predicted label",
        ylabel="True label",
        title="Confusion matrix",
    )
    if num_classes <= 40:
        ax.set_xticklabels(class_names, rotation=45, ha="right")
        ax.set_yticklabels(class_names)
        thresh = cm.max() / 2.0 if cm.size else 0.5
        for i in range(num_classes):
            for j in range(num_classes):
                ax.text(
                    j, i, format(cm[i, j], ".2f") if cm[i, j] != 0 else ".",
                    ha="center", va="center",
                    color="white" if cm[i, j] > thresh else "black",
                )
    fig.tight_layout()
    return fig


class TensorboardWriter:
    """Wraps torch.utils.tensorboard.SummaryWriter; enabled by
    ``TENSORBOARD.ENABLE`` (log dir: ``TENSORBOARD.LOG_DIR`` or
    ``runs-<dataset>`` under OUTPUT_DIR, reference :25-88)."""

    def __init__(self, cfg):
        from torch.utils.tensorboard import SummaryWriter

        self.cfg = cfg
        log_dir = (
            os.path.join(cfg.OUTPUT_DIR, cfg.TENSORBOARD.LOG_DIR)
            if cfg.TENSORBOARD.LOG_DIR
            else os.path.join(cfg.OUTPUT_DIR, f"runs-{cfg.TEST.DATASET}")
        )
        self.writer = SummaryWriter(log_dir=log_dir)
        self.class_names: Optional[Sequence[str]] = None
        if cfg.TENSORBOARD.CLASS_NAMES_PATH:
            with open(cfg.TENSORBOARD.CLASS_NAMES_PATH) as f:
                self.class_names = [ln.strip() for ln in f if ln.strip()]
        logger.info("TensorBoard -> %s", log_dir)

    def add_scalars(self, data_dict: dict, global_step: Optional[int] = None):
        for k, v in data_dict.items():
            self.writer.add_scalar(k, v, global_step)

    def plot_eval(self, preds: np.ndarray, labels: np.ndarray, global_step=None):
        """Confusion matrix of full-set predictions (reference :101-168)."""
        if not self.cfg.TENSORBOARD.CONFUSION_MATRIX.ENABLE:
            return
        num_classes = self.cfg.MODEL.NUM_CLASSES
        cm = get_confusion_matrix(np.asarray(preds), np.asarray(labels), num_classes)
        fig = plot_confusion_matrix(
            cm,
            num_classes,
            self.class_names,
            figsize=self.cfg.TENSORBOARD.CONFUSION_MATRIX.FIGSIZE,
        )
        self.writer.add_figure("Confusion Matrix", fig, global_step=global_step)

    def add_video(self, vid: np.ndarray, tag: str = "Video Input", global_step=None, fps=4):
        """vid: [B, T, H, W, C] float in [0,1] -> NTCHW uint8."""
        import torch

        v = torch.from_numpy(np.asarray(vid)).permute(0, 1, 4, 2, 3)
        self.writer.add_video(tag, v, global_step=global_step, fps=fps)

    def flush(self):
        self.writer.flush()

    def close(self):
        self.writer.flush()
        self.writer.close()
