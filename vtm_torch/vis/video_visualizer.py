"""Box/label drawing for demo output (copy of ``vtm/vis/video_visualizer.py``).

Functional parity target: slowfast/visualization/video_visualizer.py.
The fork STRIPPED upstream's VideoVisualizer down to
``_create_text_labels`` (:17-40) — its own demo/async pipelines call
``video_vis.draw_clip_range`` which no longer exists, so they crash.
Like the ROI head, this module restores the upstream PySlowFast
semantics (label text creation, top-k/thresh prediction selection,
per-frame cv2 box + caption drawing over a clip range) so the demo
surface actually works.

The box colours come from the ``colormap`` resampled to ``num_classes``
entries, as matplotlib's ``get_cmap(colormap, num_classes)`` gives them.
The default "rainbow" is computed here from matplotlib's definition of it
(``rainbow_colors``), so that boxes are drawn without matplotlib; another
colormap imports matplotlib when the first box is drawn.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from vtm_torch.utils.logging import get_logger

logger = get_logger(__name__)


def rainbow_colors(n: int) -> np.ndarray:
    """[n, 4] RGBA: matplotlib's "rainbow" resampled to n entries
    (``matplotlib._cm``: red |2x - 0.5|, green sin(pi x), blue cos(pi x / 2),
    each clipped to [0, 1], at x = linspace(0, 1, n))."""
    x = np.linspace(0, 1, n)
    rgb = np.clip(np.stack([np.abs(2 * x - 0.5), np.sin(x * np.pi), np.cos(x * np.pi / 2)], axis=1), 0, 1)
    return np.concatenate([rgb, np.ones((n, 1))], axis=1)


def _create_text_labels(classes, scores, class_names, ground_truth=False):
    """Reference video_visualizer.py:17-40 (verbatim semantics)."""
    try:
        labels = [class_names[i] for i in classes]
    except IndexError:
        logger.error("Class indices get out of range: %s", classes)
        return None
    if ground_truth:
        labels = ["[{}] {}".format("GT", label) for label in labels]
    elif scores is not None:
        assert len(classes) == len(scores)
        labels = [
            "[{:.2f}] {}".format(s, label) for s, label in zip(scores, labels)
        ]
    return labels


class VideoVisualizer:
    """Upstream-style clip annotator: picks top-k (or thresholded)
    predictions and draws boxes + captions on the frames inside
    ``draw_range``."""

    def __init__(self, num_classes: int, class_names: Optional[List[str]] = None,
                 top_k: int = 1, thres: float = 0.7, mode: str = "top-k",
                 colormap: str = "rainbow", lower_thres: float = 0.3,
                 common_class_names: Optional[List[str]] = None):
        assert mode in ("top-k", "thres")
        self.num_classes = num_classes
        self.class_names = class_names or [str(i) for i in range(num_classes)]
        self.top_k = top_k
        self.thres = thres
        self.mode = mode
        # dual-threshold labelling (upstream PySlowFast semantics the
        # reference fork's gutted visualizer dropped; DEMO.
        # COMMON_CLASS_NAMES / UNCOMMON_CLASS_THRES): frequent classes
        # require `thres`, everything else the lower threshold
        self.lower_thres = lower_thres
        if common_class_names:
            common = set(common_class_names)
            self.common_class_ids = [
                i for i, n in enumerate(self.class_names) if n in common
            ]
        else:
            self.common_class_ids = None
        self.colormap = colormap
        self._colors = None

    def cmap(self, class_id: int):
        """The RGBA colour of a class's boxes."""
        if self._colors is None:
            if self.colormap == "rainbow":
                self._colors = rainbow_colors(self.num_classes)
            else:
                import matplotlib.pyplot as plt

                cmap = plt.get_cmap(self.colormap, self.num_classes)
                self._colors = np.asarray([cmap(i) for i in range(self.num_classes)])
        return tuple(self._colors[class_id])

    def _labels_for(self, preds) -> List[str]:
        preds = np.asarray(preds).reshape(-1)
        if self.mode == "top-k":
            idx = np.argsort(-preds)[: self.top_k]
        elif self.common_class_ids is not None:
            thr = np.full(preds.shape, self.lower_thres)
            thr[self.common_class_ids] = self.thres
            idx = np.nonzero(preds >= thr)[0]
        else:
            idx = np.nonzero(preds >= self.thres)[0]
        labels = _create_text_labels(
            list(idx), [float(preds[i]) for i in idx], self.class_names
        )
        return labels or []

    def draw_one_frame(self, frame: np.ndarray, preds, bboxes=None) -> np.ndarray:
        """frame: uint8 [H, W, 3] (modified copy returned)."""
        import cv2

        img = np.ascontiguousarray(frame).copy()
        if bboxes is None or len(bboxes) == 0:
            labels = self._labels_for(preds)
            for j, text in enumerate(labels):
                cv2.putText(
                    img, text, (5, 20 + 18 * j), cv2.FONT_HERSHEY_SIMPLEX,
                    0.5, (0, 235, 0), 1,
                )
            return img
        preds = np.asarray(preds)
        for i, box in enumerate(np.asarray(bboxes)):
            x1, y1, x2, y2 = [int(round(v)) for v in box[:4]]
            top1 = int(np.argmax(preds[i]))
            color = tuple(int(255 * c) for c in self.cmap(top1)[:3])
            cv2.rectangle(img, (x1, y1), (x2, y2), color, 2)
            labels = self._labels_for(preds[i])
            for j, text in enumerate(labels):
                cv2.putText(
                    img, text, (x1 + 2, max(y1 - 4 - 14 * j, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.4, color, 1,
                )
        return img

    def draw_clip_range(self, frames: List[np.ndarray], preds, bboxes=None,
                        keyframe_idx: Optional[int] = None,
                        draw_range: Optional[List[int]] = None) -> List[np.ndarray]:
        """Annotate the frames within ``draw_range`` (inclusive), leave
        the rest untouched (upstream draw_clip_range contract)."""
        n = len(frames)
        if draw_range is None:
            lo, hi = 0, n - 1
        else:
            lo, hi = max(draw_range[0], 0), min(draw_range[1], n - 1)
        out = []
        for i, frame in enumerate(frames):
            if lo <= i <= hi:
                out.append(self.draw_one_frame(frame, preds, bboxes))
            else:
                out.append(frame)
        return out
