"""Video demo pipeline (port of ``vtm/vis/demo.py``; reference:
slowfast/visualization/{demo_loader,predictor,video_visualizer}.py, driven
by DEMO.* flags).

A cv2 ``VideoManager`` produces sliding clip buffers from a file or webcam,
``Predictor`` runs the model's eval step on each clip on its device (the
first CUDA device; the tests pass the CPU), and top-k labels are drawn on
the frames of the clip before display / file output. The reference's
async (ThreadVideoManager/AsyncDemo) path is a thread wrapping the same
manager.
"""

from __future__ import annotations

import queue
import threading
from typing import List, Optional

import numpy as np
import torch

from vtm_torch.data import transform
from vtm_torch.utils.logging import get_logger

logger = get_logger(__name__)


class TaskInfo:
    """One clip worth of work (reference utils.TaskInfo:383-415)."""

    def __init__(self, task_id: int, frames: List[np.ndarray]):
        self.id = task_id
        self.frames = frames  # raw BGR uint8 frames
        self.preds: Optional[np.ndarray] = None
        # async/demo pipeline fields (reference TaskInfo attributes)
        self.bboxes = None
        self.action_preds: Optional[np.ndarray] = None
        self.num_buffer_frames = 0
        self.img_height = 0
        self.img_width = 0
        self.crop_size = 0
        self.clip_vis_size = len(frames)

    def add_frames(self, idx, frames):
        """reference utils.py:395-403."""
        self.frames = frames
        self.id = idx

    def add_bboxes(self, bboxes):
        self.bboxes = bboxes

    def add_action_preds(self, preds):
        self.action_preds = preds


class VideoManager:
    """Read frames from DEMO.INPUT_VIDEO or DEMO.WEBCAM and yield
    sliding clips of NUM_FRAMES*SAMPLING_RATE frames
    (reference demo_loader.py:17-143)."""

    def __init__(self, cfg):
        import cv2

        assert cfg.DEMO.INPUT_VIDEO or cfg.DEMO.WEBCAM > -1, (
            "demo needs DEMO.INPUT_VIDEO or DEMO.WEBCAM"
        )
        self.cfg = cfg
        source = cfg.DEMO.WEBCAM if cfg.DEMO.WEBCAM > -1 else cfg.DEMO.INPUT_VIDEO
        self.cap = cv2.VideoCapture(source)
        if not self.cap.isOpened():
            raise IOError(f"cannot open video source {source!r}")
        self.buffer_size = cfg.DEMO.BUFFER_SIZE
        self.seq_length = cfg.DATA.NUM_FRAMES * cfg.DATA.SAMPLING_RATE
        self.buffer: List[np.ndarray] = []
        self.task_id = 0
        self.output_file = None
        if cfg.DEMO.OUTPUT_FILE:
            fps = cfg.DEMO.OUTPUT_FPS
            if fps == -1:
                fps = self.cap.get(cv2.CAP_PROP_FPS) or 30
            # DEMO.SLOWMO: the output plays SLOWMO x slower (upstream
            # semantics for a key the reference fork left dead)
            fps = max(1.0, float(fps) / max(1, int(cfg.DEMO.SLOWMO)))
            w = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            h = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            self.output_file = cv2.VideoWriter(
                cfg.DEMO.OUTPUT_FILE,
                cv2.VideoWriter_fourcc(*"mp4v"),
                fps,
                (w, h),
            )

    def __iter__(self):
        return self

    def __next__(self) -> TaskInfo:
        frames = list(self.buffer)
        # frames carried over from the previous clip were already
        # displayed with it (reference demo_loader.py:96,123 sets
        # num_buffer_frames = 0 for the first task, buffer_size after)
        num_buffer = len(frames)
        while len(frames) < self.seq_length:
            ok, frame = self.cap.read()
            if not ok:
                raise StopIteration
            frames.append(frame)
        if self.buffer_size:
            self.buffer = frames[-self.buffer_size :]
        task = TaskInfo(self.task_id, frames)
        task.num_buffer_frames = num_buffer
        task.clip_vis_size = self.cfg.DEMO.CLIP_VIS_SIZE
        self.task_id += 1
        return task

    def display(self, task: TaskInfo):
        import cv2

        for frame in task.frames[task.num_buffer_frames :]:
            if self.output_file is not None:
                self.output_file.write(frame)
            else:
                cv2.imshow("vtm demo", frame)
                cv2.waitKey(1)

    def clean(self):
        self.cap.release()
        if self.output_file is not None:
            self.output_file.release()

    # reference API parity
    def start(self):
        return self

    def join(self):
        pass


class ThreadVideoManager(VideoManager):
    """Producer-thread variant (reference demo_loader.py:147-357)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.q: "queue.Queue[Optional[TaskInfo]]" = queue.Queue(maxsize=8)
        self.thread = threading.Thread(target=self._produce, daemon=True)

    def _produce(self):
        try:
            while True:
                self.q.put(VideoManager.__next__(self))
        except StopIteration:
            self.q.put(None)

    def start(self):
        self.thread.start()
        return self

    def __next__(self) -> TaskInfo:
        task = self.q.get()
        if task is None:
            raise StopIteration
        return task

    def join(self):
        self.thread.join(timeout=1.0)


class Predictor:
    """Run the model on a TaskInfo (reference predictor.py Predictor): the
    config's model with ``load_test_checkpoint``'s weights (or ``bundle``),
    through ``make_eval_step`` on ``device`` (the first CUDA device unless
    given)."""

    def __init__(self, cfg, bundle=None, device: Optional[torch.device | str] = None):
        from vtm_torch.checkpoints.checkpoint import load_test_checkpoint
        from vtm_torch.models import build_model
        from vtm_torch.parallel.mesh import entry_device
        from vtm_torch.train.train_step import make_eval_step

        self.cfg = cfg
        self.device = entry_device(device, "the demo", 1)
        if bundle is None:
            bundle = load_test_checkpoint(cfg, build_model(cfg, self.device))
        self.bundle = bundle
        self._fn = make_eval_step(bundle.module)

    def _preprocess(self, frames: List[np.ndarray]) -> np.ndarray:
        import cv2

        cfg = self.cfg
        t = cfg.DATA.NUM_FRAMES
        idx = np.linspace(0, len(frames) - 1, t).astype(int)
        size = cfg.DATA.TEST_CROP_SIZE
        clip = []
        for i in idx:
            f = frames[i]
            if self.cfg.DEMO.INPUT_FORMAT == "BGR":
                f = cv2.cvtColor(f, cv2.COLOR_BGR2RGB)
            f = cv2.resize(f, (size, size), interpolation=cv2.INTER_LINEAR)
            clip.append(f)
        arr = np.stack(clip).astype(np.float32) / 255.0
        arr = transform.tensor_normalize(arr, cfg.DATA.MEAN, cfg.DATA.STD)
        return arr[None]

    def __call__(self, task: TaskInfo) -> TaskInfo:
        # geometry for box revert downstream (reference predictor.py
        # sets crop_size/img dims on the task before inference)
        task.crop_size = self.cfg.DATA.TEST_CROP_SIZE
        task.img_height, task.img_width = task.frames[0].shape[:2]
        logits = self._fn(torch.as_tensor(self._preprocess(task.frames), device=self.device))
        if isinstance(logits, tuple):
            logits = logits[0]
        task.preds = logits.float().cpu().numpy()[0]
        return task


def draw_predictions(task: TaskInfo, class_names: Optional[List[str]], k: int = 3):
    """Annotate the clip's frames with top-k labels
    (reference video_visualizer.py text labels)."""
    import cv2

    order = np.argsort(-task.preds)[:k]
    from vtm_torch.eval.metrics import softmax

    probs = softmax(task.preds)[order]
    lines = [
        f"{class_names[c] if class_names else c}: {p:.2f}"
        for c, p in zip(order, probs)
    ]
    for frame in task.frames:
        for li, text in enumerate(lines):
            cv2.putText(
                frame,
                text,
                (10, 30 + 25 * li),
                cv2.FONT_HERSHEY_SIMPLEX,
                0.7,
                (0, 255, 0),
                2,
            )
    return task


def load_class_names(path: str) -> Optional[List[str]]:
    if not path:
        return None
    import json

    with open(path) as f:
        if path.endswith(".json"):
            d = json.load(f)
            names = [None] * len(d)
            for name, idx in d.items():
                names[int(idx)] = name
            return names
        return [ln.strip() for ln in f if ln.strip()]
