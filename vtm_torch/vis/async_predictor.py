"""Asynchronous multiprocess visualization pipeline for the demo (port of
``vtm/vis/async_predictor.py``).

Functional parity target: slowfast/visualization/async_predictor.py
(AsyncVis:16-121, _StopToken:123-124, draw_predictions:127-170).

The reference's AsyncPredictor (multiprocess GPU inference workers) is
absent from the fork (predictor.py is stripped to imports); inference
stays in the demo's process, on its device, while DRAWING — the host-side
CPU work — fans out to worker processes like the reference's AsyncVis.
The workers never touch CUDA: they are started by ``spawn`` (a forked
child of a process that has initialised CUDA cannot use it, and a fork of
a threaded process can deadlock), and ``put`` hands them numpy frames,
boxes and predictions only.
"""

from __future__ import annotations

import atexit
import multiprocessing as mp
from typing import Optional

import numpy as np

from vtm_torch.utils.logging import get_logger

logger = get_logger(__name__)


class _StopToken:
    pass


def draw_predictions(task, video_vis):
    """Annotate a task's frames (reference async_predictor.py:127-170):
    buffer frames pass through untouched; the clip range around the
    keyframe is drawn with boxes/labels."""
    boxes = getattr(task, "bboxes", None)
    frames = list(task.frames)
    preds = np.asarray(task.action_preds)
    if boxes is not None and len(boxes) and task.crop_size:
        # boxes live in model-crop coordinates; map them back onto the
        # raw display frames (reference async_predictor.py:140-146)
        from vtm_torch.data.cv2_transform import revert_scaled_boxes

        boxes = revert_scaled_boxes(
            task.crop_size, np.asarray(boxes), task.img_height,
            task.img_width,
        )
    keyframe_idx = len(frames) // 2 - task.num_buffer_frames
    draw_range = [
        keyframe_idx - task.clip_vis_size,
        keyframe_idx + task.clip_vis_size,
    ]
    buffer = frames[: task.num_buffer_frames]
    frames = frames[task.num_buffer_frames :]
    if boxes is not None and len(boxes):
        frames = video_vis.draw_clip_range(
            frames, preds, bboxes=np.asarray(boxes),
            keyframe_idx=keyframe_idx, draw_range=draw_range,
        )
    else:
        frames = video_vis.draw_clip_range(
            frames, preds, keyframe_idx=keyframe_idx, draw_range=draw_range,
        )
    return buffer + list(frames)


def _vis_worker_loop(video_vis, task_queue, result_queue):
    """Worker body (reference AsyncVis._VisWorker.run:44-58); a module-
    level function so spawn can pickle the target."""
    while True:
        task = task_queue.get()
        if isinstance(task, _StopToken):
            break
        frames = draw_predictions(task, video_vis)
        task.frames = np.array(frames)
        result_queue.put(task)


class AsyncVis:
    """Fan drawing work out to ``n_workers`` processes; results are
    re-ordered by task id on get() (reference AsyncVis semantics:
    get() raises IndexError while the next id is still pending)."""

    def __init__(self, video_vis, n_workers: Optional[int] = None):
        num_workers = n_workers if n_workers is not None else mp.cpu_count()
        # spawn, not fork: the demo process has initialised CUDA and runs
        # threads by the time drawing fans out
        ctx = mp.get_context("spawn")
        self.task_queue = ctx.Queue()
        self.result_queue = ctx.Queue()
        self.procs = []
        self.result_data = {}
        self.put_id = -1
        self.get_id = -1
        for _ in range(max(num_workers, 1)):
            self.procs.append(
                ctx.Process(
                    target=_vis_worker_loop,
                    args=(video_vis, self.task_queue, self.result_queue),
                    daemon=True,
                )
            )
        for p in self.procs:
            p.start()
        atexit.register(self.shutdown)

    def put(self, task):
        """Enqueue for drawing; ids are assigned HERE, sequentially —
        get() hands results back in put order regardless of the
        caller's own (possibly gappy, NUM_CLIPS_SKIP) task numbering.
        Tensors on the task (predictions, boxes) go as numpy arrays."""
        for name in ("action_preds", "preds", "bboxes"):
            value = getattr(task, name, None)
            if hasattr(value, "detach"):
                setattr(task, name, value.detach().float().cpu().numpy())
        self.put_id += 1
        task.id = self.put_id
        self.task_queue.put(task)

    def get(self):
        """Return the task with the next sequential id; IndexError if
        it has not been drawn yet (reference :83-101)."""
        get_idx = self.get_id + 1
        if self.result_data.get(get_idx) is not None:
            res = self.result_data[get_idx]
            del self.result_data[get_idx]
            self.get_id = get_idx
            return res
        while not self.result_queue.empty():
            res = self.result_queue.get()
            idx = res.id
            if idx == get_idx:
                self.get_id = get_idx
                return res
            self.result_data[idx] = res
        raise IndexError("Results are not available yet.")

    def __call__(self, task):
        self.put(task)

    def shutdown(self):
        for _ in self.procs:
            self.task_queue.put(_StopToken())

    @property
    def result_available(self) -> bool:
        return self.result_queue.qsize() > 0 or len(self.result_data) > 0

    @property
    def default_buffer_size(self) -> int:
        return len(self.procs) * 2
