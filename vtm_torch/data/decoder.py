"""Video decode + clip index math (copy of ``vtm/data/decoder.py``).

Clip-index math is a faithful port of slowfast/datasets/decoder.py
(temporal_sampling:17-34, get_start_end_idx:37-78); decoding goes
through OpenCV (PyAV is not in this image) with the same
fps-retargeting semantics as the reference pyav path (decoder.py:378-489).
"""

from __future__ import annotations

import math
import random
from typing import Optional, Tuple

import numpy as np

from vtm_torch.data import transform


def temporal_sampling(
    frames: np.ndarray, start_idx: float, end_idx: float, num_samples: int
) -> np.ndarray:
    """Sample ``num_samples`` equally spaced frames in [start, end]
    (reference decoder.py:17-34)."""
    index = np.linspace(start_idx, end_idx, num_samples)
    index = np.clip(index, 0, frames.shape[0] - 1).astype(np.int64)
    return frames[index]


def get_start_end_idx(
    video_size: int,
    clip_size: float,
    clip_idx: int,
    num_clips_uniform: int,
    use_offset: bool = False,
) -> Tuple[float, float, float]:
    """Start/end frame of the clip_idx-th of num_clips uniform clips
    (reference decoder.py:37-78)."""
    delta = max(video_size - clip_size, 0)
    if clip_idx == -1:
        start_idx = random.uniform(0, delta)
    else:
        if use_offset:
            if num_clips_uniform == 1:
                start_idx = math.floor(delta / 2)
            else:
                start_idx = clip_idx * math.floor(delta / (num_clips_uniform - 1))
        else:
            start_idx = delta * clip_idx / num_clips_uniform
    end_idx = start_idx + clip_size - 1
    return start_idx, end_idx, start_idx / delta if delta != 0 else 0.0


def get_multiple_start_end_idx(
    video_size: int,
    clip_sizes,
    clip_idx: int,
    num_clips_uniform: int,
    min_delta: float = 0,
    max_delta: float = math.inf,
    use_offset: bool = False,
) -> np.ndarray:
    """Sample one clip window per entry of ``clip_sizes`` with pairwise
    gap constraints (reference decoder.py:81-185 — the multi-pathway /
    contrastive sampling path).

    Each clip is drawn like :func:`get_start_end_idx`; when ``clip_idx``
    is -1 the draw is retried (up to 100x per clip, 100x overall) until
    every gap between consecutive sorted windows lies in
    [min_delta, max_delta], keeping the best-scoring draw otherwise.
    Returns [n_clips, 3]: (start, end, delta to previous clip).
    """

    def draw_once():
        windows = np.empty((0, 2))
        gaps = np.empty((0,))
        for clip_size in clip_sizes:
            for attempt in range(100):
                max_start = max(video_size - clip_size, 0)
                if clip_idx == -1:
                    start = random.uniform(0, max_start)
                elif use_offset:
                    if num_clips_uniform == 1:
                        start = math.floor(max_start / 2)
                    else:
                        start = clip_idx * math.floor(
                            max_start / (num_clips_uniform - 1)
                        )
                else:
                    start = max_start * clip_idx / num_clips_uniform
                candidate = np.append(
                    windows, [[start, start + clip_size - 1]], axis=0
                )
                if windows.shape[0] < 1:
                    windows = candidate
                    break
                ordered = np.sort(candidate, 0)
                gaps = ordered[1:, 0] - ordered[:-1, 1]
                bad = any(gaps < min_delta) or any(gaps > max_delta)
                if not bad or attempt == 99:
                    windows = ordered
                    break
        return windows, gaps

    best, best_gaps, best_score = None, None, -math.inf
    for _ in range(100):
        windows, gaps = draw_once()
        ok = not (any(gaps < min_delta) or any(gaps > max_delta))
        if ok or clip_idx != -1:
            best, best_gaps = windows, gaps
            break
        score = np.r_[gaps[gaps < min_delta], -gaps[gaps > max_delta]].sum()
        if score > best_score:
            best, best_gaps, best_score = windows, gaps, score
    return np.c_[best, np.concatenate(([0], best_gaps))]


def read_video_cv2(path: str) -> Tuple[Optional[np.ndarray], float]:
    """Decode all frames of a video to RGB uint8 [T, H, W, 3] + fps."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        return None, 0.0
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        return None, fps
    return np.stack(frames), float(fps)


def read_video_window_cv2(
    path: str, first: int, last: int
) -> Tuple[Optional[np.ndarray], int]:
    """Decode only frames [first, last] (inclusive): leading frames are
    skipped with ``grab()`` (no pixel decode) — the host-side analog of
    the reference's selective-seek pyav decode (decoder.py:378-489).
    Returns (frames, actual_first)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        return None, 0
    for _ in range(first):
        if not cap.grab():
            cap.release()
            return None, 0
    frames = []
    for _ in range(first, last + 1):
        ok, frame = cap.read()
        if not ok:
            break  # window extends past EOF: clip, like the reference
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        return None, 0
    return np.stack(frames), first


def _video_meta(path: str) -> Tuple[float, int]:
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        return 0.0, 0
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
    cap.release()
    return float(fps), count


def decode(
    path: str,
    sampling_rate: int,
    num_frames: int,
    clip_idx: int = -1,
    num_clips: int = 10,
    target_fps: int = 30,
    use_offset: bool = False,
    time_diff_prob: float = 0.0,
    gaussian_prob: float = 0.0,
) -> Optional[np.ndarray]:
    """Decode a clip: fps-retargeted clip window, selective decode of
    only the window's frames, equal-interval sampling (reference
    decoder.py:492-666 semantics).

    Returns [num_frames, H, W, 3] uint8 — float32 when the raw-frame
    SSL augs fire (``time_diff_prob``/``gaussian_prob``, reference
    decoder.py:619-661; tensor_normalize restores /255 downstream) —
    or None on decode failure (callers implement the
    retry-with-replacement loop the reference uses, kinetics.py:282-309).
    """

    def _aug(clip):
        if clip is None or (time_diff_prob <= 0.0 and gaussian_prob <= 0.0):
            return clip
        clip, _ = transform.augment_raw_frames(
            clip, time_diff_prob, gaussian_prob
        )
        return clip
    fps, total = _video_meta(path)
    if total > 0:
        clip_size = sampling_rate * num_frames / target_fps * fps
        start_idx, end_idx, _ = get_start_end_idx(
            total, clip_size, clip_idx, num_clips, use_offset=use_offset
        )
        first = int(math.floor(max(start_idx, 0)))
        last = min(int(math.ceil(end_idx)), total - 1)
        window, first = read_video_window_cv2(path, first, last)
        if window is not None:
            # raw-frame augs run on the decoded window BEFORE temporal
            # sampling (reference decoder.py:643-648): the time
            # difference is between consecutive RAW frames, which the
            # sampling then subsamples
            window = _aug(window)
            index = np.linspace(start_idx, end_idx, num_frames)
            index = np.clip(index, 0, total - 1).astype(np.int64) - first
            index = np.clip(index, 0, window.shape[0] - 1)
            return window[index]
        # fall through to the full-read path on metadata mismatch

    frames, fps = read_video_cv2(path)
    if frames is None:
        return None
    clip_size = sampling_rate * num_frames / target_fps * fps
    start_idx, end_idx, _ = get_start_end_idx(
        frames.shape[0], clip_size, clip_idx, num_clips, use_offset=use_offset
    )
    # aug-before-sampling, as above (reference decoder.py:643-648)
    return temporal_sampling(_aug(frames), start_idx, end_idx, num_frames)


def decode_clips(
    path: str,
    sampling_rate: int,
    num_frames: int,
    num_decode: int,
    target_fps: int = 30,
    min_delta: float = -math.inf,
    max_delta: float = math.inf,
    time_diff_prob: float = 0.0,
    gaussian_prob: float = 0.0,
) -> Optional[list]:
    """Decode ``num_decode`` random training clips of one video with the
    reference's pairwise-gap-constrained sampling
    (get_multiple_start_end_idx — the SSL multi-view path,
    reference kinetics.py:256-311 + decoder.py:81-185).

    Returns a list of [num_frames, H, W, 3] uint8 arrays or None.
    """
    frames, fps = read_video_cv2(path)
    if frames is None:
        return None
    clip_size = sampling_rate * num_frames / target_fps * fps
    windows = get_multiple_start_end_idx(
        frames.shape[0], [clip_size] * num_decode, -1, 1,
        min_delta=min_delta, max_delta=max_delta,
    )
    if time_diff_prob > 0.0 or gaussian_prob > 0.0:
        # independent draws per decoded view on the WHOLE raw video
        # before sampling (reference decoder.py:630-648 clones the
        # decoded video per view, augments it, then temporal-samples)
        return [
            temporal_sampling(
                transform.augment_raw_frames(
                    frames, time_diff_prob, gaussian_prob
                )[0],
                s,
                e,
                num_frames,
            )
            for s, e, _ in windows
        ]
    return [temporal_sampling(frames, s, e, num_frames) for s, e, _ in windows]
