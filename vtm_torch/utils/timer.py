"""Simple wall-clock timer (reference analog: fvcore Timer used in
slowfast/utils/meters.py)."""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self._start = time.perf_counter()
        self._paused_at = None
        self._total = 0.0

    def pause(self):
        if self._paused_at is None:
            self._paused_at = time.perf_counter()
            self._total += self._paused_at - self._start

    def resume(self):
        if self._paused_at is not None:
            self._start = time.perf_counter()
            self._paused_at = None

    def seconds(self) -> float:
        if self._paused_at is not None:
            return self._total
        return self._total + (time.perf_counter() - self._start)
