"""Spans around the program's functions, put in by the benchmark for a
traced run: each metric file lists in ``WRAPS`` the (module, attribute)
places where the models look a function up, and its span's label
(``SPAN``). While ``recording`` is on, the wrapper also records each
call's bound (the metric's ``bound(args, kwargs)``, in seconds). A place
that no longer exists is skipped and named on standard error: the metric
then reads nothing."""

from __future__ import annotations

import collections
import functools
import importlib
import sys

from torch.profiler import record_function


class Spans:
    def __init__(self):
        self.bounds = collections.defaultdict(list)  # label -> [each call's bound, s]
        self.recording = False
        self._undo = []

    def install(self, metric) -> None:
        for module_name, attr in getattr(metric, "WRAPS", ()):
            try:
                module = importlib.import_module(module_name)
                original = getattr(module, attr)
            except (ImportError, AttributeError):
                print(f"portbench: {module_name}.{attr} not found; {metric.NAME} reads nothing", file=sys.stderr)
                continue
            setattr(module, attr, self._wrapper(original, metric.SPAN, getattr(metric, "bound", None)))
            self._undo.append((module, attr, original))

    def _wrapper(self, fn, label: str, bound):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if self.recording and bound is not None:
                self.bounds[label].append(bound(args, kwargs))
            with record_function(label):
                return fn(*args, **kwargs)

        return wrapped

    def uninstall(self) -> None:
        for module, attr, original in reversed(self._undo):
            setattr(module, attr, original)
        self._undo.clear()
