"""The merge decisions the timed path makes, kept for the reference to
follow and to judge. ``Recorder.install`` wraps
``vtm_torch.merge.bipartite.bipartite_soft_matching`` (which
``merge/policy.py::reduce_tokens`` looks up through the module); the
wrapper appends each Matching's index tensors (kept, merged, destination)
to ``sink`` while a batch or step is being kept. It adds no kernel and no
synchronise; the indices stay on the device until the check."""

from __future__ import annotations

import functools
import importlib

MODULE, ATTR = "vtm_torch.merge.bipartite", "bipartite_soft_matching"


class Recorder:
    def __init__(self):
        self.sink = None  # the list receiving the current batch's or step's decisions, or None

    def install(self):
        """Wrap the matcher; returns the undo function."""
        module = importlib.import_module(MODULE)
        original = getattr(module, ATTR)

        @functools.wraps(original)
        def matching(*args, **kwargs):
            m = original(*args, **kwargs)
            if self.sink is not None and m is not None:
                self.sink.append((m.unm_idx, m.src_idx, m.dst_idx))
            return m

        setattr(module, ATTR, matching)
        return lambda: setattr(module, ATTR, original)
