"""Serving: one closed-loop client keeps ``in_flight`` batches in flight.
Batch i+1's forward is enqueued before batch i's logits are read; each
batch's logits go to the host as bf16 through a pinned buffer. A pool of
distinct batches, made from the seed, is cycled.

Per batch the host clock gives the enqueue time (around the forward's
call, before any synchronise) and the latency (from the dispatch to the
logits on the host). The window's clips/s are the clips whose logits
reached the host over the time from the first dispatch to the last
arrival.

``correct``: once the window has closed and the program is freed, the
float32 reference computes the logits of every pool batch, and every
batch of the window is compared with its pool batch's: the largest gap of
a logit, over the rms of the reference's logits.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import random
import sys
import time

import torch
from torch.profiler import record_function

from portbench.core import decisions, inputs, program
from portbench.core.check import logit_gaps
from portbench.reference.common import NUMERICS, exact_fp32


@dataclasses.dataclass
class Serving:
    cell: object
    seed: int
    forward: object
    pool: list
    holder: object  # what keeps the program alive, freed before the check
    batch: int
    recorder: decisions.Recorder
    undo: object = None

    def window(self, seconds: float = None, batches: int = None, sample: int = 0) -> dict:
        """Dispatch until ``seconds`` have passed (or ``batches`` are
        dispatched), then wait for those in flight. ``sample``: keep the
        merge decisions of that many batches, drawn uniformly over the
        window from the seed (reservoir sampling as they are dispatched)."""
        depth = self.cell.traffic["in_flight"]
        pend = collections.deque()
        enqueue, latency, outputs = [], [], []
        cuda = self.pool[0].is_cuda
        pinned = [torch.empty((self.batch, self.cell.model["num_classes"]), dtype=torch.bfloat16, pin_memory=cuda)
                  for _ in range(depth + 1)]

        def arrive():
            t0, i, event, host = pend.popleft()
            if event is not None:
                event.synchronize()
            latency.append(time.perf_counter() - t0)
            outputs.append((i % len(self.pool), host.clone()))

        draw = random.Random(self.seed)
        slots, kept = [None] * sample, {}
        start = time.perf_counter()
        i = 0
        while (batches is None and time.perf_counter() - start < seconds) or (batches is not None and i < batches):
            slot = i if i < sample else draw.randrange(i + 1)
            if slot < sample:
                kept.pop(slots[slot], None)
                slots[slot], kept[i] = i, []
            self.recorder.sink = kept.get(i)
            t0 = time.perf_counter()
            with record_function("serve.batch"):
                logits = self.forward(self.pool[i % len(self.pool)])
                host = pinned[i % len(pinned)]
                host.copy_(logits.to(torch.bfloat16), non_blocking=cuda)
                event = torch.cuda.Event() if cuda else None
                if cuda:
                    event.record()
            enqueue.append(time.perf_counter() - t0)
            pend.append((t0, i, event, host))
            i += 1
            while len(pend) >= depth:
                arrive()
        while pend:
            arrive()
        elapsed = time.perf_counter() - start
        self.recorder.sink = None
        return {"seconds": elapsed, "units": len(latency), "clips": len(latency) * self.batch,
                "enqueue_s": enqueue, "latency_s": latency, "outputs": outputs,
                "sampled": kept}

    def free(self) -> None:
        if self.undo:
            self.undo()
        self.forward = self.holder = self.undo = None
        gc.collect()
        if self.pool[0].is_cuda:
            torch.cuda.empty_cache()

    def check(self, window: dict, limits: dict) -> dict:
        """Unmerged: every batch of the window against the reference's
        logits of its pool batch. Merged: the sampled batches, the reference
        following each one's merge decisions and judging them by its own
        scores (``match_gap``)."""
        ref_mod, _ = self.cell.family_modules
        model, r, fp32 = self.cell.model, self.cell.r, NUMERICS["fp32"]
        params = inputs.make_params(ref_mod.param_specs(model), self.seed, self.pool[0].device,
                                    round_to=torch.bfloat16)
        outputs = window["outputs"]
        with exact_fp32():
            if r == 0:
                refs = [ref_mod.logits(params, v, model, r, fp32)[0].cpu() for v in self.pool]
                gaps = logit_gaps(outputs, refs)
                numbers = {}
            else:
                refs, gaps, match = [], [], 0.0
                for j, calls in sorted(window["sampled"].items()):
                    i, out = outputs[j]
                    ref, gap = ref_mod.logits(params, self.pool[i], model, r, fp32, calls=calls)
                    refs.append(ref.cpu())
                    gaps += logit_gaps([(len(refs) - 1, out)], refs)
                    match = max(match, gap)
                numbers = {"match_gap": (match if gaps else float("inf"), limits["match_gap"])}
        limit = limits["logit_gap"]
        numbers["logit_gap"] = (max(gaps, default=float("inf")), limit)
        return {"numbers": numbers, "failed": sum(not g <= limit for g in gaps),
                "detail": {"batch_gaps": gaps}}


def setup(cell, seed: int, device, make_forward=None) -> Serving:
    """Weights (in bf16, as served) and the pool from the seed; the
    program built with them; every shape of the window warmed up."""
    traffic, model = cell.traffic, cell.model
    batch = traffic["batch"]
    ref_mod, _ = cell.family_modules
    marks = [time.perf_counter()]
    params = inputs.make_params(ref_mod.param_specs(model), seed, device, round_to=torch.bfloat16)
    recorder = decisions.Recorder()
    undo = recorder.install()
    marks.append(time.perf_counter())
    forward, holder = (make_forward or program.serving_forward)(cell, params, batch, device, recorder)
    del params
    marks.append(time.perf_counter())
    pool = inputs.make_videos(traffic["pool"], batch, model["num_frames"], model["img_size"],
                              traffic["video"], seed, device)
    marks.append(time.perf_counter())
    serving = Serving(cell, seed, forward, pool, holder, batch, recorder, undo)
    serving.window(batches=traffic["warmup"])
    marks.append(time.perf_counter())
    print("portbench: cell set-up: weights {:.3f} s, program {:.3f} s, inputs {:.3f} s, warm-up {:.3f} s".format(
        *(b - a for a, b in zip(marks, marks[1:]))), file=sys.stderr)
    return serving
