"""Training: the trainer's step dispatched back to back on a pool of
distinct batches made from the seed, with no host read between steps; the
losses are read once, after the window's final synchronise. The window's
clips/s are the clips of its steps over the time to that synchronise.

``correct``: set-up builds the one trainer the window drives and takes it
through its first three steps, on batches 0, 1 and 2 of the pool, with the
window's own call. It keeps each step's loss, the norm of each leaf's
first gradient as the optimizer got it (worked out from AdamW's first
moment after one step, m / (1 - beta1)) and, after the third step, the
norm of each leaf's change. Once the window has closed and the program is
freed, the float32 reference takes the same three steps from the same
weights, and the two are compared: the largest relative gap of a loss,
and by the worst leaf the gap of the gradient norms and of the change
norms (``check.worst_leaf_gap``). Leaves whose reference gradient is under
a thousandth of the median leaf's move by round-off alone under Adam, and
are left out of the change. A number the cell's file gives no limit is
printed and not compared.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time

import torch
from torch.profiler import record_function

from portbench.core import decisions, inputs, program
from portbench.core.check import host_norms, worst_leaf_gap
from portbench.reference.common import NUMERICS, exact_fp32

CHECKED_STEPS = 3
ROUND_OFF = 1e-3  # of the median leaf's reference gradient: moves by round-off alone


class ProgramStepper:
    """The program's trainer, as the window drives it."""

    def __init__(self, cell, params: dict, batch: int, device, recorder=None):
        self.trainer = program.trainer(cell, params, batch, device)
        self.beta1 = self.trainer.optimizer.param_groups[0]["betas"][0]

    def step(self, frames, labels):
        return self.trainer.train_step(frames, labels)[0]

    def first_gradients(self) -> dict:
        """m / (1 - beta1) after one step; zero where the step left no state."""
        state = self.trainer.optimizer.state
        return {k: state[p]["exp_avg"] / (1 - self.beta1) if "exp_avg" in state.get(p, {}) else torch.zeros_like(p)
                for k, p in self.trainer.module.named_parameters()}

    def params(self) -> dict:
        return dict(self.trainer.module.named_parameters())


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Training:
    cell: object
    seed: int
    stepper: object
    pool: list
    labels: list
    readings: dict
    batch: int
    device: torch.device
    recorder: decisions.Recorder = None
    undo: object = None
    next: int = CHECKED_STEPS

    def window(self, seconds: float = None, batches: int = None, sample: int = 0) -> dict:
        losses, enqueue = [], []
        _sync(self.device)
        start = time.perf_counter()
        i = self.next
        while (batches is None and time.perf_counter() - start < seconds) or (batches is not None and i - self.next < batches):
            t0 = time.perf_counter()
            with record_function("train.step"):
                losses.append(torch.as_tensor(self.stepper.step(self.pool[i % len(self.pool)],
                                                                self.labels[i % len(self.pool)])))
            enqueue.append(time.perf_counter() - t0)
            i += 1
        _sync(self.device)
        elapsed = time.perf_counter() - start
        steps, self.next = i - self.next, i
        finite = torch.isfinite(torch.stack(losses).float()).tolist() if losses else []
        return {"seconds": elapsed, "units": steps, "clips": steps * self.batch, "enqueue_s": enqueue,
                "failed": sum(not f for f in finite)}

    def free(self) -> None:
        self.stepper = None
        if self.undo:
            self.undo()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, window: dict, limits: dict) -> dict:
        ref = reference_readings(self.cell, self.seed, self.pool, self.labels, NUMERICS["fp32"],
                                 self.readings["calls"])
        numbers = compare(self.readings, ref)
        if self.cell.r > 0:
            numbers["match_gap"] = ref["match"]
        for k in sorted(numbers.keys() - limits.keys()):
            print(f"portbench: {k} {numbers[k]!r} read, not compared (the cell sets it no limit)", file=sys.stderr)
        detail = {k: v for k, v in self.readings.items() if k != "calls"}
        return {"numbers": {k: (v, limits[k]) for k, v in numbers.items() if k in limits}, "failed": window["failed"],
                "detail": {"program": detail, "reference": ref}}


def first_steps(stepper, pool: list, labels: list, p0: dict, recorder) -> dict:
    """Steps 1-3 of ``stepper`` on pool batches 0-2, keeping each step's
    merge decisions; the readings compared."""
    losses, calls = [], []
    for s in range(CHECKED_STEPS):
        calls.append([])
        recorder.sink = calls[-1]
        losses.append(torch.as_tensor(stepper.step(pool[s], labels[s])))
        recorder.sink = None
        if s == 0:
            grads = {k: g.float().norm() for k, g in stepper.first_gradients().items()}
    change = {k: (p.detach().float() - p0[k]).norm() for k, p in stepper.params().items()}
    return {"loss": [float(x) for x in losses], "grad": host_norms(grads), "change": host_norms(change),
            "calls": calls}


def reference_readings(cell, seed: int, pool: list, labels: list, num, calls: list) -> dict:
    """The reference's readings of the same three steps, its merges
    following the decisions ``calls`` of each step."""
    ref_mod, _ = cell.family_modules
    solver = cell.config["port"]["SOLVER"]
    params = inputs.make_params(ref_mod.param_specs(cell.model), seed, pool[0].device)
    p0 = {k: t.clone() for k, t in params.items()}
    opt = ref_mod.AdamW(params, lr=solver["BASE_LR"] * solver["LRS"][0], wd=solver["WEIGHT_DECAY"])
    losses, match = [], 0.0
    with exact_fp32():
        for s in range(CHECKED_STEPS):
            loss, grads, gap = ref_mod.loss_and_grads(params, pool[s], labels[s], cell.model, cell.r, num,
                                                      calls=calls[s])
            if s == 0:
                first = ref_mod.leaf_norms(grads)
            opt.step(params, grads)
            losses.append(loss)
            match = max(match, gap)
    change = ref_mod.leaf_norms({k: params[k] - p0[k] for k in params})
    return {"loss": losses, "grad": first, "change": change, "match": match}


def compare(program_readings: dict, ref: dict) -> dict:
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(program_readings["loss"], ref["loss"]))
    median = sorted(ref["grad"].values())[len(ref["grad"]) // 2]
    live = {k for k, g in ref["grad"].items() if g >= ROUND_OFF * median}
    return {
        "loss_gap": loss_gap if math.isfinite(loss_gap) else math.inf,
        "grad_norm_gap": worst_leaf_gap(program_readings["grad"], ref["grad"])[0],
        "change_norm_gap": worst_leaf_gap(program_readings["change"], ref["change"], keep=live.__contains__)[0],
    }


def setup(cell, seed: int, device, make_stepper=None) -> Training:
    """Weights (fp32) and the pool from the seed; the trainer built with
    them and taken through the three checked steps and the warm-up."""
    traffic, model = cell.traffic, cell.model
    batch = traffic["batch"]
    ref_mod, _ = cell.family_modules
    marks = [time.perf_counter()]
    params = inputs.make_params(ref_mod.param_specs(model), seed, device)
    recorder = decisions.Recorder()
    undo = recorder.install()
    marks.append(time.perf_counter())
    stepper = (make_stepper or ProgramStepper)(cell, params, batch, device, recorder)
    marks.append(time.perf_counter())
    pool = inputs.make_videos(traffic["pool"], batch, model["num_frames"], model["img_size"],
                              traffic["video"], seed, device)
    labels = inputs.make_labels(traffic["pool"], batch, model["num_classes"], seed, device)
    readings = first_steps(stepper, pool, labels, params, recorder)
    del params
    marks.append(time.perf_counter())
    training = Training(cell, seed, stepper, pool, labels, readings, batch, device, recorder, undo)
    training.window(batches=traffic["warmup"])
    marks.append(time.perf_counter())
    print("portbench: cell set-up: weights {:.3f} s, program {:.3f} s, inputs and checked steps {:.3f} s, "
          "warm-up {:.3f} s".format(*(b - a for a, b in zip(marks, marks[1:]))), file=sys.stderr)
    return training
