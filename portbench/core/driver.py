"""One run of one cell: set-up, the measured window, with ``--trace 1``
the traced window after it, the check, and the result's line."""

from __future__ import annotations

import math
import pathlib
import sys
import time
import types

import torch

from portbench.core import check, hostinfo, serve, spec, train, wraps
from portbench.core.trace import traced

KINDS = {"serve": serve, "train": train}
TRACE_FILE = pathlib.Path(__file__).resolve().parents[2] / "build" / "portbench" / "trace.json"


def p95(values: list) -> float:
    """Nearest-rank 95th percentile."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def end_to_end(names: list, kind: str, window: dict, setup_s: float) -> dict:
    """The cell's end-to-end metrics, as ``BENCHMARK.json`` names them."""
    rate = window["clips"] / window["seconds"]
    metrics = {"setup_s": (setup_s, "s")}
    if kind == "serve":
        metrics["clips_per_s"] = (rate, "clips/s")
        metrics["batch_ms_p95"] = (p95(window["latency_s"]) * 1e3, "ms")
    else:
        metrics["train_clips_per_s"] = (rate, "clips/s")
    return {name: {"value": metrics[name][0], "unit": metrics[name][1]} for name in names}


def per_layer(run, metrics: dict) -> dict:
    """The cell's per-layer metrics' readings; one that finds nothing is
    left out."""
    out = {}
    for name, metric in metrics.items():
        value = metric.read(run)
        if value is not None:
            out[name] = {"value": value, "unit": metric.UNIT}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device, started: float, make_program=None,
             detail: dict = None) -> dict:
    """One run; ``detail``, where given, receives the check's diagnostics."""
    kind = KINDS[cell.traffic["kind"]]
    state = kind.setup(cell, seed, device, make_program)
    setup_s = time.perf_counter() - started
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the windows: one process with one host thread; no operation computes on the host
    before = hostinfo.sample()
    window = state.window(seconds=seconds, sample=cell.traffic.get("check_batches", 0))
    print(f"portbench: host over the window: {hostinfo.summary(before, hostinfo.sample(), window['enqueue_s'])}",
          file=sys.stderr)
    measured, spans = None, wraps.Spans()
    metrics = {name: spec.load_metric(name, cell.root) for name in cell.per_layer} if trace else {}
    if trace:
        for metric in metrics.values():
            spans.install(metric)
        spans.recording = True
        try:
            measured = traced(lambda n: state.window(batches=n), cell.workload["trace_iters"], TRACE_FILE)
        finally:
            spans.recording = False
            spans.uninstall()
    torch.set_num_threads(threads)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    state.free()
    checked = state.check(window, cell.workload["limits"])
    if detail is not None:
        detail.update(checked.get("detail", {}))
    run = types.SimpleNamespace(cell=cell, kind=cell.traffic["kind"], batch=cell.traffic["batch"], window=window,
                                trace=measured, bounds=dict(spans.bounds),
                                flops_per_clip=cell.family_modules[1].forward_flops(cell.model, cell.r))
    line = {
        "correct": check.verdict(checked["numbers"]) and window["units"] > 0 and checked["failed"] == 0,
        "attempted": window["units"],
        "failed": checked["failed"],
        "metrics": per_layer(run, metrics) if trace else end_to_end(cell.end_to_end, run.kind, window, setup_s),
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak},
    }
    if measured is not None:
        line["device"].update(busy_s=measured.busy_s, window_s=measured.window_s)
        line["breakdown"] = measured.breakdown("serve.batch" if run.kind == "serve" else "train.step")
    print(f"portbench: {cell.name} seed {seed} setup {setup_s:.3f} s, window {window['seconds']:.3f} s, "
          f"{window['units']} {'batches' if run.kind == 'serve' else 'steps'}", file=sys.stderr)
    line["checks"] = check.report(checked["numbers"])  # last, on stderr and in the line
    return line
