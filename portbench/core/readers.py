"""Shared arithmetic of the per-layer metric files."""

from __future__ import annotations

from portbench.core.peaks import BF16_FLOPS


def roofline_pct(run, span: str):
    """Sum of the calls' bounds over the device time of the kernels launched
    inside their spans, in %; None where the traced window made no call."""
    if run.trace is None:
        return None
    device_s = run.trace.span_device_s(span)
    bounds = run.bounds.get(span, [])
    if device_s <= 0 or not bounds:
        return None
    return 100.0 * sum(bounds) / device_s


def idle_pct(run):
    """1 - the device's busy seconds a batch or step in the traced window
    over the seconds a batch or step took in the measured, untraced one, in
    %: the trace gives device time alone, so the profiler's own host cost
    does not enter the share."""
    if run.trace is None or run.trace.iters <= 0 or run.window["units"] <= 0:
        return None
    busy = run.trace.busy_s / run.trace.iters
    return 100.0 * (1.0 - busy / (run.window["seconds"] / run.window["units"]))


def host_ms(run):
    enqueue = run.window["enqueue_s"]
    return 1e3 * sum(enqueue) / len(enqueue) if enqueue else None


def mfu_pct(run, passes: int):
    """``passes`` times the analytic forward operations of a clip, times the
    window's clips/s, over the bf16 peak, in %."""
    if run.window["seconds"] <= 0:
        return None
    return 100.0 * passes * run.flops_per_clip * run.window["clips"] / run.window["seconds"] / BF16_FLOPS


def grad_wanted(*tensors) -> bool:
    import torch

    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)
