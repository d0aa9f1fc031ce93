"""What the host did over a window: the process's CPU seconds, the seconds
the machine's virtual cores were stolen by the hypervisor (``/proc/stat``;
left out where it cannot be read) and the cores the process may run on.
Printed on standard error beside the spread of the window's enqueue
times, so that a run that reads slow can be told apart from a busy host."""

from __future__ import annotations

import os
import statistics
import time


def sample() -> dict:
    out = {"cpu_s": time.process_time()}
    try:
        with open("/proc/stat") as f:
            cpu = f.readline().split()
        out["steal_s"] = int(cpu[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return out


def summary(before: dict, after: dict, enqueue_s: list) -> str:
    parts = [f"{k} {after[k] - before[k]:.3f}" for k in after if k in before]
    if enqueue_s:
        ms = sorted(1e3 * e for e in enqueue_s)
        parts.append("enqueue ms min {:.2f} median {:.2f} p90 {:.2f} max {:.2f}".format(
            ms[0], statistics.median(ms), ms[int(0.9 * (len(ms) - 1))], ms[-1]))
    if hasattr(os, "sched_getaffinity"):
        parts.append(f"cores {sorted(os.sched_getaffinity(0))}")
    return ", ".join(parts)
