"""The numbers that decide ``correct``, each from the program's output and
the reference's, and how they are printed beside their limits."""

from __future__ import annotations

import math
import statistics
import sys

import torch


def logit_gaps(outputs: list, refs: list) -> list:
    """Per batch of the window: the largest |logit - reference logit| over
    the rms of its pool batch's reference logits."""
    rms = [float(r.float().square().mean().sqrt()) for r in refs]
    return [float((out.float() - refs[i]).abs().max()) / rms[i] for i, out in outputs]


def worst_leaf_gap(program: dict, reference: dict, keep=None) -> tuple:
    """(gap, leaf): over the leaves (those ``keep`` accepts), the largest
    |program's norm - reference's norm| over the larger of the reference's
    norm of that leaf and of the median leaf."""
    names = [k for k in reference if keep is None or keep(k)]
    median = statistics.median(reference[k] for k in names)
    worst = (0.0, None)
    for k in names:
        gap = abs(program[k] - reference[k]) / max(reference[k], median)
        if not gap <= worst[0]:
            worst = (gap, k)
    return worst


def verdict(numbers: dict) -> bool:
    return all(math.isfinite(v) and v <= limit for v, limit in numbers.values())


def report(numbers: dict) -> dict:
    """Prints each number beside its limit as the last lines of standard
    error; returns them for the result's last key."""
    out = {name: {"value": v, "limit": limit} for name, (v, limit) in numbers.items()}
    for name, entry in out.items():
        print(f"check {name} {entry['value']!r} limit {entry['limit']!r}", file=sys.stderr, flush=True)
    return out


def host_norms(norms: dict) -> dict:
    """{name: float} from {name: 0-d device tensor}, in one transfer."""
    names = list(norms)
    values = torch.stack([norms[k] for k in names]).double().cpu().tolist() if names else []
    return dict(zip(names, values))
