"""Accuracy metrics (reference: slowfast/utils/metrics.py:9-96),
numpy host-side — stats tensors are tiny."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Numerically-stabilised host-side softmax (shared by the demo
    annotator and the analysis prob caching)."""
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def topks_correct(preds: np.ndarray, labels: np.ndarray, ks: Sequence[int]):
    """Number of top-k correct predictions for each k."""
    assert preds.shape[0] == labels.shape[0]
    order = np.argsort(-preds, axis=1)
    correct = order == labels[:, None]
    return [float(correct[:, :k].sum()) for k in ks]


def topk_accuracies(preds, labels, ks):
    num = preds.shape[0]
    return [x / num * 100.0 for x in topks_correct(preds, labels, ks)]


def topk_errors(preds, labels, ks):
    num = preds.shape[0]
    return [(1.0 - x / num) * 100.0 for x in topks_correct(preds, labels, ks)]


def multitask_topks_correct(
    preds: Tuple[np.ndarray, np.ndarray],
    labels: Tuple[np.ndarray, np.ndarray],
    ks: Sequence[int] = (1,),
):
    """Joint (verb AND noun) top-k correctness: a sample counts at k iff
    every task's label is within its own top-k (reference:
    metrics.py:67-96)."""
    maxk = max(ks)
    in_topk = []
    for p, l in zip(preds, labels):
        kk = min(maxk, p.shape[1])  # a head may have < maxk classes
        order = np.argsort(-p, axis=1)[:, :kk]
        correct = order == np.asarray(l)[:, None]  # [N, kk]
        hit = np.cumsum(correct, axis=1) > 0  # [N, kk] in top-(j+1)
        if kk < maxk:  # in top-C => in top-k for all k >= C
            hit = np.concatenate(
                [hit, np.repeat(hit[:, -1:], maxk - kk, axis=1)], axis=1
            )
        in_topk.append(hit)
    joint = in_topk[0]
    for h in in_topk[1:]:
        joint = joint & h
    return [float(joint[:, k - 1].sum()) for k in ks]


def multitask_topk_accuracies(preds, labels, ks=(1, 5)):
    num = preds[0].shape[0]
    return [x / num * 100.0 for x in multitask_topks_correct(preds, labels, ks)]
