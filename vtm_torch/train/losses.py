"""Loss functions (port of ``vtm/train/losses.py``), on torch tensors.

Every loss is the mean over the batch, computed in fp32 from the fp32
logits the heads return."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def soft_target_cross_entropy(logits: torch.Tensor, soft_targets: torch.Tensor) -> torch.Tensor:
    return -(soft_targets * F.log_softmax(logits, dim=-1)).sum(dim=-1).mean()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.0):
    """labels may be int class ids or soft distributions (mixup)."""
    if labels.dim() == logits.dim():
        return soft_target_cross_entropy(logits, labels)
    if label_smoothing > 0.0:
        n = logits.shape[-1]
        soft = F.one_hot(labels.long(), n).to(logits.dtype) * (1.0 - label_smoothing) + label_smoothing / n
        return soft_target_cross_entropy(logits, soft)
    return F.cross_entropy(logits, labels.long())


def bce_logit(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logits, labels.to(logits.dtype))


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def multiple_mse(preds, labels_and_weights, masks=None):
    """Weighted sum of per-depth mse losses: (sum, [per-depth loss]).
    ``labels_and_weights``: per depth a label or (label, weight), weight 1
    by default. ``masks``: optional per-depth [B, N] bool, the positions
    whose rows count: each depth's loss is then the squared error summed
    over those rows over ``max(rows * width, 1)``, the mean over the
    masked positions that upstream's ``x[mask]`` selection takes."""
    loss_sum = 0.0
    multi = []
    for i, (pred, lw) in enumerate(zip(preds, labels_and_weights)):
        label, weight = (lw[0], lw[1]) if isinstance(lw, (tuple, list)) else (lw, 1.0)
        if masks is not None:
            m = masks[i].float()[..., None]
            per = ((pred - label) ** 2) * m
            loss = per.sum() / torch.clamp(m.sum() * pred.shape[-1], min=1.0)
        else:
            loss = ((pred - label) ** 2).mean()
        loss_sum = loss_sum + loss * weight
        multi.append(loss)
    return loss_sum, multi


_LOSSES = {
    "cross_entropy": cross_entropy,
    "soft_cross_entropy": soft_target_cross_entropy,
    "bce_logit": bce_logit,
    "mse": mse,
    "multi_mse": multiple_mse,
}


def get_loss_func(name: str):
    if name not in _LOSSES:
        raise NotImplementedError(f"Loss {name!r} not supported")
    return _LOSSES[name]


def epic_dual_loss(loss_fn, logits_pair, labels):
    """0.5 * (verb + noun) over the twin heads."""
    verb_logits, noun_logits = logits_pair
    return 0.5 * (loss_fn(verb_logits, labels["verb"]) + loss_fn(noun_logits, labels["noun"]))
