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


_LOSSES = {
    "cross_entropy": cross_entropy,
    "soft_cross_entropy": soft_target_cross_entropy,
    "bce_logit": bce_logit,
}
# losses of the masked-pretraining family, ported with it
_NOT_PORTED = ("mse", "multi_mse")


def get_loss_func(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(f"Loss {name!r} belongs to the masked family, which is not ported yet")
    if name not in _LOSSES:
        raise NotImplementedError(f"Loss {name!r} not supported")
    return _LOSSES[name]


def epic_dual_loss(loss_fn, logits_pair, labels):
    """0.5 * (verb + noun) over the twin heads."""
    verb_logits, noun_logits = logits_pair
    return 0.5 * (loss_fn(verb_logits, labels["verb"]) + loss_fn(noun_logits, labels["noun"]))
