"""Optimizer construction with torch.optim (port of ``vtm/train/optimizer.py``).

The JAX package chains, per parameter,
    [clip] -> adam moments (eps 1e-8) -> + wd * p -> * layer-decay scale -> * -lr
(AdamW; ``adam`` and ``sgd`` add ``wd * p`` to the gradient first). In
torch.optim terms that is one parameter group per (weight decay,
layer-decay scale) pair whose learning rate is ``lr * scale``:
  * ``sgd``: ``torch.optim.SGD`` (decay added before the momentum trace);
  * ``adamw`` / ``mt_adamw``: ``torch.optim.AdamW`` (decoupled decay);
  * ``adam``: ``torch.optim.Adam`` (decay folded into the gradient).
``set_lr`` therefore sets ``lr * lr_scale`` in every group, not one value.

Grouping follows the JAX package: the model's no-weight-decay name set
and, under ``SOLVER.ZERO_WD_1D_PARAM``, 1-D parameters and ``*bias`` get
weight decay 0; ``SOLVER.LAYER_DECAY`` < 1 scales block i's step by
``ld ** (L + 1 - (i + 1))``, the embeddings' by ``ld ** (L + 1)``, the
head's by 1. Gradient clipping (``SOLVER.CLIP_GRAD_L2NORM`` by global
norm, else ``SOLVER.CLIP_GRAD_VAL`` by value) runs in ``apply_update``
before the optimizer's step.

LARS (``SOLVER.LARS_ON``) and the BatchNorm group belong to the conv and
contrastive families and raise until those are ported.
"""

from __future__ import annotations

import re
from typing import Callable, Tuple

import torch
from torch import nn

from vtm_torch.train.lr_policy import get_lr_at_epoch


def _is_bn(name: str) -> bool:
    """BatchNorm parameters (conv families): any name segment ending in 'bn'."""
    return any(seg.endswith("bn") for seg in name.split("."))


def _skip_names(cfg) -> tuple:
    """The model's no_weight_decay() name set (substring match on the
    parameter name). Only the models that define one."""
    name = getattr(cfg.MODEL, "MODEL_NAME", "").lower()
    if name == "motionformer":
        return ("pos_embed", "cls_token", "st_embed", "temp_embed")
    if name in ("mvit", "maskmvit") and cfg.MVIT.ZERO_DECAY_POS_CLS:
        return (
            "pos_embed",
            "pos_embed_spatial",
            "pos_embed_temporal",
            "pos_embed_class",
            "rel_pos_h",
            "rel_pos_w",
            "rel_pos_t",
            "cls_token",
            "mask_token",
        )
    return ()


def _is_zero_wd(cfg, name: str, param: torch.Tensor) -> bool:
    if any(k in name for k in _skip_names(cfg)):
        return True
    return bool(cfg.SOLVER.ZERO_WD_1D_PARAM and (param.dim() <= 1 or name.endswith("bias")))


def _layer_id(name: str, num_layers: int) -> int:
    """Parameter name -> layer index for layer decay: embeddings -> 0,
    block i -> i + 1, head -> L + 1."""
    m = re.search(r"(?:blocks|layer)[._](\d+)", name)
    if m:
        return int(m.group(1)) + 1
    if any(k in name for k in ("patch_embed", "cls_token", "position_embeddings", "pos_embed")):
        return 0
    return num_layers + 1


def construct_optimizer(
    cfg, module: nn.Module, num_layers: int = 12
) -> Tuple[torch.optim.Optimizer, Callable[[float], float]]:
    """Returns (optimizer over ``module``'s parameters, lr_at(epoch_exact)).
    Set the learning rate before each step with ``set_lr`` and take the
    step with ``apply_update``."""
    method = cfg.SOLVER.OPTIMIZING_METHOD
    if getattr(cfg.SOLVER, "LARS_ON", False):
        raise NotImplementedError("SOLVER.LARS_ON: LARS is not ported yet (contrastive family)")
    wd = cfg.SOLVER.WEIGHT_DECAY
    ld = cfg.SOLVER.LAYER_DECAY

    groups = {}  # (weight decay, lr scale) -> parameters, in first-seen order
    for name, param in module.named_parameters():
        if not param.requires_grad:
            continue
        if _is_bn(name):
            raise NotImplementedError(f"{name}: the BatchNorm group is not ported yet (conv families)")
        decay = 0.0 if _is_zero_wd(cfg, name, param) else wd
        scale = ld ** (num_layers + 1 - _layer_id(name, num_layers)) if ld < 1.0 else 1.0
        groups.setdefault((decay, scale), []).append(param)

    lr0 = get_lr_at_epoch(cfg, 0.0)
    param_groups = [
        dict(params=params, weight_decay=decay, lr_scale=scale, lr=lr0 * scale)
        for (decay, scale), params in groups.items()
    ]
    if method == "sgd":
        optimizer = torch.optim.SGD(
            param_groups, lr=lr0, momentum=cfg.SOLVER.MOMENTUM,
            nesterov=bool(cfg.SOLVER.NESTEROV and cfg.SOLVER.MOMENTUM > 0),
        )
    elif method in ("adamw", "mt_adamw"):
        optimizer = torch.optim.AdamW(param_groups, lr=lr0, betas=tuple(cfg.SOLVER.BETAS), eps=1e-8)
    elif method == "adam":
        optimizer = torch.optim.Adam(param_groups, lr=lr0, betas=tuple(cfg.SOLVER.BETAS), eps=1e-8)
    else:
        raise NotImplementedError(f"optimizer {method!r} not supported")
    optimizer.clip_grad_l2norm = cfg.SOLVER.CLIP_GRAD_L2NORM
    optimizer.clip_grad_val = cfg.SOLVER.CLIP_GRAD_VAL

    def lr_at(epoch_exact: float) -> float:
        return get_lr_at_epoch(cfg, epoch_exact)

    return optimizer, lr_at


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Set the schedule's learning rate: each group steps by ``lr`` times
    its layer-decay scale."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group.get("lr_scale", 1.0)
    return optimizer


@torch.no_grad()
def clip_gradients(optimizer: torch.optim.Optimizer) -> None:
    """Clip the gradients in place as the optimizer was configured: by
    global L2 norm (scaled by max_norm / norm when the norm exceeds it),
    else by value."""
    max_norm = getattr(optimizer, "clip_grad_l2norm", None)
    max_val = getattr(optimizer, "clip_grad_val", None)
    grads = [p.grad for g in optimizer.param_groups for p in g["params"] if p.grad is not None]
    if max_norm:
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        for g in grads:
            g.mul_(factor.to(g.dtype))
    elif max_val:
        for g in grads:
            g.clamp_(-max_val, max_val)


def apply_update(optimizer: torch.optim.Optimizer) -> None:
    """Clip, step, and clear the gradients."""
    clip_gradients(optimizer)
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
