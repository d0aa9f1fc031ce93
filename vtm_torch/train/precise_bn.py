"""Precise BatchNorm statistics (port of ``vtm/train/precise_bn.py``).

Before a checkpoint or an eval epoch (``BN.USE_PRECISE_STATS``), the
running statistics are recomputed as the plain average of per-batch
statistics over ``BN.NUM_BATCHES_PRECISE`` loader batches: every BatchNorm
runs at momentum 1, so that after a train-mode forward its running
statistics are that batch's, and every statistic is averaged over the
batches, a SubBatchNorm's per-split ones included. Under data parallelism
the BatchNorms' sync group makes each batch's statistics the global
batch's, as ``vtm``'s forward over the sharded batch computes them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from vtm_torch.models.convnet import batchnorms


@torch.no_grad()
def compute_precise_bn_stats(module: nn.Module, loader, num_batches: int, device: torch.device,
                             generator: Optional[torch.Generator] = None) -> nn.Module:
    """Sets every BatchNorm's running statistics of ``module`` (in place) to
    their average over the first ``num_batches`` batches of ``loader``;
    ``generator`` draws the forwards' dropout and drop-connect masks.
    Returns the module."""
    bns = batchnorms(module)
    if not bns or num_batches < 1:
        return module
    stats = [buf for bn in bns for buf in bn.buffers()]
    totals = [torch.zeros_like(buf) for buf in stats]
    momenta = [bn.momentum for bn in bns]
    was_training = module.training
    for bn in bns:
        bn.momentum = 1.0
    module.train()
    # a detection model runs its backbone alone: its ROI head has no
    # BatchNorm, and vtm's model without boxes falls through to the basic head
    forward = module.body if getattr(module, "detection", False) else module
    seen = 0
    try:
        for batch in loader:
            forward(torch.as_tensor(np.asarray(batch["frames"]), device=device), generator=generator)
            for total, buf in zip(totals, stats):
                total += buf
            seen += 1
            if seen >= num_batches:
                break
    finally:
        for bn, m in zip(bns, momenta):
            bn.momentum = m
        module.train(was_training)
    for total, buf in zip(totals, stats):
        if seen:
            buf.copy_(total / seen)
    return module
