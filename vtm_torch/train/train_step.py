"""Training-step construction: loss, backward, optimizer update (port of
``vtm/train/train_step.py`` for the families without BatchNorm).

The JAX step is a pure function of (params, opt_state); here the module's
parameters and the optimizer's state are updated in place, and the step
returns only (loss, logits, aux). Gradient accumulation
(``accumulate_steps`` = ``SOLVER.ACCUMULATE_STEPS``) follows
``optax.MultiSteps``: the mean of k micro-step gradients, one update
every k calls, taken with the learning rate set at the k-th.

The BatchNorm, detection, MAE, MaskFeat and contrastive steps are not
ported yet and raise.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from vtm_torch.train import losses as loss_lib
from vtm_torch.train.optimizer import apply_update


def make_train_step(
    module: nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_name: str,
    multi_head: bool,
    accumulate_steps: int = 1,
    has_batch_stats: bool = False,
) -> Callable:
    """Returns ``step(frames, labels, generator=None) -> (loss, logits,
    aux)``. ``labels`` is a tensor, or {"verb", "noun"} tensors for the
    twin heads, where the loss is 0.5 * (verb + noun) and aux is the
    (verb, noun) pair of losses. ``generator`` draws the dropout and
    stochastic-depth masks. loss, logits and aux are detached."""
    if has_batch_stats:
        raise NotImplementedError("the BatchNorm train step is not ported yet (conv families)")
    base_loss = loss_lib.get_loss_func(loss_name)
    k = max(1, int(accumulate_steps))
    micro_step = 0

    def step(frames, labels, generator: Optional[torch.Generator] = None):
        nonlocal micro_step
        module.train()
        logits, _ = module(frames, generator=generator)
        if multi_head:
            verb = base_loss(logits[0], labels["verb"])
            noun = base_loss(logits[1], labels["noun"])
            loss = 0.5 * (verb + noun)
            aux = (verb.detach(), noun.detach())
            logits = tuple(l.detach() for l in logits)
        else:
            loss = base_loss(logits, labels)
            aux = ()
            logits = logits.detach()
        # .grad sums over backward calls: dividing by k makes it the mean
        (loss / k if k > 1 else loss).backward()
        micro_step += 1
        if micro_step == k:
            apply_update(optimizer)
            micro_step = 0
        return loss.detach(), logits, aux

    return step


def make_eval_step(module: nn.Module, batch_stats=None) -> Callable:
    """Returns ``step(frames, generator=None) -> logits``: a forward in eval
    mode without autograd; ``generator`` draws the random merge modes'
    scores."""
    if batch_stats is not None:
        raise NotImplementedError("the BatchNorm eval step is not ported yet (conv families)")

    def step(frames, generator: Optional[torch.Generator] = None):
        module.eval()
        with torch.inference_mode():
            logits, _ = module(frames, generator=generator)
        return logits

    return step


def _not_ported(name: str):
    def raiser(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet")

    raiser.__name__ = name
    return raiser


make_bn_eval_step = _not_ported("make_bn_eval_step")
make_detection_eval_step = _not_ported("make_detection_eval_step")
make_detection_train_step = _not_ported("make_detection_train_step")
make_mae_train_step = _not_ported("make_mae_train_step")
make_maskfeat_train_step = _not_ported("make_maskfeat_train_step")
make_contrastive_train_step = _not_ported("make_contrastive_train_step")
