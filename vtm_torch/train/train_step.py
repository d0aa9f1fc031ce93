"""Training-step construction: loss, backward, optimizer update (port of
``vtm/train/train_step.py``).

The JAX step is a pure function of (params, opt_state); here the module's
parameters and the optimizer's state are updated in place, and the step
returns only (loss, logits, aux). Gradient accumulation
(``accumulate_steps`` = ``SOLVER.ACCUMULATE_STEPS``) follows
``optax.MultiSteps``: the mean of k micro-step gradients, one update
every k calls, taken with the learning rate set at the k-th.

Data parallelism: ``module`` may be a ``DistributedDataParallel`` wrapper
over the ``data`` group (``train_net`` wraps it). Its gradients are then
the mean over the data ranks of each rank's mean, which with equal rows a
rank is the global batch's mean gradient, as ``vtm``'s step over the
sharded batch computes it; the first k - 1 micro-steps of an accumulation
run under ``no_sync()``, so one all-reduce carries the k-step sum. The
returned loss (and aux) is the global batch's mean too, all-reduced over
``data_group``; the logits stay this rank's rows.

The conv families' BatchNorm step is the same step: in training mode the
module's BatchNorms normalise with the batch's statistics and update their
running statistics (buffers) in place, which is what ``vtm``'s step returns
as the new ``batch_stats``; under
``MODEL.FROZEN_BN`` they keep them. Under data parallelism ``train_net``
points the BatchNorms at the data group (``convnet.set_sync_group``), so the
statistics are the global batch's. Their eval step is ``make_eval_step``: a
forward in eval mode on the running statistics.

The masked-pretraining steps (``make_mae_train_step``,
``make_maskfeat_train_step``) take the batch's frames and loader mask: a
forward, ``losses.multiple_mse`` over the masked positions, a backward and
the update (accumulated as above). They run in one process, as ``vtm``'s.

The contrastive step (``make_contrastive_train_step``) runs the
``ContrastiveModel``'s forward, which also advances its state (the momentum
encoder, queues and banks, in place), the backward and the update; MoCo's
queue warm-up steps (``update_param=False``) skip the update. It runs in one
process, as ``vtm``'s.

The detection steps (AVA, ``DETECTION.ENABLE``): ``make_detection_eval_step``
returns the per-box scores of a forward in eval mode;
``make_detection_train_step`` the per-box loss of ``vtm``'s formula, its
mean over the batch's boxes in the collate's order, the backward and the
update. ``vtm`` pads the boxes to a multiple of 8 with rows of weight 0 for
its jit's static shapes; the eager step takes the batch's boxes as they
are, which gives the same loss, and a batch without a box a loss of 0 (and
an update with zero gradients, as ``vtm``'s). They run in one process, as
``vtm``'s single-device jit does.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from vtm_torch.train import losses as loss_lib
from vtm_torch.train.optimizer import apply_update


def make_train_step(
    module: nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_name: str,
    multi_head: bool,
    accumulate_steps: int = 1,
    data_group=None,
) -> Callable:
    """Returns ``step(frames, labels, generator=None) -> (loss, logits,
    aux)``. ``labels`` is a tensor, or {"verb", "noun"} tensors for the
    twin heads, where the loss is 0.5 * (verb + noun) and aux is the
    (verb, noun) pair of losses. ``generator`` draws the dropout and
    stochastic-depth masks. loss, logits and aux are detached; with
    ``data_group``, loss and aux are the means over its ranks."""
    base_loss = loss_lib.get_loss_func(loss_name)
    k = max(1, int(accumulate_steps))
    micro_step = 0

    def step(frames, labels, generator: Optional[torch.Generator] = None):
        nonlocal micro_step
        module.train()
        defer = micro_step < k - 1 and isinstance(module, DistributedDataParallel)
        with module.no_sync() if defer else contextlib.nullcontext():
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
        return _global_mean(loss.detach(), data_group), logits, tuple(_global_mean(a, data_group) for a in aux)

    return step


def _global_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group``; ``x`` without one."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x / dist.get_world_size(group)


def make_eval_step(module: nn.Module) -> Callable:
    """Returns ``step(frames, generator=None) -> logits``: a forward in eval
    mode without autograd; ``generator`` draws the random merge modes'
    scores. The conv families' BatchNorms then use their running statistics."""

    def step(frames, generator: Optional[torch.Generator] = None):
        module.eval()
        with torch.inference_mode():
            logits, _ = module(frames, generator=generator)
        return logits

    return step


def _update_step(module: nn.Module, optimizer: torch.optim.Optimizer, accumulate_steps: int, loss_of) -> Callable:
    """A step around ``loss_of(generator, *args) -> (loss, [tensors])`` (the
    per-depth losses of pretraining, a detection step's logits): the module
    in training mode, the backward, the update every ``accumulate_steps``
    calls; returns the loss and the tensors, detached."""
    k = max(1, int(accumulate_steps))
    micro_step = 0

    def step(*args, generator: Optional[torch.Generator] = None):
        nonlocal micro_step
        module.train()
        loss, multi = loss_of(generator, *args)
        (loss / k if k > 1 else loss).backward()
        micro_step += 1
        if micro_step == k:
            apply_update(optimizer)
            micro_step = 0
        return loss.detach(), [m.detach() for m in multi]

    return step


def make_mae_train_step(module: nn.Module, optimizer: torch.optim.Optimizer, accumulate_steps: int = 1) -> Callable:
    """MAE pretraining (``MASK.MAE_ON``): ``step(frames, mask,
    generator=None) -> (loss, per-depth losses)``. The model makes its pixel
    labels from the frames on their device and draws its random noise from
    ``generator``; each depth's masked mse weighs ``1 / depths``."""

    def loss_of(generator, frames, mask):
        preds, labels, masks = module(frames, mask, generator=generator)
        return loss_lib.multiple_mse(preds, [(l, 1.0 / len(labels)) for l in labels], masks)

    return _update_step(module, optimizer, accumulate_steps, loss_of)


def make_maskfeat_train_step(module: nn.Module, optimizer: torch.optim.Optimizer,
                             accumulate_steps: int = 1) -> Callable:
    """MaskFeat pretraining: ``step(frames, mask, labels, generator=None) ->
    (loss, per-depth losses)`` with the per-depth HOG or pixel ``labels``
    given (``models/masked.py::maskfeat_hog_labels``), each depth's masked
    mse weighing 1."""

    def loss_of(generator, frames, mask, labels):
        preds, masks = module(frames, mask, generator=generator)
        return loss_lib.multiple_mse(preds, [(l, 1.0) for l in labels], masks)

    return _update_step(module, optimizer, accumulate_steps, loss_of)


def make_contrastive_train_step(model: nn.Module, optimizer: torch.optim.Optimizer) -> Callable:
    """``step(clips, index, epoch_exact, generator=None, update_param=True)
    -> (loss, logits)`` for a ``models.contrastive.ContrastiveModel``. SwAV's
    prototypes are re-normalised in place before the forward, outside the
    graph, and their gradient is zeroed while ``epoch_exact <= 1`` (the
    optimizer still steps them: momentum and weight decay, as in ``vtm``).
    ``update_param=False`` leaves the parameters and the optimizer's state
    as they are while the model's state advances. loss and logits are
    detached."""
    from vtm_torch.models.contrastive import l2_normalize

    protos = getattr(model, "swav_prototypes", None)

    def step(clips, index, epoch_exact: float, generator: Optional[torch.Generator] = None,
             update_param: bool = True):
        model.train()
        if protos is not None:
            with torch.no_grad():
                protos.weight.copy_(l2_normalize(protos.weight, dim=1))
        logits, loss = model(clips, index, epoch_exact=epoch_exact, generator=generator)
        loss.backward()
        if protos is not None and epoch_exact <= 1.0:
            protos.weight.grad.zero_()
        if update_param:
            apply_update(optimizer)
        else:
            optimizer.zero_grad(set_to_none=True)
        return loss.detach(), logits.detach()

    return step


def make_detection_eval_step(module: nn.Module) -> Callable:
    """Returns ``step(frames, boxes, generator=None) -> [N, classes]``: a
    forward in eval mode without autograd, one row of class scores (the
    head's sigmoid or softmax) for each of the [N, 5] boxes (batch index,
    x1, y1, x2, y2)."""

    def step(frames, boxes, generator: Optional[torch.Generator] = None):
        module.eval()
        with torch.inference_mode():
            scores, _ = module(frames, generator=generator, bboxes=boxes)
        return scores

    return step


def detection_loss(logits: torch.Tensor, labels: torch.Tensor, loss_name: str) -> torch.Tensor:
    """``vtm``'s per-box detection loss over [N, classes] logits and labels:
    ``bce_logit`` the mean over the classes of each box, any other loss box
    by box; then the mean over the boxes, 0 for none (``vtm``'s
    sum(per * w) / max(sum(w), 1) with every weight 1)."""
    labels = labels.to(logits.dtype)
    if loss_name == "bce_logit":
        per = F.binary_cross_entropy_with_logits(logits, labels, reduction="none").mean(dim=-1)
    else:
        base_loss = loss_lib.get_loss_func(loss_name)
        per = torch.stack([base_loss(lg[None], lb[None]) for lg, lb in zip(logits, labels)]) \
            if len(logits) else logits.sum(dim=-1)
    return per.sum() / max(per.shape[0], 1)


def make_detection_train_step(module: nn.Module, optimizer: torch.optim.Optimizer, loss_name: str,
                              accumulate_steps: int = 1) -> Callable:
    """AVA detection training: ``step(frames, boxes, labels, generator=None)
    -> (loss, [logits])`` with the batch's [N, 5] boxes and [N, classes]
    multi-hot labels; ``detection_loss``, the backward and the update (every
    ``accumulate_steps`` calls). ``generator`` draws the ROI head's dropout
    and the backbone's drop-connect masks."""
    loss_lib.get_loss_func(loss_name)  # an unknown name raises here, as in vtm's make_detection_train_step

    def loss_of(generator, frames, boxes, labels):
        logits, _ = module(frames, generator=generator, bboxes=boxes)
        return detection_loss(logits, labels, loss_name), [logits]

    return _update_step(module, optimizer, accumulate_steps, loss_of)
