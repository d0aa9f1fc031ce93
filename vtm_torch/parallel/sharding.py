"""Tensor-parallel (Megatron) cuts of the ViT block stack (port of
``vtm/parallel/sharding.py``).

``vtm`` states the cuts as PartitionSpecs by parameter name and lets
GSPMD insert the collectives. Here the same name rules cut the
``nn.Linear`` weights in place (``shard_module``), and the model code
calls two collectives of its own over the ``model`` group:

  * ``f`` (``copy_to_model``): identity forward, all-reduce backward, at
    the input of each column-parallel group (the attention's q/k/v, the
    MLP's first layer);
  * ``g`` (``reduce_from_model``): all-reduce forward, identity backward,
    after each row-parallel product, whose bias is added after the reduce
    (``models/common.py::Linear``).

``torch.distributed.nn.functional.all_reduce`` is not ``g``: its backward
all-reduces a gradient that is already the same on every rank, which
scales it by the group's size.

Rules by parameter name (module, leaf), as in ``vtm``:
  qkv / query / key / value / fc1 / intermediate / proj_q / proj_kv
      weight and bias cut along the output features (column parallel);
  proj / attention_output / fc2 / output
      weight cut along the input features (row parallel), bias whole;
  everything else (embeddings, norms, heads, class token) whole.
Two departures, both forced by cutting in place rather than by spec: the
fused ``qkv`` [3C, C] is cut as three parts, so that rank r holds heads
r*H/tp ... of q, of k and of v; and VideoMAE's ``q_bias`` / ``v_bias``
(whole in ``vtm``, where GSPMD reshards them) are cut with q and v.

Each cut parameter carries its ``Cut`` (``param.tp_cut``), from which
``full_state_dict`` gathers it back and ``load_full_state_dict`` takes
this rank's piece of a whole tensor; the optimizer's state follows the
same cuts (``full_optimizer_state``, ``load_optimizer_state``).

Cut: VideoMAE and ViViT, the dense-attention families (their classes'
``supports_tensor_parallel``). The conv families (SlowFast, ResNet, X3D)
stay whole on every rank of a model group (``replicated_over_model``).
TimeSformer and Motionformer raise (ROADMAP.md Queue 1, item 15).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

# column-parallel: output features cut (bias cut too)
_COL = ("qkv", "query", "key", "value", "fc1", "intermediate", "proj_q", "proj_kv")
# row-parallel: input features cut, output all-reduced (bias whole, added after)
_ROW = ("proj", "attention_output", "fc2", "output")
# VideoMAE's split biases of the fused qkv, cut with q and v
_HEAD_BIASES = ("q_bias", "v_bias")
# fused projections: parts cut alike (q, k, v)
_FUSED = {"qkv": 3}



def check_tensor_parallel(cfg) -> None:
    """Raise for ``TPU.MODEL_PARALLEL`` > 1 on a family that has no cuts and
    is not held whole on every rank, before its model is built."""
    from vtm_torch.models import MODEL_CLASSES

    module_class = MODEL_CLASSES.get(cfg.MODEL.MODEL_NAME)
    if cfg.TPU.MODEL_PARALLEL > 1 and not (getattr(module_class, "supports_tensor_parallel", False)
                                          or getattr(module_class, "replicated_over_model", False)):
        raise NotImplementedError(
            f"TPU.MODEL_PARALLEL > 1 for {cfg.MODEL.MODEL_NAME}: its tensor-parallel cuts "
            "are not ported yet (ROADMAP.md Queue 1, item 15)"
        )


class _CopyToModel(torch.autograd.Function):
    """f: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllReduceSum(torch.autograd.Function):
    """All-reduce (sum) forward, all-reduce (sum) backward: a sum over the
    group whose every rank's loss depends on every rank's part, as the
    BatchNorm statistics of the global batch do."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, its gradient summed over it too."""
    return _AllReduceSum.apply(x, group)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``f`` over ``group``; identity without one."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """``g`` over ``group``; identity without one."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_heads(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's features [..., F] -> every rank's, in rank order along
    the last axis (no gradient: the matching metric's use)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    return torch.cat(parts, dim=-1)


@dataclasses.dataclass(frozen=True)
class Cut:
    """How a parameter is cut: axis ``dim`` split into ``parts`` equal
    parts (3 for a fused qkv), each split ``ways`` ways; this rank holds
    piece ``rank`` of every part. ``group`` is the model group."""

    dim: int
    parts: int
    ways: int
    rank: int
    group: object = dataclasses.field(default=None, compare=False, repr=False)


def cut_rule(name: str, ndim: int) -> Optional[Tuple[int, int]]:
    """(dim, parts) of the parameter ``name`` (torch's dotted name), or
    None when it stays whole."""
    names = name.split(".")
    leaf, module = names[-1], (names[-2] if len(names) >= 2 else "")
    if module in _COL and ((leaf == "weight" and ndim == 2) or (leaf == "bias" and ndim == 1)):
        return 0, _FUSED.get(module, 1)
    if module in _ROW and leaf == "weight" and ndim == 2:
        return 1, 1
    if leaf in _HEAD_BIASES and ndim == 1:
        return 0, 1
    return None


def take(full: torch.Tensor, cut: Cut) -> torch.Tensor:
    """This rank's piece of a whole tensor."""
    n = full.shape[cut.dim]
    if n % (cut.parts * cut.ways):
        raise ValueError(f"axis {cut.dim} of {tuple(full.shape)} does not split {cut.parts} x {cut.ways} ways")
    v = full.unflatten(cut.dim, (cut.parts, cut.ways, n // (cut.parts * cut.ways)))
    return v.select(cut.dim + 1, cut.rank).flatten(cut.dim, cut.dim + 1).contiguous()


def join(pieces, cut: Cut) -> torch.Tensor:
    """The whole tensor from every rank's piece, in rank order."""
    stacked = torch.stack([p.unflatten(cut.dim, (cut.parts, -1)) for p in pieces], dim=cut.dim + 1)
    return stacked.flatten(cut.dim, cut.dim + 2)


def gather(piece: torch.Tensor, cut: Cut) -> torch.Tensor:
    parts = [torch.empty_like(piece) for _ in range(cut.ways)]
    dist.all_gather(parts, piece.contiguous(), group=cut.group)
    return join(parts, cut)


def shard_module(module: nn.Module, mesh) -> nn.Module:
    """Cut ``module``'s parameters for this rank of ``mesh``'s model group,
    in place: the rules above, the attention modules' head counts divided,
    and the model group set where the model code applies ``f`` (modules
    with a column-cut child) and ``g`` (row-cut ``Linear``s). Build the
    optimizer after this. A no-op at model width 1."""
    if mesh.model == 1 or getattr(module, "replicated_over_model", False):
        return module
    if not getattr(module, "supports_tensor_parallel", False):
        raise NotImplementedError(
            f"{type(module).__name__}: tensor-parallel cuts are ported for VideoMAE and ViViT "
            "only (ROADMAP.md Queue 1, item 15)"
        )
    from vtm_torch.models.common import Linear

    ways, rank, group = mesh.model, mesh.model_rank, mesh.model_group
    for name, sub in module.named_modules():
        for pname, p in list(sub.named_parameters(recurse=False)):
            rule = cut_rule(f"{name}.{pname}", p.dim())
            if rule is None:
                continue
            cut = Cut(*rule, ways=ways, rank=rank, group=group)
            new = nn.Parameter(take(p.data, cut), requires_grad=p.requires_grad)
            new.tp_cut = cut
            setattr(sub, pname, new)
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _ROW and isinstance(sub, Linear):
            sub.model_group = group
        if any(child in _COL for child, _ in sub.named_children()):
            sub.model_group = group
            if hasattr(sub, "num_heads"):
                if sub.num_heads % ways:
                    raise ValueError(f"{name}: {sub.num_heads} heads do not split {ways} ways")
                sub.num_heads //= ways
    return module


def is_cut(p: torch.Tensor) -> bool:
    return getattr(p, "tp_cut", None) is not None


def _cuts(module: nn.Module) -> Dict[str, Cut]:
    return {n: p.tp_cut for n, p in module.named_parameters() if is_cut(p)}


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The whole model's state dict: the cut parameters gathered over the
    model group (a collective: every rank of it calls). The module's own
    ``state_dict()`` when nothing is cut."""
    cuts = _cuts(module)
    sd = module.state_dict()
    return {k: (gather(v, cuts[k]) if k in cuts else v) for k, v in sd.items()}


def load_full_state_dict(module: nn.Module, sd: Mapping[str, torch.Tensor], strict: bool = True):
    """Load a whole model's state dict, each cut parameter taking this
    rank's piece."""
    cuts = _cuts(module)
    return module.load_state_dict({k: (take(v, cuts[k]) if k in cuts else v) for k, v in sd.items()},
                                  strict=strict)


def _optimizer_params(optimizer):
    return [p for g in optimizer.param_groups for p in g["params"]]


def _map_state(optimizer, sd: dict, fn) -> dict:
    """``sd`` with ``fn(tensor, cut)`` applied to the per-parameter state
    tensors shaped like a cut parameter (moments; not Adam's step count)."""
    params = _optimizer_params(optimizer)
    state = {}
    for idx, st in sd["state"].items():
        cut = getattr(params[idx], "tp_cut", None)
        state[idx] = {k: (fn(v, cut) if cut is not None and torch.is_tensor(v) and v.dim() > 0 else v)
                      for k, v in st.items()}
    return dict(sd, state=state)


def full_optimizer_state(optimizer) -> dict:
    """The optimizer's state dict with each cut parameter's state gathered
    whole (a collective over the model group)."""
    return _map_state(optimizer, optimizer.state_dict(), gather)


def load_optimizer_state(optimizer, sd: dict) -> None:
    """Load a whole optimizer state dict, each cut parameter's state
    taking this rank's piece."""
    optimizer.load_state_dict(_map_state(optimizer, sd, take))
