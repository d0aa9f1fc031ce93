"""Model registry and build function (port of ``vtm/models/build.py``).

``build_model(cfg, device)`` returns a ``ModelBundle`` whose module holds
weights drawn from ``cfg.RNG_SEED``, cast to the compute dtype and moved
to ``device``, in eval mode. ``fp32_params=True`` (training) keeps every
parameter in fp32 and casts at use instead. ``TOME.LAYER_QUANTITY > 1``
runs block ``TOME.LAYER_TO_DUPLICATE`` that many times
(``duplication_plan``), merging ``TOME.R_VALUE`` at each of those steps.

``DETECTION.ENABLE`` builds the AVA ROI head on SlowFast, ResNet and MViT
(``models/roi_head.py``); any other model raises TypeError, where ``vtm``'s
build fails initialising it with boxes. The PTV CSN and R(2+1)D build functions
raise first, with upstream's NotImplementedError.

The conv families (SlowFast, ResNet, X3D; ``models/slowfast.py``) merge
nothing: their bundle holds ``MergePolicy()``, their BatchNorm statistics
are buffers of the module, and, as in ``vtm``, ``bundle.r = ...`` and
``apply(trace_source=True)`` raise TypeError for them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from vtm_torch.merge.policy import MergePolicy
from vtm_torch.merge.schedule import parse_r

MODEL_REGISTRY: Dict[str, Callable] = {}
# model name -> the class of its module, whose attributes say what tensor
# parallelism does to it (``parallel/sharding.py``)
MODEL_CLASSES: Dict[str, type] = {}


def register_model(name: str, module_class: type):
    def deco(fn):
        MODEL_REGISTRY[name] = fn
        MODEL_CLASSES[name] = module_class
        return fn

    return deco


@dataclasses.dataclass
class ModelBundle:
    """A built model: module (with its weights) + metadata."""

    module: nn.Module
    policy: MergePolicy
    name: str

    def set_policy(self, policy: MergePolicy) -> None:
        """Make ``policy`` the bundle's and that of the module and every
        block in it, each of which holds its own reference."""
        self.policy = policy
        for m in self.module.modules():
            if isinstance(getattr(m, "policy", None), MergePolicy):
                m.policy = policy

    def apply(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None, trace_source: bool = False
    ):
        """One forward of the module: (logits, MergeState). ``generator``
        draws the random modes' scores; ``trace_source=True`` tracks the
        merge sources for this call (``state.source``) even if the policy
        was built without."""
        if trace_source:
            self._merging()
        if not trace_source or self.policy.trace_source:
            return self.module(x, generator=generator)
        policy = self.policy
        self.set_policy(dataclasses.replace(policy, trace_source=True))
        try:
            return self.module(x, generator=generator)
        finally:
            self.set_policy(policy)

    @property
    def r(self):
        """The reference's ``model.r`` surface (see ``vtm_torch.patch``):
        the per-layer merge schedule; assign int | (r, inflect) | [r0, r1, ...]."""
        return self.policy.rs

    def _merging(self) -> None:
        if not hasattr(self.module, "layer_schedule"):
            raise TypeError(f"{type(self.module).__name__} merges no tokens: it has no merge schedule")

    @r.setter
    def r(self, value):
        self._merging()
        # duplicated blocks lengthen the executed stack, and r is parsed
        # against it
        schedule = self.module.layer_schedule
        rs = tuple(parse_r(len(schedule) if schedule else self.module.config.depth, value))
        policy = dataclasses.replace(self.policy, rs=rs)
        if policy.mode == "none":
            policy = dataclasses.replace(policy, mode="merge")
        self.set_policy(policy)


def compute_dtype(cfg) -> torch.dtype:
    return {
        "bfloat16": torch.bfloat16,
        "float32": torch.float32,
        "float16": torch.float16,
    }[cfg.TPU.COMPUTE_DTYPE]


def duplication_plan(cfg, depth: int):
    """The executed block stack when duplication is on, else None:
    ``((block, metric_only), ...)`` with block ``L = TOME.LAYER_TO_DUPLICATE``
    run ``Q = TOME.LAYER_QUANTITY`` times, the first Q - 1 as metric-only
    steps (attention for the metric, then the reduction; VideoMAE and
    ViViT). TimeSformer and Motionformer take the block indices only and
    re-run the whole shared block."""
    if not cfg.TOME.ENABLE or cfg.TOME.LAYER_QUANTITY <= 1:
        return None
    L, q = cfg.TOME.LAYER_TO_DUPLICATE, cfg.TOME.LAYER_QUANTITY
    plan = [(i, False) for i in range(L)]
    plan += [(L, True)] * (q - 1) + [(L, False)]
    plan += [(i, False) for i in range(L + 1, depth)]
    return tuple(plan)


def make_policy(cfg, depth: int, n_protected_class_token: bool) -> MergePolicy:
    """Build the MergePolicy from the TOME.* config keys. With duplication
    the schedule is [0] * L + [R] * Q + [0] * (depth - 1 - L), one entry per
    executed step."""
    if not cfg.TOME.ENABLE:
        return MergePolicy(rs=(0,) * depth, mode="none")
    if cfg.TOME.LAYER_QUANTITY > 1:
        L, q = cfg.TOME.LAYER_TO_DUPLICATE, cfg.TOME.LAYER_QUANTITY
        rs = tuple([0] * L + [cfg.TOME.R_VALUE] * q + [0] * (depth - 1 - L))
    else:
        r = (cfg.TOME.R_VALUE, cfg.TOME.SCHEDULE) if cfg.TOME.SCHEDULE else cfg.TOME.R_VALUE
        rs = tuple(parse_r(depth, r))
    return MergePolicy(
        rs=rs,
        mode=cfg.TOME.MODE,
        prop_attn=cfg.TOME.PROP_ATTN,
        head_aggregation=cfg.TOME.HEAD_AGGREGATION,
        threshold=cfg.TOME.THRESHOLD,
        trace_source=cfg.TOME.TRACE_SOURCE,
        class_token=n_protected_class_token,
    )


def build_model(cfg, device: torch.device | str, fp32_params: bool = False) -> ModelBundle:
    name = cfg.MODEL.MODEL_NAME
    if name not in MODEL_REGISTRY:
        raise KeyError(
            f"Unknown MODEL.MODEL_NAME {name!r}; registered: {sorted(MODEL_REGISTRY)}"
        )
    bundle = MODEL_REGISTRY[name](cfg, fp32_params)
    if cfg.DETECTION.ENABLE and not cfg.MASK.ENABLE and not getattr(bundle.module, "takes_boxes", False):
        # vtm's build initialises such a model with boxes, which its __call__ does not take
        raise TypeError(f"{name} has no detection head: DETECTION.ENABLE needs SlowFast, ResNet or MViT "
                        "(vtm: __call__() got an unexpected keyword argument 'bboxes')")
    bundle.module.to(device).eval()
    return bundle
