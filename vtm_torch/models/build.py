"""Model registry and build function (port of ``vtm/models/build.py``).

``build_model(cfg, device)`` returns a ``ModelBundle`` whose module holds
weights drawn from ``cfg.RNG_SEED``, cast to the compute dtype and moved
to ``device``, in eval mode. ``fp32_params=True`` (training) keeps every
parameter in fp32 and casts at use instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
from torch import nn

from vtm_torch.merge.bipartite import NOT_PORTED
from vtm_torch.merge.policy import MergePolicy
from vtm_torch.merge.schedule import parse_r

MODEL_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str):
    def deco(fn):
        MODEL_REGISTRY[name] = fn
        return fn

    return deco


@dataclasses.dataclass
class ModelBundle:
    """A built model: module (with its weights) + metadata."""

    module: nn.Module
    policy: MergePolicy
    name: str


def compute_dtype(cfg) -> torch.dtype:
    return {
        "bfloat16": torch.bfloat16,
        "float32": torch.float32,
        "float16": torch.float16,
    }[cfg.TPU.COMPUTE_DTYPE]


def make_policy(cfg, depth: int, n_protected_class_token: bool) -> MergePolicy:
    """Build the MergePolicy from the TOME.* config keys."""
    if not cfg.TOME.ENABLE:
        return MergePolicy(rs=(0,) * depth, mode="none")
    if cfg.TOME.LAYER_QUANTITY > 1:
        raise NotImplementedError(f"TOME.LAYER_QUANTITY > 1: layer duplication is {NOT_PORTED}")
    if cfg.TOME.TRACE_SOURCE:
        raise NotImplementedError(f"TOME.TRACE_SOURCE: source tracking is {NOT_PORTED}")
    r = (cfg.TOME.R_VALUE, cfg.TOME.SCHEDULE) if cfg.TOME.SCHEDULE else cfg.TOME.R_VALUE
    return MergePolicy(
        rs=tuple(parse_r(depth, r)),
        mode=cfg.TOME.MODE,
        prop_attn=cfg.TOME.PROP_ATTN,
        head_aggregation=cfg.TOME.HEAD_AGGREGATION,
        class_token=n_protected_class_token,
    )


def build_model(cfg, device: torch.device | str, fp32_params: bool = False) -> ModelBundle:
    name = cfg.MODEL.MODEL_NAME
    if name not in MODEL_REGISTRY:
        raise KeyError(
            f"Unknown MODEL.MODEL_NAME {name!r}; registered: {sorted(MODEL_REGISTRY)}"
        )
    bundle = MODEL_REGISTRY[name](cfg, fp32_params)
    bundle.module.to(device).eval()
    return bundle
