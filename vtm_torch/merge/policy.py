"""MergePolicy — merging as a model component (port of ``vtm/merge/policy.py``).

The policy is an immutable spec passed to the model constructor; the
per-layer r schedule is resolved at build time, and per-forward state
(token sizes, the source adjacency, the generator of the random modes)
is carried in a ``MergeState``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from vtm_torch.merge import bipartite
from vtm_torch.merge.bipartite import DROP_MODES, MERGE_MODES
from vtm_torch.merge.schedule import token_counts

ALL_MODES = MERGE_MODES + DROP_MODES + ("hybrid", "none")


@dataclasses.dataclass(frozen=True)
class MergePolicy:
    """Static merging configuration for one model.

      mode: merge | random_merge | drop | random_drop | hybrid | none
      rs:   per-layer r values (use ``parse_r`` to expand an int/tuple)
      prop_attn: add log(size) to attention logits
      head_aggregation: 'mean' | 'concat' over heads for the metric
      threshold: the hybrid mode's drop threshold on an edge's score
      trace_source: carry the [B, n_t, n_0] source adjacency (visualisation)
      class_token: token 0 is a class token, never merged
      distill_token: token 1 is a distillation token, never merged
    """

    rs: Tuple[int, ...] = ()
    mode: str = "none"
    prop_attn: bool = True
    head_aggregation: str = "mean"
    threshold: float = 0.0
    trace_source: bool = False
    class_token: bool = False
    distill_token: bool = False

    def __post_init__(self):
        if self.mode not in ALL_MODES:
            raise ValueError(f"unknown merge mode {self.mode!r}")
        object.__setattr__(self, "rs", tuple(int(r) for r in self.rs))

    @property
    def enabled(self) -> bool:
        return self.mode != "none" and any(r > 0 for r in self.rs)

    @property
    def needs_rng(self) -> bool:
        return self.mode in ("random_merge", "random_drop")

    def r_at(self, layer: int) -> int:
        if layer >= len(self.rs):
            return 0
        return self.rs[layer]

    def token_counts(self, n0: int) -> Tuple[int, ...]:
        """Token count entering each layer (len(rs)+1 entries)."""
        if self.mode == "none":
            return tuple([n0] * (len(self.rs) + 1))
        return tuple(token_counts(n0, self.rs, int(self.class_token) + int(self.distill_token)))


@dataclasses.dataclass
class MergeState:
    """Per-forward companion of MergePolicy, carried through the layer
    stack: ``size`` [B, n, 1] fp32 token multiplicities, ``source``
    [B, n, n0] adjacency (when traced), and ``generator``, from which the
    random modes draw one score tensor a layer."""

    size: Optional[torch.Tensor] = None
    source: Optional[torch.Tensor] = None
    generator: Optional[torch.Generator] = None

    def attn_size(self, prop_attn: bool) -> Optional[torch.Tensor]:
        return self.size if prop_attn else None


def reduce_tokens(
    policy: MergePolicy,
    layer: int,
    metric: torch.Tensor,
    x: torch.Tensor,
    state: MergeState,
) -> Tuple[torch.Tensor, MergeState]:
    """Apply the layer's token reduction: ``metric`` [B, n, Cm] and ``x``
    [B, n, C] -> x with n - r tokens, and the updated state. B may be a
    folded (batch x frames) axis for the per-frame models."""
    r = policy.r_at(layer)
    if policy.mode == "none" or r <= 0:
        return x, state
    generator = state.generator if policy.needs_rng else None
    args = (metric, r, policy.class_token, policy.distill_token)

    if policy.mode in MERGE_MODES:
        m = bipartite.bipartite_soft_matching(*args, policy.mode, generator)
        if policy.trace_source:
            state.source = bipartite.merge_source(m, x, state.source)
        x, state.size = bipartite.merge_wavg(m, x, state.size)
        return x, state

    if policy.mode in DROP_MODES:
        m = bipartite.bipartite_soft_matching_drop(*args, policy.mode, generator)
        if policy.trace_source:
            state.source = bipartite.drop_source(m, x, state.source)
        x = bipartite.drop(m, x)
        # every kept token stands for itself again: with prop_attn the
        # next attention gets a zero bias, not none
        state.size = torch.ones(x.shape[:2] + (1,), dtype=torch.float32, device=x.device)
        return x, state

    # hybrid
    m = bipartite.bipartite_soft_matching_hybrid(*args, "merge", policy.threshold, generator)
    if policy.trace_source:
        state.source = bipartite.merge_source(m, x, state.source, threshold=policy.threshold)
    x, state.size = bipartite.merge_wavg(m, x, state.size, threshold=policy.threshold)
    return x, state
