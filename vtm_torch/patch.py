"""Migration surface for the reference's users: ``tome.patch.X`` ->
``vtm_torch.patch.X`` (copy of ``vtm/patch.py``).

The reference monkey-patches module classes and then sets ``model.r``.
Here "patching" gives the bundle's module and each of its blocks a new
``MergePolicy`` (the same weights: merging has none), and ``bundle.r =
...`` sets the static per-layer schedule:

    bundle = build_model(cfg, "cuda")
    vtm_torch.patch.videomae(bundle, trace_source=True, prop_attn=False)
    bundle.r = 150                     # int | (r, inflect) | [r0, r1, ...]
    logits, state = bundle.apply(clip)
    source = state.source              # the reference's _tome_info['source']

``mode=`` (merge, random_merge, drop, random_drop, hybrid) and
``threshold=`` (hybrid) pass through to the policy; the random modes draw
from the generator given to ``bundle.apply``. ``duplicate_*`` runs one
block ``quantity`` times; set ``bundle.r`` after it, so that the schedule
is parsed against the grown stack.
"""

from __future__ import annotations

from vtm_torch.merge.policy import MergePolicy


def _apply(bundle, class_token: bool, prop_attn: bool, trace_source: bool = False, **kwargs) -> None:
    bundle.set_policy(MergePolicy(
        rs=(0,) * bundle.module.config.depth,
        mode=kwargs.get("mode", "merge"),
        prop_attn=prop_attn,
        head_aggregation=kwargs.get("head_aggregation", "mean"),
        threshold=kwargs.get("threshold", 0.0),
        trace_source=trace_source,
        class_token=class_token,
    ))


def vivit(bundle, trace_source: bool = False, prop_attn: bool = True, **kw) -> None:
    """reference tome.patch.vivit (tome/patch/vivit.py:226-270)."""
    assert bundle.name == "ViViT", bundle.name
    _apply(bundle, class_token=True, prop_attn=prop_attn, trace_source=trace_source, **kw)


def videomae(bundle, trace_source: bool = False, prop_attn: bool = False, **kw) -> None:
    """reference tome.patch.videomae (prop_attn=False default,
    tome/patch/videomae.py:172-214)."""
    assert bundle.name == "VideoMAE", bundle.name
    _apply(bundle, class_token=False, prop_attn=prop_attn, trace_source=trace_source, **kw)


def timesformer(bundle, trace_source: bool = False, prop_attn: bool = True, **kw) -> None:
    """reference tome.patch.timesformer (tome/patch/timesformer.py:187-224)."""
    assert bundle.name == "TimeSformer", bundle.name
    _apply(bundle, class_token=False, prop_attn=prop_attn, trace_source=trace_source, **kw)


def motionformer(bundle, trace_source: bool = False, prop_attn: bool = True, **kw) -> None:
    """reference tome.patch.motionformer (tome/patch/motionformer.py:247-284)."""
    assert bundle.name == "Motionformer", bundle.name
    _apply(bundle, class_token=False, prop_attn=prop_attn, trace_source=trace_source, **kw)


def _duplicate(bundle, layer_to_duplicate: int, quantity: int) -> None:
    """reference tome.patch.duplicate_* (apply_duplicate_patch): block
    ``layer_to_duplicate`` runs ``quantity`` times, the first quantity - 1
    as metric-only steps in VideoMAE and ViViT, in full with shared
    weights in TimeSformer and Motionformer."""
    depth = bundle.module.config.depth
    plan = [(i, False) for i in range(layer_to_duplicate)]
    plan += [(layer_to_duplicate, True)] * (quantity - 1) + [(layer_to_duplicate, False)]
    plan += [(i, False) for i in range(layer_to_duplicate + 1, depth)]
    if bundle.name in ("TimeSformer", "Motionformer"):
        bundle.module.layer_schedule = tuple(i for i, _ in plan)
    else:
        bundle.module.layer_schedule = tuple(plan)


duplicate_vivit = _duplicate
duplicate_videomae = _duplicate
duplicate_timesformer = _duplicate
duplicate_motionformer = _duplicate
