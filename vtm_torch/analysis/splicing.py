"""Clip-splicing analysis datasets (the paper's semantics probe; copy of
``vtm/analysis/splicing.py``).

Functional parity with the reference wrappers
(slowfast/datasets/dataset_utils.py:29-206): replace
``num_to_replace`` tubelet-aligned groups of ``patch_depth`` frames in
each clip with the same frames from a donor clip chosen by policy:

  * ``random``      — uniform random donor (RandomKinetics/Ssv2/Epickitchens)
  * ``same_class``  — donor shares the clip's label (SameClass*); for
                      EPIC-KITCHENS ``match_type`` selects verb or noun
  * ``kl_similarity`` — donor minimises prediction-KL among same-class
                      clips (KLSimilarityEpickitchens), using matrices
                      produced by vtm_torch.analysis.dataset_tools

Quirk preserved from the reference (dataset_utils.py:40): the donor
tubelet groups are drawn from ``range(T // patch_depth - 1)`` — the
LAST tubelet is never replaced.

One generic ``SplicedDataset`` replaces the reference's six
near-identical classes; the named constructors keep API parity.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class SplicedDataset:
    """Wrap any vtm_torch dataset (items: dict with 'frames' [T,H,W,C]) and
    splice donor frames into every clip."""

    def __init__(
        self,
        base,
        policy: str,
        patch_depth: int,
        num_to_replace: int,
        match_type: Optional[str] = None,
        kl_divergences: Optional[np.ndarray] = None,
        seed: int = 0,
    ):
        assert policy in ("random", "same_class", "kl_similarity")
        self.base = base
        self.policy = policy
        self.patch_depth = patch_depth
        self.num_to_replace = num_to_replace
        self.match_type = match_type
        self.kl_divergences = kl_divergences
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.base)

    # ------------------------------------------------------------- helpers

    def _frames_to_insert(self, num_frames: int) -> list:
        """Tubelet-aligned frame indices (reference dataset_utils.py:40,
        incl. the last-group exclusion quirk)."""
        pd = self.patch_depth
        groups = self.rng.choice(
            num_frames // pd - 1, self.num_to_replace, replace=False
        )
        return sorted(int(pd * g + o) for g in groups for o in range(pd))

    def _labels_of(self, which: str) -> list:
        base = self.base
        if which == "verb" and hasattr(base, "_verb_labels"):
            return base._verb_labels
        if which == "noun" and hasattr(base, "_noun_labels"):
            return base._noun_labels
        return base._labels

    def _label_value(self, label, which: str):
        if isinstance(label, dict):
            return label[which]
        return label

    def _donor_index(self, index: int, label) -> int:
        if self.policy == "random":
            return int(self.rng.choice(len(self), 1)[0])
        which = self.match_type or "verb"
        labels = self._labels_of(which)
        target = self._label_value(label, which)
        same = [i for i, x in enumerate(labels) if x == target]
        if self.policy == "same_class":
            return int(self.rng.choice(same, 1)[0])
        # kl_similarity: min-KL donor among same-class clips
        assert self.kl_divergences is not None, (
            "kl_similarity needs cached KL matrices "
            "(vtm_torch.analysis.dataset_tools.cache_kl_divergences)"
        )
        kl = self.kl_divergences[0 if which == "verb" else 1]
        row = np.array(kl[index], copy=True)
        mask = np.ones(len(row), dtype=bool)
        mask[same] = False
        row[mask] = np.inf
        return int(np.argmin(row))

    # --------------------------------------------------------------- item

    def __getitem__(self, index: int) -> dict:
        item = self.base[index]
        frames = np.array(item["frames"], copy=True)
        to_insert = self._frames_to_insert(frames.shape[0])
        donor_idx = self._donor_index(index, item["label"])
        donor = self.base[donor_idx]["frames"]
        for f in to_insert:
            frames[f] = donor[f]
        out = dict(item)
        out["frames"] = frames
        return out


def _named(policy):
    def ctor(base, patch_depth, num_to_replace, match_type=None, kl_divergences=None, seed=0):
        return SplicedDataset(
            base, policy, patch_depth, num_to_replace, match_type, kl_divergences, seed
        )

    return ctor


# API-parity constructors (reference class names, dataset passed in)
RandomKinetics = RandomSsv2 = RandomEpickitchens = _named("random")
SameClassKinetics = SameClassSsv2 = SameClassEpickitchens = _named("same_class")
KLSimilarityEpickitchens = _named("kl_similarity")
