"""TimeSformer pieces in PyTorch (port of ``vtm/models/timesformer.py``).

For now only the space fold that Motionformer's per-frame merging shares;
the TimeSformer model itself is not ported yet (ROADMAP.md Queue 1,
item 7).
"""

from __future__ import annotations

import torch


def _fold_space(body: torch.Tensor, b: int, t: int) -> torch.Tensor:
    """[B, P*T, D] ('(p t)' order) -> [(B*T), P, D]."""
    d = body.shape[-1]
    p = body.shape[1] // t
    return body.reshape(b, p, t, d).transpose(1, 2).reshape(b * t, p, d)


def _unfold_space(x: torch.Tensor, b: int, t: int) -> torch.Tensor:
    """[(B*T), P, D] -> [B, P*T, D]."""
    d = x.shape[-1]
    p = x.shape[1]
    return x.reshape(b, t, p, d).transpose(1, 2).reshape(b, p * t, d)
