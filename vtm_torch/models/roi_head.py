"""The AVA detection head (port of ``vtm/models/roi_head.py``): upstream
PySlowFast's ``ResNetRoIHead`` semantics. Each pathway is averaged over
time, ``roi_align`` samples every box on it, each ROI is max-pooled over
space, the pathways are concatenated, then dropout (training only),
``detach_final_fc`` and the fp32 ``projection``; the sigmoid or softmax
applies only outside training.

``roi_align`` is ``vtm``'s arithmetic, not torchvision's ``roi_align``: a
fixed grid of ``samples_per_bin`` x ``samples_per_bin`` bilinear samples a
bin; ``aligned`` subtracts half a pixel, and without it a box is at least
one feature pixel wide and high; every sample point is clamped to the map
(a point past an edge reads the edge row or column, it is not zeroed), its
weights clipped to [0, 1]; the batch index is ``boxes[:, 0]`` truncated to
an integer.

Bilinear sampling on a fixed grid is separable: a bin's value is
``sum_y sum_x a_y(y) a_x(x) feat[b, y, x]``, where ``a_y`` holds the bin's
two rows of samples, each sample's (1 - wy) at its clamped floor row and
wy at the row after (summed where the clamp makes the two one row), and
averages them, and ``a_x`` likewise over columns. So ``roi_align`` builds
those weights as dense [N, R, B * H] and [N, R, W] matrices (the batch
index as a one-hot factor of the first) and takes two matrix products,
with no gather. Its backward is two more products, with no scatter: no
atomics on CUDA, the same bits on every run, where a gather's backward
(four corners scattered per sample) would add them in any order.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from vtm_torch.models.common import dropout
from vtm_torch.models.convnet import at_least_fp32


def _axis_weights(lo: torch.Tensor, hi: torch.Tensor, size: int, resolution: int, samples: int) -> torch.Tensor:
    """[N, resolution, size]: each bin's mean over its ``samples`` sample
    points along one axis, of that axis's bilinear weights, for boxes that
    span [lo, hi] in feature pixels."""
    g = resolution * samples
    steps = (torch.arange(g, device=lo.device, dtype=lo.dtype) + 0.5) / g
    pos = lo[:, None] + steps[None, :] * (hi - lo)[:, None]  # [N, g]
    p0 = torch.clamp(torch.floor(pos), 0, size - 1)
    p1 = torch.clamp(p0 + 1, 0, size - 1)
    w = torch.clamp(pos - p0, 0.0, 1.0)
    grid = torch.arange(size, device=lo.device, dtype=lo.dtype)
    a = (1 - w)[..., None] * (grid == p0[..., None]) + w[..., None] * (grid == p1[..., None])
    return a.reshape(lo.shape[0], resolution, samples, size).mean(dim=2)


def roi_align(
    feat: torch.Tensor,  # [B, H, W, C]
    boxes: torch.Tensor,  # [N, 5]: (batch_idx, x1, y1, x2, y2) in input pixels
    resolution: int,
    spatial_scale: float,
    aligned: bool = True,
    samples_per_bin: int = 2,
) -> torch.Tensor:
    """[N, resolution, resolution, C] bilinear ROI features (the module
    docstring), in ``feat``'s dtype."""
    b, h, w, c = feat.shape
    boxes = boxes.to(feat.dtype)
    b_idx = boxes[:, 0].to(torch.int64)  # truncated, as vtm's astype(int32)
    offset = 0.5 if aligned else 0.0
    x1 = boxes[:, 1] * spatial_scale - offset
    y1 = boxes[:, 2] * spatial_scale - offset
    x2 = boxes[:, 3] * spatial_scale - offset
    y2 = boxes[:, 4] * spatial_scale - offset
    if not aligned:
        x2 = torch.maximum(x2, x1 + 1.0)
        y2 = torch.maximum(y2, y1 + 1.0)
    n = boxes.shape[0]
    a_y = _axis_weights(y1, y2, h, resolution, samples_per_bin)  # [N, R, H]
    a_x = _axis_weights(x1, x2, w, resolution, samples_per_bin)  # [N, R, W]
    pick = (torch.arange(b, device=feat.device) == b_idx[:, None]).to(feat.dtype)  # [N, B]
    rows = (pick[:, None, :, None] * a_y[:, :, None, :]).reshape(n * resolution, b * h)
    # [N * R, B * H] @ [B * H, W * C]: each box's rows of bins, over its own map
    out = (rows @ feat.reshape(b * h, w * c)).reshape(n, resolution, w, c)
    # [N, R_y, W, C] -> [N, R_y, R_x, C]
    return torch.einsum("nixc,njx->nijc", out, a_x)


class ResNetRoIHead(nn.Module):
    """Upstream SlowFast's ROI head (the module docstring). ``forward(xs,
    boxes, generator=None)`` takes the pathways' maps [B, C, T, H, W] (any
    memory format; a bf16 map is sampled in fp32) and the [N, 5] boxes;
    returns [N, num_classes] in the projection's dtype, fp32 unless the
    module was cast."""

    def __init__(self, dim_in: Sequence[int], num_classes: int, resolution: Sequence[int],
                 scale_factor: Sequence[int], dropout_rate: float = 0.0, act_func: str = "sigmoid",
                 aligned: bool = True, detach_final_fc: bool = False):
        super().__init__()
        self.resolution, self.scale_factor = tuple(resolution), tuple(scale_factor)
        self.dropout_rate, self.act_func = dropout_rate, act_func
        self.aligned, self.detach_final_fc = aligned, detach_final_fc
        self.projection = nn.Linear(sum(dim_in), num_classes)

    def pooled(self, xs, boxes: torch.Tensor) -> torch.Tensor:
        """[N, sum(C)]: each pathway's temporal mean, ``roi_align``, the max
        over each ROI's bins, concatenated."""
        feats = []
        for p, x in enumerate(xs):
            # [B, H, W, C], fp32 at least (vtm's bf16 map meets fp32 weights)
            x = x.mean(dim=2).permute(0, 2, 3, 1).to(at_least_fp32(x.dtype))
            roi = roi_align(x, boxes, self.resolution[p], 1.0 / float(self.scale_factor[p]), aligned=self.aligned)
            feats.append(roi.amax(dim=(1, 2)))
        return torch.cat(feats, dim=-1)

    def forward(self, xs, boxes: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(self.pooled(xs, boxes), self.dropout_rate, self.training, generator)
        if self.detach_final_fc:
            x = x.detach()
        x = self.projection(x.to(self.projection.weight.dtype))
        if not self.training:
            if self.act_func == "sigmoid":
                x = torch.sigmoid(x)
            elif self.act_func == "softmax":
                x = torch.softmax(x, dim=-1)
        return x
