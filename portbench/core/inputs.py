"""Weights and inputs, made on the device from the run's seed in a few
large draws. The same seed gives the same weights, videos and labels; the
program and the reference are handed the same tensors."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

WEIGHTS, VIDEOS, LABELS = 0, 1, 2  # the streams drawn from one seed


def generator(seed: int, stream: int, device) -> torch.Generator:
    state = int(np.random.SeedSequence([int(seed), stream]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(state)


def make_params(specs, seed: int, device, round_to=None) -> dict:
    """{name: float32 tensor}: base + 0.02 * a normal draw cut at two
    deviations, all leaves from one draw. ``round_to`` rounds every value to
    that type first (the type the weights are served in), so both sides get
    the same numbers."""
    sizes = [math.prod(shape) for _, shape, _ in specs]
    flat = torch.randn(sum(sizes), generator=generator(seed, WEIGHTS, device), device=device)
    base = torch.repeat_interleave(torch.tensor([b for _, _, b in specs], device=device),
                                   torch.tensor(sizes, device=device))
    flat = flat.clamp_(-2.0, 2.0).mul_(0.02).add_(base)
    if round_to is not None:
        flat = flat.to(round_to).float()
    return {name: t.view(shape) for (name, shape, _), t in zip(specs, flat.split(sizes))}


def make_videos(count: int, batch: int, frames: int, side: int, video: dict, seed: int, device) -> list:
    """``count`` batches of float32 clips [B, T, H, W, 3], normalised pixels:
    a coarse random motion field of ``video["coarse"]`` (t, h, w) cells,
    interpolated to full size, plus ``video["noise"]`` of per-pixel noise.
    Neighbouring patches are alike, as in real video, which is what token
    merging exploits."""
    g = generator(seed, VIDEOS, device)
    t, h, w = video["coarse"]
    out = []
    for _ in range(count):
        coarse = torch.randn((batch, 3, t, h, w), generator=g, device=device)
        clip = F.interpolate(coarse, size=(frames, side, side), mode="trilinear", align_corners=False)
        clip = clip.permute(0, 2, 3, 4, 1).contiguous()
        out.append(clip.add_(torch.randn(clip.shape, generator=g, device=device), alpha=video["noise"]))
    return out


def make_labels(count: int, batch: int, classes: int, seed: int, device) -> list:
    g = generator(seed, LABELS, device)
    return [torch.randint(0, classes, (batch,), generator=g, device=device) for _ in range(count)]
