"""Grad-CAM for the port's video models (port of ``vtm/vis/gradcam.py``;
reference: slowfast/visualization/gradcam_utils.py GradCAM:12-188).

A forward hook on the target module swaps its output (a conv stage's
slow pathway, a block's tokens) for a leaf tensor that requires a
gradient, and ``torch.autograd.grad(score, leaf)`` is the gradient of the
score with respect to that activation: what ``vtm`` takes with ``jax.grad``
with respect to a zero perturbation of it. The forward below the target
runs without autograd and the backward stops at the target: no parameter
gets a gradient, and on the card the attention kernels' backward (K2, K4,
K5b) runs through the blocks above the target only.

When tokens are merged the map is broadcast back to the original token
grid through the source adjacency before it is reshaped; source tracing is
forced for the call when the policy merges without it, as in ``vtm``. The
source is the one the target block hands on, which groups the tokens of
its output; ``vtm`` takes the model's final one, which is that same source
only when the target is the last block (at an earlier block of a merged
model ``vtm``'s map pairs the target's tokens with the last block's
groups: ROADMAP.md Queue 3).
Layer names are ``vtm``'s flax paths (``blocks_5``, ViViT's ``layer_11``,
a conv stage ``s5``, ``blocks_0/attn``) or the module's own dotted names
(``blocks.5``). The maps and predictions come back as fp32 numpy.
``overlay`` needs matplotlib for its colormap; the map itself does not.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

CONV_FAMILIES = ("SlowFast", "ResNet", "X3D")
CLASS_TOKEN_FAMILIES = ("ViViT", "TimeSformer", "Motionformer")


def resolve_layer(module: nn.Module, name: str) -> nn.Module:
    """The submodule that ``name`` names: a dotted module name, or a flax
    path of ``vtm`` ('/'-separated, a list entry as ``<list>_<i>``)."""
    modules = dict(module.named_modules())
    if name in modules:
        return modules[name]
    parts = []
    for part in name.split("/"):
        m = re.fullmatch(r"(.+)_(\d+)", part)
        if m and isinstance(modules.get(".".join(parts + [m.group(1)])), nn.ModuleList):
            parts += [m.group(1), m.group(2)]
        else:
            parts.append(part)
    dotted = ".".join(parts)
    if dotted not in modules:
        raise KeyError(f"target layer {name!r} not found in {type(module).__name__} "
                       "(use the flax path, e.g. 'blocks_5', or the module name, e.g. 'blocks.5')")
    return modules[dotted]


def _colormap(name: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt.get_cmap(name)


class GradCAM:
    """Localization maps for a ``ModelBundle``.

    ``target_layer``: ``vtm``'s flax path or the module name (default: the
    last block, or ``s5`` for the conv families)."""

    def __init__(self, bundle, target_layer: Optional[str] = None, colormap: str = "viridis"):
        self.bundle = bundle
        self.module = bundle.module
        policy = bundle.policy
        # merged maps must be unrolled through the source adjacency to
        # reshape to the original grid: trace it for the call
        self.force_trace = policy.mode != "none" and any(policy.rs) and not policy.trace_source
        config = self.module.config
        depth = getattr(config, "depth", None) or getattr(config, "num_hidden_layers", 12)
        self.is_conv = bundle.name in CONV_FAMILIES
        if self.is_conv:
            self.target_layer = target_layer or "s5"
        else:
            prefix = "layer" if bundle.name == "ViViT" else "blocks"
            self.target_layer = target_layer or f"{prefix}_{depth - 1}"
        self.target = resolve_layer(self.module, self.target_layer)
        self.colormap_name = colormap
        self.class_token = bundle.name in CLASS_TOKEN_FAMILIES

    def _forward(self, x: torch.Tensor):
        """One eval-mode forward: autograd off until the target's output,
        which becomes a leaf that requires a gradient, on after it.
        Returns (logits, the source the target hands on or None, leaves): a
        module that runs more than once (a duplicated block) gives a leaf
        each time, and its last source."""
        leaves, sources = [], []

        def hook(_module, _args, out):
            torch.set_grad_enabled(True)  # the outer no_grad restores the mode on exit
            first = out[0] if isinstance(out, (list, tuple)) else out
            leaf = first.detach().requires_grad_(True)
            leaves.append(leaf)
            if isinstance(out, tuple) and hasattr(out[1], "source"):  # a block's (x, MergeState)
                sources.append(out[1].source)
            if isinstance(out, list):  # a conv stage: the slow pathway
                return [leaf] + out[1:]
            if isinstance(out, tuple):
                return (leaf, *out[1:])
            return leaf

        handle = self.target.register_forward_hook(hook)
        try:
            with torch.no_grad():
                logits, _ = self.bundle.apply(x, trace_source=self.force_trace)
                if not leaves:
                    raise KeyError(f"target layer {self.target_layer!r} did not run in {self.bundle.name}")
                lg = logits[0] if isinstance(logits, tuple) else logits  # EPIC: the verb head
                return lg, sources[-1] if sources else None, leaves
        finally:
            handle.remove()

    def localization_map(self, x, labels: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        """x: [B, T, H, W, C] (a tensor, or numpy put on the module's device).
        Returns (maps in [0, 1], preds [B, C]): maps [B, n_tokens_orig] for
        the transformers, [B, T', H', W'] for the conv families."""
        device = next(self.module.parameters()).device
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x, device=device)
        self.module.eval()
        lg, source, leaves = self._forward(x)
        with torch.enable_grad():
            lab = (torch.as_tensor(np.asarray(labels), device=lg.device) if labels is not None
                   else lg.argmax(dim=-1))
            score = lg.gather(1, lab.long()[:, None]).sum()
            grads = torch.autograd.grad(score, leaves, allow_unused=True)
        act = leaves[-1].detach().float().cpu().numpy()
        grads = sum(np.zeros(act.shape, np.float32) if g is None else g.float().cpu().numpy() for g in grads)
        preds = lg.detach().float().cpu().numpy()

        if self.is_conv:
            # [B, C, T', H', W']: GAP weights over the spatio-temporal grid
            weights = grads.mean(axis=(2, 3, 4), keepdims=True)
            cam = np.maximum((weights * act).sum(axis=1), 0.0)  # [B, T, H, W]
            flat = cam.reshape(cam.shape[0], -1)
            lo = flat.min(axis=1)[:, None, None, None]
            hi = flat.max(axis=1)[:, None, None, None]
            return (cam - lo) / np.maximum(hi - lo, 1e-8), preds

        weights = grads.mean(axis=1, keepdims=True)  # [B', 1, D]
        cam = np.maximum((weights * act).sum(axis=-1), 0.0)  # [B', N']
        if self.class_token:
            cam = cam[:, 1:]  # strip CLS from the flat sequence

        # broadcast merged-token maps back to the original grid
        if source is not None:
            src = source.detach().float().cpu().numpy()
            b = cam.shape[0]
            if src.shape[0] == b:
                # spatio-temporal merging (VideoMAE/ViViT): src [B, n_t, n_0];
                # a protected CLS stays at position 0 of both axes for ViViT
                if self.class_token:
                    src = src[:, :, 1:]
                if src.shape[1] == cam.shape[1] + 1:
                    src = src[:, 1:, :]
                cam = np.einsum("bn,bnm->bm", cam[:, : src.shape[1]], src)
            else:
                # per-frame merging (TimeSformer/Motionformer): src is
                # [(B*T), p_t, p_0] and the flat body order is spatial-major
                # ((p t) / (s f)): fold, unroll, unfold
                t = src.shape[0] // b
                p_t, p0 = src.shape[1], src.shape[2]
                per = cam.reshape(b, p_t, t).transpose(0, 2, 1).reshape(b * t, p_t)
                out = np.einsum("bn,bnm->bm", per, src)  # [(B*T), p_0]
                cam = out.reshape(b, t, p0).transpose(0, 2, 1).reshape(b, p0 * t)

        lo = cam.min(axis=1, keepdims=True)
        hi = cam.max(axis=1, keepdims=True)
        return (cam - lo) / np.maximum(hi - lo, 1e-8), preds

    def overlay(self, frames: np.ndarray, cam_tokens: np.ndarray, alpha: float = 0.5) -> np.ndarray:
        """frames [T, H, W, C] in [0,1] + per-token map -> heatmap overlay
        video [T, H, W, 3] uint8. Token grid inferred from the model's patch
        geometry."""
        colormap = _colormap(self.colormap_name)
        t, h, w, _ = frames.shape
        c = self.module.config
        if self.is_conv:
            # cam_tokens is already a [T', H', W'] grid
            grid = np.asarray(cam_tokens)
            up = np.repeat(
                np.repeat(
                    np.repeat(grid, max(1, t // grid.shape[0]), axis=0)[:t],
                    max(1, h // grid.shape[1]), axis=1,
                )[:, :h],
                max(1, w // grid.shape[2]), axis=2,
            )[:, :, :w]
            # pad if the repeat under-shot (non-divisible grids)
            pt, ph, pw = t - up.shape[0], h - up.shape[1], w - up.shape[2]
            up = np.pad(up, [(0, pt), (0, ph), (0, pw)], mode="edge")
            heat = colormap(up)[..., :3]
            out = (1 - alpha) * frames + alpha * heat
            return np.uint8(np.clip(out, 0, 1) * 255)
        name = self.bundle.name
        if name == "VideoMAE":
            gt, gs = t // c.tubelet_size, h // c.patch_size
        elif name == "ViViT":
            gt, gs = t // c.tubelet_size[0], h // c.tubelet_size[1]
        elif name == "Motionformer":
            gt, gs = c.temporal_resolution, h // c.patch_size
        else:  # TimeSformer: (p t) order handled below
            gt, gs = t, h // c.patch_size
        if name in ("TimeSformer", "Motionformer"):
            # spatial-major flat order ((p t) / (s f)) -> (t, h, w)
            grid = cam_tokens.reshape(gs * gs, gt).T.reshape(gt, gs, gs)
        else:
            grid = cam_tokens.reshape(gt, gs, gs)
        up = np.repeat(np.repeat(np.repeat(grid, t // gt, axis=0), h // gs, axis=1), w // gs, axis=2)
        heat = colormap(up)[..., :3]
        out = (1 - alpha) * frames + alpha * heat
        return np.uint8(np.clip(out, 0, 1) * 255)
