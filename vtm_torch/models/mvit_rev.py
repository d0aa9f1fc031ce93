"""The reversible MViT encoder (``MVIT.REV``) in PyTorch: port of
``vtm/models/mvit_rev.py``.

The two-stream state (X1, X2) is carried as two tensors and concatenated
along the channels only between segments. A reversible block computes
Y1 = X1 + F(X2), Y2 = X2 + G(Y1) (F: LayerNorm + pooling attention, G:
LayerNorm + MLP); the Q-pooling layers (``MVIT.REV.BUFFER_LAYERS``) are
irreversible stage transitions (``StageTransitionBlock``) that fuse the
two streams first (``MVIT.REV.PRE_Q_FUSION``).

The memory-saving backward: in training each run of reversible blocks is
one ``torch.autograd.Function`` (``_RevSegment``), whose forward keeps only
the segment's outputs (Y1, Y2) and the drop-path masks. Its backward walks
the blocks from the last: X2 = Y2 - G(Y1), X1 = Y1 - F(X2), each
sub-function recomputed under ``torch.enable_grad()`` and differentiated
with ``torch.autograd.grad``; the parameters' gradients are returned as
the gradients of the Function's parameter inputs, so they accumulate as
any other's (DDP's hooks included). ``ReversibleMViT.use_rev_backward =
False`` runs the same forward under plain autograd instead: the yardstick
the reversible backward is held to.

Stochastic depth: each layer's keep mask is drawn once, before its
segment runs, and scaled by 1 / keep in fp32; a reversible block uses it
for F and for G and the backward's recomputation uses it again. The
transition layers drop-path their whole output (residual included), as
in ``vtm``. Two dropouts: one here on the encoder's output and one before
the head (``models/mvit.py``).

Module names are the upstream ones: ``rev_backbone.layers.{i}.F.norm``,
``F.attn.*``, ``G.norm``, ``G.mlp.fc1`` / ``fc2``, ``res_proj``,
``pre_q_fuse.fuse_fn.*``, and the final ``fuse.fuse_fn.*``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from vtm_torch.models.common import LayerNorm, Linear, Mlp, dropout
from vtm_torch.models.mvit import NORM_EPS, MViTSpec, MultiScaleAttention, attention_pool, draw_keep_mask


def _parse_concat_linear(mode: str):
    """(dim_mult, drop_rate) from 'concat_linear[_{dim_mult}[_{drop}]]'
    (``vtm``'s length-based parse)."""
    parts = mode.split("_")
    if len(parts) == 2:
        return 1.0, 0.0
    if len(parts) == 3:
        return float(parts[-1]), 0.0
    if len(parts) == 4:
        return float(parts[-2]), float(parts[-1])
    raise NotImplementedError(f"fusion mode {mode}")


class TwoStreamFusion(nn.Module):
    """Fuse a channel-concatenated two-stream tensor (``vtm``'s
    ``TwoStreamFusion``): ``add``, ``max``, ``min``, ``avg`` of the halves,
    ``concat`` (as it is), or ``[ln+]concat_linear[_m[_drop]]``: x plus an
    MLP of x (hidden ``dim * m``, computed in fp32, its dropout in
    training), after a LayerNorm for ``ln+``. ``dim`` is the full (2x)
    width."""

    def __init__(self, mode: str, dim: Optional[int] = None):
        super().__init__()
        self.mode = mode
        if mode in ("add", "max", "min", "avg", "concat"):
            return
        if "concat_linear" not in mode:
            raise NotImplementedError(f"fusion mode {mode}")
        dim_mult, drop = _parse_concat_linear(mode)
        mlp = Mlp(dim, int(dim * dim_mult), dim, drop=drop)
        self.fuse_fn = nn.Sequential(LayerNorm(dim, NORM_EPS), mlp) if mode.split("+")[0] == "ln" else mlp

    def out_dim(self, dim: int) -> int:
        return dim // 2 if self.mode in ("add", "max", "min", "avg") else dim

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        mode = self.mode
        if mode in ("add", "max", "min", "avg"):
            a, b = torch.chunk(x, 2, dim=-1)
            if mode == "add":
                return a + b
            if mode == "max":
                return torch.maximum(a, b)
            if mode == "min":
                return torch.minimum(a, b)
            return (a + b) / 2.0
        if mode == "concat":
            return x
        if isinstance(self.fuse_fn, nn.Sequential):
            y = self.fuse_fn[1](self.fuse_fn[0](x).float(), generator)
        else:
            y = self.fuse_fn(x.float(), generator)
        return y + x


class MLPSubblock(nn.Module):
    """G: LayerNorm + MLP in the compute dtype."""

    def __init__(self, dim: int, mlp_ratio: float, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.norm = LayerNorm(dim, NORM_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(self.norm(x).to(self.dtype))


class AttentionSubBlock(nn.Module):
    """F: LayerNorm + pooling attention on the layer's fixed input thw."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, input_size, qkv_bias: bool, kernel_q, kernel_kv,
                 stride_q, stride_kv, mode: str, has_cls: bool, pool_first: bool, rel_pos_spatial: bool,
                 rel_pos_temporal: bool, residual_pooling: bool, separate_qkv: bool, dtype: torch.dtype):
        super().__init__()
        self.thw = tuple(input_size)
        self.norm = LayerNorm(dim, NORM_EPS)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads, input_size, qkv_bias, kernel_q, kernel_kv, stride_q,
                                        stride_kv, mode, has_cls, pool_first, rel_pos_spatial, rel_pos_temporal,
                                        residual_pooling, separate_qkv, dtype)

    def forward(self, x: torch.Tensor, x_res: Optional[torch.Tensor] = None):
        if x_res is not None:
            out, _, pooled = self.attn(self.norm(x), self.thw, x_res=x_res)
            return out, pooled
        return self.attn(self.norm(x), self.thw)[0]


def _attention_kwargs(blk: dict, s: MViTSpec, dtype: torch.dtype) -> dict:
    return dict(num_heads=blk["num_heads"], input_size=blk["input_size"], qkv_bias=s.qkv_bias,
                kernel_q=blk["kernel_q"], kernel_kv=blk["kernel_kv"], stride_q=blk["stride_q"],
                stride_kv=blk["stride_kv"], mode=s.mode, has_cls=s.cls_embed_on, pool_first=s.pool_first,
                rel_pos_spatial=s.rel_pos_spatial, rel_pos_temporal=s.rel_pos_temporal,
                residual_pooling=s.residual_pooling, separate_qkv=s.separate_qkv, dtype=dtype)


class ReversibleBlock(nn.Module):
    """Y1 = X1 + F(X2) * m; Y2 = X2 + G(Y1) * m, one mask m for both."""

    def __init__(self, blk: dict, s: MViTSpec, dtype: torch.dtype):
        super().__init__()
        if blk["dim"] != blk["dim_out"]:
            raise ValueError(f"a reversible block must preserve width: {blk['dim']} -> {blk['dim_out']}")
        if blk["stride_q"] and int(np.prod(blk["stride_q"])) != 1:
            raise ValueError("Q-pooling layers must be listed in MVIT.REV.BUFFER_LAYERS")
        self.F = AttentionSubBlock(blk["dim"], blk["dim_out"], **_attention_kwargs(blk, s, dtype))
        self.G = MLPSubblock(blk["dim"], s.mlp_ratio, dtype)

    def call_f(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        out = self.F(x)
        return out if mask is None else out * mask.to(out.dtype)

    def call_g(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        out = self.G(x)
        return out if mask is None else out * mask.to(out.dtype)

    def forward(self, x1, x2, mask=None):
        y1 = x1 + self.call_f(x2, mask)
        return y1, x2 + self.call_g(y1, mask)


class StageTransitionBlock(nn.Module):
    """The irreversible Q-pooling layer between segments (``vtm``'s
    ``StageTransitionBlock``) on the previous segment's concatenated
    streams: the pre-q fusion, ``res_proj`` (before the pool, or after it
    under ``pool_first``), the residual pooled through the attention's own
    ``pool_q`` / ``norm_q`` (``RES_PATH conv``) or a max pool padded by
    stride // 2 (``max``), F, G, and the whole output drop-pathed."""

    def __init__(self, blk: dict, s: MViTSpec, dtype: torch.dtype):
        super().__init__()
        pre_q = s.rev_pre_q_fusion
        if "concat_linear" in pre_q and _parse_concat_linear(pre_q)[1] > 0.0:
            raise NotImplementedError("PRE_Q_FUSION dropout inside the reversible stack")
        self.dim, self.dim_out, self.num_heads = blk["dim"], blk["dim_out"], blk["num_heads"]
        self.pool_first, self.res_path, self.has_cls = s.pool_first, s.rev_res_path, s.cls_embed_on
        self.stride_q, self.input_size, self.dtype = tuple(blk["stride_q"]), tuple(blk["input_size"]), dtype
        self.pre_q_fuse = TwoStreamFusion(pre_q, dim=self.dim)
        self.F = AttentionSubBlock(self.dim, self.dim_out, **_attention_kwargs(blk, s, dtype))
        self.G = MLPSubblock(self.dim_out, s.mlp_ratio, dtype)
        if self.dim != self.dim_out:
            self.res_proj = Linear(self.dim, self.dim_out)
        if self.res_path not in ("conv", "max"):
            raise NotImplementedError(self.res_path)

    def forward(self, x: torch.Tensor, dp_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.pre_q_fuse(x)
        x_res = x
        is_proj = self.dim != self.dim_out
        if is_proj and not self.pool_first:
            x_res = self.res_proj(x_res.to(self.dtype))
        b, n, c = x_res.shape
        if self.res_path == "conv":
            xr = x_res.reshape(b, n, self.num_heads, c // self.num_heads).transpose(1, 2)
            fx, pooled = self.F(x, x_res=xr)
            x_res = pooled.transpose(1, 2).reshape(b, pooled.shape[2], c)
        else:
            stride = self.stride_q
            x_res = attention_pool(x_res[:, None], self.input_size, tuple(s + 1 if s > 1 else s for s in stride),
                                   stride, "max", self.has_cls, pad_override=tuple(s // 2 for s in stride))[0][:, 0]
            fx = self.F(x)
        if is_proj and self.pool_first:
            x_res = self.res_proj(x_res.to(self.dtype))
        x = x_res + fx
        x = x + self.G(x)
        return x if dp_mask is None else x * dp_mask.to(x.dtype)


def _segment_layout(plan):
    """Layer indices grouped into ('transition', i) / ('rev', [i, ...]) runs."""
    segments = []
    for i, blk in enumerate(plan):
        if blk["is_transition"]:
            segments.append(("transition", i))
        else:
            if not segments or segments[-1][0] == "transition":
                segments.append(("rev", []))
            segments[-1][1].append(i)
    return segments


def _trainable(module: nn.Module) -> List[nn.Parameter]:
    return [p for p in module.parameters() if p.requires_grad]


class _RevSegment(torch.autograd.Function):
    """A run of reversible blocks with the memory-saving backward. Inputs:
    (x1, x2, masks [L, B, 1, 1] or None, blocks, *params), params being
    the blocks' trainable parameters in ``_trainable`` order."""

    @staticmethod
    def forward(ctx, x1, x2, masks, blocks, *params):
        for j, blk in enumerate(blocks):
            x1, x2 = blk(x1, x2, None if masks is None else masks[j])
        ctx.blocks = blocks
        ctx.save_for_backward(x1, x2, masks)
        return x1, x2

    @staticmethod
    def backward(ctx, dy1, dy2):
        y1, y2, masks = ctx.saved_tensors
        blocks = ctx.blocks
        grads = []
        for j in range(len(blocks) - 1, -1, -1):
            blk = blocks[j]
            m = None if masks is None else masks[j]
            g_params, f_params = _trainable(blk.G), _trainable(blk.F)
            with torch.enable_grad():
                y1_ = y1.detach().requires_grad_(True)
                g_y1 = blk.call_g(y1_, m)
                dy1_add, *dp_g = torch.autograd.grad(g_y1, [y1_] + g_params, dy2, allow_unused=True)
            x2 = y2 - g_y1.detach()
            dy1 = dy1 + dy1_add
            with torch.enable_grad():
                x2_ = x2.detach().requires_grad_(True)
                f_x2 = blk.call_f(x2_, m)
                dx2_add, *dp_f = torch.autograd.grad(f_x2, [x2_] + f_params, dy1, allow_unused=True)
            x1 = y1 - f_x2.detach()
            dy2 = dy2 + dx2_add
            by_param = dict(zip(map(id, g_params), dp_g))
            by_param.update(zip(map(id, f_params), dp_f))
            grads.append([by_param[id(p)] for p in _trainable(blk)])
            y1, y2 = x1, x2
        flat = [g for per_block in reversed(grads) for g in per_block]
        return (dy1, dy2, None, None, *flat)


class ReversibleMViT(nn.Module):
    """The reversible encoder stack. [B, N, C] -> the channel-concatenated
    streams [B, N', 2 C']. In training, reversible segments take the
    memory-saving backward when ``use_rev_backward`` is on (the default),
    plain autograd when it is off; eval runs them plainly."""

    def __init__(self, spec: MViTSpec, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spec = spec
        self.use_rev_backward = True
        self.plan = spec.rev_block_plan()
        layers = []
        for i, blk in enumerate(self.plan):
            if blk["is_transition"]:
                if i == 0:
                    raise ValueError("a stage transition cannot be layer 0")
                layers.append(StageTransitionBlock(blk, spec, dtype))
            else:
                layers.append(ReversibleBlock(blk, spec, dtype))
        self.layers = nn.ModuleList(layers)
        self.dpr = np.linspace(0, spec.droppath_rate, spec.depth)

    def _dp_mask(self, rate: float, b: int, device, generator) -> Optional[torch.Tensor]:
        """The scaled keep mask [B, 1, 1] (fp32, mask / keep), or None."""
        if not self.training or rate <= 0.0:
            return None
        return draw_keep_mask(rate, b, device, generator) / (1.0 - rate)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        s = self.spec
        b, device = x.shape[0], x.device
        for kind, payload in _segment_layout(self.plan):
            if kind == "transition":
                x = self.layers[payload](x, self._dp_mask(self.dpr[payload], b, device, generator))
                continue
            idxs = payload
            masks = None
            if self.training and s.droppath_rate > 0.0:
                masks = torch.stack([
                    self._dp_mask(self.dpr[i], b, device, generator) if self.dpr[i] > 0.0
                    else torch.ones((b, 1, 1), device=device) for i in idxs])
            blocks = [self.layers[i] for i in idxs]
            if self.training and self.use_rev_backward and torch.is_grad_enabled():
                params = [p for blk in blocks for p in _trainable(blk)]
                x1, x2 = _RevSegment.apply(x, x, masks, blocks, *params)
            else:
                x1 = x2 = x
                for j, blk in enumerate(blocks):
                    x1, x2 = blk(x1, x2, None if masks is None else masks[j])
            x = torch.cat([x1, x2], dim=-1)
        return dropout(x, s.dropout_rate, self.training, generator)
