"""MViT (Multiscale Vision Transformers, v1 and v2) in PyTorch: port of
``vtm/models/mvit.py``.

Pooling attention: q, k and v are pooled over (T, H, W) before the
product, by a depthwise ``Conv3d`` (``MVIT.MODE conv``, followed by a
LayerNorm), a max pool or an average pool (padding counted); the CLS token
bypasses the pool. v2 adds the decomposed relative positions (spatial and
temporal biases from ``rel_pos_h`` / ``rel_pos_w`` / ``rel_pos_t``) and the
residual pooling connection. The reversible encoder (``MVIT.REV``) lives in
``models/mvit_rev.py``.

Modules carry the upstream PySlowFast state-dict names (``patch_embed.proj``,
``blocks.{i}.attn.{qkv,q,k,v,proj,pool_q,norm_q,...,rel_pos_h}``,
``blocks.{i}.{norm1,norm2,proj,mlp.fc1,mlp.fc2,gamma_1,gamma_2}``,
``pos_embed*``, ``cls_token``, ``norm``, ``head.projection``), so a released
checkpoint loads with ``load_state_dict``
(``checkpoints/convert.py::load_mvit_state_dict``).

Where ``vtm`` rounds, the port rounds. Linear layers and the patch
embedding compute in ``TPU.COMPUTE_DTYPE``; the pooling conv promotes a
bf16 input and its fp32 kernel to fp32 (as ``vtm``'s ``nn.Conv`` without a
dtype does), so a pooled q, k or v and its LayerNorm are fp32 while a max
pool keeps bf16; the attention logits are fp32 (an fp32 product of the
operands, ``vtm``'s ``preferred_element_type``), the relative-position
einsums run in q's dtype and the softmax is cast to v's. LayerNorms compute
in fp32 and return their input's dtype. Weights are drawn in fp32 from a
``torch.Generator`` seeded with ``RNG_SEED``, with ``vtm``'s initialisers;
for serving the linear and patch-embedding weights are cast once to the
compute dtype, and the pooling convs, norms, embeddings and the head stay
fp32.

Training: stochastic depth (``MVIT.DROPPATH_RATE``, linear over the
blocks, two masks a block) and the head's dropout (``MODEL.DROPOUT_RATE``)
draw from the forward's ``generator``. Each block's masks are drawn before
the block runs, so ``MODEL.ACT_CHECKPOINT`` (each block under
``torch.utils.checkpoint``, non-reentrant) recomputes with the same masks
and gives the plain stack's values and gradients. The head's activation
(softmax or sigmoid) applies in eval mode only.

``_get_rel_pos`` and the position embeddings' ``to_grid`` resize as
``jax.image.resize(..., "linear")`` does (a triangle kernel, widened when
shrinking), not as ``F.interpolate``: ``resize_linear``.

``CONTRASTIVE.NUM_MLP_LAYERS`` > 1 makes ``head.projection`` the
contrastive family's ``convnet.MLPHead`` (``fc0``, ``bn{i}``, ``fc{i}``;
fp32, lecun-normal with zero biases, as ``vtm``'s ``_mvit_head``).

``DETECTION.ENABLE`` (the AVA path): ``norm``, the class token stripped,
the tokens refolded to the [T, H, W] grid and sent as one pathway through
the ROI head (``models/roi_head.py``, named ``head``, its ``projection``
normal(0.01) with a zero bias as in ``vtm``); ``forward(x, bboxes=...)``
returns one row a box, and raises ValueError without boxes. The reversible
encoder has no detection path (an AssertionError, as in ``vtm``).

Tensor parallelism (``parallel/sharding.py``): each attention holds its
local heads (``qkv``, or the separate ``q`` / ``k`` / ``v``, cut by heads;
``proj`` by rows; ``head_dim`` unchanged), the MLPs are cut as the ViTs',
and the block-level ``proj`` stays whole. The pooling convs, their norms
and the relative positions act on every head alike: a rank applies them to
its own heads through ``copy_to_model``, so their gradients are summed over
the model group. ``pool_first`` splits its input by the whole head count,
pools every head on every rank and passes the pooled tensors through ``f``
into the cut projections. An attention whose heads do not split stays
whole (``uneven_heads_stay_whole``): MViTv2-S's one-head first block at
tp 2.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from vtm_torch.merge.policy import MergePolicy
from vtm_torch.models.common import LayerNorm, Linear, Mlp, dropout
from vtm_torch.models.convnet import MLPHead, lecun_normal_, max_pool3d, mlp_head_linears, round_width
from vtm_torch.models.roi_head import ResNetRoIHead
from vtm_torch.parallel.sharding import copy_to_model

NORM_EPS = 1e-6


# ----------------------------------------------------------- pos embeds


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    omega = np.arange(embed_dim // 2, dtype=float)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_3d_sincos_pos_embed(embed_dim: int, grid_size: int, t_size: int, cls_token: bool = False) -> np.ndarray:
    """Copy of ``vtm/models/mvit.py::get_3d_sincos_pos_embed``."""
    assert embed_dim % 4 == 0
    dim_sp, dim_t = embed_dim // 4 * 3, embed_dim // 4
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_h, grid_h), axis=0)  # w first
    emb_h = get_1d_sincos_pos_embed_from_grid(dim_sp // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(dim_sp // 2, grid[1])
    pos_sp = np.concatenate([emb_h, emb_w], axis=1)
    pos_t = get_1d_sincos_pos_embed_from_grid(dim_t, np.arange(t_size, dtype=np.float32))
    pos_t = np.repeat(pos_t[:, np.newaxis, :], grid_size ** 2, axis=1)
    pos_sp = np.repeat(pos_sp[np.newaxis, :, :], t_size, axis=0)
    pos = np.concatenate([pos_t, pos_sp], axis=-1).reshape(-1, embed_dim)
    if cls_token:
        pos = np.concatenate([np.zeros([1, embed_dim]), pos], axis=0)
    return pos


# ------------------------------------------------------- rel pos helpers


def linear_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] fp32 weights of ``jax.image.resize(..., "linear")``
    along one axis (``jax/_src/image/scale.py::compute_weight_mat``):
    half-pixel sample positions, a triangle kernel widened by n_in / n_out
    when shrinking (antialiasing), each column normalised to sum 1."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x)).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_linear(x: torch.Tensor, shape) -> torch.Tensor:
    """``jax.image.resize(x, shape, "linear")``: every axis whose length
    changes is resampled by ``linear_resize_weights``, one after another,
    in x's dtype."""
    for d, n in enumerate(shape):
        if x.shape[d] == n:
            continue
        w = torch.from_numpy(linear_resize_weights(x.shape[d], n)).to(x.device, x.dtype)
        x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x


def _get_rel_pos(rel_pos: torch.Tensor, d: int) -> torch.Tensor:
    """A trained rel-pos table resized to distance d (``vtm``'s ``_get_rel_pos``)."""
    if rel_pos.shape[0] == d:
        return rel_pos
    return resize_linear(rel_pos, (d, rel_pos.shape[1]))


def _dist_table(q_n: int, k_n: int) -> np.ndarray:
    q_ratio = max(k_n / q_n, 1.0)
    k_ratio = max(q_n / k_n, 1.0)
    dist = np.arange(q_n)[:, None] * q_ratio - np.arange(k_n)[None, :] * k_ratio
    dist += (k_n - 1) * k_ratio
    return dist.astype(np.int64)


def _body(attn: torch.Tensor, sp: int, q_shape, k_shape) -> torch.Tensor:
    """The non-CLS block of the logits [B, H, qN, kN] as a view
    [B, H, qt, qh, qw, kt, kh, kw]."""
    return attn[:, :, sp:, sp:].unflatten(3, tuple(k_shape)).unflatten(2, tuple(q_shape))


def cal_rel_pos_spatial(attn, q, has_cls, q_shape, k_shape, rel_pos_h, rel_pos_w):
    """Decomposed spatial relative positional bias (``vtm``'s
    ``cal_rel_pos_spatial``), added to the logits' non-CLS block in place:
    the h and w terms summed in q's dtype, then cast to the logits'."""
    sp = 1 if has_cls else 0
    q_t, q_h, q_w = q_shape
    k_t, k_h, k_w = k_shape
    dh = int(2 * max(q_h, k_h) - 1)
    dw = int(2 * max(q_w, k_w) - 1)
    rh = _get_rel_pos(rel_pos_h, dh)[torch.from_numpy(_dist_table(q_h, k_h)).to(q.device)]
    rw = _get_rel_pos(rel_pos_w, dw)[torch.from_numpy(_dist_table(q_w, k_w)).to(q.device)]
    b, n_head, _, dim = q.shape
    r_q = q[:, :, sp:].reshape(b, n_head, q_t, q_h, q_w, dim)
    rel_h = torch.einsum("bythwc,hkc->bythwk", r_q, rh.to(q.dtype))
    rel_w = torch.einsum("bythwc,wkc->bythwk", r_q, rw.to(q.dtype))
    bias = rel_h[:, :, :, :, :, None, :, None] + rel_w[:, :, :, :, :, None, None, :]
    _body(attn, sp, q_shape, k_shape).add_(bias.to(attn.dtype))
    return attn


def cal_rel_pos_temporal(attn, q, has_cls, q_shape, k_shape, rel_pos_t):
    """Temporal relative positional bias (``vtm``'s ``cal_rel_pos_temporal``),
    in place as ``cal_rel_pos_spatial``."""
    sp = 1 if has_cls else 0
    q_t, q_h, q_w = q_shape
    k_t = k_shape[0]
    dt = int(2 * max(q_t, k_t) - 1)
    rt = _get_rel_pos(rel_pos_t, dt)[torch.from_numpy(_dist_table(q_t, k_t)).to(q.device)]
    b, n_head, _, dim = q.shape
    r_q = q[:, :, sp:].reshape(b, n_head, q_t, q_h, q_w, dim)
    rel = torch.einsum("bythwc,tkc->bythwk", r_q, rt.to(q.dtype))
    _body(attn, sp, q_shape, k_shape).add_(rel[:, :, :, :, :, :, None, None].to(attn.dtype))
    return attn


# --------------------------------------------------------- pooling attn


def _identity(p: torch.Tensor) -> torch.Tensor:
    return p


def attention_pool(x: torch.Tensor, thw, kernel, stride, mode: str, has_cls: bool,
                   conv: Optional[nn.Conv3d] = None, norm: Optional[nn.Module] = None, pad_override=None,
                   shared=_identity):
    """The q/k/v pooling of ``vtm``'s ``AttentionPool`` on [B, H, L, c]:
    ``conv`` (depthwise, in the promoted dtype of x and its kernel, then
    ``norm``), ``max`` (``max_pool3d``) or ``avg`` (padding counted) over [B·H, c, T, H, W]
    (a ``channels_last_3d`` view of the channels-last tokens). The CLS
    token bypasses the pool. Returns (x, the pooled thw). An empty
    ``kernel`` returns x as it is. ``shared`` maps the conv's and the
    norm's parameters at their use (``copy_to_model`` on a rank's heads)."""
    if not kernel:
        return x, tuple(thw)
    b, h, _, c = x.shape
    cls_tok = None
    if has_cls:
        cls_tok, x = x[:, :, :1], x[:, :, 1:]
    t, hh, ww = thw
    xg = x.reshape(b * h, t, hh, ww, c).permute(0, 4, 1, 2, 3)
    pad = tuple(pad_override) if pad_override is not None else tuple(k // 2 for k in kernel)
    if mode == "conv":
        dt = torch.promote_types(x.dtype, conv.weight.dtype)
        xg = F.conv3d(xg.to(dt), shared(conv.weight).to(dt), None, tuple(stride), pad, 1, conv.groups)
    elif mode == "max":
        xg = max_pool3d(xg, kernel, stride, pad)
    elif mode == "avg":
        xg = F.avg_pool3d(xg, tuple(kernel), tuple(stride), pad, count_include_pad=True)
    else:
        raise NotImplementedError(f"Unsupported mode {mode}")
    new_thw = tuple(int(s) for s in xg.shape[2:])
    x = xg.permute(0, 2, 3, 4, 1).reshape(b, h, -1, xg.shape[1])
    if cls_tok is not None:
        x = torch.cat([cls_tok.to(x.dtype), x], dim=2)
    if mode == "conv" and norm is not None:
        x = functional_call(norm, {"weight": shared(norm.weight), "bias": shared(norm.bias)}, (x,))
    return x, new_thw


def _volume(v) -> int:
    return math.prod(v or (1,))


class MultiScaleAttention(nn.Module):
    """Pooling attention (``vtm``'s ``MultiScaleAttention``): fused ``qkv``
    or ``separate_qkv``, ``pool_first``, kernels of volume 1 (with stride
    1) dropped, the optional external ``x_res`` pooled through the same
    ``pool_q`` / ``norm_q``, residual pooling over every row but the CLS
    row. Cut for tensor parallelism as the module docstring says: its
    input (or under ``pool_first`` the pooled tensors) passes ``f`` over
    ``model_group``, ``num_heads`` is then this rank's (``pool_heads`` the
    whole count) and the parameters shared by the heads pass ``f`` at use.
    The external ``x_res`` is whole on every rank and pools with them as
    they are."""

    model_group = None

    def __init__(self, dim: int, dim_out: int, num_heads: int, input_size, qkv_bias: bool, kernel_q, kernel_kv,
                 stride_q, stride_kv, mode: str, has_cls: bool, pool_first: bool, rel_pos_spatial: bool,
                 rel_pos_temporal: bool, residual_pooling: bool, separate_qkv: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if mode == "conv_unshared":
            raise NotImplementedError("MVIT.MODE conv_unshared is out of scope, as in vtm")
        self.dtype, self.num_heads, self.pool_heads = dtype, num_heads, num_heads
        self.head_dim = dim_out // num_heads
        self.scale = self.head_dim ** -0.5
        self.mode, self.has_cls, self.pool_first = mode, has_cls, pool_first
        self.separate_qkv, self.residual_pooling = separate_qkv, residual_pooling
        if _volume(kernel_q) == 1 and _volume(stride_q) == 1:
            kernel_q = ()
        if _volume(kernel_kv) == 1 and _volume(stride_kv) == 1:
            kernel_kv = ()
        self.kernel_q, self.kernel_kv = tuple(kernel_q), tuple(kernel_kv)
        self.stride_q, self.stride_kv = tuple(stride_q), tuple(stride_kv)
        if pool_first:
            dim_conv = dim // num_heads
            self.q = Linear(dim, dim_out, bias=qkv_bias)
            self.k = Linear(dim, dim_out, bias=qkv_bias)
            self.v = Linear(dim, dim_out, bias=qkv_bias)
        else:
            dim_conv = dim_out // num_heads
            if separate_qkv:
                self.q = Linear(dim, dim_out, bias=qkv_bias)
                self.k = Linear(dim, dim_out, bias=qkv_bias)
                self.v = Linear(dim, dim_out, bias=qkv_bias)
            else:
                self.qkv = Linear(dim, 3 * dim_out, bias=qkv_bias)
        self.proj = Linear(dim_out, dim_out)
        if mode == "conv":
            for nm, kernel, stride in (("q", self.kernel_q, self.stride_q), ("k", self.kernel_kv, self.stride_kv),
                                       ("v", self.kernel_kv, self.stride_kv)):
                if kernel:
                    setattr(self, f"pool_{nm}", nn.Conv3d(dim_conv, dim_conv, kernel, stride,
                                                          tuple(k // 2 for k in kernel), groups=dim_conv,
                                                          bias=False))
                    setattr(self, f"norm_{nm}", LayerNorm(dim_conv, NORM_EPS))
        self.rel_pos_spatial, self.rel_pos_temporal = rel_pos_spatial, rel_pos_temporal
        if rel_pos_spatial:
            size = input_size[1]
            sq = stride_q[1] if stride_q else 1
            skv = stride_kv[1] if stride_kv else 1
            rel_sp_dim = 2 * max(size // sq, size // skv) - 1
            self.rel_pos_h = nn.Parameter(torch.zeros(rel_sp_dim, self.head_dim))
            self.rel_pos_w = nn.Parameter(torch.zeros(rel_sp_dim, self.head_dim))
        if rel_pos_temporal:
            self.rel_pos_t = nn.Parameter(torch.zeros(2 * input_size[0] - 1, self.head_dim))

    def _shared(self, p: torch.Tensor) -> torch.Tensor:
        """A parameter every head uses, at its use on this rank's heads."""
        return copy_to_model(p, self.model_group)

    def _pool(self, nm: str, x: torch.Tensor, thw, local: bool = True):
        """Pool x [B, heads, L, c]; ``local``: x holds this rank's heads."""
        kernel, stride = (self.kernel_q, self.stride_q) if nm == "q" else (self.kernel_kv, self.stride_kv)
        return attention_pool(x, thw, kernel, stride, self.mode, self.has_cls,
                              getattr(self, f"pool_{nm}", None), getattr(self, f"norm_{nm}", None),
                              shared=self._shared if local else _identity)

    def _heads(self, z: torch.Tensor) -> torch.Tensor:
        b, n, _ = z.shape
        return z.reshape(b, n, self.num_heads, self.head_dim).transpose(1, 2)

    def forward(self, x: torch.Tensor, thw, x_res: Optional[torch.Tensor] = None):
        """x [B, N, C] -> (out [B, qN, dim_out], q's thw), and the pooled
        ``x_res`` [B, heads, ., c] third when it is given."""
        b, n, _ = x.shape
        dt = self.dtype
        if self.pool_first:  # every head pooled on every rank: f comes after the pool
            q = k = v = x.reshape(b, n, self.pool_heads, -1).transpose(1, 2)
        elif self.separate_qkv:
            xd = copy_to_model(x, self.model_group).to(dt)
            q, k, v = self._heads(self.q(xd)), self._heads(self.k(xd)), self._heads(self.v(xd))
        else:
            qkv = self.qkv(copy_to_model(x, self.model_group).to(dt))
            qkv = qkv.reshape(b, n, 3, self.num_heads, self.head_dim).permute(2, 0, 3, 1, 4)
            q, k, v = qkv[0], qkv[1], qkv[2]
        local = not self.pool_first
        q, q_shape = self._pool("q", q, thw, local)
        pooled_res = None
        if x_res is not None:
            pooled_res, _ = self._pool("q", x_res, thw, local=False)
        k, k_shape = self._pool("k", k, thw, local)
        v, v_shape = self._pool("v", v, thw, local)
        if self.pool_first:
            def project(z, layer):
                z = copy_to_model(z.transpose(1, 2).reshape(b, z.shape[2], -1), self.model_group)
                return self._heads(layer(z.to(dt)))

            q, v, k = project(q, self.q), project(v, self.v), project(k, self.k)

        attn = torch.matmul((q * self.scale).float(), k.float().transpose(-2, -1))
        if self.rel_pos_spatial:
            attn = cal_rel_pos_spatial(attn, q, self.has_cls, q_shape, k_shape, self._shared(self.rel_pos_h),
                                       self._shared(self.rel_pos_w))
        if self.rel_pos_temporal:
            attn = cal_rel_pos_temporal(attn, q, self.has_cls, q_shape, k_shape, self._shared(self.rel_pos_t))
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v)
        if self.residual_pooling:
            if self.has_cls:  # vtm's .at[].add: the sum in out's dtype
                out = torch.cat([out[:, :, :1], out[:, :, 1:] + q[:, :, 1:].to(out.dtype)], dim=2)
            else:
                out = out + q
        out = self.proj(out.transpose(1, 2).reshape(b, out.shape[2], -1).to(dt))
        if x_res is not None:
            return out, q_shape, pooled_res
        return out, q_shape


def _drop(z: torch.Tensor, mask: Optional[torch.Tensor], keep: float) -> torch.Tensor:
    """``vtm``'s drop path given the drawn 0/1 mask [B, 1, 1]: z * mask / keep in z's dtype."""
    return z if mask is None else z * mask.to(z.dtype) / keep


def draw_keep_mask(rate: float, batch: int, device, generator: Optional[torch.Generator]) -> torch.Tensor:
    """A per-sample Bernoulli(1 - rate) keep mask [B, 1, 1], 0 or 1 in fp32."""
    return (torch.rand((batch, 1, 1), generator=generator, device=device) < 1.0 - rate).float()


class MultiScaleBlock(nn.Module):
    """``vtm``'s ``MultiScaleBlock``: norm1, pooling attention, the skip
    path's max pool (kernel s + 1) where q is strided, ``proj`` on the
    normed input (before the attention residual under ``dim_mul_in_att``,
    else after norm2), layer scale, and drop path with the masks given.
    Under tensor parallelism ``proj`` stays whole: it takes the whole normed
    input, which a row cut cannot."""

    tp_whole = ("proj",)

    def __init__(self, dim: int, dim_out: int, num_heads: int, input_size, mlp_ratio: float, qkv_bias: bool,
                 kernel_q, kernel_kv, stride_q, stride_kv, mode: str, has_cls: bool, pool_first: bool,
                 rel_pos_spatial: bool, rel_pos_temporal: bool, residual_pooling: bool,
                 dim_mul_in_att: bool, separate_qkv: bool, layer_scale_init_value: float = 0.0,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.has_cls, self.dim_mul_in_att = dtype, has_cls, dim_mul_in_att
        self.drop_path = drop_path
        att_dim = dim_out if dim_mul_in_att else dim
        self.norm1 = LayerNorm(dim, NORM_EPS)
        self.attn = MultiScaleAttention(dim, att_dim, num_heads, input_size, qkv_bias, kernel_q, kernel_kv, stride_q,
                                        stride_kv, mode, has_cls, pool_first, rel_pos_spatial, rel_pos_temporal,
                                        residual_pooling, separate_qkv, dtype)
        if dim != dim_out:
            self.proj = Linear(dim, dim_out)
        self.stride_skip = tuple(stride_q)
        if layer_scale_init_value > 0:
            self.gamma_1 = nn.Parameter(torch.full((att_dim,), float(layer_scale_init_value)))
            self.gamma_2 = nn.Parameter(torch.full((dim_out,), float(layer_scale_init_value)))
        self.layer_scale = layer_scale_init_value > 0
        self.norm2 = LayerNorm(att_dim, NORM_EPS)
        self.mlp = Mlp(att_dim, int(att_dim * mlp_ratio), dim_out)

    def forward(self, x: torch.Tensor, thw, masks=None):
        """masks: None, or the two drawn keep masks (attention, MLP)."""
        dt, keep = self.dtype, 1.0 - self.drop_path
        m1, m2 = masks if masks is not None else (None, None)
        x_norm = self.norm1(x)
        x_block, thw_new = self.attn(x_norm, thw)
        proj = getattr(self, "proj", None)
        if self.dim_mul_in_att and proj is not None:
            x = proj(x_norm.to(dt))
        if self.stride_skip and math.prod(self.stride_skip) > 1:
            kernel_skip = tuple(s + 1 if s > 1 else s for s in self.stride_skip)
            x_res, _ = attention_pool(x[:, None], thw, kernel_skip, self.stride_skip, "max", self.has_cls)
            x_res = x_res[:, 0]
        else:
            x_res = x
        if self.layer_scale:
            x_block = x_block * self.gamma_1.to(x_block.dtype)
        x = x_res + _drop(x_block, m1, keep)
        x_norm = self.norm2(x)
        x_mlp = self.mlp(x_norm.to(dt))
        if not self.dim_mul_in_att and proj is not None:
            x = proj(x_norm.to(dt))
        if self.layer_scale:
            x_mlp = x_mlp * self.gamma_2.to(x_mlp.dtype)
        return x + _drop(x_mlp, m2, keep), thw_new


# --------------------------------------------------------------- model


@dataclasses.dataclass(frozen=True)
class MViTSpec:
    """Static arch parameters (``cfg.MVIT.*`` + input geometry): a copy of
    ``vtm``'s ``MViTSpec`` and its schedule arithmetic."""

    num_classes: Union[int, Tuple[int, ...]]
    num_frames: int
    crop_size: int
    in_chans: int
    embed_dim: int
    num_heads: int
    depth: int
    mlp_ratio: float
    qkv_bias: bool
    mode: str
    pool_first: bool
    cls_embed_on: bool
    use_mean_pooling: bool
    use_abs_pos: bool
    use_fixed_sincos_pos: bool
    sep_pos_embed: bool
    rel_pos_spatial: bool
    rel_pos_temporal: bool
    rel_pos_zero_init: bool
    residual_pooling: bool
    dim_mul_in_att: bool
    separate_qkv: bool
    patch_kernel: Tuple[int, int, int]
    patch_stride: Tuple[int, int, int]
    patch_padding: Tuple[int, int, int]
    dim_mul: Tuple[Tuple[int, float], ...]
    head_mul: Tuple[Tuple[int, float], ...]
    pool_q_stride: Tuple[Tuple[int, ...], ...]
    pool_kv_stride: Tuple[Tuple[int, ...], ...]
    pool_kv_stride_adaptive: Optional[Tuple[int, int, int]]
    pool_kvq_kernel: Optional[Tuple[int, int, int]]
    norm_stem: bool
    layer_scale_init_value: float
    droppath_rate: float
    dropout_rate: float
    head_act: str
    norm_eps: float = NORM_EPS
    rev_enable: bool = False
    rev_respath_fuse: str = "concat"
    rev_buffer_layers: Tuple[int, ...] = ()
    rev_res_path: str = "conv"
    rev_pre_q_fusion: str = "avg"
    detection: bool = False  # DETECTION.ENABLE: the ROI head
    roi_resolution: int = 7
    roi_scale_factor: int = 16
    roi_aligned: bool = True
    mlp_layers: int = 1  # the contrastive family's SSL head (CONTRASTIVE.*)
    mlp_dim: int = 2048
    mlp_bn: bool = False
    multi_head = False  # one head (not a field: no config sets another)

    @property
    def patch_dims(self) -> Tuple[int, int, int]:
        return (
            self.num_frames // self.patch_stride[0],
            self.crop_size // self.patch_stride[1],
            self.crop_size // self.patch_stride[2],
        )

    def _muls(self):
        dim_mul = np.ones(self.depth + 1)
        head_mul = np.ones(self.depth + 1)
        for i, m in self.dim_mul:
            dim_mul[int(i)] = m
        for i, m in self.head_mul:
            head_mul[int(i)] = m
        return dim_mul, head_mul

    def _pool_schedule(self):
        """Per-depth pool kernels and strides (``vtm``'s ``_pool_schedule``)."""
        depth = self.depth
        pool_q = [[] for _ in range(depth)]
        pool_kv = [[] for _ in range(depth)]
        stride_q = [[] for _ in range(depth)]
        stride_kv = [[] for _ in range(depth)]
        for entry in self.pool_q_stride:
            i = int(entry[0])
            stride_q[i] = list(entry[1:])
            pool_q[i] = (list(self.pool_kvq_kernel) if self.pool_kvq_kernel is not None
                         else [s + 1 if s > 1 else s for s in entry[1:]])
        kv_stride = self.pool_kv_stride
        if self.pool_kv_stride_adaptive is not None:
            _stride_kv = list(self.pool_kv_stride_adaptive)
            kv_stride = []
            for i in range(depth):
                if len(stride_q[i]) > 0:
                    _stride_kv = [max(_stride_kv[d] // stride_q[i][d], 1) for d in range(len(_stride_kv))]
                kv_stride.append([i] + _stride_kv)
        for entry in kv_stride:
            i = int(entry[0])
            stride_kv[i] = list(entry[1:])
            pool_kv[i] = (list(self.pool_kvq_kernel) if self.pool_kvq_kernel is not None
                          else [s + 1 if s > 1 else s for s in entry[1:]])
        return pool_q, pool_kv, stride_q, stride_kv

    def block_plan(self):
        """Per-block (dim, dim_out, num_heads, input_size, kernels, strides)
        (``vtm``'s ``block_plan``)."""
        dim_mul, head_mul = self._muls()
        pool_q, pool_kv, stride_q, stride_kv = self._pool_schedule()
        plan = []
        embed_dim = self.embed_dim
        num_heads = self.num_heads
        input_size = list(self.patch_dims)
        for i in range(self.depth):
            num_heads = round_width(num_heads, head_mul[i])
            if self.dim_mul_in_att:
                dim_out = round_width(embed_dim, dim_mul[i], divisor=round_width(num_heads, head_mul[i]))
            else:
                dim_out = round_width(embed_dim, dim_mul[i + 1], divisor=round_width(num_heads, head_mul[i + 1]))
            plan.append(dict(dim=embed_dim, dim_out=dim_out, num_heads=num_heads, input_size=tuple(input_size),
                             kernel_q=tuple(pool_q[i]), kernel_kv=tuple(pool_kv[i]), stride_q=tuple(stride_q[i]),
                             stride_kv=tuple(stride_kv[i])))
            if len(stride_q[i]) > 0:
                input_size = [size // s for size, s in zip(input_size, stride_q[i])]
            embed_dim = dim_out
        return plan

    def rev_block_plan(self):
        """Per-layer schedule of the reversible encoder (``vtm``'s
        ``rev_block_plan``): the width changes only in the stage-transition
        layers (``MVIT.REV.BUFFER_LAYERS``)."""
        dim_mul, head_mul = self._muls()
        pool_q, pool_kv, stride_q, stride_kv = self._pool_schedule()
        concat_fuse = "concat" in self.rev_pre_q_fusion
        plan = []
        embed_dim = self.embed_dim
        num_heads = self.num_heads
        input_size = list(self.patch_dims)
        for i in range(self.depth):
            num_heads = round_width(num_heads, head_mul[i])
            embed_dim = round_width(embed_dim, dim_mul[i - 1] if i > 0 else 1.0, divisor=num_heads)
            dim_out = round_width(embed_dim, dim_mul[i], divisor=round_width(num_heads, head_mul[i + 1]))
            is_transition = i in self.rev_buffer_layers
            input_mult = 2 if (is_transition and concat_fuse) else 1
            plan.append(dict(dim=embed_dim * input_mult, dim_out=dim_out, num_heads=num_heads,
                             input_size=tuple(input_size), kernel_q=tuple(pool_q[i]), kernel_kv=tuple(pool_kv[i]),
                             stride_q=tuple(stride_q[i]), stride_kv=tuple(stride_kv[i]),
                             is_transition=is_transition))
            if len(stride_q[i]) > 0:
                input_size = [size // s for size, s in zip(input_size, stride_q[i])]
        return plan

    @property
    def rev_final_dim(self) -> int:
        """The single stream's width after the reversible encoder."""
        dim_mul, _ = self._muls()
        return round_width(self.embed_dim, float(np.prod(dim_mul)), divisor=self.num_heads)


def mvit_spec_from_cfg(cfg) -> MViTSpec:
    """``vtm``'s ``mvit_spec_from_cfg`` (``MVIT.PATCH_2D`` and
    ``MVIT.HEAD_INIT_SCALE`` left out, which ``vtm``'s model does not read)."""
    assert cfg.DATA.TRAIN_CROP_SIZE == cfg.DATA.TEST_CROP_SIZE
    t = lambda v: tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in v)
    return MViTSpec(
        num_classes=cfg.MODEL.NUM_CLASSES,
        num_frames=cfg.DATA.NUM_FRAMES,
        crop_size=cfg.DATA.TRAIN_CROP_SIZE,
        in_chans=cfg.DATA.INPUT_CHANNEL_NUM[0],
        embed_dim=cfg.MVIT.EMBED_DIM,
        num_heads=cfg.MVIT.NUM_HEADS,
        depth=cfg.MVIT.DEPTH,
        mlp_ratio=cfg.MVIT.MLP_RATIO,
        qkv_bias=cfg.MVIT.QKV_BIAS,
        mode=cfg.MVIT.MODE,
        pool_first=cfg.MVIT.POOL_FIRST,
        cls_embed_on=cfg.MVIT.CLS_EMBED_ON,
        use_mean_pooling=cfg.MVIT.USE_MEAN_POOLING,
        use_abs_pos=cfg.MVIT.USE_ABS_POS,
        use_fixed_sincos_pos=cfg.MVIT.USE_FIXED_SINCOS_POS,
        sep_pos_embed=cfg.MVIT.SEP_POS_EMBED,
        rel_pos_spatial=cfg.MVIT.REL_POS_SPATIAL,
        rel_pos_temporal=cfg.MVIT.REL_POS_TEMPORAL,
        rel_pos_zero_init=cfg.MVIT.REL_POS_ZERO_INIT,
        residual_pooling=cfg.MVIT.RESIDUAL_POOLING,
        dim_mul_in_att=cfg.MVIT.DIM_MUL_IN_ATT,
        separate_qkv=cfg.MVIT.SEPARATE_QKV,
        patch_kernel=tuple(cfg.MVIT.PATCH_KERNEL),
        patch_stride=tuple(cfg.MVIT.PATCH_STRIDE),
        patch_padding=tuple(cfg.MVIT.PATCH_PADDING),
        dim_mul=t(cfg.MVIT.DIM_MUL),
        head_mul=t(cfg.MVIT.HEAD_MUL),
        pool_q_stride=t(cfg.MVIT.POOL_Q_STRIDE),
        pool_kv_stride=t(cfg.MVIT.POOL_KV_STRIDE),
        pool_kv_stride_adaptive=(tuple(cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE)
                                 if cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE is not None else None),
        pool_kvq_kernel=tuple(cfg.MVIT.POOL_KVQ_KERNEL) if cfg.MVIT.POOL_KVQ_KERNEL is not None else None,
        norm_stem=cfg.MVIT.NORM_STEM,
        layer_scale_init_value=cfg.MVIT.LAYER_SCALE_INIT_VALUE,
        droppath_rate=cfg.MVIT.DROPPATH_RATE,
        dropout_rate=cfg.MODEL.DROPOUT_RATE,
        head_act=cfg.MODEL.HEAD_ACT,
        rev_enable=cfg.MVIT.REV.ENABLE,
        rev_respath_fuse=cfg.MVIT.REV.RESPATH_FUSE,
        rev_buffer_layers=tuple(cfg.MVIT.REV.BUFFER_LAYERS),
        rev_res_path=cfg.MVIT.REV.RES_PATH,
        rev_pre_q_fusion=cfg.MVIT.REV.PRE_Q_FUSION,
        detection=cfg.DETECTION.ENABLE,
        roi_resolution=cfg.DETECTION.ROI_XFORM_RESOLUTION,
        roi_scale_factor=cfg.DETECTION.SPATIAL_SCALE_FACTOR,
        roi_aligned=cfg.DETECTION.ALIGNED,
        mlp_layers=cfg.CONTRASTIVE.NUM_MLP_LAYERS,
        mlp_dim=cfg.CONTRASTIVE.MLP_DIM,
        mlp_bn=cfg.CONTRASTIVE.BN_MLP,
    )


class _PatchEmbed(nn.Module):
    """``patch_embed.proj``: the Conv3d patchify [B, T, H, W, C] -> [B, C', T', H', W'] in ``dtype``."""

    def __init__(self, in_chans: int, dim: int, kernel, stride, padding, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Conv3d(in_chans, dim, tuple(kernel), tuple(stride), tuple(padding))

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        p, dt = self.proj, self.dtype
        return F.conv3d(video.permute(0, 4, 1, 2, 3).to(dt), p.weight.to(dt), p.bias.to(dt), p.stride, p.padding)


class _Head(nn.Module):
    """``head.projection`` (upstream ``TransformerBasicHead``): a linear
    layer, or with ``mlp_layers`` > 1 the contrastive family's MLP."""

    def __init__(self, dim: int, num_classes: int, mlp_layers: int = 1, mlp_dim: int = 2048, mlp_bn: bool = False):
        super().__init__()
        if mlp_layers > 1:
            self.projection = MLPHead(dim, num_classes, mlp_dim, mlp_layers, mlp_bn)
        else:
            self.projection = nn.Linear(dim, num_classes)


def trunc02_(t: torch.Tensor, generator: torch.Generator) -> None:
    """``vtm``'s ``trunc02``: normal(0, 0.02) truncated at two deviations."""
    nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=generator)


@torch.no_grad()
def init_mvit_weights(module: nn.Module, generator: torch.Generator, rel_pos_zero_init: bool) -> None:
    """``vtm``'s initialisers: the MLPs' linear layers (``Mlp``: blocks, the
    reversible G, the fusions; the contrastive head's ``MLPHead``)
    lecun-normal with zero biases; every other
    linear layer, the patch embedding and the pooling convs trunc02 with
    biases 0.02; the position tables and the class token trunc02 (a fixed
    sin-cos table is set over it after); ``rel_pos_*`` zeros under
    ``MVIT.REL_POS_ZERO_INIT``, else trunc02; LayerNorms 1 and 0; layer
    scales their constant."""
    mlp_linears = set()
    for m in module.modules():
        if isinstance(m, Mlp):
            for fc in (m.fc1, m.fc2):
                lecun_normal_(fc.weight, generator)
                nn.init.zeros_(fc.bias)
                mlp_linears.add(id(fc))
    for fc in mlp_head_linears(module):
        lecun_normal_(fc.weight, generator)
        if fc.bias is not None:
            nn.init.zeros_(fc.bias)
        mlp_linears.add(id(fc))
    for m in module.modules():
        if isinstance(m, nn.Linear) and id(m) not in mlp_linears or isinstance(m, nn.Conv3d):
            trunc02_(m.weight, generator)
            if m.bias is not None:
                nn.init.constant_(m.bias, 0.02)
    for name, p in module.named_parameters(recurse=True):
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("cls_token", "pos_embed", "pos_embed_spatial", "pos_embed_temporal", "pos_embed_class"):
            trunc02_(p, generator)
        elif leaf.startswith("rel_pos_") and not rel_pos_zero_init:
            trunc02_(p, generator)


class MViTModel(nn.Module):
    """MViT (``vtm``'s ``MViTModel``), with the ROI head under
    ``DETECTION.ENABLE`` (the module docstring). Input
    [B, T, H, W, C] (or a one-element list of it); returns (logits, state):
    logits in training mode, the head's activation in eval mode. The
    position tables are resized to the input's patch grid when it differs
    from the configured one (``resize_linear``; absolute positions only, as
    in ``vtm``). ``act_checkpoint`` (``MODEL.ACT_CHECKPOINT``) runs each
    block under ``torch.utils.checkpoint`` when gradients are recorded."""

    takes_boxes = True  # DETECTION.ENABLE builds the ROI head
    supports_tensor_parallel = True  # parallel/sharding.py cuts it (detection runs in one process)
    uneven_heads_stay_whole = True  # MViTv2-S's one-head first block at tp 2

    def __init__(self, spec: MViTSpec, dtype: torch.dtype = torch.float32, seed: int = 0,
                 fp32_params: bool = False, act_checkpoint: bool = False):
        super().__init__()
        s = self.config = self.spec = spec
        self.dtype, self.act_checkpoint = dtype, act_checkpoint
        self.patch_embed = _PatchEmbed(s.in_chans, s.embed_dim, s.patch_kernel, s.patch_stride, s.patch_padding, dtype)
        n = int(np.prod(s.patch_dims))
        sp = 1 if s.cls_embed_on else 0
        if s.use_abs_pos and not s.sep_pos_embed:
            self.pos_embed = nn.Parameter(torch.zeros(1, n + sp, s.embed_dim))
        if s.cls_embed_on:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, s.embed_dim))
        if s.use_abs_pos and s.sep_pos_embed:
            p_t, p_h, p_w = s.patch_dims
            self.pos_embed_spatial = nn.Parameter(torch.zeros(1, p_h * p_w, s.embed_dim))
            self.pos_embed_temporal = nn.Parameter(torch.zeros(1, p_t, s.embed_dim))
            if s.cls_embed_on:
                self.pos_embed_class = nn.Parameter(torch.zeros(1, 1, s.embed_dim))
        if s.norm_stem:
            self.norm_stem = LayerNorm(s.embed_dim, s.norm_eps)
        if s.rev_enable:
            from vtm_torch.models.mvit_rev import ReversibleMViT, TwoStreamFusion

            assert not s.cls_embed_on, "rev does not allow cls token"
            assert not s.detection, "rev does not support detection"
            self.rev_backbone = ReversibleMViT(s, dtype)
            two_dim = 2 * s.rev_final_dim
            self.fuse = TwoStreamFusion(s.rev_respath_fuse, dim=two_dim)
            fused = self.fuse.out_dim(two_dim)
            self.norm = LayerNorm(fused if s.use_mean_pooling else two_dim, s.norm_eps)
            head_dim = fused
        else:
            plan = s.block_plan()
            dpr = np.linspace(0, s.droppath_rate, s.depth)
            self.blocks = nn.ModuleList(
                MultiScaleBlock(
                    blk["dim"], blk["dim_out"], blk["num_heads"], blk["input_size"], s.mlp_ratio, s.qkv_bias,
                    blk["kernel_q"], blk["kernel_kv"], blk["stride_q"], blk["stride_kv"], s.mode, s.cls_embed_on,
                    s.pool_first, s.rel_pos_spatial, s.rel_pos_temporal, s.residual_pooling, s.dim_mul_in_att, s.separate_qkv, s.layer_scale_init_value, float(dpr[i]), dtype)
                for i, blk in enumerate(plan))
            head_dim = plan[-1]["dim_out"]
            self.norm = LayerNorm(head_dim, s.norm_eps)
        if s.detection:
            self.head = ResNetRoIHead((head_dim,), s.num_classes, (s.roi_resolution,), (s.roi_scale_factor,),
                                      s.dropout_rate, s.head_act, s.roi_aligned)
        else:
            self.head = _Head(head_dim, s.num_classes, s.mlp_layers, s.mlp_dim, s.mlp_bn)
        generator = torch.Generator().manual_seed(seed)
        init_mvit_weights(self, generator, s.rel_pos_zero_init)
        if s.detection:  # vtm's ResNetRoIHead: normal(fc_init_std 0.01), zero bias
            with torch.no_grad():
                nn.init.normal_(self.head.projection.weight, std=0.01, generator=generator)
                nn.init.zeros_(self.head.projection.bias)
        if s.use_fixed_sincos_pos:
            table = get_3d_sincos_pos_embed(s.embed_dim, s.patch_dims[1], s.patch_dims[0], s.cls_embed_on)
            with torch.no_grad():
                self.pos_embed.copy_(torch.from_numpy(table[None].astype(np.float32)))
        if not fp32_params:
            for name, m in self.named_modules():
                if isinstance(m, nn.Linear) and not name.startswith("head") and "fuse" not in name or \
                        name == "patch_embed.proj":
                    m.to(dtype)

    def _to_grid(self, pe: torch.Tensor, thw) -> torch.Tensor:
        """A table on the configured patch grid -> the input's grid."""
        if tuple(thw) == self.spec.patch_dims:
            return pe
        grid = pe.reshape((1,) + self.spec.patch_dims + (pe.shape[-1],))
        return resize_linear(grid, (1,) + tuple(thw) + (grid.shape[-1],)).reshape(1, -1, pe.shape[-1])

    def embed(self, x) -> Tuple[torch.Tensor, tuple]:
        """The clip -> the first block's tokens [B, N, C] and the patch grid."""
        s = self.spec
        if isinstance(x, (list, tuple)):
            x = x[0]
        b = x.shape[0]
        x = self.patch_embed(x)
        thw = tuple(int(d) for d in x.shape[2:])
        if thw != s.patch_dims:
            assert s.use_abs_pos and not s.use_fixed_sincos_pos, (thw, s.patch_dims)
        x = x.flatten(2).transpose(1, 2)
        sp = 1 if s.cls_embed_on else 0
        if s.use_fixed_sincos_pos:
            x = x + self.pos_embed[:, sp:, :].to(x.dtype)
        if s.cls_embed_on:
            cls = self.cls_token.expand(b, 1, s.embed_dim).to(x.dtype)
            if s.use_fixed_sincos_pos:
                cls = cls + self.pos_embed[:, :1, :].to(x.dtype)
            x = torch.cat([cls, x], dim=1)
        if s.use_abs_pos:
            if s.sep_pos_embed:
                p_t, p_h, p_w = s.patch_dims
                pe = self.pos_embed_spatial.repeat(1, p_t, 1) + \
                    self.pos_embed_temporal.repeat_interleave(p_h * p_w, dim=1)
                pe = self._to_grid(pe, thw)
                if s.cls_embed_on:
                    pe = torch.cat([self.pos_embed_class, pe], dim=1)
            else:
                pe = self.pos_embed
                if thw != s.patch_dims:
                    pe = torch.cat([pe[:, :sp], self._to_grid(pe[:, sp:], thw)], dim=1)
            x = x + pe.to(x.dtype)
        if s.norm_stem:
            x = self.norm_stem(x)
        return x, thw

    def _block_masks(self, blk: MultiScaleBlock, b: int, device, generator):
        if not self.training or blk.drop_path <= 0.0:
            return None
        return tuple(draw_keep_mask(blk.drop_path, b, device, generator) for _ in range(2))

    def forward(self, x, state=None, generator: Optional[torch.Generator] = None, bboxes=None):
        s = self.spec
        if s.detection and bboxes is None:
            raise ValueError("a detection model (DETECTION.ENABLE) takes the boxes: forward(x, bboxes=...)")
        x, thw = self.embed(x)
        b = x.shape[0]
        if s.rev_enable:
            x = self.rev_backbone(x, generator)
            if s.use_mean_pooling:
                x = self.norm(self.fuse(x, generator).mean(dim=1))
            else:
                x = self.fuse(self.norm(x), generator).mean(dim=1)
        else:
            use_checkpoint = self.act_checkpoint and torch.is_grad_enabled()
            for blk in self.blocks:
                masks = self._block_masks(blk, b, x.device, generator)
                if use_checkpoint:
                    x, thw = checkpoint(blk, x, thw, masks, use_reentrant=False)
                else:
                    x, thw = blk(x, thw, masks)
            if s.detection:  # norm, no class token, [B, C, T, H, W] for the ROI head
                x = self.norm(x)
                if s.cls_embed_on:
                    x = x[:, 1:]
                x = x.reshape((b,) + tuple(thw) + (x.shape[-1],)).permute(0, 4, 1, 2, 3)
                return self.head([x], bboxes, generator), state
            if s.use_mean_pooling:
                if s.cls_embed_on:
                    x = x[:, 1:]
                x = self.norm(x.mean(dim=1))
            elif s.cls_embed_on:
                x = self.norm(x)[:, 0]
            else:
                x = self.norm(x).mean(dim=1)
        x = dropout(x, s.dropout_rate, self.training, generator)
        logits = self.head.projection(x.float())
        if not self.training:
            if s.head_act == "softmax":
                logits = torch.softmax(logits, dim=-1)
            elif s.head_act == "sigmoid":
                logits = torch.sigmoid(logits)
        return logits, state


from vtm_torch.models.build import ModelBundle, compute_dtype, register_model  # noqa: E402


@register_model("MViT", MViTModel)
def _build_mvit_bundle(cfg, fp32_params: bool = False) -> ModelBundle:
    module = MViTModel(mvit_spec_from_cfg(cfg), dtype=compute_dtype(cfg), seed=cfg.RNG_SEED,
                       fp32_params=fp32_params, act_checkpoint=cfg.MODEL.ACT_CHECKPOINT)
    return ModelBundle(module=module, policy=MergePolicy(), name="MViT")
