"""Shared model components in PyTorch (port of ``vtm/models/common.py``).

Conventions, as in the JAX package:
  * activations in the compute dtype (bf16 by default); layernorms and
    the softmax in fp32;
  * video tensors are channels-last [B, T, H, W, C];
  * attention takes [B, H, N, hd] and attention modules return
    ``(out, metric)``, where metric is the head-aggregated key tensor
    used for token matching;
  * parameters may be kept in fp32 while the activations are bf16 (the
    training layout): ``Linear`` and ``TubeletEmbed`` cast their weights
    to the activation dtype at use, so gradients and optimizer state stay
    fp32. When the weights already have that dtype (serving) the cast is
    a no-op.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from vtm_torch.ops.flash_attention import _reference, tome_flash_attention
from vtm_torch.parallel.sharding import copy_to_model, gather_features, reduce_from_model


def sinusoid_encoding_table(n_position: int, d_hid: int) -> np.ndarray:
    """Fixed sin-cos positional table [1, n_position, d_hid] (fp32)."""
    position = np.arange(n_position)[:, None]
    dim = np.arange(d_hid)[None, :]
    angle = position / np.power(10000.0, 2 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table[None]


def aggregate_metric(k: torch.Tensor, head_aggregation: str, group=None) -> torch.Tensor:
    """Aggregate per-head keys [B, H, N, hd] into a matching metric.

    'mean'   -> [B, N, hd]
    'concat' -> [B, N, H*hd]

    Under tensor parallelism (``group``, the model group) k holds this
    rank's heads, and the metric comes from every rank's, so that each rank
    of the group makes the same Matching: 'mean' all-reduces the fp32 sum
    of the local heads and divides by the total head count (rounded once to
    k's dtype, as ``k.mean`` rounds); 'concat' gathers the heads in rank
    order. The metric only picks indices, so it carries no gradient there.
    """
    if head_aggregation not in ("mean", "concat"):
        raise ValueError(f"unknown head_aggregation {head_aggregation!r}")
    if group is None:
        return k.mean(dim=1) if head_aggregation == "mean" else merge_heads(k)
    if head_aggregation == "concat":
        return gather_features(merge_heads(k).detach(), group)
    total = k.detach().float().sum(dim=1)
    dist.all_reduce(total, group=group)
    return (total / (k.shape[1] * dist.get_world_size(group))).to(k.dtype)


def proportional_attn_bias(size: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """log(size) bias [B, N, 1] -> [B, 1, 1, N], added to attention logits."""
    if size is None:
        return None
    return torch.log(size[:, :, 0])[:, None, None, :]


def dropout(
    x: torch.Tensor, rate: float, training: bool, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Elementwise dropout with an explicit generator: Bernoulli(1 - rate)
    keep mask, kept values scaled by 1 / (1 - rate). Identity outside
    training or at rate 0."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return x * mask.to(x.dtype) / keep


def drop_path(
    z: torch.Tensor, rate: float, training: bool, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Stochastic depth on a residual branch: a per-sample Bernoulli keep,
    scaled by 1 / keep. Identity outside training or at rate 0."""
    if not training or rate <= 0.0:
        return z
    keep = 1.0 - rate
    shape = (z.shape[0],) + (1,) * (z.dim() - 1)
    mask = torch.rand(shape, generator=generator, device=z.device) < keep
    return z * mask.to(z.dtype) / keep


class Linear(nn.Linear):
    """nn.Linear that computes in its input's dtype: weight and bias are
    cast at use (a no-op when they already have that dtype). Cut row-wise
    for tensor parallelism (``model_group`` set by
    ``parallel/sharding.py::shard_module``), it all-reduces its product
    over the model group (``g``) and adds the bias after."""

    model_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if self.model_group is None:
            return F.linear(x, self.weight.to(x.dtype), bias)
        y = reduce_from_model(F.linear(x, self.weight.to(x.dtype)), self.model_group)
        return y if bias is None else y + bias


class TubeletEmbed(nn.Module):
    """Tubelet embedding [B, T, H, W, C] -> [B, T/t * H/ph * W/pw, dim]: a
    Conv3d with kernel = stride = (t, ph, pw), tokens in (t, h, w) order.
    ``patch`` is the square patch's side or a (ph, pw) pair. Computes in
    ``dtype``, or in the weight's dtype when that is None."""

    def __init__(self, in_chans: int, features: int, tubelet: int, patch,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        ph, pw = (patch, patch) if isinstance(patch, int) else patch
        self.proj = nn.Conv3d(in_chans, features, kernel_size=(tubelet, ph, pw), stride=(tubelet, ph, pw))

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        p = self.proj
        dtype = self.dtype or p.weight.dtype
        x = F.conv3d(
            v.permute(0, 4, 1, 2, 3).to(dtype), p.weight.to(dtype), p.bias.to(dtype), stride=p.stride
        )
        return x.flatten(2).transpose(1, 2)


class PatchEmbed2d(nn.Module):
    """Per-frame patch embedding [B, T, H, W, C] -> [B, T * H/p * W/p, dim]
    (``patch_size_temp`` 1): a Conv2d with kernel = stride = p over every
    frame, tokens frame-major. Computes in ``dtype``, or in the weight's
    dtype when that is None."""

    def __init__(self, in_chans: int, features: int, patch: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Conv2d(in_chans, features, kernel_size=patch, stride=patch)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        p = self.proj
        dtype = self.dtype or p.weight.dtype
        b = v.shape[0]
        frames = v.flatten(0, 1).permute(0, 3, 1, 2).to(dtype)
        x = F.conv2d(frames, p.weight.to(dtype), p.bias.to(dtype), stride=p.stride)
        return x.flatten(2).transpose(1, 2).reshape(b, -1, x.shape[1])


class Mlp(nn.Module):
    """Transformer MLP: fc1 -> exact GELU -> fc2 (+ dropout when training).
    Under the tensor-parallel cuts (fc1 by columns, fc2 by rows) its input
    passes ``f`` over ``model_group``."""

    model_group = None

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 drop: float = 0.0):
        super().__init__()
        self.drop = drop
        self.fc1 = Linear(in_features, hidden_features)
        self.fc2 = Linear(hidden_features, out_features)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = copy_to_model(x, self.model_group)
        return dropout(self.fc2(F.gelu(self.fc1(x))), self.drop, self.training, generator)


class LayerNorm(nn.LayerNorm):
    """fp32 layernorm whatever the activation dtype; parameters stay fp32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps).to(x.dtype)


# ``attention_core`` sends rows of 256 to 4096 tokens to the dense kernel
# (K1) and shorter or longer rows to the plain product, as in the JAX
# package. Both bounds were set on the TPU and are still to be measured on
# the H100. They are K1's only: TimeSformer's divided spatial attention
# (197 tokens a frame and fewer) goes to the block-diagonal kernel (K5) at
# every frame length, from ``models/timesformer.py``.
_FLASH_MIN_SEQ = 256
_FLASH_MAX_SEQ = 4096


def attention_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    size_bias: Optional[torch.Tensor] = None,
    bias_excludes_first: bool = False,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Scaled dot-product attention over [B, H, N, hd] with an optional
    proportional-attention bias ``size_bias`` [B, 1, 1, N].

    On CUDA, rows of 256 to 4096 tokens go to the fused kernel
    (``tome_flash_attention``); everything else, and every call with
    ``use_kernel=False``, takes the plain product.

    ``bias_excludes_first``: TimeSformer adds log(size) only to the non-CLS
    block of the logits: ``size_bias`` then has key length N - 1 and is
    added to ``logits[:, :, 1:, 1:]``. With the key bias [0, log size] that
    is the bias on every query row but the first: the rank-1 product
    row_mask x key_bias added to the logits. This form is plain products at
    every length: it serves the CPU and ``use_kernel=False``, and on CUDA
    the divided spatial attention, its only caller with a size, takes the
    block-diagonal kernel instead (``models/timesformer.py``).
    """
    n = q.shape[2]
    kernel_ok = (
        use_kernel
        and q.is_cuda
        and n == k.shape[2]
        and _FLASH_MIN_SEQ <= n <= _FLASH_MAX_SEQ
    )
    if not bias_excludes_first or size_bias is None:
        key_bias = None if size_bias is None else size_bias[:, 0, 0, :].float().contiguous()
        if kernel_ok:
            return tome_flash_attention(q, k, v, key_bias, scale)
        return _reference(q, k, v, key_bias, scale)

    key_bias = F.pad(size_bias[:, 0, 0, :].float(), (1, 0))  # [B, N]: 0 for the CLS key
    row_mask = (torch.arange(n, device=q.device) > 0).float()
    logits = torch.matmul((q * scale).float(), k.float().transpose(-2, -1))
    logits = logits + row_mask[None, None, :, None] * key_bias[:, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, N, hd] -> [B, N, H*hd]."""
    b, h, n, hd = x.shape
    return x.transpose(1, 2).reshape(b, n, h * hd)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, N, C] -> [B, H, N, C/H], a view."""
    b, n, c = x.shape
    return x.view(b, n, num_heads, c // num_heads).transpose(1, 2)
