"""3-D conv building blocks of the PySlowFast families (SlowFast, ResNet,
X3D), in PyTorch: port of ``vtm/models/convnet.py``.

Layout: the clip arrives as [B, T, H, W, C]; the models permute it to
[B, C, T, H, W] without a copy, which is ``channels_last_3d`` memory, and
keep their conv weights in that format (cuDNN's tensor-core convolutions
prefer it). Everything here computes in fp32, as ``vtm``'s conv stack does
(in fp64 when a model and its input are cast to it, as a reference).

Modules carry the upstream PySlowFast names (``a``, ``a_bn``,
``branch2``, ``pathway0_res3``, ``conv_f2s``, ``head.projection``, ...),
so an upstream ``.pyth`` state dict loads with ``load_state_dict``
(``checkpoints/convert.py::load_pyslowfast_state_dict``).

BatchNorm (``BatchNorm``) keeps its running statistics as buffers. In
training mode it normalises with the batch's statistics and updates the
running ones with the biased variance, as ``vtm`` does (``F.batch_norm``
would store the unbiased one); in eval mode, or under ``NormSpec.frozen``
(``MODEL.FROZEN_BN``), it normalises with the running statistics. With
``sync_group`` set (``set_sync_group``; ``train_net`` sets the data group)
the statistics are those of the global batch, as ``vtm``'s step over the
sharded batch computes them: per-channel sums in fp32 and the element
counts are summed over the group, then the sums of squared deviations from
the global mean (two passes, as ``torch.var_mean``), each with an
all-reduce in the backward too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from vtm_torch.models.common import dropout, drop_path


def at_least_fp32(dtype: torch.dtype) -> torch.dtype:
    """The dtype the conv families compute in: fp32, or fp64 when given it
    (a reference computation)."""
    return torch.promote_types(dtype, torch.float32)


def round_width(width, multiplier, min_width=1, divisor=1):
    """Copy of ``vtm/models/convnet.py::round_width``."""
    if not multiplier:
        return width
    width *= multiplier
    min_width = min_width or divisor
    width_out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if width_out < 0.9 * width:
        width_out += divisor
    return int(width_out)


@dataclasses.dataclass(frozen=True)
class NormSpec:
    """The BatchNorm settings every block shares (``cfg.BN.*``): eps,
    momentum in torch's convention (running = (1 - m) running + m new),
    whether a block's final BN starts at zero (``RESNET.ZERO_INIT_FINAL_BN``),
    the splits of ``BN.NORM_TYPE sub_batchnorm`` and ``MODEL.FROZEN_BN``."""

    eps: float = 1e-5
    momentum: float = 0.1
    zero_init_final: bool = True
    num_splits: int = 1
    frozen: bool = False


class _RunningStats(nn.Module):
    """The running statistics of a SubBatchNorm's inner BNs (upstream
    ``X.bn`` and ``X.split_bn``), without affine parameters."""

    def __init__(self, c: int):
        super().__init__()
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))


class BatchNorm(nn.Module):
    """BN over (B, T, H, W) per channel of [B, C, T, H, W]; ``num_splits``
    > 1 keeps statistics per split of the batch (SubBatchNorm: split s is
    the s-th contiguous chunk of B / k rows, as in ``vtm``), in
    ``split_bn.running_*`` [k * C] (split-major), with the eval statistics in
    ``bn.running_*`` and the affine ``weight`` / ``bias`` on the module. As
    in ``vtm``, SlowFast, ResNet and X3D build every BN with one split
    whatever ``BN.NUM_SPLITS`` says; the PTV families (``models/ptv.py``)
    take it. ``set_num_splits`` re-shapes the statistics in place (a
    multigrid long-cycle flip)."""

    def __init__(self, c: int, spec: NormSpec, zero_init: bool = False, num_splits: int = 1):
        super().__init__()
        self.spec, self.zero_init, self.num_splits = spec, zero_init, num_splits
        self.weight = nn.Parameter(torch.zeros(c) if zero_init else torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        if num_splits > 1:
            self.bn = _RunningStats(c)
            self.split_bn = _RunningStats(c * num_splits)
        else:
            self.register_buffer("running_mean", torch.zeros(c))
            self.register_buffer("running_var", torch.ones(c))
        self.momentum = spec.momentum  # precise BN sets 1 for its forwards
        self.sync_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(at_least_fp32(x.dtype))
        k = self.num_splits
        if not self.training or self.spec.frozen:
            stats = self.bn if k > 1 else self
            return F.batch_norm(xf, stats.running_mean, stats.running_var, self.weight, self.bias, False, 0.0,
                                self.spec.eps).to(x.dtype)
        mean, var = self._batch_stats(xf)  # [k, C] each
        with torch.no_grad():
            m, stats = self.momentum, (self.split_bn if k > 1 else self)
            stats.running_mean.copy_((1 - m) * stats.running_mean + m * mean.reshape(-1))
            stats.running_var.copy_((1 - m) * stats.running_var + m * var.reshape(-1))
        shape = (xf.shape[0], xf.shape[1]) + (1,) * (xf.dim() - 2)
        if k > 1:  # each row normalised with its split's statistics
            row = self._row_splits(xf.shape[0], xf.device)
            mean, var = mean[row].view(shape), var[row].view(shape)
        else:
            mean, var = mean.view(1, -1, *shape[2:]), var.view(1, -1, *shape[2:])
        y = (xf - mean) / torch.sqrt(var + self.spec.eps)
        return (y * self.weight.view(1, -1, *shape[2:]) + self.bias.view(1, -1, *shape[2:])).to(x.dtype)

    @torch.no_grad()
    def set_num_splits(self, k: int) -> None:
        """Keep statistics over ``k`` sub-batches from now on, as ``vtm``'s
        ``train/multigrid.py::adapt_batch_stats`` re-shapes its stat tree: the
        eval statistics carry over, split statistics of another ``k`` start
        from their init (mean 0, variance 1). The affine parameters stay the
        same tensors."""
        if k == self.num_splits:
            return
        old = self.bn if self.num_splits > 1 else self
        mean, var = old.running_mean, old.running_var
        if self.num_splits > 1:
            del self.bn, self.split_bn
        else:
            del self.running_mean, self.running_var
        self.num_splits = k
        if k > 1:
            self.bn = _RunningStats(mean.numel()).to(mean)
            self.bn.running_mean.copy_(mean)
            self.bn.running_var.copy_(var)
            self.split_bn = _RunningStats(mean.numel() * k).to(mean)
        else:
            self.register_buffer("running_mean", mean)
            self.register_buffer("running_var", var)

    def _row_splits(self, b: int, device) -> torch.Tensor:
        """The split of each of this process's rows: contiguous chunks of
        the global batch, whose rows this rank holds from rank * b on."""
        k = self.num_splits
        if k == 1:
            return torch.zeros(b, dtype=torch.long, device=device)
        world, rank = 1, 0
        if self.sync_group is not None:
            world, rank = dist.get_world_size(self.sync_group), dist.get_rank(self.sync_group)
        total = b * world
        if total % k:
            raise ValueError(f"a batch of {total} does not split into {k} sub-batches")
        return (rank * b + torch.arange(b, device=device)) // (total // k)

    def _batch_stats(self, xf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The batch's (mean, biased var), [k, C] each."""
        k, b, c = self.num_splits, xf.shape[0], xf.shape[1]
        dims = tuple(range(2, xf.dim()))
        if self.sync_group is None:
            if k == 1:
                var, mean = torch.var_mean(xf, dim=(0,) + dims, unbiased=False)
                return mean[None], var[None]
            if b % k:  # vtm's reshape fails here too; nothing is padded
                raise ValueError(f"a batch of {b} does not split into {k} sub-batches")
            var, mean = torch.var_mean(xf.unflatten(0, (k, b // k)), dim=(1,) + tuple(d + 1 for d in dims),
                                       unbiased=False)
            return mean, var
        from vtm_torch.parallel.sharding import all_reduce_sum

        # two passes, as var_mean: the global mean first, then the sum of
        # squared deviations from it (no cancellation of E[x^2] - E[x]^2)
        row = self._row_splits(b, xf.device)
        per_row = xf[0, 0].numel()
        sums = xf.new_zeros(k, c).index_add(0, row, xf.sum(dim=dims))
        counts = torch.bincount(row, minlength=k).to(xf.dtype)[:, None] * per_row
        total = all_reduce_sum(torch.cat([sums, counts], dim=1), self.sync_group)
        counts = total[:, c:]
        mean = total[:, :c] / counts
        dev = (xf - mean[row].view((b, c) + (1,) * len(dims))).square().sum(dim=dims)
        squares = all_reduce_sum(xf.new_zeros(k, c).index_add(0, row, dev), self.sync_group)
        return mean, squares / counts


def batchnorms(module: nn.Module):
    return [m for m in module.modules() if isinstance(m, BatchNorm)]


def set_sync_group(module: nn.Module, group) -> None:
    """Compute every BatchNorm's training statistics over ``group``'s batch
    (None: this process's rows)."""
    for bn in batchnorms(module):
        bn.sync_group = group


@torch.no_grad()
def aggregate_subbn_stats(module: nn.Module) -> None:
    """Fold each SubBatchNorm's per-split running statistics into its eval
    statistics, in place (``vtm/models/convnet.py::aggregate_subbn_stats``):
    the mean of the split means, and the mean of the split variances plus
    the variance of the split means."""
    for bn in batchnorms(module):
        if bn.num_splits == 1:
            continue
        k = bn.num_splits
        split_mean = bn.split_bn.running_mean.view(k, -1)
        split_var = bn.split_bn.running_var.view(k, -1)
        mean = split_mean.mean(dim=0)
        bn.bn.running_mean.copy_(mean)
        bn.bn.running_var.copy_(split_var.mean(dim=0) + (split_mean - mean).square().sum(dim=0) / k)


def conv3d(c_in: int, c_out: int, kernel, stride=(1, 1, 1), padding=None, dilation=(1, 1, 1), groups: int = 1,
           bias: bool = False) -> nn.Conv3d:
    """A Conv3d with torch's symmetric integer padding (k // 2 by default)."""
    if padding is None:
        padding = tuple(k // 2 for k in kernel)
    return nn.Conv3d(c_in, c_out, tuple(kernel), tuple(stride), tuple(padding), tuple(dilation), groups, bias)


class _MaxPool3d(torch.autograd.Function):
    """``F.max_pool3d`` whose backward is deterministic: the gradient is
    scattered to each window's argmax by ``index_put_(accumulate=True)``
    (sorted on CUDA), where torch's CUDA backward adds overlapping windows'
    gradients with atomics in no fixed order. The argmax is the one
    ``F.max_pool3d`` picks, so the gradient is the same up to that order."""

    @staticmethod
    def forward(ctx, x, kernel, stride, pad):
        out, idx = F.max_pool3d(x, kernel, stride, pad, return_indices=True)
        ctx.save_for_backward(idx)
        ctx.in_shape = x.shape
        return out

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        n, c = ctx.in_shape[:2]
        plane = math.prod(ctx.in_shape[2:])
        flat = idx + torch.arange(n * c, device=idx.device).view(n, c, 1, 1, 1) * plane
        out = grad.new_zeros(n * c * plane).index_put_((flat.reshape(-1),), grad.reshape(-1), accumulate=True)
        return out.view(ctx.in_shape), None, None, None


def max_pool3d(x: torch.Tensor, kernel, stride, padding=(0, 0, 0)) -> torch.Tensor:
    """A max pool (padding as -inf) with ``_MaxPool3d``'s deterministic
    backward when a gradient is recorded: the conv stems' overlapping
    1x3x3 windows at stride 1x2x2, the pathway pools and MViT's pooling
    attention all pool through it."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _MaxPool3d.apply(x, tuple(kernel), tuple(stride), tuple(padding))
    return F.max_pool3d(x, tuple(kernel), tuple(stride), tuple(padding))


class Swish(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(x)


class SE(nn.Module):
    """Squeeze-and-excitation: global average, 1x1x1 conv + ReLU, 1x1x1
    conv + sigmoid, channel scale (``fc1``, ``fc2``)."""

    def __init__(self, dim_in: int, ratio: float):
        super().__init__()
        dim_fc = round_width(dim_in, ratio, min_width=8, divisor=8)
        self.fc1 = conv3d(dim_in, dim_fc, (1, 1, 1), bias=True)
        self.fc2 = conv3d(dim_fc, dim_in, (1, 1, 1), bias=True)

    def forward(self, x):
        s = x.mean(dim=(2, 3, 4), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class Nonlocal(nn.Module):
    """Non-local block: theta / phi / g 1x1x1 convs, the affinity over all
    (T, H, W) positions (softmax with scale dim_inner^-0.5, or
    dot_product: divided by the key count), ``conv_out`` + ``bn``, residual.
    ``pool_size`` max-pools phi and g."""

    def __init__(self, dim: int, dim_inner: int, pool_size=None, instantiation: str = "softmax",
                 norm: NormSpec = NormSpec()):
        super().__init__()
        if instantiation not in ("softmax", "dot_product"):
            raise NotImplementedError(f"Unknown norm type {instantiation}")
        self.dim_inner, self.instantiation = dim_inner, instantiation
        self.pool_size = tuple(pool_size) if pool_size is not None and any(s > 1 for s in pool_size) else None
        self.conv_theta = conv3d(dim, dim_inner, (1, 1, 1), bias=True)
        self.conv_phi = conv3d(dim, dim_inner, (1, 1, 1), bias=True)
        self.conv_g = conv3d(dim, dim_inner, (1, 1, 1), bias=True)
        self.conv_out = conv3d(dim_inner, dim, (1, 1, 1), bias=True)
        self.bn = BatchNorm(dim, norm, zero_init=norm.zero_init_final)

    def forward(self, x):
        b = x.shape[0]
        theta = self.conv_theta(x).reshape(b, self.dim_inner, -1)  # [B, C', THW]
        xp = x if self.pool_size is None else max_pool3d(x, self.pool_size, self.pool_size)
        phi = self.conv_phi(xp).reshape(b, self.dim_inner, -1)
        g = self.conv_g(xp).reshape(b, self.dim_inner, -1)
        aff = torch.einsum("bct,bcp->btp", theta, phi)
        if self.instantiation == "softmax":
            aff = torch.softmax(aff * (self.dim_inner ** -0.5), dim=2)
        else:
            aff = aff / aff.shape[2]
        out = torch.einsum("btp,bcp->bct", aff, g).reshape(b, self.dim_inner, *x.shape[2:])
        return x + self.bn(self.conv_out(out))


class BasicTransform(nn.Module):
    """Tx3x3 + 1x3x3."""

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, dilation=1, norm=NormSpec(), **_):
        super().__init__()
        t = temp_kernel_size
        self.a = conv3d(dim_in, dim_out, (t, 3, 3), (1, stride, stride), (t // 2, 1, 1))
        self.a_bn = BatchNorm(dim_out, norm)
        self.b = conv3d(dim_out, dim_out, (1, 3, 3), (1, 1, 1), (0, dilation, dilation), (1, dilation, dilation))
        self.b_bn = BatchNorm(dim_out, norm, zero_init=norm.zero_init_final)

    def forward(self, x):
        return self.b_bn(self.b(F.relu(self.a_bn(self.a(x)))))


class BottleneckTransform(nn.Module):
    """Tx1x1 + 1x3x3 (grouped) + 1x1x1."""

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, dim_inner, num_groups=1, stride_1x1=False,
                 dilation=1, norm=NormSpec(), **_):
        super().__init__()
        s1, s3 = (stride, 1) if stride_1x1 else (1, stride)
        t = temp_kernel_size
        self.a = conv3d(dim_in, dim_inner, (t, 1, 1), (1, s1, s1), (t // 2, 0, 0))
        self.a_bn = BatchNorm(dim_inner, norm)
        self.b = conv3d(dim_inner, dim_inner, (1, 3, 3), (1, s3, s3), (0, dilation, dilation),
                        (1, dilation, dilation), groups=num_groups)
        self.b_bn = BatchNorm(dim_inner, norm)
        self.c = conv3d(dim_inner, dim_out, (1, 1, 1))
        self.c_bn = BatchNorm(dim_out, norm, zero_init=norm.zero_init_final)

    def forward(self, x):
        x = F.relu(self.a_bn(self.a(x)))
        x = F.relu(self.b_bn(self.b(x)))
        return self.c_bn(self.c(x))


class X3DTransform(nn.Module):
    """1x1x1 + Tx3x3 depthwise (+ SE on even blocks, Swish) + 1x1x1."""

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, dim_inner, num_groups=1, stride_1x1=False,
                 dilation=1, se_ratio=0.0625, swish_inner=True, block_idx=0, norm=NormSpec(), **_):
        super().__init__()
        s1, s3 = (stride, 1) if stride_1x1 else (1, stride)
        t = temp_kernel_size
        self.a = conv3d(dim_in, dim_inner, (1, 1, 1), (1, s1, s1))
        self.a_bn = BatchNorm(dim_inner, norm)
        self.b = conv3d(dim_inner, dim_inner, (t, 3, 3), (1, s3, s3), (t // 2, dilation, dilation),
                        (1, dilation, dilation), groups=num_groups)
        self.b_bn = BatchNorm(dim_inner, norm)
        # SE every other block: (block_idx + 1) % 2 truthy, the even blocks
        self.se = SE(dim_inner, se_ratio) if se_ratio > 0.0 and (block_idx + 1) % 2 else None
        self.swish_inner = swish_inner
        self.b_swish = Swish()
        self.c = conv3d(dim_inner, dim_out, (1, 1, 1))
        self.c_bn = BatchNorm(dim_out, norm, zero_init=norm.zero_init_final)

    def forward(self, x):
        x = F.relu(self.a_bn(self.a(x)))
        x = self.b_bn(self.b(x))
        if self.se is not None:
            x = self.se(x)
        x = self.b_swish(x) if self.swish_inner else F.relu(x)
        return self.c_bn(self.c(x))


TRANS_FUNCS = {
    "bottleneck_transform": BottleneckTransform,
    "basic_transform": BasicTransform,
    "x3d_transform": X3DTransform,
}


class ResBlock(nn.Module):
    """Residual block: ``branch2`` (the transform), drop-connect in
    training, and a ``branch1`` / ``branch1_bn`` projection where the width
    or the stride changes."""

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, trans_func_name, dim_inner, num_groups=1,
                 stride_1x1=False, dilation=1, block_idx=0, drop_connect_rate=0.0, norm=NormSpec()):
        super().__init__()
        kwargs = dict(dim_in=dim_in, dim_out=dim_out, temp_kernel_size=temp_kernel_size, stride=stride,
                      dilation=dilation, norm=norm, dim_inner=dim_inner, num_groups=num_groups,
                      stride_1x1=stride_1x1)
        if trans_func_name == "x3d_transform":
            kwargs.update(block_idx=block_idx)
        self.branch2 = TRANS_FUNCS[trans_func_name](**kwargs)
        self.drop_connect_rate = drop_connect_rate
        self.project = dim_in != dim_out or stride != 1
        if self.project:
            self.branch1 = conv3d(dim_in, dim_out, (1, 1, 1), (1, stride, stride))
            self.branch1_bn = BatchNorm(dim_out, norm)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        f_x = drop_path(self.branch2(x), self.drop_connect_rate, self.training, generator)
        sc = self.branch1_bn(self.branch1(x)) if self.project else x
        return F.relu(sc + f_x)


class ResStage(nn.Module):
    """One multi-pathway stage: per pathway ``pathway{p}_res{i}`` blocks,
    with ``pathway{p}_nonlocal{i}`` after block i where ``nonlocal_inds``
    names it (temporal groups folded into the batch first)."""

    def __init__(self, dim_in, dim_out, stride, temp_kernel_sizes, num_blocks, dim_inner, num_groups,
                 num_block_temp_kernel, nonlocal_inds, nonlocal_group, nonlocal_pool, dilation,
                 instantiation="softmax", trans_func_name="bottleneck_transform", stride_1x1=False,
                 drop_connect_rate=0.0, norm=NormSpec()):
        super().__init__()
        self.num_blocks = tuple(num_blocks)
        self.nonlocal_inds = tuple(tuple(i) for i in nonlocal_inds)
        self.nonlocal_group = tuple(nonlocal_group)
        for p in range(len(num_blocks)):
            n, k = num_blocks[p], num_block_temp_kernel[p]
            # the basis repeated over the blocks, then 1s past num_block_temp_kernel
            temp_kernels = (list(temp_kernel_sizes[p]) * n)[:k] + [1] * (n - k)
            for i in range(n):
                self.add_module(f"pathway{p}_res{i}", ResBlock(
                    dim_in[p] if i == 0 else dim_out[p], dim_out[p], temp_kernels[i],
                    stride[p] if i == 0 else 1, trans_func_name, dim_inner[p], num_groups[p], stride_1x1,
                    dilation[p], i, drop_connect_rate, norm))
                if i in self.nonlocal_inds[p]:
                    self.add_module(f"pathway{p}_nonlocal{i}", Nonlocal(
                        dim_out[p], dim_out[p] // 2, nonlocal_pool[p], instantiation, norm))

    def forward(self, xs: Sequence[torch.Tensor], generator: Optional[torch.Generator] = None):
        out = []
        for p, x in enumerate(xs):
            for i in range(self.num_blocks[p]):
                x = getattr(self, f"pathway{p}_res{i}")(x, generator)
                if i in self.nonlocal_inds[p]:
                    group = self.nonlocal_group[p]
                    b, c, t, h, w = x.shape
                    if group > 1:  # fold temporal groups into the batch
                        x = x.reshape(b, c, group, t // group, h, w).transpose(1, 2).reshape(
                            b * group, c, t // group, h, w)
                    x = getattr(self, f"pathway{p}_nonlocal{i}")(x)
                    if group > 1:
                        x = x.reshape(b, group, c, t // group, h, w).transpose(1, 2).reshape(b, c, t, h, w)
            out.append(x)
        return out


class ResNetBasicStem(nn.Module):
    """``conv`` + ``bn`` + ReLU + 1x3x3 max-pool of stride 1x2x2."""

    def __init__(self, dim_in, dim_out, kernel, stride, padding, norm=NormSpec()):
        super().__init__()
        self.conv = conv3d(dim_in, dim_out, kernel, stride, padding)
        self.bn = BatchNorm(dim_out, norm)

    def forward(self, x):
        return max_pool3d(F.relu(self.bn(self.conv(x))), (1, 3, 3), (1, 2, 2), (0, 1, 1))


class X3DStem(nn.Module):
    """Spatial ``conv_xy``, then the depthwise temporal ``conv``, ``bn``, ReLU."""

    def __init__(self, dim_in, dim_out, kernel, stride, padding, norm=NormSpec()):
        super().__init__()
        self.conv_xy = conv3d(dim_in, dim_out, (1, kernel[1], kernel[2]), (1, stride[1], stride[2]),
                              (0, padding[1], padding[2]))
        self.conv = conv3d(dim_out, dim_out, (kernel[0], 1, 1), (stride[0], 1, 1), (padding[0], 0, 0),
                           groups=dim_out)
        self.bn = BatchNorm(dim_out, norm)

    def forward(self, x):
        return F.relu(self.bn(self.conv(self.conv_xy(x))))


class VideoModelStem(nn.Module):
    """A stem a pathway: ``pathway{p}_stem``."""

    def __init__(self, dim_in, dim_out, kernel, stride, padding, stem_func_name="basic_stem", norm=NormSpec()):
        super().__init__()
        cls = {"basic_stem": ResNetBasicStem, "x3d_stem": X3DStem}[stem_func_name]
        self.num_pathways = len(dim_out)
        for p in range(len(dim_out)):
            self.add_module(f"pathway{p}_stem", cls(dim_in[p], dim_out[p], kernel[p], stride[p], padding[p], norm))

    def forward(self, xs):
        return [getattr(self, f"pathway{p}_stem")(x) for p, x in enumerate(xs)]


class FuseFastToSlow(nn.Module):
    """Fast -> slow lateral connection: ``conv_f2s`` (time stride alpha) +
    ``bn`` + ReLU on the fast pathway, concatenated to the slow one's channels."""

    def __init__(self, dim_in, fusion_conv_channel_ratio, fusion_kernel, alpha, norm=NormSpec()):
        super().__init__()
        self.conv_f2s = conv3d(dim_in, dim_in * fusion_conv_channel_ratio, (fusion_kernel, 1, 1), (alpha, 1, 1),
                               (fusion_kernel // 2, 0, 0))
        self.bn = BatchNorm(dim_in * fusion_conv_channel_ratio, norm)

    def forward(self, xs):
        x_s, x_f = xs
        return [torch.cat([x_s, F.relu(self.bn(self.conv_f2s(x_f)))], dim=1), x_f]


def _activate(x: torch.Tensor, act_func: str, allow_none: bool) -> torch.Tensor:
    """The heads' eval activation over the classes of [B, t, h, w, K] (or [B, K])."""
    if act_func == "softmax":
        return torch.softmax(x, dim=-1)
    if act_func == "sigmoid":
        return torch.sigmoid(x)
    if act_func == "none" and allow_none:
        return x
    raise NotImplementedError(f"{act_func} is not supported as an activation function.")


def _pool_within(pool, x: torch.Tensor):
    """``pool``, where it fits the [B, C, T, H, W] map ``x``; else a clear
    error. (``vtm``'s pool leaves an empty map there, so its logits have no
    entries: a training loss of NaN; ROADMAP.md Queue 3.)"""
    if any(k > n for k, n in zip(pool, x.shape[2:])):
        raise ValueError(
            f"the head's average pool {tuple(pool)} (from DATA.NUM_FRAMES and DATA.TRAIN_CROP_SIZE) is larger than "
            f"its feature map {tuple(x.shape[2:])}: the clip is smaller than the one the head was built for (a "
            "multigrid short-cycle crop, say: SlowFast and ResNet pool globally under MULTIGRID.SHORT_CYCLE, CSN "
            "and R(2+1)D do not)")
    return pool


class MLPHead(nn.Module):
    """The contrastive family's projection / predictor MLP (``vtm``'s
    ``MLPHead``): ``fc0``, then for each further layer i ``bn{i}`` (with
    ``bn_on``), ReLU and ``fc{i}``; the last layer is ``dim_out`` wide.
    Biases are dropped on the layers a BatchNorm covers; the last layer
    keeps ``bias``. A map with more than two dims ([B, t, h, w, C]) is
    normalised per channel over all its positions."""

    def __init__(self, dim_in: int, dim_out: int, mlp_dim: int, num_layers: int, bn_on: bool = False,
                 bias: bool = True, norm: NormSpec = NormSpec()):
        super().__init__()
        self.num_layers, self.bn_on = num_layers, bn_on
        b = bias and not bn_on
        self.fc0 = nn.Linear(dim_in, mlp_dim, bias=b)
        for i in range(1, num_layers):
            if bn_on:
                self.add_module(f"bn{i}", BatchNorm(mlp_dim, norm))
            last = i == num_layers - 1
            self.add_module(f"fc{i}", nn.Linear(mlp_dim, dim_out if last else mlp_dim, bias=bias if last else b))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc0(x)
        for i in range(1, self.num_layers):
            if self.bn_on:
                bn = getattr(self, f"bn{i}")
                x = bn(x) if x.dim() == 2 else bn(x.movedim(-1, 1)).movedim(1, -1)
            x = getattr(self, f"fc{i}")(F.relu(x))
        return x


class ResNetBasicHead(nn.Module):
    """Per-pathway average pool (``pool_size`` None: global), concat,
    dropout, ``projection``; at eval the activation, then the mean of what
    is left of T, H, W (fully convolutional testing at a larger crop).
    ``mlp_layers`` > 1 makes ``projection`` the contrastive family's
    ``MLPHead`` (a [B, 1, 1, 1, C] map flattened to [B, C] first, as in
    ``vtm``), and each of ``predictor_depths`` appends a predictor MLP
    (``predictors.{i}``) over the projection: the head then returns
    [projection, *predictions]."""

    def __init__(self, dim_in: Sequence[int], num_classes: int, pool_size, dropout_rate=0.0, act_func="softmax",
                 detach_final_fc=False, mlp_layers=1, predictor_depths=(), mlp_dim=2048, mlp_bn=False,
                 norm: NormSpec = NormSpec()):
        super().__init__()
        self.pool_size = pool_size
        self.dropout_rate, self.act_func, self.detach_final_fc = dropout_rate, act_func, detach_final_fc
        self.mlp = mlp_layers > 1
        if self.mlp:
            self.projection = MLPHead(sum(dim_in), num_classes, mlp_dim, mlp_layers, mlp_bn, norm=norm)
        else:
            self.projection = nn.Linear(sum(dim_in), num_classes)
        self.predictors = nn.ModuleList(
            MLPHead(num_classes, num_classes, mlp_dim, depth, mlp_bn, norm=norm) for depth in predictor_depths)

    def forward(self, xs, generator: Optional[torch.Generator] = None):
        pooled = []
        for p, x in enumerate(xs):
            if self.pool_size is None or self.pool_size[p] is None:
                pooled.append(x.mean(dim=(2, 3, 4), keepdim=True))
            else:
                pooled.append(F.avg_pool3d(x, tuple(_pool_within(self.pool_size[p], x)), stride=1))
        x = torch.cat(pooled, dim=1).permute(0, 2, 3, 4, 1)  # [B, t, h, w, C]
        x = dropout(x, self.dropout_rate, self.training, generator)
        if self.detach_final_fc:
            x = x.detach()
        if self.mlp and x.shape[1:4] == (1, 1, 1):
            x = x.reshape(x.shape[0], -1)
        x = self.projection(x)
        predictions = [p(x) for p in self.predictors]
        if not self.training:
            x = _activate(x, self.act_func, allow_none=True)
            if x.dim() > 2:
                x = x.mean(dim=(1, 2, 3))
        x = x.reshape(x.shape[0], -1)
        if predictions:
            return [x] + [t.reshape(t.shape[0], -1) for t in predictions]
        return x


class X3DHead(nn.Module):
    """``conv_5`` + ``conv_5_bn`` + ReLU, average pool, ``lin_5`` (+
    ``lin_5_bn``) + ReLU, dropout, ``projection``; the activation and the
    mean over T, H, W at eval."""

    def __init__(self, dim_in, dim_inner, dim_out, num_classes, pool_size, dropout_rate=0.0, act_func="softmax",
                 bn_lin5_on=False, norm=NormSpec()):
        super().__init__()
        self.pool_size, self.dropout_rate, self.act_func = pool_size, dropout_rate, act_func
        self.conv_5 = conv3d(dim_in, dim_inner, (1, 1, 1))
        self.conv_5_bn = BatchNorm(dim_inner, norm)
        self.lin_5 = conv3d(dim_inner, dim_out, (1, 1, 1))
        self.lin_5_bn = BatchNorm(dim_out, norm) if bn_lin5_on else None
        self.projection = nn.Linear(dim_out, num_classes)

    def forward(self, xs, generator: Optional[torch.Generator] = None):
        x = F.relu(self.conv_5_bn(self.conv_5(xs[0])))
        if self.pool_size is None:
            x = x.mean(dim=(2, 3, 4), keepdim=True)
        else:
            x = F.avg_pool3d(x, tuple(self.pool_size), stride=1)
        x = self.lin_5(x)
        if self.lin_5_bn is not None:
            x = self.lin_5_bn(x)
        x = F.relu(x).permute(0, 2, 3, 4, 1)
        x = self.projection(dropout(x, self.dropout_rate, self.training, generator))
        if not self.training:
            x = _activate(x, self.act_func, allow_none=False).mean(dim=(1, 2, 3))
        return x.reshape(x.shape[0], -1)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default Dense kernel init (``lecun_normal``): a normal over
    fan-in truncated at two deviations, its deviation corrected for the cut."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


def mlp_head_linears(module: nn.Module) -> list:
    """The linear layers of every ``MLPHead`` in ``module``."""
    return [m for head in module.modules() if isinstance(head, MLPHead)
            for m in head.modules() if isinstance(m, nn.Linear)]


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator, fc_init_std: float) -> None:
    """``vtm``'s initialisers, drawn from ``generator``: convs
    Kaiming-normal over fan-out with the ReLU gain, the projection
    normal(``fc_init_std``), biases 0, BN weight 1 (0 where the block's
    final BN starts at zero), running mean 0 and variance 1; an
    ``MLPHead``'s layers keep flax's Dense default, lecun-normal with zero
    biases."""
    mlp = {id(m) for m in mlp_head_linears(module)}
    for m in module.modules():
        if isinstance(m, nn.Conv3d):
            nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu", generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Linear):
            if id(m) in mlp:
                lecun_normal_(m.weight, generator)
            else:
                nn.init.normal_(m.weight, std=fc_init_std, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
