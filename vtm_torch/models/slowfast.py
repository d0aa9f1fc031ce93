"""The PySlowFast model families, SlowFast, ResNet (C2D, I3D, Slow) and
X3D, in PyTorch: port of ``vtm/models/slowfast.py``.

Input is the clip [B, T, H, W, C] (or a list of per-pathway clips); a
single clip fed to SlowFast is packed into [slow, fast] with ``vtm``'s
``pack_pathway_output`` indices. The models return (output, None): logits
in training mode, the head's activation averaged over what is left of
T, H, W in eval mode. They do not merge tokens (``MergePolicy()``, as in
``vtm``). Weights are drawn in fp32 from a ``torch.Generator`` seeded with
``RNG_SEED``; the models compute in fp32 whatever ``TPU.COMPUTE_DTYPE``
says, as ``vtm``'s do, and keep their conv weights in ``channels_last_3d``
memory. Dropout and drop-connect draw from the forward's ``generator``.

Under ``DETECTION.ENABLE`` SlowFast and ResNet build the AVA ROI head
(``models/roi_head.py``) as ``head`` in place of the basic head, and
``forward(x, bboxes=...)`` takes the [N, 5] boxes (batch index, x1, y1, x2,
y2 in input pixels) and returns one row a box. Called without boxes such a
model raises ValueError, where ``vtm``'s falls through to its basic head on
the ROI projection's weights. X3D has no detection head (``build_model``
raises TypeError, as ``vtm``'s build does).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from vtm_torch.merge.policy import MergePolicy
from vtm_torch.models.roi_head import ResNetRoIHead
from vtm_torch.models.convnet import (
    FuseFastToSlow,
    NormSpec,
    ResNetBasicHead,
    ResStage,
    VideoModelStem,
    X3DHead,
    at_least_fp32,
    init_weights,
    max_pool3d,
    round_width,
)

# vtm/models/slowfast.py:36-59 (upstream video_model_builder.py:38-110)
_MODEL_STAGE_DEPTH = {18: (2, 2, 2, 2), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}

_TEMPORAL_KERNEL_BASIS = {
    "2d": [[[1]], [[1]], [[1]], [[1]], [[1]]],
    "c2d": [[[1]], [[1]], [[1]], [[1]], [[1]]],
    "slow_c2d": [[[1]], [[1]], [[1]], [[1]], [[1]]],
    "i3d": [[[5]], [[3]], [[3, 1]], [[3, 1]], [[1, 3]]],
    "slow_i3d": [[[5]], [[3]], [[3, 1]], [[3, 1]], [[1, 3]]],
    "slow": [[[1]], [[1]], [[1]], [[3]], [[3]]],
    "slowfast": [[[1], [5]], [[1], [3]], [[1], [3]], [[3], [3]], [[3], [3]]],
    "x3d": [[[5]], [[3]], [[3]], [[3]], [[3]]],
}

_POOL1 = {
    "2d": [[1, 1, 1]],
    "c2d": [[2, 1, 1]],
    "slow_c2d": [[1, 1, 1]],
    "i3d": [[2, 1, 1]],
    "slow_i3d": [[1, 1, 1]],
    "slow": [[1, 1, 1]],
    "slowfast": [[1, 1, 1], [1, 1, 1]],
    "x3d": [[1, 1, 1]],
}


RGB = 3  # the clips' channels (vtm's stems take whatever the clip has: RGB)


def _t(x):
    """Deep list -> tuple."""
    if isinstance(x, (list, tuple)):
        return tuple(_t(v) for v in x)
    return x


def slow_indices(t: int, alpha: int) -> np.ndarray:
    """The slow pathway's frames of a T-frame clip: ``vtm``'s
    ``jnp.linspace(0, t - 1, t // alpha).astype(int32)``, in its float32
    arithmetic (start (1 - s) + stop s with s = i / (n - 1), then the
    endpoint), truncated."""
    n = t // alpha
    stop = np.float32(t - 1)
    if n <= 1:
        return np.zeros(n, np.int64)
    step = np.arange(n - 1, dtype=np.float32) / np.float32(n - 1)
    out = np.float32(0.0) * (np.float32(1.0) - step) + stop * step
    return np.concatenate([out, [stop]]).astype(np.float32).astype(np.int32).astype(np.int64)


def pack_pathway_output(frames: torch.Tensor, alpha: int) -> list:
    """[B, T, ...] -> [slow, fast]: fast is the clip, slow its
    ``slow_indices`` frames (``vtm/models/slowfast.py:69-75``)."""
    idx = torch.as_tensor(slow_indices(frames.shape[1], alpha), device=frames.device)
    return [frames.index_select(1, idx), frames]


@dataclasses.dataclass(frozen=True)
class ConvNetSpec:
    """SlowFast / ResNet arch parameters from the config (``spec_from_cfg``)."""

    arch: str
    depth: int
    num_groups: int
    width_per_group: int
    trans_func: str
    stride_1x1: bool
    num_block_temp_kernel: Tuple
    spatial_strides: Tuple
    spatial_dilations: Tuple
    nonlocal_location: Tuple
    nonlocal_group: Tuple
    nonlocal_pool: Tuple
    nonlocal_instantiation: str
    num_classes: Union[int, Tuple[int, ...]]
    dropout_rate: float
    head_act: str
    detach_final_fc: bool
    fc_init_std: float
    num_frames: int
    crop_size: int
    alpha: int = 8
    beta_inv: int = 8
    fusion_conv_channel_ratio: int = 2
    fusion_kernel_sz: int = 7
    norm: NormSpec = NormSpec()
    global_head_pool: bool = False  # MULTIGRID.SHORT_CYCLE: a global average in the head
    mlp_layers: int = 1  # the contrastive family's SSL head (CONTRASTIVE.*)
    predictor_depths: Tuple[int, ...] = ()
    mlp_dim: int = 2048
    mlp_bn: bool = False
    detection: bool = False  # DETECTION.ENABLE: the ROI head in place of the basic head
    roi_resolution: int = 7
    roi_scale_factor: int = 16
    roi_aligned: bool = True
    multi_head = False  # one head (not a field: no config sets another)


def _norm_spec(cfg) -> NormSpec:
    return NormSpec(
        zero_init_final=cfg.RESNET.ZERO_INIT_FINAL_BN,
        num_splits=cfg.BN.NUM_SPLITS if cfg.BN.NORM_TYPE == "sub_batchnorm" else 1,
        frozen=cfg.MODEL.FROZEN_BN,
    )


def spec_from_cfg(cfg) -> ConvNetSpec:
    return ConvNetSpec(
        arch=cfg.MODEL.ARCH,
        depth=cfg.RESNET.DEPTH,
        num_groups=cfg.RESNET.NUM_GROUPS,
        width_per_group=cfg.RESNET.WIDTH_PER_GROUP,
        trans_func=cfg.RESNET.TRANS_FUNC,
        stride_1x1=cfg.RESNET.STRIDE_1X1,
        num_block_temp_kernel=_t(cfg.RESNET.NUM_BLOCK_TEMP_KERNEL),
        spatial_strides=_t(cfg.RESNET.SPATIAL_STRIDES),
        spatial_dilations=_t(cfg.RESNET.SPATIAL_DILATIONS),
        nonlocal_location=_t(cfg.NONLOCAL.LOCATION),
        nonlocal_group=_t(cfg.NONLOCAL.GROUP),
        nonlocal_pool=_t(cfg.NONLOCAL.POOL),
        nonlocal_instantiation=cfg.NONLOCAL.INSTANTIATION,
        num_classes=cfg.MODEL.NUM_CLASSES,
        dropout_rate=cfg.MODEL.DROPOUT_RATE,
        head_act=cfg.MODEL.HEAD_ACT,
        detach_final_fc=cfg.MODEL.DETACH_FINAL_FC,
        fc_init_std=cfg.MODEL.FC_INIT_STD,
        num_frames=cfg.DATA.NUM_FRAMES,
        crop_size=cfg.DATA.TRAIN_CROP_SIZE,
        alpha=cfg.SLOWFAST.ALPHA,
        beta_inv=cfg.SLOWFAST.BETA_INV,
        fusion_conv_channel_ratio=cfg.SLOWFAST.FUSION_CONV_CHANNEL_RATIO,
        fusion_kernel_sz=cfg.SLOWFAST.FUSION_KERNEL_SZ,
        norm=_norm_spec(cfg),
        global_head_pool=cfg.MULTIGRID.SHORT_CYCLE,
        mlp_layers=cfg.CONTRASTIVE.NUM_MLP_LAYERS,
        predictor_depths=_t(cfg.CONTRASTIVE.PREDICTOR_DEPTHS),
        mlp_dim=cfg.CONTRASTIVE.MLP_DIM,
        mlp_bn=cfg.CONTRASTIVE.BN_MLP,
        detection=cfg.DETECTION.ENABLE,
        roi_resolution=cfg.DETECTION.ROI_XFORM_RESOLUTION,
        roi_scale_factor=cfg.DETECTION.SPATIAL_SCALE_FACTOR,
        roi_aligned=cfg.DETECTION.ALIGNED,
    )


def _as_pathway_list(x, num_pathways: int, alpha: int) -> list:
    if isinstance(x, (list, tuple)):
        if len(x) != num_pathways:
            raise ValueError(f"{len(x)} pathways given, {num_pathways} expected")
        return list(x)
    if num_pathways == 2:
        return pack_pathway_output(x, alpha)
    return [x]


def _channels_first(xs) -> list:
    """[B, T, H, W, C] -> [B, C, T, H, W] views (channels_last_3d memory),
    in fp32 (fp64 stays fp64)."""
    return [x.to(at_least_fp32(x.dtype)).permute(0, 4, 1, 2, 3) for x in xs]


class _ConvNet(nn.Module):
    """What the three families share: no merging, fp32, channels_last_3d,
    the seeded init, and ``forward(x, state=None, generator=None,
    bboxes=None)`` (the boxes for a detection model, whose ``head`` is the
    ROI head; the module docstring). Nothing
    is cut for tensor parallelism (``parallel/sharding.py``): ``vtm``'s name
    rules name none of their matrices (only X3D's SE ``fc1`` bias, whose cut
    storage changes no arithmetic there), so at a model width above 1 every
    rank of a model group holds the whole model."""

    replicated_over_model = True
    detection = False  # built with the ROI head (DETECTION.ENABLE)

    def _finish(self, seed: int, fc_init_std: float) -> None:
        init_weights(self, torch.Generator().manual_seed(seed), fc_init_std)
        self.to(memory_format=torch.channels_last_3d)

    def _head(self, dims, pool, s: ConvNetSpec) -> nn.Module:
        """The ROI head under ``s.detection``, else the basic head."""
        if s.detection:
            self.detection = True
            return ResNetRoIHead(dims, s.num_classes, (s.roi_resolution,) * len(dims),
                                 (s.roi_scale_factor,) * len(dims), s.dropout_rate, s.head_act, s.roi_aligned,
                                 s.detach_final_fc)
        return ResNetBasicHead(dims, s.num_classes, pool, s.dropout_rate, s.head_act, s.detach_final_fc,
                               s.mlp_layers, s.predictor_depths, s.mlp_dim, s.mlp_bn, s.norm)

    def forward(self, x, state=None, generator: Optional[torch.Generator] = None, bboxes=None):
        if self.detection:
            if bboxes is None:
                raise ValueError("a detection model (DETECTION.ENABLE) takes the boxes: forward(x, bboxes=...)")
            return self.head(self.body(x, generator), bboxes, generator), state
        return self.head(self.body(x, generator), generator), state


class SlowFastModel(_ConvNet):
    """Two-pathway SlowFast (``s1`` stems, ``s{i}_fuse`` lateral
    connections, ``s2``-``s5`` stages, ``head``)."""

    takes_boxes = True  # DETECTION.ENABLE builds the ROI head

    def __init__(self, spec: ConvNetSpec, seed: int = 0):
        super().__init__()
        s = self.config = spec
        self.spec = spec
        pool = self.pool_size = _POOL1[s.arch]
        d2, d3, d4, d5 = _MODEL_STAGE_DEPTH[s.depth]
        wpg, b = s.width_per_group, s.beta_inv
        dim_inner = s.num_groups * wpg
        ratio = s.beta_inv // s.fusion_conv_channel_ratio
        tk = _TEMPORAL_KERNEL_BASIS[s.arch]
        norm = s.norm
        self.s1 = VideoModelStem((RGB, RGB), (wpg, wpg // b), (tuple(tk[0][0]) + (7, 7), tuple(tk[0][1]) + (7, 7)),
                                 ((1, 2, 2),) * 2, ((tk[0][0][0] // 2, 3, 3), (tk[0][1][0] // 2, 3, 3)), norm=norm)
        self.s1_fuse = FuseFastToSlow(wpg // b, s.fusion_conv_channel_ratio, s.fusion_kernel_sz, s.alpha, norm)
        widths = (4, 8, 16, 32)
        dims_in = [(wpg + wpg // ratio, wpg // b)] + [
            (wpg * w + wpg * w // ratio, wpg * w // b) for w in widths[:3]]
        for i, (w, n) in enumerate(zip(widths, (d2, d3, d4, d5))):
            self.add_module(f"s{i + 2}", ResStage(
                dim_in=dims_in[i], dim_out=(wpg * w, wpg * w // b),
                stride=s.spatial_strides[i], temp_kernel_sizes=_t(tk[i + 1]), num_blocks=(n,) * 2,
                dim_inner=(dim_inner * w // 4, dim_inner * w // 4 // b), num_groups=(s.num_groups,) * 2,
                num_block_temp_kernel=s.num_block_temp_kernel[i], nonlocal_inds=s.nonlocal_location[i],
                nonlocal_group=s.nonlocal_group[i], nonlocal_pool=s.nonlocal_pool[i],
                dilation=s.spatial_dilations[i], instantiation=s.nonlocal_instantiation,
                trans_func_name=s.trans_func, stride_1x1=s.stride_1x1, norm=norm))
            if i < 3:
                self.add_module(f"s{i + 2}_fuse", FuseFastToSlow(
                    wpg * w // b, s.fusion_conv_channel_ratio, s.fusion_kernel_sz, s.alpha, norm))
        head_pool = None if s.global_head_pool else (
            (s.num_frames // s.alpha // pool[0][0], s.crop_size // 32 // pool[0][1], s.crop_size // 32 // pool[0][2]),
            (s.num_frames // pool[1][0], s.crop_size // 32 // pool[1][1], s.crop_size // 32 // pool[1][2]),
        )
        self.head = self._head((wpg * 32, wpg * 32 // b), head_pool, s)
        self._finish(seed, s.fc_init_std)

    def body(self, x, generator=None):
        xs = _channels_first(_as_pathway_list(x, 2, self.spec.alpha))
        xs = self.s1_fuse(self.s1(xs))
        xs = self.s2_fuse(self.s2(xs, generator))
        xs = [max_pool3d(xp, self.pool_size[p], self.pool_size[p]) for p, xp in enumerate(xs)]
        xs = self.s3_fuse(self.s3(xs, generator))
        xs = self.s4_fuse(self.s4(xs, generator))
        return self.s5(xs, generator)


class ResNetModel(_ConvNet):
    """One-pathway C2D / I3D / Slow ResNet (``s1``, ``s2``-``s5``, ``head``)."""

    takes_boxes = True  # DETECTION.ENABLE builds the ROI head

    def __init__(self, spec: ConvNetSpec, seed: int = 0):
        super().__init__()
        s = self.config = spec
        self.spec = spec
        pool = self.pool_size = _POOL1[s.arch]
        wpg = s.width_per_group
        dim_inner = s.num_groups * wpg
        tk = _TEMPORAL_KERNEL_BASIS[s.arch]
        norm = s.norm
        self.s1 = VideoModelStem((RGB,), (wpg,), (tuple(tk[0][0]) + (7, 7),), ((1, 2, 2),),
                                 ((tk[0][0][0] // 2, 3, 3),), norm=norm)
        dims = [(wpg, wpg * 4, dim_inner), (wpg * 4, wpg * 8, dim_inner * 2), (wpg * 8, wpg * 16, dim_inner * 4),
                (wpg * 16, wpg * 32, dim_inner * 8)]
        for i, ((din, dout, dinner), n) in enumerate(zip(dims, _MODEL_STAGE_DEPTH[s.depth])):
            self.add_module(f"s{i + 2}", ResStage(
                dim_in=(din,), dim_out=(dout,), stride=s.spatial_strides[i], temp_kernel_sizes=_t(tk[i + 1]),
                num_blocks=(n,), dim_inner=(dinner,), num_groups=(s.num_groups,),
                num_block_temp_kernel=s.num_block_temp_kernel[i], nonlocal_inds=s.nonlocal_location[i],
                nonlocal_group=s.nonlocal_group[i], nonlocal_pool=s.nonlocal_pool[i],
                dilation=s.spatial_dilations[i], instantiation=s.nonlocal_instantiation,
                trans_func_name=s.trans_func, stride_1x1=s.stride_1x1, norm=norm))
        head_pool = None if s.global_head_pool else (
            (s.num_frames // pool[0][0], s.crop_size // 32 // pool[0][1], s.crop_size // 32 // pool[0][2]),)
        self.head = self._head((wpg * 32,), head_pool, s)
        self._finish(seed, s.fc_init_std)

    def body(self, x, generator=None):
        xs = self.s2(self.s1(_channels_first(_as_pathway_list(x, 1, 1))), generator)
        xs = [max_pool3d(xp, self.pool_size[p], self.pool_size[p]) for p, xp in enumerate(xs)]
        for i in (3, 4, 5):
            xs = getattr(self, f"s{i}")(xs, generator)
        return xs


@dataclasses.dataclass(frozen=True)
class X3DSpec:
    """X3D arch parameters from the config (``x3d_spec_from_cfg``)."""

    depth: int
    num_groups: int
    width_per_group: int
    trans_func: str
    stride_1x1: bool
    spatial_dilations: Tuple
    nonlocal_location: Tuple
    nonlocal_group: Tuple
    nonlocal_pool: Tuple
    nonlocal_instantiation: str
    num_classes: Union[int, Tuple[int, ...]]
    dropout_rate: float
    head_act: str
    fc_init_std: float
    num_frames: int
    crop_size: int
    width_factor: float
    depth_factor: float
    bottleneck_factor: float
    dim_c1: int
    dim_c5: int
    scale_res2: bool
    channelwise_3x3x3: bool
    bn_lin5: bool
    dropconnect_rate: float
    norm: NormSpec = NormSpec()
    multi_head = False


def x3d_spec_from_cfg(cfg) -> X3DSpec:
    return X3DSpec(
        depth=cfg.RESNET.DEPTH,
        num_groups=cfg.RESNET.NUM_GROUPS,
        width_per_group=cfg.RESNET.WIDTH_PER_GROUP,
        trans_func=cfg.RESNET.TRANS_FUNC,
        stride_1x1=cfg.RESNET.STRIDE_1X1,
        spatial_dilations=_t(cfg.RESNET.SPATIAL_DILATIONS),
        nonlocal_location=_t(cfg.NONLOCAL.LOCATION),
        nonlocal_group=_t(cfg.NONLOCAL.GROUP),
        nonlocal_pool=_t(cfg.NONLOCAL.POOL),
        nonlocal_instantiation=cfg.NONLOCAL.INSTANTIATION,
        num_classes=cfg.MODEL.NUM_CLASSES,
        dropout_rate=cfg.MODEL.DROPOUT_RATE,
        head_act=cfg.MODEL.HEAD_ACT,
        fc_init_std=cfg.MODEL.FC_INIT_STD,
        num_frames=cfg.DATA.NUM_FRAMES,
        crop_size=cfg.DATA.TRAIN_CROP_SIZE,
        width_factor=cfg.X3D.WIDTH_FACTOR,
        depth_factor=cfg.X3D.DEPTH_FACTOR,
        bottleneck_factor=cfg.X3D.BOTTLENECK_FACTOR,
        dim_c1=cfg.X3D.DIM_C1,
        dim_c5=cfg.X3D.DIM_C5,
        scale_res2=cfg.X3D.SCALE_RES2,
        channelwise_3x3x3=cfg.X3D.CHANNELWISE_3x3x3,
        bn_lin5=cfg.X3D.BN_LIN5,
        dropconnect_rate=cfg.MODEL.DROPCONNECT_RATE,
        norm=_norm_spec(cfg),
    )


class X3DModel(_ConvNet):
    """X3D (``s1`` stem, ``s2``-``s5``, ``head``)."""

    def __init__(self, spec: X3DSpec, seed: int = 0):
        super().__init__()
        s = self.config = spec
        self.spec = spec
        tk = _TEMPORAL_KERNEL_BASIS["x3d"]
        norm = s.norm
        dim_res2 = round_width(s.dim_c1, 2.0, divisor=8) if s.scale_res2 else s.dim_c1
        dim_res3 = round_width(dim_res2, 2.0, divisor=8)
        dim_res4 = round_width(dim_res3, 2.0, divisor=8)
        dim_res5 = round_width(dim_res4, 2.0, divisor=8)
        blocks = ((1, dim_res2, 2), (2, dim_res3, 2), (5, dim_res4, 2), (3, dim_res5, 2))
        dim_res1 = round_width(s.dim_c1, s.width_factor)
        self.s1 = VideoModelStem((RGB,), (dim_res1,), (tuple(tk[0][0]) + (3, 3),), ((1, 2, 2),),
                                 ((tk[0][0][0] // 2, 1, 1),), stem_func_name="x3d_stem", norm=norm)
        dim_in = dim_inner = dim_res1
        for stage, (reps, width, stride) in enumerate(blocks):
            dim_out = round_width(width, s.width_factor)
            dim_inner = int(s.bottleneck_factor * dim_out)
            n = int(math.ceil(s.depth_factor * reps)) if s.depth_factor else reps
            self.add_module(f"s{stage + 2}", ResStage(
                dim_in=(dim_in,), dim_out=(dim_out,), stride=(stride,), temp_kernel_sizes=_t(tk[1]),
                num_blocks=(n,), dim_inner=(dim_inner,),
                num_groups=(dim_inner,) if s.channelwise_3x3x3 else (s.num_groups,),
                num_block_temp_kernel=(n,), nonlocal_inds=s.nonlocal_location[0],
                nonlocal_group=s.nonlocal_group[0], nonlocal_pool=s.nonlocal_pool[0],
                dilation=s.spatial_dilations[stage], instantiation=s.nonlocal_instantiation,
                trans_func_name=s.trans_func, stride_1x1=s.stride_1x1,
                drop_connect_rate=s.dropconnect_rate * (stage + 2) / (len(blocks) + 1), norm=norm))
            dim_in = dim_out
        spat = int(math.ceil(s.crop_size / 32.0))
        self.head = X3DHead(dim_in, dim_inner, s.dim_c5, s.num_classes, (s.num_frames, spat, spat),
                            s.dropout_rate, s.head_act, s.bn_lin5, norm)
        self._finish(seed, s.fc_init_std)

    def body(self, x, generator=None):
        xs = self.s1(_channels_first(_as_pathway_list(x, 1, 1)))
        for i in (2, 3, 4, 5):
            xs = getattr(self, f"s{i}")(xs, generator)
        return xs


from vtm_torch.models.build import ModelBundle, register_model  # noqa: E402


def _bundle(module: nn.Module, name: str) -> ModelBundle:
    return ModelBundle(module=module, policy=MergePolicy(), name=name)


@register_model("SlowFast", SlowFastModel)
def _build_slowfast(cfg, fp32_params: bool = False) -> ModelBundle:
    return _bundle(SlowFastModel(spec_from_cfg(cfg), seed=cfg.RNG_SEED), "SlowFast")


@register_model("ResNet", ResNetModel)
def _build_resnet(cfg, fp32_params: bool = False) -> ModelBundle:
    return _bundle(ResNetModel(spec_from_cfg(cfg), seed=cfg.RNG_SEED), "ResNet")


@register_model("X3D", X3DModel)
def _build_x3d(cfg, fp32_params: bool = False) -> ModelBundle:
    return _bundle(X3DModel(x3d_spec_from_cfg(cfg), seed=cfg.RNG_SEED), "X3D")
