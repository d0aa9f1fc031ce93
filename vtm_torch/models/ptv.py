"""The PTV conv families, CSN and R(2+1)D, and the PTV* registry names, in
PyTorch: port of ``vtm/models/ptv.py``.

ir-CSN (Tran et al. 2019) and R(2+1)D (Tran et al. 2018) on ResNet
bottlenecks, with the architecture ``vtm`` gives them (stem and stage
kernels and strides, head pool kernels). Unlike SlowFast, ResNet and X3D,
every BatchNorm here takes ``BN.NUM_SPLITS`` under ``BN.NORM_TYPE
sub_batchnorm`` (``NormSpec.num_splits``), as in ``vtm``: the statistics
are kept per contiguous sub-batch of B / k rows, and a batch that k does not
divide raises.

Modules carry ``vtm``'s parameter names (``stem_conv``, ``stem_bn``,
``s2.res_0.branch1`` / ``branch1_bn``, ``s2.res_0.branch2.conv_a``,
``conv_b`` or ``conv_b_xy`` / ``conv_b_t``, ``conv_c``, ``head.projection``),
so ``checkpoints/convert.py::ptv_state_dict_from_vtm_params`` is a rename of
leaves and a layout change. Clips arrive as [B, T, H, W, C] and run in
fp32 (fp64 when given it) in ``channels_last_3d`` memory, as the other conv
families do. CSN's depthwise 3x3x3 ``conv_b`` (``groups`` = its width) is a
cuDNN convolution, as ``vtm``'s is an XLA one.

``PTVX3D``, ``PTVSlowFast``, ``PTVResNet`` and ``PTVMViT`` build the
port's native models under the PTV name, as in ``vtm``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch.nn.functional as F
from torch import nn

from vtm_torch.merge.policy import MergePolicy
from vtm_torch.models.convnet import BatchNorm, NormSpec, ResNetBasicHead, conv3d, max_pool3d
from vtm_torch.models.slowfast import (
    RGB,
    _ConvNet,
    _MODEL_STAGE_DEPTH,
    _as_pathway_list,
    _channels_first,
    _norm_spec,
)

# vtm/models/ptv.py:43-45: CSN takes the deeper table entry too
_STAGE_DEPTH = dict(_MODEL_STAGE_DEPTH)
_STAGE_DEPTH[152] = (3, 8, 36, 3)
FC_INIT_STD = 0.01  # vtm's PTV heads keep ResNetBasicHead's default, whatever MODEL.FC_INIT_STD says


@dataclasses.dataclass(frozen=True)
class PTVSpec:
    """The two PTV families' arch parameters (``ptv_spec_from_cfg``)."""

    depth: int
    width_per_group: int
    num_classes: int
    dropout_rate: float
    head_act: str
    num_frames: int
    crop_size: int
    norm: NormSpec
    multi_head = False


def ptv_spec_from_cfg(cfg) -> PTVSpec:
    return PTVSpec(
        depth=cfg.RESNET.DEPTH,
        width_per_group=cfg.RESNET.WIDTH_PER_GROUP,
        num_classes=cfg.MODEL.NUM_CLASSES,
        dropout_rate=cfg.MODEL.DROPOUT_RATE,
        head_act=cfg.MODEL.HEAD_ACT,
        num_frames=cfg.DATA.NUM_FRAMES,
        crop_size=cfg.DATA.TRAIN_CROP_SIZE,
        norm=_norm_spec(cfg),
    )


class _PTVBottleneck(nn.Module):
    """1x1x1 ``conv_a`` -> ``conv_b`` -> 1x1x1 ``conv_c``, each followed by a
    BatchNorm, ReLU after the first two; the stride rides ``conv_b``. Style
    ``csn``: ``conv_b`` is a depthwise 3x3x3. Style ``r2plus1d``: a spatial
    1x3x3 ``conv_b_xy`` (stride 1, s, s), BN, ReLU, then a temporal 3x1x1
    ``conv_b_t`` (stride t, 1, 1), both at width ``dim_inner``."""

    def __init__(self, dim_in: int, dim_inner: int, dim_out: int, stride: Tuple[int, int], style: str,
                 norm: NormSpec):
        super().__init__()
        t, s = stride
        k = norm.num_splits
        self.style = style
        self.conv_a = conv3d(dim_in, dim_inner, (1, 1, 1))
        self.conv_a_bn = BatchNorm(dim_inner, norm, num_splits=k)
        if style == "csn":
            self.conv_b = conv3d(dim_inner, dim_inner, (3, 3, 3), (t, s, s), groups=dim_inner)
        elif style == "r2plus1d":
            self.conv_b_xy = conv3d(dim_inner, dim_inner, (1, 3, 3), (1, s, s))
            self.conv_b_xy_bn = BatchNorm(dim_inner, norm, num_splits=k)
            self.conv_b_t = conv3d(dim_inner, dim_inner, (3, 1, 1), (t, 1, 1))
        else:
            raise ValueError(style)
        self.conv_b_bn = BatchNorm(dim_inner, norm, num_splits=k)
        self.conv_c = conv3d(dim_inner, dim_out, (1, 1, 1))
        self.conv_c_bn = BatchNorm(dim_out, norm, zero_init=norm.zero_init_final, num_splits=k)

    def forward(self, x):
        x = F.relu(self.conv_a_bn(self.conv_a(x)))
        if self.style == "csn":
            x = self.conv_b(x)
        else:
            x = self.conv_b_t(F.relu(self.conv_b_xy_bn(self.conv_b_xy(x))))
        x = F.relu(self.conv_b_bn(x))
        return self.conv_c_bn(self.conv_c(x))


class _PTVResBlock(nn.Module):
    """``branch2`` (the bottleneck) plus the input, or its ``branch1`` /
    ``branch1_bn`` projection where the width or the stride changes."""

    def __init__(self, dim_in: int, dim_inner: int, dim_out: int, stride: Tuple[int, int], style: str,
                 norm: NormSpec):
        super().__init__()
        t, s = stride
        self.project = dim_in != dim_out or t != 1 or s != 1
        if self.project:
            self.branch1 = conv3d(dim_in, dim_out, (1, 1, 1), (t, s, s))
            self.branch1_bn = BatchNorm(dim_out, norm, num_splits=norm.num_splits)
        self.branch2 = _PTVBottleneck(dim_in, dim_inner, dim_out, stride, style, norm)

    def forward(self, x):
        sc = self.branch1_bn(self.branch1(x)) if self.project else x
        return F.relu(sc + self.branch2(x))


class _PTVStage(nn.Module):
    """``res_0`` .. ``res_{n-1}``; block 0 carries the stride."""

    def __init__(self, num_blocks: int, dim_in: int, dim_inner: int, dim_out: int, stride: Tuple[int, int],
                 style: str, norm: NormSpec):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"res_{i}", _PTVResBlock(dim_in if i == 0 else dim_out, dim_inner, dim_out,
                                                     stride if i == 0 else (1, 1), style, norm))

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, f"res_{i}")(x)
        return x


class _PTVModel(_ConvNet):
    """What the two families share: the stem (``stem_kernel`` / (1, 2, 2),
    BN, ReLU, then a (1, 3, 3) / (1, 2, 2) max pool where ``stem_pool``),
    ``s2``-``s5`` on bottlenecks of width ``w * 2**i`` (inner) and ``w * 4 *
    2**i`` (out) with ``strides[i]`` = (temporal, spatial), and the head,
    whose average pool is (T // ``t_div``, crop // 32, crop // 32) of
    ``DATA.TRAIN_CROP_SIZE``."""

    style, t_div, stem_kernel, stem_pool, strides = "", 1, (1, 7, 7), False, ()

    def __init__(self, spec: PTVSpec, seed: int = 0):
        super().__init__()
        s = self.config = self.spec = spec
        w, k = s.width_per_group, s.norm.num_splits
        self.stem_conv = conv3d(RGB, w, self.stem_kernel, (1, 2, 2))
        self.stem_bn = BatchNorm(w, s.norm, num_splits=k)
        dim_in = w
        for i, n in enumerate(_STAGE_DEPTH[s.depth]):
            self.add_module(f"s{i + 2}", _PTVStage(n, dim_in, w * 2**i, w * 4 * 2**i, self.strides[i], self.style,
                                                   s.norm))
            dim_in = w * 4 * 2**i
        pool = ((s.num_frames // self.t_div, s.crop_size // 32, s.crop_size // 32),)
        self.head = ResNetBasicHead((dim_in,), s.num_classes, pool, s.dropout_rate, s.head_act)
        self._finish(seed, FC_INIT_STD)

    def body(self, x, generator=None):
        x = F.relu(self.stem_bn(self.stem_conv(_channels_first(_as_pathway_list(x, 1, 1))[0])))
        if self.stem_pool:
            x = max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        for i in (2, 3, 4, 5):
            x = getattr(self, f"s{i}")(x)
        return [x]


class CSNModel(_PTVModel):
    """ir-CSN: stem (3, 7, 7) with the max pool; depthwise ``conv_b``;
    strides (1, 2, 2, 2) in time and space; head pool T // 8."""

    style, t_div, stem_kernel, stem_pool = "csn", 8, (3, 7, 7), True
    strides = ((1, 1), (2, 2), (2, 2), (2, 2))


class R2Plus1DModel(_PTVModel):
    """R(2+1)D: stem (1, 7, 7), no pool; factorised ``conv_b``; spatial
    stride 2 in every stage, temporal strides (1, 1, 2, 2); head pool T // 4."""

    style, t_div, stem_kernel, stem_pool = "r2plus1d", 4, (1, 7, 7), False
    strides = ((1, 2), (1, 2), (2, 2), (2, 2))


# ---------------------------------------------------------------------------
# registry

from vtm_torch.models.build import MODEL_CLASSES, MODEL_REGISTRY, ModelBundle, register_model  # noqa: E402


def _refuse_detection(cfg, name: str) -> None:
    if cfg.DETECTION.ENABLE:
        raise NotImplementedError(f"Detection model is not supported for {name} yet.")


@register_model("PTVCSN", CSNModel)
def _build_csn(cfg, fp32_params: bool = False) -> ModelBundle:
    _refuse_detection(cfg, "PTVCSN")
    return ModelBundle(module=CSNModel(ptv_spec_from_cfg(cfg), seed=cfg.RNG_SEED), policy=MergePolicy(),
                       name="PTVCSN")


@register_model("PTVR2plus1D", R2Plus1DModel)
def _build_r2plus1d(cfg, fp32_params: bool = False) -> ModelBundle:
    _refuse_detection(cfg, "PTVR2plus1D")
    return ModelBundle(module=R2Plus1DModel(ptv_spec_from_cfg(cfg), seed=cfg.RNG_SEED), policy=MergePolicy(),
                       name="PTVR2plus1D")


def _alias(ptv_name: str, native_name: str) -> None:
    """``ptv_name`` builds the port's ``native_name`` model under the PTV name."""

    @register_model(ptv_name, MODEL_CLASSES[native_name])
    def _build(cfg, fp32_params: bool = False) -> ModelBundle:
        return dataclasses.replace(MODEL_REGISTRY[native_name](cfg, fp32_params), name=ptv_name)


_alias("PTVX3D", "X3D")
_alias("PTVSlowFast", "SlowFast")
_alias("PTVResNet", "ResNet")
_alias("PTVMViT", "MViT")
