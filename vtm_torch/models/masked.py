"""Masked video pretraining for MViT in PyTorch: port of ``vtm/models/masked.py``.

Two families, both built as ``MODEL.MODEL_NAME MaskMViT``:

- MaskFeat (``MaskMViT``): the loader's block mask, resized to the token
  grid, swaps tokens for a learned ``mask_token``; the MViT blocks run up to
  the deepest ``MASK.PRETRAIN_DEPTH``; a head per depth predicts HOG
  (``MASK.PRED_HOG``) or pixel targets at every position.
- MAE (``MaskMViTMAE``, ``MASK.MAE_ON``): tokens dropped by a stable argsort
  of a noise (the loader mask, or uniform noise under
  ``MASK.MAE_RND_MASK``), the encoder over the kept ones, a decoder over the
  restored grid, pixel targets made in the forward.

As in ``vtm``, the heads predict every position with static shapes and the
mask weights the loss (``train/losses.py::multiple_mse``), where upstream
PySlowFast selects the masked rows (``x[mask]``). The targets are made on the
tensor's device: ``hog_features`` bins each pixel's gradient magnitude by a
one-hot product over the bins, not a scatter, whose atomics would add fp32
in no fixed order; ``_interp_mask`` picks rows by integer index, as ``vtm``
does, where ``F.interpolate`` rounds a float scale. The MAE's noise comes
from the forward's ``torch.Generator`` (``vtm`` draws JAX's); a ``noise``
tensor given to the forward stands in for the draw.

Modules carry the upstream state-dict names (``mask_token``,
``decoder_embed``, ``decoder_pos_embed``, ``dec_pos_embed_*``, ``norm``,
``pred_head.transforms.{i}.{j}`` with the norm last, ``pred_head.projections.{i}``);
``checkpoints/convert.py::load_maskmvit_state_dict`` loads such a file.
The products stay ``torch.matmul``: no attention kernel of the package runs.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vtm_torch.merge.policy import MergePolicy
from vtm_torch.models.common import LayerNorm, Linear
from vtm_torch.models.mvit import (
    MultiScaleBlock,
    MViTSpec,
    _PatchEmbed,
    get_3d_sincos_pos_embed,
    init_mvit_weights,
    mvit_spec_from_cfg,
    trunc02_,
)

# ------------------------------------------------------------------- HOG


def hog_bins(images: torch.Tensor, nbins: int = 9):
    """Each pixel's gradient magnitude and orientation bin, [B, C, H, W]
    each: the reflect-padded 3x3 Sobel cross-correlation as nine shifted
    adds in ``vtm``'s order, the bin ``floor(atan2(gx, gy) / pi * nbins) %
    nbins``. images [B, H, W, C]. ``vtm``'s numpy fp32 atan2 is not
    correctly rounded either: where it is an ulp off on a bin's edge, the
    bins differ."""
    b, h, w, c = images.shape
    x = torch.nn.functional.pad(images.float().permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    kx = ((1, 0, -1), (2, 0, -2), (1, 0, -1))
    gx = torch.zeros((b, c, h, w), dtype=torch.float32, device=images.device)
    gy = torch.zeros_like(gx)
    for i in range(3):
        for j in range(3):
            patch = x[:, :, i:i + h, j:j + w]
            gx = gx + float(kx[i][j]) * patch
            gy = gy + float(kx[j][i]) * patch
    # sqrt and atan2 in fp64, rounded once to fp32: the correctly rounded
    # values, the same on the CPU and on the card (their fp32 versions are
    # within an ulp or two, each its own way, and an ulp moves a bin on its edge)
    norm = torch.sqrt((gx ** 2 + gy ** 2).double()).float()
    angle = torch.atan2(gx.double(), gy.double()).float()
    # the divisor as a tensor: a CUDA division by a Python scalar multiplies
    # by its reciprocal, which also moves a phase on an edge
    pi = torch.tensor(math.pi, dtype=torch.float32, device=images.device)
    phase = angle / pi * nbins
    return norm, torch.remainder(torch.floor(phase).long(), nbins)


def hog_features(images: torch.Tensor, nbins: int = 9, pool: int = 8) -> torch.Tensor:
    """Per-channel histogram-of-gradients features (``vtm``'s
    ``hog_features``, upstream ``HOGLayerC``): each pixel's magnitude put in
    its bin (``hog_bins``) by a one-hot product, summed over pool x pool
    cells, L2-normalised over the bins.
    images [B, H, W, C] -> [B, C, nbins, H / pool, W / pool], fp32."""
    b, h, w, c = images.shape
    norm, binned = hog_bins(images, nbins)
    one_hot = binned[:, :, None] == torch.arange(nbins, device=images.device).view(1, 1, nbins, 1, 1)
    out = one_hot.float() * norm[:, :, None]  # [B, C, nbins, H, W]
    hp, wp = h // pool, w // pool
    out = out[:, :, :, :hp * pool, :wp * pool]
    out = out.reshape(b, c, nbins, hp, pool, wp, pool).sum(dim=(4, 6))
    denom = torch.sqrt((out ** 2).sum(dim=2, keepdim=True))
    return out / torch.clamp(denom, min=1e-12)


def calc_mvit_feature_geometry(spec: MViTSpec):
    """Per-depth (feat_size, feat_stride) (``vtm``'s copy of upstream utils.py:200-225)."""
    feat_size = [[spec.num_frames // spec.patch_stride[0], spec.crop_size // spec.patch_stride[1],
                  spec.crop_size // spec.patch_stride[2]] for _ in range(spec.depth)]
    feat_stride = [list(spec.patch_stride) for _ in range(spec.depth)]
    for entry in spec.pool_q_stride:
        for i in range(spec.depth):
            if i >= entry[0]:
                for j in range(3):
                    feat_size[i][j] = feat_size[i][j] // entry[j + 1]
                    feat_stride[i][j] = feat_stride[i][j] * entry[j + 1]
    return feat_size, feat_stride


def maskfeat_hog_labels(spec: MViTSpec, pretrain_depth, frames: torch.Tensor, cell: int = 8, nbins: int = 9):
    """Full-grid HOG targets per depth, [B, N_d, C_hog] (``vtm``'s
    ``maskfeat_hog_labels``; upstream's unfold order). frames [B, T, H, W, C]."""
    feat_size, _ = calc_mvit_feature_geometry(spec)
    sub = frames[:, ::spec.patch_stride[0]]
    b, t = sub.shape[:2]
    hog = hog_features(sub.reshape((-1,) + tuple(sub.shape[2:])), nbins=nbins, pool=cell)
    hog = hog.reshape(b * t, 3 * nbins, hog.shape[-2], hog.shape[-1])
    labels = []
    for depth in pretrain_depth:
        fs = feat_size[depth][-1]
        unfold = hog.shape[-1] // fs
        lab = hog.permute(0, 2, 3, 1).reshape(b * t, fs, unfold, fs, unfold, hog.shape[1])
        lab = lab.permute(0, 1, 3, 5, 2, 4).reshape(b, t, fs, fs, -1)
        labels.append(lab.reshape(b, t * fs * fs, -1))
    return labels


def _interp_mask(mask: torch.Tensor, size) -> torch.Tensor:
    """Nearest resize of the trailing two dims by ``vtm``'s integer rows
    ``arange(th) * h // th``, as fp32."""
    mask = mask.float()
    h, w = mask.shape[-2:]
    th, tw = size
    if (h, w) == (th, tw):
        return mask
    yi = torch.arange(th, device=mask.device) * h // th
    xi = torch.arange(tw, device=mask.device) * w // tw
    return mask[..., yi, :][..., xi]


def _patchify_pixels(imgs, p: int, u: int):
    """[B, T, H, W, C] -> [B, t * h * w, u * p * p * C] in upstream's token
    feature order (``_patchify``: nthwupqc); torch tensors or numpy arrays."""
    b, T, H, W, c = imgs.shape
    t, h, w = T // u, H // p, W // p
    x = imgs.reshape(b, t, u, h, p, w, p, c)
    perm = (0, 1, 3, 5, 2, 4, 6, 7)
    x = x.permute(*perm) if isinstance(x, torch.Tensor) else x.transpose(perm)
    return x.reshape(b, t * h * w, u * p * p * c)


def mae_pixel_labels(frames: torch.Tensor, patch_t_stride: int, p: int, time_stride_loss: bool = True,
                     norm: bool = True) -> torch.Tensor:
    """Full-grid pixel targets (``vtm``'s ``mae_pixel_labels``), each token
    normalised by its mean and unbiased variance under ``norm``."""
    if time_stride_loss:
        imgs, u = frames[:, ::patch_t_stride], 1
    else:
        imgs, u = frames, patch_t_stride
    label = _patchify_pixels(imgs, p, u)
    if norm:
        mean = label.mean(dim=-1, keepdim=True)
        var = label.var(dim=-1, keepdim=True, correction=1)
        label = (label - mean) / (var + 1.0e-6) ** 0.5
    return label


def maskfeat_pixel_labels(spec: MViTSpec, pretrain_depth, frames: torch.Tensor, time_stride_loss: bool = True,
                          norm: bool = True):
    """Per-depth full-grid pixel targets of the MaskFeat path."""
    _, feat_stride = calc_mvit_feature_geometry(spec)
    return [mae_pixel_labels(frames, spec.patch_stride[0], feat_stride[d][-1], time_stride_loss, norm)
            for d in pretrain_depth]


def maskfeat_labels(cfg, spec: MViTSpec, frames: torch.Tensor):
    """MaskFeat's per-depth targets of ``frames`` on their device: HOG under
    ``MASK.PRED_HOG``, else pixels (``MASK.TIME_STRIDE_LOSS``,
    ``MASK.NORM_PRED_PIXEL``)."""
    if cfg.MASK.PRED_HOG:
        return maskfeat_hog_labels(spec, cfg.MASK.PRETRAIN_DEPTH, frames)
    return maskfeat_pixel_labels(spec, cfg.MASK.PRETRAIN_DEPTH, frames, cfg.MASK.TIME_STRIDE_LOSS,
                                 cfg.MASK.NORM_PRED_PIXEL)


def pixel_num_classes(spec: MViTSpec, pretrain_depth, time_stride_loss: bool = True) -> Tuple[int, ...]:
    """Prediction width per depth for pixel targets."""
    _, feat_stride = calc_mvit_feature_geometry(spec)
    pred_t_sz = 1 if time_stride_loss else spec.patch_stride[0]
    return tuple(pred_t_sz * (feat_stride[d][-1] ** 2) * 3 for d in pretrain_depth)


def hog_num_classes(spec: MViTSpec, pretrain_depth, nbins: int = 9, cell: int = 8) -> Tuple[int, ...]:
    """Prediction width per depth for HOG targets."""
    _, feat_stride = calc_mvit_feature_geometry(spec)
    return tuple(3 * nbins * (feat_stride[d][-1] // cell) ** 2 for d in pretrain_depth)


# ------------------------------------------------------------------ head


class MSSeparateHead(nn.Module):
    """Per depth: optional decoder ``MultiScaleBlock``s (``DECODER_EMBED_DIM
    // 64`` heads, KV pooling from ``MASK.DEC_KV_*``, no q pooling, relative
    positions, residual pooling or ``dim_mul_in_att``; fp32 as in ``vtm``),
    a LayerNorm (eps 1e-6; ``transforms.{i}`` holds the blocks, then the
    norm), the CLS row dropped, the projection in fp32. Predicts every
    position."""

    def __init__(self, spec: MViTSpec, num_classes: Sequence[int], head_dims: Sequence[int], feat_sizes,
                 decoder_depth: int = 0, decoder_embed_dim: int = 512, dec_kv_kernel=(), dec_kv_stride=()):
        super().__init__()
        s = spec
        self.has_cls = s.cls_embed_on
        self.transforms = nn.ModuleList()
        self.projections = nn.ModuleList()
        for idx, n_out in enumerate(num_classes):
            head_dim = head_dims[idx]
            layers = []
            for _ in range(decoder_depth):
                layers.append(MultiScaleBlock(
                    head_dim, decoder_embed_dim, decoder_embed_dim // 64, feat_sizes[idx], s.mlp_ratio, s.qkv_bias,
                    (), tuple(dec_kv_kernel), (), tuple(dec_kv_stride), s.mode, s.cls_embed_on, s.pool_first,
                    False, False, False, False, False))
                head_dim = decoder_embed_dim
            layers.append(LayerNorm(head_dim, 1e-6))
            self.transforms.append(nn.ModuleList(layers))
            self.projections.append(nn.Linear(head_dim, n_out))

    def forward(self, block_outputs, thw):
        outputs = []
        for transform, projection, x in zip(self.transforms, self.projections, block_outputs):
            for blk in transform[:-1]:
                x, thw = blk(x, thw)
            x = transform[-1](x)
            if self.has_cls:
                x = x[:, 1:]
            outputs.append(projection(x.float()))
        return outputs


# ----------------------------------------------------------------- models


def _init(module: nn.Module, seed: int, spec: MViTSpec, zero_biases: Sequence[nn.Linear]) -> None:
    """``vtm``'s initialisers: ``init_mvit_weights``, then trunc02 for the
    masked family's own tables, zero biases where ``vtm``'s Dense keeps its
    default (``decoder_embed``, the projections)."""
    generator = torch.Generator().manual_seed(seed)
    init_mvit_weights(module, generator, spec.rel_pos_zero_init)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name in ("mask_token", "decoder_pos_embed") or name.startswith("dec_pos_embed_"):
                trunc02_(p, generator)
        for layer in zero_biases:
            nn.init.zeros_(layer.bias)


def _grid_positions(spatial: torch.Tensor, temporal: torch.Tensor) -> torch.Tensor:
    """Separate tables [1, h * w, C] and [1, t, C] -> [1, t * h * w, C]."""
    return spatial.repeat(1, temporal.shape[1], 1) + temporal.repeat_interleave(spatial.shape[1], dim=1)


class MaskMViT(nn.Module):
    """MaskFeat forward (``vtm``'s ``MaskMViT``): patch embedding, mask-token
    substitution ``x * (1 - m) + mask_token * m`` on the full grid (a 2-D
    mask broadcast over time), CLS and absolute positions, ``norm_stem``,
    the blocks up to the deepest pretrain depth with drop path 0, the head.
    ``forward(x, mask)`` -> (per-depth predictions at every position,
    per-depth boolean masks at feature resolution)."""

    def __init__(self, spec: MViTSpec, pretrain_depth=(15,), pred_hog: bool = True, time_stride_loss: bool = True,
                 decoder_depth: int = 0, decoder_embed_dim: int = 512, dec_kv_kernel=(), dec_kv_stride=(),
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        s = self.config = self.spec = spec
        self.pretrain_depth = tuple(pretrain_depth)
        self.dtype = dtype
        self.patch_embed = _PatchEmbed(s.in_chans, s.embed_dim, s.patch_kernel, s.patch_stride, s.patch_padding, dtype)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, s.embed_dim))
        sp = 1 if s.cls_embed_on else 0
        if s.cls_embed_on:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, s.embed_dim))
        if s.use_abs_pos:
            p_t, p_h, p_w = s.patch_dims
            if s.sep_pos_embed:
                self.pos_embed_spatial = nn.Parameter(torch.zeros(1, p_h * p_w, s.embed_dim))
                self.pos_embed_temporal = nn.Parameter(torch.zeros(1, p_t, s.embed_dim))
                if s.cls_embed_on:
                    self.pos_embed_class = nn.Parameter(torch.zeros(1, 1, s.embed_dim))
            else:
                self.pos_embed = nn.Parameter(torch.zeros(1, p_t * p_h * p_w + sp, s.embed_dim))
        if s.norm_stem:
            self.norm_stem = LayerNorm(s.embed_dim, s.norm_eps)
        plan = s.block_plan()[:max(self.pretrain_depth) + 1]
        self.blocks = nn.ModuleList(
            MultiScaleBlock(blk["dim"], blk["dim_out"], blk["num_heads"], blk["input_size"], s.mlp_ratio, s.qkv_bias,
                            blk["kernel_q"], blk["kernel_kv"], blk["stride_q"], blk["stride_kv"], s.mode,
                            s.cls_embed_on, s.pool_first, s.rel_pos_spatial, s.rel_pos_temporal, s.residual_pooling,
                            s.dim_mul_in_att, s.separate_qkv, s.layer_scale_init_value, 0.0, dtype)
            for blk in plan)
        # the head's inputs in block order, as the forward collects them
        feat_size, _ = calc_mvit_feature_geometry(s)
        taken = sorted(self.pretrain_depth)
        feat_sizes, head_dims = [tuple(feat_size[d]) for d in taken], [plan[d]["dim_out"] for d in taken]
        num_classes = (hog_num_classes(s, self.pretrain_depth) if pred_hog
                       else pixel_num_classes(s, self.pretrain_depth, time_stride_loss))
        self.pred_head = MSSeparateHead(s, num_classes, head_dims, feat_sizes, decoder_depth, decoder_embed_dim,
                                        dec_kv_kernel, dec_kv_stride)
        _init(self, seed, s, list(self.pred_head.projections))

    def forward(self, x, mask, state=None, generator: Optional[torch.Generator] = None):
        s = self.spec
        if isinstance(x, (list, tuple)):
            x = x[0]
        b = x.shape[0]
        x = self.patch_embed(x)
        t, hh, ww = (int(d) for d in x.shape[2:])
        x = x.flatten(2).transpose(1, 2)
        n = x.shape[1]
        if mask is None:
            raise ValueError("MaskFeat masks the loader's mask: set AUG.GEN_MASK_LOADER")
        mask = torch.as_tensor(mask, device=x.device)
        float_mask = _interp_mask(mask, (hh, ww))
        if float_mask.dim() == 3:  # a 2-D mask, the same in every frame
            float_mask = float_mask[:, None].expand(b, t, hh, ww)
        m = float_mask.reshape(b, n, 1).to(x.dtype)
        x = x * (1 - m) + self.mask_token.to(x.dtype) * m
        if s.cls_embed_on:
            x = torch.cat([self.cls_token.expand(b, 1, s.embed_dim).to(x.dtype), x], dim=1)
        if s.use_abs_pos:
            if s.sep_pos_embed:
                pe = _grid_positions(self.pos_embed_spatial, self.pos_embed_temporal)
                if s.cls_embed_on:
                    pe = torch.cat([self.pos_embed_class, pe], dim=1)
            else:
                pe = self.pos_embed
            x = x + pe.to(x.dtype)
        if s.norm_stem:
            x = self.norm_stem(x)
        thw = s.patch_dims
        block_outputs = []
        for i, blk in enumerate(self.blocks):
            x, thw = blk(x, thw)
            if i in self.pretrain_depth:
                block_outputs.append(x)
        preds = self.pred_head(block_outputs, thw)
        feat_size, _ = calc_mvit_feature_geometry(s)
        out_masks = []
        for d in self.pretrain_depth:
            fs = feat_size[d][-1]
            md = _interp_mask(mask, (fs, fs))
            if md.dim() == 3:
                md = md[:, None].expand(b, feat_size[d][0], fs, fs)
            out_masks.append(md.reshape(b, -1) > 0.5)
        return preds, out_masks


class MaskMViTMAE(nn.Module):
    """MAE forward (``vtm``'s ``MaskMViTMAE``): ``len_keep = int(L * (1 -
    AUG.MASK_RATIO))`` fixed at build; the noise (loader mask, or uniform
    under ``rnd_mask`` / without a mask, tiled over time under
    ``AUG.MASK_TUBE``; per frame under ``MASK.PER_FRAME_MASKING``) sorted
    stably; the kept tokens and their positions gathered (a fixed sin-cos
    table added before the drop); the encoder and ``norm``;
    ``decoder_embed``, mask tokens restored to grid order, the decoder
    positions; the head. ``forward(x, mask=None, noise=None)`` ->
    (predictions, pixel labels, boolean masks), per depth, every position.
    ``noise`` replaces the draw: [B, 1, h * w] under the tube, else [rows, L].
    With a loader mask the split follows the ratio, not the mask's count,
    as in ``vtm``. The encoder must not pool and has no relative positions."""

    def __init__(self, spec: MViTSpec, pretrain_depth=(15,), mask_ratio: float = 0.75, rnd_mask: bool = False,
                 per_frame_masking: bool = False, mask_tube: bool = False, time_stride_loss: bool = True,
                 norm_pred_pixel: bool = True, decoder_embed_dim: int = 512, decoder_sep_pos_embed: bool = False,
                 decoder_depth: int = 0, dec_kv_kernel=(), dec_kv_stride=(), dtype: torch.dtype = torch.float32,
                 seed: int = 0):
        super().__init__()
        s = self.config = self.spec = spec
        self.pretrain_depth = tuple(pretrain_depth)
        self.mask_ratio, self.rnd_mask = mask_ratio, rnd_mask
        self.per_frame_masking, self.mask_tube = per_frame_masking, mask_tube
        self.time_stride_loss, self.norm_pred_pixel = time_stride_loss, norm_pred_pixel
        self.decoder_sep_pos_embed, self.dtype = decoder_sep_pos_embed, dtype
        plan = s.block_plan()[:max(self.pretrain_depth) + 1]
        for blk in plan:
            assert not blk["kernel_q"] and not blk["kernel_kv"], (
                "the MAE encoder runs on a token subset; pooling attention requires the full grid")
        assert not (s.rel_pos_spatial or s.rel_pos_temporal)
        self.patch_embed = _PatchEmbed(s.in_chans, s.embed_dim, s.patch_kernel, s.patch_stride, s.patch_padding, dtype)
        t, hh, ww = s.patch_dims
        n_full, sp = t * hh * ww, (1 if s.cls_embed_on else 0)
        dec = decoder_embed_dim
        if s.use_abs_pos and not s.sep_pos_embed:
            self.pos_embed = nn.Parameter(torch.zeros(1, n_full + sp, s.embed_dim))
        if s.cls_embed_on:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, s.embed_dim))
        if s.use_abs_pos and not s.use_fixed_sincos_pos and s.sep_pos_embed:
            self.pos_embed_spatial = nn.Parameter(torch.zeros(1, hh * ww, s.embed_dim))
            self.pos_embed_temporal = nn.Parameter(torch.zeros(1, t, s.embed_dim))
            if s.cls_embed_on:
                self.pos_embed_class = nn.Parameter(torch.zeros(1, 1, s.embed_dim))
        self.blocks = nn.ModuleList(
            MultiScaleBlock(blk["dim"], blk["dim_out"], blk["num_heads"], blk["input_size"], s.mlp_ratio, s.qkv_bias,
                            (), (), (), (), s.mode, s.cls_embed_on, s.pool_first, False, False, s.residual_pooling,
                            s.dim_mul_in_att, s.separate_qkv, s.layer_scale_init_value, 0.0, dtype)
            for blk in plan)
        self.norm = LayerNorm(plan[-1]["dim_out"], s.norm_eps)
        self.decoder_embed = Linear(plan[-1]["dim_out"], dec)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, dec))
        if s.use_abs_pos:
            if decoder_sep_pos_embed:
                self.dec_pos_embed_spatial = nn.Parameter(torch.zeros(1, hh * ww, dec))
                self.dec_pos_embed_temporal = nn.Parameter(torch.zeros(1, t, dec))
                if s.cls_embed_on:
                    self.dec_pos_embed_class = nn.Parameter(torch.zeros(1, 1, dec))
            else:
                self.decoder_pos_embed = nn.Parameter(torch.zeros(1, n_full + sp, dec))
        k = len(self.pretrain_depth)
        self.pred_head = MSSeparateHead(s, pixel_num_classes(s, self.pretrain_depth, time_stride_loss), (dec,) * k,
                                        ((t, hh, ww),) * k, decoder_depth, dec, dec_kv_kernel, dec_kv_stride)
        _init(self, seed, s, [self.decoder_embed, *self.pred_head.projections])
        if s.use_fixed_sincos_pos:
            table = get_3d_sincos_pos_embed(s.embed_dim, hh, t, s.cls_embed_on)
            with torch.no_grad():
                self.pos_embed.copy_(torch.from_numpy(table[None].astype(np.float32)))

    def _noise(self, mask, noise, b: int, thw, rows: int, L: int, device, generator) -> torch.Tensor:
        """[rows, L] keys whose stable ascending order keeps the first
        ``len_keep`` tokens of each row."""
        t, hh, ww = thw
        if self.rnd_mask or mask is None:
            tube = self.mask_tube and not self.per_frame_masking
            if noise is None:
                noise = torch.rand((b, 1, hh * ww) if tube else (rows, L), generator=generator, device=device)
            noise = torch.as_tensor(noise, device=device).float()
            return noise.repeat(1, t, 1).reshape(rows, L) if tube else noise.reshape(rows, L)
        noise = _interp_mask(torch.as_tensor(mask, device=device), (hh, ww))
        if noise.dim() == 3:  # a 2-D mask: a tube over time
            noise = noise[:, None].expand(b, t, hh, ww)
        return noise.reshape(rows, L)

    def forward(self, x, mask=None, state=None, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        s = self.spec
        if isinstance(x, (list, tuple)):
            x = x[0]
        frames = x
        b = x.shape[0]
        x = self.patch_embed(x)
        t, hh, ww = (int(d) for d in x.shape[2:])
        x = x.flatten(2).transpose(1, 2)
        n_full, sp, width = t * hh * ww, (1 if s.cls_embed_on else 0), s.embed_dim
        if s.use_fixed_sincos_pos:
            x = x + self.pos_embed[:, sp:, :].to(x.dtype)

        L = hh * ww if self.per_frame_masking else n_full
        rows = b * t if self.per_frame_masking else b
        len_keep = int(L * (1 - self.mask_ratio))
        assert len_keep > 1
        keys = self._noise(mask, noise, b, (t, hh, ww), rows, L, x.device, generator)
        ids_shuffle = torch.argsort(keys, dim=1, stable=True)
        ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
        ids_keep = ids_shuffle[:, :len_keep]
        x = torch.gather(x.reshape(rows, L, width), 1, ids_keep[:, :, None].expand(-1, -1, width))
        bin_mask = torch.ones((rows, L), device=x.device)
        bin_mask[:, :len_keep] = 0.0
        out_mask = torch.gather(bin_mask, 1, ids_restore).reshape(b, n_full)
        x = x.reshape(b, -1, width)

        if s.cls_embed_on:
            cls = self.cls_token.expand(b, 1, width)
            if s.use_fixed_sincos_pos:
                cls = cls + self.pos_embed[:, :sp, :]
            x = torch.cat([cls.to(x.dtype), x], dim=1)
        if s.use_abs_pos and not s.use_fixed_sincos_pos:
            # the kept tokens' positions, gathered as the tokens were
            pe = (_grid_positions(self.pos_embed_spatial, self.pos_embed_temporal) if s.sep_pos_embed
                  else self.pos_embed[:, sp:, :])
            pe = pe.expand(b, n_full, width).reshape(rows, L, width)
            pe = torch.gather(pe, 1, ids_keep[:, :, None].expand(-1, -1, width)).reshape(b, -1, width)
            if s.cls_embed_on:
                pe_c = self.pos_embed_class if s.sep_pos_embed else self.pos_embed[:, :sp, :]
                pe = torch.cat([pe_c.expand(b, 1, width), pe], dim=1)
            x = x + pe.to(x.dtype)

        thw = (t, hh, ww)  # nominal: nothing pools
        for blk in self.blocks:
            x, thw = blk(x, thw)
        x = self.norm(x)

        x = self.decoder_embed(x.to(self.dtype))
        dec = x.shape[-1]
        core = x[:, sp:, :].reshape(rows, len_keep, dec)
        restored = torch.cat([core, self.mask_token.to(core.dtype).expand(rows, L - len_keep, dec)], dim=1)
        restored = torch.gather(restored, 1, ids_restore[:, :, None].expand(-1, -1, dec)).reshape(b, n_full, dec)
        x = torch.cat([x[:, :sp, :], restored], dim=1)
        if s.use_abs_pos:
            if self.decoder_sep_pos_embed:
                dpe = _grid_positions(self.dec_pos_embed_spatial, self.dec_pos_embed_temporal)
                if s.cls_embed_on:
                    dpe = torch.cat([self.dec_pos_embed_class, dpe], dim=1)
            else:
                dpe = self.decoder_pos_embed
            x = x + dpe.to(x.dtype)

        k = len(self.pretrain_depth)
        preds = self.pred_head([x] * k, (t, hh, ww))
        _, feat_stride = calc_mvit_feature_geometry(s)
        labels = [mae_pixel_labels(frames, s.patch_stride[0], feat_stride[d][-1], self.time_stride_loss,
                                   self.norm_pred_pixel) for d in self.pretrain_depth]
        return preds, labels, [out_mask > 0.5] * k


# --------------------------------------------------------------- registry

from vtm_torch.models.build import ModelBundle, compute_dtype, register_model  # noqa: E402


@register_model("MaskMViT", MaskMViT)
def _build_maskmvit_bundle(cfg, fp32_params: bool = False) -> ModelBundle:
    spec = mvit_spec_from_cfg(cfg)
    # the family only trains: its parameters stay fp32 (``fp32_params`` or
    # not), cast to the compute dtype at use
    m = cfg.MASK
    common = dict(pretrain_depth=tuple(m.PRETRAIN_DEPTH), time_stride_loss=m.TIME_STRIDE_LOSS,
                  decoder_depth=m.DECODER_DEPTH, decoder_embed_dim=m.DECODER_EMBED_DIM,
                  dec_kv_kernel=tuple(m.DEC_KV_KERNEL), dec_kv_stride=tuple(m.DEC_KV_STRIDE),
                  dtype=compute_dtype(cfg), seed=cfg.RNG_SEED)
    if m.MAE_ON:
        assert not m.PRED_HOG, "MAE carries the pixel branch; HOG targets use MaskFeat (MASK.MAE_ON False)"
        module = MaskMViTMAE(spec, mask_ratio=cfg.AUG.MASK_RATIO, rnd_mask=m.MAE_RND_MASK,
                             per_frame_masking=m.PER_FRAME_MASKING, mask_tube=cfg.AUG.MASK_TUBE,
                             norm_pred_pixel=m.NORM_PRED_PIXEL, decoder_sep_pos_embed=m.DECODER_SEP_POS_EMBED,
                             **common)
    elif m.MAE_RND_MASK:
        # upstream's MaskFeat with a random mask selects its HOG rows by a
        # token-grid mask, which mismatches the pooled grid of every shipped
        # MaskFeat config; vtm refuses it
        raise NotImplementedError(
            "MASK.MAE_RND_MASK requires MASK.MAE_ON (the reference's MaskFeat+rnd-mask path is incoherent "
            "for pooled MViTs)")
    else:
        module = MaskMViT(spec, pred_hog=m.PRED_HOG, **common)
    return ModelBundle(module=module, policy=MergePolicy(), name="MaskMViT")
