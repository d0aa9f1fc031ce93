"""Motionformer — trajectory-attention ViT, in PyTorch.

Port of ``vtm/models/motionformer.py`` for serving and training with
trajectory attention (``ATTN_LAYER: trajectory``), joint space-time
attention (``joint``) or divided space-time attention (``divided``), the
3-D tubelet or the per-frame 2-D patch embed, separate or joint position
embeddings, one head or the EPIC-KITCHENS verb/noun pair. Token merging
runs per pseudo-frame between attention and MLP of each trajectory or
joint block. Trajectory attention's spatial step may be approximated
(``APPROX_ATTN_TYPE``: ``nystrom``, ``orthoformer`` or ``performer``, with
``APPROX_ATTN_DIM`` landmarks; ``motionformer_approx``): then it runs as
plain products, K3 is not launched, and the token sizes do not reach it,
as in ``vtm``. Divided blocks (``timeattn`` under ``norm3``, then ``attn``
under ``norm1``, then the MLP) are plain products too and never merge,
whatever the policy says, as in ``vtm``.

The reference's quirks are kept exactly, since they produced the
paper's numbers:
  * the body sequence is frame-major ``(f n)``, and the spatial
    attention groups keys into contiguous frames (frame = index // s);
  * the matching metric, the per-pseudo-frame merge and the
    proportional-attention size use the ``(s f)`` fold of the same
    sequence (``_fold_space``: pseudo-frame = index % F);
  * with ``use_original_code`` the temporal values are the spatial
    output ``xq`` itself (the reference's ``v=x`` typo), so only the k
    half of ``proj_kv`` is contracted; its weight keeps the full
    [2D, D] shape;
  * the head applies a softmax unless the model was built with
    ``train_mode=True``, which returns the raw logits. ``build_model``
    does not set it (neither does ``vtm``'s build function), so a model built
    from a config hands probabilities to the loss.

There is no dropout or stochastic depth (``MOTIONFORMER.DROP*`` are not
read, as in ``vtm``), so ``module.train()`` changes nothing.
``layer_schedule`` (block indices) sets the executed stack for layer
duplication, as in TimeSformer: a shared block re-runs in full.

Modules are named after the upstream state-dict layout
(``patch_embed_3d.proj`` or ``patch_embed.proj``, ``cls_token``,
``pos_embed``, ``temp_embed`` or ``st_embed``,
``blocks.{i}.attn.{qkv,proj_q,proj_kv,proj}``, and for divided blocks
``blocks.{i}.timeattn.{qkv,proj}`` and ``blocks.{i}.norm3``, ``norm``,
``pre_logits.fc``, ``head`` or ``head0`` / ``head1``), so an upstream
checkpoint loads with ``load_state_dict``. Weights are drawn in fp32 from
a ``torch.Generator``. For serving (``fp32_params=False``) linear and conv
weights (not the heads) are then cast once to the compute dtype. For
training (``fp32_params=True``) every parameter stays fp32 and is cast to
the compute dtype at use, so gradients and optimizer state are fp32; the
forward's values are the same either way. Norms and the heads stay fp32,
as in VideoMAE.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from vtm_torch.merge.policy import MergePolicy, MergeState, reduce_tokens
from vtm_torch.models import motionformer_approx as approx
from vtm_torch.models.build import (
    ModelBundle,
    compute_dtype,
    duplication_plan,
    make_policy,
    register_model,
)
from vtm_torch.models.common import (
    _FLASH_MAX_SEQ,
    _FLASH_MIN_SEQ,
    LayerNorm,
    Linear,
    Mlp,
    PatchEmbed2d,
    TubeletEmbed,
    merge_heads,
    split_heads,
)
from vtm_torch.models.timesformer import _fold_space, _unfold_space
from vtm_torch.ops.flash_attention import _reference, tome_frame_attention

ATTN_LAYERS = ("trajectory", "joint", "divided")
APPROX_ATTN_TYPES = ("none", "nystrom", "orthoformer", "performer")
PERFORMER_FEATURES = 256  # FAVOR+'s m, as in vtm
# flax's gelu is the tanh approximation
HEAD_ACTS = {"tanh": nn.Tanh, "gelu": functools.partial(nn.GELU, approximate="tanh"), "relu": nn.ReLU}


@dataclasses.dataclass(frozen=True)
class MotionformerConfig:
    img_size: int = 224
    patch_size: int = 16
    patch_size_temp: int = 2
    in_chans: int = 3
    num_classes: Union[int, Tuple[int, int]] = 400
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    temporal_resolution: int = 8  # frames AFTER temporal patching
    use_mlp: bool = False
    head_act: str = "tanh"
    pos_embed_type: str = "separate"  # separate | joint
    attn_layer: str = "trajectory"  # trajectory | joint | divided
    use_original_code: bool = True
    approx_attn_type: str = "none"  # none | nystrom | orthoformer | performer
    approx_attn_dim: int = 128  # landmarks of nystrom and orthoformer
    layer_norm_eps: float = 1e-6

    @property
    def spatial_tokens(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def multi_head(self) -> bool:
        return isinstance(self.num_classes, (tuple, list))


def _check_config(c: MotionformerConfig) -> None:
    if c.attn_layer not in ATTN_LAYERS:
        raise ValueError(f"unknown attn_layer {c.attn_layer!r}; one of {ATTN_LAYERS}")
    if c.approx_attn_type not in APPROX_ATTN_TYPES:
        raise ValueError(f"unknown approx_attn_type {c.approx_attn_type!r}; one of {APPROX_ATTN_TYPES}")
    if c.head_act not in HEAD_ACTS:
        raise ValueError(f"unknown head_act {c.head_act!r}; one of {sorted(HEAD_ACTS)}")
    if c.pos_embed_type not in ("separate", "joint"):
        raise ValueError(f"unknown pos_embed_type {c.pos_embed_type!r}")


class TrajectoryAttention(nn.Module):
    """Trajectory attention returning (out, metric): a per-frame spatial
    attention (K3 on CUDA for 256 to 4096 body tokens, or the configured
    approximation as plain products) followed by a temporal attention
    along each token's trajectory. ``use_kernel=False`` sends every call
    to the plain product, so the kernel can be checked against it inside a
    model."""

    def __init__(self, config: MotionformerConfig):
        super().__init__()
        c = config
        d = c.embed_dim
        self.num_heads = c.num_heads
        self.scale = (d // c.num_heads) ** -0.5
        self.use_original_code = c.use_original_code
        self.approx_attn_type = c.approx_attn_type
        self.approx_attn_dim = c.approx_attn_dim
        self.use_kernel = True
        self.qkv = Linear(d, d * 3, bias=c.qkv_bias)
        self.proj_q = Linear(d, d, bias=c.qkv_bias)
        self.proj_kv = Linear(d, d * 2, bias=c.qkv_bias)
        self.proj = Linear(d, d)

    def forward(
        self,
        x: torch.Tensor,
        num_frames: int,
        size: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """x [B, 1 + F*s, D]; ``size`` [(B*F), s, 1] per-pseudo-frame token
        sizes or None; ``generator`` draws orthoformer's first landmark
        (None: row 0). Returns (out [B, 1 + F*s, D], metric [(B*F), s, hd])."""
        b, n, d = x.shape
        h = self.num_heads
        hd = d // h
        f = num_frames
        nb = n - 1
        s = nb // f
        scale = self.scale

        q, k, v = (split_heads(t, h) for t in self.qkv(x).chunk(3, dim=-1))
        # the CLS row attends over every token, itself included
        cls_out = merge_heads(_reference(q[:, :, :1], k, v, None, scale))

        q_, k_, v_ = q[:, :, 1:], k[:, :, 1:], v[:, :, 1:]
        approximate = self.approx_attn_type != "none"
        # keys are grouped (f n) for the spatial softmax, but the size is
        # (s f)-folded: the reference patch's inconsistency, kept. The
        # approximations take no size bias, as in vtm.
        key_bias = None
        if size is not None and not approximate:
            key_bias = torch.log(_unfold_space(size, b, f)[:, :, 0])
        if approximate:
            # heads flattened into the batch
            flat = [t.reshape(b * h, nb, hd) for t in (q_, k_, v_)]
            xfa = self.approximate(*flat, f, generator)
            xfa = xfa.reshape(b, h, nb, f, hd).permute(0, 2, 3, 1, 4)
        elif self.use_kernel and x.is_cuda and _FLASH_MIN_SEQ <= nb <= _FLASH_MAX_SEQ:
            xfa = tome_frame_attention(q_, k_, v_, key_bias, scale, f)
        else:
            logits = torch.matmul(q_.float(), k_.float().transpose(-2, -1)) * scale
            if key_bias is not None:
                logits = logits + key_bias[:, None, None, :]
            attn = torch.softmax(logits.view(b, h, nb, f, s), dim=-1).to(v.dtype)
            xfa = torch.einsum("bhqfn,bhfnd->bqfhd", attn, v_.reshape(b, h, f, s, hd))

        # token-major [B, N', F, D]: the head merge is a free reshape
        out = self.temporal(xfa.reshape(b, nb, f, d), s)
        out = self.proj(torch.cat([cls_out, out], dim=1))

        # metric: (s f) fold of the body keys, mean over heads
        return out, _fold_space(k_.mean(dim=1), b, f)

    def approximate(self, q, k, v, num_frames: int, generator: Optional[torch.Generator]):
        """The approximate spatial step on [B*h, N', hd] -> [B*h, N', F, hd]."""
        if self.approx_attn_type == "nystrom":
            return approx.nystrom_spatial_attn(
                q, k, v, landmarks=self.approx_attn_dim, num_frames=num_frames, use_spatial_landmarks=True
            )
        if self.approx_attn_type == "orthoformer":
            return approx.orthoformer(
                q, k, v, num_landmarks=self.approx_attn_dim, num_frames=num_frames, generator=generator
            )
        return approx.performer_attention(q, k, v, num_frames, m=PERFORMER_FEATURES)

    def temporal(self, xq: torch.Tensor, s: int) -> torch.Tensor:
        """Temporal attention along each token's trajectory: xq [B, N', F, D]
        (the spatial step's output per frame) -> [B, N', D]. The query is
        the token's own-frame slice."""
        b, nb, f, d = xq.shape
        h = self.num_heads
        hd = d // h
        scale = self.scale
        tokens = torch.arange(nb, device=xq.device)
        x_diag = xq[:, tokens, tokens // s]  # [B, N', D]
        q2 = self.proj_q(x_diag)
        if self.use_original_code:
            # v=x typo: proj_kv's v half is never used (its gradient is
            # zero). The cast at use covers fp32 parameters, as in Linear.
            w, bias = self.proj_kv.weight, self.proj_kv.bias
            k2 = F.linear(xq, w[:d].to(xq.dtype), None if bias is None else bias[:d].to(xq.dtype))
            val2 = xq
        else:
            k2, val2 = self.proj_kv(xq).chunk(2, dim=-1)
        # per-head logits: products in the compute dtype, summed in fp32
        z = (q2 * scale)[:, :, None, :] * k2  # [B, N', F, D]
        logits2 = z.float().view(b, nb, f, h, hd).sum(dim=-1)  # [B, N', F, h]
        attn2 = torch.softmax(logits2, dim=2).to(xq.dtype)
        return (attn2[..., None] * val2.reshape(b, nb, f, h, hd)).sum(dim=2).reshape(b, nb, d)


class JointAttention(nn.Module):
    """Joint space-time attention over all tokens (plain products, as in
    ``vtm``; the token sizes and the generator are not used), returning
    (out, metric)."""

    def __init__(self, config: MotionformerConfig):
        super().__init__()
        c = config
        d = c.embed_dim
        self.num_heads = c.num_heads
        self.scale = (d // c.num_heads) ** -0.5
        self.qkv = Linear(d, d * 3, bias=c.qkv_bias)
        self.proj = Linear(d, d)

    def forward(self, x: torch.Tensor, num_frames: int, size: Optional[torch.Tensor] = None, generator=None):
        q, k, v = (split_heads(t, self.num_heads) for t in self.qkv(x).chunk(3, dim=-1))
        out = self.proj(merge_heads(_reference(q, k, v, None, self.scale)))
        return out, _fold_space(k.mean(dim=1)[:, 1:], x.shape[0], num_frames)


class DividedAttention(nn.Module):
    """Divided space-time attention (plain products, as in ``vtm``): the
    CLS query attends over every token; each body query attends within its
    frame (space) or, with ``to_time``, within its spatial position over
    the frames (time), with the CLS key and value prepended to every
    group. The body is folded exactly (f n), unlike trajectory's (s f)."""

    def __init__(self, config: MotionformerConfig):
        super().__init__()
        c = config
        d = c.embed_dim
        self.num_heads = c.num_heads
        self.scale = (d // c.num_heads) ** -0.5
        self.qkv = Linear(d, d * 3, bias=c.qkv_bias)
        self.proj = Linear(d, d)

    def forward(self, x: torch.Tensor, num_frames: int, to_time: bool) -> torch.Tensor:
        b, n, _ = x.shape
        h = self.num_heads
        q, k, v = (split_heads(t, h) for t in self.qkv(x).chunk(3, dim=-1))
        hd = q.shape[-1]
        f = num_frames
        nb = n - 1
        s = nb // f
        cls_out = _reference(q[:, :, :1], k, v, None, self.scale)

        def fold(t):
            t = t[:, :, 1:].reshape(b, h, f, s, hd)  # [B, h, F, s, hd]: groups of one frame
            return t.transpose(2, 3) if to_time else t

        qf, kf, vf = fold(q), fold(k), fold(v)
        g = qf.shape[2]
        kf = torch.cat([k[:, :, :1, None].expand(b, h, g, 1, hd), kf], dim=3)
        vf = torch.cat([v[:, :, :1, None].expand(b, h, g, 1, hd), vf], dim=3)
        out = _reference(qf, kf, vf, None, self.scale)
        if to_time:
            out = out.transpose(2, 3)
        out = torch.cat([cls_out, out.reshape(b, h, nb, hd)], dim=2)
        return self.proj(merge_heads(out))


class MotionformerBlock(nn.Module):
    """Pre-norm block; merging runs per (s f)-folded pseudo-frame between
    attention and MLP. A divided block runs time attention (``timeattn``
    under ``norm3``), then space attention (``attn`` under ``norm1``), then
    the MLP, and never merges: the reference's merging patch does not
    reach such blocks, and ``vtm`` keeps that."""

    def __init__(self, config: MotionformerConfig, policy: MergePolicy):
        super().__init__()
        c = config
        self.policy = policy
        self.divided = c.attn_layer == "divided"
        self.orthoformer = c.approx_attn_type == "orthoformer"
        self.norm1 = LayerNorm(c.embed_dim, eps=c.layer_norm_eps)
        if self.divided:
            self.timeattn = DividedAttention(c)
            self.norm3 = LayerNorm(c.embed_dim, eps=c.layer_norm_eps)
            self.attn = DividedAttention(c)
        else:
            self.attn = {"trajectory": TrajectoryAttention, "joint": JointAttention}[c.attn_layer](c)
        self.norm2 = LayerNorm(c.embed_dim, eps=c.layer_norm_eps)
        self.mlp = Mlp(c.embed_dim, int(c.embed_dim * c.mlp_ratio), c.embed_dim)

    def forward(
        self, x: torch.Tensor, state: MergeState, layer: int, num_frames: int
    ) -> Tuple[torch.Tensor, MergeState]:
        if self.divided:
            x = x + self.timeattn(self.norm3(x), num_frames, to_time=True)
            x = x + self.attn(self.norm1(x), num_frames, to_time=False)
            return x + self.mlp(self.norm2(x)), state
        # orthoformer's first landmark comes from the forward's generator
        generator = state.generator if self.orthoformer else None
        out, metric = self.attn(self.norm1(x), num_frames, state.attn_size(self.policy.prop_attn), generator)
        x = x + out
        if self.policy.mode != "none" and self.policy.r_at(layer) > 0:
            b = x.shape[0]
            folded = _fold_space(x[:, 1:], b, num_frames)
            folded, state = reduce_tokens(self.policy, layer, metric, folded, state)
            x = torch.cat([x[:, :1], _unfold_space(folded, b, num_frames)], dim=1)
        return x + self.mlp(self.norm2(x)), state


class Motionformer(nn.Module):
    """Full model. Input: [B, T, H, W, C] channels-last video (T raw
    frames; the tubelet embed reduces them to ``temporal_resolution``).
    Returns (output, MergeState): class probabilities [B, num_classes]
    fp32, or with ``train_mode`` the raw logits; a (verb, noun) pair of
    them for the twin heads."""

    def __init__(
        self,
        config: MotionformerConfig,
        policy: MergePolicy = MergePolicy(),
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
        train_mode: bool = False,
        fp32_params: bool = False,
        layer_schedule: Optional[Sequence[int]] = None,
    ):
        super().__init__()
        _check_config(config)
        c = config
        d = c.embed_dim
        self.config = config
        self.policy = policy
        self.layer_schedule = tuple(layer_schedule) if layer_schedule else None
        self.train_mode = train_mode
        if c.patch_size_temp > 1:
            self.patch_embed_3d = TubeletEmbed(c.in_chans, d, c.patch_size_temp, c.patch_size, dtype=dtype)
        else:
            self.patch_embed = PatchEmbed2d(c.in_chans, d, c.patch_size, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, c.spatial_tokens + 1, d))
        if c.pos_embed_type == "separate":
            self.temp_embed = nn.Parameter(torch.zeros(1, c.temporal_resolution, d))
        else:
            self.st_embed = nn.Parameter(
                torch.zeros(1, c.spatial_tokens * c.temporal_resolution + 1, d)
            )
        self.blocks = nn.ModuleList(MotionformerBlock(c, policy) for _ in range(c.depth))
        self.norm = LayerNorm(d, eps=c.layer_norm_eps)
        if c.use_mlp:
            self.pre_logits = nn.Sequential(
                collections.OrderedDict(fc=Linear(d, d), act=HEAD_ACTS[c.head_act]())
            )
        else:
            self.pre_logits = nn.Identity()
        if c.multi_head:
            self.head0 = nn.Linear(d, c.num_classes[0])
            self.head1 = nn.Linear(d, c.num_classes[1])
        else:
            self.head = nn.Linear(d, c.num_classes)
        self._init_weights(torch.Generator().manual_seed(seed))
        if not fp32_params:
            for name, module in self.named_modules():
                if isinstance(module, (nn.Linear, nn.Conv3d, nn.Conv2d)) and not name.startswith("head"):
                    module.to(dtype)

    @torch.no_grad()
    def _init_weights(self, generator: torch.Generator) -> None:
        """Truncated-normal (std 0.02) linear and conv weights, class token
        and position embeddings; zero biases and temporal embedding."""
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Conv3d, nn.Conv2d)):
                nn.init.trunc_normal_(module.weight, std=0.02, generator=generator)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)
        for p in (self.cls_token, self.pos_embed):
            nn.init.trunc_normal_(p, std=0.02, generator=generator)
        if self.config.pos_embed_type == "joint":
            nn.init.trunc_normal_(self.st_embed, std=0.02, generator=generator)

    def embed(self, video: torch.Tensor) -> torch.Tensor:
        """[B, T, H, W, C] -> the first block's input [B, 1 + F*s, D]: CLS
        token, then the patches frame-major, plus the position embedding
        tiled over frames and the temporal one repeated over space (or the
        joint space-time embedding)."""
        c = self.config
        emb = (self.patch_embed_3d if c.patch_size_temp > 1 else self.patch_embed)(video)
        cls = self.cls_token.to(emb.dtype).expand(emb.shape[0], -1, -1)
        x = torch.cat([cls, emb], dim=1)
        if c.pos_embed_type == "joint":
            return x + self.st_embed.to(x.dtype)
        pos = self.pos_embed
        tiled = pos[:, 1:].repeat(1, c.temporal_resolution, 1) + self.temp_embed.repeat_interleave(
            c.spatial_tokens, dim=1
        )
        return x + torch.cat([pos[:, :1], tiled], dim=1).to(x.dtype)

    def _head(self, head: nn.Linear, feats: torch.Tensor) -> torch.Tensor:
        logits = head(feats)
        return logits if self.train_mode else torch.softmax(logits, dim=-1)

    def forward(
        self,
        x: torch.Tensor,
        state: Optional[MergeState] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """``generator`` (as ``MergeState.generator``) draws the random
        modes' scores and, with Orthoformer, each layer's first landmark
        (row 0 without one); the model draws nothing else."""
        if state is None:
            state = MergeState(generator=generator)
        x = self.embed(x)
        for step, i in enumerate(self.layer_schedule or range(self.config.depth)):
            x, state = self.blocks[i](x, state, layer=step, num_frames=self.config.temporal_resolution)
        feats = self.pre_logits(self.norm(x)[:, 0]).float()
        if self.config.multi_head:
            return (self._head(self.head0, feats), self._head(self.head1, feats)), state
        return self._head(self.head, feats), state


@register_model("Motionformer", Motionformer)
def _build_motionformer(cfg, fp32_params: bool = False) -> ModelBundle:
    """Construct from a config (the keys ``vtm.models.motionformer._build_motionformer``
    reads). Like that function it leaves ``train_mode`` off."""
    num_classes = (
        cfg.MODEL.NUM_CLASSES
        if cfg.EPICKITCHENS.NUM_CLASSES is None
        else tuple(cfg.EPICKITCHENS.NUM_CLASSES)
    )
    m = cfg.MOTIONFORMER
    config = MotionformerConfig(
        img_size=cfg.DATA.TRAIN_CROP_SIZE,
        patch_size=m.PATCH_SIZE,
        patch_size_temp=m.PATCH_SIZE_TEMP,
        in_chans=m.CHANNELS,
        num_classes=num_classes,
        embed_dim=m.EMBED_DIM,
        depth=m.DEPTH,
        num_heads=m.NUM_HEADS,
        mlp_ratio=float(m.MLP_RATIO),
        qkv_bias=m.QKV_BIAS,
        temporal_resolution=m.TEMPORAL_RESOLUTION,
        use_mlp=m.USE_MLP,
        head_act=m.HEAD_ACT,
        pos_embed_type=m.POS_EMBED,
        attn_layer=m.ATTN_LAYER,
        use_original_code=m.USE_ORIGINAL_TRAJ_ATTN_CODE,
        approx_attn_type=m.APPROX_ATTN_TYPE,
        approx_attn_dim=m.APPROX_ATTN_DIM,
    )
    policy = make_policy(cfg, config.depth, n_protected_class_token=False)
    plan = duplication_plan(cfg, config.depth)  # full-block shared-weight re-runs
    module = Motionformer(
        config, policy=policy, dtype=compute_dtype(cfg), seed=cfg.RNG_SEED, fp32_params=fp32_params,
        layer_schedule=[i for i, _ in plan] if plan else None,
    )
    return ModelBundle(module=module, policy=policy, name="Motionformer")
