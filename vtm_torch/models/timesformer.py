"""TimeSformer — divided space-time attention ViT, in PyTorch.

Port of ``vtm/models/timesformer.py`` for serving and training, with all
three attention types (``divided_space_time``, ``space_only``,
``joint_space_time``), one head or the EPIC-KITCHENS verb/noun pair.

Token layout, as in the reference: the sequence is [CLS, body] with the
body ordered ``(p t)``, spatial-major and time-minor. A divided block runs
temporal attention over ``(b p) t`` (rows of ``num_frames`` tokens, plain
products), then spatial attention over ``(b t) p`` with the CLS token
broadcast to every frame and its outputs averaged over frames, then merges
tokens **per frame** with the spatial-attention keys as the metric (CLS
excluded; the proportional-attention bias reaches only the non-CLS block
of the spatial logits). The per-frame token count shrinks by r each layer.

The divided spatial attention is block-diagonal attention over the clip's
``t * (P + 1)`` tokens, frame-major: on a CUDA tensor it goes to
``tome_blockdiag_attention`` (kernels K5a and K5b) at every frame length,
with q, k, v as views of the fused qkv projection and the token-major
output reshaped straight into ``proj``. On the CPU, and with
``use_kernel=False``, it is ``attention_core`` on the ``(b t)`` batch with
the CLS-excluded bias, the same function in plain products.

There is no dropout or stochastic depth (``MODEL.DROPOUT_RATE`` is not
read, as in ``vtm``), so ``module.train()`` changes nothing.
``layer_schedule`` (block indices) sets the executed stack for layer
duplication: a block listed at several steps re-runs in full with shared
weights, merging with the r of the step.

Modules are named after the upstream state-dict layout
(``patch_embed.proj``, ``cls_token``, ``pos_embed``, ``time_embed``,
``blocks.{i}.{norm1,attn.qkv,attn.proj,temporal_norm1,temporal_attn.qkv,
temporal_attn.proj,temporal_fc,norm2,mlp.fc1,mlp.fc2}``, ``norm``,
``head`` or ``head0`` / ``head1``), so an upstream checkpoint loads with
``load_state_dict`` (``checkpoints/convert.py::load_timesformer_state_dict``
adds the HuggingFace names, the embedding interpolation and the image-ViT
rule). Weights are drawn in fp32 from a ``torch.Generator``; for serving
(``fp32_params=False``) linear and conv weights (not the heads) are then
cast once to the compute dtype, for training every parameter stays fp32 and
is cast at use. Norms and the heads stay fp32.

Also here: the space folds that Motionformer's per-frame merging shares.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from vtm_torch.merge.policy import MergePolicy, MergeState, reduce_tokens
from vtm_torch.models.common import (
    LayerNorm,
    Linear,
    Mlp,
    PatchEmbed2d,
    aggregate_metric,
    attention_core,
    merge_heads,
    proportional_attn_bias,
    split_heads,
)
from vtm_torch.ops.flash_attention import tome_blockdiag_attention
from vtm_torch.parallel.sharding import copy_to_model

ATTENTION_TYPES = ("divided_space_time", "space_only", "joint_space_time")


@dataclasses.dataclass(frozen=True)
class TimeSformerConfig:
    img_size: int = 224
    patch_size: int = 16
    num_classes: Union[int, Tuple[int, int]] = 400
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    num_frames: int = 8
    attention_type: str = "divided_space_time"
    layer_norm_eps: float = 1e-6

    @property
    def spatial_tokens(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def multi_head(self) -> bool:
        return isinstance(self.num_classes, (tuple, list))


def _fold_time(body: torch.Tensor, b: int, t: int) -> torch.Tensor:
    """[B, P*T, D] ('(p t)' order) -> [(B*P), T, D]."""
    return body.reshape(-1, t, body.shape[-1])


def _unfold_time(x: torch.Tensor, b: int, t: int) -> torch.Tensor:
    """[(B*P), T, D] -> [B, P*T, D]."""
    return x.reshape(b, -1, x.shape[-1])


def _fold_space(body: torch.Tensor, b: int, t: int) -> torch.Tensor:
    """[B, P*T, D] ('(p t)' order) -> [(B*T), P, D]."""
    d = body.shape[-1]
    p = body.shape[1] // t
    return body.reshape(b, p, t, d).transpose(1, 2).reshape(b * t, p, d)


def _unfold_space(x: torch.Tensor, b: int, t: int) -> torch.Tensor:
    """[(B*T), P, D] -> [B, P*T, D]."""
    d = x.shape[-1]
    p = x.shape[1]
    return x.reshape(b, t, p, d).transpose(1, 2).reshape(b, p * t, d)


class TimeSformerAttention(nn.Module):
    """Fused-qkv attention. With ``size`` [Bx, N - 1, 1] it adds log(size)
    to the non-CLS block of the logits. Returns (out, metric), the metric
    being the head-mean keys without the CLS row, or only ``out`` when
    built with ``with_metric=False``.

    ``frames``: x is the ``(b t)`` batch of the divided spatial attention,
    ``frames`` rows per clip. On a CUDA tensor that call goes to the
    block-diagonal kernel; ``use_kernel=False`` sends every call to the
    plain product, so the kernel can be checked against it inside a model.

    Under tensor parallelism (``parallel/sharding.py``) it holds its local
    heads (``qkv`` cut by heads in q, k and v, ``proj`` by rows); its input
    passes ``f`` and the metric is aggregated over ``model_group``. Both
    paths take the head count from ``num_heads``, H / tp.
    """

    model_group = None

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool, with_metric: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.with_metric = with_metric
        self.use_kernel = True
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, size: Optional[torch.Tensor] = None,
                frames: Optional[int] = None):
        qkv = self.qkv(copy_to_model(x, self.model_group))
        if frames is not None and self.use_kernel and x.is_cuda:
            out, k_mean = self.frames_attention(qkv, size, frames)
        else:
            out, k_mean = self.batch_attention(qkv, size)
        out = self.proj(out)
        if not self.with_metric:
            return out
        return out, k_mean[:, 1:, :]

    def _metric(self, k: torch.Tensor) -> Optional[torch.Tensor]:
        """The head-mean keys [B, N, hd] of k [B, H, N, hd] over the model
        group, or None where the module returns no metric."""
        return aggregate_metric(k, "mean", self.model_group) if self.with_metric else None

    def batch_attention(self, qkv: torch.Tensor, size: Optional[torch.Tensor]):
        """Every row of the batch on its own, through ``attention_core``:
        qkv [Bx, N, 3*D] -> (out [Bx, N, D], the head-mean keys [Bx, N, hd]
        or None)."""
        q, k, v = (split_heads(t, self.num_heads) for t in qkv.chunk(3, dim=-1))
        size_bias = proportional_attn_bias(size)
        out = attention_core(
            q, k, v, self.scale, size_bias, bias_excludes_first=size_bias is not None,
            use_kernel=self.use_kernel,
        )
        return merge_heads(out), self._metric(k)

    def frames_attention(self, qkv: torch.Tensor, size: Optional[torch.Tensor], frames: int):
        """The same for the (b t) batch of the divided spatial attention,
        as one block-diagonal attention per clip: a clip's frames are
        contiguous in the batch, so q, k, v of [B, H, t * N, hd] are views
        of the projection's output, and the token-major output is [Bx, N, D]
        as it stands."""
        bx, n, width = qkv.shape
        h, dim = self.num_heads, width // 3
        b = bx // frames
        q, k, v = (t.transpose(1, 2) for t in qkv.view(b, frames * n, 3, h, dim // h).unbind(dim=2))
        key_bias = None
        if size is not None:  # [0, log size] per frame
            key_bias = torch.log(F.pad(size[:, :, 0].float(), (1, 0), value=1.0)).view(b, frames * n)
        out = tome_blockdiag_attention(q, k, v, key_bias, self.scale, frames=frames, exclude_first_row=True)
        metric = self._metric(k)
        return out.view(bx, n, dim), None if metric is None else metric.view(bx, n, dim // h)


class TimeSformerBlock(nn.Module):
    """Divided block: temporal attention, spatial attention with the
    broadcast CLS, per-frame merging, MLP. The ``space_only`` and
    ``joint_space_time`` blocks are plain pre-norm blocks without merging."""

    def __init__(self, config: TimeSformerConfig, policy: MergePolicy):
        super().__init__()
        c = config
        self.divided = c.attention_type == "divided_space_time"
        self.policy = policy
        self.norm1 = LayerNorm(c.embed_dim, eps=c.layer_norm_eps)
        self.attn = TimeSformerAttention(c.embed_dim, c.num_heads, c.qkv_bias, with_metric=self.divided)
        if self.divided:
            self.temporal_norm1 = LayerNorm(c.embed_dim, eps=c.layer_norm_eps)
            self.temporal_attn = TimeSformerAttention(c.embed_dim, c.num_heads, c.qkv_bias, with_metric=False)
            self.temporal_fc = Linear(c.embed_dim, c.embed_dim)
        self.norm2 = LayerNorm(c.embed_dim, eps=c.layer_norm_eps)
        self.mlp = Mlp(c.embed_dim, int(c.embed_dim * c.mlp_ratio), c.embed_dim)

    def forward(
        self, x: torch.Tensor, state: MergeState, layer: int, b: int, t: int
    ) -> Tuple[torch.Tensor, MergeState]:
        if not self.divided:
            x = x + self.attn(self.norm1(x))
            return x + self.mlp(self.norm2(x)), state

        # ---- temporal attention over (b p) t
        body = x[:, 1:, :]
        res_t = self.temporal_attn(self.temporal_norm1(_fold_time(body, b, t)))
        xt = body + self.temporal_fc(_unfold_time(res_t, b, t))

        # ---- spatial attention over (b t) p with the broadcast CLS
        init_cls = x[:, :1, :]  # [B, 1, D]
        cls_rep = init_cls.repeat_interleave(t, dim=0)  # [(B*T), 1, D], b-major
        xs = torch.cat([cls_rep, _fold_space(xt, b, t)], dim=1)
        res_s, metric = self.attn(self.norm1(xs), state.attn_size(self.policy.prop_attn), frames=t)
        cls_out = res_s[:, 0, :].reshape(b, t, -1).mean(dim=1, keepdim=True)
        x = torch.cat([init_cls + cls_out, xt + _unfold_space(res_s[:, 1:, :], b, t)], dim=1)

        # ---- per-frame token reduction
        if self.policy.mode != "none" and self.policy.r_at(layer) > 0:
            folded, state = reduce_tokens(self.policy, layer, metric, _fold_space(x[:, 1:, :], b, t), state)
            x = torch.cat([x[:, :1, :], _unfold_space(folded, b, t)], dim=1)

        return x + self.mlp(self.norm2(x)), state


class TimeSformer(nn.Module):
    """Full model. Input: [B, T, H, W, C] channels-last video; returns
    (logits, MergeState): logits [B, num_classes] fp32, or a (verb, noun)
    pair of them for the twin heads."""

    supports_tensor_parallel = True  # parallel/sharding.py cuts it

    def __init__(
        self,
        config: TimeSformerConfig,
        policy: MergePolicy = MergePolicy(),
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
        fp32_params: bool = False,
        layer_schedule: Optional[Sequence[int]] = None,
    ):
        super().__init__()
        c = config
        if c.attention_type not in ATTENTION_TYPES:
            raise ValueError(f"unknown attention_type {c.attention_type!r}; one of {ATTENTION_TYPES}")
        d = c.embed_dim
        self.config = config
        self.policy = policy
        self.layer_schedule = tuple(layer_schedule) if layer_schedule else None
        self.patch_embed = PatchEmbed2d(3, d, c.patch_size, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, c.spatial_tokens + 1, d))
        if c.attention_type != "space_only":
            self.time_embed = nn.Parameter(torch.zeros(1, c.num_frames, d))
        self.blocks = nn.ModuleList(TimeSformerBlock(c, policy) for _ in range(c.depth))
        self.norm = LayerNorm(d, eps=c.layer_norm_eps)
        if c.multi_head:
            self.head0 = nn.Linear(d, c.num_classes[0])
            self.head1 = nn.Linear(d, c.num_classes[1])
        else:
            self.head = nn.Linear(d, c.num_classes)
        self._init_weights(torch.Generator().manual_seed(seed))
        if not fp32_params:
            for name, module in self.named_modules():
                if isinstance(module, (nn.Linear, nn.Conv2d)) and not name.startswith("head"):
                    module.to(dtype)

    @torch.no_grad()
    def _init_weights(self, generator: torch.Generator) -> None:
        """Truncated-normal (std 0.02) linear and conv weights, class token,
        position and time embeddings; zero biases."""
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Conv2d)):
                nn.init.trunc_normal_(module.weight, std=0.02, generator=generator)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)
        for name in ("cls_token", "pos_embed", "time_embed"):
            if hasattr(self, name):
                nn.init.trunc_normal_(getattr(self, name), std=0.02, generator=generator)

    def embed(self, video: torch.Tensor) -> torch.Tensor:
        """[B, T, H, W, C] -> the first block's input: [B, 1 + P*T, D] with
        the body in '(p t)' order, or for ``space_only`` [(B*T), 1 + P, D]."""
        c = self.config
        b, t = video.shape[:2]
        d = c.embed_dim
        emb = self.patch_embed(video).reshape(b * t, -1, d)  # [(b t), P, D]
        p = emb.shape[1]
        if p != c.spatial_tokens:
            raise ValueError(
                f"input spatial tokens {p} != model {c.spatial_tokens}; the position embedding "
                "is interpolated when a checkpoint is converted"
            )
        pos = self.pos_embed
        emb = emb + pos[:, 1:, :].to(emb.dtype)
        cls = (self.cls_token + pos[:, :1, :]).to(emb.dtype)
        if c.attention_type == "space_only":
            return torch.cat([cls.expand(b * t, -1, -1), emb], dim=1)
        if t != c.num_frames:
            raise ValueError(
                f"input frames {t} != model {c.num_frames}; the time embedding is interpolated "
                "when a checkpoint is converted"
            )
        xt = emb.reshape(b, t, p, d).transpose(1, 2).reshape(b * p, t, d) + self.time_embed.to(emb.dtype)
        return torch.cat([cls.expand(b, -1, -1), xt.reshape(b, p * t, d)], dim=1)

    def forward(
        self,
        x: torch.Tensor,
        state: Optional[MergeState] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """``generator`` draws the random modes' scores (as
        ``MergeState.generator``); the model itself draws nothing."""
        if state is None:
            state = MergeState(generator=generator)
        b, t = x.shape[:2]
        x = self.embed(x)
        for step, i in enumerate(self.layer_schedule or range(self.config.depth)):
            x, state = self.blocks[i](x, state, layer=step, b=b, t=t)
        if self.config.attention_type == "space_only":
            x = x.reshape(b, t, *x.shape[1:]).mean(dim=1)
        feats = self.norm(x)[:, 0].float()
        if self.config.multi_head:
            return (self.head0(feats), self.head1(feats)), state
        return self.head(feats), state


from vtm_torch.models.build import (  # noqa: E402
    ModelBundle,
    compute_dtype,
    duplication_plan,
    make_policy,
    register_model,
)


@register_model("TimeSformer", TimeSformer)
def _build_timesformer(cfg, fp32_params: bool = False) -> ModelBundle:
    """Construct from a config (the keys ``vtm.models.timesformer._build_timesformer``
    reads). Merging runs on the CLS-stripped per-frame tokens, so the
    policy protects no class token."""
    num_classes = (
        cfg.MODEL.NUM_CLASSES
        if cfg.EPICKITCHENS.NUM_CLASSES is None
        else tuple(cfg.EPICKITCHENS.NUM_CLASSES)
    )
    config = TimeSformerConfig(
        img_size=cfg.DATA.TRAIN_CROP_SIZE,
        num_classes=num_classes,
        num_frames=cfg.DATA.NUM_FRAMES,
        attention_type=cfg.TIMESFORMER.ATTENTION_TYPE,
    )
    policy = make_policy(cfg, config.depth, n_protected_class_token=False)
    plan = duplication_plan(cfg, config.depth)  # full-block shared-weight re-runs
    module = TimeSformer(
        config, policy=policy, dtype=compute_dtype(cfg), seed=cfg.RNG_SEED, fp32_params=fp32_params,
        layer_schedule=[i for i, _ in plan] if plan else None,
    )
    return ModelBundle(module=module, policy=policy, name="TimeSformer")
