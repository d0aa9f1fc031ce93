"""VideoMAE — joint space-time ViT with tubelet embedding, in PyTorch.

Port of ``vtm/models/videomae.py``. Token merging is a constructor
argument (``MergePolicy``) applied between attention and MLP of each
block. No CLS token; fixed sin-cos positional embeddings; EPIC-KITCHENS
twin verb/noun heads when ``num_classes`` is a pair. The head pools by the
mean over the tokens and ``fc_norm`` (``use_mean_pooling``, every shipped
config), or, as ``VIDEOMAE.USE_MEAN_POOLING False`` asks, by ``norm`` over
every token and then token 0 (there is no class token: it is the first
patch token left). ``init_values > 0`` turns on layer scale: the
attention and MLP branches are multiplied by ``gamma_1`` and ``gamma_2``,
initialised to that constant (no config key sets it, as in ``vtm``).

Modules are named after the original MCG-NJU state-dict layout
(``patch_embed.proj``, ``blocks.{i}.attn.qkv`` / ``q_bias`` / ``v_bias`` /
``proj``, ``mlp.fc1`` / ``fc2``, ``norm1`` / ``norm2``, ``gamma_1`` /
``gamma_2``, ``fc_norm`` or ``norm``, ``head``; ``head0`` / ``head1`` for
the twin heads), so a released checkpoint loads with ``load_state_dict``.

Weights are drawn in fp32 from a ``torch.Generator`` seeded by ``seed``.
For serving (``fp32_params=False``) linear and conv weights (not the
head) are then cast once to the compute dtype. For training
(``fp32_params=True``) every parameter stays fp32 and is cast to the
compute dtype at use, so gradients and optimizer state are fp32; the
forward's values are the same either way. LayerNorms, the layer-scale
gammas (cast to the activation dtype at use) and the head stay fp32, as
in the JAX package.

In training mode (``module.train()``) the dropout sites of the JAX
package are active: ``drop_rate`` after the positional embedding, on the
attention projection and in the MLP; stochastic depth at
``drop_path_rate * i / (depth - 1)`` in block i; ``fc_drop_rate`` before
the head. Their masks come from the ``generator`` passed to ``forward``.

``layer_schedule`` ((block, metric_only) pairs) sets the executed stack
for layer duplication: a block may run at several steps, sharing its
weights, and merges with the r of the step (``layer=step``). A
``metric_only`` step runs norm1 and the attention for the metric, then
reduces x with no residual update.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from vtm_torch.merge.policy import MergePolicy, MergeState, reduce_tokens
from vtm_torch.models.common import (
    LayerNorm,
    Linear,
    Mlp,
    TubeletEmbed,
    aggregate_metric,
    attention_core,
    drop_path,
    dropout,
    merge_heads,
    proportional_attn_bias,
    sinusoid_encoding_table,
    split_heads,
)
from vtm_torch.parallel.sharding import copy_to_model


@dataclasses.dataclass(frozen=True)
class VideoMAEConfig:
    img_size: int = 224
    patch_size: int = 16
    num_classes: Union[int, Tuple[int, int]] = 400
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_frames: int = 16
    tubelet_size: int = 2
    use_mean_pooling: bool = True  # False: norm over every token, then token 0
    init_values: float = 0.0  # > 0: layer scale gamma_1 / gamma_2
    fc_drop_rate: float = 0.0
    drop_rate: float = 0.0
    drop_path_rate: float = 0.0

    @property
    def tokens(self) -> int:
        return (
            (self.img_size // self.patch_size) ** 2 * (self.num_frames // self.tubelet_size)
        )

    @property
    def multi_head(self) -> bool:
        return isinstance(self.num_classes, (tuple, list))


VARIANTS = {
    "vit_small_patch16_224": dict(embed_dim=384, depth=12, num_heads=6),
    "vit_base_patch16_224": dict(embed_dim=768, depth=12, num_heads=12),
    "vit_base_patch16_384": dict(embed_dim=768, depth=12, num_heads=12, img_size=384),
    "vit_large_patch16_224": dict(embed_dim=1024, depth=24, num_heads=16),
    "vit_large_patch16_384": dict(embed_dim=1024, depth=24, num_heads=16, img_size=384),
    "vit_large_patch16_512": dict(embed_dim=1024, depth=24, num_heads=16, img_size=512),
    "vit_huge_patch16_224": dict(embed_dim=1280, depth=32, num_heads=16),
}


class VideoMAEAttention(nn.Module):
    """Fused-qkv attention with split q/v bias and zero k bias, returning
    (out, metric). ``use_kernel=False`` sends every row to the plain
    product, so the kernel can be checked against it inside a model.

    Under tensor parallelism (``parallel/sharding.py``) it holds its local
    heads: ``qkv`` cut by heads in each of q, k and v, ``q_bias`` and
    ``v_bias`` cut with them, ``num_heads`` H / tp (the scale stays the head
    dim's), ``proj`` cut by rows; its input passes ``f`` and the metric is
    aggregated over ``model_group``."""

    model_group = None

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.use_kernel = True
        self.qkv = Linear(dim, dim * 3, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = Linear(dim, dim)

    def forward(self, x, size=None, head_aggregation: str = "mean"):
        x = copy_to_model(x, self.model_group)
        # the bias is added after the bias-free product, in the compute dtype
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
        qkv = self.qkv(x) + bias.to(x.dtype)
        q, k, v = (split_heads(t, self.num_heads) for t in qkv.chunk(3, dim=-1))
        out = attention_core(
            q, k, v, self.scale, proportional_attn_bias(size), use_kernel=self.use_kernel
        )
        return self.proj(merge_heads(out)), aggregate_metric(k, head_aggregation, self.model_group)


class VideoMAEBlock(nn.Module):
    """Pre-norm block with merging between attention and MLP."""

    def __init__(self, config: VideoMAEConfig, policy: MergePolicy, drop_path_rate: float = 0.0):
        super().__init__()
        c = config
        self.policy = policy
        self.drop_rate = c.drop_rate
        self.drop_path_rate = drop_path_rate  # this block's stochastic-depth rate
        self.norm1 = LayerNorm(c.embed_dim)
        self.attn = VideoMAEAttention(c.embed_dim, c.num_heads)
        self.norm2 = LayerNorm(c.embed_dim)
        self.mlp = Mlp(c.embed_dim, int(c.embed_dim * c.mlp_ratio), c.embed_dim, drop=c.drop_rate)
        if c.init_values > 0:
            self.gamma_1 = nn.Parameter(torch.full((c.embed_dim,), float(c.init_values)))
            self.gamma_2 = nn.Parameter(torch.full((c.embed_dim,), float(c.init_values)))
        else:
            self.gamma_1 = self.gamma_2 = None

    def forward(
        self, x: torch.Tensor, state: MergeState, layer: int,
        generator: Optional[torch.Generator] = None, metric_only: bool = False,
    ) -> Tuple[torch.Tensor, MergeState]:
        attn_out, metric = self.attn(
            self.norm1(x), state.attn_size(self.policy.prop_attn), self.policy.head_aggregation
        )
        if metric_only:
            return reduce_tokens(self.policy, layer, metric, x, state)
        attn_out = dropout(attn_out, self.drop_rate, self.training, generator)
        if self.gamma_1 is not None:
            attn_out = attn_out * self.gamma_1.to(attn_out.dtype)
        x = x + drop_path(attn_out, self.drop_path_rate, self.training, generator)
        x, state = reduce_tokens(self.policy, layer, metric, x, state)
        mlp_out = self.mlp(self.norm2(x), generator)
        if self.gamma_2 is not None:
            mlp_out = mlp_out * self.gamma_2.to(mlp_out.dtype)
        return x + drop_path(mlp_out, self.drop_path_rate, self.training, generator), state


class VideoMAE(nn.Module):
    """Full model. Input: [B, T, H, W, C] channels-last video; returns
    (logits, MergeState): logits [B, num_classes] fp32, or a (verb, noun)
    pair of them for the twin heads."""

    supports_tensor_parallel = True  # parallel/sharding.py cuts it

    def __init__(
        self,
        config: VideoMAEConfig,
        policy: MergePolicy = MergePolicy(),
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
        fp32_params: bool = False,
        layer_schedule: Optional[Sequence[Tuple[int, bool]]] = None,
    ):
        super().__init__()
        c = config
        self.config = config
        self.policy = policy
        self.layer_schedule = tuple(layer_schedule) if layer_schedule else None
        self.patch_embed = TubeletEmbed(3, c.embed_dim, c.tubelet_size, c.patch_size, dtype=dtype)
        self.register_buffer(
            "pos_embed",
            torch.from_numpy(sinusoid_encoding_table(c.tokens, c.embed_dim)),
            persistent=False,
        )
        # per-block stochastic-depth rates, linearly spaced
        dpr = [c.drop_path_rate * i / max(c.depth - 1, 1) for i in range(c.depth)]
        self.blocks = nn.ModuleList(VideoMAEBlock(c, policy, dpr[i]) for i in range(c.depth))
        if c.use_mean_pooling:
            self.fc_norm = LayerNorm(c.embed_dim)
        else:
            self.norm = LayerNorm(c.embed_dim)
        if c.multi_head:
            self.head0 = nn.Linear(c.embed_dim, c.num_classes[0])
            self.head1 = nn.Linear(c.embed_dim, c.num_classes[1])
        else:
            self.head = nn.Linear(c.embed_dim, c.num_classes)
        self._init_weights(torch.Generator().manual_seed(seed))
        if not fp32_params:
            for name, module in self.named_modules():
                if isinstance(module, (nn.Linear, nn.Conv3d)) and not name.startswith("head"):
                    module.to(dtype)

    @torch.no_grad()
    def _init_weights(self, generator: torch.Generator) -> None:
        """Truncated-normal (std 0.02) linear and conv weights, zero biases."""
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Conv3d)):
                nn.init.trunc_normal_(module.weight, std=0.02, generator=generator)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)

    def embed(
        self, video: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        """[B, T, H, W, C] -> the first block's input [B, N, D]."""
        x = self.patch_embed(video)
        x = x + self.pos_embed.to(x.dtype)
        return dropout(x, self.config.drop_rate, self.training, generator)

    def forward(
        self,
        x: torch.Tensor,
        state: Optional[MergeState] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """``generator`` draws the dropout and stochastic-depth masks in
        training mode (None: torch's default generator of x's device) and,
        as ``MergeState.generator``, the random modes' scores."""
        if state is None:
            state = MergeState(generator=generator)
        x = self.embed(x, generator)
        schedule = self.layer_schedule or [(i, False) for i in range(self.config.depth)]
        for step, (i, metric_only) in enumerate(schedule):
            x, state = self.blocks[i](x, state, layer=step, generator=generator, metric_only=metric_only)
        if self.config.use_mean_pooling:
            feats = self.fc_norm(x.mean(dim=1)).float()
        else:
            feats = self.norm(x)[:, 0].float()
        feats = dropout(feats, self.config.fc_drop_rate, self.training, generator)
        if self.config.multi_head:
            return (self.head0(feats), self.head1(feats)), state
        return self.head(feats), state


def build_videomae(
    cfg, policy: Optional[MergePolicy] = None, dtype: torch.dtype = torch.float32,
    fp32_params: bool = False,
) -> VideoMAE:
    """Construct from a config (same keys as ``vtm.models.videomae.build_videomae``)."""
    variant = dict(VARIANTS[cfg.VIDEOMAE.MODEL])
    num_classes = (
        cfg.MODEL.NUM_CLASSES
        if cfg.EPICKITCHENS.NUM_CLASSES is None
        else tuple(cfg.EPICKITCHENS.NUM_CLASSES)
    )
    # variant names pin img_size for the 384/512 models; otherwise the
    # configured crop size sets the sin-cos table
    img_size = variant.pop("img_size", cfg.DATA.TRAIN_CROP_SIZE)
    config = VideoMAEConfig(
        img_size=img_size,
        num_classes=num_classes,
        num_frames=cfg.DATA.NUM_FRAMES,
        tubelet_size=cfg.VIDEOMAE.TUBELET_SIZE,
        fc_drop_rate=cfg.VIDEOMAE.FC_DROP_RATE,
        drop_rate=cfg.VIDEOMAE.DROP_RATE,
        drop_path_rate=cfg.VIDEOMAE.DROP_PATH_RATE,
        use_mean_pooling=cfg.VIDEOMAE.USE_MEAN_POOLING,
        **variant,
    )
    return VideoMAE(
        config, policy=policy or MergePolicy(), dtype=dtype, seed=cfg.RNG_SEED,
        fp32_params=fp32_params,
    )


from vtm_torch.models.build import (  # noqa: E402
    ModelBundle,
    compute_dtype,
    duplication_plan,
    make_policy,
    register_model,
)


@register_model("VideoMAE", VideoMAE)
def _build_videomae_bundle(cfg, fp32_params: bool = False) -> ModelBundle:
    if cfg.VIDEOMAE.ATTN_DROP_RATE > 0:
        raise NotImplementedError(
            "VIDEOMAE.ATTN_DROP_RATE: dropout inside the fused attention kernel "
            "is unsupported (every reference config sets 0)"
        )
    depth = VARIANTS[cfg.VIDEOMAE.MODEL]["depth"]
    policy = make_policy(cfg, depth, n_protected_class_token=False)
    module = build_videomae(
        cfg, policy=policy, dtype=compute_dtype(cfg), fp32_params=fp32_params
    )
    module.layer_schedule = duplication_plan(cfg, depth)
    return ModelBundle(module=module, policy=policy, name="VideoMAE")
