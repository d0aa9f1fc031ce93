"""ViViT (the HuggingFace ``VivitModel`` the reference wraps), in PyTorch.

Port of ``vtm/models/vivit.py`` for serving and training: tubelet Conv3d
embedding, CLS token, learned position embeddings; pre-LN encoder layers
with separate query / key / value projections; a final layernorm; one
classifier, or the EPIC-KITCHENS verb / noun pair, over the CLS token.
Token merging runs after the attention residual, before the MLP, with the
CLS token protected. The attention is ``attention_core`` with the
proportional-attention key bias: on CUDA the dense kernels (K1, and K2
under training) for rows of 256 to 4096 tokens. ``layer_schedule``
((layer, metric_only) pairs) sets the executed stack for layer
duplication, as in VideoMAE: a ``metric_only`` step runs the attention for
the metric and reduces x with no residual update.

Modules carry the JAX package's names (``patch_embed.proj``,
``cls_token``, ``position_embeddings``, ``layer.{i}.{layernorm_before,
attention.query, attention.key, attention.value, attention_output,
layernorm_after, intermediate, output}``, ``layernorm``, ``classifier`` or
``verb_classifier`` / ``noun_classifier``);
``checkpoints/convert.py::load_vivit_state_dict`` maps a HuggingFace or
reference-wrapper state dict onto them. Weights are drawn in fp32 from a
``torch.Generator``; for serving (``fp32_params=False``) linear and conv
weights (not the classifiers) are then cast once to the compute dtype, for
training every parameter stays fp32 and is cast at use. Norms and the
classifiers stay fp32. There is no dropout (every shipped config sets 0).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from vtm_torch.merge.policy import MergePolicy, MergeState, reduce_tokens
from vtm_torch.models.common import (
    LayerNorm,
    Linear,
    TubeletEmbed,
    aggregate_metric,
    attention_core,
    merge_heads,
    proportional_attn_bias,
    split_heads,
)

EXACT_GELU = ("gelu",)
TANH_GELU = ("gelu_fast", "gelu_new", "gelu_pytorch_tanh")


@dataclasses.dataclass(frozen=True)
class ViViTConfig:
    image_size: int = 224
    num_frames: int = 32
    tubelet_size: Tuple[int, int, int] = (2, 16, 16)
    num_channels: int = 3
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu_fast"
    layer_norm_eps: float = 1e-6
    qkv_bias: bool = True
    num_classes: Union[int, Tuple[int, int]] = 400

    @property
    def tokens(self) -> int:  # incl. CLS
        t, ph, pw = self.tubelet_size
        return (self.num_frames // t) * (self.image_size // ph) * (self.image_size // pw) + 1

    @property
    def depth(self) -> int:
        return self.num_hidden_layers

    @property
    def multi_head(self) -> bool:
        return isinstance(self.num_classes, (tuple, list))

    @classmethod
    def from_json(cls, path: str, num_classes) -> "ViViTConfig":
        """Build from the reference's HF-style json configs
        (configs/vivit/*/*.json)."""
        with open(path) as f:
            d = json.load(f)
        return cls(
            image_size=d["video_size"][1],
            num_frames=d["video_size"][0],
            tubelet_size=tuple(d["tubelet_size"]),
            num_channels=d["num_channels"],
            hidden_size=d["hidden_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=d["num_attention_heads"],
            intermediate_size=d["intermediate_size"],
            hidden_act=d["hidden_act"],
            layer_norm_eps=d["layer_norm_eps"],
            qkv_bias=d["qkv_bias"],
            num_classes=num_classes,
        )


class ViViTSelfAttention(nn.Module):
    """Separate q/k/v attention returning (context, metric).
    ``use_kernel=False`` sends every row to the plain product, so the
    kernel can be checked against it inside a model."""

    def __init__(self, config: ViViTConfig):
        super().__init__()
        c = config
        self.num_heads = c.num_attention_heads
        self.scale = (c.hidden_size // c.num_attention_heads) ** -0.5
        self.use_kernel = True
        self.query = Linear(c.hidden_size, c.hidden_size, bias=c.qkv_bias)
        self.key = Linear(c.hidden_size, c.hidden_size, bias=c.qkv_bias)
        self.value = Linear(c.hidden_size, c.hidden_size, bias=c.qkv_bias)

    def forward(self, x, size=None, head_aggregation: str = "mean"):
        q, k, v = (split_heads(proj(x), self.num_heads) for proj in (self.query, self.key, self.value))
        ctx = attention_core(
            q, k, v, self.scale, proportional_attn_bias(size), use_kernel=self.use_kernel
        )
        return merge_heads(ctx), aggregate_metric(k, head_aggregation)


class ViViTLayer(nn.Module):
    """Pre-LN encoder layer with token reduction after the attention
    residual."""

    def __init__(self, config: ViViTConfig, policy: MergePolicy):
        super().__init__()
        c = config
        if c.hidden_act not in EXACT_GELU + TANH_GELU:
            # a silent exact-gelu fallback breaks parity with no diagnostic
            raise NotImplementedError(f"hidden_act {c.hidden_act!r}")
        self.gelu = "tanh" if c.hidden_act in TANH_GELU else "none"
        self.policy = policy
        self.layernorm_before = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.attention = ViViTSelfAttention(c)
        self.attention_output = Linear(c.hidden_size, c.hidden_size)
        self.layernorm_after = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.intermediate = Linear(c.hidden_size, c.intermediate_size)
        self.output = Linear(c.intermediate_size, c.hidden_size)

    def forward(
        self, x: torch.Tensor, state: MergeState, layer: int, metric_only: bool = False
    ) -> Tuple[torch.Tensor, MergeState]:
        ctx, metric = self.attention(
            self.layernorm_before(x), state.attn_size(self.policy.prop_attn), self.policy.head_aggregation
        )
        if metric_only:
            return reduce_tokens(self.policy, layer, metric, x, state)
        x = x + self.attention_output(ctx)
        x, state = reduce_tokens(self.policy, layer, metric, x, state)
        y = F.gelu(self.intermediate(self.layernorm_after(x)), approximate=self.gelu)
        return x + self.output(y), state


class ViViT(nn.Module):
    """Full ViViT classifier. Input: [B, T, H, W, C] channels-last video;
    returns (logits, MergeState): logits [B, num_classes] fp32, or a
    (verb, noun) pair of them for the twin classifiers."""

    def __init__(
        self,
        config: ViViTConfig,
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
        self.patch_embed = TubeletEmbed(
            c.num_channels, c.hidden_size, c.tubelet_size[0], tuple(c.tubelet_size[1:]), dtype=dtype
        )
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.hidden_size))
        self.position_embeddings = nn.Parameter(torch.zeros(1, c.tokens, c.hidden_size))
        self.layer = nn.ModuleList(ViViTLayer(c, policy) for _ in range(c.num_hidden_layers))
        self.layernorm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        if c.multi_head:
            self.verb_classifier = nn.Linear(c.hidden_size, c.num_classes[0])
            self.noun_classifier = nn.Linear(c.hidden_size, c.num_classes[1])
        else:
            self.classifier = nn.Linear(c.hidden_size, c.num_classes)
        self._init_weights(torch.Generator().manual_seed(seed))
        if not fp32_params:
            for name, module in self.named_modules():
                if isinstance(module, (nn.Linear, nn.Conv3d)) and "classifier" not in name:
                    module.to(dtype)

    @torch.no_grad()
    def _init_weights(self, generator: torch.Generator) -> None:
        """Truncated-normal (std 0.02) linear and conv weights; zero
        biases, class token and position embeddings, as the JAX package's
        ``init`` gives them (vtm/models/vivit.py:174-176)."""
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Conv3d)):
                nn.init.trunc_normal_(module.weight, std=0.02, generator=generator)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)
        for p in (self.cls_token, self.position_embeddings):
            nn.init.zeros_(p)

    def embed(self, video: torch.Tensor) -> torch.Tensor:
        """[B, T, H, W, C] -> the first layer's input [B, 1 + N, D]."""
        x = self.patch_embed(video)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embeddings.to(x.dtype)

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
        x = self.embed(x)
        schedule = self.layer_schedule or [(i, False) for i in range(self.config.num_hidden_layers)]
        for step, (i, metric_only) in enumerate(schedule):
            x, state = self.layer[i](x, state, layer=step, metric_only=metric_only)
        feats = self.layernorm(x)[:, 0].float()
        if self.config.multi_head:
            return (self.verb_classifier(feats), self.noun_classifier(feats)), state
        return self.classifier(feats), state


from vtm_torch.models.build import (  # noqa: E402
    ModelBundle,
    compute_dtype,
    duplication_plan,
    make_policy,
    register_model,
)


@register_model("ViViT")
def _build_vivit(cfg, fp32_params: bool = False) -> ModelBundle:
    """Construct from a config (the keys ``vtm.models.vivit._build_vivit``
    reads): the architecture from the json at ``VIVIT.CONFIG_PATH``."""
    num_classes = (
        cfg.MODEL.NUM_CLASSES
        if cfg.EPICKITCHENS.NUM_CLASSES is None
        else tuple(cfg.EPICKITCHENS.NUM_CLASSES)
    )
    config = ViViTConfig.from_json(cfg.VIVIT.CONFIG_PATH, num_classes)
    policy = make_policy(cfg, config.num_hidden_layers, n_protected_class_token=True)
    module = ViViT(
        config, policy=policy, dtype=compute_dtype(cfg), seed=cfg.RNG_SEED, fp32_params=fp32_params,
        layer_schedule=duplication_plan(cfg, config.num_hidden_layers),
    )
    return ModelBundle(module=module, policy=policy, name="ViViT")
