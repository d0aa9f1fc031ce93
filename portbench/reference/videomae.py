"""Plain float32 VideoMAE with ToMe (Tong et al., NeurIPS 2022; Bolya et
al., ICLR 2023), from the equations.

A tubelet embedding plus the fixed sin-cos table; per block a pre-norm
attention with the qkv product unbiased and the q and v biases added after
it, then ToMe's size-weighted merge of r tokens matched on the mean over
heads of the keys, then the pre-norm MLP; the mean over the tokens left,
``fc_norm`` and the head. Without proportional attention the sizes only
weight the merges. Parameter names follow the released checkpoints.
"""

from __future__ import annotations

import torch

from portbench.counts.videomae import tokens
from portbench.reference.common import (
    FP32,
    Follow,
    Numerics,
    attention,
    bipartite_merge,
    chunks,
    layer_norm,
    linear,
    mlp,
    sincos_table,
    split_heads,
    stitch,
    tubelet_embed,
)

EPS = 1e-6


def param_specs(m: dict):
    """(name, shape, base) of every parameter: a weight is base + 0.02 *
    a normal draw cut at two deviations (base 1 for a norm's scale)."""
    d, hidden = m["embed_dim"], int(m["embed_dim"] * m["mlp_ratio"])
    specs = [("patch_embed.proj.weight", (d, 3, m["tubelet_size"], m["patch_size"], m["patch_size"]), 0.0),
             ("patch_embed.proj.bias", (d,), 0.0)]
    for i in range(m["depth"]):
        p = f"blocks.{i}."
        specs += [(p + "norm1.weight", (d,), 1.0), (p + "norm1.bias", (d,), 0.0),
                  (p + "attn.qkv.weight", (3 * d, d), 0.0),
                  (p + "attn.q_bias", (d,), 0.0), (p + "attn.v_bias", (d,), 0.0),
                  (p + "attn.proj.weight", (d, d), 0.0), (p + "attn.proj.bias", (d,), 0.0),
                  (p + "norm2.weight", (d,), 1.0), (p + "norm2.bias", (d,), 0.0),
                  (p + "mlp.fc1.weight", (hidden, d), 0.0), (p + "mlp.fc1.bias", (hidden,), 0.0),
                  (p + "mlp.fc2.weight", (d, hidden), 0.0), (p + "mlp.fc2.bias", (d,), 0.0)]
    return specs + [("fc_norm.weight", (d,), 1.0), ("fc_norm.bias", (d,), 0.0),
                    ("head.weight", (m["num_classes"], d), 0.0), ("head.bias", (m["num_classes"],), 0.0)]


def forward(p: dict, video: torch.Tensor, m: dict, r: int, num: Numerics = FP32, follow: Follow = None,
            record: list = None) -> torch.Tensor:
    """Logits [B, classes] of float32 ``video`` [B, T, H, W, 3]; the merges
    follow ``follow`` where given and go to ``record``."""
    d, heads = m["embed_dim"], m["num_heads"]
    scale = (d // heads) ** -0.5
    x = tubelet_embed(video, p["patch_embed.proj.weight"], p["patch_embed.proj.bias"], num)
    x = x + sincos_table(tokens(m), d).to(x.device)
    size = None
    zeros = torch.zeros(d, device=x.device)
    for i in range(m["depth"]):
        b = f"blocks.{i}."
        h = layer_norm(x, p[b + "norm1.weight"], p[b + "norm1.bias"], EPS)
        bias = torch.cat([p[b + "attn.q_bias"], zeros, p[b + "attn.v_bias"]])
        q, k, v = (split_heads(t, heads) for t in linear(h, p[b + "attn.qkv.weight"], bias, num).chunk(3, -1))
        out = attention(q, k, v, scale, None, num).transpose(1, 2).reshape(x.shape)
        x = x + linear(out, p[b + "attn.proj.weight"], p[b + "attn.proj.bias"], num)
        x, size = bipartite_merge(x, size, k.mean(dim=1), r, follow, record)
        x = x + mlp(layer_norm(x, p[b + "norm2.weight"], p[b + "norm2.bias"], EPS), p, b + "mlp.", num)
    feats = layer_norm(x.mean(dim=1), p["fc_norm.weight"], p["fc_norm.bias"], EPS)
    return linear(feats, p["head.weight"], p["head.bias"], num)


@torch.no_grad()
def logits(p: dict, video: torch.Tensor, m: dict, r: int, num: Numerics = FP32, rows: int = 8,
           calls: list = None, record: list = None):
    """``forward`` in blocks of ``rows`` clips, so that it fits beside the
    program's leftovers; the merges follow ``calls`` (a whole batch's
    decisions) where given. Returns (logits, the widest decision gap)."""
    out, gap, blocks = [], 0.0, []
    for block in chunks(video.shape[0], rows):
        follow = Follow(calls, block) if calls is not None else None
        blocks.append([])
        out.append(forward(p, video[block], m, r, num, follow, blocks[-1]))
        if follow:
            follow.finish()
            gap = max(gap, follow.gap)
    if record is not None:
        record.extend(stitch(blocks))
    return torch.cat(out), gap
