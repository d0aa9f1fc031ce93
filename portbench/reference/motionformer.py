"""Plain float32 Motionformer with trajectory attention and ToMe (Patrick
et al., NeurIPS 2021), from the equations, and its AdamW training step.

The tubelet embedding gives F frames of s patches, frame-major after a
class token; the position embedding is tiled over frames and the temporal
one repeated over space. A trajectory block, pre-norm:

* the class row attends over every token;
* each body query attends over the keys of each frame f (keys f*s ..
  (f+1)*s - 1) in its own softmax, with log(size) added to the keys'
  logits, giving one output per frame;
* along its trajectory: the query is ``proj_q`` of the token's output in
  its own frame (token // s), the keys the k half of ``proj_kv`` on its
  output in every frame, the values those outputs themselves (the released
  code's ``v=x``), one softmax over the F frames per head;
* ``proj`` of [class row, body], added to x;
* ToMe per pseudo-frame: the body regrouped so that pseudo-frame t holds
  the tokens at positions p*F + t, each merged by r on the mean over heads
  of its keys, weighted and tracked by size (the sizes of the next block's
  bias come from this grouping);
* the pre-norm MLP.

The class token through the final norm, ``pre_logits`` (linear and tanh)
and the head gives logits, to which the model as built from the config
applies a softmax before the loss. Parameter names follow the released
checkpoints.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.counts.motionformer import frames, spatial
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
    split_heads,
    stitch,
    tubelet_embed,
)

EPS = 1e-6
NO_DECAY = ("pos_embed", "cls_token", "temp_embed")  # the model's no-weight-decay names


def param_specs(m: dict):
    d, hidden = m["embed_dim"], int(m["embed_dim"] * m["mlp_ratio"])
    pt, ps = m["patch_size_temp"], m["patch_size"]
    specs = [("cls_token", (1, 1, d), 0.0), ("pos_embed", (1, spatial(m) + 1, d), 0.0),
             ("temp_embed", (1, frames(m), d), 0.0),
             ("patch_embed_3d.proj.weight", (d, 3, pt, ps, ps), 0.0), ("patch_embed_3d.proj.bias", (d,), 0.0)]
    for i in range(m["depth"]):
        p = f"blocks.{i}."
        specs += [(p + "norm1.weight", (d,), 1.0), (p + "norm1.bias", (d,), 0.0),
                  (p + "attn.qkv.weight", (3 * d, d), 0.0), (p + "attn.qkv.bias", (3 * d,), 0.0),
                  (p + "attn.proj_q.weight", (d, d), 0.0), (p + "attn.proj_q.bias", (d,), 0.0),
                  (p + "attn.proj_kv.weight", (2 * d, d), 0.0), (p + "attn.proj_kv.bias", (2 * d,), 0.0),
                  (p + "attn.proj.weight", (d, d), 0.0), (p + "attn.proj.bias", (d,), 0.0),
                  (p + "norm2.weight", (d,), 1.0), (p + "norm2.bias", (d,), 0.0),
                  (p + "mlp.fc1.weight", (hidden, d), 0.0), (p + "mlp.fc1.bias", (hidden,), 0.0),
                  (p + "mlp.fc2.weight", (d, hidden), 0.0), (p + "mlp.fc2.bias", (d,), 0.0)]
    specs += [("norm.weight", (d,), 1.0), ("norm.bias", (d,), 0.0)]
    if m.get("use_mlp"):
        specs += [("pre_logits.fc.weight", (d, d), 0.0), ("pre_logits.fc.bias", (d,), 0.0)]
    return specs + [("head.weight", (m["num_classes"], d), 0.0), ("head.bias", (m["num_classes"],), 0.0)]


def fold(body, f: int):
    """[B, P*F, C] -> [(B*F), P, C]: pseudo-frame t holds positions p*F + t."""
    b, n, c = body.shape
    return body.reshape(b, n // f, f, c).transpose(1, 2).reshape(b * f, n // f, c)


def unfold(x, b: int, f: int):
    """The inverse of ``fold``."""
    _, p, c = x.shape
    return x.reshape(b, f, p, c).transpose(1, 2).reshape(b, p * f, c)


def trajectory_block(x, size, p: dict, i: int, m: dict, r: int, num: Numerics, follow=None, record=None):
    d, heads, f = m["embed_dim"], m["num_heads"], frames(m)
    hd = d // heads
    scale = hd ** -0.5
    b, n, _ = x.shape
    nb = n - 1
    s = nb // f
    pre = f"blocks.{i}."
    a = pre + "attn."
    h = layer_norm(x, p[pre + "norm1.weight"], p[pre + "norm1.bias"], EPS)
    q, k, v = (split_heads(t, heads) for t in linear(h, p[a + "qkv.weight"], p[a + "qkv.bias"], num).chunk(3, -1))
    cls_out = attention(q[:, :, :1], k, v, scale, None, num).transpose(1, 2).reshape(b, 1, d)

    qb, kb, vb = q[:, :, 1:], k[:, :, 1:], v[:, :, 1:]
    logits = torch.matmul(num.q(qb), num.q(kb).transpose(-2, -1)) * scale  # [B, H, nb, nb]
    if size is not None:
        logits = logits + torch.log(unfold(size, b, f)[:, :, 0])[:, None, None, :]
    probs = torch.softmax(logits.reshape(b, heads, nb, f, s), dim=-1)
    # [B, H, nb, F, hd]: the body query's output in each frame
    per_frame = torch.einsum("bhqfn,bhfnd->bhqfd", num.q(probs), num.q(vb.reshape(b, heads, f, s, hd)))
    xq = per_frame.permute(0, 2, 3, 1, 4).reshape(b, nb, f, d)  # [B, nb, F, D]
    tok = torch.arange(nb, device=x.device)
    q2 = linear(xq[:, tok, tok // s], p[a + "proj_q.weight"], p[a + "proj_q.bias"], num) * scale
    k2 = linear(xq, p[a + "proj_kv.weight"][:d], p[a + "proj_kv.bias"][:d], num)
    logits2 = torch.einsum("bnfhc,bnhc->bnfh", num.q(k2.reshape(b, nb, f, heads, hd)),
                           num.q(q2.reshape(b, nb, heads, hd)))
    attn2 = torch.softmax(logits2, dim=2)
    body = torch.einsum("bnfh,bnfhc->bnhc", num.q(attn2), num.q(xq.reshape(b, nb, f, heads, hd)))
    out = linear(torch.cat([cls_out, body.reshape(b, nb, d)], 1), p[a + "proj.weight"], p[a + "proj.bias"], num)
    x = x + out
    if r > 0:
        merged, size = bipartite_merge(fold(x[:, 1:], f), size, fold(kb.mean(dim=1), f), r, follow, record)
        x = torch.cat([x[:, :1], unfold(merged, b, f)], 1)
    return x + mlp(layer_norm(x, p[pre + "norm2.weight"], p[pre + "norm2.bias"], EPS), p, pre + "mlp.", num), size


def forward(p: dict, video: torch.Tensor, m: dict, r: int, num: Numerics = FP32, follow: Follow = None,
            record: list = None) -> torch.Tensor:
    """Class probabilities [B, classes] of float32 ``video`` [B, T, H, W, 3];
    the merges follow ``follow`` where given and go to ``record``."""
    f, s = frames(m), spatial(m)
    emb = tubelet_embed(video, p["patch_embed_3d.proj.weight"], p["patch_embed_3d.proj.bias"], num)
    pos = p["pos_embed"]
    body_pos = pos[:, 1:].repeat(1, f, 1) + p["temp_embed"].repeat_interleave(s, dim=1)
    x = torch.cat([p["cls_token"].expand(emb.shape[0], -1, -1), emb], 1) + torch.cat([pos[:, :1], body_pos], 1)
    size = None
    for i in range(m["depth"]):
        x, size = trajectory_block(x, size, p, i, m, r, num, follow, record)
    feats = layer_norm(x, p["norm.weight"], p["norm.bias"], EPS)[:, 0]
    if m.get("use_mlp"):
        feats = torch.tanh(linear(feats, p["pre_logits.fc.weight"], p["pre_logits.fc.bias"], num))
    return torch.softmax(linear(feats, p["head.weight"], p["head.bias"], num), dim=-1)


def loss_and_grads(p: dict, video, labels, m: dict, r: int, num: Numerics = FP32, rows: int = 4,
                   calls: list = None, record: list = None):
    """The batch's mean cross-entropy (on the class probabilities, as the
    model hands them to the loss) and its gradient, in blocks of ``rows``
    clips so that it fits; the merges follow ``calls`` (a whole batch's
    decisions, F pseudo-frames a clip) where given and go to ``record``.
    Returns (loss, {name: gradient}, the widest decision gap)."""
    leaves = {k: t.detach().requires_grad_(True) for k, t in p.items()}
    grads = {k: torch.zeros_like(t) for k, t in p.items()}
    total, gap, blocks = 0.0, 0.0, []
    bsz, f = video.shape[0], frames(m)
    for sl in chunks(bsz, rows):
        follow = Follow(calls, slice(sl.start * f, sl.stop * f)) if calls is not None else None
        blocks.append([])
        out = forward(leaves, video[sl], m, r, num, follow, blocks[-1])
        loss = F.cross_entropy(out, labels[sl], reduction="sum") / bsz
        for k, g in zip(leaves, torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)):
            if g is not None:
                grads[k] += g
        total += float(loss.detach())
        if follow:
            follow.finish()
            gap = max(gap, follow.gap)
    if record is not None:
        record.extend(stitch(blocks))
    return total, grads, gap


class AdamW:
    """Decoupled weight decay Adam (Loshchilov and Hutter), written out:
    p <- p (1 - lr wd); m, v the moving averages of g and g^2; p <- p - lr
    m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, p: dict, lr: float, wd: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.betas, self.eps, self.t = lr, betas, eps, 0
        self.wd = {k: 0.0 if any(n in k for n in NO_DECAY) else wd for k in p}
        self.m = {k: torch.zeros_like(t) for k, t in p.items()}
        self.v = {k: torch.zeros_like(t) for k, t in p.items()}

    @torch.no_grad()
    def step(self, p: dict, grads: dict) -> None:
        b1, b2 = self.betas
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, g in grads.items():
            p[k].mul_(1 - self.lr * self.wd[k])
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            p[k].sub_(self.lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps))


def leaf_norms(tensors: dict) -> dict:
    return {k: math.sqrt(float(t.double().square().sum())) for k, t in tensors.items()}
