"""Plain float32 building blocks of the references.

Written from the published equations (ViT blocks, ToMe's bipartite soft
matching and size-weighted merge), in PyTorch only: no kernel, no cache,
nothing of the program under test. Every product goes through a
``Numerics`` object, so the same code computes in float32 (TF32 off) or,
as the control, with both operands of every product of the model
(projections, the tubelet embedding, attention) rounded to fp8 e4m3 at a
per-tensor scale. The matching scores stay float32 in both.
"""

from __future__ import annotations

import contextlib
import math
import sys

import numpy as np
import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


class Numerics:
    """float32 products."""

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return t


class Fp8(Numerics):
    """The control: each operand of a product rounded to e4m3 at the scale
    that maps its largest magnitude to the format's largest value, as an
    fp8 path with per-tensor scales computes. The rounding passes the
    gradient straight through."""

    def q(self, t: torch.Tensor) -> torch.Tensor:
        scale = (t.detach().abs().amax().float() / E4M3_MAX).clamp(min=1e-30)
        rounded = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
        return t + (rounded - t).detach()


FP32 = Numerics()
NUMERICS = {"fp32": FP32, "fp8_e4m3": Fp8()}


@contextlib.contextmanager
def exact_fp32():
    """float32 products without TF32, whatever the process had set."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def linear(x, w, b, num: Numerics):
    y = torch.matmul(num.q(x), num.q(w).t())
    return y if b is None else y + b


def layer_norm(x, w, b, eps: float):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def mlp(x, p: dict, prefix: str, num: Numerics):
    h = F.gelu(linear(x, p[prefix + "fc1.weight"], p[prefix + "fc1.bias"], num))
    return linear(h, p[prefix + "fc2.weight"], p[prefix + "fc2.bias"], num)


def tubelet_embed(video, w, b, num: Numerics):
    """[B, T, H, W, C] -> [B, tokens, D], tokens in (t, h, w) order: a
    product of each non-overlapping tubelet with the filters."""
    bsz, t, hh, ww, c = video.shape
    d, _, kt, kh, kw = w.shape
    x = video.reshape(bsz, t // kt, kt, hh // kh, kh, ww // kw, kw, c)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(bsz, -1, c * kt * kh * kw)
    return linear(x, w.reshape(d, -1), b, num)


def split_heads(x, heads: int):
    bsz, n, d = x.shape
    return x.reshape(bsz, n, heads, d // heads).transpose(1, 2)


def attention(q, k, v, scale: float, key_bias, num: Numerics):
    """softmax(q k^T * scale + key_bias) v over [..., n, d]; key_bias
    broadcasts over the keys' axis."""
    logits = torch.matmul(num.q(q), num.q(k).transpose(-2, -1)) * scale
    if key_bias is not None:
        logits = logits + key_bias
    return torch.matmul(num.q(torch.softmax(logits, dim=-1)), num.q(v))


def sincos_table(n: int, d: int) -> torch.Tensor:
    """The fixed sin-cos position table of the original Transformer [n, d]."""
    pos = np.arange(n)[:, None]
    dim = np.arange(d)[None, :]
    angle = pos / np.power(10000.0, 2 * (dim // 2) / d)
    table = np.where(dim % 2 == 0, np.sin(angle), np.cos(angle))
    return torch.from_numpy(table.astype(np.float32))


class Follow:
    """The merge decisions another run made, for the reference to follow:
    ``calls`` holds, per merge in call order, (kept, src, dst) index tensors
    with one row per merged sequence of the whole batch; ``rows`` the rows
    of this block (a slice over the batch's sequences). Following, the
    reference judges each decision by its own float32 scores: ``gap`` is the
    widest amount by which a chosen edge's score lies below the best edge
    of its source, or a kept source's best score above a merged one's.

    The reference works out its own token schedule, and a decision outside
    it makes ``gap`` infinite (the reference then takes its own decision
    there and goes on): another number of merged tokens than the
    reference's r at that merge, kept and merged rows that are not a
    partition of set A, a destination outside set B, a merge for which the
    calls hold no call or too few rows, or a call left over once the
    forward is done (``finish``). ``faults`` says which."""

    def __init__(self, calls: list, rows: slice):
        self.calls, self.rows, self.i, self.gap, self.faults = calls, rows, 0, 0.0, []

    def fault(self, why: str) -> None:
        if not self.faults:
            print(f"portbench: a merge decision outside the reference's schedule: {why}", file=sys.stderr)
        self.gap = math.inf
        self.faults.append(why)

    def take(self):
        if self.i >= len(self.calls):
            self.fault(f"merge {self.i + 1} of the reference's schedule has no call")
            return None
        call = self.calls[self.i]
        self.i += 1
        if call[0].shape[0] < self.rows.stop:
            self.fault(f"call {self.i} holds {call[0].shape[0]} rows, not {self.rows.stop}")
            return None
        return tuple(t[self.rows] for t in call)

    def finish(self) -> None:
        if self.i != len(self.calls):
            self.fault(f"{len(self.calls)} calls, {self.i} merges in the reference's schedule")


def schedule_fault(given: tuple, bsz: int, r: int, n_a: int, n_b: int):
    """Why the decisions ``given`` (kept, src, dst) are not a merge of r of
    set A's n_a rows into set B's n_b, or None."""
    kept, src, dst = given
    if kept.dim() != 2 or src.dim() != 2 or dst.shape != src.shape or kept.shape[0] != bsz or src.shape[0] != bsz:
        return f"index shapes {tuple(kept.shape)}, {tuple(src.shape)}, {tuple(dst.shape)} for {bsz} rows"
    if src.shape[1] != r or kept.shape[1] != n_a - r:
        return f"{src.shape[1]} merged and {kept.shape[1]} kept of {n_a}; the reference's schedule merges {r}"
    rows = torch.sort(torch.cat([kept, src], 1), dim=1).values
    if not torch.equal(rows, torch.arange(n_a, device=rows.device).expand(bsz, -1)):
        return "kept and merged rows are not a partition of set A"
    if r and (int(dst.min()) < 0 or int(dst.max()) >= n_b):
        return "a destination outside set B"
    return None


def bipartite_merge(x, size, metric, r: int, follow: Follow = None, record: list = None):
    """ToMe's size-weighted merge of r tokens: x [B, n, C], size [B, n, 1]
    (None: every token stands for one), metric [B, n, c]. The even tokens
    (set A) each find their most similar odd token (set B) by cosine
    similarity; the r best-matched A tokens are averaged, weighted by size,
    into their B tokens. Returns (x, size) of n - r tokens ordered [A
    tokens kept, best score first; B tokens]. ``follow`` takes another
    run's decisions instead (``Follow``); ``record`` receives the decisions
    taken."""
    bsz, n, c = x.shape
    r = min(r, n // 2)
    if size is None:
        size = torch.ones((bsz, n, 1), dtype=torch.float32, device=x.device)
    if r <= 0:
        return x, size
    with torch.no_grad():
        m = metric.float()
        m = m / m.norm(dim=-1, keepdim=True)
        scores = torch.bmm(m[:, ::2], m[:, 1::2].transpose(1, 2))
        best, best_idx = scores.max(dim=-1)
        order = torch.argsort(best, dim=-1, descending=True, stable=True)
        kept, src = order[:, r:], order[:, :r]
        dst = torch.gather(best_idx, 1, src)
        given = follow.take() if follow is not None else None
        if given is not None:
            why = schedule_fault(given, bsz, r, scores.shape[1], scores.shape[2])
            if why:
                follow.fault(why)
                given = None
        if given is not None:
            kept, src, dst = given
            chosen = torch.gather(torch.gather(scores, 1, src[:, :, None].expand(-1, -1, scores.shape[2])), 2,
                                  dst[:, :, None])[:, :, 0]
            src_best = torch.gather(best, 1, src)
            order_gap = torch.gather(best, 1, kept).amax(dim=1) - src_best.amin(dim=1) if kept.shape[1] else 0 * best[:, 0]
            follow.gap = max(follow.gap, float((src_best - chosen).amax()), float(order_gap.clamp(min=0).amax()))
        if record is not None:
            record.append((kept, src, dst))
    xa, xb = x[:, ::2], x[:, 1::2]
    sa, sb = size[:, ::2], size[:, 1::2]

    def rows(t, idx):
        return torch.gather(t, 1, idx[:, :, None].expand(-1, -1, t.shape[-1]))

    # [B, tb, r]: which B token each merged A token joins
    onehot = (dst[:, None, :] == torch.arange(xb.shape[1], device=x.device)[None, :, None]).float()
    s_src = rows(sa, src)
    mass = torch.bmm(onehot, rows(xa, src) * s_src)
    added = torch.bmm(onehot, s_src)
    sb_new = sb + added
    xb_new = (xb * sb + mass) / sb_new
    return torch.cat([rows(xa, kept), xb_new], 1), torch.cat([rows(sa, kept), sb_new], 1)


def stitch(blocks: list) -> list:
    """Decisions recorded block by block -> one (kept, src, dst) a merge
    for the whole batch."""
    return [tuple(torch.cat(parts) for parts in zip(*merge)) for merge in zip(*blocks)]


def chunks(n: int, size: int):
    for start in range(0, n, size):
        yield slice(start, min(n, start + size))

