"""Bipartite soft matching — the ToMe core — in PyTorch.

Port of ``vtm/merge/bipartite.py``: the balanced (even/odd) matcher in
modes ``merge``, ``random_merge``, ``drop``, ``random_drop`` and the
hybrid drop+merge, the kth and random-partition matchers, and the
functions that apply a matching (``merge``, ``unmerge``, ``drop``,
``merge_wavg``) or track which original tokens each group holds
(``merge_source``, ``drop_source``). Matching returns a ``Matching`` of
index tensors; the kth and random-partition matchers return closures, as
in the JAX package.

Numerics are held to the JAX package's so that merge decisions agree:
  * scores in fp32 from the metric cast to fp32, with TF32 off for the
    product;
  * ``argmax`` takes the first index; the descending sort is stable;
  * token sizes stay fp32; the merged-mass product rounds once in the
    compute dtype; the segment sum is a one-hot ``bmm`` (atomics would
    reorder the fp32 sums). ``amax``, ``prod`` and ``mean`` reductions
    are ``scatter_reduce(include_self=True)``: exact for ``amax``, and on
    CUDA ``prod`` and ``mean`` may differ in the last bit from run to run;
  * random scores are fp32 uniforms drawn by ``random_scores`` from an
    explicit ``torch.Generator`` (JAX's threefry and torch's Philox draw
    different numbers from one seed, so the random modes agree with
    ``vtm`` only given the same draws).

Token bookkeeping: tokens are split (even positions -> set A / "src",
odd -> set B / "dst"); each src's best dst is found by cosine
similarity; the r highest-scoring srcs are merged into (or dropped
for) their dsts; output order is [unmerged srcs (score-desc, or
index-asc when a class token is protected), dsts], with a distillation
token's dst (row 1) moved to position 1.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import torch

MERGE_MODES = ("merge", "random_merge")
DROP_MODES = ("drop", "random_drop")


@dataclasses.dataclass(frozen=True)
class Matching:
    """Result of a bipartite soft matching over ``n`` tokens.

    Index tensors (int64) all refer to rows of the even/odd split:
      unm_idx: [B, ta - r]  rows of A kept (in output order)
      src_idx: [B, r]       rows of A merged or dropped
      dst_idx: [B, r]       the B-row each merged src goes to
      src_score: [B, r]     each merged edge's score (fp32; the hybrid
                            mode's threshold reads it)
    """

    unm_idx: torch.Tensor
    src_idx: torch.Tensor
    dst_idx: torch.Tensor
    src_score: torch.Tensor
    n: int
    r: int
    distill_token: bool = False

    @property
    def out_tokens(self) -> int:
        return self.n - self.r


@contextlib.contextmanager
def _full_fp32():
    """TF32 off for the products inside: it would perturb near-tied
    scores enough to flip merge decisions, and round fp32 rows summed
    through a one-hot product."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _effective_r(n: int, r: int, class_token: bool, distill_token: bool = False) -> int:
    protected = int(class_token) + int(distill_token)
    return max(0, min(int(r), (n - protected) // 2))


def random_scores(shape: Tuple[int, ...], generator: Optional[torch.Generator]) -> torch.Tensor:
    """fp32 uniforms in [0, 1) of ``shape`` on ``generator``'s device: the
    scores of the random modes and the random partition, all drawn here."""
    if generator is None:
        raise ValueError("the random merge modes require a torch.Generator")
    return torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float32)


def _cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, ta, tb] cosine scores between rows of ``a`` and ``b`` of one
    fp32-normalised metric, in full fp32."""
    with _full_fp32():
        return torch.bmm(a, b.transpose(1, 2))


def _normalised(metric: torch.Tensor) -> torch.Tensor:
    m = metric.float()
    return m / torch.sqrt((m * m).sum(dim=-1, keepdim=True))


def _scores(
    metric: torch.Tensor,
    mode: str,
    class_token: bool,
    distill_token: bool,
    generator: Optional[torch.Generator],
) -> torch.Tensor:
    """[B, ta, tb] matching scores between the even (A) and odd (B) sets."""
    b, n, _ = metric.shape
    if mode.startswith("random"):
        scores = random_scores((b, n - n // 2, n // 2), generator)
    else:
        m = _normalised(metric)
        scores = _cosine(m[:, ::2, :], m[:, 1::2, :])
    if class_token:
        scores[:, 0, :] = -torch.inf
    if distill_token:
        scores[:, :, 0] = -torch.inf
    return scores


def _match(
    metric: torch.Tensor,
    r: int,
    class_token: bool,
    distill_token: bool,
    mode: str,
    generator: Optional[torch.Generator],
) -> Optional[Matching]:
    n = metric.shape[1]
    r = _effective_r(n, r, class_token, distill_token)
    if r <= 0:
        return None

    scores = _scores(metric, mode, class_token, distill_token, generator)
    node_max = scores.amax(dim=-1)  # [B, ta]
    node_idx = scores.argmax(dim=-1)  # [B, ta], first index on ties
    # stable: ties resolve to the lower src index, as jnp.argsort does
    edge_idx = torch.argsort(-node_max, dim=-1, stable=True)
    src_idx = edge_idx[:, :r]
    unm_idx = edge_idx[:, r:]
    if class_token:
        unm_idx = torch.sort(unm_idx, dim=-1).values
    return Matching(
        unm_idx=unm_idx,
        src_idx=src_idx,
        dst_idx=torch.gather(node_idx, 1, src_idx),
        src_score=torch.gather(node_max, 1, src_idx),
        n=n,
        r=r,
        distill_token=distill_token,
    )


def bipartite_soft_matching(
    metric: torch.Tensor,
    r: int,
    class_token: bool = False,
    distill_token: bool = False,
    mode: str = "merge",
    generator: Optional[torch.Generator] = None,
) -> Optional[Matching]:
    """ToMe matching with a balanced (even/odd) split over ``metric``
    [B, n, C]; a protected class token (row 0) and distillation token
    (row 1) are never merged. ``mode`` is 'merge' (cosine similarity) or
    'random_merge' (uniform scores from ``generator``). Returns None when
    the clamped r is zero (identity)."""
    if mode not in MERGE_MODES:
        raise ValueError(f"unsupported mode {mode!r}")
    return _match(metric, r, class_token, distill_token, mode, generator)


def bipartite_soft_matching_drop(
    metric: torch.Tensor,
    r: int,
    class_token: bool = False,
    distill_token: bool = False,
    mode: str = "drop",
    generator: Optional[torch.Generator] = None,
) -> Optional[Matching]:
    """The same matching; the top-r srcs are discarded (apply with
    :func:`drop`), not merged."""
    if mode not in DROP_MODES:
        raise ValueError(f"unsupported mode {mode!r}")
    return _match(metric, r, class_token, distill_token, mode, generator)


def bipartite_soft_matching_hybrid(
    metric: torch.Tensor,
    r: int,
    class_token: bool = False,
    distill_token: bool = False,
    mode: str = "merge",
    threshold: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> Optional[Matching]:
    """Hybrid drop+merge matching: the matching of
    :func:`bipartite_soft_matching`; the thresholded dst-zeroing happens
    in :func:`merge` and :func:`merge_wavg` through ``threshold=``."""
    del threshold  # applied at merge time
    if mode not in ("merge", "random_merge", "hybrid"):
        raise ValueError(f"unsupported mode {mode!r}")
    score_mode = "random_merge" if mode == "random_merge" else "merge"
    return _match(metric, r, class_token, distill_token, score_mode, generator)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather token rows: x [B, N, C], idx [B, K] -> [B, K, C]."""
    return torch.take_along_dim(x, idx[:, :, None], dim=1)


def _one_hot(idx: torch.Tensor, depth: int, dtype: torch.dtype) -> torch.Tensor:
    """[B, r] int -> [B, r, depth] one-hot."""
    iota = torch.arange(depth, device=idx.device)
    return (idx[:, :, None] == iota).to(dtype)


def _scatter(dst: torch.Tensor, dst_idx: torch.Tensor, src: torch.Tensor, mode: str) -> torch.Tensor:
    """Scatter-reduce ``src`` [B, r, C] into ``dst`` [B, tb, C] rows at
    ``dst_idx`` [B, r], the original dst value included in the reduction.
    ``sum`` is a one-hot product accumulated in fp32 and rounded once to
    dst's dtype."""
    if mode == "sum":
        oh_t = _one_hot(dst_idx, dst.shape[1], torch.float32).transpose(1, 2)  # [B, tb, r]
        with _full_fp32():
            add = torch.bmm(oh_t, src.float())
        return dst + add.to(dst.dtype)
    reduce = {"max": "amax", "amax": "amax", "prod": "prod", "mean": "mean"}.get(mode)
    if reduce is None:
        raise ValueError(f"unsupported reduce mode {mode!r}")
    index = dst_idx[:, :, None].expand(-1, -1, src.shape[-1])
    return dst.scatter_reduce(1, index, src, reduce=reduce, include_self=True)


def _dst_kept(m: Matching, tb: int, threshold: float) -> torch.Tensor:
    """[B, tb, 1] fp32: 0 for every dst that receives at least one edge
    scoring below ``threshold`` (the hybrid mode drops that group), else 1.
    The hit count is a one-hot product of 0/1 values, exact in fp32."""
    below = (m.src_score < threshold).float()  # [B, r]
    oh = _one_hot(m.dst_idx, tb, torch.float32)  # [B, r, tb]
    with _full_fp32():
        hits = torch.bmm(below[:, None, :], oh)[:, 0]  # [B, tb]
    return (hits == 0).float()[:, :, None]


def _interleave(m: Matching, kept: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """[kept srcs, dsts], a distillation token's dst moved to row 1."""
    if m.distill_token:
        return torch.cat([kept[:, :1], dst[:, :1], kept[:, 1:], dst[:, 1:]], dim=1)
    return torch.cat([kept, dst], dim=1)


def merge(
    m: Optional[Matching],
    x: torch.Tensor,
    mode: str = "mean",
    threshold: Optional[float] = None,
) -> torch.Tensor:
    """Apply a matching: [B, n, C] -> [B, n - r, C], reducing each dst
    with its merged srcs by ``mode`` (sum, mean, amax/max, prod).

    ``threshold`` gives the hybrid semantics: every dst that receives at
    least one merge edge scoring below it is zeroed before the reduction,
    so the sub-threshold group is dropped."""
    if m is None:
        return x
    src, dst = x[:, ::2, :], x[:, 1::2, :]
    if threshold is not None:
        dst = dst * _dst_kept(m, dst.shape[1], threshold).to(dst.dtype)
    unm = _gather(src, m.unm_idx)
    src = _gather(src, m.src_idx)
    return _interleave(m, unm, _scatter(dst, m.dst_idx, src, mode))


def unmerge(m: Optional[Matching], x: torch.Tensor) -> torch.Tensor:
    """Inverse layout of :func:`merge`: [B, n - r, C] -> [B, n, C], each
    dst value broadcast back to its merged srcs."""
    if m is None:
        return x
    unm_len = m.unm_idx.shape[1]
    unm, dst = x[:, :unm_len, :], x[:, unm_len:, :]
    src = _gather(dst, m.dst_idx)
    c = x.shape[-1]
    out = torch.zeros((x.shape[0], m.n, c), dtype=x.dtype, device=x.device)
    out[:, 1::2, :] = dst
    out.scatter_(1, (2 * m.unm_idx)[:, :, None].expand(-1, -1, c), unm)
    out.scatter_(1, (2 * m.src_idx)[:, :, None].expand(-1, -1, c), src)
    return out


def drop(m: Optional[Matching], x: torch.Tensor) -> torch.Tensor:
    """Apply a drop matching: keep the unmatched srcs and all dsts."""
    if m is None:
        return x
    src, dst = x[:, ::2, :], x[:, 1::2, :]
    return _interleave(m, _gather(src, m.unm_idx), dst)


def merge_wavg(
    m: Optional[Matching],
    x: torch.Tensor,
    size: Optional[torch.Tensor] = None,
    threshold: Optional[float] = None,
):
    """Size-weighted merge: returns (x_merged, size_merged).

    ``size`` [B, n, 1] (fp32) counts the original tokens each current
    token stands for. Unmerged srcs are plain row gathers; the mass
    multiply/divide runs over the r merged rows and the dst half only.
    ``threshold`` (hybrid) zeroes the mass and the size of every dst that
    receives a sub-threshold edge before the sum.
    """
    if size is None:
        size = torch.ones(x.shape[:2] + (1,), dtype=torch.float32, device=x.device)
    # sizes are token counts: bf16 cannot hold integers > 256 exactly
    size = size.float()
    if m is None:
        return x, size
    src_x, dst_x = x[:, ::2, :], x[:, 1::2, :]
    src_s, dst_s = size[:, ::2, :], size[:, 1::2, :]

    # one permutation gather for [kept | merged] src rows
    perm = torch.cat([m.unm_idx, m.src_idx], dim=1)
    gx = _gather(src_x, perm)
    gs = _gather(src_s, perm)
    n_unm = m.unm_idx.shape[1]
    unm_x, sel_x = gx[:, :n_unm], gx[:, n_unm:]
    unm_s, sel_s = gs[:, :n_unm], gs[:, n_unm:]

    if threshold is not None:
        keep = _dst_kept(m, dst_x.shape[1], threshold)
        dst_x = dst_x * keep.to(dst_x.dtype)
        dst_s = dst_s * keep

    sel_mass = sel_x * sel_s.to(x.dtype)
    oh_t = _one_hot(m.dst_idx, dst_x.shape[1], torch.float32).transpose(1, 2)  # [B, tb, r]
    # mass: compute dtype in and out, fp32 accumulation (one rounding);
    # size: exact fp32
    with _full_fp32():
        add_mass = torch.bmm(oh_t.to(x.dtype), sel_mass)
        add_size = torch.bmm(oh_t, sel_s)
    dst_size = dst_s + add_size
    dst_out = (dst_x * dst_s.to(x.dtype) + add_mass) / dst_size.to(x.dtype)
    return _interleave(m, unm_x, dst_out), _interleave(m, unm_s, dst_size)


def _identity_source(x: torch.Tensor) -> torch.Tensor:
    """[B, n, n] identity in ``x``'s dtype: each token holds itself."""
    bsz, t, _ = x.shape
    return torch.eye(t, dtype=x.dtype, device=x.device).expand(bsz, t, t)


def merge_source(
    m: Optional[Matching],
    x: torch.Tensor,
    source: Optional[torch.Tensor] = None,
    threshold: Optional[float] = None,
) -> torch.Tensor:
    """Track which original tokens make up each merged group: ``source``
    [B, n_t, n_0] (0/1, the identity in ``x``'s dtype on the first call)
    merged by ``amax``. ``threshold`` applies the hybrid dst-zeroing, so a
    dropped group shows an empty row."""
    if source is None:
        source = _identity_source(x)
    return merge(m, source, mode="amax", threshold=threshold)


def drop_source(
    m: Optional[Matching], x: torch.Tensor, source: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Source tracking for the drop modes: the drop applied to the source."""
    if source is None:
        source = _identity_source(x)
    return drop(m, source)


def kth_bipartite_soft_matching(metric: torch.Tensor, k: int):
    """Sets = (every k-th token as dst, the rest as src); n -> n / k.
    Returns (merge_fn, unmerge_fn) closures."""
    if k <= 1:
        return (lambda x, mode="mean": x), (lambda x: x)

    def split(x):
        t_rnd = (x.shape[1] // k) * k
        x = x[:, :t_rnd, :].reshape(x.shape[0], -1, k, x.shape[2])
        a = x[:, :, : k - 1, :].reshape(x.shape[0], -1, x.shape[-1])
        return a, x[:, :, k - 1, :]

    a, b = split(_normalised(metric))
    dst_idx = _cosine(a, b).argmax(dim=-1)  # [B, r]

    def merge_fn(x: torch.Tensor, mode: str = "mean") -> torch.Tensor:
        src, dst = split(x)
        return _scatter(dst, dst_idx, src, mode)

    def unmerge_fn(x: torch.Tensor) -> torch.Tensor:
        n, _, c = x.shape
        src = _gather(x, dst_idx).reshape(n, -1, k - 1, c)
        dst = x.reshape(n, -1, 1, c)
        return torch.cat([src, dst], dim=-2).reshape(n, -1, c)

    return merge_fn, unmerge_fn


def random_bipartite_soft_matching(
    metric: torch.Tensor, r: int, generator: Optional[torch.Generator]
):
    """Sets = (r randomly chosen tokens as src, the rest as dst), the
    partition drawn by ``random_scores``. Returns (merge_fn, unmerge_fn)."""
    if r <= 0:
        return (lambda x, mode="mean": x), (lambda x: x)

    bsz, n, _ = metric.shape
    rand_idx = torch.argsort(random_scores((bsz, n), generator), dim=1, stable=True)
    a_idx, b_idx = rand_idx[:, :r], rand_idx[:, r:]

    def split(x):
        return _gather(x, a_idx), _gather(x, b_idx)

    a, b = split(_normalised(metric))
    dst_idx = _cosine(a, b).argmax(dim=-1)

    def merge_fn(x: torch.Tensor, mode: str = "mean") -> torch.Tensor:
        src, dst = split(x)
        return _scatter(dst, dst_idx, src, mode)

    def unmerge_fn(x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        out = torch.zeros((bsz, n, c), dtype=x.dtype, device=x.device)
        out.scatter_(1, a_idx[:, :, None].expand(-1, -1, c), _gather(x, dst_idx))
        out.scatter_(1, b_idx[:, :, None].expand(-1, -1, c), x)
        return out

    return merge_fn, unmerge_fn
