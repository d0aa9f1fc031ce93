"""Approximate spatial attention for Motionformer's trajectory attention,
in PyTorch.

Port of ``vtm/models/motionformer_approx.py``: Nyström attention
(``iterative_inv``, ``_segment_means``, ``nystrom_spatial_attn``),
Orthoformer (``orthogonal_landmarks``, ``orthoformer``) and Performer's
FAVOR+ (``create_projection_matrix``, ``softmax_kernel_transformation``,
``performer_attention``), selected by ``MOTIONFORMER.APPROX_ATTN_TYPE``.

Every attention takes flattened-head tensors ``[B*, N, D]`` (B* may hold
the head axis, N = F * P frame-major) and returns ``[B*, N, F, D]``: for
each query, the values aggregated over each frame, the shape the
trajectory step consumes. They are plain torch products, as the JAX
package's are plain einsums: no kernel of the port runs here.

Two draws cannot be the JAX package's, since torch's generators are not
JAX's threefry:
  * Orthoformer's first landmark is row 0, or one ``torch.randint`` draw
    from a given generator; ``init_idx`` puts in a chosen one.
  * Performer's projection is drawn from a seed that depends on q, as in
    the JAX package; ``projection`` puts in a chosen matrix.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

BIG_CONSTANT = 1e8
UINT32_MAX = 2**32 - 1


# -------------------------------------------------------------------- nystrom


def iterative_inv(mat: torch.Tensor, n_iter: int = 6) -> torch.Tensor:
    """Newton-Schulz pseudo-inverse of ``mat`` [..., L, L], ``n_iter``
    steps from the 'exact' start V = K^T / (max column sum * max row sum),
    in mat's dtype."""
    eye = torch.eye(mat.shape[-2], dtype=mat.dtype, device=mat.device)
    k_mat = mat
    v_mat = k_mat.transpose(-1, -2) / (
        k_mat.sum(dim=-2).amax(dim=-1)[..., None, None] * k_mat.sum(dim=-1).amax(dim=-1)[..., None, None]
    )
    for _ in range(n_iter):
        kv = k_mat @ v_mat
        v_mat = 0.25 * v_mat @ (13 * eye - kv @ (15 * eye - kv @ (7 * eye - kv)))
    return v_mat


def _segment_means(x: torch.Tensor, landmarks: int) -> torch.Tensor:
    """[B, N, D] -> [B, landmarks, D] segment means. Where ``landmarks``
    does not divide N, the first ``(segs + 1) * landmarks - N`` landmarks
    average ``segs = N // landmarks`` elements and the rest ``segs + 1``."""
    b, n, d = x.shape
    if n % landmarks == 0:
        return x.reshape(b, landmarks, n // landmarks, d).mean(dim=-2)
    segs = n // landmarks
    num_k = (segs + 1) * landmarks - n
    first = x[:, : num_k * segs].reshape(b, num_k, segs, d).mean(dim=-2)
    last = x[:, num_k * segs :].reshape(b, landmarks - num_k, segs + 1, d).mean(dim=-2)
    return torch.cat([first, last], dim=-2)


def nystrom_spatial_attn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    landmarks: int = 64,
    num_frames: Optional[int] = None,
    inv_iters: int = 6,
    use_spatial_landmarks: bool = True,
) -> torch.Tensor:
    """Space-time Nyström attention with a softmax per frame: q, k, v
    [B, N, D] with N = F * P -> [B, N, F, D]. ``use_spatial_landmarks``
    orders the tokens (p f) before the segment means, so each landmark
    averages spatial neighbours over time. Everything, the pseudo-inverse
    included, runs in q's dtype."""
    b, n, d = k.shape
    f = num_frames
    p = n // f
    q = q * d**-0.5

    if use_spatial_landmarks:
        def to_pf(t):
            return t.reshape(b, f, p, d).transpose(1, 2).reshape(b, n, d)

        q_land = _segment_means(to_pf(q), landmarks)
        k_land = _segment_means(to_pf(k), landmarks)
    else:
        q_land = _segment_means(q, landmarks)
        k_land = _segment_means(k, landmarks)

    kernel_1 = torch.softmax(q @ k_land.transpose(-1, -2), dim=-1)
    kernel_2 = torch.softmax(q_land @ k_land.transpose(-1, -2), dim=-1)
    kernel_3 = torch.softmax((q_land @ k.transpose(-1, -2)).reshape(b, landmarks, f, p), dim=-1)
    attn = kernel_1 @ iterative_inv(kernel_2, n_iter=inv_iters)
    lv = torch.einsum("blfp,bfpd->blfd", kernel_3, v.reshape(b, f, p, d))
    return torch.einsum("bnl,blfd->bnfd", attn, lv)


# ----------------------------------------------------------------- orthoformer


@torch.no_grad()
def greedy_landmark_order(
    q: torch.Tensor,
    num_landmarks: int = 64,
    init_idx: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The rows of q [B, N, D] that the greedy selection picks, [B, M] in
    the order picked. Starting from ``init_idx`` [B] (else one draw from
    ``generator``, else row 0), each step picks the row whose largest
    |cosine| to the rows picked so far is least; picked rows count as 10,
    and ties go to the first index. ``num_landmarks - 1`` dependent steps
    in q's dtype. A row's score is the running maximum of its |cosines|,
    which equals the JAX package's maximum over its table of them; a
    picked row's score is set to 10 and stays there (|cosine| <= 1)."""
    b, n, d = q.shape
    qk = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    if init_idx is None:
        if generator is not None:
            init_idx = torch.randint(0, n, (b,), generator=generator, device=generator.device)
        else:
            init_idx = torch.zeros(b, dtype=torch.long)
    cur = init_idx.to(device=q.device, dtype=torch.long)
    score = torch.full((b, n), -math.inf, dtype=q.dtype, device=q.device)
    order = [cur]
    for _ in range(1, num_landmarks):
        picked = qk.gather(1, cur[:, None, None].expand(b, 1, d))  # [B, 1, D]
        score = torch.maximum(score, torch.bmm(qk, picked.transpose(1, 2))[:, :, 0].abs())
        score.scatter_(1, cur[:, None], 10.0)
        cur = score.argmin(dim=-1)
        order.append(cur)
    return torch.stack(order, dim=1)


def orthogonal_landmark_indices(
    q: torch.Tensor,
    num_landmarks: int = 64,
    init_idx: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """``greedy_landmark_order``'s rows in index order, as the JAX package
    returns its landmarks."""
    return torch.sort(greedy_landmark_order(q, num_landmarks, init_idx, generator), dim=1).values


def orthogonal_landmarks(
    q: torch.Tensor,
    k: torch.Tensor,
    num_landmarks: int = 64,
    init_idx: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The landmark queries [B, M, D]: q's rows picked by
    ``orthogonal_landmark_indices``, in index order. ``k`` is unused, as in
    the JAX package."""
    idx = orthogonal_landmark_indices(q, num_landmarks, init_idx, generator)
    return torch.gather(q, 1, idx[:, :, None].expand(-1, -1, q.shape[-1]))


def orthoformer(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_landmarks: int = 64,
    num_frames: Optional[int] = None,
    init_idx: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Orthoformer attention through shared landmarks: q, k, v [B, N, D]
    -> [B, N, F, D]. q and k are scaled by D^-1/4; the landmarks carry no
    gradient (the JAX package's stop_gradient)."""
    b, n, d = k.shape
    f = num_frames
    scale = d**-0.25
    q = q * scale
    k = k * scale
    landmarks = orthogonal_landmarks(q, k, num_landmarks, init_idx, generator).detach()
    kernel_1 = torch.softmax(q @ landmarks.transpose(-1, -2), dim=-1)
    kernel_2 = torch.softmax((landmarks @ k.transpose(-1, -2)).reshape(b, num_landmarks, f, n // f), dim=-1)
    x = torch.einsum("blfp,bfpd->blfd", kernel_2, v.reshape(b, f, n // f, d))
    return torch.einsum("bnl,blfd->bnfd", kernel_1, x)


# ------------------------------------------------------------------ performer


def create_projection_matrix(m: int, d: int, generator: torch.Generator) -> torch.Tensor:
    """m x d block-orthogonal Gaussian projections, fp32 on the generator's
    device: each block of d rows is Q^T of the QR of a d x d Gaussian, and
    row i is scaled by the norm of a Gaussian d-vector (a chi(d) draw)."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, device=generator.device)

    blocks = []
    nb = m // d
    for _ in range(nb):
        blocks.append(torch.linalg.qr(normal(d, d))[0].T)
    rem = m - nb * d
    if rem > 0:
        blocks.append(torch.linalg.qr(normal(d, d))[0].T[:rem])
    proj = torch.cat(blocks, dim=0)
    return torch.linalg.vector_norm(normal(m, d), dim=1)[:, None] * proj


def softmax_kernel_transformation(
    data: torch.Tensor, is_query: bool, projection_matrix: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """FAVOR+ positive softmax features of ``data`` [B, N, H, D] under
    ``projection_matrix`` [m, D] -> [B, N, H, m]. The product with the fp32
    projection runs in fp32 (JAX's promotion of a bf16 operand); a query's
    stabiliser is its own maximum, a key's the maximum over N and m."""
    m = projection_matrix.shape[0]
    data_normalizer = 1.0 / math.sqrt(math.sqrt(data.shape[-1]))
    ratio = 1.0 / math.sqrt(m)
    dash = torch.einsum("bnhd,md->bnhm", (data_normalizer * data).float(), projection_matrix.float())
    diag = ((data * data).sum(dim=-1) * (data_normalizer**2) * 0.5).float()
    if is_query:
        stab = dash.amax(dim=-1, keepdim=True)
    else:
        stab = dash.amax(dim=(-1, -3), keepdim=True)
    return ratio * (torch.exp(dash - diag[..., None] - stab) + eps)


def projection_seed(q: torch.Tensor) -> int:
    """The seed the JAX package derives from q: ceil(|sum(q)| * 1e8),
    computed in q's dtype, cast to uint32. The cast saturates as XLA's
    does: a value above 2^32 - 1 gives 2^32 - 1 and NaN gives 0, so any q
    whose entries sum beyond about 43 in magnitude gets the seed
    4294967295 (the usual case at ViT-B width)."""
    value = torch.ceil(torch.abs(q.sum() * BIG_CONSTANT)).item()
    return 0 if math.isnan(value) else int(min(value, UINT32_MAX))


def performer_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_frames: int,
    m: int = 256,
    projection: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """FAVOR+ attention with a normaliser per frame: q, k, v [B, N, D] ->
    [B, N, F, D] in q's dtype (fp32 inside). ``projection`` [m, D] puts in a
    chosen matrix; without one it is drawn from ``projection_seed(q)``
    through a CPU ``torch.Generator``, Gaussians and QR on the CPU, then
    moved to q's device, so one seed gives one matrix on every device. The
    draws are torch's, not the JAX package's threefry ones."""
    b, n, d = q.shape
    f = num_frames
    if projection is None:
        generator = torch.Generator().manual_seed(projection_seed(q))
        projection = create_projection_matrix(m, d, generator)
    projection = projection.to(device=q.device, dtype=torch.float32)
    m = projection.shape[0]
    q_prime = softmax_kernel_transformation(q[:, :, None, :], True, projection)[:, :, 0]
    k_prime = softmax_kernel_transformation(k[:, :, None, :], False, projection)[:, :, 0]
    k_f = k_prime.reshape(b, f, n // f, m)
    v_f = v.float().reshape(b, f, n // f, d)
    kv = torch.einsum("bfnr,bfnd->bfrd", k_f, v_f)
    qkv = torch.einsum("bpr,bfrd->bpfd", q_prime, kv)
    normaliser = torch.einsum("bpr,bfr->bpf", q_prime, k_f.sum(dim=2))
    return (qkv / normaliser[..., None]).to(q.dtype)
