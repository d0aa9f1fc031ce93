"""Fused attention kernels for the ToMe video transformers.

K1, ``tome_flash_attention``: softmax(q k^T * sm_scale + key_bias) v over
[B, H, N, d], the counterpart of ``vtm/ops/flash_attention.py::
tome_flash_attention``; kernel ``csrc/flash_attention_fwd.cu``. It is
differentiable: a ``torch.autograd.Function`` whose backward is K2. When a
gradient is wanted it also writes each row's log-sum-exp (``lse``).

K2, ``tome_flash_attention_backward``: dq, dk, dv and dbias of K1 from
(q, k, v, key_bias, do) and the forward's residuals (out, lse): it
recomputes the logits, takes p = exp(s - lse) and delta = rowsum(do * out)
instead of a statistics pass (the counterpart of ``vtm``'s ``_backward``);
kernel ``csrc/flash_attention_bwd.cu``.

K3, ``tome_frame_attention``: the same with a separate softmax over each
frame's contiguous key segment, returning token-major [B, N, F, H, d]
(Motionformer's trajectory attention), the counterpart of ``vtm``'s
``tome_frame_attention``; kernel ``csrc/frame_attention_fwd.cu``. It is
differentiable: a ``torch.autograd.Function`` whose backward is K4. When a
gradient is wanted it also writes each row's log-sum-exp in each frame.

K4, ``tome_frame_attention_backward``: dq, dk, dv and dbias of K3 from
(q, k, v, key_bias, do) and the forward's residuals (out, lse): it
recomputes the logits, takes p = exp(s - lse_f) and delta_f = rowsum(do_f
* out_f) per frame (the counterpart of ``vtm``'s ``_frame_bwd``, for every
head count and frame length); kernel ``csrc/frame_attention_bwd.cu``.

K5a, ``tome_blockdiag_attention``: block-diagonal per-frame attention
(the queries of frame f attend only to the keys of frame f; TimeSformer's
divided spatial attention), optionally with the key bias kept off row 0 of
every frame, returning token-major [B, N, H*d]; the counterpart of
``vtm``'s ``tome_blockdiag_attention``; kernel
``csrc/blockdiag_attention_fwd.cu``. It is differentiable: a
``torch.autograd.Function`` whose backward is K5b. When a gradient is
wanted it also writes each row's log-sum-exp.

K5b, ``tome_blockdiag_attention_backward``: dq, dk, dv and dbias of K5a
from (q, k, v, key_bias, do) and the forward's residuals (out, lse), in
K2's residual form per frame (the counterpart of ``vtm``'s
``_blockdiag_backward``); kernel ``csrc/blockdiag_attention_bwd.cu``, on
K5a's launch plan. Both take any frame length.

None writes the [B, H, N, N] logits to device memory. The kernels are
CUDA C++ for Hopper, built and bound by ``vtm_torch/ops/build.py``.

A tensor on the CPU goes to the plain PyTorch version of the same math
(``_reference``, ``_backward_reference``, ``_frame_reference``,
``_frame_backward_reference``, ``_blockdiag_reference``,
``_blockdiag_backward_reference``). A CUDA tensor goes to the kernel, or the
call raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

# Kernel launches since import (or since a caller reset them to 0):
# K1 (tome_flash_attention), K2 (its backward), K3 (tome_frame_attention),
# K4 (its backward), K5a (tome_blockdiag_attention) and K5b (its backward).
LAUNCHES = 0
BWD_LAUNCHES = 0
FRAME_LAUNCHES = 0
FRAME_BWD_LAUNCHES = 0
BLOCKDIAG_LAUNCHES = 0
BLOCKDIAG_BWD_LAUNCHES = 0

# Open FLOP counts (``utils/model_info.py::flop_count``): each forward
# launch of K1, K3 and K5a adds its products, 4 * B * H * Nq * Nk * d (two
# for q k^T, two for p v), to every list here. ``FlopCounterMode`` sees the
# plain versions' products on the CPU, not a ctypes launch.
PRODUCT_COUNTS: list = []


def _count_products(flops: int) -> None:
    for counts in PRODUCT_COUNTS:
        counts.append(flops)


_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
HEAD_DIMS = (16, 32, 64, 128)
_ALIGN = 16  # bytes: the kernel stages rows with 16-byte loads
_MAX_GRID_Y = 65535  # batch * heads is the grid's y extent
MAX_FRAME_LEN = 512  # K3's fp32 body keeps one frame's [64 x s] fp32 logits in shared memory
_MAX_GRID_X = 2**31 - 1  # K5a, K5b: the blocks of one (batch, head) pair are the grid's x extent
_TILE = 64  # query rows of a tile, keys of a key tile


def _reference(q, k, v, key_bias, sm_scale, want_lse=False):
    """Plain version: fp32 logits, fp32 softmax, probabilities in v's
    dtype before the product with v (vtm/ops/flash_attention.py:355-362).
    With ``want_lse`` returns (out, lse), lse the fp32 [B, H, N]
    log-sum-exp of each row's logits."""
    logits = torch.matmul((q * sm_scale).float(), k.float().transpose(-2, -1))
    if key_bias is not None:
        logits = logits + key_bias.float()[:, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v)
    return (out, torch.logsumexp(logits, dim=-1)) if want_lse else out


def check_kernel_args(q, k, v, key_bias) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, N, d], got shape {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v shapes differ: {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be bfloat16 or float32, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, n, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if n < 1 or b * h < 1 or b * h > _MAX_GRID_Y:
        raise ValueError(f"unsupported B*H={b * h}, N={n}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        size = t.element_size()
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim, strides {t.stride()}")
        if t.data_ptr() % _ALIGN or any((s * size) % _ALIGN for s in t.stride()[:3]):
            raise ValueError(f"{name} data and strides must be {_ALIGN}-byte aligned")
    if key_bias is not None:
        if key_bias.shape != (b, n) or key_bias.dtype != torch.float32:
            raise ValueError(f"key_bias must be float32 [{b}, {n}], got {key_bias.dtype} {tuple(key_bias.shape)}")
        if key_bias.device != q.device or not key_bias.is_contiguous():
            raise ValueError("key_bias must be contiguous on q's device")
    if not (q.device == k.device == v.device and q.device.type == "cuda"):
        raise ValueError(f"q, k, v must share one CUDA device, got {q.device}, {k.device}, {v.device}")


def _forward(q, k, v, key_bias, sm_scale, want_lse=False):
    """K1 on a CUDA tensor, its plain version on a CPU tensor. With
    ``want_lse`` returns (out, lse), lse float32 [B, H, N]."""
    global LAUNCHES
    if not q.is_cuda:
        return _reference(q, k, v, key_bias, sm_scale, want_lse)
    check_kernel_args(q, k, v, key_bias)
    from vtm_torch.ops.build import load_library

    lib = load_library()
    b, h, n, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device) if want_lse else None
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    with torch.cuda.device(q.device):
        err = lib.vtm_attention_fwd(
            _DTYPE_CODES[q.dtype], d,
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if key_bias is None else key_bias.data_ptr(),
            out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, h, n, float(sm_scale),
            ctypes.addressof(strides),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed with cudaError_t {err}")
    LAUNCHES += 1
    _count_products(4 * b * h * n * n * d)
    return (out, lse) if want_lse else out


def _backward_reference(q, k, v, key_bias, do, sm_scale, out=None, lse=None):
    """Plain version of K2, step by step with the TPU kernel's rounding
    points (vtm/ops/flash_attention.py:386-440, 535-542): fp32 logits from
    the unscaled q, fp32 softmax, dp and ds; p and ds rounded to the input
    dtype before the three products, whose fp32 sums are cast at the end;
    dbias from the unrounded ds, summed over queries and heads.

    Given the forward's residuals ``out`` and ``lse`` it takes the
    kernel's arithmetic: p = exp(s - lse) and delta = rowsum(do * out) in
    fp32, out read in its own dtype. Without them p is the softmax of s
    and delta = rowsum(p * dp), as in the TPU kernel.
    Returns (dq, dk, dv, dbias); dbias is None without a key_bias."""
    dtype = q.dtype
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-2, -1)) * sm_scale
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    dp = torch.matmul(dof, vf.transpose(-2, -1))
    if out is None or lse is None:
        p = torch.softmax(s, dim=-1)
        delta = (p * dp).sum(dim=-1, keepdim=True)
    else:
        p = torch.exp(s - lse.float()[..., None])
        delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    p_lo = p.to(dtype).float()
    ds_lo = ds.to(dtype).float()
    dq = (torch.matmul(ds_lo, kf) * sm_scale).to(dtype)
    dk = (torch.matmul(ds_lo.transpose(-2, -1), qf) * sm_scale).to(dtype)
    dv = torch.matmul(p_lo.transpose(-2, -1), dof).to(dtype)
    dbias = None if key_bias is None else ds.sum(dim=(1, 2)).to(key_bias.dtype)
    return dq, dk, dv, dbias


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels read it (last dim contiguous, 16-byte aligned
    rows), copied only when it is not already so."""
    size = t.element_size()
    if (
        t.stride(-1) != 1
        or t.data_ptr() % _ALIGN
        or any((s * size) % _ALIGN for s in t.stride()[:-1])
    ):
        return t.contiguous()
    return t


def _gradient_buffers(q: torch.Tensor, want_dbias: bool):
    """What a backward kernel writes: dq, dk, dv as [B, H, N, d] views of
    one token-major [B, N, 3, H, d] buffer, and the per-head dbias
    [B, H, N] in float32 (None when not wanted)."""
    b, h, n, d = q.shape
    grads = torch.empty((b, n, 3, h, d), dtype=q.dtype, device=q.device)
    dq, dk, dv = (grads[:, :, i].transpose(1, 2) for i in range(3))
    dbias_heads = torch.empty((b, h, n), dtype=torch.float32, device=q.device) if want_dbias else None
    return dq, dk, dv, dbias_heads


def tome_flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_bias: Optional[torch.Tensor],
    do: torch.Tensor,
    sm_scale: float = 1.0,
    need_dbias: bool = True,
    out: Optional[torch.Tensor] = None,
    lse: Optional[torch.Tensor] = None,
):
    """Gradients of ``tome_flash_attention`` given ``do`` = d loss / d out.

    q, k, v, key_bias as in the forward; do: [B, H, N, d] in q's dtype, any
    strides (the gradient of the token-major output view needs no copy).
    ``out`` and ``lse`` are the forward's residuals (its output and the
    float32 [B, H, N] row log-sum-exp of ``_forward(..., want_lse=True)``);
    when either is missing K1 runs first to make them.
    Returns (dq, dk, dv, dbias): dq, dk, dv are [B, H, N, d] views of one
    token-major [B, N, 3, H, d] buffer, so the gradient of a fused qkv
    projection's ``chunk`` is that buffer; dbias is float32 [B, N] (summed
    over heads and queries), or None when there is no key_bias or
    ``need_dbias`` is False.
    """
    global BWD_LAUNCHES
    if out is None or lse is None:
        out, lse = _forward(q, k, v, key_bias, sm_scale, want_lse=True)
    if not q.is_cuda:
        dq, dk, dv, dbias = _backward_reference(q, k, v, key_bias, do, sm_scale, out, lse)
        return dq, dk, dv, dbias if need_dbias else None
    check_kernel_args(q, k, v, key_bias)
    b, h, n, d = q.shape
    for name, t, dtype in (("do", do, q.dtype), ("out", out, q.dtype)):
        if t.shape != q.shape or t.dtype != dtype or t.device != q.device:
            raise ValueError(
                f"{name} must match q: {t.dtype} {tuple(t.shape)} on {t.device} "
                f"against {q.dtype} {tuple(q.shape)} on {q.device}"
            )
    if lse.shape != (b, h, n) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be float32 [{b}, {h}, {n}] on {q.device}, got {lse.dtype} {tuple(lse.shape)}")
    do, out, lse = _kernel_operand(do), _kernel_operand(out), lse.contiguous()
    from vtm_torch.ops.build import load_library

    lib = load_library()
    dq, dk, dv, dbias_heads = _gradient_buffers(q, need_dbias and key_bias is not None)
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3], *out.stride()[:3],
        *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
    )
    with torch.cuda.device(q.device):
        err = lib.vtm_attention_bwd(
            _DTYPE_CODES[q.dtype], d,
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if key_bias is None else key_bias.data_ptr(),
            do.data_ptr(), out.data_ptr(), lse.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if dbias_heads is None else dbias_heads.data_ptr(),
            delta.data_ptr(),
            b, h, n, float(sm_scale),
            ctypes.addressof(strides),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"attention backward kernel launch failed with cudaError_t {err}")
    BWD_LAUNCHES += 1
    dbias = None if dbias_heads is None else dbias_heads.sum(dim=1).to(key_bias.dtype)
    return dq, dk, dv, dbias


def _grad_wanted(*tensors) -> bool:
    """Whether autograd records a call on ``tensors`` (None entries
    skipped): only then do the forwards write the lse residual."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K2 backward. When a gradient is wanted the forward
    also writes the row log-sum-exp, and the Function saves (q, k, v,
    key_bias, out, lse): the backward recomputes the logits but takes the
    row statistics from the residuals. ``out`` is the token-major buffer
    whose [B, N, H*d] view the output projection's Linear keeps for its
    own backward, so saving it costs no memory of its own; lse is fp32
    [B, H, N], 1/32 of q's size in bf16 at d = 64. Serving (no gradient
    wanted) does not reach the Function: ``tome_flash_attention`` calls K1
    without the lse."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, sm_scale):
        ctx.sm_scale = sm_scale
        out, lse = _forward(q, k, v, key_bias, sm_scale, want_lse=True)
        ctx.save_for_backward(q, k, v, key_bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_bias, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias = tome_flash_attention_backward(
            q, k, v, key_bias, do, ctx.sm_scale, need_dbias=ctx.needs_input_grad[3], out=out, lse=lse
        )
        return dq, dk, dv, dbias, None


def tome_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_bias: Optional[torch.Tensor] = None,
    sm_scale: float = 1.0,
) -> torch.Tensor:
    """softmax(q k^T * sm_scale + key_bias[:, None, None, :]) v.

    q, k, v: [B, H, N, d] in bfloat16 or float32, last dim contiguous
    (row strides are passed to the kernel, so the ``split_heads`` view of
    a fused qkv projection needs no copy). key_bias: float32 [B, N] (log
    token sizes) or None. Returns [B, H, N, d] in q's dtype, a view of a
    token-major [B, N, H, d] buffer so ``merge_heads`` needs no copy.
    Gradients with respect to q, k, v and key_bias come from K2
    (``tome_flash_attention_backward``).
    """
    if not _grad_wanted(q, k, v, key_bias):
        return _forward(q, k, v, key_bias, sm_scale)
    return _FlashAttention.apply(q, k, v, key_bias, sm_scale)


def _frame_reference(q, k, v, key_bias, sm_scale, frames, want_lse=False):
    """Plain version of K3 (vtm/ops/flash_attention.py:1276-1286): q*scale
    in q's dtype, fp32 logits plus the key bias, a softmax per frame's
    contiguous key segment in fp32, probabilities in v's dtype before the
    product with v. Returns [B, N, F, H, d]; with ``want_lse`` (out, lse),
    lse the fp32 [B, H, F, N] log-sum-exp of each row's logits in each
    frame."""
    b, h, n, d = q.shape
    s = n // frames
    logits = torch.matmul((q * sm_scale).float(), k.float().transpose(-2, -1))
    if key_bias is not None:
        logits = logits + key_bias.float()[:, None, None, :]
    logits = logits.view(b, h, n, frames, s)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqfn,bhfnd->bqfhd", probs, v.reshape(b, h, frames, s, d))
    if not want_lse:
        return out
    return out, torch.logsumexp(logits, dim=-1).transpose(2, 3).contiguous()


def check_frame_kernel_args(q, k, v, key_bias, frames: int) -> None:
    """Raise ValueError on anything the K3 kernel does not take."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, N, d], got shape {tuple(q.shape)}")
    n = q.shape[2]
    if frames < 1 or n % frames:
        raise ValueError(f"frames={frames} does not divide N={n}")
    if n // frames > MAX_FRAME_LEN:
        raise ValueError(f"{n // frames} keys per frame exceed the kernel's {MAX_FRAME_LEN}")
    check_kernel_args(q, k, v, key_bias)


def _frame_forward(q, k, v, key_bias, sm_scale, frames, want_lse=False):
    """K3 on a CUDA tensor, its plain version on a CPU tensor. With
    ``want_lse`` returns (out, lse), lse float32 [B, H, F, N]."""
    global FRAME_LAUNCHES
    if not q.is_cuda:
        return _frame_reference(q, k, v, key_bias, sm_scale, frames, want_lse)
    check_frame_kernel_args(q, k, v, key_bias, frames)
    from vtm_torch.ops.build import load_library

    lib = load_library()
    b, h, n, d = q.shape
    out = torch.empty((b, n, frames, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, frames, n), dtype=torch.float32, device=q.device) if want_lse else None
    ob, orow, oframe, ohead = out.stride()[:4]
    strides = (ctypes.c_longlong * 13)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], ob, ohead, orow, oframe
    )
    with torch.cuda.device(q.device):
        err = lib.vtm_frame_attention_fwd(
            _DTYPE_CODES[q.dtype], d,
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if key_bias is None else key_bias.data_ptr(),
            out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, h, n, frames, float(sm_scale),
            ctypes.addressof(strides),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"frame attention kernel launch failed with cudaError_t {err}")
    FRAME_LAUNCHES += 1
    _count_products(4 * b * h * n * n * d)  # every key of every frame
    return (out, lse) if want_lse else out


def _frame_backward_reference(q, k, v, key_bias, do, sm_scale, frames, out=None, lse=None):
    """Plain version of K4, step by step with the TPU kernel's rounding
    points (vtm/ops/flash_attention.py:1113-1200, 1261-1273), per frame f
    with keys [f*s, (f+1)*s): fp32 logits from the unscaled q, an fp32
    softmax over the frame, dp = do_f v_f^T and ds = p (dp - rowsum(p dp))
    in fp32; p and ds rounded to the input dtype before the three
    products, whose fp32 sums (dq over frames and keys, dk and dv over
    queries) are cast at the end; dbias from the unrounded ds, summed over
    queries and heads. ``do`` is the token-major cotangent [B, N, F, H, d].

    Given the forward's residuals ``out`` (token-major [B, N, F, H, d]) and
    ``lse`` (fp32 [B, H, F, N]) it takes the kernel's arithmetic: p =
    exp(s - lse_f) and delta_f = rowsum(do_f * out_f) in fp32, out read in
    its own dtype. Returns (dq, dk, dv, dbias); dbias is None without a
    key_bias."""
    dtype = q.dtype
    b, h, n, d = q.shape
    s = n // frames
    qf, dof = q.float(), do.float()
    kf, vf = (t.float().reshape(b, h, frames, s, d) for t in (k, v))
    sf = torch.einsum("bhqd,bhfkd->bhqfk", qf, kf) * sm_scale
    if key_bias is not None:
        sf = sf + key_bias.float().view(b, 1, 1, frames, s)
    dp = torch.einsum("bqfhd,bhfkd->bhqfk", dof, vf)
    if out is None or lse is None:
        p = torch.softmax(sf, dim=-1)
        delta = (p * dp).sum(dim=-1, keepdim=True)
    else:
        p = torch.exp(sf - lse.float().transpose(2, 3)[..., None])
        delta = (dof * out.float()).sum(dim=-1).permute(0, 3, 1, 2)[..., None]
    ds = p * (dp - delta)
    p_lo = p.to(dtype).float()
    ds_lo = ds.to(dtype).float()
    dq = (torch.einsum("bhqfk,bhfkd->bhqd", ds_lo, kf) * sm_scale).to(dtype)
    dk = (torch.einsum("bhqfk,bhqd->bhfkd", ds_lo, qf) * sm_scale).reshape(b, h, n, d).to(dtype)
    dv = torch.einsum("bhqfk,bqfhd->bhfkd", p_lo, dof).reshape(b, h, n, d).to(dtype)
    dbias = None if key_bias is None else ds.sum(dim=(1, 2)).reshape(b, n).to(key_bias.dtype)
    return dq, dk, dv, dbias


def tome_frame_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_bias: Optional[torch.Tensor],
    do: torch.Tensor,
    sm_scale: float = 1.0,
    frames: int = 8,
    need_dbias: bool = True,
    out: Optional[torch.Tensor] = None,
    lse: Optional[torch.Tensor] = None,
):
    """Gradients of ``tome_frame_attention`` given ``do`` = d loss / d out.

    q, k, v, key_bias as in the forward; do: token-major [B, N, F, H, d] in
    q's dtype, last dim contiguous (read through its strides: no
    head-major transpose). ``out`` and ``lse`` are the forward's residuals
    (its token-major output and the float32 [B, H, F, N] per-frame row
    log-sum-exp of ``_frame_forward(..., want_lse=True)``); when either is
    missing K3 runs first to make them. Returns (dq, dk, dv, dbias): dq,
    dk, dv are [B, H, N, d] views of one token-major [B, N, 3, H, d]
    buffer; dbias is float32 [B, N] (summed over heads and queries), or
    None when there is no key_bias or ``need_dbias`` is False.
    """
    global FRAME_BWD_LAUNCHES
    if out is None or lse is None:
        out, lse = _frame_forward(q, k, v, key_bias, sm_scale, frames, want_lse=True)
    if not q.is_cuda:
        dq, dk, dv, dbias = _frame_backward_reference(q, k, v, key_bias, do, sm_scale, frames, out, lse)
        return dq, dk, dv, dbias if need_dbias else None
    check_frame_kernel_args(q, k, v, key_bias, frames)
    b, h, n, d = q.shape
    for name, t in (("do", do), ("out", out)):
        if t.shape != (b, n, frames, h, d) or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name} must be {q.dtype} {(b, n, frames, h, d)} on {q.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if lse.shape != (b, h, frames, n) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(
            f"lse must be float32 {(b, h, frames, n)} on {q.device}, got {lse.dtype} {tuple(lse.shape)}"
        )
    do, out, lse = _kernel_operand(do), _kernel_operand(out), lse.contiguous()
    from vtm_torch.ops.build import load_library

    lib = load_library()
    dq, dk, dv, dbias_heads = _gradient_buffers(q, need_dbias and key_bias is not None)
    delta = torch.empty((b, h, frames, n), dtype=torch.float32, device=q.device)
    token_major = [(t.stride(0), t.stride(3), t.stride(1), t.stride(2)) for t in (do, out)]
    strides = (ctypes.c_longlong * 26)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *token_major[0], *token_major[1],
        *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
    )
    with torch.cuda.device(q.device):
        err = lib.vtm_frame_attention_bwd(
            _DTYPE_CODES[q.dtype], d,
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if key_bias is None else key_bias.data_ptr(),
            do.data_ptr(), out.data_ptr(), lse.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if dbias_heads is None else dbias_heads.data_ptr(),
            delta.data_ptr(),
            b, h, n, frames, float(sm_scale),
            ctypes.addressof(strides),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"frame attention backward kernel launch failed with cudaError_t {err}")
    FRAME_BWD_LAUNCHES += 1
    dbias = None if dbias_heads is None else dbias_heads.sum(dim=1).to(key_bias.dtype)
    return dq, dk, dv, dbias


class _FrameAttention(torch.autograd.Function):
    """K3 forward, K4 backward. The forward also writes each row's
    log-sum-exp in each frame, and the Function saves (q, k, v, key_bias,
    out, lse): the backward recomputes the logits but takes the row
    statistics from the residuals. Motionformer's temporal step feeds
    ``out`` to a Linear and a product that keep it for their own backward,
    so saving it costs no memory of its own; lse is fp32 [B, H, F, N], F/32
    of q's size in bf16 at d = 64. Serving (no gradient wanted) does not
    reach the Function: ``tome_frame_attention`` calls K3 without the lse."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, sm_scale, frames):
        out, lse = _frame_forward(q, k, v, key_bias, sm_scale, frames, want_lse=True)
        ctx.save_for_backward(q, k, v, key_bias, out, lse)
        ctx.sm_scale, ctx.frames = sm_scale, frames
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_bias, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias = tome_frame_attention_backward(
            q, k, v, key_bias, do, ctx.sm_scale, ctx.frames, need_dbias=ctx.needs_input_grad[3],
            out=out, lse=lse,
        )
        return dq, dk, dv, dbias, None, None


def tome_frame_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_bias: Optional[torch.Tensor] = None,
    sm_scale: float = 1.0,
    frames: int = 8,
) -> torch.Tensor:
    """Per-frame softmax attention: for each query and each frame f, a
    softmax over the keys [f*s, (f+1)*s) (s = N / frames) of
    q k^T * sm_scale + key_bias, times those keys' values.

    q, k, v: [B, H, N, d] in bfloat16 or float32, last dim contiguous (the
    ``split_heads`` views of a fused projection go in without a copy).
    key_bias: float32 [B, N] or None. Returns token-major [B, N, F, H, d]
    in q's dtype, so the [B, N, F, H*d] view is free. Gradients with
    respect to q, k, v and key_bias come from K4
    (``tome_frame_attention_backward``).
    """
    if not _grad_wanted(q, k, v, key_bias):
        return _frame_forward(q, k, v, key_bias, sm_scale, frames)
    return _FrameAttention.apply(q, k, v, key_bias, sm_scale, frames)


def _blockdiag_reference(q, k, v, key_bias, sm_scale, frames, exclude_first_row=False, want_lse=False):
    """Plain version of K5a (vtm/ops/flash_attention.py:1624-1644): per
    frame of s = N / frames tokens, q*scale in q's dtype, fp32 logits plus
    the key bias (on rows > 0 of each frame only with
    ``exclude_first_row``), an fp32 softmax over the frame's keys,
    probabilities in v's dtype before the product with v. Returns
    token-major [B, N, H*d]; with ``want_lse`` (out, lse), lse the fp32
    [B, H, N] log-sum-exp of each row's logits over its frame's keys."""
    b, h, n, d = q.shape
    f = frames
    s = n // f
    qf = (q * sm_scale).reshape(b, h, f, s, d)
    kf, vf = (t.reshape(b, h, f, s, d) for t in (k, v))
    logits = torch.matmul(qf.float(), kf.float().transpose(-2, -1))  # [B, H, F, s, s]
    if key_bias is not None:
        kb = key_bias.float().reshape(b, 1, f, 1, s)
        if exclude_first_row:
            kb = (torch.arange(s, device=q.device) > 0).float().view(1, 1, 1, s, 1) * kb
        logits = logits + kb
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs, vf).permute(0, 2, 3, 1, 4).reshape(b, n, h * d)  # from [B, H, F, s, d]
    if not want_lse:
        return out
    return out, torch.logsumexp(logits, dim=-1).reshape(b, h, n)


def hopper_body(q: torch.Tensor) -> bool:
    """Whether the kernels take ``q`` into their Hopper (wgmma) body: bf16
    at head dim 64, every ViT-B path. Everything else runs the first body."""
    return q.dtype == torch.bfloat16 and q.shape[-1] == 64


def blockdiag_plan(frames: int, s: int, hopper: bool) -> tuple:
    """K5a's launch plan for ``frames`` frames of ``s`` tokens: (frames per
    block, 64-row query tiles per frame, blocks per (batch, head) pair).

    The Hopper body packs g = 64 // s whole frames into one 64-row tile
    when s <= 32 (rows [f0*s, (f0+g)*s) of a clip, one key tile, a clip's
    last block holding frames % g frames); otherwise, and always in the
    first body, a block is one 64-row tile of one frame's rows."""
    if hopper and s <= _TILE // 2:
        g = _TILE // s
        return g, 1, -(-frames // g)
    tiles = -(-s // _TILE)
    return 1, tiles, frames * tiles


def check_blockdiag_kernel_args(q, k, v, key_bias, frames: int) -> None:
    """Raise ValueError on anything the K5a and K5b kernels do not take.
    A frame may have any length: the kernels walk it in 64-row tiles and
    keep no whole frame on chip. The limits are the grid's: at most
    2^31 - 1 blocks a (batch, head) pair, bounded for the larger of the
    Hopper bodies' plan (``blockdiag_plan``, K5a's and K5b's) and the first
    bodies' one block a (frame, 64-row tile), and 65535 (batch, head)
    pairs."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, N, d], got shape {tuple(q.shape)}")
    n = q.shape[2]
    if frames < 1 or n % frames:
        raise ValueError(f"frames={frames} does not divide N={n}")
    s = n // frames
    blocks = max(blockdiag_plan(frames, s, hopper_body(q))[2], frames * -(-s // _TILE))
    if blocks > _MAX_GRID_X:
        raise ValueError(f"frames={frames} of {s} tokens exceed the kernel's grid")
    check_kernel_args(q, k, v, key_bias)


def _blockdiag_forward(q, k, v, key_bias, sm_scale, frames, exclude_first_row, plan=None, want_lse=False):
    """K5a on a CUDA tensor, its plain version on a CPU tensor. ``plan``:
    the launch plan ``blockdiag_plan`` gives when None; another one is for
    measuring the packing (the C entry checks it covers every row). With
    ``want_lse`` returns (out, lse), lse float32 [B, H, N]."""
    global BLOCKDIAG_LAUNCHES
    if not q.is_cuda:
        return _blockdiag_reference(q, k, v, key_bias, sm_scale, frames, exclude_first_row, want_lse)
    check_blockdiag_kernel_args(q, k, v, key_bias, frames)
    from vtm_torch.ops.build import load_library

    lib = load_library()
    b, h, n, d = q.shape
    out = torch.empty((b, n, h * d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device) if want_lse else None
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], n * h * d, d, h * d
    )
    plan = plan or blockdiag_plan(frames, n // frames, hopper_body(q))
    with torch.cuda.device(q.device):
        err = lib.vtm_blockdiag_attention_fwd(
            _DTYPE_CODES[q.dtype], d,
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if key_bias is None else key_bias.data_ptr(),
            out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, h, n, frames, int(bool(exclude_first_row)), *plan, float(sm_scale),
            ctypes.addressof(strides),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"block-diagonal attention kernel launch failed with cudaError_t {err}")
    BLOCKDIAG_LAUNCHES += 1
    _count_products(4 * b * h * n * (n // frames) * d)  # each frame's keys
    return (out, lse) if want_lse else out


def _blockdiag_backward_reference(q, k, v, key_bias, do, sm_scale, frames, exclude_first_row=False,
                                  out=None, lse=None):
    """Plain version of K5b, step by step with the TPU kernel's rounding
    points (vtm/ops/flash_attention.py:1501-1549, 1611), per frame: fp32
    logits from the unscaled q, plus the key bias (on rows > 0 only with
    ``exclude_first_row``), an fp32 softmax over the frame's keys, dp =
    do v^T and ds = p (dp - rowsum(p dp)) in fp32; p and ds rounded to the
    input dtype before the three products, whose fp32 sums are cast at the
    end; dbias from the unrounded ds, summed over heads and over the query
    rows the bias reached. ``do`` is the token-major cotangent
    [B, N, H*d].

    Given the forward's residuals ``out`` (token-major [B, N, H*d]) and
    ``lse`` (fp32 [B, H, N]) it takes the kernel's arithmetic: p =
    exp(s - lse) and delta = rowsum(do * out) in fp32, out read in its own
    dtype. Returns (dq, dk, dv, dbias); dbias is None without a key_bias."""
    dtype = q.dtype
    b, h, n, d = q.shape
    f = frames
    s = n // f
    qf, kf, vf = (t.float().reshape(b, h, f, s, d) for t in (q, k, v))
    dof = do.float().reshape(b, f, s, h, d).permute(0, 3, 1, 2, 4)  # [B, H, F, s, d]
    sf = torch.matmul(qf, kf.transpose(-2, -1)) * sm_scale
    rows = None  # the query rows the bias reaches, [1, 1, 1, s, 1]
    if key_bias is not None:
        kb = key_bias.float().reshape(b, 1, f, 1, s)
        if exclude_first_row:
            rows = (torch.arange(s, device=q.device) > 0).float().view(1, 1, 1, s, 1)
            kb = rows * kb
        sf = sf + kb
    dp = torch.matmul(dof, vf.transpose(-2, -1))
    if out is None or lse is None:
        p = torch.softmax(sf, dim=-1)
        delta = (p * dp).sum(dim=-1, keepdim=True)
    else:
        p = torch.exp(sf - lse.float().reshape(b, h, f, s, 1))
        delta = (do.float() * out.float()).reshape(b, n, h, d).sum(dim=-1).transpose(1, 2)
        delta = delta.reshape(b, h, f, s, 1)
    ds = p * (dp - delta)
    p_lo = p.to(dtype).float()
    ds_lo = ds.to(dtype).float()
    dq = (torch.matmul(ds_lo, kf) * sm_scale).reshape(b, h, n, d).to(dtype)
    dk = (torch.matmul(ds_lo.transpose(-2, -1), qf) * sm_scale).reshape(b, h, n, d).to(dtype)
    dv = torch.matmul(p_lo.transpose(-2, -1), dof).reshape(b, h, n, d).to(dtype)
    dbias = None
    if key_bias is not None:
        reached = ds if rows is None else ds * rows
        dbias = reached.sum(dim=(1, 3)).reshape(b, n).to(key_bias.dtype)
    return dq, dk, dv, dbias


def tome_blockdiag_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_bias: Optional[torch.Tensor],
    do: torch.Tensor,
    sm_scale: float = 1.0,
    frames: int = 8,
    exclude_first_row: bool = False,
    need_dbias: bool = True,
    out: Optional[torch.Tensor] = None,
    lse: Optional[torch.Tensor] = None,
):
    """Gradients of ``tome_blockdiag_attention`` given ``do`` = d loss / d out.

    q, k, v, key_bias as in the forward; do: token-major [B, N, H*d] in q's
    dtype, last dim contiguous (read through its strides: no head-major
    transpose). ``out`` and ``lse`` are the forward's residuals (its
    token-major output and the float32 [B, H, N] row log-sum-exp of
    ``_blockdiag_forward(..., want_lse=True)``); when either is missing K5a
    runs first to make them. Returns (dq, dk, dv, dbias): dq, dk, dv are
    [B, H, N, d] views of one token-major [B, N, 3, H, d] buffer, so the
    gradient of a fused qkv projection's split is that buffer; dbias is
    float32 [B, N] (summed over heads and over the query rows the bias
    reached), or None when there is no key_bias or ``need_dbias`` is False.
    """
    global BLOCKDIAG_BWD_LAUNCHES
    if out is None or lse is None:
        out, lse = _blockdiag_forward(q, k, v, key_bias, sm_scale, frames, exclude_first_row, want_lse=True)
    if not q.is_cuda:
        dq, dk, dv, dbias = _blockdiag_backward_reference(
            q, k, v, key_bias, do, sm_scale, frames, exclude_first_row, out, lse
        )
        return dq, dk, dv, dbias if need_dbias else None
    check_blockdiag_kernel_args(q, k, v, key_bias, frames)
    b, h, n, d = q.shape
    for name, t in (("do", do), ("out", out)):
        if t.shape != (b, n, h * d) or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name} must be {q.dtype} {(b, n, h * d)} on {q.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if lse.shape != (b, h, n) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be float32 [{b}, {h}, {n}] on {q.device}, got {lse.dtype} {tuple(lse.shape)}")
    do, out, lse = _kernel_operand(do), _kernel_operand(out), lse.contiguous()
    from vtm_torch.ops.build import load_library

    lib = load_library()
    dq, dk, dv, dbias_heads = _gradient_buffers(q, need_dbias and key_bias is not None)
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], do.stride(0), d, do.stride(1),
        out.stride(0), d, out.stride(1), *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
    )
    plan = blockdiag_plan(frames, n // frames, hopper_body(q))
    with torch.cuda.device(q.device):
        err = lib.vtm_blockdiag_attention_bwd(
            _DTYPE_CODES[q.dtype], d,
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if key_bias is None else key_bias.data_ptr(),
            do.data_ptr(), out.data_ptr(), lse.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if dbias_heads is None else dbias_heads.data_ptr(),
            delta.data_ptr(),
            b, h, n, frames, int(bool(exclude_first_row)), *plan, float(sm_scale),
            ctypes.addressof(strides),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"block-diagonal attention backward kernel launch failed with cudaError_t {err}")
    BLOCKDIAG_BWD_LAUNCHES += 1
    dbias = None if dbias_heads is None else dbias_heads.sum(dim=1).to(key_bias.dtype)
    return dq, dk, dv, dbias


class _BlockdiagAttention(torch.autograd.Function):
    """K5a forward, K5b backward. The forward also writes each row's
    log-sum-exp, and the Function saves (q, k, v, key_bias, out, lse): the
    backward recomputes the logits but takes the row statistics from the
    residuals. TimeSformer feeds ``out`` straight to the output projection,
    whose Linear keeps it for its own backward, so saving it costs no
    memory of its own; lse is fp32 [B, H, N], 1/32 of q's size in bf16 at
    d = 64. Serving (no gradient wanted) does not reach the Function:
    ``tome_blockdiag_attention`` calls K5a without the lse."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, sm_scale, frames, exclude_first_row):
        out, lse = _blockdiag_forward(q, k, v, key_bias, sm_scale, frames, exclude_first_row, want_lse=True)
        ctx.save_for_backward(q, k, v, key_bias, out, lse)
        ctx.sm_scale, ctx.frames, ctx.exclude_first_row = sm_scale, frames, exclude_first_row
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_bias, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias = tome_blockdiag_attention_backward(
            q, k, v, key_bias, do, ctx.sm_scale, ctx.frames, ctx.exclude_first_row,
            need_dbias=ctx.needs_input_grad[3], out=out, lse=lse,
        )
        return dq, dk, dv, dbias, None, None, None


def tome_blockdiag_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_bias: Optional[torch.Tensor] = None,
    sm_scale: float = 1.0,
    frames: int = 8,
    exclude_first_row: bool = False,
) -> torch.Tensor:
    """Block-diagonal per-frame attention: the queries of frame f attend
    only to the keys of frame f (TimeSformer's divided spatial attention,
    folded as [B, frames * s] frame-major instead of a (b t) batch).

    q, k, v: [B, H, N, d] with N = frames * s, in bfloat16 or float32, last
    dim contiguous (the views of a fused qkv projection go in without a
    copy). key_bias: float32 [B, N] (log token sizes; entry 0 of each
    frame, the CLS token, is 0) or None. ``exclude_first_row``: the bias
    reaches query rows > 0 of each frame only (the reference's
    ``logits[:, :, 1:, 1:] += log size``). Returns token-major [B, N, H*d]
    in q's dtype (merged heads). Gradients with respect to q, k, v and
    key_bias come from K5b (``tome_blockdiag_attention_backward``).
    """
    if not _grad_wanted(q, k, v, key_bias):
        return _blockdiag_forward(q, k, v, key_bias, sm_scale, frames, exclude_first_row)
    return _BlockdiagAttention.apply(q, k, v, key_bias, sm_scale, frames, exclude_first_row)
