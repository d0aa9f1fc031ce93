"""A/B variants of the dense attention kernel (K1), for measurement.

Twelve functions, each the counterpart of one Pallas TPU kernel of the JAX
package's ``tools/ab_*.py`` and named after it. They answer what single
steps of K1's body cost on the card: the q k^T product alone, the softmax
passes beside it, the bias, the block order, two heads packed into one
128-wide contraction, the softmax denominator taken from the p v product.
None is on a model's path; ``vtm_torch.tools.ab_dense`` runs them.

  T1  ``chunked_attention``  ab_bisect.py::call_kernel      online-softmax attention, [bh, n, d]
  T2  ``qk64``               ab_mxu_pack.py::qk64           sum over key chunks of (q k_chunk^T)[:, :d]
  T3  ``qk_packed``          ab_mxu_pack.py::qk_packed      the same over packed operands
  T4  ``packed_attention``   ab_mxu_pack.py::packed_attention  attention, two heads per contraction
  T5  ``grid_swapped``       ab_b32.py::grid_swapped        unbiased attention, b*h fastest in the grid
  T6  ``qk_d64``             ab_decomp.py::qk_d64           row sums of q k^T
  T7  ``qk_packed_rowsum``   ab_decomp.py::qk_packed        the same over packed operands
  T8  ``chain``              ab_decomp.py::chain            q k^T -> nosmax | linear | full -> p v
  T9  ``chain_bias``         ab_decomp.py::chain_bias       full, plus a shared key bias read two ways
  T10 ``chain_bias_cost``    ab_decomp.py::chain_bias_cost  T9 with a hint to the compiler
  T11 ``v2_attention``       ab_dense_v2.py::v2_attention   v2_sum | v2_fold | v2_nomax
  T12 ``n8_attention``       ab_block_attn.py::n8_attention unbiased attention, q scaled in the kernel

Kernels: ``csrc/ab_qk_probe.cu`` (T2, T3, T6, T7; in bf16 on a Hopper
body of their own, wgmma products from shared memory over
``csrc/wgmma_tiles.cuh``, at depth 64 and 128, ``PROBE_TILING``; fp32 on a
first body), ``csrc/ab_chain.cu`` (T1, T5, T8, T9, T10, T12;
in bf16 T1, T5, T12, T8 ``full``, T9 ``1d`` and T10 on K1's own instances
of the Hopper tile loop, ``csrc/wgmma_attention.cuh``, so with K1's output
bits, T10's in a kernel with an occupancy target; T9 ``2d``, T8 ``linear``
and ``nosmax`` on the same loop under a policy each; fp32 on a first
body),
``csrc/ab_dense_variants.cu`` (T4, T11; in bf16 on the same tile loop
under a softmax policy each): CUDA C++ for
Hopper at head dim 64, built and bound by ``vtm_torch/ops/build.py``.
A tensor on the CPU goes to the plain PyTorch version (``*_plain``); a
CUDA tensor goes to the kernel, or the call raises: there is no fallback.

Rounding points, shared by the plain versions and the kernels: logits,
running max, denominator and accumulator in fp32; p cast to the input
dtype before p v; the fp32 accumulator divided by the denominator and
cast once. ``v2_*`` take the denominator from the *cast* p (a ones column
goes through the product); the others from the fp32 p. ``n8_attention``,
``grid_swapped``, ``packed_attention`` and ``v2_attention`` round
``q * sm_scale`` to q's dtype first.

Three functions depend on the chunk size ``blk`` and take it as a
parameter: ``qk64`` and ``qk_packed`` keep columns ``[:d]`` of every
chunk's product, and ``chain(..., "linear")`` runs the online recurrence
without exp, which does not telescope. Their plain versions loop over
chunks; the kernels work in key tiles of ``KEY_TILE`` and take no other
``blk``.
"""

from __future__ import annotations

import ctypes
import torch

KEY_TILE = 64  # keys per tile of every kernel here: the only blk they take
HEAD_DIM = 64  # the tools are fixed at d = 64 (packed operands: 128)
CHAIN_MODES = ("nosmax", "linear", "full")
BIAS_MODES = ("1d", "2d")
V2_VARIANTS = ("v2_sum", "v2_fold", "v2_nomax")
_MASK = -1e30
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_ALIGN = 16  # bytes: tiles are staged with 16-byte loads
_MAX_GRID_Y = 65535

# Kernel launches per function since import (or since a caller reset them).
AB_LAUNCHES = {name: 0 for name in (
    "chunked_attention", "qk64", "qk_packed", "packed_attention", "grid_swapped", "qk_d64",
    "qk_packed_rowsum", "chain", "chain_bias", "chain_bias_cost", "v2_attention", "n8_attention")}

# variant codes of csrc/ab_chain.cu: in bf16 every one runs the Hopper body
# (the three modes: T8, full also T5, T12; the three bias reads: T9 1d, 2d,
# T10; _CHAIN_ATTENTION_BIAS: T1, 1d's instance), fp32 the first body
CHAIN_CODES = range(7)
(_CHAIN_FULL, _CHAIN_NOSMAX, _CHAIN_LINEAR, _CHAIN_BIAS, _CHAIN_BIAS_STAGED, _CHAIN_BIAS_HINTED,
 _CHAIN_ATTENTION_BIAS) = CHAIN_CODES
# shared memory a block of ab_chain.cu's Hopper kernels takes
# (csrc/wgmma_attention.cuh, ModeSmem::kLaunchBytes): the q tile, two ring
# stages of k and v and the output stage, 8 KB each, and 1 KB for the
# swizzle's alignment; the staged bias (T9 2d) two 256-byte slots more
_HOPPER_BLOCK_BYTES = 6 * 64 * 128 + 1024
_STAGED_BIAS_BYTES = 2 * KEY_TILE * 4
_CHAIN_MODE_CODES = {"full": _CHAIN_FULL, "nosmax": _CHAIN_NOSMAX, "linear": _CHAIN_LINEAR}
# the bf16 probe body's launch by contraction depth (csrc/ab_qk_probe.cu,
# WgTiling and WgSmem): 64-row tiles of q a block, 64-key tiles of k in the
# ring, the dynamic shared bytes and the blocks an SM they allow on an H100
PROBE_TILING = {64: dict(row_tiles=2, stages=4, smem_bytes=50_176, blocks_per_sm=4),
                128: dict(row_tiles=4, stages=3, smem_bytes=115_712, blocks_per_sm=2)}
# variant codes of csrc/ab_dense_variants.cu
_DENSE_CODES = {"v2_sum": 0, "v2_fold": 1, "v2_nomax": 2, "packed": 3}


# ---------------------------------------------------------------- operands


def pack_q(q: torch.Tensor) -> torch.Tensor:
    """[bh, n, d] -> the interleaved block-diagonal operand [bh/2, 2n, 2d]:
    row 2i = [q1_i | 0], row 2i + 1 = [0 | q2_i] for the head pair
    (q1, q2) = (q[2g], q[2g + 1]) (ab_mxu_pack.py:269-272)."""
    bh, n, d = q.shape
    pair = q.reshape(bh // 2, 2, n, d)
    qp = q.new_zeros((bh // 2, 2 * n, 2 * d))
    qp[:, 0::2, :d] = pair[:, 0]
    qp[:, 1::2, d:] = pair[:, 1]
    return qp


def pack_k(k: torch.Tensor) -> torch.Tensor:
    """[bh, n, d] -> [bh/2, n, 2d] = [k1 | k2] (ab_mxu_pack.py:273-274)."""
    bh, n, d = k.shape
    pair = k.reshape(bh // 2, 2, n, d)
    return torch.cat([pair[:, 0], pair[:, 1]], dim=-1)


def packed_plan(b: int, h: int, n: int, hopper: bool):
    """T4's launch plan, as both bodies of ``csrc/ab_dense_variants.cu``
    map it: the grid (query tiles, batch x head pairs), and ``block(x, y)``,
    what block (x, y) writes: heads 2 g and 2 g + 1 (g = y % (h / 2)) of
    batch y // (h / 2), query rows [x q, x q + rows) of each, q = 64 in the
    Hopper body (bf16; it walks the two heads as two frames) or 32 in the
    first (fp32; its 64 rows interleave the heads), head j into columns
    [j d, (j + 1) d) of the token-major [B, N, H*d] output. Returns (grid,
    block), block giving [(batch, head, first row, rows, first column)]."""
    if h % 2:
        raise ValueError(f"packed_attention pairs heads: H={h} is odd")
    queries = KEY_TILE if hopper else KEY_TILE // 2
    pairs = h // 2

    def block(x: int, y: int) -> list:
        batch, g = divmod(y, pairs)
        r0 = x * queries
        return [(batch, head, r0, min(queries, n - r0), head * HEAD_DIM) for head in (2 * g, 2 * g + 1)]

    return (-(-n // queries), b * pairs), block


def chain_plan(b: int, h: int, n: int, swap_grid: bool):
    """The launch plan of ``csrc/ab_chain.cu``, as both its bodies map it:
    the grid (query tiles, b*h), or with ``swap_grid`` (T5) (b*h, query
    tiles), and ``block(x, y)``, what block (x, y) writes: rows [r0, r0 +
    rows) of head ``head`` of batch ``batch``, 64 rows a block. Returns
    (grid, block), block giving (batch, head, r0, rows)."""
    tiles = -(-n // KEY_TILE)

    def block(x: int, y: int) -> tuple:
        bh, tile = (x, y) if swap_grid else (y, x)
        batch, head = divmod(bh, h)
        r0 = tile * KEY_TILE
        return batch, head, r0, min(KEY_TILE, n - r0)

    return ((b * h, tiles) if swap_grid else (tiles, b * h)), block


def chain_smem_bytes(variant: int) -> int:
    """The dynamic shared bytes a block of ``csrc/ab_chain.cu``'s bf16
    (Hopper) kernel for ``variant`` takes, as the C side sizes them."""
    return _HOPPER_BLOCK_BYTES + (_STAGED_BIAS_BYTES if variant == _CHAIN_BIAS_STAGED else 0)


def probe_occupancy(depth: int, rowsum: bool) -> tuple:
    """(blocks an SM, dynamic shared bytes) of ``csrc/ab_qk_probe.cu``'s
    bf16 kernel at ``depth`` (64 or 128) with or without the row-sum
    epilogue, from the CUDA runtime's occupancy calculator on the current
    device. Launches nothing; on the card only."""
    out = (ctypes.c_int * 2)()
    err = _library().vtm_ab_qk_probe_occupancy(depth, int(rowsum), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"occupancy of ab_qk_probe.cu at depth {depth} failed with cudaError_t {err}")
    return out[0], out[1]


def chain_occupancy(dtype: torch.dtype, variant: int) -> tuple:
    """(blocks an SM, dynamic shared bytes) of the kernel ``csrc/ab_chain.cu``
    launches for ``variant`` in ``dtype``, from the CUDA runtime's occupancy
    calculator on the current device. Launches nothing; on the card only."""
    out = (ctypes.c_int * 2)()
    err = _library().vtm_ab_chain_occupancy(_DTYPE_CODES[dtype], variant, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"occupancy of ab_chain.cu variant {variant} failed with cudaError_t {err}")
    return out[0], out[1]


def split_bias(key_bias: torch.Tensor, dtype: torch.dtype):
    """An fp32 key bias as two numbers of ``dtype``: hi = dtype(bias) and
    lo = dtype(bias - hi), so that hi + lo carries the bias through a
    product in ``dtype`` with fp32 accumulation (ab_dense_v2.py:133-134)."""
    bias = key_bias.float()
    hi = bias.to(dtype)
    lo = (bias - hi.float()).to(dtype)
    return hi, lo


# ------------------------------------------------------------- comparison

ILL_CONDITIONED = 20.0  # times the median row's largest entry


def ill_conditioned_rows(want: torch.Tensor) -> torch.Tensor:
    """The rows of ``want`` whose largest entry exceeds ``ILL_CONDITIONED``
    times the median row's: a boolean mask over ``want.shape[:-1]``."""
    rows = want.float().abs().amax(dim=-1)
    return rows > ILL_CONDITIONED * rows.flatten().median()


def relative_error(got: torch.Tensor, want: torch.Tensor, trim_ill_conditioned: bool = False) -> float:
    """The largest difference over ``want``'s largest entry.

    ``chain(..., "linear")`` divides by l = l * corr + sum(p), a positive
    and a negative term of some thousand each. In a row where l lands near
    zero the quotient is huge and carries the rounding of the logits
    amplified without bound, so two correct computations differ there by
    any amount. With ``trim_ill_conditioned`` the rows that
    ``ill_conditioned_rows`` marks are left out of both the difference and
    the largest entry; every other row, ragged tiles included, is still
    compared. ``cancelled_rows`` says what the rows left out look like."""
    got, want = got.float(), want.float()
    if trim_ill_conditioned:
        keep = ~ill_conditioned_rows(want)
        got, want = got[keep], want[keep]
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def cancelled_rows(got: torch.Tensor, plain: torch.Tensor, want: torch.Tensor, exact: torch.Tensor) -> dict:
    """A second witness for the rows that ``relative_error`` leaves out:
    how many of ``want``'s rows they are, and how far the kernel's result
    ``got`` and the plain version's ``plain`` each lie from ``exact`` (the
    fp64 recurrence) there: the median over those rows of the largest
    difference in the row over the row's largest exact entry. A kernel that
    is right sits as far from fp64 as the plain version does."""
    rows = ill_conditioned_rows(want)
    out = dict(rows=rows.numel(), left_out=int(rows.sum()), share=rows.float().mean().item())
    if out["left_out"]:
        exact = exact[rows].double()
        scale = exact.abs().amax(dim=-1).clamp_min(1e-30)
        for name, t in (("kernel", got), ("plain", plain)):
            out[f"{name}_row_err_vs_fp64"] = ((t[rows].double() - exact).abs().amax(dim=-1) / scale).median().item()
    return out


# ---------------------------------------------------------- plain versions


def _online_chain(q, k, v, bias, mode: str, blk: int):
    """The online recurrence over key chunks of ``blk`` (ab_decomp.py:
    117-142), on [..., n, d] operands with an optional fp32 bias that
    broadcasts against the [..., n, n] logits. Returns acc / max(|l|, 1e-6)
    in q's dtype; for ``full`` the denominator is at least 1, so that is
    acc / l. Works in fp32, or in fp64 throughout on fp64 operands."""
    n = k.shape[-2]
    wide = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf, kf, vf = q.to(wide), k.to(wide), v.to(wide)
    rows = qf.shape[:-1]
    m = qf.new_full((*rows, 1), _MASK)
    l = qf.new_zeros((*rows, 1))
    acc = qf.new_zeros((*rows, v.shape[-1]))
    for j in range(0, n, blk):
        s = torch.matmul(qf, kf[..., j:j + blk, :].transpose(-2, -1))
        if bias is not None:
            s = s + bias[..., j:j + blk]
        vj = vf[..., j:j + blk, :]
        if mode == "nosmax":
            acc = acc + torch.matmul(s.to(q.dtype).to(wide), vj)
            continue
        mj = torch.maximum(m, s.max(dim=-1, keepdim=True).values)
        p = (s - mj) if mode == "linear" else torch.exp(s - mj)
        corr = (m - mj) if mode == "linear" else torch.exp(m - mj)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(q.dtype).to(wide), vj)
        m = mj
    return (acc / l.abs().clamp_min(1e-6)).to(q.dtype)


def _whole_row(q, k, v, key_bias, sm_scale):
    """softmax((q * sm_scale) k^T + key_bias[b, key]) v over [B, H, N, d]
    with the kernels' rounding: q * sm_scale in q's dtype, p cast before
    p v, the fp32 sum divided by the fp32 denominator."""
    bias = None if key_bias is None else key_bias.float()[:, None, None, :]
    return _online_chain(q * sm_scale, k, v, bias, "full", k.shape[-2])


def chunked_attention_plain(q, k, v, bias, bias_shared: bool, num_heads: int):
    bh, n, d = q.shape
    b = bh // num_heads
    row = bias.float().reshape(1 if bias_shared else b, 1, 1, n)
    out = _online_chain(*(t.reshape(b, num_heads, n, d) for t in (q, k, v)), row, "full", n)
    return out.reshape(bh, n, d)


def _chunk_columns(q, k, blk: int):
    """sum over chunks of (q k_chunk^T)[:, :64] in fp32."""
    n = k.shape[-2]
    if blk < HEAD_DIM or n % blk:
        raise ValueError(f"blk {blk} must be at least {HEAD_DIM} and divide the key count {n}")
    qf, kf = q.float(), k.float()
    acc = qf.new_zeros((*q.shape[:-1], HEAD_DIM))
    for j in range(0, n, blk):
        acc = acc + torch.matmul(qf, kf[..., j:j + blk, :].transpose(-2, -1))[..., :HEAD_DIM]
    return acc


def qk64_plain(q, k, blk: int):
    return _chunk_columns(q, k, blk).to(q.dtype)


qk_packed_plain = qk64_plain  # the same function of the packed operands


def qk_d64_plain(q, k):
    return torch.matmul(q.float(), k.float().transpose(-2, -1)).sum(dim=-1, keepdim=True)


qk_packed_rowsum_plain = qk_d64_plain  # the same function of the packed operands


def chain_plain(q, k, v, mode: str, blk: int):
    return _online_chain(q, k, v, None, mode, blk)


def chain_bias_plain(q, k, v, bias, mode: str):
    """``mode`` ("1d" or "2d") names how the kernel reads the bias; the
    numbers are the same."""
    return _online_chain(q, k, v, bias.float().reshape(1, 1, -1), "full", k.shape[-2])


def chain_bias_cost_plain(q, k, v, bias):
    return chain_bias_plain(q, k, v, bias, "1d")


def packed_attention_plain(q, k, v, key_bias, sm_scale):
    """Token-major [B, N, H*d]."""
    b, h, n, d = q.shape
    return _whole_row(q, k, v, key_bias, sm_scale).transpose(1, 2).reshape(b, n, h * d)


def n8_attention_plain(q, k, v, sm_scale):
    return _whole_row(q, k, v, None, sm_scale)


grid_swapped_plain = n8_attention_plain  # the block order changes no number


def v2_attention_plain(q, k, v, key_bias, sm_scale, variant: str):
    """K1's function with the denominator taken from the cast p through a
    ones column of v (all three), the bias carried through q k^T as two
    extra contraction features hi + lo (``v2_fold``, ``v2_nomax``), and no
    max subtraction (``v2_nomax``: overflows on large logits by design)."""
    b, h, n, d = q.shape
    dtype = q.dtype
    qs = (q * sm_scale).float()
    bias = q.new_zeros((b, n), dtype=torch.float32) if key_bias is None else key_bias.float()
    if variant == "v2_sum":
        s = torch.matmul(qs, k.float().transpose(-2, -1)) + bias[:, None, None, :]
    else:
        hi, lo = split_bias(bias, dtype)
        ones = qs.new_ones((b, h, n, 2))
        extra = torch.stack([hi, lo], dim=-1).float()[:, None].expand(b, h, n, 2)
        s = torch.matmul(torch.cat([qs, ones], dim=-1), torch.cat([k.float(), extra], dim=-1).transpose(-2, -1))
    if variant == "v2_nomax":
        p = torch.exp(s)
    else:
        p = torch.exp(s - s.max(dim=-1, keepdim=True).values)
    v_aug = torch.cat([v.float(), qs.new_ones((b, h, n, 1))], dim=-1)
    acc = torch.matmul(p.to(dtype).float(), v_aug)
    return (acc[..., :d] / acc[..., d:]).to(dtype)


# ------------------------------------------------------------ kernel checks


def _check_operands(named, dims: int, last: int) -> None:
    """Every operand: ``dims`` dimensions, one dtype (bf16 or fp32), one
    CUDA device, a contiguous last dim of ``last``, 16-byte aligned rows."""
    first = named[0][1]
    if first.dtype not in _DTYPE_CODES:
        raise ValueError(f"operands must be bfloat16 or float32, got {first.dtype}")
    for name, t in named:
        if t.dim() != dims or t.shape[-1] != last:
            raise ValueError(f"{name} must have {dims} dims and a last dim of {last}, got shape {tuple(t.shape)}")
        if t.dtype != first.dtype:
            raise ValueError(f"{name} must share {named[0][0]}'s dtype {first.dtype}, got {t.dtype}")
        size = t.element_size()
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim, strides {t.stride()}")
        if t.data_ptr() % _ALIGN or any((s * size) % _ALIGN for s in t.stride()[:-1]):
            raise ValueError(f"{name} data and strides must be {_ALIGN}-byte aligned")
    if any(t.device != first.device for _, t in named) or first.device.type != "cuda":
        raise ValueError(f"operands must share one CUDA device, got {[str(t.device) for _, t in named]}")


def _check_blk(name: str, blk: int) -> None:
    if blk != KEY_TILE:
        raise ValueError(f"{name}: the kernel works in key tiles of {KEY_TILE} and takes no other blk, got {blk}")


def _check_fp32_rows(name: str, t: torch.Tensor, shape, like: torch.Tensor) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if t.device != like.device or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous on the operands' device")


def _library():
    from vtm_torch.ops.build import load_library

    return load_library()


def _strides(*tensors) -> ctypes.Array:
    """(batch, head, row) element strides of [B, H, N, d] tensors."""
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError_t {err}")
    AB_LAUNCHES[name] += 1


def _launch_chain(name, variant, q, k, v, bias, bias_batch_stride, out, sm_scale, swap_grid=False):
    """csrc/ab_chain.cu on [B, H, N, 64] views; ``out`` is written through
    its strides."""
    _check_operands((("q", q), ("k", k), ("v", v)), 4, HEAD_DIM)
    b, h, n, _ = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if n < 1 or b * h < 1 or chain_plan(b, h, n, swap_grid)[0][1] > _MAX_GRID_Y:
        raise ValueError(f"unsupported B*H={b * h}, N={n}")
    strides = _strides(q, k, v, out)
    with torch.cuda.device(q.device):
        err = _library().vtm_ab_chain(
            _DTYPE_CODES[q.dtype], variant,
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(),
            out.data_ptr(),
            b, h, n, float(sm_scale), bias_batch_stride, int(swap_grid),
            ctypes.addressof(strides),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _launched(name, err)
    return out


def _flat_chain(name, variant, q, k, v, bias, bias_batch_stride, num_heads):
    """The chain kernel on [bh, n, d] operands: [bh, n, d] out."""
    for t_name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3:
            raise ValueError(f"{t_name} must be [bh, n, d], got shape {tuple(t.shape)}")
    bh, n, d = q.shape
    if bh % num_heads:
        raise ValueError(f"bh={bh} is not a multiple of num_heads={num_heads}")
    out = torch.empty((bh, n, d), dtype=q.dtype, device=q.device)
    views = [t.unflatten(0, (bh // num_heads, num_heads)) for t in (q, k, v, out)]
    _launch_chain(name, variant, *views[:3], bias, bias_batch_stride, views[3], 1.0)
    return out


def _launch_probe(name, q, k, rowsum: bool):
    """csrc/ab_qk_probe.cu on contiguous [g, nq, depth], [g, nk, depth]."""
    depth = q.shape[-1]
    if depth not in (HEAD_DIM, 2 * HEAD_DIM):
        raise ValueError(f"{name}: contraction depth {depth} not in ({HEAD_DIM}, {2 * HEAD_DIM})")
    _check_operands((("q", q), ("k", k)), 3, depth)
    if k.shape[0] != q.shape[0] or not (q.is_contiguous() and k.is_contiguous()):
        raise ValueError(f"{name}: q and k must be contiguous with one leading dim, got {tuple(q.shape)}, {tuple(k.shape)}")
    g, nq, _ = q.shape
    nk = k.shape[1]
    if not 1 <= g <= _MAX_GRID_Y or nq < 1 or nk < 1:
        raise ValueError(f"unsupported groups={g}, nq={nq}, nk={nk}")
    if rowsum:
        out = torch.empty((g, nq, 1), dtype=torch.float32, device=q.device)
    else:
        out = torch.empty((g, nq, HEAD_DIM), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _library().vtm_ab_qk_probe(
            _DTYPE_CODES[q.dtype], depth, int(rowsum),
            q.data_ptr(), k.data_ptr(), out.data_ptr(), g, nq, nk,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _launched(name, err)
    return out


def _launch_dense(name, variant, q, k, v, bias, hi, lo, sm_scale, token_major: bool):
    """csrc/ab_dense_variants.cu on [B, H, N, 64] views; the output is
    allocated token-major and returned as [B, H, N, d] (a view) or, with
    ``token_major``, as [B, N, H*d]."""
    _check_operands((("q", q), ("k", k), ("v", v)), 4, HEAD_DIM)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, n, d = q.shape
    groups = packed_plan(b, h, n, q.dtype == torch.bfloat16)[0][1] if variant == "packed" else b * h
    if n < 1 or not 1 <= groups <= _MAX_GRID_Y:
        raise ValueError(f"unsupported B*H={b * h}, N={n}")
    if bias is not None:
        _check_fp32_rows("key_bias", bias, (b, n), q)
    flat = torch.empty((b, n, h * d), dtype=q.dtype, device=q.device)
    out = flat.view(b, n, h, d).transpose(1, 2)
    strides = _strides(q, k, v, out)
    with torch.cuda.device(q.device):
        err = _library().vtm_ab_dense_variant(
            _DTYPE_CODES[q.dtype], _DENSE_CODES[variant],
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if hi is None else hi.data_ptr(),
            None if lo is None else lo.data_ptr(),
            out.data_ptr(),
            b, h, n, float(sm_scale),
            ctypes.addressof(strides),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _launched(name, err)
    return flat if token_major else out


# ---------------------------------------------------------------- wrappers


def chunked_attention(q, k, v, bias, bias_shared: bool, num_heads: int):
    """T1. q (pre-scaled), k, v: [bh, n, d]; ``bias``: fp32 [b, 1, n] per
    batch, or [1, 1, n] with ``bias_shared``. Returns [bh, n, d]. In bf16
    K1's biased instance at scale 1, so K1's output bits for the bias
    expanded to [b, n]."""
    if not q.is_cuda:
        return chunked_attention_plain(q, k, v, bias, bias_shared, num_heads)
    n = q.shape[1]
    _check_fp32_rows("bias", bias, (1 if bias_shared else q.shape[0] // num_heads, 1, n), q)
    return _flat_chain("chunked_attention", _CHAIN_ATTENTION_BIAS, q, k, v, bias, 0 if bias_shared else n,
                       num_heads)


def qk64(q, k, blk: int = KEY_TILE):
    """T2. q, k: [bh, n, d] -> [bh, n, d] in q's dtype: the fp32 sum over
    key chunks of ``blk`` of (q k_chunk^T)[:, :d]. Depends on ``blk``. In
    bf16 the Hopper body at depth 64 (``PROBE_TILING``: 128 rows of q a
    block, four 64-key tiles in the ring)."""
    if not q.is_cuda:
        return qk64_plain(q, k, blk)
    _check_blk("qk64", blk)
    if q.shape[-1] != HEAD_DIM or k.shape[1] % blk:
        raise ValueError(f"qk64: d must be {HEAD_DIM} and blk must divide the key count, got {tuple(k.shape)}")
    return _launch_probe("qk64", q, k, rowsum=False)


def qk_packed(qp, kc, blk: int = KEY_TILE):
    """T3. The same over packed operands: qp [bh/2, 2n, 128] from
    ``pack_q``, kc [bh/2, n, 128] from ``pack_k`` -> [bh/2, 2n, 64]. In
    bf16 the Hopper body at depth 128 takes 256 rows of qp a block, the
    whole 128-deep product on every key tile (it cannot know the zero
    halves)."""
    if not qp.is_cuda:
        return qk_packed_plain(qp, kc, blk)
    _check_blk("qk_packed", blk)
    if qp.shape[-1] != 2 * HEAD_DIM or kc.shape[1] % blk:
        raise ValueError(f"qk_packed: depth must be {2 * HEAD_DIM} and blk must divide the key count, got {tuple(kc.shape)}")
    return _launch_probe("qk_packed", qp, kc, rowsum=False)


def packed_attention(q, k, v, key_bias, sm_scale):
    """T4. q, k, v: [B, H, N, d] with H even; ``key_bias``: fp32 [B, N] or
    None. One block a head pair (``packed_plan``): on the TPU the two heads
    share one 128-deep q k^T and one 128-wide p v; the fp32 kernel packs
    them so, the bf16 one walks them one after the other. Token-major
    [B, N, H*d]."""
    if q.shape[1] % 2:
        raise ValueError(f"packed_attention pairs heads: H={q.shape[1]} is odd")
    if not q.is_cuda:
        return packed_attention_plain(q, k, v, key_bias, sm_scale)
    return _launch_dense("packed_attention", "packed", q, k, v, key_bias, None, None, sm_scale, True)


def _unbiased(name, q, k, v, sm_scale, swap_grid):
    """T5 and T12: ``full`` (in bf16 K1's instance of the Hopper tile loop,
    so K1's output bits on the same operands) with their scale."""
    b, h, n, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    return _launch_chain(name, _CHAIN_FULL, q, k, v, None, 0, out, sm_scale, swap_grid)


def grid_swapped(q, k, v, sm_scale):
    """T5. Unbiased attention over [B, H, N, d] with the block order
    swapped (``chain_plan``): b*h varies fastest, so neighbouring blocks
    share no k or v. Returns [B, H, N, d] as a view of a token-major
    buffer; in bf16 K1's output bits."""
    if not q.is_cuda:
        return grid_swapped_plain(q, k, v, sm_scale)
    return _unbiased("grid_swapped", q, k, v, sm_scale, True)


def qk_d64(q, k):
    """T6. q, k: [bh, n, d] -> fp32 [bh, n, 1]: row sums of q k^T, any key
    count. In bf16 T2's Hopper body with T7's row-sum epilogue."""
    if not q.is_cuda:
        return qk_d64_plain(q, k)
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"qk_d64: d must be {HEAD_DIM}, got {q.shape[-1]}")
    return _launch_probe("qk_d64", q, k, rowsum=True)


def qk_packed_rowsum(qp, kc):
    """T7. The same over the packed operands of T3 -> fp32 [bh/2, 2n, 1],
    any key count. In bf16 T3's Hopper body with a row-sum epilogue: each
    thread's 16 columns of a row in order, then the quad's four sums."""
    if not qp.is_cuda:
        return qk_packed_rowsum_plain(qp, kc)
    if qp.shape[-1] != 2 * HEAD_DIM:
        raise ValueError(f"qk_packed_rowsum: depth must be {2 * HEAD_DIM}, got {qp.shape[-1]}")
    return _launch_probe("qk_packed_rowsum", qp, kc, rowsum=True)


def chain(q, k, v, mode: str, blk: int = KEY_TILE):
    """T8. q, k, v: [bh, n, d], no scale and no bias. ``nosmax``: p = the
    logits, cast; ``linear``: the online recurrence with identity in place
    of exp (depends on ``blk``); ``full``: online softmax. Returns
    acc / max(|l|, 1e-6) as [bh, n, d]; ``nosmax`` leaves l at 0. In bf16
    ``full`` is K1's instance at scale 1 (K1's output bits; l >= 1, so
    acc / l), ``linear`` and ``nosmax`` the same tile loop under a policy
    each."""
    if mode not in CHAIN_MODES:
        raise ValueError(f"mode {mode!r} not in {CHAIN_MODES}")
    if not q.is_cuda:
        return chain_plain(q, k, v, mode, blk)
    _check_blk("chain", blk)
    return _flat_chain("chain", _CHAIN_MODE_CODES[mode], q, k, v, None, 0, 1)


def _shared_bias_chain(name, variant, q, k, v, bias):
    _check_fp32_rows("bias", bias, (1, 1, q.shape[1]), q)
    if variant == _CHAIN_BIAS_STAGED and bias.data_ptr() % _ALIGN:
        raise ValueError(f"{name}: a staged bias must start {_ALIGN}-byte aligned")
    return _flat_chain(name, variant, q, k, v, bias, 0, 1)


def chain_bias(q, k, v, bias, mode: str):
    """T9. ``chain`` full plus a shared fp32 bias [1, 1, n], read from
    device memory per element (``1d``) or staged in shared memory per key
    tile (``2d``, 16-byte aligned): the same numbers. In bf16 ``1d`` is
    K1's biased instance at scale 1 (T1's), ``2d`` that loop with each key
    tile's bias copied in with its keys: both K1's bits for the row
    expanded to every batch."""
    if mode not in BIAS_MODES:
        raise ValueError(f"mode {mode!r} not in {BIAS_MODES}")
    if not q.is_cuda:
        return chain_bias_plain(q, k, v, bias, mode)
    return _shared_bias_chain("chain_bias", _CHAIN_BIAS if mode == "1d" else _CHAIN_BIAS_STAGED, q, k, v, bias)


def chain_bias_cost(q, k, v, bias):
    """T10. ``chain_bias`` ``1d`` from a second instantiation that carries
    an occupancy hint and a shared-memory carve-out preference: the same
    numbers (in bf16 K1's bits, 4 blocks an SM)."""
    if not q.is_cuda:
        return chain_bias_cost_plain(q, k, v, bias)
    return _shared_bias_chain("chain_bias_cost", _CHAIN_BIAS_HINTED, q, k, v, bias)


def v2_attention(q, k, v, key_bias, sm_scale, variant: str):
    """T11. q, k, v: [B, H, N, d]; ``key_bias``: fp32 [B, N] or None.
    Returns [B, H, N, d] (a view of a token-major buffer). ``v2_nomax`` is
    for measurement only: it overflows on large logits."""
    if variant not in V2_VARIANTS:
        raise ValueError(f"variant {variant!r} not in {V2_VARIANTS}")
    if not q.is_cuda:
        return v2_attention_plain(q, k, v, key_bias, sm_scale, variant)
    if variant == "v2_sum" or key_bias is None:
        return _launch_dense("v2_attention", variant, q, k, v, key_bias, None, None, sm_scale, False)
    _check_fp32_rows("key_bias", key_bias, (q.shape[0], q.shape[2]), q)
    hi, lo = split_bias(key_bias, q.dtype)
    return _launch_dense("v2_attention", variant, q, k, v, None, hi, lo, sm_scale, False)


def n8_attention(q, k, v, sm_scale):
    """T12. Unbiased attention over [B, H, N, d], any N: q scaled inside
    the kernel, keys past N masked by their index. Takes the split-heads
    views of a fused qkv projection; returns [B, H, N, d] as a view of a
    token-major buffer, so merging the heads is free. In bf16 K1's body and
    block order, and K1's output bits."""
    if not q.is_cuda:
        return n8_attention_plain(q, k, v, sm_scale)
    return _unbiased("n8_attention", q, k, v, sm_scale, False)
