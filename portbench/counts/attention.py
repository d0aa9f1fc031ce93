"""Operations and bytes of one call of the attention kernels, from its
shapes. A forward does two products over every (query, key) pair,
4·B·H·Nq·Nk·d operations; a backward five, 10·B·H·Nq·Nk·d. Each input
byte is read once and each output byte written once: q, k, v and the
output at the element size, the key bias and the log-sum-exp in fp32."""

from __future__ import annotations

F32 = 4


def k1(b: int, h: int, n: int, d: int, bias: bool, lse: bool, elt: int = 2):
    """K1 (dense attention): (operations, bytes)."""
    flops = 4 * b * h * n * n * d
    nbytes = 4 * b * h * n * d * elt + (b * n * F32 if bias else 0) + (b * h * n * F32 if lse else 0)
    return flops, nbytes


def k3(b: int, h: int, n: int, d: int, frames: int, bias: bool, lse: bool, elt: int = 2):
    """K3 (per-frame attention over all N keys in F softmaxes; output
    token-major [B, N, F, H, d]): (operations, bytes)."""
    flops = 4 * b * h * n * n * d
    nbytes = (3 * b * h * n * d * elt + (b * n * F32 if bias else 0)
              + b * n * frames * h * d * elt + (b * h * frames * n * F32 if lse else 0))
    return flops, nbytes


def k4(b: int, h: int, n: int, d: int, frames: int, bias: bool, dbias: bool, elt: int = 2):
    """K4 (K3's backward): reads q, k, v, the bias, do and out ([B, N, F, H,
    d] each) and the per-frame lse; writes dq, dk, dv and the per-head key
    bias gradient. (operations, bytes)."""
    flops = 10 * b * h * n * n * d
    reads = 3 * b * h * n * d * elt + (b * n * F32 if bias else 0) + 2 * b * n * frames * h * d * elt \
        + b * h * frames * n * F32
    writes = 3 * b * h * n * d * elt + (b * h * n * F32 if dbias else 0)
    return flops, reads + writes
