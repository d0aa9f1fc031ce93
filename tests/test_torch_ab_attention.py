"""The port's A/B attention variants (T1-T12, ``vtm_torch.ops.ab_attention``)
against the Pallas kernels of the JAX package's ``tools/ab_*.py``.

The JAX tools are loaded by path (``tools/`` is no package) with their
module globals set small, and run their kernels in interpret mode, as they
select it themselves off the TPU. On the CPU every port function runs its
plain version; the CUDA kernels are held against those plain versions on
the card by ``chip_smoke.py``.

Tolerances, relative to the output's largest entry: fp32 1e-5 (two
orders of summation); bf16 2e-2 (one bf16 rounding of p, taken against
another running max, and one of the output: 2^-8 each, summed over a row).
"""

import functools
import importlib.util
import json
import os
import pathlib
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_flash_attention import _tile_walk
from vtm_torch.ops import ab_attention as ab
from vtm_torch.ops.flash_attention import _reference

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = ("float32", "bfloat16")


@functools.lru_cache(maxsize=None)
def jax_tool(name: str):
    """``tools/<name>.py`` as a module. Its import sets up the JAX compile
    cache: send that to a temporary directory, not to the home directory."""
    before = os.environ.get("VTM_COMPILATION_CACHE")
    os.environ["VTM_COMPILATION_CACHE"] = tempfile.mkdtemp(prefix="vtm_jax_cache_")
    try:
        spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}", REPO / "tools" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        if before is None:
            os.environ.pop("VTM_COMPILATION_CACHE")
        else:
            os.environ["VTM_COMPILATION_CACHE"] = before
    return module


def both(array: np.ndarray, dtype: str):
    """One numpy array as a jax and a torch array of ``dtype`` (both round
    to nearest even, so the bf16 values are the same)."""
    return jnp.asarray(array, getattr(jnp, dtype)), torch.from_numpy(array).to(getattr(torch, dtype))


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def assert_close(got: torch.Tensor, want, dtype: str, tol=None, explain=None):
    """``got`` within ``tol`` of ``want``, relative to its largest entry.
    ``explain()``, called only when that fails, adds to the message."""
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err <= (tol or TOL[dtype]), (err, explain() if explain else "")


def deviation_report(got, want, got_again, want_again, exact) -> str:
    """Where a failed comparison was made and what tells a transient
    deviation from one of the host's arithmetic: the CPU code path and the
    fp32 matmul precision; whether a second evaluation of each side gave
    the same bits; how far each side lies from the float64 answer (of its
    largest entry)."""
    got, want, exact = (np.asarray(x, np.float64) for x in (got, want, exact))
    scale = max(np.abs(exact).max(), 1e-6)
    same = {name: "gave the same bits" if np.array_equal(np.asarray(a), np.asarray(b)) else "differed"
            for name, a, b in (("port", got, got_again), ("tool", want, want_again))}
    return (f"CPU capability {torch.backends.cpu.get_cpu_capability()}, {torch.get_num_threads()} threads, "
            f"fp32 matmul precision {torch.get_float32_matmul_precision()}; a second evaluation of the port "
            f"{same['port']}, of the JAX tool {same['tool']}; the port {np.abs(got - exact).max() / scale:.3g} "
            f"and the JAX tool {np.abs(want - exact).max() / scale:.3g} from float64")


# ---- T1 ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("n_pad,blk", [(32, 16), (72, 24)])
def test_t1_chunked_attention(dtype, shared, n_pad, blk):
    tool = jax_tool("ab_bisect")
    tool.B, tool.H, tool.D, tool.N_PAD, tool.BLK = 2, 3, 16, n_pad, blk
    rng = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = (both(normal(rng, 6, n_pad, 16) * s, dtype) for s in (0.5, 1, 1))
    bias = np.log(rng.uniform(1, 5, (1 if shared else 2, 1, n_pad))).astype(np.float32)
    want = tool.call_kernel(jq, jk, jv, jnp.asarray(bias), shared)
    got = ab.chunked_attention(tq, tk, tv, torch.from_numpy(bias), shared, num_heads=3)

    def explain():
        # the answer in float64: softmax(q k^T + the key bias of each row's batch) v
        q, k, v = (t.double().reshape(2, 3, n_pad, 16) for t in (tq, tk, tv))
        logits = q @ k.transpose(-2, -1) + torch.from_numpy(bias).double().reshape(-1, 1, 1, n_pad)
        exact = (torch.softmax(logits, dim=-1) @ v).reshape(6, n_pad, 16)
        again = ab.chunked_attention(tq, tk, tv, torch.from_numpy(bias), shared, num_heads=3)
        want_again = tool.call_kernel(jq, jk, jv, jnp.asarray(bias), shared)
        return deviation_report(got.float().numpy(), np.asarray(want, np.float32), again.float().numpy(),
                                np.asarray(want_again, np.float32), exact.numpy())

    assert_close(got, want, dtype, explain=explain)


# ---- T2, T3, T6, T7: the q k^T probes -----------------------------------------


def test_packed_operands_match_the_numpy_ones():
    """pack_q / pack_k against ab_mxu_pack.py:269-274."""
    rng = np.random.default_rng(2)
    bh, n, d = 4, 10, 8
    q, k = normal(rng, bh, n, d), normal(rng, bh, n, d)
    q4 = q.reshape(bh // 2, 2, n, d)
    qp = np.zeros((bh // 2, 2 * n, 2 * d), np.float32)
    qp[:, 0::2, :d] = q4[:, 0]
    qp[:, 1::2, d:] = q4[:, 1]
    k4 = k.reshape(bh // 2, 2, n, d)
    kc = np.concatenate([k4[:, 0], k4[:, 1]], axis=-1)
    np.testing.assert_array_equal(ab.pack_q(torch.from_numpy(q)).numpy(), qp)
    np.testing.assert_array_equal(ab.pack_k(torch.from_numpy(k)).numpy(), kc)
    assert ab.pack_q(torch.from_numpy(q).to(torch.bfloat16)).dtype == torch.bfloat16


def test_split_bias_carries_fp32_through_bf16():
    bias = torch.tensor([[0.0, 1.2345678, -1e30, float(np.log(3.0))]], dtype=torch.float32)
    hi, lo = ab.split_bias(bias, torch.bfloat16)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, bias.to(torch.bfloat16))
    back = hi.float() + lo.float()
    assert ((back - bias).abs() <= bias.abs() * 2.0 ** -15).all()
    hi32, lo32 = ab.split_bias(bias, torch.float32)
    assert torch.equal(hi32, bias) and not lo32.any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("blk", [64, 128])
def test_t2_qk64(dtype, blk):
    """d = 64 and blk >= 64: the JAX probe slices [:d] of every chunk."""
    tool = jax_tool("ab_mxu_pack")
    rng = np.random.default_rng(3)
    (jq, tq), (jk, tk) = (both(normal(rng, 2, 128, 64), dtype) for _ in range(2))
    assert_close(ab.qk64(tq, tk, blk), tool.qk64(jq, jk, blk), dtype)


def test_t2_t3_depend_on_blk():
    rng = np.random.default_rng(3)
    q, k = (torch.from_numpy(normal(rng, 2, 128, 64)) for _ in range(2))
    assert not torch.allclose(ab.qk64(q, k, 64), ab.qk64(q, k, 128))
    assert not torch.allclose(ab.qk_packed(ab.pack_q(q), ab.pack_k(k), 64),
                              ab.qk_packed(ab.pack_q(q), ab.pack_k(k), 128))
    with pytest.raises(ValueError, match="divide the key count"):
        ab.qk64(q, k, 96)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("blk", [64, 128])
def test_t3_qk_packed(dtype, blk):
    tool = jax_tool("ab_mxu_pack")
    rng = np.random.default_rng(4)
    q, k = normal(rng, 4, 128, 64), normal(rng, 4, 128, 64)
    tq, tk = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k))
    tqp, tkc = ab.pack_q(tq), ab.pack_k(tk)
    jqp, jkc = (jnp.asarray(t.float().numpy(), getattr(jnp, dtype)) for t in (tqp, tkc))
    got = ab.qk_packed(tqp, tkc, blk)
    assert got.shape == (2, 256, 64)
    assert_close(got, tool.qk_packed(jqp, jkc, blk), dtype)
    # even rows are head 1's q k^T, odd rows head 2's
    assert_close(got[:, 0::2], np.asarray(ab.qk64(tq[0::2], tk[0::2], blk).float()), dtype, tol=1e-2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_pad,blk", [(32, 16), (72, 24)])
def test_t6_qk_d64(dtype, n_pad, blk):
    tool = jax_tool("ab_decomp")
    tool.N_PAD, tool.BLK, tool.D = n_pad, blk, 16
    rng = np.random.default_rng(5)
    (jq, tq), (jk, tk) = (both(normal(rng, 3, n_pad, 16), dtype) for _ in range(2))
    got = ab.qk_d64(tq, tk)
    assert got.dtype == torch.float32 and got.shape == (3, n_pad, 1)
    assert_close(got, tool.qk_d64(jq, jk), "float32")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_pad,blk", [(32, 16), (72, 24)])
def test_t7_qk_packed_rowsum(dtype, n_pad, blk):
    tool = jax_tool("ab_decomp")
    tool.N_PAD, tool.BLK, tool.D = n_pad, blk, 16
    rng = np.random.default_rng(6)
    tq, tk = (torch.from_numpy(normal(rng, 4, n_pad, 16)).to(getattr(torch, dtype)) for _ in range(2))
    tqp, tkc = ab.pack_q(tq), ab.pack_k(tk)
    jqp, jkc = (jnp.asarray(t.float().numpy(), getattr(jnp, dtype)) for t in (tqp, tkc))
    got = ab.qk_packed_rowsum(tqp, tkc)
    assert got.dtype == torch.float32 and got.shape == (2, 2 * n_pad, 1)
    assert_close(got, tool.qk_packed(jqp, jkc), "float32")


def _probe_tile_walk(qp, kc, rowsum: bool, tile=64, step=16):
    """T3's and T7's Hopper body (``ab_qk_probe_wgmma``) on the CPU in
    fp32: one fp32 accumulator per row and column c < 64, summed over every
    64-key tile in order (keys past the end zero), each tile's product as
    16-deep k-steps in the kernel's order. T3: the accumulator cast to bf16
    at the end. T7: each row's sum as the kernel takes it, each of a quad's
    four threads l summing its 16 columns 8 j + 2 l + c in order (j, then
    c), then lanes (0 + 1) + (2 + 3)."""
    g, nq, depth = qp.shape
    nk = kc.shape[1]
    q, k = qp.float(), kc.float()
    acc = torch.zeros(g, nq, tile)
    for k0 in range(0, nk, tile):
        kt = torch.zeros(g, tile, depth)
        kt[:, :min(tile, nk - k0)] = k[:, k0:k0 + tile]
        for d0 in range(0, depth, step):
            acc = acc + q[..., d0:d0 + step] @ kt[..., d0:d0 + step].transpose(-2, -1)
    if not rowsum:
        return acc.to(torch.bfloat16)
    cols = acc.view(g, nq, 8, 4, 2)  # column 8 j + 2 l + c at [j, l, c]
    lane = torch.zeros(g, nq, 4)
    for j in range(8):
        for c in range(2):
            lane = lane + cols[..., j, :, c]
    return ((lane[..., 0] + lane[..., 1]) + (lane[..., 2] + lane[..., 3]))[..., None]


def _packed_bf16(seed, bh, n):
    rng = np.random.default_rng(seed)
    tq, tk = (torch.from_numpy(normal(rng, bh, n, 64)).to(torch.bfloat16) for _ in range(2))
    tqp, tkc = ab.pack_q(tq), ab.pack_k(tk)
    return (tqp, tkc), tuple(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tqp, tkc))


@pytest.mark.parametrize("n", [64, 192])
def test_t3_tile_walk_matches_jax_kernel(n):
    """The redesigned T3's arithmetic, emulated by ``_probe_tile_walk``,
    agrees with the JAX tool's kernel (interpret mode, blk 64) on the same
    bf16 packed operands, within the file's bf16 tolerance. 2n rows (128,
    384) leave the Hopper body's last 256-row block half filled. A fault in
    the CUDA kernel shows only on the card (chip_smoke's ``ab_kernels``,
    ``check_ab``)."""
    tool = jax_tool("ab_mxu_pack")
    (tqp, tkc), (jqp, jkc) = _packed_bf16(15, 4, n)
    got = _probe_tile_walk(tqp, tkc, rowsum=False)
    assert got.shape == (2, 2 * n, 64) and got.dtype == torch.bfloat16
    assert_close(got, tool.qk_packed(jqp, jkc, 64), "bfloat16")
    assert_close(got, ab.qk_packed(tqp, tkc).float().numpy(), "bfloat16")


@pytest.mark.parametrize("n,blk", [(37, 37), (200, 40)])
def test_t7_tile_walk_matches_jax_kernel(n, blk):
    """The redesigned T7's arithmetic (``_probe_tile_walk``: 64-key tiles,
    the last ending mid-tile, then the quad-wise row sums) against the JAX
    tool's kernel on the same bf16 packed operands at depth 128; both sum
    in fp32, so within the file's fp32 tolerance, tighter than bf16's."""
    tool = jax_tool("ab_decomp")
    tool.N_PAD, tool.BLK, tool.D = n, blk, 64
    (tqp, tkc), (jqp, jkc) = _packed_bf16(16, 4, n)
    got = _probe_tile_walk(tqp, tkc, rowsum=True)
    assert got.dtype == torch.float32 and got.shape == (2, 2 * n, 1)
    assert_close(got, tool.qk_packed(jqp, jkc), "float32")
    assert_close(got, ab.qk_packed_rowsum(tqp, tkc).numpy(), "float32")


@pytest.mark.parametrize("n,blk", [(37, 37), (64, 64), (200, 40), (320, 64)])
def test_t6_tile_walk_matches_jax_kernel(n, blk):
    """The redesigned T6's arithmetic (``_probe_tile_walk`` at depth 64:
    64-key tiles of four 16-deep k-steps, the last tile ending mid-tile at
    n 37 and 200, then the quad-wise row sums) against the JAX tool's
    kernel on the same bf16 operands; both sum in fp32, so within the
    file's fp32 tolerance. n 64, 200 and 320 leave the Hopper body's last
    row block partly filled."""
    tool = jax_tool("ab_decomp")
    tool.N_PAD, tool.BLK, tool.D = n, blk, 64
    rng = np.random.default_rng(17)
    (jq, tq), (jk, tk) = (both(normal(rng, 4, n, 64), "bfloat16") for _ in range(2))
    got = _probe_tile_walk(tq, tk, rowsum=True)
    assert got.dtype == torch.float32 and got.shape == (4, n, 1)
    assert_close(got, tool.qk_d64(jq, jk), "float32")
    assert_close(got, ab.qk_d64(tq, tk).numpy(), "float32")


@pytest.mark.parametrize("n", [64, 320])
def test_t2_tile_walk_matches_jax_kernel(n):
    """The redesigned T2's arithmetic (``_probe_tile_walk`` at depth 64:
    one fp32 accumulator a column over every 64-key tile, cast to bf16
    once) against the JAX tool's kernel (interpret mode, blk 64) on the
    same bf16 operands, within the file's bf16 tolerance. n 64 and 320
    leave the Hopper body's last row block partly filled."""
    tool = jax_tool("ab_mxu_pack")
    rng = np.random.default_rng(18)
    (jq, tq), (jk, tk) = (both(normal(rng, 4, n, 64), "bfloat16") for _ in range(2))
    got = _probe_tile_walk(tq, tk, rowsum=False)
    assert got.shape == (4, n, 64) and got.dtype == torch.bfloat16
    assert_close(got, tool.qk64(jq, jk, 64), "bfloat16")
    assert_close(got, ab.qk64(tq, tk).float().numpy(), "bfloat16")


def _probe_smem(depth: int) -> dict:
    """``WgSmem<depth>``'s constants of ``csrc/ab_qk_probe.cu``, evaluated
    from the source: the tiling of ``WgTiling<depth>``."""
    import re

    from vtm_torch.ops import build

    text = (build.CSRC / "ab_qk_probe.cu").read_text()
    specialised = text[text.index("struct WgTiling<64> {"):]
    tiling = specialised if depth == 64 else text[text.index("struct WgTiling {"):]
    scope = dict(kDepth=depth, kRows=64, kTileBytes=64 * 128)
    for name, expr in re.findall(r"static constexpr int (\w+) = ([^;]+);", tiling[:tiling.index("};")]):
        scope[name] = int(expr)
    body = text[text.index("struct WgSmem {"):]
    for name, expr in re.findall(r"static constexpr int (\w+) = ([^;]+);", body[:body.index("};")]):
        expr = re.sub(r"WgTiling<kDepth>::(\w+)", r"\1", expr).replace(" / ", " // ")  # C's int division
        scope[name] = eval(re.sub(r"(?:wg::)?k\w+", lambda m: repr(scope[m.group(0).split("::")[-1]]), expr))
    return scope


@pytest.mark.parametrize("depth", [64, 128])
def test_probe_shared_bytes_per_depth_match_the_source(depth):
    """The probe body's tiling is a constant of the depth: its launch
    bytes and the blocks an SM they allow, evaluated from
    ``ab_qk_probe.cu``'s ``WgTiling`` and ``WgSmem``, are the figures of
    ``PROBE_TILING`` that chip_smoke's ab_kernels holds the runtime's
    occupancy calculator to: at depth 64 (T2, T6) 2 row tiles, 4 stages,
    50,176 B, 4 blocks an SM; at 128 (T3, T7) 4, 3, 115,712 B, 2. The
    output stage of the columns form fits the ring's first stage at both
    depths."""
    c = _probe_smem(depth)
    want = {64: (2, 4, 50_176, 4), 128: (4, 3, 115_712, 2)}[depth]
    assert (c["kRowTiles"], c["kStages"], c["kLaunchBytes"], c["kMinBlocks"]) == want
    assert tuple(ab.PROBE_TILING[depth].values()) == want
    assert c["kStage"] >= 64 * 128


# ---- T8, T9, T10: the chain --------------------------------------------------


def chain_inputs(rng, n_pad, dtype):
    return [both(normal(rng, 4, n_pad, 16), dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ab.CHAIN_MODES)
@pytest.mark.parametrize("n_pad,blk", [(32, 16), (72, 24)])
def test_t8_chain(dtype, mode, n_pad, blk):
    """No scale: logits of standard deviation 4 at d = 16. ``nosmax``
    divides by 1e-6, so its outputs are near 1e7; all are compared
    relative to the largest entry. ``linear`` in fp32 gets 2e-3: its
    denominator l = l * corr + sum(p) adds a positive and a negative term
    of some thousand each, so a row whose l lands near zero carries the
    two packages' different summation orders amplified, and that row's
    quotient is the output's largest entry."""
    tool = jax_tool("ab_decomp")
    tool.N_PAD, tool.BLK, tool.D = n_pad, blk, 16
    (jq, tq), (jk, tk), (jv, tv) = chain_inputs(np.random.default_rng(7), n_pad, dtype)
    tol = 2e-3 if (mode, dtype) == ("linear", "float32") else None
    assert_close(ab.chain(tq, tk, tv, mode, blk), tool.chain(jq, jk, jv, mode), dtype, tol)


def test_relative_error_leaves_out_the_rows_that_cancelled():
    want = torch.ones(50, 4)
    want[7] = 1e4  # a row whose denominator fell near zero
    got = want.clone()
    got[7, 0] += 500.0
    got[3, 1] += 0.01
    assert ab.relative_error(got, want) == pytest.approx(0.05)
    assert ab.relative_error(got, want, trim_ill_conditioned=True) == pytest.approx(0.01)
    assert ab.relative_error(got[:7], want[:7], trim_ill_conditioned=True) == pytest.approx(0.01)


def test_t8_linear_depends_on_blk_and_full_does_not():
    (_, q), (_, k), (_, v) = chain_inputs(np.random.default_rng(7), 64, "float32")
    assert not torch.allclose(ab.chain(q, k, v, "linear", 16), ab.chain(q, k, v, "linear", 32), rtol=1e-3)
    for mode in ("full", "nosmax"):
        a, b = ab.chain(q, k, v, mode, 16), ab.chain(q, k, v, mode, 64)
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    with pytest.raises(ValueError, match="mode"):
        ab.chain(q, k, v, "softmax")


def _chain_tile_walk(q, k, v, mode: str, tile=64):
    """T8's ``linear`` and ``nosmax`` on the Hopper body (``wg::attend``
    under the LinearChain and NoSoftmax policies) on the CPU: 64-key tiles,
    fp32 logits in natural units, p rounded to bf16 before p v. ``linear``:
    a running max over the tile's keys (the keys past N masked on a last
    tile that ends early), corr = m_old - m_new, p = x - m_new with a
    masked key's p = 0, the fp32 sum of the fp32 p; ``nosmax``: p = the
    logits (zero-filled keys past N give 0), l stays 0. Then o / max(|l|,
    1e-6), cast to bf16. Operands [..., n, d]."""
    n = k.shape[-2]
    bf16 = lambda t: t.to(torch.bfloat16).float()
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((*q.shape[:-1], 1), ab._MASK)
    l = torch.zeros((*q.shape[:-1], 1))
    o = torch.zeros_like(qf)
    for c0 in range(0, n, tile):
        keys = torch.arange(c0, c0 + tile)
        valid = keys < n
        kt, vt = (t[..., keys.clamp(max=n - 1), :] * valid[:, None] for t in (kf, vf))
        x = qf @ kt.transpose(-2, -1)
        if mode == "nosmax":
            o = o + bf16(x) @ vt
            continue
        x = x.masked_fill(~valid, ab._MASK)
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        corr = m - m_new
        p = torch.where(valid, x - m_new, 0.0)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        o = o * corr + bf16(p) @ vt
        m = m_new
    return (o / l.abs().clamp_min(1e-6)).to(torch.bfloat16)


def assert_chain_close(got, want, mode):
    """The file's bf16 tolerance; ``linear`` on the rows whose denominator
    did not cancel (``ab.relative_error``'s rule)."""
    want = torch.as_tensor(np.asarray(want, np.float32))
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    assert ab.relative_error(got, want, trim_ill_conditioned=mode == "linear") <= TOL["bfloat16"]


@pytest.mark.parametrize("mode", ["linear", "nosmax"])
@pytest.mark.parametrize("n", [64, 192])
def test_t8_tile_walk_matches_jax_kernel(mode, n):
    """The redesigned T8 ``linear`` and ``nosmax`` (``_chain_tile_walk``)
    against the JAX tool's kernel (interpret mode) at its chunk of 64 keys,
    the Hopper body's key tile, on the same bf16 inputs. A fault in the
    CUDA kernel shows only on the card (chip_smoke's ``ab_kernels``,
    ``check_ab``)."""
    tool = jax_tool("ab_decomp")
    tool.N_PAD, tool.BLK, tool.D = n, 64, 16
    (jq, tq), (jk, tk), (jv, tv) = chain_inputs(np.random.default_rng(19), n, "bfloat16")
    got = _chain_tile_walk(tq, tk, tv, mode)
    assert_chain_close(got, tool.chain(jq, jk, jv, mode), mode)
    assert_chain_close(got, ab.chain(tq, tk, tv, mode, 64).float().numpy(), mode)


@pytest.mark.parametrize("mode", ["linear", "nosmax"])
@pytest.mark.parametrize("n,blk", [(37, 37), (200, 40)])
def test_t8_tile_walk_ends_inside_a_tile(mode, n, blk):
    """A last key tile that ends early (keys 192-199 of 200; 37 of one
    tile): the masked walk against the plain version's 64-key chunks, the
    last one short, which the JAX tool cannot cut (its chunks divide N).
    ``nosmax`` sums over keys, so it is also held against the JAX tool at
    chunks of ``blk``."""
    (jq, tq), (jk, tk), (jv, tv) = chain_inputs(np.random.default_rng(20), n, "bfloat16")
    got = _chain_tile_walk(tq, tk, tv, mode)
    assert_chain_close(got, ab.chain(tq, tk, tv, mode, 64).float().numpy(), mode)
    if mode == "nosmax":
        tool = jax_tool("ab_decomp")
        tool.N_PAD, tool.BLK, tool.D = n, blk, 16
        assert_chain_close(got, tool.chain(jq, jk, jv, mode), mode)


@pytest.mark.parametrize("n,blk", [(37, 37), (200, 40)])
def test_t8_full_tile_walk_matches_jax_kernel(n, blk):
    """The redesigned T8 ``full``, K1's unbiased instance at scale 1 on
    [bh, 1, n, d] views (``_k1_walk``), against the JAX tool's kernel on
    the same bf16 inputs; the online softmax telescopes, so any chunk."""
    tool = jax_tool("ab_decomp")
    tool.N_PAD, tool.BLK, tool.D = n, blk, 16
    (jq, tq), (jk, tk), (jv, tv) = chain_inputs(np.random.default_rng(21), n, "bfloat16")
    got = _k1_walk(*(t[:, None] for t in (tq, tk, tv)), 1.0)[:, 0]
    assert_close(got, tool.chain(jq, jk, jv, "full"), "bfloat16")
    assert_close(got, ab.chain(tq, tk, tv, "full").float().numpy(), "bfloat16")


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("n,blk", [(37, 37), (200, 40)])
def test_t1_tile_walk_matches_jax_kernel(shared, n, blk):
    """The redesigned T1, K1's biased instance at scale 1 (``_k1_walk``
    with the bias, a shared row expanded to b rows), against the JAX
    tool's kernel (``ab_bisect.call_kernel``, body ``_kernel_chunked``) on
    the same bf16 inputs, pre-scaled q, per-batch and shared bias."""
    tool = jax_tool("ab_bisect")
    tool.B, tool.H, tool.D, tool.N_PAD, tool.BLK = 2, 3, 16, n, blk
    rng = np.random.default_rng(22)
    (jq, tq), (jk, tk), (jv, tv) = (both(normal(rng, 6, n, 16) * s, "bfloat16") for s in (0.5, 1, 1))
    bias = np.log(rng.uniform(1, 5, (1 if shared else 2, 1, n))).astype(np.float32)
    want = tool.call_kernel(jq, jk, jv, jnp.asarray(bias), shared)
    rows = torch.from_numpy(bias).reshape(-1, n).expand(2, n)
    got = _k1_walk(*(t.view(2, 3, n, 16) for t in (tq, tk, tv)), 1.0, rows).reshape(6, n, 16)
    assert_close(got, want, "bfloat16")
    assert_close(got, ab.chunked_attention(tq, tk, tv, torch.from_numpy(bias), shared, 3).float().numpy(),
                 "bfloat16")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ab.BIAS_MODES)
def test_t9_chain_bias(dtype, mode):
    tool = jax_tool("ab_decomp")
    tool.N_PAD, tool.BLK, tool.D = 48, 16, 16
    rng = np.random.default_rng(8)
    (jq, tq), (jk, tk), (jv, tv) = chain_inputs(rng, 48, dtype)
    bias = np.log(rng.uniform(1, 12, (1, 1, 48))).astype(np.float32)
    want = tool.chain_bias(jq, jk, jv, jnp.asarray(bias), mode)
    assert_close(ab.chain_bias(tq, tk, tv, torch.from_numpy(bias), mode), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_t10_chain_bias_cost(dtype):
    """``chain_bias_cost`` is nested inside ab_decomp.main3 and cannot be
    imported; its body (ab_decomp.py:344-366) is ``chain_bias``'s ``1d``
    body (221-246) line for line with a cost estimate attached, so the
    port's counterpart is held against ``chain_bias(..., "1d")``."""
    tool = jax_tool("ab_decomp")
    tool.N_PAD, tool.BLK, tool.D = 48, 16, 16
    rng = np.random.default_rng(9)
    (jq, tq), (jk, tk), (jv, tv) = chain_inputs(rng, 48, dtype)
    bias = np.log(rng.uniform(1, 12, (1, 1, 48))).astype(np.float32)
    want = tool.chain_bias(jq, jk, jv, jnp.asarray(bias), "1d")
    assert_close(ab.chain_bias_cost(tq, tk, tv, torch.from_numpy(bias)), want, dtype)


def _t9_walk(q, k, v, bias):
    """The bf16 Hopper body of T9 (both modes) and T10: K1's biased
    instance at scale 1 on [bh, 1, n, d] views, the shared row [1, 1, n]
    expanded to every (b, h) (``_k1_walk``). ``2d`` reads the same fp32
    values from shared memory, zero past the last key as ``1d``'s edge rule
    gives them, so one model serves both."""
    rows = bias.reshape(1, -1).expand(q.shape[0], -1)
    return _k1_walk(*(t[:, None] for t in (q, k, v)), 1.0, rows)[:, 0]


@pytest.mark.parametrize("mode", ab.BIAS_MODES)
@pytest.mark.parametrize("n,blk", [(64, 64), (37, 37), (200, 40)])
def test_t9_tile_walk_matches_jax_kernel(mode, n, blk):
    """The redesigned T9 (``_t9_walk``: 64-key tiles, the last ending
    mid-tile at 37 and 200) against the JAX tool's kernel
    (``ab_decomp.chain_bias``, interpret mode) and the port's wrapper on
    the CPU, on the same bf16 inputs and a log-size bias."""
    tool = jax_tool("ab_decomp")
    tool.N_PAD, tool.BLK, tool.D = n, blk, 16
    rng = np.random.default_rng(23)
    (jq, tq), (jk, tk), (jv, tv) = chain_inputs(rng, n, "bfloat16")
    bias = np.log(rng.uniform(1, 12, (1, 1, n))).astype(np.float32)
    got = _t9_walk(tq, tk, tv, torch.from_numpy(bias))
    assert_close(got, tool.chain_bias(jq, jk, jv, jnp.asarray(bias), mode), "bfloat16")
    assert_close(got, ab.chain_bias(tq, tk, tv, torch.from_numpy(bias), mode).float().numpy(), "bfloat16")


@pytest.mark.parametrize("n,blk", [(37, 37), (200, 40)])
def test_t10_tile_walk_matches_jax_kernel(n, blk):
    """The redesigned T10, T9 ``1d``'s walk in a kernel with an occupancy
    target, against ``ab_decomp.chain_bias(..., "1d")`` (its body line for
    line, as ``test_t10_chain_bias_cost`` explains) and the port's wrapper
    on the CPU."""
    tool = jax_tool("ab_decomp")
    tool.N_PAD, tool.BLK, tool.D = n, blk, 16
    rng = np.random.default_rng(24)
    (jq, tq), (jk, tk), (jv, tv) = chain_inputs(rng, n, "bfloat16")
    bias = np.log(rng.uniform(1, 12, (1, 1, n))).astype(np.float32)
    got = _t9_walk(tq, tk, tv, torch.from_numpy(bias))
    assert_close(got, tool.chain_bias(jq, jk, jv, jnp.asarray(bias), "1d"), "bfloat16")
    assert_close(got, ab.chain_bias_cost(tq, tk, tv, torch.from_numpy(bias)).float().numpy(), "bfloat16")


def _smem_constants(policy: dict) -> dict:
    """``ModeSmem<Mode>``'s constants of ``csrc/wgmma_attention.cuh``, and
    ``WalkSmem``'s as ``WalkSmem::<name>``, evaluated from the source with
    the policy's flags ``policy`` (C's ternaries as Python's)."""
    import re

    from vtm_torch.ops import build

    text = (build.CSRC / "wgmma_attention.cuh").read_text()
    scope = dict(kRows=64, kTileBytes=64 * 128, **{f"Mode::{flag}": value for flag, value in policy.items()})
    for struct in ("WalkSmem", "ModeSmem"):
        body = text[text.index(f"struct {struct} {{"):]
        local = {}
        for name, expr in re.findall(r"static constexpr int (\w+) = ([^;]+);", body[:body.index("};")]):
            expr = re.sub(r"(?:\w+::)?k\w+", lambda m: repr({**scope, **local}[m.group(0)]), expr)
            ternary = re.fullmatch(r"(.+?) \? (.+?) : (.+)", expr)
            local[name] = eval(f"({ternary[2]}) if {ternary[1]} else ({ternary[3]})" if ternary else expr)
        scope.update({f"{struct}::{name}": value for name, value in local.items()})
    return {**scope, **local}


def test_staged_bias_keeps_four_blocks_an_sm():
    """T9 ``2d``'s two 256-byte bias slots sit after the output stage and
    keep ab_chain.cu's Hopper kernels at 4 blocks an SM: the launch bytes
    evaluated from ``wgmma_attention.cuh``'s ``WalkSmem`` and ``ModeSmem``
    equal the wrapper's mirror (``ab.chain_smem_bytes``), 50,176 B and
    50,688 B staged, each at most 57,344 B (an SM's 233,472 B over 4, less
    the 1 KB a block reserves). The chip's occupancy calculator says the
    same on the card (chip_smoke's ab_kernels)."""
    flags = dict(kOnes=False, kStageBias=False)
    plain, staged = _smem_constants(flags), _smem_constants(dict(flags, kStageBias=True))
    assert (plain["kLaunchBytes"], staged["kLaunchBytes"]) == (50176, 50688)
    assert staged["kBiasSlots"] % 16 == 0 and staged["kBiasSlots"] >= staged["WalkSmem::kOut"] + 64 * 128
    assert staged["kBiasSlots"] + staged["kBiasBytes"] + 1024 <= staged["kLaunchBytes"]
    sm_bytes, reserved = 233472, 1024  # an H100 SM's shared memory for blocks, and each block's reserve
    for code in ab.CHAIN_CODES:
        want = (staged if code == ab._CHAIN_BIAS_STAGED else plain)["kLaunchBytes"]
        assert ab.chain_smem_bytes(code) == want <= sm_bytes // 4 - reserved == 57344
        assert sm_bytes // (want + reserved) == 4


def test_t9_staged_bias_must_be_aligned(monkeypatch):
    """T9 ``2d`` copies the bias 16 bytes at a time: a row that starts off
    a 16-byte boundary is refused before any launch (``1d`` takes it)."""
    launched = []
    monkeypatch.setattr(ab, "_flat_chain", lambda *args: launched.append(args[:2]))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    q = torch.zeros((2, 40, 64), dtype=torch.bfloat16)
    bias = torch.zeros((1, 1, 41))[..., 1:]
    assert bias.is_contiguous() and bias.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        ab.chain_bias(q, q, q, bias, "2d")
    ab.chain_bias(q, q, q, bias, "1d")
    ab.chain_bias(q, q, q, torch.zeros((1, 1, 40)), "2d")
    assert launched == [("chain_bias", ab._CHAIN_BIAS), ("chain_bias", ab._CHAIN_BIAS_STAGED)]


# ---- T4, T5, T11, T12: whole attention --------------------------------------


def attention_inputs(seed, n, dtype, biased, b=2, h=4, d=16):
    rng = np.random.default_rng(seed)
    qkv = [both(normal(rng, b, h, n, d), dtype) for _ in range(3)]
    bias = np.log(rng.uniform(1, 12, (b, n))).astype(np.float32) if biased else None
    jbias, tbias = (None, None) if bias is None else (jnp.asarray(bias), torch.from_numpy(bias))
    return [j for j, _ in qkv], [t for _, t in qkv], jbias, tbias


def assert_computes_k1(got, tq, tk, tv, tbias, scale, dtype):
    """The same function as K1: against its plain version in fp32."""
    want = _reference(tq.float(), tk.float(), tv.float(), tbias, scale)
    assert_close(got, want.numpy(), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("n", [37, 200])
def test_t4_packed_attention(dtype, biased, n):
    tool = jax_tool("ab_mxu_pack")
    (jq, jk, jv), (tq, tk, tv), jbias, tbias = attention_inputs(10, n, dtype, biased)
    got = ab.packed_attention(tq, tk, tv, tbias, 0.25)
    assert got.shape == (2, n, 64)
    assert_close(got, tool.packed_attention(jq, jk, jv, jbias, 0.25), dtype)
    assert_computes_k1(got.view(2, n, 4, 16).transpose(1, 2), tq, tk, tv, tbias, 0.25, dtype)
    with pytest.raises(ValueError, match="odd"):
        ab.packed_attention(tq[:, :3], tk[:, :3], tv[:, :3], tbias, 0.25)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,blk", [(40, 8), (72, 24)])
def test_t5_grid_swapped(dtype, n, blk):
    tool = jax_tool("ab_b32")
    (jq, jk, jv), (tq, tk, tv), _, _ = attention_inputs(11, n, dtype, False)
    got = ab.grid_swapped(tq, tk, tv, 0.25)
    assert_close(got, tool.grid_swapped(jq, jk, jv, 0.25, blk), dtype)
    assert_computes_k1(got, tq, tk, tv, None, 0.25, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ab.V2_VARIANTS)
@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("n", [37, 200])
def test_t11_v2_attention(dtype, variant, biased, n):
    """``v2_nomax`` takes exp of the raw logits: safe on these inputs
    (standard normal, scale 1/4 at d = 16), unsafe in general."""
    tool = jax_tool("ab_dense_v2")
    (jq, jk, jv), (tq, tk, tv), jbias, tbias = attention_inputs(12, n, dtype, biased)
    got = ab.v2_attention(tq, tk, tv, tbias, 0.25, variant)
    assert_close(got, tool.v2_attention(jq, jk, jv, jbias, 0.25, variant), dtype)
    assert_computes_k1(got, tq, tk, tv, tbias, 0.25, dtype)


def _v2_tile_walk(q, k, v, bias, scale, variant, tile=64):
    """T11's Hopper body (``wg::attend`` under the OnesColumn, FoldedBias
    and FoldedNoMax policies) on the CPU in fp32, p rounded to bf16: 64-key
    tiles, logits in log2 units; the denominator the sum of the rounded p
    (the ones column of p v), rescaled by the max's correction as o is;
    ``v2_sum`` adds the fp32 bias and masks the keys past N on the ragged
    last tile, the folded two add hi + lo, the bf16 split of the bias, with
    keys past N at hi = bf16(-1e30) and lo its residual, and mask nothing;
    ``v2_nomax`` takes no max."""
    b, h, n, _ = q.shape
    log2e = 1.4426950408889634
    bf16 = lambda t: t.to(torch.bfloat16).float()
    qs = bf16(q * scale)
    fp32_bias = torch.zeros(b, n) if bias is None else bias
    hi, lo = ab.split_bias(fp32_bias, torch.bfloat16)
    mask_hi = bf16(torch.tensor(ab._MASK))
    mask_lo = bf16(torch.tensor(ab._MASK) - mask_hi)
    m = torch.full((b, h, n, 1), ab._MASK)
    l_ones = torch.zeros((b, h, n, 1))
    o = torch.zeros_like(q)
    for c0 in range(0, n, tile):
        keys = torch.arange(c0, c0 + tile)
        valid = keys < n
        at = keys.clamp(max=n - 1)
        kt, vt = (t[:, :, at] * valid[:, None] for t in (k, v))
        x = qs @ kt.transpose(-2, -1)
        if variant == "v2_sum":
            x = (x + (fp32_bias[:, at] * valid)[:, None, None, :]) * log2e
            if c0 + tile > n:
                x = x.masked_fill(~valid, ab._MASK)
        else:
            fold = torch.where(valid, hi.float()[:, at] + lo.float()[:, at], mask_hi + mask_lo)
            x = (x + fold[:, None, None, :]) * log2e
        if variant == "v2_nomax":
            p = bf16(torch.exp2(x))
            l_ones = l_ones + p.sum(dim=-1, keepdim=True)
            o = o + p @ vt
            continue
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = bf16(torch.exp2(x - m_new))
        l_ones = l_ones * corr + p.sum(dim=-1, keepdim=True)
        o = o * corr + p @ vt
        m = m_new
    return o / l_ones


@pytest.mark.parametrize("variant", ab.V2_VARIANTS)
@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("n", [37, 200])
def test_t11_tile_walk_matches_jax_kernel(variant, biased, n):
    """The redesigned T11's arithmetic, emulated by ``_v2_tile_walk``,
    agrees with the JAX tool's kernel (interpret mode) on the same bf16
    inputs, where the tool also rounds p to bf16 before p v: within the
    file's bf16 tolerance. A fault in the CUDA kernel shows only on the
    card (chip_smoke's ``ab_kernels``, ``check_ab``)."""
    tool = jax_tool("ab_dense_v2")
    (jq, jk, jv), (tq, tk, tv), jbias, tbias = attention_inputs(12, n, "bfloat16", biased)
    want = tool.v2_attention(jq, jk, jv, jbias, 0.25, variant)
    got = _v2_tile_walk(tq.float(), tk.float(), tv.float(), tbias, 0.25, variant)
    assert_close(got, want, "bfloat16")


@pytest.mark.parametrize("hopper", [True, False], ids=["hopper_body", "first_body"])
@pytest.mark.parametrize("b,h,n", [(2, 4, 37), (1, 2, 64), (2, 12, 200), (1, 2, 1)])
def test_t4_plan_covers_every_head_row_once(b, h, n, hopper):
    """T4's head-pair plan (``ab_attention.packed_plan``): every (batch,
    head, row) exactly once, from a block that holds both heads of its
    pair, and head h written to columns [h d, (h + 1) d) of the token-major
    output."""
    (grid_x, grid_y), block = ab.packed_plan(b, h, n, hopper)
    assert grid_y == b * h // 2
    seen = np.zeros((b, h, n), dtype=int)
    for y in range(grid_y):
        for x in range(grid_x):
            writes = block(x, y)
            heads = [head for _, head, _, _, _ in writes]
            assert heads[0] % 2 == 0 and heads == [heads[0], heads[0] + 1]
            for batch, head, r0, rows, col in writes:
                assert 1 <= rows <= (64 if hopper else 32) and col == head * ab.HEAD_DIM
                seen[batch, head, r0:r0 + rows] += 1
    np.testing.assert_array_equal(seen, 1)
    with pytest.raises(ValueError, match="odd"):
        ab.packed_plan(b, h + 1, n, hopper)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,h", [(37, 4), (1152, 1)])
def test_t12_n8_attention(dtype, n, h):
    """N 37 pads to 40 in the JAX kernel (one chunk, pad keys masked by an
    iota); N 1152 takes its chunked branch (two chunks of 576)."""
    tool = jax_tool("ab_block_attn")
    (jq, jk, jv), (tq, tk, tv), _, _ = attention_inputs(13, n, dtype, False, b=1, h=h)
    got = ab.n8_attention(tq, tk, tv, 0.25)
    assert_close(got, tool.n8_attention(jq, jk, jv, 0.25), dtype)
    assert_computes_k1(got, tq, tk, tv, None, 0.25, dtype)


def _k1_walk(q, k, v, scale, bias=None):
    """The bf16 Hopper body of T5, T12, T8 ``full`` and, with an fp32
    ``bias`` [B, N], T1: K1's instances of the tile loop, on the CPU: q *
    scale in fp32 rounded to bf16 (``stage_q``), then K1's ``_tile_walk``
    with p rounded to bf16 before p v, the quotient cast to bf16."""
    qs = (q.float() * scale).to(torch.bfloat16).float()
    out, _ = _tile_walk(qs, k.float(), v.float(), bias, 1.0, p_dtype=torch.bfloat16)
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("n,blk", [(37, 37), (200, 40)])
def test_t5_tile_walk_matches_jax_kernel(n, blk):
    """The redesigned T5's arithmetic (``_k1_walk``: 64-key tiles, the last
    ending mid-tile) against the JAX tool's kernel (interpret mode, the
    grid swapped) on the same bf16 inputs at d 64, within the file's bf16
    tolerance. The block order changes no number; a fault in the CUDA
    kernel shows only on the card (chip_smoke's ``ab_kernels``, which holds
    its bits against K1's, and ``check_ab``)."""
    tool = jax_tool("ab_b32")
    (jq, jk, jv), (tq, tk, tv), _, _ = attention_inputs(17, n, "bfloat16", False, d=64)
    got = _k1_walk(tq, tk, tv, 0.125)
    assert_close(got, tool.grid_swapped(jq, jk, jv, 0.125, blk), "bfloat16")
    assert_close(got, ab.grid_swapped(tq, tk, tv, 0.125).float().numpy(), "bfloat16")


@pytest.mark.parametrize("n", [37, 200])
def test_t12_tile_walk_matches_jax_kernel(n):
    """The same for T12 against ``ab_block_attn.n8_attention``, which pads
    N to a multiple of 8 and masks the pad keys by index; q, k, v are
    split-heads views of one fused projection, as the card runs them."""
    tool = jax_tool("ab_block_attn")
    rng = np.random.default_rng(18)
    fused = torch.from_numpy(normal(rng, 2, n, 3 * 4 * 64)).to(torch.bfloat16)
    tq, tk, tv = (t.unflatten(-1, (4, 64)).transpose(1, 2) for t in fused.chunk(3, dim=-1))
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tq, tk, tv))
    got = _k1_walk(tq, tk, tv, 0.125)
    assert_close(got, tool.n8_attention(jq, jk, jv, 0.125), "bfloat16")
    assert_close(got, ab.n8_attention(tq, tk, tv, 0.125).float().numpy(), "bfloat16")


@pytest.mark.parametrize("swap", [True, False], ids=["T5", "T12"])
@pytest.mark.parametrize("b,h,n", [(8, 12, 1568), (32, 12, 1568), (2, 3, 37), (1, 1, 1)])
def test_chain_plan_covers_every_head_row_once(b, h, n, swap):
    """``ab_attention.chain_plan``, the launch plan both bodies of
    ``ab_chain.cu`` map: every (batch, head, row) written once, at most 64
    rows a block, within the grid's y limit; swapped (T5) neighbouring
    blocks in x hold different heads, unswapped (T12, K1) the same head's
    next q tile."""
    (grid_x, grid_y), block = ab.chain_plan(b, h, n, swap)
    assert grid_x * grid_y == b * h * -(-n // ab.KEY_TILE) and grid_y <= ab._MAX_GRID_Y
    seen = np.zeros((b, h, n), dtype=int)
    for y in range(grid_y):
        for x in range(grid_x):
            batch, head, r0, rows = block(x, y)
            assert 1 <= rows <= ab.KEY_TILE
            seen[batch, head, r0:r0 + rows] += 1
            if x:
                same_head = block(x - 1, y)[:2] == (batch, head)
                assert same_head != swap
    np.testing.assert_array_equal(seen, 1)


def test_t5_t12_launch_k1s_instance(monkeypatch):
    """T5 and T12 pass ab_chain.cu the variant of K1's instance, T8's
    ``full`` (code 0: K1's unbiased instance in bf16), with their scale, T5
    with the grid swapped, and a token-major output buffer."""
    calls = []
    monkeypatch.setattr(ab, "_launch_chain", lambda *args: calls.append(args))
    q = _meta((2, 3, 40, 64))
    for name, swap in (("grid_swapped", True), ("n8_attention", False)):
        ab._unbiased(name, q, q, q, 0.125, swap)
    for (name, variant, *_, out, scale, swap), want in zip(calls, (("grid_swapped", True), ("n8_attention", False))):
        assert (name, swap) == want and variant == ab._CHAIN_FULL == ab._CHAIN_MODE_CODES["full"]
        assert out.shape == q.shape and out.transpose(1, 2).is_contiguous() and scale == 0.125


def _chain_dispatch():
    """{variant code: the launch of ``ab_chain.cu``'s dispatch_variant}, the
    enums' names resolved to their values: ``launch_either`` is the Hopper
    body in bf16 (the first body in fp32), ``launch`` the first body."""
    import re

    from vtm_torch.ops import build

    text = (build.CSRC / "ab_chain.cu").read_text()
    names = {name: int(value) for name, value in re.findall(r"\b(k[A-Za-z]+) = (\d+)", text)}
    body = text[text.index("cudaError_t dispatch_variant("):text.index("default: return cudaErrorInvalidValue")]
    dispatch, labels = {}, []
    for label, launch in re.findall(r"case (\w+):(?:\s*return (launch_either|launch)<)?", body):
        labels.append(int(names.get(label, label)))
        if launch:
            dispatch.update({code: launch for code in labels})
            labels = []
    return dispatch


def test_t1_t8_launch_hopper_variants(monkeypatch):
    """On a CUDA tensor T8 passes its mode's code (0, 1, 2), T1 a code of
    its own (6, a per-batch bias row of stride n or a shared one of stride
    0), T9 ``1d``, ``2d`` and T10 codes 3, 4 and 5 (a shared row, stride
    0); ab_chain.cu sends every code to the Hopper body in bf16 (3 and 6
    to K1's biased instance, 4 under ``StagedBias``, 5 to the hinted
    kernel) and to the first body in fp32. No wrapper reaches K1's entry
    point: the bits K1 gives come from its instance."""
    import inspect

    calls = []
    monkeypatch.setattr(ab, "_launch_chain", lambda *args: calls.append(args))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    q = _meta((6, 40, 64))
    per_batch, shared = (torch.empty((rows, 1, 40), device="meta") for rows in (2, 1))
    for mode in ab.CHAIN_MODES:
        ab.chain(q, q, q, mode)
    ab.chunked_attention(q, q, q, per_batch, False, 3)
    ab.chunked_attention(q, q, q, shared, True, 3)
    for mode in ab.BIAS_MODES:
        ab.chain_bias(q, q, q, shared, mode)
    ab.chain_bias_cost(q, q, q, shared)
    got = [(name, variant, stride) for name, variant, _, _, _, _, stride, *_ in calls]
    assert got == [("chain", 1, 0), ("chain", 2, 0), ("chain", 0, 0), ("chunked_attention", 6, 40),
                   ("chunked_attention", 6, 0), ("chain_bias", 3, 0), ("chain_bias", 4, 0),
                   ("chain_bias_cost", 5, 0)]
    assert [ab._CHAIN_MODE_CODES[m] for m in ("full", "nosmax", "linear")] == [0, 1, 2]
    assert ab._CHAIN_ATTENTION_BIAS == 6
    assert _chain_dispatch() == {c: "launch_either" for c in ab.CHAIN_CODES}
    from vtm_torch.ops import build

    text = (build.CSRC / "ab_chain.cu").read_text()
    for code, instance in ((3, "kBiasPerElement, wg::Softmax>"), (4, "kBiasStaged, wg::StagedBias>"),
                           (5, "kBiasPerElement, wg::Softmax, true>"), ("kAttentionBias", "kBiasPerElement, wg::Softmax>")):
        assert f"case {code}: return launch_either<T, kFull, {instance}(a);" in text
    for fn in (ab.chain, ab.chunked_attention, ab._flat_chain, ab._launch_chain):
        code = inspect.getsource(fn)
        assert "flash_attention" not in code and "vtm_attention_fwd" not in code


# ---- the wrappers' refusals and counters ---------------------------------------


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("name", ["qk64", "qk_packed", "chain"])
@pytest.mark.parametrize("blk", [16, 128, 800])
def test_kernels_take_no_other_blk(name, blk):
    """On the card the three chunk-dependent functions work in key tiles
    of 64 and raise for any other blk: nothing falls back."""
    with pytest.raises(ValueError, match="takes no other blk"):
        ab._check_blk(name, blk)
    ab._check_blk(name, ab.KEY_TILE)


@pytest.mark.parametrize(
    "operands,dims,last,match",
    [
        ([_meta((6, 40, 64))] * 2, 3, 64, "CUDA device"),
        ([_meta((6, 40, 64), torch.float16)] * 2, 3, 64, "bfloat16 or float32"),
        ([_meta((6, 40, 64)), _meta((6, 40, 64), torch.float32)], 3, 64, "share q's dtype"),
        ([_meta((6, 40, 48))] * 2, 3, 64, "last dim of 64"),
        ([_meta((2, 3, 40, 64))] * 2, 3, 64, "3 dims"),
        ([_meta((6, 40, 128))[:, :, ::2]] * 2, 3, 64, "contiguous in its last dim"),
    ],
)
def test_kernel_operands_rejected(operands, dims, last, match):
    """The wrappers' checks raise on what the kernels do not take (run
    here on meta tensors; on the card they guard every launch)."""
    with pytest.raises(ValueError, match=match):
        ab._check_operands(list(zip(("q", "k"), operands)), dims, last)


def test_cpu_calls_launch_no_kernel():
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(normal(rng, 2, 64, 64)) for _ in range(3))
    ab.chain(q, k, v, "full")
    ab.qk64(q, k)
    ab.n8_attention(q[None], k[None], v[None], 0.125)
    assert len(ab.AB_LAUNCHES) == 12 and not any(ab.AB_LAUNCHES.values())


def test_sources_hold_kernels_of_their_own():
    """Three CUDA sources, each with a note on the TPU function it
    replaces: ab_chain.cu three __global__ templates, the first body's
    fp32 template on FMA units and the Hopper kernel of every variant on
    the shared wgmma tile loop: K1's instances (variant codes 0, 3 and 6),
    T8's two policies LinearChain and NoSoftmax, T9 2d's StagedBias, and
    the same loop under T10's occupancy target, with no wmma left;
    ab_qk_probe.cu two, the first body's fp32 template on FMA units and
    the Hopper template of T2, T3, T6 and T7 (bf16 at depth 64 and 128) on
    wgmma_tiles.cuh's products, with no wmma left (since T2 and T6 moved
    to the Hopper template); ab_dense_variants.cu two, the first body's fp32 template on
    FMA units and the bf16 template on the shared wgmma tile loop, with no
    wmma left. None calls a library's product or attention, or K1's entry
    point; the wrappers call no matrix product either."""
    import inspect

    from vtm_torch.ops import build

    for name, replaced in (("ab_qk_probe.cu", "ab_mxu_pack.py"), ("ab_chain.cu", "ab_decomp.py"),
                           ("ab_dense_variants.cu", "ab_dense_v2.py")):
        text = (build.CSRC / name).read_text()
        assert replaced in text
        if name == "ab_dense_variants.cu":
            assert text.count("__global__") == 2 and "ab_mxu_pack.py" in text
            assert "ab_dense_variant_kernel(const float*" in text and "wg::attend<" in text
            assert '#include "wgmma_attention.cuh"' in text and "wmma" not in text
        elif name == "ab_qk_probe.cu":
            assert text.count("__global__") == 2 and "wmma" not in text and "ab_decomp.py" in text
            assert '#include "wgmma_tiles.cuh"' in text and "ab_qk_probe_wgmma(" in text and "wg::mma_ss(" in text
            assert "ab_qk_probe_kernel(const T*" in text and "std::is_same<T, float>::value" in text
            assert "launch_bf16<64>(" in text and "launch_bf16<128>(" in text
        else:
            assert text.count("__global__") == 3 and "wmma" not in text
            assert "ab_chain_kernel(const T*" in text and "ab_attention_hinted_wgmma(" in text
            assert "__launch_bounds__(wg::kThreads, kHintedBlocks)" in text and "wg::StagedBias" in text
            assert "ab_b32.py" in text and "ab_block_attn.py" in text
            assert '#include "wgmma_attention.cuh"' in text and "ab_attention_wgmma(" in text
            assert "wg::attend<kBias, wg::AllPairs, Policy>(w, wg::AllPairs(), smem)" in text
            assert f"kAttentionBias = {ab._CHAIN_ATTENTION_BIAS}" in text
            assert "wg::LinearChain" in text and "wg::NoSoftmax" in text and "ab_bisect.py" in text
        for foreign in ("cublas", "cudnn", "cutlass", "vtm_attention_fwd"):
            assert foreign not in text, (name, foreign)
    for fn in (ab._launch_chain, ab._launch_probe, ab._launch_dense, ab._flat_chain, ab._unbiased):
        code = inspect.getsource(fn)
        for foreign in ("scaled_dot_product_attention", "matmul", "bmm", "einsum", "torch.compile", "_plain"):
            assert foreign not in code, (fn.__name__, foreign)


def test_ptxas_report_names_each_chain_instance():
    """``build.parse_ptxas`` tells ab_chain.cu's Hopper instances apart by
    their kernel's name (T10's ``ab_attention_hinted_wgmma`` from
    ``ab_attention_wgmma``) and mangled template arguments (the bias switch
    and the softmax policy, a class: T9 2d's ``StagedBias``), as
    chip_smoke's ab_kernels phase reads them against
    ``AB_CHAIN_HOPPER_INSTANCES``; the first body's and K1's rows keep
    their form."""
    import chip_smoke
    from vtm_torch.ops import build

    def entry(mangled, registers, spills=0):
        return (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
                f"ptxas info    : Function properties for {mangled}\n"
                f"    0 bytes stack frame, {spills} bytes spill stores, {spills} bytes spill loads\n"
                f"ptxas info    : Used {registers} registers, used 1 barriers, 560 bytes cmem[0]\n")

    args = "EvPK13__nv_bfloat16S4_S4_PKfPS2_iifxiNS_7StridesE"
    hopper = sorted(chip_smoke.AB_CHAIN_HOPPER_INSTANCES)
    assert {(kernel, policy) for kernel, _, policy in hopper} >= {
        ("ab_attention_wgmma", "StagedBias"), ("ab_attention_hinted_wgmma", "Softmax")}
    text = "".join(entry(f"_ZN12_GLOBAL__N_1{len(kernel)}{kernel}ILb{bias}EN3vtm2wg{len(policy)}{policy}E{args}", 128)
                   for kernel, bias, policy in hopper)
    text += entry("_ZN12_GLOBAL__N_115ab_chain_kernelIfLi2ELi0ELi1EEEvPKT_", 96, spills=8)
    text += entry("_Z19attention_fwd_wgmmaILb1EEvPK13__nv_bfloat16", 120)
    rows = build.parse_ptxas(text)
    k = len(hopper)
    assert [(r["kernel"], r["template_args"][0], r["policy"]) for r in rows[:k]] == hopper
    assert all(r["registers"] == 128 for r in rows[:k])
    assert (rows[k]["kernel"], rows[k]["dtype"], rows[k]["template_args"]) == ("ab_chain_kernel", "fp32", [2, 0, 1])
    assert (rows[k]["spill_store_bytes"], rows[k]["registers"]) == (8, 96) and "policy" not in rows[k]
    assert rows[k + 1] == dict(kernel="attention_fwd_wgmma", dtype="bf16", head_dim=64, template_args=[1],
                               spill_store_bytes=0, spill_load_bytes=0, registers=120)


def test_card_cases_cover_every_function_and_mode(capsys):
    """The rows the card's checks run (``ab_dense.exp_kernels``, used by
    ``check_ab`` and chip_smoke.py's ab_kernels phase): every T id, every
    mode, each with its useful operations, its bytes and a finite error
    inside the tolerance; on the CPU a row's wrapper call and its plain
    version are the same computation, and no launch count moves."""
    from vtm_torch.tools import ab_dense

    sizes = ab_dense.Sizes(b8=1, h=2, n_pad=192, packed_ns=(40,))
    rows = ab_dense.exp_kernels(ab_dense.Bench(torch.device("cpu"), sizes, 0, 1, 1, dtype=torch.float32))
    assert [json.loads(line)["name"] for line in capsys.readouterr().out.splitlines()] == [r["name"] for r in rows]
    ids = [r["kernel"] for r in rows]
    assert ids == sorted(ids, key=lambda t: int(t[1:])) and set(ids) == {f"T{i}" for i in range(1, 13)}
    assert {r["function"] for r in rows} == set(ab.AB_LAUNCHES)
    modes = {r.get("mode", "") for r in rows}
    assert set(ab.CHAIN_MODES) | set(ab.BIAS_MODES) <= modes
    assert all(any(v in m for m in modes) for v in ab.V2_VARIANTS)
    for row in rows:
        assert row["flops"] > 0 and row["nbytes"] > 0 and row["ms"]["median"] > 0 and row["plain_ms"] > 0
        assert row["err_vs_plain"] == 0.0 and row["rel_err_vs_fp32ref"] == 0.0 and row["dtype"] == "float32"
        assert row["tol"] == (ab_dense.LINEAR_TOL if row.get("mode") == "linear" else ab_dense.FP32_TOL)
    by_id = {r["kernel"]: r for r in rows}
    for probe in ("T2", "T3", "T6", "T7"):  # one pass over k and a narrow product, not the n x n product
        assert by_id[probe]["bound_flops"] < by_id[probe]["flops"] and by_id[probe]["library_ms"] > 0
    # the packed probes also at ragged token counts; their products issued, zeros included, twice the useful
    ragged = {(r["kernel"], r["mode"]) for r in rows if r.get("mode", "").startswith("n ")}
    assert ragged == {(tid, f"n {n}") for tid, n in ab_dense.Sizes().ragged_probes}
    for row in rows:
        packed = row["kernel"] in ("T3", "T7")
        assert row.get("issued_flops", 0.0) == (2 * row["flops"] if packed else 0.0)
    assert not any(ab.AB_LAUNCHES.values())
    assert ab_dense.tolerance(torch.float32, True, 0.0) == ab_dense.LINEAR_TOL > ab_dense.FP32_TOL
    assert ab_dense.tolerance(torch.bfloat16, False, 0.02) == 0.04
    assert ab_dense.tolerance(torch.bfloat16, False, 0.0) == ab_dense.BF16_FLOOR


def test_k1_bits_runs_on_the_card_only():
    """``ab_dense.k1_bits`` holds T5's and T12's bf16 bits against K1's;
    on the CPU the plain versions round otherwise, so it refuses. Its
    ragged token counts end inside a key tile."""
    from vtm_torch.tools import ab_dense

    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="on the card"):
            ab_dense.k1_bits(ab_dense.Bench(torch.device("cpu"), ab_dense.CPU_SIZES, 0, 1, 1, dtype=dtype))
    assert all(n % ab.KEY_TILE for n in ab_dense.K1_BITS_RAGGED_N)


def test_ragged_probes_end_inside_a_key_tile():
    """The card's ragged cases of T6 and T7 (``ab_dense.Sizes.ragged_probes``):
    key counts that end inside a 64-key tile and that span several tiles,
    which the probes' shape (n 1600, 25 full tiles) does not reach."""
    from vtm_torch.tools import ab_dense

    ns = [n for tid, n in ab_dense.Sizes().ragged_probes]
    assert {tid for tid, _ in ab_dense.Sizes().ragged_probes} == {"T6", "T7"}
    assert all(n % ab.KEY_TILE for n in ns) and any(n > ab.KEY_TILE for n in ns)


@pytest.mark.parametrize("arg,want", [("ab", ("ab",)), ("digests,ab", ("ab", "digests")),
                                      ("times,all", ("times", "packing", "backward", "ab", "digests"))])
def test_kernel_times_takes_a_list_of_experiments(arg, want):
    """``kernel_times --exp ab,digests`` (one process a tree when two trees
    are timed in turns): the named experiments in their fixed order."""
    from vtm_torch.tools import kernel_times

    assert kernel_times.experiments(arg) == want
    with pytest.raises(Exception, match="unknown experiments"):
        kernel_times.experiments(arg + ",probes")


def test_ptxas_report_names_each_probe_instance():
    """``build.parse_ptxas`` reads ab_qk_probe.cu's Hopper instances by
    their mangled template arguments (depth, rowsum), as chip_smoke's
    ab_kernels phase holds them against ``AB_QK_PROBE_INSTANCES``; the
    first body's fp32 rows keep their form."""
    import chip_smoke
    from vtm_torch.ops import build

    def entry(mangled, registers):
        return (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
                f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
                f"ptxas info    : Used {registers} registers, used 1 barriers, 392 bytes cmem[0]\n")

    text = "".join(entry(f"_ZN12_GLOBAL__N_117ab_qk_probe_wgmmaILi{depth}ELb{rowsum}EEEvPK13__nv_bfloat16S3_Pvii", 160)
                   for depth, rowsum in sorted(chip_smoke.AB_QK_PROBE_INSTANCES))
    text += entry("_ZN12_GLOBAL__N_118ab_qk_probe_kernelIfLi64ELb1EEEvPKT_S3_Pvii", 90)
    rows = build.parse_ptxas(text)
    assert [tuple(r["template_args"]) for r in rows[:4]] == sorted(chip_smoke.AB_QK_PROBE_INSTANCES)
    assert all(r["kernel"] == "ab_qk_probe_wgmma" and r["spill_store_bytes"] == 0 for r in rows[:4])
    assert (rows[4]["kernel"], rows[4]["dtype"], rows[4]["template_args"]) == ("ab_qk_probe_kernel", "fp32", [64, 1])


@pytest.mark.parametrize("name,args", [("T2", "qk"), ("T3", "packed"), ("T6", "qk"), ("T7", "packed")])
def test_probe_library_calls_compute_the_probes(name, args):
    """The one-einsum yardsticks of the four probes give the plain
    versions' numbers (T6 / T7 without the kept dim)."""
    from vtm_torch.tools import ab_dense

    bench = ab_dense.Bench(torch.device("cpu"), ab_dense.CPU_SIZES, 3, 1, 1, dtype=torch.float32)
    q, k = bench.randn(4, 128, 64), bench.randn(4, 128, 64)
    row = ab_dense._probe_rows(bench, q, k)[name]
    want = row.plain_as(None)
    got = row.library().reshape(want.shape)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_cancelled_rows_names_the_rows_left_out():
    want = torch.ones(50, 4)
    want[7] = 1e4
    exact = want.double()
    got, plain = want.clone(), want.clone()
    got[7, 0] += 500.0
    plain[7, 1] -= 1000.0
    rows = ab.cancelled_rows(got, plain, want, exact)
    assert (rows["rows"], rows["left_out"], rows["share"]) == (50, 1, pytest.approx(0.02))
    assert rows["kernel_row_err_vs_fp64"] == pytest.approx(0.05) and rows["plain_row_err_vs_fp64"] == pytest.approx(0.1)
    assert ab.cancelled_rows(want[:7], want[:7], want[:7], exact[:7]) == dict(rows=7, left_out=0, share=0.0)


def test_chain_runs_in_fp64_on_fp64_operands():
    (_, q), (_, k), (_, v) = chain_inputs(np.random.default_rng(7), 64, "float32")
    out = ab.chain_plain(q.double(), k.double(), v.double(), "full", 16)
    assert out.dtype == torch.float64
    assert (out.float() - ab.chain_plain(q, k, v, "full", 16)).abs().max() <= 1e-5 * out.abs().max()


# ---- the slice as a whole ------------------------------------------------------


def test_entry_point_on_the_cpu(capsys):
    """``ab_dense --exp all`` on the CPU: the plain versions at a small
    shape; a row for every T id, each with a finite error."""
    from vtm_torch.tools import ab_dense

    ab_dense.main(["--exp", "all"], device="cpu")
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    by_kernel = {}
    for row in rows:
        if "kernel" in row:
            by_kernel.setdefault(row["kernel"], []).append(row)
    assert set(by_kernel) == {f"T{i}" for i in range(1, 13)} | {"K1"}
    for rows_ in by_kernel.values():
        for row in rows_:
            assert row["device"] == "cpu" and np.isfinite(row["err_vs_plain"]) and row["ms"]["median"] > 0
    exps = {row["exp"] for row in rows if "exp" in row}
    assert exps == set(ab_dense.EXPERIMENTS)
    assert sum(1 for row in rows if row.get("name", "").startswith("prod")) >= len(ab_dense.EXPERIMENTS)


def test_entry_point_refuses_to_run_without_cuda():
    from vtm_torch.tools import ab_dense

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA device"):
        ab_dense.main(["--exp", "decomp"])
