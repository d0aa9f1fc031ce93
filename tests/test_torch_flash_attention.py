"""The port's attention (K1) wrapper against the JAX package's kernel.

On the CPU the port's ``tome_flash_attention`` runs its plain version;
the JAX side runs the Pallas kernel in interpret mode, as
tests/test_flash_attention.py does. The CUDA kernel itself is checked
against the plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vtm.ops.flash_attention import tome_flash_attention as jax_attention
from vtm_torch.ops import build, flash_attention
from vtm_torch.ops.flash_attention import check_kernel_args, tome_flash_attention

torch.set_num_threads(2)


def _inputs(n, with_bias, b=2, h=3, d=64, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3))
    bias = np.log(rng.uniform(1, 5, (b, n))).astype(np.float32) if with_bias else None
    return q, k, v, bias


@pytest.mark.parametrize("n", [37, 256, 300])
@pytest.mark.parametrize("with_bias", [False, True])
def test_matches_jax_kernel(n, with_bias):
    q, k, v, bias = _inputs(n, with_bias)
    want = np.asarray(
        jax_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if bias is None else jnp.asarray(bias), 0.125,
        )
    )
    got = tome_flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias), 0.125,
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n", [37, 300])
@pytest.mark.parametrize("with_bias", [False, True])
def test_plain_lse_is_the_logsumexp_of_the_logits(n, with_bias):
    """K1's plain version with want_lse: the same output, and the fp32
    log-sum-exp of each row's logits (q * scale) k^T + bias, as numpy
    computes it in float64."""
    q, k, v, bias = _inputs(n, with_bias, seed=3)
    args = [torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            None if bias is None else torch.from_numpy(bias), 0.125]
    out, lse = flash_attention._forward(*args, want_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    np.testing.assert_array_equal(out.numpy(), flash_attention._forward(*args).numpy())
    logits = np.einsum("bhqd,bhkd->bhqk", (q * 0.125).astype(np.float64), k.astype(np.float64))
    if bias is not None:
        logits = logits + bias[:, None, None, :]
    m = logits.max(axis=-1)
    want = m + np.log(np.exp(logits - m[..., None]).sum(axis=-1))
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-6 * max(1.0, np.abs(want).max()))


def _tile_walk(q, k, v, bias, scale, tile=64, p_dtype=None):
    """The Hopper body's arithmetic on the CPU in fp32: 64-key tiles, an
    online softmax in log2 units (the bias added, and the keys past N
    masked on the last, ragged, tile only, where the running max is taken),
    o / l at the end, and each row's natural-log log-sum-exp from the log2
    running max m and denominator l, (m + log2 l) ln 2: what K2 reads. With
    ``p_dtype`` p is rounded to it before p v, as the bf16 kernel rounds
    it; l sums the unrounded p."""
    n = q.shape[2]
    qs = q * scale
    m = torch.full(q.shape[:3], -1e30)
    l = torch.zeros(q.shape[:3])
    o = torch.zeros_like(q)
    log2e = 1.4426950408889634
    for c0 in range(0, n, tile):
        keys = torch.arange(c0, c0 + tile)
        valid = keys < n
        kt, vt = (t[:, :, keys.clamp(max=n - 1)] * valid[:, None] for t in (k, v))
        x = qs @ kt.transpose(-2, -1)
        if bias is not None:
            x = x + (bias[:, keys.clamp(max=n - 1)] * valid)[:, None, None, :]
        x = x * log2e
        if c0 + tile > n:
            x = x.masked_fill(~valid, -1e30)
        m_new = torch.maximum(m, x.max(dim=-1).values)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + (p if p_dtype is None else p.to(p_dtype).float()) @ vt
        m = m_new
    return o / l[..., None], (m + torch.log2(l)) * 0.6931471805599453


@pytest.mark.parametrize("n", [37, 64, 300])
@pytest.mark.parametrize("with_bias", [False, True])
def test_tile_walk_matches_jax_kernel_and_lse(n, with_bias):
    """The tile loop's arithmetic agrees with vtm's kernel (interpret
    mode), and its log2-domain statistics, converted once, are the
    natural-log log-sum-exp of the plain version. This holds the design's
    arithmetic, emulated here by ``_tile_walk``, not the CUDA kernel: a
    fault in ``wgmma_attention.cuh`` shows only on the card (chip_smoke's
    ``kernel`` phase, ``check_lse``, and K2 given K1's residuals)."""
    q, k, v, bias = _inputs(n, with_bias, seed=5)
    want = np.asarray(
        jax_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if bias is None else jnp.asarray(bias), 0.125,
        )
    )
    args = [torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            None if bias is None else torch.from_numpy(bias)]
    out, lse = _tile_walk(*args, 0.125)
    np.testing.assert_allclose(out.numpy(), want, rtol=2e-5, atol=2e-5)
    _, plain_lse = flash_attention._forward(*args, 0.125, want_lse=True)
    tol = 1e-5 * max(1.0, plain_lse.abs().max().item())
    np.testing.assert_allclose(lse.numpy(), plain_lse.numpy(), rtol=0, atol=tol)


def test_cpu_call_launches_no_kernel():
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(64, True))
    before = flash_attention.LAUNCHES
    tome_flash_attention(q, k, v, bias, 0.125)
    assert flash_attention.LAUNCHES == before == 0


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize(
    "q,k,bias,match",
    [
        (_meta((2, 3, 40, 64)), _meta((2, 3, 40, 64)), None, "CUDA device"),
        (_meta((2, 3, 40, 48)), _meta((2, 3, 40, 48)), None, "head dim"),
        (_meta((2, 3, 40, 64), torch.float16), _meta((2, 3, 40, 64), torch.float16), None, "bfloat16 or float32"),
        (_meta((2, 3, 40, 64)), _meta((2, 3, 41, 64)), None, "shapes differ"),
        (_meta((3, 40, 64)), _meta((3, 40, 64)), None, r"\[B, H, N, d\]"),
    ],
)
def test_kernel_args_rejected(q, k, bias, match):
    """The wrapper's checks raise on what the kernel does not take (run
    here on meta tensors; on the card they guard every launch)."""
    with pytest.raises(ValueError, match=match):
        check_kernel_args(q, k, k, bias)


def test_build_command_targets_hopper():
    srcs = build.sources()
    assert [s.name for s in srcs] == [
        "ab_chain.cu", "ab_dense_variants.cu", "ab_qk_probe.cu",
        "blockdiag_attention_bwd.cu", "blockdiag_attention_fwd.cu",
        "flash_attention_bwd.cu", "flash_attention_fwd.cu", "frame_attention_bwd.cu", "frame_attention_fwd.cu",
    ]
    assert {h.name for h in build.CSRC.glob("*.cuh")} == {
        "attention_tiles.cuh", "wgmma_attention.cuh", "wgmma_attention_bwd.cuh", "wgmma_tiles.cuh"}
    objs = [build.BUILD_DIR / f"{s.stem}.o" for s in srcs]
    for src, obj in zip(srcs, objs):
        cmd = build.compile_command(src, obj)
        assert "arch=compute_90a,code=sm_90a" in cmd and "-c" in cmd and cmd[-1] == str(src)
    link = build.link_command(objs, build.library_path())
    assert "arch=compute_90a,code=sm_90a" in link and "-shared" in link
    assert build.library_path().parent == build.BUILD_DIR


def test_library_name_follows_every_source(monkeypatch, tmp_path):
    """A changed kernel or shared header names a new library, so a stale
    build is never loaded."""
    for src in build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    names = {build.library_path().name}
    for changed in ("frame_attention_fwd.cu", "attention_tiles.cuh"):
        (tmp_path / changed).write_text((tmp_path / changed).read_text() + "\n")
        names.add(build.library_path().name)
    assert len(names) == 3


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc means no kernel: the build raises, nothing falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not list((tmp_path / "build").glob("*.so"))
