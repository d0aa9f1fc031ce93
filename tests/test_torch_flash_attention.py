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
