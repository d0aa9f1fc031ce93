"""The port's per-frame attention (K3) wrapper against the JAX package's.

On the CPU the port's ``tome_frame_attention`` runs its plain version;
the JAX side runs the Pallas kernel in interpret mode, as
tests/test_flash_attention.py does. The CUDA kernel itself is checked
against the plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vtm.ops.flash_attention import tome_frame_attention as jax_frame_attention
from vtm_torch.ops import flash_attention
from vtm_torch.ops.flash_attention import check_frame_kernel_args, tome_frame_attention

torch.set_num_threads(2)

B, D, SCALE = 2, 16, 0.25


def _inputs(f, s, h, with_bias, seed=0):
    n = f * s
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, h, n, D)).astype(np.float32) for _ in range(3))
    bias = np.log(rng.uniform(1, 4, (B, n))).astype(np.float32) if with_bias else None
    return q, k, v, bias


# the (f, s, h) cases of tests/test_flash_attention.py's frame-kernel test:
# odd and even head counts, ragged frame lengths, an odd frame count
@pytest.mark.parametrize(
    "f,s,h",
    [(8, 5, 3), (4, 50, 3), (8, 193, 3), (8, 5, 4), (4, 50, 2), (8, 193, 4), (5, 8, 4)],
)
@pytest.mark.parametrize("with_bias", [False, True])
def test_matches_jax_kernel(f, s, h, with_bias):
    """fp32, rtol/atol 2e-5: the JAX test's own bound between its kernel
    and its reference (fp32 sums in another order)."""
    q, k, v, bias = _inputs(f, s, h, with_bias)
    want = np.asarray(
        jax_frame_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if bias is None else jnp.asarray(bias), SCALE, f,
        )
    )
    got = tome_frame_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias), SCALE, f,
    )
    assert tuple(got.shape) == (B, f * s, f, h, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_cpu_call_launches_no_kernel():
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(4, 50, 2, True))
    before = flash_attention.FRAME_LAUNCHES
    out = tome_frame_attention(q, k, v, bias, SCALE, 4)
    assert tuple(out.shape) == (B, 200, 4, 2, D)
    assert flash_attention.FRAME_LAUNCHES == before == 0


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize(
    "q,bias,frames,match",
    [
        (_meta((2, 12, 1568, 64)), None, 5, "does not divide"),
        (_meta((1, 12, 4104, 64)), None, 8, "exceed"),  # s = 513
        (_meta((2, 12, 1568, 48)), None, 8, "head dim"),
        (_meta((2, 12, 1568, 64), torch.float16), None, 8, "bfloat16 or float32"),
        (_meta((2, 12, 1568, 64)), None, 8, "CUDA device"),
        (torch.empty((2, 3, 40, 64)), None, 8, "CUDA device"),
        (_meta((2, 12, 1568, 64)), _meta((2, 1567), torch.float32), 8, "key_bias"),
        (_meta((2, 12, 1568, 64)), _meta((2, 1568), torch.bfloat16), 8, "key_bias"),
    ],
)
def test_kernel_args_rejected(q, bias, frames, match):
    """The wrapper's checks raise on what the kernel does not take (run
    here on meta and CPU tensors; on the card they guard every launch)."""
    with pytest.raises(ValueError, match=match):
        check_frame_kernel_args(q, q, q, bias, frames)
