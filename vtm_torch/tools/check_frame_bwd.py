"""A short first check of the per-frame attention backward kernel (K4) on
the card, for use after a change to ``csrc/frame_attention_bwd.cu`` or to
the tile code it shares with K2 (``csrc/attention_tiles.cuh``).

    python -m vtm_torch.tools.check_frame_bwd

  1. builds the library (every source through ``ptxas -v``) and prints, for
     the two backward sources, each kernel's registers and spill bytes (one
     line per template instance);
  2. holds K4 against its plain version at the training path's shapes, some
     odd ones and every head dim: fp32 and bf16, biased and unbiased,
     strided q/k/v, and two runs bit for bit (the wrapper makes the
     residuals, out and lse, with K3);
  3. times K4 and K2 given their forwards' residuals, beside K4's plain
     version, at B8 H12 d64 bf16, N' 1568 and 848 (10 calls each), and
     holds K2 against its plain version once.
Prints one JSON line per step. Needs a CUDA device and nvcc; it is much
shorter than ``chip_smoke.py``, which makes the same checks in full.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from vtm_torch.models.common import split_heads
from vtm_torch.ops import build as kernel_build
from vtm_torch.ops import flash_attention as fa
from vtm_torch.ops.build import kernel_resources
from vtm_torch.ops.flash_attention import (
    _backward_reference,
    _frame_backward_reference,
    tome_flash_attention_backward,
    tome_frame_attention_backward,
)

FRAMES = 8
SHAPES = [(2, 3, 296, 16), (8, 12, 272, 64), (8, 12, 848, 64), (8, 12, 1568, 64), (1, 12, 3528, 64),
          (1, 2, 512, 128), (1, 2, 320, 32)]
FP32_TOL = 1e-4  # of each gradient's largest entry


def _heads(fused: torch.Tensor, h: int):
    return [split_heads(t, h) for t in fused.chunk(3, dim=-1)]


def _rel_errors(got, want) -> list:
    """Largest difference over the largest entry of ``want``, per tensor. A
    ``want`` of zeros (a one-token frame's dq and dk, zero analytically) is
    held to the largest entry of all of ``want``: the kernels' residual
    form takes ds = p (dp - delta) with dp = do v^T and delta = rowsum(do *
    out) the same sum in two orders, so there ds is their rounding, not 0.
    A NaN fails either way."""
    scale = max(w.float().abs().max().item() for w in want if w is not None)
    out = []
    for a, w in zip(got, want):
        if w is not None:
            largest = w.float().abs().max().item()
            out.append(((a.float() - w.float()).abs().max() / (largest if largest > 0 else scale)).item())
    return out


def check_against_plain() -> list:
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, h, n, d in SHAPES:
        scale = d ** -0.5
        for biased in (False, True):
            bias = torch.log(torch.rand((b, n), generator=gen, device="cuda") * 4 + 1) if biased else None
            fused = torch.randn((b, n + 1, 3 * h * d), generator=gen, device="cuda")
            do = torch.randn((b, n, FRAMES, h, d), generator=gen, device="cuda")
            q, k, v = _heads(fused[:, 1:], h)
            got = tome_frame_attention_backward(q, k, v, bias, do, scale, FRAMES)
            torch.cuda.synchronize()
            fp32 = _rel_errors(got, _frame_backward_reference(q, k, v, bias, do, scale, FRAMES))
            if max(fp32) > FP32_TOL:
                raise AssertionError(f"K4 fp32 off by {max(fp32)} at {(b, h, n, d)} biased={biased}")
            qb, kb, vb = _heads(fused.to(torch.bfloat16)[:, 1:], h)
            dob = do.to(torch.bfloat16)
            one = tome_frame_attention_backward(qb, kb, vb, bias, dob, scale, FRAMES)
            two = tome_frame_attention_backward(qb, kb, vb, bias, dob, scale, FRAMES)
            if not all(torch.equal(x, y) for x, y in zip(one[:3], two[:3])):
                raise AssertionError(f"K4 differs from run to run at {(b, h, n, d)}")
            ref = _frame_backward_reference(qb.float(), kb.float(), vb.float(), bias, dob.float(), scale, FRAMES)
            base = _frame_backward_reference(qb, kb, vb, bias, dob, scale, FRAMES)
            bf16, plain = _rel_errors(one, ref), _rel_errors(base, ref)
            if max(bf16) > max(1e-2, 2 * max(plain)):
                raise AssertionError(f"K4 bf16 off by {max(bf16)} at {(b, h, n, d)} biased={biased}")
            rows.append(dict(shape=[b, h, n, d], biased=biased, fp32_rel_err=max(fp32),
                             bf16_rel_err=max(bf16), bf16_plain_rel_err=max(plain)))
    return rows


def _ms(fn, iters: int = 10) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def quick_times() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for n in (1568, 848):
        q, k, v = _heads(torch.randn((8, n, 3 * 768), generator=gen, device="cuda").to(torch.bfloat16), 12)
        do = torch.randn((8, n, FRAMES, 12, 64), generator=gen, device="cuda").to(torch.bfloat16)
        dense_do = do[:, :, 0].transpose(1, 2)
        res4 = fa._frame_forward(q, k, v, None, 0.125, FRAMES, want_lse=True)
        res2 = fa._forward(q, k, v, None, 0.125, want_lse=True)
        out[str(n)] = dict(
            k4_ms=_ms(lambda: tome_frame_attention_backward(q, k, v, None, do, 0.125, FRAMES, out=res4[0],
                                                            lse=res4[1])),
            k4_plain_ms=_ms(lambda: _frame_backward_reference(q, k, v, None, do, 0.125, FRAMES)),
            k2_ms=_ms(lambda: tome_flash_attention_backward(q, k, v, None, dense_do, 0.125, out=res2[0],
                                                            lse=res2[1])),
        )
    return out


def check_dense_backward() -> float:
    """K2 shares the tile code: one fp32 case against its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = _heads(torch.randn((2, 300, 3 * 3 * 64), generator=gen, device="cuda"), 3)
    do = torch.randn((2, 300, 3, 64), generator=gen, device="cuda").transpose(1, 2)
    bias = torch.log(torch.rand((2, 300), generator=gen, device="cuda") * 4 + 1)
    err = max(_rel_errors(tome_flash_attention_backward(q, k, v, bias, do, 0.125),
                          _backward_reference(q, k, v, bias, do, 0.125)))
    if err > FP32_TOL:
        raise AssertionError(f"K2 fp32 off by {err}")
    return err


def main():
    if not torch.cuda.is_available():
        raise SystemExit("check_frame_bwd needs a CUDA device and found none")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    kernel_build.load_library()
    print(json.dumps(dict(step="build", seconds=time.perf_counter() - t0)), flush=True)
    for source in ("frame_attention_bwd.cu", "flash_attention_bwd.cu"):
        print(json.dumps(dict(step="resources", source=source, kernels=kernel_resources(source))), flush=True)
    print(json.dumps(dict(step="k4_against_plain", checks=check_against_plain())), flush=True)
    print(json.dumps(dict(step="k2_against_plain", fp32_rel_err=check_dense_backward())), flush=True)
    print(json.dumps(dict(step="times_bf16_B8_H12_d64", nvidia_smi=smi, **quick_times())), flush=True)


if __name__ == "__main__":
    main()
