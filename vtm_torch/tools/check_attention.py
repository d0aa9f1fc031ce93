"""A short first check of the dense attention kernels (K1's lse residual,
K2) and the per-frame forward (K3) on the card, for use after a change to
``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``,
``csrc/frame_attention_fwd.cu`` or the tile code they share
(``csrc/attention_tiles.cuh``, ``csrc/wgmma_tiles.cuh``).

    python -m vtm_torch.tools.check_attention

  1. compiles the three sources with ``-Xptxas -v`` and prints each
     kernel's registers and spill bytes (the wgmma bodies included);
  2. builds the library and holds K2, given K1's residuals (out, lse) as a
     train step passes them, against its plain version with the same
     residuals and against an fp32 computation: fp32 and bf16, biased and
     unbiased, every head dim, strided q/k/v and do, two runs bit for bit;
     K1's lse against its plain version's; K3 against its plain version at
     Motionformer's frame lengths and every head dim;
  3. times K2 given the residuals, K3, and K1 with and without the lse
     write at B8 H12 d64 bf16 (10 calls each).
Prints one JSON line per step. Needs a CUDA device and nvcc; it is much
shorter than ``chip_smoke.py``, which makes the same checks in full.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from vtm_torch.ops import build as kernel_build
from vtm_torch.ops import flash_attention as fa
from vtm_torch.tools.check_frame_bwd import _heads, _ms, _rel_errors, kernel_resources

FRAMES = 8
# the training paths' widest row, ragged and shorter than one tile at
# d = 64 (the wgmma body), and every other head dim (the first body)
K2_SHAPES = [(1, 2, 64, 64), (2, 3, 37, 64), (2, 3, 257, 64), (8, 12, 1568, 64), (2, 3, 296, 16),
             (1, 2, 320, 32), (1, 2, 130, 128)]
# frames of 37 and 5 keys, Motionformer's 196 and the 336 crop's 441 at
# d = 64; every other head dim
K3_SHAPES = [(1, 2, FRAMES * 37, 64), (2, 3, FRAMES * 5, 64), (8, 12, 1568, 64), (1, 12, 3528, 64),
             (2, 3, 296, 16), (1, 2, FRAMES * 40, 32), (1, 2, FRAMES * 65, 128)]
FP32_TOL = 1e-4  # of each gradient's largest entry; of K3's largest output
LSE_TOL = 1e-4   # of max(1, the largest |lse|)


def _bf16_tol(plain_err: float) -> float:
    """chip_smoke's rule: within max(1e-2, twice the bf16 plain version's
    error) of an fp32 computation."""
    return max(1e-2, 2 * plain_err)


def check_k2() -> list:
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, h, n, d in K2_SHAPES:
        scale = d ** -0.5
        for biased in (False, True):
            bias = torch.log(torch.rand((b, n), generator=gen, device="cuda") * 4 + 1) if biased else None
            fused = torch.randn((b, n + 1, 3 * h * d), generator=gen, device="cuda")
            do32 = torch.randn((b, n, h, d), generator=gen, device="cuda").transpose(1, 2)
            row = dict(shape=[b, h, n, d], biased=biased)
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = _heads(fused.to(dtype)[:, 1:], h)
                do = do32.to(dtype)
                out, lse = fa._forward(q, k, v, bias, scale, want_lse=True)
                _, lse_plain = fa._reference(q, k, v, bias, scale, want_lse=True)
                lse_err = (lse - lse_plain).abs().max().item() / max(1.0, lse_plain.abs().max().item())
                if lse_err > LSE_TOL:
                    raise AssertionError(f"K1 lse off by {lse_err} at {(b, h, n, d)} {dtype}")
                one = fa.tome_flash_attention_backward(q, k, v, bias, do, scale, out=out, lse=lse)
                two = fa.tome_flash_attention_backward(q, k, v, bias, do, scale, out=out, lse=lse)
                if not all(torch.equal(x, y) for x, y in zip(one[:3], two[:3])):
                    raise AssertionError(f"K2 differs from run to run at {(b, h, n, d)} {dtype}")
                same = _rel_errors(one, fa._backward_reference(q, k, v, bias, do, scale, out, lse))
                ref = fa._backward_reference(q.float(), k.float(), v.float(), bias, do.float(), scale)
                err, plain = _rel_errors(one, ref), _rel_errors(fa._backward_reference(q, k, v, bias, do, scale), ref)
                tol = FP32_TOL if dtype == torch.float32 else _bf16_tol(max(plain))
                if max(err) > tol:
                    raise AssertionError(f"K2 {dtype} off by {max(err)} > {tol} at {(b, h, n, d)} biased={biased}")
                tag = "fp32" if dtype == torch.float32 else "bf16"
                row.update({f"{tag}_rel_err": max(err), f"{tag}_vs_same_residuals": max(same),
                            f"{tag}_plain_rel_err": max(plain), f"{tag}_lse_err": lse_err})
            rows.append(row)
    torch.cuda.synchronize()
    return rows


def check_k3() -> list:
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for b, h, n, d in K3_SHAPES:
        scale = d ** -0.5
        for biased in (False, True):
            bias = torch.log(torch.rand((b, n), generator=gen, device="cuda") * 4 + 1) if biased else None
            fused = torch.randn((b, n + 1, 3 * h * d), generator=gen, device="cuda")
            q, k, v = _heads(fused[:, 1:], h)
            got = fa._frame_forward(q, k, v, bias, scale, FRAMES)
            ref = fa._frame_reference(q, k, v, bias, scale, FRAMES)
            err32 = ((got - ref).abs().max() / ref.abs().max()).item()
            if err32 > FP32_TOL:
                raise AssertionError(f"K3 fp32 off by {err32} at {(b, h, n, d)} biased={biased}")
            qb, kb, vb = _heads(fused.to(torch.bfloat16)[:, 1:], h)
            got = fa._frame_forward(qb, kb, vb, bias, scale, FRAMES).float()
            plain = fa._frame_reference(qb, kb, vb, bias, scale, FRAMES).float()
            ref = fa._frame_reference(qb.float(), kb.float(), vb.float(), bias, scale, FRAMES)
            err, err_plain = (got - ref).abs().max().item(), (plain - ref).abs().max().item()
            if err > _bf16_tol(err_plain):
                raise AssertionError(f"K3 bf16 off by {err} at {(b, h, n, d)} biased={biased}")
            rows.append(dict(shape=[b, h, n, d], biased=biased, fp32_rel_err=err32, bf16_err=err,
                             bf16_plain_err=err_plain))
    torch.cuda.synchronize()
    return rows


def quick_times() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for n, biased in ((1568, False), (3137, True), (848, True)):
        q, k, v = _heads(torch.randn((8, n, 3 * 768), generator=gen, device="cuda").to(torch.bfloat16), 12)
        bias = torch.log(torch.rand((8, n), generator=gen, device="cuda") * 4 + 1) if biased else None
        do = torch.randn((8, n, 12, 64), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
        res, lse = fa._forward(q, k, v, bias, 0.125, want_lse=True)
        out[str(n)] = dict(
            biased=biased,
            k1_ms=_ms(lambda: fa._forward(q, k, v, bias, 0.125)),
            k1_lse_ms=_ms(lambda: fa._forward(q, k, v, bias, 0.125, want_lse=True)),
            k2_ms=_ms(lambda: fa.tome_flash_attention_backward(q, k, v, bias, do, 0.125, need_dbias=False,
                                                                out=res, lse=lse)),
            # ViViT's 3137 tokens make no frames
            k3_ms=_ms(lambda: fa._frame_forward(q, k, v, bias, 0.125, FRAMES)) if n % FRAMES == 0 else None,
        )
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("check_attention needs a CUDA device and found none")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    for source in ("flash_attention_fwd.cu", "flash_attention_bwd.cu", "frame_attention_fwd.cu"):
        print(json.dumps(dict(step="resources", source=source, kernels=kernel_resources(source))), flush=True)
    t0 = time.perf_counter()
    kernel_build.load_library()
    print(json.dumps(dict(step="build", seconds=time.perf_counter() - t0)), flush=True)
    print(json.dumps(dict(step="k2_against_plain", checks=check_k2())), flush=True)
    print(json.dumps(dict(step="k3_against_plain", checks=check_k3())), flush=True)
    print(json.dumps(dict(step="times_bf16_B8_H12_d64", nvidia_smi=smi, **quick_times())), flush=True)


if __name__ == "__main__":
    main()
