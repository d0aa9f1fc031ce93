"""A short first check of the block-diagonal attention kernels (K5a, K5b)
on the card, for use after a change to ``csrc/blockdiag_attention_fwd.cu``,
``csrc/blockdiag_attention_bwd.cu`` or the tile code they share
(``csrc/attention_tiles.cuh``).

    python -m vtm_torch.tools.check_blockdiag

  1. builds the library (every source through ``ptxas -v``) and prints, for
     the two sources, each kernel's registers and spill bytes (one line per
     template instance);
  2. holds K5a and K5b against their plain versions at TimeSformer's frame
     lengths, a long frame, odd ones and every head dim: fp32 and bf16,
     unbiased, biased, and biased with the row mask, strided q/k/v, a
     strided cotangent, and two runs bit for bit;
  3. times both beside their plain versions at B8 H12 d64 F8 bf16, s = 197,
     35 and 10 (10 calls each), K5b given K5a's residuals.
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
from vtm_torch.ops.build import kernel_resources
from vtm_torch.ops.flash_attention import (
    _blockdiag_backward_reference,
    _blockdiag_reference,
    tome_blockdiag_attention,
    tome_blockdiag_attention_backward,
)
from vtm_torch.tools.check_frame_bwd import _ms, _rel_errors

# (B, H, frames, s, d); at d = 64 frames of at most 32 tokens are packed
# (s = 10 and 18 at F = 7: a clip's last block holds fewer), s = 32 and 33
# are the packing's edges
SHAPES = [(8, 12, 8, 197, 64), (8, 12, 8, 179, 64), (8, 12, 8, 35, 64), (8, 12, 8, 10, 64),
          (8, 12, 7, 10, 64), (2, 3, 7, 18, 64), (2, 3, 5, 32, 64), (2, 3, 3, 33, 64), (1, 2, 3, 1, 64),
          (1, 12, 2, 785, 64), (2, 3, 4, 37, 16), (1, 2, 3, 65, 128), (1, 2, 3, 64, 32), (1, 2, 2, 2, 16), (1, 2, 3, 1, 16)]
FP32_TOL = 1e-5  # of the output's, or each gradient's, largest entry
MODES = ((False, False), (True, False), (True, True))  # (biased, exclude_first_row)


def frame_views(fused: torch.Tensor, b: int, h: int, f: int, s: int):
    """q, k, v [B, H, F*s, d] as views of a fused qkv projection of the
    (b t) batch [(B*F), s, 3*H*d]: frames are contiguous per clip."""
    d = fused.shape[-1] // (3 * h)
    qkv = fused.view(b, f * s, 3, h, d)
    return [qkv[:, :, i].transpose(1, 2) for i in range(3)]


def check_against_plain() -> list:
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, h, f, s, d in SHAPES:
        n, scale = f * s, d ** -0.5
        for biased, masked in MODES:
            bias = None
            if biased:
                bias = torch.log(torch.rand((b, n), generator=gen, device="cuda") * 4 + 1)
                bias.view(b, f, s)[:, :, 0] = 0.0
            fused = torch.randn((b * f, s, 3 * h * d), generator=gen, device="cuda")
            do = torch.randn((n, b, h * d), generator=gen, device="cuda").transpose(0, 1)
            q, k, v = frame_views(fused, b, h, f, s)
            out = tome_blockdiag_attention(q, k, v, bias, scale, f, masked)
            got = tome_blockdiag_attention_backward(q, k, v, bias, do, scale, f, masked)
            torch.cuda.synchronize()
            fwd32 = _rel_errors([out], [_blockdiag_reference(q, k, v, bias, scale, f, masked)])
            bwd32 = _rel_errors(got, _blockdiag_backward_reference(q, k, v, bias, do, scale, f, masked))
            if not all(e <= FP32_TOL for e in fwd32 + bwd32):  # a NaN fails too
                raise AssertionError(f"fp32 off by {fwd32} {bwd32} at {(b, h, f, s, d)} {biased} {masked}")
            qb, kb, vb = frame_views(fused.to(torch.bfloat16), b, h, f, s)
            dob = do.to(torch.bfloat16)
            outb = tome_blockdiag_attention(qb, kb, vb, bias, scale, f, masked)
            one = tome_blockdiag_attention_backward(qb, kb, vb, bias, dob, scale, f, masked)
            two = tome_blockdiag_attention_backward(qb, kb, vb, bias, dob, scale, f, masked)
            if not all(torch.equal(x, y) for x, y in zip(one[:3], two[:3])):
                raise AssertionError(f"K5b differs from run to run at {(b, h, f, s, d)}")
            args32 = (qb.float(), kb.float(), vb.float(), bias)
            ref_out = _blockdiag_reference(*args32, scale, f, masked)
            ref = _blockdiag_backward_reference(*args32, dob.float(), scale, f, masked)
            fwd16 = _rel_errors([outb], [ref_out])
            fwd_plain = _rel_errors([_blockdiag_reference(qb, kb, vb, bias, scale, f, masked)], [ref_out])
            bwd16 = _rel_errors(one, ref)
            bwd_plain = _rel_errors(_blockdiag_backward_reference(qb, kb, vb, bias, dob, scale, f, masked), ref)
            for name, err, plain in (("K5a", fwd16, fwd_plain), ("K5b", bwd16, bwd_plain)):
                if not all(e <= max(1e-2, 2 * max(plain)) for e in err):
                    raise AssertionError(f"{name} bf16 off by {max(err)} at {(b, h, f, s, d)} {biased} {masked}")
            rows.append(dict(shape=[b, h, f, s, d], biased=biased, exclude_first_row=masked,
                             fwd_fp32=max(fwd32), bwd_fp32=max(bwd32), fwd_bf16=max(fwd16),
                             fwd_bf16_plain=max(fwd_plain), bwd_bf16=max(bwd16), bwd_bf16_plain=max(bwd_plain)))
    return rows


def quick_times() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for s in (197, 35, 10):
        fused = torch.randn((64, s, 3 * 768), generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = frame_views(fused, 8, 12, 8, s)
        do = torch.randn((8, 8 * s, 768), generator=gen, device="cuda").to(torch.bfloat16)
        with torch.inference_mode():
            res = fa._blockdiag_forward(q, k, v, None, 0.125, 8, False, want_lse=True)
            out[str(s)] = dict(
                k5a_ms=_ms(lambda: tome_blockdiag_attention(q, k, v, None, 0.125, 8)),
                k5a_plain_ms=_ms(lambda: _blockdiag_reference(q, k, v, None, 0.125, 8)),
                k5b_ms=_ms(lambda: tome_blockdiag_attention_backward(q, k, v, None, do, 0.125, 8, out=res[0],
                                                                     lse=res[1])),
                k5b_plain_ms=_ms(lambda: _blockdiag_backward_reference(q, k, v, None, do, 0.125, 8)),
            )
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("check_blockdiag needs a CUDA device and found none")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    kernel_build.load_library()
    print(json.dumps(dict(step="build", seconds=time.perf_counter() - t0)), flush=True)
    for source in ("blockdiag_attention_fwd.cu", "blockdiag_attention_bwd.cu"):
        print(json.dumps(dict(step="resources", source=source, kernels=kernel_resources(source))), flush=True)
    print(json.dumps(dict(step="k5_against_plain", checks=check_against_plain())), flush=True)
    print(json.dumps(dict(step="times_bf16_B8_H12_d64_F8", nvidia_smi=smi, **quick_times())), flush=True)


if __name__ == "__main__":
    main()
