"""A short first check of the A/B attention kernels (T1-T12,
``vtm_torch/ops/ab_attention.py``), for use after a change to
``csrc/ab_qk_probe.cu``, ``csrc/ab_chain.cu`` or
``csrc/ab_dense_variants.cu``.

    python -m vtm_torch.tools.check_ab

  1. builds the library (every source through ``ptxas -v``) and prints, for
     the three sources, each kernel's registers and spill bytes (one line
     per template instance);
  2. runs ``ab_dense.exp_kernels``: every function and mode against its
     plain version, by ``ab_dense``'s rule, in fp32 at a small ragged
     shape, then in bf16 at B8 H12 d64 and the tools' token counts (the
     probes T2, T3, T6 and T7 run the Hopper body of ``ab_qk_probe.cu``
     there, at depth 64 and 128; their row counts leave the last row
     block partly filled, and T6 and T7 also run at
     ``Sizes.ragged_probes``, keys that end inside a tile), there timed
     beside the
     plain version and the library call (2 x 10 calls in turns), and by
     device time (``kernel_times.device_ms``);
  3. runs ``ab_dense.k1_bits``: T5, T12, T8 ``full``, T1, T9 and T10 in
     bf16 (K1's instances of the Hopper tile loop, T9 ``2d`` with its bias
     staged) against K1 on the same views, bit for bit: T5 and T12 at N
     1568 and T5 at B32, T8 ``full``, T1 (both bias kinds, the five
     bisect variants), T9 (both modes) and T10 at n 1600, all at ragged N;
  4. prints, for every variant code of ``csrc/ab_chain.cu`` in bf16 and
     for each bf16 kernel of ``csrc/ab_qk_probe.cu`` (depth 64 and 128,
     columns and row sums), the blocks an SM of the kernel it launches
     (the runtime's occupancy calculator) and its dynamic shared bytes;
     a probe kernel's must be ``ab_attention.PROBE_TILING``'s.
Prints one JSON line per step and per row. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import json
import time

import torch

from vtm_torch.ops import ab_attention
from vtm_torch.ops import build as kernel_build
from vtm_torch.ops.build import kernel_resources
from vtm_torch.tools import ab_dense

SOURCES = ("ab_qk_probe.cu", "ab_chain.cu", "ab_dense_variants.cu")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("check_ab needs a CUDA device and found none")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    kernel_build.load_library()
    print(json.dumps(dict(step="build", seconds=time.perf_counter() - t0)), flush=True)
    for source in SOURCES:
        print(json.dumps(dict(step="resources", source=source, kernels=kernel_resources(source))), flush=True)
    device = torch.device("cuda")
    ab_dense.exp_kernels(ab_dense.Bench(device, ab_dense.SMALL_SIZES, 0, 1, 1, dtype=torch.float32))
    bench = ab_dense.Bench(device, ab_dense.Sizes(), 0, 2, 10)
    ab_dense.exp_kernels(bench)
    for row in ab_dense.k1_bits(bench):
        print(json.dumps(dict(step="k1_bits", **row)), flush=True)
    for code in ab_attention.CHAIN_CODES:
        blocks, smem = ab_attention.chain_occupancy(torch.bfloat16, code)
        print(json.dumps(dict(step="occupancy", source="ab_chain.cu", variant=code, blocks_per_sm=blocks,
                              smem_bytes=smem)), flush=True)
    for depth, tiling in ab_attention.PROBE_TILING.items():
        for rowsum in (False, True):
            blocks, smem = ab_attention.probe_occupancy(depth, rowsum)
            print(json.dumps(dict(step="occupancy", source="ab_qk_probe.cu", depth=depth, rowsum=rowsum,
                                  blocks_per_sm=blocks, smem_bytes=smem, want=tiling)), flush=True)
            if (blocks, smem) != (tiling["blocks_per_sm"], tiling["smem_bytes"]):
                raise RuntimeError(f"ab_qk_probe.cu at depth {depth}: {blocks} blocks an SM of {smem} B, "
                                   f"not {tiling['blocks_per_sm']} of {tiling['smem_bytes']} B")


if __name__ == "__main__":
    main()
