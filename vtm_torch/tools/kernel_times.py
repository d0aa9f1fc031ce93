"""The attention kernels' times on the card, two ways.

    python -m vtm_torch.tools.kernel_times [--exp times|packing|backward|ab|digests|all] [--iters 50]

``--exp`` takes one experiment, ``all``, or a comma-separated list
(``--exp ab,digests``), run in the order of ``EXPERIMENTS``.

``--exp times`` times K1 (``tome_flash_attention``, no gradient wanted),
K3 (``tome_frame_attention``, F 8) and K5a (``tome_blockdiag_attention``,
F 8) at B8 H12 d64 bf16 on the paths' shapes (and K5a at s = 192 and 193,
the padding of s = 197's last tile), q, k and v as views of one fused
projection, and for each case prints one JSON line with
  * ``event_ms``: CUDA events around ``--iters`` back-to-back calls of the
    wrapper, per call: what a caller sees, the host's cost of a call
    included, so at short rows the host's launch rate bounds it;
  * ``device_ms``: the kernels' device time per call, ``--iters`` further
    calls queued behind a kernel that holds the stream until the host has
    issued them all (``device_ms``), so the host's cost is hidden.
Each is taken twice and the mean printed with both readings. These calls
go through the public wrappers only, so ``PYTHONPATH=<another checkout>
python3 vtm_torch/tools/kernel_times.py --exp times`` times that tree.
``--exp packing`` gives K5a's device time at s = 10 and 18, biased and
masked, with g = 1 ... 64 // s frames packed into a block (g = 1: one
frame a block), in turns, at batch 8 and 32. ``--exp backward`` times the
backwards as a train step calls them, given their forwards' residuals (out
and lse): K2 (``tome_flash_attention_backward``), K4
(``tome_frame_attention_backward``) and K5b
(``tome_blockdiag_attention_backward``) at the same shapes as their
forwards, no dbias, a token-major do. ``--exp ab`` times the A/B kernels
T4 (``ab_attention.packed_attention``) and T11 (``v2_attention``, all three
variants), unbiased and biased, and T5 (``grid_swapped``) and T12
(``n8_attention``), unbiased, beside K1, at B8 H12 N 1568 d64 bf16 on the
same fused views; K1, T5 and T12 again at ``AB_BATCHES`` (B12 to B32,
where the heads' k and v outgrow L2); then the chains, beside K1 at
scale 1 (unbiased, with T1's per-batch bias, and with the shared row
expanded to every batch) on the same operands: T1 (per-batch and shared
bias), T8 (every mode), T9 (``1d``, ``2d``) and T10, all on the Hopper
body in bf16, and the four q k^T probes T2
(``qk64``), T3 (``qk_packed``), T6 (``qk_d64``) and T7
(``qk_packed_rowsum``), at the A/B tools' shape, [96, 1600, 64] bf16 (the
packed forms qp [48, 3200, 128], kc [48, 1600, 128]), both clocks.
``--exp digests`` prints the sha256 of the forwards' output bits
(``forward_digests``: K1, K3, K5a at ``FWD_DIGEST_CASES``, B2 H12 d64 bf16,
inputs from numpy's generator), of the probes' (``probe_digests``: T2, T3,
T6, T7 in bf16 at ``PROBE_DIGEST_N``), of ``ab_chain.cu``'s
(``chain_digests``: T1, T5, T8, T9, T10, T12, every mode, bf16 and fp32,
at ``CHAIN_DIGEST_N``) and of ``ab_dense_variants.cu``'s (``dense_digests``:
T4 and T11, every variant, unbiased and biased, bf16 and fp32, at
``CHAIN_DIGEST_N``), which two trees on one card must share when their
arithmetic is the same.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import subprocess

import numpy as np
import torch

from vtm_torch.models.common import split_heads
from vtm_torch.ops import ab_attention, flash_attention
from vtm_torch.ops.flash_attention import (
    tome_blockdiag_attention,
    tome_blockdiag_attention_backward,
    tome_flash_attention,
    tome_flash_attention_backward,
    tome_frame_attention,
    tome_frame_attention_backward,
)
from vtm_torch.utils.benchmark import device_seconds

B, H, D = 8, 12, 64
FRAMES = 8
# (N, biased): VideoMAE's layers 0 and 8, ViViT's layers 9 and 0
K1_CASES = ((1568, False), (368, False), (437, True), (3137, True))
# (N', biased): Motionformer's layer 0 and a merged layer
K3_CASES = ((1568, False), (848, True))
# (s, biased, exclude_first_row): TimeSformer's layers 0, 1, 5, 9, 10, 11,
# then the padding of s = 197 (four 64-row tiles, the last holding 5 rows
# and 5 keys): three full tiles (192), and one row and key past them (193)
K5A_CASES = ((197, False, False), (179, True, True), (107, True, True), (35, True, True),
             (18, True, True), (10, True, True), (192, False, False), (193, False, False))
# K5a's packing: frame length, the frames a block may pack, the batches
PACKING = ((10, (1, 2, 3, 6)), (18, (1, 2, 3)))
PACKING_BATCHES = (8, 32)
# the backwards at their forwards' shapes: (N, biased), (N', biased), and
# TimeSformer's frame lengths with s = 18 packed as s = 10 is
K2_CASES = K1_CASES
K4_CASES = K3_CASES
K5B_CASES = ((197, False, False), (179, True, True), (107, True, True), (35, True, True),
             (18, True, True), (10, True, True))
# the A/B kernels' token count (ab_dense's first of packed_ns and v2_ns)
AB_N = 1568
# K1, T5 and T12 also at these batches: every head's k and v is 4.8 MB a
# clip at N 1568, so the 50 MB L2 holds them up to B10 (ab_b32.py: B32)
AB_BATCHES = (12, 16, 24, 32)
# (kernel, N or s, biased, exclude_first_row): K1 VideoMAE's layer 0 and a
# biased ragged N; K3 Motionformer's layer 0 and a merged layer; K5a
# TimeSformer's s 197, 107 and 10 (packed frames)
FWD_DIGEST_CASES = (("K1", 1568, False, False), ("K1", 437, True, False), ("K3", 1568, False, False),
                    ("K3", 848, True, False), ("K5a", 197, False, False), ("K5a", 107, True, True),
                    ("K5a", 10, True, True))
# the probes' shape: [bh, n, 64] as the A/B tools give them (ab_dense.Sizes().n_pad)
PROBE_BH, PROBE_N = B * H, 1600
# the probes' digests: token counts of a [24, n, 64] q and k, one a
# multiple of 64 (T2, T3 need one), one not (T6, T7 take it); kept as
# they are, so that two trees' digests of one kernel compare
PROBE_DIGEST_N = {"T2": 320, "T3": 320, "T6": 200, "T7": 200}
# ab_chain.cu's digests: B2 H12 and a token count whose last key tile ends early
CHAIN_DIGEST_N = 200
EXPERIMENTS = ("times", "packing", "backward", "ab", "digests")


def device_ms(fn, iters: int) -> float:
    """ms per call of the kernels ``fn`` launches, on the device alone:
    ``iters`` calls queued behind a kernel that holds the stream
    (``torch.cuda._sleep``) until the host has issued them all, timed by
    CUDA events around the calls, so the host's cost of a call is hidden
    and the events read the kernels back to back. The hold is long enough
    when the start event is still pending once every call is issued; if
    not, it is taken again with a hold four times longer."""
    fn()
    torch.cuda.synchronize()
    cycles = 50_000_000  # about 25 ms at the H100's clock
    for _ in range(4):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise RuntimeError("the host issued the calls slower than the stream's hold")


def fused_views(gen, rows: int, batch: int = B):
    """q, k, v [batch, H, rows, d] as split_heads views of one fused bf16
    projection [batch, rows, 3*H*d]."""
    fused = torch.randn((batch, rows, 3 * H * D), generator=gen, device="cuda").to(torch.bfloat16)
    return [split_heads(t, H) for t in fused.chunk(3, dim=-1)]


def size_bias(gen, rows: int, frame_len: int = 0, batch: int = B):
    """log token sizes, fp32 [batch, rows]; with ``frame_len``, 0 on each
    frame's first (CLS) entry."""
    bias = torch.log(torch.rand((batch, rows), generator=gen, device="cuda") * 4 + 1)
    if frame_len:
        bias.view(batch, -1, frame_len)[:, :, 0] = 0.0
    return bias


def measure(fn, iters: int) -> dict:
    """Both clocks, each read twice."""
    ev = [device_seconds(fn, iters, 3, torch.device("cuda")) * 1e3 / iters for _ in range(2)]
    dev = [device_ms(fn, iters) for _ in range(2)]
    return dict(event_ms=sum(ev) / 2, event_ms_readings=ev, device_ms=sum(dev) / 2, device_ms_readings=dev)


def exp_times(gen, iters: int, smi: str) -> None:
    for n, biased in K1_CASES:
        q, k, v = fused_views(gen, n)
        bias = size_bias(gen, n) if biased else None
        row = measure(lambda: tome_flash_attention(q, k, v, bias, 0.125), iters)
        print(json.dumps(dict(kernel="K1", n=n, biased=biased, **row, nvidia_smi=smi)), flush=True)
    for n, biased in K3_CASES:
        q, k, v = fused_views(gen, n)
        bias = size_bias(gen, n) if biased else None
        row = measure(lambda: tome_frame_attention(q, k, v, bias, 0.125, FRAMES), iters)
        print(json.dumps(dict(kernel="K3", n=n, biased=biased, **row, nvidia_smi=smi)), flush=True)
    for s, biased, masked in K5A_CASES:
        q, k, v = fused_views(gen, FRAMES * s)
        bias = size_bias(gen, FRAMES * s, s) if biased else None
        row = measure(lambda: tome_blockdiag_attention(q, k, v, bias, 0.125, FRAMES, masked), iters)
        print(json.dumps(dict(kernel="K5a", s=s, biased=biased, exclude_first_row=masked, **row,
                              nvidia_smi=smi)), flush=True)


def exp_ab(gen, iters: int, smi: str) -> None:
    q, k, v = fused_views(gen, AB_N)
    for bias in (None, size_bias(gen, AB_N)):
        biased = bias is not None
        calls = [("K1", "", lambda: tome_flash_attention(q, k, v, bias, 0.125)),
                 ("T4", "packed", lambda: ab_attention.packed_attention(q, k, v, bias, 0.125))]
        calls += [("T11", variant, lambda variant=variant: ab_attention.v2_attention(q, k, v, bias, 0.125, variant))
                  for variant in ab_attention.V2_VARIANTS]
        if not biased:
            calls += [("T5", "", lambda: ab_attention.grid_swapped(q, k, v, 0.125)),
                      ("T12", "", lambda: ab_attention.n8_attention(q, k, v, 0.125))]
        for kernel, mode, call in calls:
            print(json.dumps(dict(kernel=kernel, mode=mode, n=AB_N, biased=biased, **measure(call, iters),
                                  nvidia_smi=smi)), flush=True)
    for batch in AB_BATCHES:
        q, k, v = fused_views(gen, AB_N, batch)
        for kernel, call in (("K1", lambda: tome_flash_attention(q, k, v, None, 0.125)),
                             ("T5", lambda: ab_attention.grid_swapped(q, k, v, 0.125)),
                             ("T12", lambda: ab_attention.n8_attention(q, k, v, 0.125))):
            print(json.dumps(dict(kernel=kernel, mode="", batch=batch, n=AB_N, biased=False, **measure(call, iters),
                                  nvidia_smi=smi)), flush=True)
    q3, k3, v3 = (torch.randn((PROBE_BH, PROBE_N, D), generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(3))
    bias = torch.log(torch.rand((B, 1, PROBE_N), generator=gen, device="cuda") * 11 + 1)
    q4, k4, v4 = (t.view(B, H, PROBE_N, D) for t in (q3, k3, v3))
    shared = bias[:1].view(1, PROBE_N).expand(B, PROBE_N).contiguous()
    chains = [("K1", "unbiased, scale 1", lambda: tome_flash_attention(q4, k4, v4, None, 1.0)),
              ("K1", "per-batch bias, scale 1", lambda: tome_flash_attention(q4, k4, v4, bias.view(B, PROBE_N), 1.0)),
              ("K1", "shared bias, scale 1", lambda: tome_flash_attention(q4, k4, v4, shared, 1.0)),
              ("T1", "per-batch bias", lambda: ab_attention.chunked_attention(q3, k3, v3, bias, False, H)),
              ("T1", "shared bias", lambda: ab_attention.chunked_attention(q3, k3, v3, bias[:1], True, H)),
              ("T9", "1d", lambda: ab_attention.chain_bias(q3, k3, v3, bias[:1], "1d")),
              ("T9", "2d", lambda: ab_attention.chain_bias(q3, k3, v3, bias[:1], "2d")),
              ("T10", "", lambda: ab_attention.chain_bias_cost(q3, k3, v3, bias[:1]))]
    chains += [("T8", mode, functools.partial(ab_attention.chain, q3, k3, v3, mode))
               for mode in ab_attention.CHAIN_MODES]
    for kernel, mode, call in chains:
        print(json.dumps(dict(kernel=kernel, mode=mode, shape=list(q3.shape), **measure(call, iters),
                              nvidia_smi=smi)), flush=True)
    qp, kc = ab_attention.pack_q(q3), ab_attention.pack_k(k3)
    probes = (("T2", "qk64", (q3, k3)), ("T3", "qk_packed", (qp, kc)), ("T6", "qk_d64", (q3, k3)),
              ("T7", "qk_packed_rowsum", (qp, kc)))
    for kernel, function, args in probes:
        call = functools.partial(getattr(ab_attention, function), *args)
        print(json.dumps(dict(kernel=kernel, function=function, shape=list(args[0].shape), **measure(call, iters),
                              nvidia_smi=smi)), flush=True)


def forward_digests() -> dict:
    """{kernel: sha256 of its outputs at FWD_DIGEST_CASES}, each output
    through the public wrapper on bf16 split-heads views of a fused [2, N,
    3*768] projection, inputs from numpy's generator seeded by N."""
    digests = {}
    with torch.inference_mode():
        for kernel, n, biased, masked in FWD_DIGEST_CASES:
            rows = n * FRAMES if kernel == "K5a" else n
            rng = np.random.default_rng(n)
            fused = torch.from_numpy(rng.standard_normal((2, rows, 3 * H * D)).astype(np.float32)).cuda()
            q, k, v = (split_heads(t, H) for t in fused.to(torch.bfloat16).chunk(3, dim=-1))
            bias = torch.from_numpy(np.log(rng.uniform(1, 5, (2, rows))).astype(np.float32)).cuda() if biased else None
            if kernel == "K1":
                out = tome_flash_attention(q, k, v, bias, 0.125)
            elif kernel == "K3":
                out = tome_frame_attention(q, k, v, bias, 0.125, FRAMES)
            else:
                out = tome_blockdiag_attention(q, k, v, bias, 0.125, FRAMES, masked)
            digests.setdefault(kernel, hashlib.sha256()).update(
                out.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return {kernel: d.hexdigest() for kernel, d in digests.items()}


def probe_digests() -> dict:
    """{T id: sha256 of the probe's bf16 output} through the public
    wrappers, q and k [24, n, 64] from numpy's generator seeded by n (T3
    and T7 on their packed forms), n from PROBE_DIGEST_N."""
    digests = {}
    with torch.inference_mode():
        for kernel, n in PROBE_DIGEST_N.items():
            rng = np.random.default_rng(n)
            q, k = (torch.from_numpy(rng.standard_normal((2 * H, n, D)).astype(np.float32)).cuda().to(torch.bfloat16)
                    for _ in range(2))
            if kernel == "T2":
                out = ab_attention.qk64(q, k)
            elif kernel == "T3":
                out = ab_attention.qk_packed(ab_attention.pack_q(q), ab_attention.pack_k(k))
            elif kernel == "T6":
                out = ab_attention.qk_d64(q, k)
            else:
                out = ab_attention.qk_packed_rowsum(ab_attention.pack_q(q), ab_attention.pack_k(k))
            digests[kernel] = hashlib.sha256(out.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
    return digests


def chain_digests() -> dict:
    """{"T<i> <mode> <dtype>": sha256 of the output} of ab_chain.cu's six
    functions through the public wrappers, every mode, in bf16 and fp32:
    T1, T8, T9, T10 on [24, n, 64] q, k, v with the tools' fp32 key biases,
    T5 and T12 on split-heads views of a fused [2, n, 3*768] projection,
    inputs from numpy's generator seeded by n = CHAIN_DIGEST_N."""
    ab, n = ab_attention, CHAIN_DIGEST_N
    digests = {}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            rng = np.random.default_rng(n)

            def randn(*shape):
                return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda().to(dtype)

            def log_sizes(*shape):
                return torch.from_numpy(np.log(rng.uniform(1, 12, shape)).astype(np.float32)).cuda()

            q3, k3, v3 = (randn(2 * H, n, D) for _ in range(3))
            q, k, v = (split_heads(t, H) for t in randn(2, n, 3 * H * D).chunk(3, dim=-1))
            per_batch, shared = log_sizes(2, 1, n), log_sizes(1, 1, n)
            calls = {"T1 per-batch bias": lambda: ab.chunked_attention(q3, k3, v3, per_batch, False, H),
                     "T1 shared bias": lambda: ab.chunked_attention(q3, k3, v3, shared, True, H),
                     "T5": lambda: ab.grid_swapped(q, k, v, 0.125),
                     "T10": lambda: ab.chain_bias_cost(q3, k3, v3, shared),
                     "T12": lambda: ab.n8_attention(q, k, v, 0.125)}
            calls.update({f"T8 {mode}": functools.partial(ab.chain, q3, k3, v3, mode) for mode in ab.CHAIN_MODES})
            calls.update({f"T9 {mode}": functools.partial(ab.chain_bias, q3, k3, v3, shared, mode)
                          for mode in ab.BIAS_MODES})
            tag = str(dtype).split(".")[-1]
            for name, call in calls.items():
                out = call().contiguous()
                digests[f"{name} {tag}"] = hashlib.sha256(out.view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
    return digests


def dense_digests() -> dict:
    """{"T<i> <variant> <biased> <dtype>": sha256 of the output} of
    ``ab_dense_variants.cu``'s two functions through the public wrappers,
    T4 and T11 (every variant), unbiased and biased, bf16 and fp32, on
    split-heads views of a fused [2, n, 3*768] projection and an fp32 bias
    [2, n] from numpy's generator seeded by n = CHAIN_DIGEST_N."""
    ab, n = ab_attention, CHAIN_DIGEST_N
    digests = {}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            rng = np.random.default_rng(n)
            fused = torch.from_numpy(rng.standard_normal((2, n, 3 * H * D)).astype(np.float32)).cuda().to(dtype)
            q, k, v = (split_heads(t, H) for t in fused.chunk(3, dim=-1))
            bias = torch.from_numpy(np.log(rng.uniform(1, 12, (2, n))).astype(np.float32)).cuda()
            tag = str(dtype).split(".")[-1]
            for key_bias, biased in ((None, "unbiased"), (bias, "biased")):
                calls = {"T4 packed": lambda: ab.packed_attention(q, k, v, key_bias, 0.125)}
                calls.update({f"T11 {variant}": functools.partial(ab.v2_attention, q, k, v, key_bias, 0.125, variant)
                              for variant in ab.V2_VARIANTS})
                for name, call in calls.items():
                    out = call().contiguous()
                    digests[f"{name} {biased} {tag}"] = hashlib.sha256(
                        out.view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
    return digests


def exp_digests(gen, iters: int, smi: str) -> None:
    print(json.dumps(dict(forward_digests=forward_digests(), cases=FWD_DIGEST_CASES, probe_digests=probe_digests(),
                          probe_cases=PROBE_DIGEST_N, chain_digests=chain_digests(), dense_digests=dense_digests(),
                          chain_n=CHAIN_DIGEST_N, nvidia_smi=smi)), flush=True)


def exp_backward(gen, iters: int, smi: str) -> None:
    fa = flash_attention
    for n, biased in K2_CASES:
        q, k, v = fused_views(gen, n)
        bias = size_bias(gen, n) if biased else None
        do = torch.randn((B, n, H, D), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
        out, lse = fa._forward(q, k, v, bias, 0.125, want_lse=True)
        call = lambda: tome_flash_attention_backward(q, k, v, bias, do, 0.125, need_dbias=False, out=out, lse=lse)
        print(json.dumps(dict(kernel="K2", n=n, biased=biased, **measure(call, iters), nvidia_smi=smi)), flush=True)
    for n, biased in K4_CASES:
        q, k, v = fused_views(gen, n)
        bias = size_bias(gen, n) if biased else None
        do = torch.randn((B, n, FRAMES, H, D), generator=gen, device="cuda").to(torch.bfloat16)
        out, lse = fa._frame_forward(q, k, v, bias, 0.125, FRAMES, want_lse=True)
        call = lambda: tome_frame_attention_backward(q, k, v, bias, do, 0.125, FRAMES, need_dbias=False,
                                                     out=out, lse=lse)
        print(json.dumps(dict(kernel="K4", n=n, biased=biased, **measure(call, iters), nvidia_smi=smi)), flush=True)
    for s, biased, masked in K5B_CASES:
        q, k, v = fused_views(gen, FRAMES * s)
        bias = size_bias(gen, FRAMES * s, s) if biased else None
        do = torch.randn((B, FRAMES * s, H * D), generator=gen, device="cuda").to(torch.bfloat16)
        out, lse = fa._blockdiag_forward(q, k, v, bias, 0.125, FRAMES, masked, want_lse=True)
        call = lambda: tome_blockdiag_attention_backward(q, k, v, bias, do, 0.125, FRAMES, masked,
                                                         need_dbias=False, out=out, lse=lse)
        print(json.dumps(dict(kernel="K5b", s=s, biased=biased, exclude_first_row=masked, **measure(call, iters),
                              nvidia_smi=smi)), flush=True)


def exp_packing(gen, iters: int, smi: str) -> None:
    for s, packings in PACKING:
        for batch in PACKING_BATCHES:
            q, k, v = fused_views(gen, FRAMES * s, batch)
            bias = size_bias(gen, FRAMES * s, s, batch)
            ms = {g: [] for g in packings}
            for g in list(packings) + list(reversed(packings)):  # in turns
                plan = (g, 1, -(-FRAMES // g))
                call = lambda: flash_attention._blockdiag_forward(q, k, v, bias, 0.125, FRAMES, True, plan)
                ms[g].append(device_ms(call, iters))
            print(json.dumps(dict(kernel="K5a_packing", s=s, batch=batch, frames=FRAMES,
                                  device_ms={g: sum(r) / 2 for g, r in ms.items()},
                                  device_ms_readings=ms, nvidia_smi=smi)), flush=True)


def experiments(arg: str) -> tuple:
    """``--exp``'s value as the experiments it names, in EXPERIMENTS' order."""
    names = set(arg.split(","))
    unknown = names - set(EXPERIMENTS) - {"all"}
    if unknown:
        raise argparse.ArgumentTypeError(f"unknown experiments {sorted(unknown)}; choose from {EXPERIMENTS} or all")
    return EXPERIMENTS if "all" in names else tuple(e for e in EXPERIMENTS if e in names)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--exp", type=experiments, default="all",
                        help=f"one of {EXPERIMENTS}, all, or a comma-separated list")
    parser.add_argument("--iters", type=int, default=50)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA device and found none")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        for exp, run in (("times", exp_times), ("packing", exp_packing), ("backward", exp_backward),
                         ("ab", exp_ab), ("digests", exp_digests)):
            if exp in args.exp:
                run(gen, args.iters, smi)


if __name__ == "__main__":
    main()
