"""The dense-attention A/B entry point: what the steps of the dense
attention kernel (K1) cost on the card, one experiment per question.

    python -m vtm_torch.tools.ab_dense --exp decomp
    python -m vtm_torch.tools.ab_dense --exp all --out build/ab_dense.jsonl

Each experiment runs the rows, shapes and variants of one of the JAX
package's ``tools/ab_*.py`` through the port's kernels
(``vtm_torch/ops/ab_attention.py``, T1-T12), at B8 (and B32) H12 d64 bf16:

  bisect       ab_bisect.py     T1 inside five host variants A-E: a real
                                ``q * 1.0`` pass (A against C), a shared bias
                                (B), flat inputs (D), no slice epilogue (E)
  mxu_pack     ab_mxu_pack.py   T2, T3 (q k^T alone, packed or not), and T4
                                (two heads per contraction) against K1
  b32          ab_b32.py        T5: the block order at B8 and B32, in turns
  decomp       ab_decomp.py     T6, T7 (row sums), T8 nosmax / linear / full
  decomp_bias  ab_decomp.py --bias   T9: a shared bias read two ways, beside
                                T8 full, all three on K1's tile loop
  decomp_cost  ab_decomp.py --cost   T10: the compiler hints, beside T9 1d
                                and K1
  dense_v2     ab_dense_v2.py   T11 v2_sum / v2_fold / v2_nomax against K1,
                                and four plain matrix products (torch.matmul)
                                at contraction 64 / 128 and width 64 / 128
  block_attn   ab_block_attn.py T12 alone and inside a ViT block slice (qkv
                                linear -> heads -> attention -> merge -> proj)

Every row is one JSON line: experiment, name, kernel id, shape, ``ms``
(median, min and max over repeats taken in turns with the experiment's
other rows, against drift), TFLOP/s of useful work, and three errors
relative to the reference's largest entry: ``rel_err_vs_fp32ref`` against
the plain version on the inputs cast to fp32, the bf16 plain version's own
``plain_rel_err_vs_fp32ref``, and ``err_vs_plain`` between the two. A row is
checked before it is timed, and the run stops on a row outside ``tol``
(see ``FP32_TOL``). ``chain`` linear cancels in its denominator: it is
compared on the rows that did not, and ``cancelled_rows`` says how many
were left out and how far the kernel and the plain version each lie from
an fp64 recurrence there. Every experiment has a ``prod`` row, the ported
K1 (``tome_flash_attention``) in the same run, and a ``sdpa`` row where one
``scaled_dot_product_attention`` call computes the same function: the
yardstick, used nowhere in the port. The chunk-dependent three (T2, T3,
T8 linear) run at blk = 64, the kernels' key tile. Times are CUDA events
around queued calls; ``bisect``, ``decomp``, ``decomp_bias`` and
``decomp_cost`` rows also carry ``device_ms``, the calls' device time with
the host's cost hidden (``kernel_times.device_ms``), and
``library_device_ms``, the library call's. Nothing is written
unless ``--out`` names a file.

Runs on the first CUDA device; a machine without one raises. The CPU
(``main(argv, device="cpu")``: the plain versions at a small shape) is
for tests only.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import statistics
import subprocess
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

from vtm_torch.models.common import split_heads
from vtm_torch.ops import ab_attention as ab
from vtm_torch.ops import flash_attention
from vtm_torch.ops.flash_attention import _reference, tome_flash_attention
from vtm_torch.tools.kernel_times import device_ms
from vtm_torch.utils.benchmark import device_seconds

EXPERIMENTS = ("bisect", "mxu_pack", "b32", "decomp", "decomp_bias", "decomp_cost", "dense_v2", "block_attn")
D = ab.HEAD_DIM
# A row's result against its plain version on the inputs cast to fp32,
# relative to that result's largest entry: fp32 within FP32_TOL
# (``chain`` linear, on its well-conditioned rows, within LINEAR_TOL: what is
# left of the cancellation there); bf16 no worse than twice the bf16 plain
# version's own distance from fp32, or BF16_FLOOR (a few roundings of 2^-9).
FP32_TOL = 1e-5
LINEAR_TOL = 1e-4
BF16_FLOOR = 1e-2
# ``chain`` linear: the share of rows that may be left out as cancelled (about
# 0.15% at [96, 1600, 64], 1% at [8, 192, 64]), and how far past the plain
# version's distance from an fp64 recurrence the kernel may sit there (the
# medians over those rows; on an H100 the two agree within a tenth).
MAX_CANCELLED_SHARE = 0.03
CANCELLED_ROWS_FACTOR = 2.0


@dataclasses.dataclass
class Sizes:
    """The tools' shapes, and their small stand-ins."""
    b8: int = 8
    b32: int = 32
    h: int = 12
    n_pad: int = 1600                                   # probes and chains
    packed_ns: tuple = (1568, 1268, 968, 668, 368)      # ab_mxu_pack.py:281
    v2_ns: tuple = (1568, 1268, 968, 668)               # ab_dense_v2.py:236
    block_ns: tuple = (1568, 1418, 968)                 # ab_block_attn.py:167
    alone_ns: tuple = (1568, 1418)                      # ab_block_attn.py:182
    matmul_m: int = 4096                                # ab_dense_v2.py:203
    # ``exp_kernels`` only: T6 and T7 at key counts that end inside a 64-key
    # tile (37) and one tile short of 1600 (1568). T2 and T3 take only
    # multiples of 64, so their rows leave a row block of the Hopper body
    # empty or partly filled, and n_pad's 1600 (3200 packed) rows already
    # reach a partly filled one
    ragged_probes: tuple = (("T6", 37), ("T6", 1568), ("T7", 37), ("T7", 1568))


# ``k1_bits``: token counts whose last key tile ends early
K1_BITS_RAGGED_N = (200, 37)

CPU_SIZES = Sizes(b8=1, b32=2, h=2, n_pad=64, packed_ns=(40,), v2_ns=(40,), block_ns=(40,), alone_ns=(40,),
                  matmul_m=64)
# for ``exp_kernels`` in fp32: a ragged token count, and a multiple of 64 for T2 / T3
SMALL_SIZES = Sizes(b8=2, h=4, n_pad=192, packed_ns=(200,))


@dataclasses.dataclass
class Row:
    name: str
    fn: Callable[[], torch.Tensor]
    shape: tuple
    kernel: Optional[str] = None        # "T1" ... "T12", "K1"; None for a library call
    function: Optional[str] = None      # the wrapper's key in ab.AB_LAUNCHES
    mode: str = ""
    # the plain version on the same inputs (None), or on them cast to a dtype
    plain_as: Optional[Callable[[Optional[torch.dtype]], torch.Tensor]] = None
    flops: float = 0.0                  # useful operations of the products: those on zeros are not counted
    issued_flops: float = 0.0           # the products the kernel issues, zeros included, where more (packed probes)
    bound_flops: float = 0.0            # the operations the function needs, where fewer (the probes)
    nbytes: float = 0.0                 # every input read once, the output written once
    library: Optional[Callable[[], torch.Tensor]] = None  # one PyTorch call for the same function
    iters: int = 20
    note: str = ""
    per_clip: int = 0                   # batch size, where ms per clip is wanted
    trim: bool = False                  # compare the well-conditioned rows only


def kernel_row(name: str, kernel: str, wrapper: Callable, plain: Callable, args: tuple, shape=None,
               function: Optional[str] = None, **fields) -> Row:
    """A row from a wrapper, its plain version and one argument list."""
    def plain_as(dtype):
        return plain(*(a.to(dtype) if dtype is not None and isinstance(a, torch.Tensor) and a.is_floating_point()
                       else a for a in args))

    return Row(name, lambda: wrapper(*args), tuple(args[0].shape if shape is None else shape), kernel,
               function or wrapper.__name__, plain_as=plain_as, **fields)


def tolerance(dtype: torch.dtype, linear: bool, err_plain: float) -> float:
    if dtype == torch.float32:
        return LINEAR_TOL if linear else FP32_TOL
    return max(BF16_FLOOR, 2 * err_plain)


class Bench:
    def __init__(self, device: torch.device, sizes: Sizes, seed: int, reps: int, iters: int, out=None,
                 dtype: torch.dtype = torch.bfloat16):
        self.device, self.sizes, self.reps, self.iters, self.out = device, sizes, reps, iters, out
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.dtype = dtype
        self.device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        self.smi = None
        if device.type == "cuda":
            self.smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    def randn(self, *shape, std: float = 1.0):
        return (torch.randn(shape, generator=self.gen, device=self.device) * std).to(self.dtype)

    def log_sizes(self, *shape):
        """A key bias as proportional attention makes it: log of sizes in [1, 12]."""
        return torch.log(torch.rand(shape, generator=self.gen, device=self.device) * 11 + 1)

    def emit(self, exp: str, **fields) -> None:
        line = json.dumps({"exp": exp, **fields, "device": self.device_name, "nvidia_smi": self.smi})
        print(line, flush=True)
        if self.out:
            self.out.write(line + "\n")

    def check(self, row: Row) -> dict:
        """Call the row once, check that its own launch count moved and no
        other, and hold the result against the plain version by the rule
        above. Raises AssertionError on a disagreement."""
        before = dict(ab.AB_LAUNCHES)
        got = row.fn().float()
        moved = {name: count - before[name] for name, count in ab.AB_LAUNCHES.items() if count != before[name]}
        on_card = self.device.type == "cuda" and row.function in ab.AB_LAUNCHES
        if moved != ({row.function: 1} if on_card else {}):
            raise AssertionError(f"{row.name}: launch counts moved by {moved}")
        want, plain = row.plain_as(torch.float32).float(), row.plain_as(None).float()
        err_plain = ab.relative_error(plain, want, row.trim)
        keep = ~ab.ill_conditioned_rows(want) if row.trim else ...
        out = dict(err_vs_plain=ab.relative_error(got, plain, row.trim),
                   rel_err_vs_fp32ref=ab.relative_error(got, want, row.trim),
                   plain_rel_err_vs_fp32ref=err_plain,
                   max_abs_err_vs_plain=(got[keep] - plain[keep]).abs().max().item(),
                   tol=tolerance(self.dtype, row.trim, err_plain))
        if row.trim:
            out["cancelled_rows"] = rows = ab.cancelled_rows(got, plain, want, row.plain_as(torch.float64))
            if rows["share"] > MAX_CANCELLED_SHARE or rows.get("kernel_row_err_vs_fp64", 0.0) > \
                    CANCELLED_ROWS_FACTOR * rows.get("plain_row_err_vs_fp64", 0.0):
                raise AssertionError(f"{row.name}: the rows left out as cancelled: {rows}")
        if not out["rel_err_vs_fp32ref"] <= out["tol"]:  # a NaN fails too
            raise AssertionError(f"{row.name} {self.dtype} at {row.shape}: {out}")
        return out

    def _ms(self, fn, iters: int) -> float:
        return device_seconds(fn, iters, 2 if self.device.type == "cuda" else 0, self.device) / iters * 1e3

    def run(self, exp: str, rows: List[Row], time_plain: bool = False, time_device: bool = False) -> List[dict]:
        """Check every row that has a plain version, then time the rows in
        turns, ``reps`` times over (each row's library call, with
        ``time_plain`` its plain version, and with ``time_device`` on the
        card the device time of the row and of its library call,
        ``kernel_times.device_ms``, in the same turn), and print them. Returns what was printed."""
        time_device = time_device and self.device.type == "cuda"
        with torch.inference_mode():
            errs = [self.check(row) if row.plain_as else {} for row in rows]
            times = [dict(ms=[], library_ms=[], plain_ms=[], device_ms=[], library_device_ms=[]) for _ in rows]
            for _ in range(self.reps):
                for row, ts in zip(rows, times):
                    iters = min(row.iters, self.iters)
                    ts["ms"].append(self._ms(row.fn, iters))
                    if time_device:
                        ts["device_ms"].append(device_ms(row.fn, iters))
                    if row.library:
                        ts["library_ms"].append(self._ms(row.library, iters))
                        if time_device:
                            ts["library_device_ms"].append(device_ms(row.library, iters))
                    if time_plain and row.plain_as:
                        ts["plain_ms"].append(self._ms(lambda: row.plain_as(None), min(iters, 5)))
        printed = []
        for row, err, ts in zip(rows, errs, times):
            ms = statistics.median(ts["ms"])
            fields = dict(name=row.name, shape=list(row.shape), dtype=str(self.dtype).split(".")[-1],
                          ms=dict(median=ms, min=min(ts["ms"]), max=max(ts["ms"])), **err)
            fields.update({key: statistics.median(ts[key])
                           for key in ("library_ms", "plain_ms", "device_ms", "library_device_ms")
                           if ts[key]})
            for key in ("kernel", "function", "mode", "flops", "issued_flops", "bound_flops", "nbytes", "note"):
                if getattr(row, key):
                    fields[key] = getattr(row, key)
            if row.flops:
                fields["tflops"] = row.flops / ms / 1e9
            if row.per_clip:
                fields["ms_per_clip"] = ms / row.per_clip
            self.emit(exp, **fields)
            printed.append(fields)
        return printed


def sdpa_call(q, k, v, bias, scale):
    """One scaled_dot_product_attention call for the same function: the
    yardstick, used nowhere in the port. ``bias``: fp32 with the keys last
    and the batch (or 1) first."""
    q, k, v = (t.contiguous() for t in (q, k, v))
    mask = None if bias is None else bias.reshape(bias.shape[0], 1, 1, -1).to(q.dtype)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)


def _sdpa_row(name, q, k, v, bias, scale, flops, iters=20) -> Row:
    return Row(name, sdpa_call(q, k, v, bias, scale), tuple(q.shape), flops=flops, iters=iters,
               note="library call, yardstick only")


def _prod_row(name, q, k, v, bias, scale, flops, iters=20, per_clip=0) -> Row:
    """The ported K1 on the same inputs."""
    return kernel_row(name, "K1", tome_flash_attention, _reference, (q, k, v, bias, scale), function="K1",
                      flops=flops, iters=iters, per_clip=per_clip)


def _flat_inputs(bench: Bench):
    """[bh, n_pad, 64] standard normal q, k, v, their 4-D views, and the
    chain's useful operations."""
    s = bench.sizes
    bh = s.b8 * s.h
    q3, k3, v3 = (bench.randn(bh, s.n_pad, D) for _ in range(3))
    views = [t.view(s.b8, s.h, s.n_pad, D) for t in (q3, k3, v3)]
    return (q3, k3, v3), views, 4.0 * bh * s.n_pad * s.n_pad * D


def _probe_rows(bench: Bench, q3, k3) -> dict:
    """T2, T3, T6, T7 on [bh, n, 64] operands and their packed forms.
    ``flops`` is the q k^T product the kernel does (useful: the packed
    forms' zeros are not counted; ``issued_flops`` counts them, twice the
    useful product, which the kernel issues but the function does not
    need); ``bound_flops`` what the function needs,
    since sum_t q.k[64t + c] = q.(sum_t k[64t + c]) and a row sum of q k^T
    is q.(sum_j k_j): one pass over k and a product 64 wide or 1 wide. The
    library call is one einsum of the same function."""
    bh, m, _ = q3.shape
    es = q3.element_size()
    qp, kc = ab.pack_q(q3), ab.pack_k(k3)
    product = 2.0 * bh * m * m * D
    columns, rowsum = bh * m * D * (1.0 + 2 * ab.KEY_TILE), bh * m * D * 3.0
    note = f"blk = {ab.KEY_TILE}, the kernels' key tile: every column of every chunk is kept"
    packed = "twice the products issued at contraction 128, half of them on zeros"

    def chunk_columns(q, k):
        return lambda: torch.einsum("gid,gtcd->gic", q, k.view(k.shape[0], -1, ab.KEY_TILE, k.shape[-1]))

    def row_sums(q, k):
        return lambda: torch.einsum("gid,gjd->gi", q, k)

    return {
        "T2": kernel_row("qk64", "T2", ab.qk64, ab.qk64_plain, (q3, k3, ab.KEY_TILE), flops=product,
                         bound_flops=columns, nbytes=3 * bh * m * D * es, library=chunk_columns(q3, k3), note=note),
        "T3": kernel_row("qk_packed_prebuilt", "T3", ab.qk_packed, ab.qk_packed_plain, (qp, kc, ab.KEY_TILE),
                         flops=product, issued_flops=2 * product, bound_flops=columns,
                         nbytes=(qp.numel() + kc.numel() + bh * m * D) * es, library=chunk_columns(qp, kc),
                         note=f"{note}; {packed}"),
        "T6": kernel_row("qk_d64", "T6", ab.qk_d64, ab.qk_d64_plain, (q3, k3), flops=product, bound_flops=rowsum,
                         nbytes=2 * bh * m * D * es + bh * m * 4, library=row_sums(q3, k3),
                         note="row sums consume every column"),
        "T7": kernel_row("qk_packed", "T7", ab.qk_packed_rowsum, ab.qk_packed_rowsum_plain, (qp, kc), flops=product,
                         issued_flops=2 * product, bound_flops=rowsum,
                         nbytes=(qp.numel() + kc.numel()) * es + bh * m * 4, library=row_sums(qp, kc), note=packed),
    }


# ---------------------------------------------------------------- experiments


def bisect_variant(name: str, attn: Callable, b: int, h: int, n: int, device) -> Callable:
    """The five host variants of ab_bisect.py:57-103 around ``attn``
    (``chunked_attention`` or its plain version). A-C and E take 4-D
    q, k, v; D takes them flat."""
    def zeros(rows):
        return torch.zeros((rows, 1, n), dtype=torch.float32, device=device)

    def flat(t):
        return t.reshape(b * h, n, D)

    if name == "A_verbatim":
        return lambda q, k, v: attn(flat(q * 1.0), flat(k), flat(v), zeros(b), False, h)[:, :n].reshape(b, h, n, D)
    if name == "B_sharedbias":
        return lambda q, k, v: attn(flat(q * 1.0), flat(k), flat(v), zeros(1), True, h)[:, :n].reshape(b, h, n, D)
    if name == "C_noscale":
        return lambda q, k, v: attn(flat(q), flat(k), flat(v), zeros(b), False, h)[:, :n].reshape(b, h, n, D)
    if name == "D_flat":
        return lambda q, k, v: attn(q * 1.0, k, v, zeros(b), False, h)
    if name == "E_noslice":
        return lambda q, k, v: attn(flat(q * 1.0), flat(k), flat(v), zeros(b), False, h)
    raise KeyError(name)


BISECT_VARIANTS = ("A_verbatim", "B_sharedbias", "C_noscale", "D_flat", "E_noslice")


def exp_bisect(bench: Bench) -> None:
    s = bench.sizes
    flat, views, flops = _flat_inputs(bench)
    rows = []
    for name in BISECT_VARIANTS:
        kernel = bisect_variant(name, ab.chunked_attention, s.b8, s.h, s.n_pad, bench.device)
        plain = bisect_variant(name, ab.chunked_attention_plain, s.b8, s.h, s.n_pad, bench.device)
        rows.append(kernel_row(name, "T1", kernel, plain, tuple(flat if name == "D_flat" else views),
                               function="chunked_attention", flops=flops))
    rows.append(_prod_row("prod", *views, None, 1.0, flops))
    rows.append(_sdpa_row("sdpa", *views, None, 1.0, flops))
    bench.run("bisect", rows, time_device=True)


def _attention_inputs(bench: Bench, b: int, n: int, biased: bool):
    h = bench.sizes.h
    q, k, v = (bench.randn(b, h, n, D) for _ in range(3))
    bias = bench.log_sizes(b, n) if biased else None
    return q, k, v, bias, 4.0 * b * h * n * n * D


def _shape_sweep(bench: Bench, ns) -> list:
    """(batch, n, biased): B8 at every n, B32 at the first, unbiased; then
    B8 at the first n biased (ab_mxu_pack.py:281-285, ab_dense_v2.py:236-240)."""
    s = bench.sizes
    shapes = [(s.b8, n) for n in ns] + [(s.b32, ns[0])]
    return [(b, n, False) for b, n in shapes] + [(s.b8, ns[0], True)]


def exp_mxu_pack(bench: Bench) -> None:
    s = bench.sizes
    (q3, k3, _), _, _ = _flat_inputs(bench)
    probes = _probe_rows(bench, q3, k3)
    bench.run("mxu_pack", [probes["T2"], probes["T3"]])
    scale = D ** -0.5
    for b, n, biased in _shape_sweep(bench, s.packed_ns):
        q, k, v, bias, flops = _attention_inputs(bench, b, n, biased)
        tag = f"b{b}_n{n}" + ("_biased" if biased else "")
        iters = 5 if b > s.b8 else 20
        bench.run("mxu_pack", [
            _prod_row(f"prod_{tag}", q, k, v, bias, scale, flops, iters),
            kernel_row(f"packed_{tag}", "T4", ab.packed_attention, ab.packed_attention_plain,
                       (q, k, v, bias, scale), flops=flops, iters=iters),
            _sdpa_row(f"sdpa_{tag}", q, k, v, bias, scale, flops, iters),
        ])


def exp_b32(bench: Bench) -> None:
    """ab_b32.py:97-113 without the VTM_DENSE_BLK rows (a TPU knob): K1,
    T5 and, as T5's control, the same body unswapped (T12), each at B8 then
    B32, all taken in turns."""
    s = bench.sizes
    n, scale = s.packed_ns[0], D ** -0.5
    rows = []
    for b in (s.b8, s.b32):
        q, k, v, _, flops = _attention_inputs(bench, b, n, False)
        iters = 5 if b > s.b8 else 20
        rows.append(_prod_row(f"prod_b{b}", q, k, v, None, scale, flops, iters, per_clip=b))
        rows.append(kernel_row(f"gridswap_b{b}", "T5", ab.grid_swapped, ab.grid_swapped_plain, (q, k, v, scale),
                               flops=flops, iters=iters, per_clip=b, note="b*h fastest in the grid"))
        rows.append(kernel_row(f"unswapped_b{b}", "T12", ab.n8_attention, ab.n8_attention_plain, (q, k, v, scale),
                               flops=flops, iters=iters, per_clip=b, note="the same body, q tile fastest"))
        rows.append(_sdpa_row(f"sdpa_b{b}", q, k, v, None, scale, flops, iters))
    bench.run("b32", rows)


CHAIN_NOTES = {"nosmax": "q k^T, cast, p v: no softmax; divides by 1e-6",
               "linear": f"every softmax pass, identity in place of exp; blk = {ab.KEY_TILE}; compared on the "
                         "rows whose denominator did not cancel (cancelled_rows: the others)",
               "full": "online softmax: K1's arithmetic without the scale"}


def _chain_row(q3, k3, v3, mode: str, flops: float, **fields) -> Row:
    return kernel_row(f"chain_{mode}", "T8", ab.chain, ab.chain_plain, (q3, k3, v3, mode, ab.KEY_TILE), mode=mode,
                      flops=flops, note=CHAIN_NOTES[mode], trim=mode == "linear", **fields)


def exp_decomp(bench: Bench) -> None:
    (q3, k3, v3), views, flops = _flat_inputs(bench)
    probes = _probe_rows(bench, q3, k3)
    rows = [probes["T6"], probes["T7"]] + [_chain_row(q3, k3, v3, mode, flops) for mode in ab.CHAIN_MODES]
    rows.append(_prod_row("prod", *views, None, 1.0, flops))
    rows.append(_sdpa_row("sdpa", *views, None, 1.0, flops))
    bench.run("decomp", rows, time_device=True)


BIAS_NOTES = {"1d": "bias read per element from device memory after q k^T",
              "2d": "bias copied into shared memory with each key tile's k and v"}
COST_NOTE = "an occupancy target (bf16: 4 blocks an SM; fp32: 3) and the largest shared-memory carve-out"


def _bias_rows(q3, k3, v3, bias, modes, flops, **fields) -> list:
    return [kernel_row(f"chain_full_bias{mode}", "T9", ab.chain_bias, ab.chain_bias_plain, (q3, k3, v3, bias, mode),
                       mode=mode, flops=flops, note=BIAS_NOTES[mode], **fields) for mode in modes]


def _cost_row(q3, k3, v3, bias, flops, **fields) -> Row:
    return kernel_row("chain_bias1d_cost", "T10", ab.chain_bias_cost, ab.chain_bias_cost_plain, (q3, k3, v3, bias),
                      flops=flops, note=COST_NOTE, **fields)


def exp_decomp_bias(bench: Bench) -> None:
    (q3, k3, v3), views, flops = _flat_inputs(bench)
    bias = torch.zeros((1, 1, bench.sizes.n_pad), dtype=torch.float32, device=bench.device)
    rows = [_chain_row(q3, k3, v3, "full", flops)]
    rows += _bias_rows(q3, k3, v3, bias, ab.BIAS_MODES, flops)
    rows.append(_prod_row("prod", *views, None, 1.0, flops))
    rows.append(_prod_row("prod_scaled", *views, None, 0.125, flops))
    rows.append(_sdpa_row("sdpa", *views, bias, 1.0, flops))
    bench.run("decomp_bias", rows, time_device=True)


def exp_decomp_cost(bench: Bench) -> None:
    (q3, k3, v3), views, flops = _flat_inputs(bench)
    bias = torch.zeros((1, 1, bench.sizes.n_pad), dtype=torch.float32, device=bench.device)
    rows = _bias_rows(q3, k3, v3, bias, ("1d",), flops)
    rows.append(_cost_row(q3, k3, v3, bias, flops))
    rows.append(kernel_row("fa_forward_raw", "K1", flash_attention._forward, _reference, (*views, None, 1.0),
                           function="K1", flops=flops, note="K1 without its autograd.Function"))
    rows.append(_prod_row("prod", *views, None, 1.0, flops))
    bench.run("decomp_cost", rows, time_device=True)


def exp_dense_v2(bench: Bench) -> None:
    s = bench.sizes
    m = s.matmul_m
    probes = []
    for depth in (64, 128):  # contraction width
        a, w = bench.randn(m, depth), bench.randn(depth, m)
        probes.append(Row(f"einsum_contract{depth}", lambda a=a, w=w: torch.matmul(a, w), (m, depth, m),
                          flops=2.0 * m * m * depth, note="torch.matmul, a plain product outside any kernel"))
    for width in (64, 128):  # output width
        a, w = bench.randn(m, m), bench.randn(m, width)
        probes.append(Row(f"einsum_outwidth{width}", lambda a=a, w=w: torch.matmul(a, w), (m, m, width),
                          flops=2.0 * m * m * width, note="torch.matmul, a plain product outside any kernel"))
    bench.run("dense_v2", probes)
    scale = D ** -0.5
    for b, n, biased in _shape_sweep(bench, s.v2_ns):
        q, k, v, bias, flops = _attention_inputs(bench, b, n, biased)
        tag = f"b{b}_n{n}" + ("_biased" if biased else "")
        iters = 5 if b > s.b8 else 20
        rows = [_prod_row(f"prod_{tag}", q, k, v, bias, scale, flops, iters)]
        rows += [kernel_row(f"{variant}_{tag}", "T11", ab.v2_attention, ab.v2_attention_plain,
                            (q, k, v, bias, scale, variant), mode=variant, flops=flops, iters=iters)
                 for variant in ab.V2_VARIANTS]
        rows.append(_sdpa_row(f"sdpa_{tag}", q, k, v, bias, scale, flops, iters))
        bench.run("dense_v2", rows)


def block_slice(x, wqkv, bqkv, wproj, bproj, attn: Callable, h: int) -> torch.Tensor:
    """qkv linear -> split heads (views) -> attention -> merge heads (a
    view of the kernels' token-major output) -> proj linear
    (ab_block_attn.py:130-143). The two linears are F.linear."""
    b, n, dim = x.shape
    qkv = F.linear(x, wqkv, bqkv).view(b, n, 3, h, dim // h)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(dim=2))
    o = attn(q, k, v, (dim // h) ** -0.5)
    return F.linear(o.transpose(1, 2).reshape(b, n, dim), wproj, bproj)


def exp_block_attn(bench: Bench) -> None:
    s = bench.sizes
    dim = s.h * D
    params = (bench.randn(3 * dim, dim, std=0.02), torch.zeros(3 * dim, dtype=bench.dtype, device=bench.device),
              bench.randn(dim, dim, std=0.02), torch.zeros(dim, dtype=bench.dtype, device=bench.device))

    def prod(q, k, v, scale):
        return tome_flash_attention(q, k, v, None, scale)

    def prod_plain(q, k, v, scale):
        return _reference(q, k, v, None, scale)

    linear_flops = 2.0 * 4 * dim * dim  # per token: the qkv and proj products
    rows = []
    for n in s.block_ns:
        x = bench.randn(s.b8, n, dim)
        flops = 4.0 * s.b8 * s.h * n * n * D + s.b8 * n * linear_flops
        for which, kernel, function, attn, plain in (("prod", "K1", "K1", prod, prod_plain),
                                                     ("n8", "T12", "n8_attention", ab.n8_attention,
                                                      ab.n8_attention_plain)):
            rows.append(kernel_row(f"{which}_block_n{n}", kernel, functools.partial(block_slice, attn=attn, h=s.h),
                                   functools.partial(block_slice, attn=plain, h=s.h), (x, *params),
                                   function=function, flops=flops,
                                   note="qkv linear, heads, attention, merge, proj linear"))
    scale = D ** -0.5
    for n in s.alone_ns:
        q, k, v, _, flops = _attention_inputs(bench, s.b8, n, False)
        rows.append(_prod_row(f"prod_alone_n{n}", q, k, v, None, scale, flops))
        rows.append(kernel_row(f"n8_alone_n{n}", "T12", ab.n8_attention, ab.n8_attention_plain, (q, k, v, scale),
                               flops=flops))
        rows.append(_sdpa_row(f"sdpa_alone_n{n}", q, k, v, None, scale, flops))
    bench.run("block_attn", rows)


def exp_kernels(bench: Bench) -> List[dict]:
    """Every function and mode once, each timed beside its plain version
    and, where one call computes the same function, a library call, and on
    the card by its device time too; not
    one of ``--exp``'s experiments (``check_ab`` and ``chip_smoke.py`` run
    it, in fp32 at ``SMALL_SIZES`` and in bf16 at the tools' shapes). The
    probes and chains get contiguous [bh, n_pad, 64] operands, as the tools
    give them (standard normal; the chains take no scale); the 4-D
    functions get the strided split-heads views of a fused [B, N, 3*H*64]
    projection at the first of ``packed_ns`` tokens. T6 and T7 also run
    at ``ragged_probes``, a row each (mode ``n <tokens>``), so that a key
    tile that ends early is checked on the card."""
    s = bench.sizes
    b, h, m, n = s.b8, s.h, s.n_pad, s.packed_ns[0]
    es = torch.empty((), dtype=bench.dtype).element_size()
    (q3, k3, v3), views, flops = _flat_inputs(bench)
    io3 = 4 * b * h * m * D * es
    rows = []
    for shared in (False, True):
        bias = bench.log_sizes(1 if shared else b, 1, m)
        rows.append(kernel_row("chunked_attention", "T1", ab.chunked_attention, ab.chunked_attention_plain,
                               (q3, k3, v3, bias, shared, h), mode="shared bias" if shared else "per-batch bias",
                               flops=flops, nbytes=io3 + bias.numel() * 4,
                               library=sdpa_call(*views, bias.expand(b, 1, m), 1.0)))
    probes = _probe_rows(bench, q3, k3)
    rows += [probes["T2"], probes["T3"], probes["T6"], probes["T7"]]
    for tid, tokens in s.ragged_probes:
        row = _probe_rows(bench, bench.randn(b * h, tokens, D), bench.randn(b * h, tokens, D))[tid]
        rows.append(dataclasses.replace(row, name=f"{row.name}_n{tokens}", mode=f"n {tokens}"))
    rows += [_chain_row(q3, k3, v3, mode, flops, nbytes=io3,
                        library=sdpa_call(*views, None, 1.0) if mode == "full" else None) for mode in ab.CHAIN_MODES]
    shared_bias = bench.log_sizes(1, 1, m)
    shared_sdpa = sdpa_call(*views, shared_bias, 1.0)
    rows += _bias_rows(q3, k3, v3, shared_bias, ab.BIAS_MODES, flops, nbytes=io3 + m * 4, library=shared_sdpa)
    rows.append(_cost_row(q3, k3, v3, shared_bias, flops, nbytes=io3 + m * 4, library=shared_sdpa))
    scale = D ** -0.5
    q, k, v = (split_heads(t, h) for t in bench.randn(b, n, 3 * h * D).chunk(3, dim=-1))
    flops, io4 = 4.0 * b * h * n * n * D, 4 * b * h * n * D * es
    for bias in (None, bench.log_sizes(b, n)):
        tag = "unbiased" if bias is None else "biased"
        fields = dict(flops=flops, nbytes=io4 + (0 if bias is None else bias.numel() * 4),
                      library=sdpa_call(q, k, v, bias, scale))
        rows.append(kernel_row("packed_attention", "T4", ab.packed_attention, ab.packed_attention_plain,
                               (q, k, v, bias, scale), mode=tag, **fields))
        rows += [kernel_row("v2_attention", "T11", ab.v2_attention, ab.v2_attention_plain,
                            (q, k, v, bias, scale, variant), mode=f"{variant}, {tag}", **fields)
                 for variant in ab.V2_VARIANTS]
    fields = dict(flops=flops, nbytes=io4, library=sdpa_call(q, k, v, None, scale))
    rows.append(kernel_row("grid_swapped", "T5", ab.grid_swapped, ab.grid_swapped_plain, (q, k, v, scale), **fields))
    rows.append(kernel_row("n8_attention", "T12", ab.n8_attention, ab.n8_attention_plain, (q, k, v, scale), **fields))
    return bench.run("kernels", sorted(rows, key=lambda r: int(r.kernel[1:])), time_plain=True, time_device=True)


def k1_bits(bench: Bench) -> List[dict]:
    """In bf16 T5, T12, T8 ``full``, T1, T9 and T10 run K1's instances of
    the Hopper tile loop (T9 ``2d`` with the bias staged, the same values),
    so on the same operands their outputs equal K1's
    (``tome_flash_attention``, no lse) bit for bit. T5 and T12 take the
    split-heads views of a fused [B, N, 3*H*64] projection, at B8 and the
    first of ``packed_ns`` tokens and T5 also at B32; T8 ``full`` (K1
    unbiased at scale 1 on [bh, 1, n, 64] views), T1 (K1 biased at scale 1
    on [b, h, n, 64] views, a per-batch bias, a shared one expanded to b
    rows, and the five ``--exp bisect`` host variants against a zero bias),
    T9 (both modes) and T10 (the shared log-size row against the same K1
    call as T1's shared case) take contiguous [bh, n, 64] operands at
    ``n_pad`` tokens; every function also at ``K1_BITS_RAGGED_N``. Raises
    AssertionError on the first bit that differs; returns a row per case.
    On the card only: on the CPU the plain versions round otherwise."""
    s = bench.sizes
    if bench.device.type != "cuda" or bench.dtype != torch.bfloat16:
        raise ValueError("k1_bits compares the bf16 kernels on the card")
    rows = []

    def compare(function: str, got: torch.Tensor, want: torch.Tensor, **case) -> None:
        want = want.reshape(got.shape)
        differ = int((got.contiguous().view(torch.int16) != want.contiguous().view(torch.int16)).sum())
        row = dict(function=function, **case, elements=want.numel(), bits_differ=differ)
        if differ:
            raise AssertionError(f"{function} does not give K1's bits: {row}")
        rows.append(row)

    n0, b, h = s.packed_ns[0], s.b8, s.h
    cases = [(fn, b, n) for n in (n0, *K1_BITS_RAGGED_N) for fn in ("grid_swapped", "n8_attention")]
    cases.append(("grid_swapped", s.b32, n0))
    scale = D ** -0.5
    with torch.inference_mode():
        for function, batch, n in cases:
            q, k, v = (split_heads(t, s.h) for t in bench.randn(batch, n, 3 * s.h * D).chunk(3, dim=-1))
            compare(function, getattr(ab, function)(q, k, v, scale), tome_flash_attention(q, k, v, None, scale),
                    batch=batch, n=n)
        for n in (s.n_pad, *K1_BITS_RAGGED_N):
            flat = [bench.randn(b * h, n, D) for _ in range(3)]
            views = [t.view(b, h, n, D) for t in flat]
            compare("chain", ab.chain(*flat, "full"),
                    tome_flash_attention(*(t.unsqueeze(1) for t in flat), None, 1.0), mode="full", batch=b, n=n)
            for shared in (False, True):
                bias = bench.log_sizes(1 if shared else b, 1, n)
                want = tome_flash_attention(*views, bias.view(-1, n).expand(b, n).contiguous(), 1.0)
                compare("chunked_attention", ab.chunked_attention(*flat, bias, shared, h), want,
                        mode="shared bias" if shared else "per-batch bias", batch=b, n=n)
                if shared:
                    for mode in ab.BIAS_MODES:
                        compare("chain_bias", ab.chain_bias(*flat, bias, mode), want, mode=mode, batch=b, n=n)
                    compare("chain_bias_cost", ab.chain_bias_cost(*flat, bias), want, batch=b, n=n)
            want = tome_flash_attention(*views, torch.zeros((b, n), device=bench.device), 1.0)
            for name in BISECT_VARIANTS:
                variant = bisect_variant(name, ab.chunked_attention, b, h, n, bench.device)
                compare("chunked_attention", variant(*(flat if name == "D_flat" else views)), want, mode=name,
                        batch=b, n=n)
    return rows


RUNNERS = {"bisect": exp_bisect, "mxu_pack": exp_mxu_pack, "b32": exp_b32, "decomp": exp_decomp,
           "decomp_bias": exp_decomp_bias, "decomp_cost": exp_decomp_cost, "dense_v2": exp_dense_v2,
           "block_attn": exp_block_attn}


def main(argv=None, device: torch.device | str | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--exp", choices=EXPERIMENTS + ("all",), default="all")
    parser.add_argument("--reps", type=int, default=3, help="timed repeats of every row, taken in turns")
    parser.add_argument("--iters", type=int, default=20, help="calls per repeat (B32 rows: at most 5)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None, help="also write the rows to this file, one JSON line each")
    args = parser.parse_args(argv)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("ab_dense needs a CUDA device and found none")
        device = "cuda"
    device = torch.device(device)
    on_cpu = device.type == "cpu"
    out = open(args.out, "w") if args.out else None
    try:
        bench = Bench(device, CPU_SIZES if on_cpu else Sizes(), args.seed, 1 if on_cpu else args.reps,
                      1 if on_cpu else args.iters, out)
        for exp in EXPERIMENTS if args.exp == "all" else (args.exp,):
            RUNNERS[exp](bench)
    finally:
        if out:
            out.close()


if __name__ == "__main__":
    main()
