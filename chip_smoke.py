#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vtm_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's two serving paths with random weights from a seed, in
bf16 at batch 8, merged and unmerged, through the entry point a user
calls (``vtm_torch.tools.model_benchmark.model_benchmark``):
  * VideoMAE ViT-B/16 at 16x224, merged with constant r=150 and no
    proportional attention (``MAIN_PATH_OPTS``: the values of
    configs/videomae/kinetics/tome_VideoMAE_B_16_224_K400.yaml);
  * Motionformer ViT-B/16 at 16x224 with trajectory attention, merged per
    pseudo-frame with r=18 and proportional attention
    (``MOTIONFORMER_OPTS``: the values of
    configs/motionformer/kinetics/tome_motionformer_224_16x4.yaml).
The configs are ``get_cfg()`` plus those --opts lists (no yaml parser
needed).

Phases, each printing one JSON line:
  1. device    -- fails without CUDA; prints nvidia-smi's name and power limit
  2. build     -- compiles the kernels from vtm_torch/ops/csrc with nvcc
  3. kernel    -- the dense attention kernel (K1) against its plain version
     frame_kernel -- the per-frame attention kernel (K3) against its plain
                  version
  4. blocks    -- teacher-forced VideoMAE ViT-B blocks, fp32: kernel path vs
                  plain path
     mf_blocks -- the same for Motionformer ViT-B blocks
  5. serve     -- VideoMAE model_benchmark merged and unmerged; launch counts,
                  token counts, finite logits, clips/s
     mf_serve  -- the same for Motionformer; probabilities sum to 1
Each serve phase sets the kernels' launch counts to 0 just before it and
reads them just after. Then a ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": ...}``. Any failure raises and the script exits
nonzero without the last line.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

from vtm_torch.config import get_cfg
from vtm_torch.merge import MergeState, bipartite_soft_matching
from vtm_torch.models import build_model
from vtm_torch.models.common import split_heads
from vtm_torch.ops import build as kernel_build
from vtm_torch.ops import flash_attention
from vtm_torch.ops.flash_attention import (
    _frame_reference,
    _reference,
    tome_flash_attention,
    tome_frame_attention,
)
from vtm_torch.tools.model_benchmark import model_benchmark

# configs/videomae/kinetics/tome_VideoMAE_B_16_224_K400.yaml, key by key,
# with the checkpoint placeholder replaced by "" (random weights).
MAIN_PATH_OPTS = [
    "TRAIN.AUTO_RESUME", "True",
    "TRAIN.BATCH_SIZE", "8",
    "TRAIN.CHECKPOINT_PERIOD", "5",
    "TRAIN.DATASET", "kinetics",
    "TRAIN.ENABLE", "True",
    "TRAIN.EVAL_PERIOD", "5",
    "DATA.INPUT_CHANNEL_NUM", "[3]",
    "DATA.MEAN", "[0.485, 0.456, 0.406]",
    "DATA.NUM_FRAMES", "16",
    "DATA.PATH_PREFIX", "<KINETICS-400-PATH-PREFIX>",
    "DATA.PATH_TO_DATA_DIR", "<KINETICS-400-VIDEO>",
    "DATA.SAMPLING_RATE", "1",
    "DATA.STD", "[0.229, 0.224, 0.225]",
    "DATA.TEST_CROP_SIZE", "224",
    "DATA.TRAIN_CROP_SIZE", "224",
    "DATA.TRAIN_JITTER_SCALES", "[256, 320]",
    "SOLVER.BASE_LR", "0.005",
    "SOLVER.LRS", "[1, 0.1, 0.01]",
    "SOLVER.LR_POLICY", "steps_with_relative_lrs",
    "SOLVER.MAX_EPOCH", "15",
    "SOLVER.MOMENTUM", "0.9",
    "SOLVER.OPTIMIZING_METHOD", "sgd",
    "SOLVER.STEPS", "[0, 11, 14]",
    "SOLVER.WEIGHT_DECAY", "0.0001",
    "MODEL.ARCH", "videomae",
    "MODEL.LOSS_FUNC", "cross_entropy",
    "MODEL.MODEL_NAME", "VideoMAE",
    "MODEL.NUM_CLASSES", "400",
    "VIDEOMAE.ATTN_DROP_RATE", "0.0",
    "VIDEOMAE.DROP_PATH_RATE", "0.0",
    "VIDEOMAE.DROP_RATE", "0.0",
    "VIDEOMAE.FC_DROP_RATE", "0.0",
    "VIDEOMAE.INIT_SCALE", "0.001",
    "VIDEOMAE.MODEL", "vit_base_patch16_224",
    "VIDEOMAE.TUBELET_SIZE", "2",
    "VIDEOMAE.USE_MEAN_POOLING", "True",
    "TOME.ENABLE", "True",
    "TOME.MODE", "merge",
    "TOME.PROP_ATTN", "False",
    "TOME.R_VALUE", "150",
    "TEST.BATCH_SIZE", "32",
    "TEST.CHECKPOINT_FILE_PATH", "",
    "TEST.DATASET", "kinetics",
    "TEST.ENABLE", "True",
    "TEST.NUM_ENSEMBLE_VIEWS", "1",
    "TEST.NUM_SPATIAL_CROPS", "1",
    "DATA_LOADER.NUM_WORKERS", "4",
    "DATA_LOADER.PIN_MEMORY", "True",
    "TPU.COMPUTE_DTYPE", "bfloat16",
    "NUM_GPUS", "1",
    "NUM_SHARDS", "1",
    "RNG_SEED", "0",
    "OUTPUT_DIR", ".",
]

# configs/motionformer/kinetics/tome_motionformer_224_16x4.yaml, key by
# key, with the checkpoint placeholder replaced by "" (random weights).
MOTIONFORMER_OPTS = [
    "TRAIN.AUTO_RESUME", "True",
    "TRAIN.BATCH_SIZE", "8",
    "TRAIN.CHECKPOINT_PERIOD", "5",
    "TRAIN.DATASET", "kinetics",
    "TRAIN.ENABLE", "True",
    "TRAIN.EVAL_PERIOD", "5",
    "TRAIN.MIXED_PRECISION", "True",
    "DATA.INPUT_CHANNEL_NUM", "[3]",
    "DATA.MEAN", "[0.5, 0.5, 0.5]",
    "DATA.NUM_FRAMES", "16",
    "DATA.PATH_PREFIX", "<KINETICS-400-PATH-PREFIX>",
    "DATA.PATH_TO_DATA_DIR", "<KINETICS-400-VIDEO>",
    "DATA.SAMPLING_RATE", "4",
    "DATA.STD", "[0.5, 0.5, 0.5]",
    "DATA.TEST_CROP_SIZE", "224",
    "DATA.TRAIN_CROP_SIZE", "224",
    "DATA.TRAIN_JITTER_SCALES", "[256, 320]",
    "MIXUP.LABEL_SMOOTH_VALUE", "0.2",
    "SOLVER.BASE_LR", "0.0001",
    "SOLVER.LRS", "[1, 0.1, 0.01]",
    "SOLVER.LR_POLICY", "steps_with_relative_lrs",
    "SOLVER.MAX_EPOCH", "35",
    "SOLVER.MOMENTUM", "0.9",
    "SOLVER.OPTIMIZING_METHOD", "adamw",
    "SOLVER.STEPS", "[0, 20, 30]",
    "SOLVER.WARMUP_EPOCHS", "0.0",
    "SOLVER.WEIGHT_DECAY", "0.05",
    "MODEL.ARCH", "motionformer",
    "MODEL.LOSS_FUNC", "cross_entropy",
    "MODEL.MODEL_NAME", "Motionformer",
    "MODEL.NUM_CLASSES", "400",
    "MOTIONFORMER.ATTN_LAYER", "trajectory",
    "MOTIONFORMER.CHANNELS", "3",
    "MOTIONFORMER.DEPTH", "12",
    "MOTIONFORMER.DROP", "0.0",
    "MOTIONFORMER.DROP_PATH", "0.0",
    "MOTIONFORMER.EMBED_DIM", "768",
    "MOTIONFORMER.HEAD_ACT", "tanh",
    "MOTIONFORMER.HEAD_DROPOUT", "0.0",
    "MOTIONFORMER.IM_PRETRAINED", "True",
    "MOTIONFORMER.MLP_RATIO", "4",
    "MOTIONFORMER.NUM_HEADS", "12",
    "MOTIONFORMER.PATCH_SIZE", "16",
    "MOTIONFORMER.PATCH_SIZE_TEMP", "2",
    "MOTIONFORMER.POS_DROPOUT", "0.0",
    "MOTIONFORMER.PRETRAINED_WEIGHTS", "vit_1k",
    "MOTIONFORMER.QKV_BIAS", "True",
    "MOTIONFORMER.TEMPORAL_RESOLUTION", "8",
    "MOTIONFORMER.USE_MLP", "True",
    "MOTIONFORMER.VIDEO_INPUT", "True",
    "TOME.ENABLE", "True",
    "TOME.MODE", "merge",
    "TOME.PROP_ATTN", "True",
    "TOME.R_VALUE", "18",
    "TEST.BATCH_SIZE", "32",
    "TEST.CHECKPOINT_FILE_PATH", "",
    "TEST.DATASET", "kinetics",
    "TEST.ENABLE", "True",
    "TEST.NUM_ENSEMBLE_VIEWS", "1",
    "TEST.NUM_SPATIAL_CROPS", "1",
    "DATA_LOADER.NUM_WORKERS", "4",
    "DATA_LOADER.PIN_MEMORY", "True",
    "TPU.COMPUTE_DTYPE", "bfloat16",
    "NUM_GPUS", "1",
    "NUM_SHARDS", "1",
    "RNG_SEED", "0",
    "OUTPUT_DIR", ".",
]

# Tokens entering each of the 12 layers at r=150, and the final count.
MERGED_COUNTS = (1568, 1418, 1268, 1118, 968, 818, 668, 518, 368, 218, 109, 55, 28)
MERGED_K1_PER_FORWARD = 9  # K1 runs for N >= 256: layers 0-8
KERNEL_SHAPES = [(8, 12, n, 64) for n in (1568, 1418, 368, 256, 3137)] + [(2, 2, 37, 16)]
TIMED = ((1568, False), (368, False))  # (N, biased)
FP32_TOL = 1e-4
BF16_FLOOR = 1e-2
BLOCK_TOL = 1e-4
SERVE_WARMUP, SERVE_ITERS = 2, 10
# Unmerged / merged GFLOP per clip, 365.6 / 151.7, from XLA's cost
# analysis of the same two programs (BENCH_DETAIL.json): the ratio's
# device-independent ceiling.
FLOP_CEILING = 365.6 / 151.7

# Motionformer: F=8 frames of s=196 tokens. Body tokens (8 x tokens per
# pseudo-frame) entering each layer at r=18, and the final count; K3 runs
# for 256 <= N' <= 4096, so in layers 0-9 merged and in all 12 unmerged.
MF_FRAMES = 8
MF_BODY_COUNTS = (1568, 1424, 1280, 1136, 992, 848, 704, 560, 416, 272, 136, 72, 40)
MF_K3_PER_FORWARD = {"merged": 10, "unmerged": 12}
# K3 at the Motionformer path's shapes (F=8): s = 196, 178 and 34 at B8;
# s=441 (the 336 crop) at B1; odd H and a small d at s=37.
FRAME_SHAPES = [(8, 12, n, 64) for n in (1568, 1424, 272)] + [(1, 12, 3528, 64), (2, 3, 296, 16)]
FRAME_TIMED = ((1568, False), (848, True))  # (N', biased): layer 0, and a merged layer
PROB_SUM_TOL = 1e-3
# Unmerged / merged GFLOP per clip, 573.8 / 260.1, from XLA's cost analysis
# (BENCH_FAMILIES.json): the ratio's device-independent ceiling.
MF_FLOP_CEILING = 573.8 / 260.1


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def main_cfg(*opts):
    cfg = get_cfg()
    cfg.merge_from_list(MAIN_PATH_OPTS + list(opts))
    return cfg


def mf_cfg(*opts):
    cfg = get_cfg()
    cfg.merge_from_list(MOTIONFORMER_OPTS + list(opts))
    return cfg


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def heads(qkv: torch.Tensor, h: int):
    """q, k, v as split_heads views of one fused [B, N, 3*H*d] projection,
    the strided layout the model hands the kernel."""
    return [split_heads(t, h) for t in qkv.chunk(3, dim=-1)]


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; nothing to run")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(
        "device",
        name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(),
        nvidia_smi=smi,
        torch=torch.__version__,
        cuda=torch.version.cuda,
    )
    return smi


def phase_build() -> None:
    seconds = kernel_build.build()
    kernel_build.load_library()
    emit("build", seconds=seconds, library=kernel_build.library_path().name)


def bf16_tol(err_plain: float) -> float:
    """A bf16 kernel may be off an fp32 reference by twice the bf16 plain
    version's own error, or by 1e-2, whichever is larger."""
    return max(BF16_FLOOR, 2 * err_plain)


def check_against_plain(kernel, plain, shapes):
    """Run ``kernel`` and its ``plain`` version, each called as
    f(q, k, v, key_bias, scale), biased and unbiased, on split_heads views
    of a fused projection offset by one row (the CLS row in Motionformer).
    fp32 must agree within FP32_TOL; bf16 must stay within bf16_tol of an
    fp32 reference. Returns (rows, largest difference from the plain
    version)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst_vs_plain = [], 0.0
    for b, h, n, d in shapes:
        scale = d ** -0.5
        for biased in (False, True):
            bias = (
                torch.log(torch.rand((b, n), generator=gen, device="cuda") * 4 + 1)
                if biased else None
            )
            fused = torch.randn((b, n + 1, 3 * h * d), generator=gen, device="cuda")
            q32, k32, v32 = heads(fused[:, 1:], h)
            # the kernel's output is allocated before the plain version runs,
            # so it cannot inherit the plain result's freed memory
            out32 = kernel(q32, k32, v32, bias, scale)
            err32 = (out32 - plain(q32, k32, v32, bias, scale)).abs().max().item()
            check(err32 <= FP32_TOL, f"fp32 kernel err {err32} > {FP32_TOL} at {(b, h, n, d)} bias={biased}")
            q, k, v = heads(fused.to(torch.bfloat16)[:, 1:], h)
            out = kernel(q, k, v, bias, scale)
            ref = plain(q.float(), k.float(), v.float(), bias, scale)
            base = plain(q, k, v, bias, scale)
            err_k = (out.float() - ref).abs().max().item()
            err_p = (base.float() - ref).abs().max().item()
            tol = bf16_tol(err_p)
            check(err_k <= tol, f"bf16 kernel err {err_k} > {tol} at {(b, h, n, d)} bias={biased}")
            vs_plain = (out.float() - base.float()).abs().max().item()
            worst_vs_plain = max(worst_vs_plain, vs_plain, err32)
            rows.append(dict(shape=[b, h, n, d], biased=biased, fp32_err=err32,
                             bf16_err=err_k, bf16_plain_err=err_p, bf16_vs_plain=vs_plain))
    torch.cuda.synchronize()
    return rows, worst_vs_plain


def time_against_plain(kernel, plain, cases) -> dict:
    """ms per call at B8 H12 d64 bf16 for each (N, biased) case, taken in
    turns: plain, kernel, kernel, plain."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    times = {}
    for n, biased in cases:
        q, k, v = heads(torch.randn((8, n, 3 * 768), generator=gen, device="cuda").to(torch.bfloat16), 12)
        bias = torch.log(torch.rand((8, n), generator=gen, device="cuda") * 4 + 1) if biased else None
        kern = lambda: kernel(q, k, v, bias, 0.125)  # noqa: E731
        base = lambda: plain(q, k, v, bias, 0.125)  # noqa: E731
        p1, k1, k2, p2 = cuda_ms(base), cuda_ms(kern), cuda_ms(kern), cuda_ms(base)
        flops = 4 * 8 * 12 * n * n * 64
        times[str(n)] = dict(biased=biased, kernel_ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                             kernel_tflops=flops / ((k1 + k2) / 2) / 1e9)
    return times


def phase_kernel(phase: str, kernel, plain, shapes, timed) -> dict:
    """A kernel against its plain version at its path's shapes; returns
    the largest difference and the times of the first timed case."""
    rows, worst_vs_plain = check_against_plain(kernel, plain, shapes)
    times = time_against_plain(kernel, plain, timed)
    emit(phase, checks=rows, max_abs_err_vs_plain=worst_vs_plain, timing_bf16_B8_H12_d64=times)
    first = times[str(timed[0][0])]
    return dict(max_abs_err=worst_vs_plain, ms=first["kernel_ms"], plain_ms=first["plain_ms"])


def phase_blocks(phase: str, cfg, seed: int, block_kwargs: dict, launch_count, final_tokens: int,
                 launches_expected: int) -> None:
    """Teacher-forced full-width blocks (fp32, TF32 off, B2): each block
    gets the plain chain's input through the kernel path and the plain
    path, which must make identical Matching indices and sizes and
    outputs within BLOCK_TOL."""
    model = build_model(cfg, "cuda").module
    video = torch.from_numpy(
        np.random.default_rng(seed).random((2, 16, 224, 224, 3), dtype=np.float32)
    ).cuda()
    metrics = []
    hooks = [blk.attn.register_forward_hook(lambda m, i, o: metrics.append(o[1]))
             for blk in model.blocks]
    launches0, rows = launch_count(), []
    with torch.inference_mode():
        x = model.embed(video)
        size = None
        for i, blk in enumerate(model.blocks):
            outs = {}
            for path in ("kernel", "plain"):
                blk.attn.use_kernel = path == "kernel"
                metrics.clear()
                y, st = blk(x, MergeState(size=size), layer=i, **block_kwargs)
                m = bipartite_soft_matching(metrics[0], model.policy.r_at(i))
                outs[path] = (y, st.size, m)
            blk.attn.use_kernel = True
            (yk, sk, mk), (yp, sp, mp) = outs["kernel"], outs["plain"]
            for name in ("unm_idx", "src_idx", "dst_idx"):
                check(torch.equal(getattr(mk, name), getattr(mp, name)),
                      f"{phase} {i}: {name} differs between kernel and plain paths")
            check(torch.equal(sk, sp), f"{phase} {i}: sizes differ")
            err = (yk - yp).abs().max().item()
            check(err <= BLOCK_TOL, f"{phase} {i}: output err {err} > {BLOCK_TOL}")
            rows.append(dict(layer=i, tokens=x.shape[1], err=err))
            x, size = yp, sp
    for hk in hooks:
        hk.remove()
    check(x.shape[1] == final_tokens, f"{phase}: final tokens {x.shape[1]}")
    launches = launch_count() - launches0
    check(launches == launches_expected, f"{phase}: {launches} kernel launches")
    emit(phase, layers=rows, kernel_launches=launches)


def flops_per_clip(counts, c: int = 768, mlp: int = 3072) -> float:
    """Multiply-adds x2 of one clip's forward from the per-layer token
    counts (attention on the tokens entering a layer, MLP on the tokens
    left after its merge), plus the tubelet embedding."""
    total = 2 * counts[0] * c * (2 * 16 * 16 * 3)
    for n_in, n_out in zip(counts[:-1], counts[1:]):
        total += 2 * n_in * c * 4 * c + 4 * n_in * n_in * c + 2 * n_out * c * mlp * 2
    return float(total)


def phase_serve(smi: str) -> int:
    video = torch.from_numpy(
        np.random.default_rng(2).random((8, 16, 224, 224, 3), dtype=np.float32)
    ).cuda()
    runs = {}
    # this path's counts start here
    flash_attention.LAUNCHES = flash_attention.FRAME_LAUNCHES = 0
    for label, opts, counts, per_forward in (
        ("merged", (), MERGED_COUNTS, MERGED_K1_PER_FORWARD),
        ("unmerged", ("TOME.ENABLE", "False"), (1568,) * 13, 12),
    ):
        cfg = main_cfg("TEST.BATCH_SIZE", "8", "MODEL_BENCHMARK.WARMUP_ITERATIONS", str(SERVE_WARMUP),
                       "MODEL_BENCHMARK.ITERATIONS", str(SERVE_ITERS), *opts)
        before = flash_attention.LAUNCHES
        stats = model_benchmark(cfg)
        bundle = build_model(cfg, "cuda")
        seen = []  # tokens entering each block, then leaving the last
        blocks = bundle.module.blocks
        hooks = [blk.register_forward_pre_hook(lambda m, a: seen.append(a[0].shape[1]))
                 for blk in blocks]
        hooks.append(blocks[-1].register_forward_hook(lambda m, a, o: seen.append(o[0].shape[1])))
        with torch.inference_mode():
            logits, _ = bundle.module(video)
        torch.cuda.synchronize()
        for hk in hooks:
            hk.remove()
        launches = flash_attention.LAUNCHES - before
        check(tuple(logits.shape) == (8, 400), f"{label}: logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")
        check(tuple(seen) == counts, f"{label}: token counts {seen}")
        check(tuple(bundle.policy.token_counts(1568)) == counts, f"{label}: schedule")
        check(stats["attention_kernel_launches"] == per_forward,
              f"{label}: {stats['attention_kernel_launches']} launches per forward")
        forwards = SERVE_WARMUP + SERVE_ITERS + 1
        check(launches == per_forward * forwards, f"{label}: {launches} launches in {forwards} forwards")
        runs[label] = dict(clips_per_sec=stats["clips_per_sec"], launches=launches,
                           launches_per_forward=stats["attention_kernel_launches"],
                           token_counts=list(counts), gflop_per_clip=flops_per_clip(counts) / 1e9)
    total = flash_attention.LAUNCHES  # read right after the path ran
    check(total > 0, "the VideoMAE path launched no attention kernel")
    check(flash_attention.FRAME_LAUNCHES == 0, "the VideoMAE path launched the frame kernel")
    emit(
        "serve",
        merged=runs["merged"],
        unmerged=runs["unmerged"],
        speedup=runs["merged"]["clips_per_sec"] / runs["unmerged"]["clips_per_sec"],
        flop_ratio=runs["unmerged"]["gflop_per_clip"] / runs["merged"]["gflop_per_clip"],
        flop_ceiling=FLOP_CEILING,
        batch=8, dtype="bfloat16", nvidia_smi=smi,
    )
    return total


def phase_mf_serve(smi: str) -> int:
    video = torch.from_numpy(
        np.random.default_rng(5).random((8, 16, 224, 224, 3), dtype=np.float32)
    ).cuda()
    runs = {}
    # this path's counts start here
    flash_attention.LAUNCHES = flash_attention.FRAME_LAUNCHES = 0
    for label, opts, counts in (
        ("merged", (), MF_BODY_COUNTS),
        ("unmerged", ("TOME.ENABLE", "False"), (MF_BODY_COUNTS[0],) * 13),
    ):
        per_forward = MF_K3_PER_FORWARD[label]
        cfg = mf_cfg("TEST.BATCH_SIZE", "8", "MODEL_BENCHMARK.WARMUP_ITERATIONS", str(SERVE_WARMUP),
                     "MODEL_BENCHMARK.ITERATIONS", str(SERVE_ITERS), *opts)
        before = flash_attention.FRAME_LAUNCHES
        stats = model_benchmark(cfg)
        bundle = build_model(cfg, "cuda")
        seen = []  # body tokens entering each block, then leaving the last
        blocks = bundle.module.blocks
        hooks = [blk.register_forward_pre_hook(lambda m, a: seen.append(a[0].shape[1] - 1))
                 for blk in blocks]
        hooks.append(blocks[-1].register_forward_hook(lambda m, a, o: seen.append(o[0].shape[1] - 1)))
        with torch.inference_mode():
            probs, _ = bundle.module(video)
        torch.cuda.synchronize()
        for hk in hooks:
            hk.remove()
        launches = flash_attention.FRAME_LAUNCHES - before
        check(tuple(probs.shape) == (8, 400), f"Motionformer {label}: output shape {tuple(probs.shape)}")
        check(bool(torch.isfinite(probs).all()), f"Motionformer {label}: non-finite probabilities")
        row_err = (probs.sum(dim=-1) - 1).abs().max().item()
        check(row_err <= PROB_SUM_TOL, f"Motionformer {label}: rows sum to 1 within {row_err}")
        check(tuple(seen) == counts, f"Motionformer {label}: body token counts {seen}")
        per_frame = bundle.policy.token_counts(counts[0] // MF_FRAMES)
        check(tuple(MF_FRAMES * c for c in per_frame) == counts, f"Motionformer {label}: schedule")
        check(stats["frame_attention_kernel_launches"] == per_forward,
              f"Motionformer {label}: {stats['frame_attention_kernel_launches']} K3 launches per forward")
        check(stats["attention_kernel_launches"] == 0, f"Motionformer {label}: K1 launched")
        forwards = SERVE_WARMUP + SERVE_ITERS + 1
        check(launches == per_forward * forwards,
              f"Motionformer {label}: {launches} K3 launches in {forwards} forwards")
        runs[label] = dict(clips_per_sec=stats["clips_per_sec"], launches=launches,
                           frame_launches_per_forward=stats["frame_attention_kernel_launches"],
                           body_token_counts=list(counts), max_row_sum_err=row_err)
    total = flash_attention.FRAME_LAUNCHES  # read right after the path ran
    check(total > 0, "the Motionformer path launched no frame kernel")
    check(flash_attention.LAUNCHES == 0, "the Motionformer path launched the dense kernel")
    emit(
        "mf_serve",
        merged=runs["merged"],
        unmerged=runs["unmerged"],
        speedup=runs["merged"]["clips_per_sec"] / runs["unmerged"]["clips_per_sec"],
        flop_ceiling=MF_FLOP_CEILING,
        batch=8, dtype="bfloat16", nvidia_smi=smi,
    )
    return total


def main() -> int:
    t0 = time.perf_counter()
    smi = phase_device()
    # full fp32 for every fp32 product and convolution (the block check)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    kernel = phase_kernel("kernel", tome_flash_attention, _reference, KERNEL_SHAPES, TIMED)
    frame_kernel = phase_kernel(
        "frame_kernel",
        functools.partial(tome_frame_attention, frames=MF_FRAMES),
        functools.partial(_frame_reference, frames=MF_FRAMES),
        FRAME_SHAPES,
        FRAME_TIMED,
    )
    fp32_b2 = ("TPU.COMPUTE_DTYPE", "float32", "TEST.BATCH_SIZE", "2")
    phase_blocks("blocks", main_cfg(*fp32_b2), 1, {}, lambda: flash_attention.LAUNCHES,
                 MERGED_COUNTS[-1], MERGED_K1_PER_FORWARD)
    phase_blocks("mf_blocks", mf_cfg(*fp32_b2), 4, {"num_frames": MF_FRAMES},
                 lambda: flash_attention.FRAME_LAUNCHES, MF_BODY_COUNTS[-1] + 1,
                 MF_K3_PER_FORWARD["merged"])
    launches = phase_serve(smi)
    frame_launches = phase_mf_serve(smi)
    emit("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": [
        {
            "name": "tome_flash_attention",
            "route": "cuda",
            "source": "vtm_torch/ops/csrc/flash_attention_fwd.cu",
            "replaces": "vtm/ops/flash_attention.py:269",
            "launches": launches,
            "max_abs_err": kernel["max_abs_err"],
            "ms": kernel["ms"],
            "plain_ms": kernel["plain_ms"],
        },
        {
            "name": "tome_frame_attention",
            "route": "cuda",
            "source": "vtm_torch/ops/csrc/frame_attention_fwd.cu",
            "replaces": "vtm/ops/flash_attention.py:915",
            "launches": frame_launches,
            "max_abs_err": frame_kernel["max_abs_err"],
            "ms": frame_kernel["ms"],
            "plain_ms": frame_kernel["plain_ms"],
        },
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
