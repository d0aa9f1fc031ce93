#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vtm_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths with random weights from a seed, in bf16 at
batch 8, merged and unmerged, through the entry points a user calls.
Serving (``vtm_torch.tools.model_benchmark.model_benchmark``):
  * VideoMAE ViT-B/16 at 16x224, merged with constant r=150 and no
    proportional attention (``MAIN_PATH_OPTS``: the values of
    configs/videomae/kinetics/tome_VideoMAE_B_16_224_K400.yaml);
  * Motionformer ViT-B/16 at 16x224 with trajectory attention, merged per
    pseudo-frame with r=18 and proportional attention
    (``MOTIONFORMER_OPTS``: the values of
    configs/motionformer/kinetics/tome_motionformer_224_16x4.yaml).
Evaluation (``vtm_torch.tools.test_net``), multi-view on the synthetic
dataset at the test batch of 32: the VideoMAE config above, and
Motionformer's EPIC-KITCHENS config below with its verb/noun heads.
Training (``vtm_torch.tools.train_net``), on the synthetic dataset with
fp32 parameters, bf16 compute and AdamW:
  * VideoMAE ViT-B/16 fine-tuning through the merge (``TRAIN_OPTS``: the
    values of configs/videomae/epickitchens/
    tome_train_VideoMAE_B_16_224_EPICKITCHENS.yaml);
  * Motionformer ViT-B/16 fine-tuning through the merge
    (``MF_TRAIN_OPTS``: the values of configs/motionformer/epickitchens/
    tome_motionformer_224_16x4.yaml).
TimeSformer and ViViT, the same way:
  * TimeSformer ViT-B/16 at 8x224 with divided space-time attention, merged
    per frame with r=18 and proportional attention: serving (``TS_OPTS``:
    configs/timesformer/kinetics/tome_TimeSformer_divST_8x32_224.yaml) and
    fine-tuning with SGD (``TS_TRAIN_OPTS``: configs/timesformer/
    epickitchens/tome_train_TimeSformer_divST_8_224.yaml);
  * ViViT ViT-B at 32x224 (3137 tokens), merged with r=300 and proportional
    attention: serving (``VIVIT_OPTS``: configs/vivit/kinetics/
    tome_vivit_8x32_224.yaml) and fine-tuning with SGD (``VIVIT_TRAIN_OPTS``:
    configs/vivit/epickitchens/tome_train_vivit_8x32_224.yaml).
The configs are ``get_cfg()`` plus those --opts lists (no yaml parser
needed).

Phases, each printing one JSON line:
  1. device    -- fails without CUDA; prints nvidia-smi's name and power limit
  2. build     -- compiles the kernels from vtm_torch/ops/csrc with nvcc
  3. kernel    -- the dense attention kernel (K1) against its plain version
                  at the serve, train and eval paths' shapes (the eval's at
                  the test batch of 32), its lse residual too; timed with and without the lse write,
                  and against attention_core's plain branch at the lengths
                  where the two meet (CROSSOVER_N); ptxas's registers and
                  spills of its kernels
     bwd_kernel -- its backward (K2) against its plain version, given the
                  residuals (out, lse) from K1 as a train step passes them,
                  and without them (the wrapper then runs K1 first); timed
                  given the residuals; the sha256 of its bits at two shapes
                  (K2_DIGEST_CASES), and of K1's, K3's and K5a's outputs
                  (kernel_times.FWD_DIGEST_CASES), printed to hold beside
                  an earlier reading (PERF.md)
     frame_kernel -- the per-frame attention kernel (K3) against its plain
                  version at the same paths' shapes
     frame_bwd_kernel -- its backward (K4) against its plain version, given
                  K3's residuals (out, and the lse of each row in each
                  frame) and without them; the same bits twice; timed given
                  the residuals
     blockdiag_kernel -- the block-diagonal attention kernel (K5a) against
                  its plain version at every frame length of the TimeSformer
                  path and at F = 7 (frames its packed tiles do not divide):
                  biased, unbiased and with the row mask; registers, spills
     blockdiag_bwd_kernel -- its backward (K5b) against its plain version,
                  given K5a's residuals and without them, at K5a's F = 7
                  cases too; the same bits twice; timed given the residuals
     Each is also timed against its plain version and against the one
     PyTorch call that computes the same function
     (scaled_dot_product_attention, its autograd backward for K2, K4 and
     K5b) by CUDA events in turns (the ``ms`` of the ``kernels`` line), and
     by its device time with the host's cost hidden (calls queued behind a
     kernel that holds the stream; ``device_ms`` there), beside the least
     time the card could take (``bound_ms``).
     ab_kernels -- the twelve A/B variants of K1 (T1-T12,
                  vtm_torch/ops/ab_attention.py), every mode against its
                  plain version by the entry point's own rule
                  (ab_dense.exp_kernels): fp32 at a small ragged shape, bf16
                  at B8 H12 d64 and the tools' token counts, timed the same
                  way, and by device time; the row sums T6 and T7 also at
                  key counts that end inside a tile
                  (ab_dense.Sizes.ragged_probes);
                  T5, T12, T8 full, T1, T9 and T10 in bf16 (K1's own
                  instances of the tile loop, T9 2d's staged bias) against
                  K1 on the same views, every output bit: T5 and T12 at N
                  1568, 200 and 37, T5 at B32, T8 full, T1 (both biases,
                  the five bisect variants), T9 (both modes) and T10 at n
                  1600, 200 and 37 (ab_dense.k1_bits);
                  registers and spills of ab_chain.cu (every variant in
                  bf16 on the tile loop; each kernel's blocks an SM by the
                  runtime's calculator), ab_dense_variants.cu (T4 and T11,
                  whose bf16 instances run K1's tile loop) and
                  ab_qk_probe.cu (T2, T3, T6 and T7 in bf16 on its wgmma
                  body at depth 64 and 128, four instances, each kernel's
                  blocks an SM by the runtime's calculator). The
                  four q k^T probes' bound is that of the function (one pass
                  over k and a narrow product), their n x n product's stands
                  beside it as ``product_bound_ms``; the packed forms' also
                  as ``issued_product_ms``, the product the kernel issues
                  with the zero halves counted (no bound on the function)
  4. blocks    -- teacher-forced VideoMAE ViT-B blocks, fp32: kernel path vs
                  plain path
     mf_blocks -- the same for Motionformer ViT-B blocks
     train_blocks -- loss and every parameter's gradient of the fp32 VideoMAE
                  ViT-B through K1 and K2 against the plain path
     mf_train_blocks -- the same for the fp32 Motionformer ViT-B through K3
                  and K4
     ts_blocks, ts_train_blocks -- the same two for the fp32 TimeSformer
                  ViT-B through K5a and K5b
     vivit_blocks, vivit_train_blocks -- the same two for the fp32 ViViT
                  ViT-B through the biased K1 and K2
  5. serve     -- VideoMAE model_benchmark merged and unmerged; launch counts,
                  token counts, finite logits, clips/s
     mf_serve  -- the same for Motionformer; probabilities sum to 1
     train     -- VideoMAE train steps merged and unmerged (AdamW 1e-4, wd
                  0.05, cross-entropy, one fixed synthetic batch): the loss
                  falls, K2 launches per step, a checkpoint reloads to the
                  same next loss, train clips/s; then ``train(cfg)`` itself
                  on the EPIC-KITCHENS config (twin heads, layer decay,
                  stochastic depth) for two short epochs
     mf_train  -- the same for Motionformer (K3 and K4 launches per step,
                  peak device memory; ``train(cfg)`` on its EPIC-KITCHENS
                  config with the twin heads)
     ts_serve, ts_train -- TimeSformer serving and train steps (SGD as
                  shipped), with K5a and K5b launches per forward and step
     vivit_serve, vivit_train -- ViViT serving and train steps, with the
                  biased K1 and K2 launches
     eval      -- the evaluation entry point (vtm_torch.tools.test_net.test)
                  on VideoMAE's Kinetics config, synthetic clips, 2 views x 3
                  crops at the test batch of 32 (EVAL_OPTS): every video's clip
                  count, its ensemble against the fp64 sum of a direct forward
                  of its clips, K1 launches per batch, finite stats, clips/s
                  by the meter's batch timer (data included) over every batch
                  and over all but the first
     mf_eval   -- the same for Motionformer's EPIC-KITCHENS config with its
                  verb/noun heads (EPICTestMeter), 1 view x 3 crops, K3
                  launches per batch
     ab_dense  -- the A/B entry point (vtm_torch.tools.ab_dense --exp all,
                  one repeat of three calls a row): every row checked
                  against its plain version as it is printed, all twelve
                  launched
Each serve, eval or train phase, and ab_dense, sets the kernels' launch counts to
0 just before it and reads them just after. Then a ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": ...}``. Any failure raises and the script exits
nonzero without the last line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import io
import json
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from vtm_torch.checkpoints import checkpoint as checkpoints
from vtm_torch.config import get_cfg
from vtm_torch.data import construct_loader
from vtm_torch.merge import MergePolicy, MergeState
from vtm_torch.merge import bipartite as merge_bipartite
from vtm_torch.models import build_model
from vtm_torch.models.common import _FLASH_MAX_SEQ, _FLASH_MIN_SEQ, split_heads
from vtm_torch.ops import build as kernel_build
from vtm_torch.ops import flash_attention
from vtm_torch.ops.flash_attention import (
    _backward_reference,
    _blockdiag_backward_reference,
    _blockdiag_reference,
    _frame_backward_reference,
    _frame_reference,
    _reference,
    tome_blockdiag_attention,
    tome_blockdiag_attention_backward,
    tome_flash_attention,
    tome_flash_attention_backward,
    tome_frame_attention,
    tome_frame_attention_backward,
)
from vtm_torch.ops import ab_attention
from vtm_torch.tools import ab_dense
from vtm_torch.tools.kernel_times import FWD_DIGEST_CASES, device_ms, forward_digests
from vtm_torch.tools import test_net
from vtm_torch.tools.model_benchmark import model_benchmark
from vtm_torch.tools.train_net import build_trainer, train
from vtm_torch.train.optimizer import set_lr
from vtm_torch.utils.benchmark import device_seconds
from vtm_torch.vis import concatenate_images, make_spatiotemporal_video_visualization

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

# configs/videomae/epickitchens/tome_train_VideoMAE_B_16_224_EPICKITCHENS.yaml,
# key by key, with the test-checkpoint placeholder replaced by "".
TRAIN_OPTS = [
    "TRAIN.AUTO_RESUME", "True",
    "TRAIN.BATCH_SIZE", "128",
    "TRAIN.CHECKPOINT_FILE_PATH", "<TRAIN-CHECKPOINT>",
    "TRAIN.CHECKPOINT_PERIOD", "5",
    "TRAIN.DATASET", "epickitchens",
    "TRAIN.ENABLE", "True",
    "TRAIN.EVAL_PERIOD", "5",
    "DATA.INPUT_CHANNEL_NUM", "[3]",
    "DATA.MEAN", "[0.485, 0.456, 0.406]",
    "DATA.NUM_FRAMES", "16",
    "DATA.PATH_PREFIX", "None",
    "DATA.PATH_TO_DATA_DIR", "None",
    "DATA.RANDOM_FLIP", "False",
    "DATA.SAMPLING_RATE", "2",
    "DATA.STD", "[0.229, 0.224, 0.225]",
    "DATA.TEST_CROP_SIZE", "224",
    "DATA.TRAIN_CROP_SIZE", "224",
    "DATA.TRAIN_JITTER_SCALES", "[256, 320]",
    "AUG.AA_TYPE", "rand-m7-n4-mstd0.5-inc1",
    "AUG.ENABLE", "True",
    "EPICKITCHENS.ANNOTATIONS_DIR", "<EPIC-KITCHENS-100-ANNOTATIONS>",
    "EPICKITCHENS.NUM_CLASSES", "[97, 300]",
    "EPICKITCHENS.PARTICIPANT_FIRST", "False",
    "EPICKITCHENS.TEST_LIST", "EPIC_100_validation.pkl",
    "EPICKITCHENS.TEST_SPLIT", "validation",
    "EPICKITCHENS.TRAIN_LIST", "EPIC_100_train.pkl",
    "EPICKITCHENS.TRAIN_PLUS_VAL", "False",
    "EPICKITCHENS.VAL_LIST", "EPIC_100_validation.pkl",
    "EPICKITCHENS.VISUAL_DATA_DIR", "<EPIC-KITCHENS-100-VIDEO>",
    "SOLVER.BASE_LR", "0.001",
    "SOLVER.COSINE_AFTER_WARMUP", "True",
    "SOLVER.COSINE_END_LR", "'2e-06'",  # PyYAML reads the yaml's 2e-06 as a string
    "SOLVER.LAYER_DECAY", "0.75",
    "SOLVER.LRS", "[]",
    "SOLVER.LR_POLICY", "cosine",
    "SOLVER.MAX_EPOCH", "50",
    "SOLVER.MOMENTUM", "0.9",
    "SOLVER.OPTIMIZING_METHOD", "adamw",
    "SOLVER.STEPS", "[]",
    "SOLVER.WARMUP_EPOCHS", "5.0",
    "SOLVER.WARMUP_START_LR", "0.0",
    "SOLVER.WEIGHT_DECAY", "0.05",
    "MODEL.ARCH", "videomae",
    "MODEL.LOSS_FUNC", "cross_entropy",
    "MODEL.MODEL_NAME", "VideoMAE",
    "MODEL.NUM_CLASSES", "400",
    "VIDEOMAE.ATTN_DROP_RATE", "0.0",
    "VIDEOMAE.DROP_PATH_RATE", "0.1",
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
    "TEST.BATCH_SIZE", "128",
    "TEST.CHECKPOINT_FILE_PATH", "",
    "TEST.DATASET", "epickitchens",
    "TEST.ENABLE", "True",
    "TEST.NUM_ENSEMBLE_VIEWS", "1",
    "TEST.NUM_SPATIAL_CROPS", "1",
    "DATA_LOADER.NUM_WORKERS", "12",
    "DATA_LOADER.PIN_MEMORY", "True",
    "TPU.COMPUTE_DTYPE", "bfloat16",
    "NUM_GPUS", "1",
    "NUM_SHARDS", "1",
    "RNG_SEED", "0",
    "OUTPUT_DIR", "<OUTPUT-DIR>",
]

# configs/motionformer/epickitchens/tome_motionformer_224_16x4.yaml, key by
# key, with the test-checkpoint placeholder replaced by "".
MF_TRAIN_OPTS = [
    "TRAIN.AUTO_RESUME", "True",
    "TRAIN.BATCH_SIZE", "32",
    "TRAIN.CHECKPOINT_EPOCH_RESET", "True",
    "TRAIN.CHECKPOINT_PERIOD", "5",
    "TRAIN.DATASET", "epickitchens",
    "TRAIN.ENABLE", "True",
    "TRAIN.EVAL_PERIOD", "5",
    "TRAIN.MIXED_PRECISION", "True",
    "DATA.INPUT_CHANNEL_NUM", "[3]",
    "DATA.MEAN", "[0.5, 0.5, 0.5]",
    "DATA.NUM_FRAMES", "16",
    "DATA.PATH_PREFIX", "None",
    "DATA.PATH_TO_DATA_DIR", "None",
    "DATA.SAMPLING_RATE", "4",
    "DATA.STD", "[0.5, 0.5, 0.5]",
    "DATA.TEST_CROP_SIZE", "224",
    "DATA.TRAIN_CROP_SIZE", "224",
    "DATA.TRAIN_JITTER_SCALES", "[256, 320]",
    "MIXUP.LABEL_SMOOTH_VALUE", "0.2",
    "EPICKITCHENS.ANNOTATIONS_DIR", "<EPIC-KITCHENS-100-ANNOTATIONS>",
    "EPICKITCHENS.NUM_CLASSES", "[97, 300]",
    "EPICKITCHENS.PARTICIPANT_FIRST", "False",
    "EPICKITCHENS.TEST_LIST", "EPIC_100_validation.pkl",
    "EPICKITCHENS.TEST_SPLIT", "validation",
    "EPICKITCHENS.TRAIN_LIST", "EPIC_100_train.pkl",
    "EPICKITCHENS.TRAIN_PLUS_VAL", "False",
    "EPICKITCHENS.VAL_LIST", "EPIC_100_validation.pkl",
    "EPICKITCHENS.VISUAL_DATA_DIR", "<EPIC-KITCHENS-100-VIDEO>",
    "SOLVER.BASE_LR", "0.0001",
    "SOLVER.LRS", "[1, 0.1, 0.01]",
    "SOLVER.LR_POLICY", "steps_with_relative_lrs",
    "SOLVER.MAX_EPOCH", "50",
    "SOLVER.MOMENTUM", "0.9",
    "SOLVER.OPTIMIZING_METHOD", "adamw",
    "SOLVER.STEPS", "[0, 30, 40]",
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
    "TEST.DATASET", "epickitchens",
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

# configs/timesformer/kinetics/tome_TimeSformer_divST_8x32_224.yaml, key by
# key, with the checkpoint placeholder replaced by "" (random weights).
TS_OPTS = [
    "TRAIN.AUTO_RESUME", "True",
    "TRAIN.BATCH_SIZE", "8",
    "TRAIN.CHECKPOINT_PERIOD", "5",
    "TRAIN.DATASET", "kinetics",
    "TRAIN.ENABLE", "True",
    "TRAIN.EVAL_PERIOD", "5",
    "DATA.INPUT_CHANNEL_NUM", "[3]",
    "DATA.NUM_FRAMES", "8",
    "DATA.PATH_PREFIX", "<KINETICS-400-PATH-PREFIX>",
    "DATA.PATH_TO_DATA_DIR", "<KINETICS-400-VIDEO>",
    "DATA.SAMPLING_RATE", "32",
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
    "MODEL.ARCH", "timesformer",
    "MODEL.DROPOUT_RATE", "0.5",
    "MODEL.LOSS_FUNC", "cross_entropy",
    "MODEL.MODEL_NAME", "TimeSformer",
    "MODEL.NUM_CLASSES", "400",
    "TIMESFORMER.ATTENTION_TYPE", "divided_space_time",
    "TOME.ENABLE", "True",
    "TOME.MODE", "merge",
    "TOME.PROP_ATTN", "True",
    "TOME.R_VALUE", "18",
    "TEST.BATCH_SIZE", "64",
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

# configs/timesformer/epickitchens/tome_train_TimeSformer_divST_8_224.yaml, key by
# key, with the test-checkpoint path replaced by "".
TS_TRAIN_OPTS = [
    "TRAIN.AUTO_RESUME", "True",
    "TRAIN.BATCH_SIZE", "128",
    "TRAIN.CHECKPOINT_FILE_PATH", "<TRAIN-CHECKPOINT>",
    "TRAIN.CHECKPOINT_PERIOD", "5",
    "TRAIN.DATASET", "epickitchens",
    "TRAIN.ENABLE", "True",
    "TRAIN.EVAL_PERIOD", "5",
    "DATA.INPUT_CHANNEL_NUM", "[3]",
    "DATA.NUM_FRAMES", "8",
    "DATA.PATH_PREFIX", "None",
    "DATA.PATH_TO_DATA_DIR", "None",
    "DATA.SAMPLING_RATE", "8",
    "DATA.TEST_CROP_SIZE", "224",
    "DATA.TRAIN_CROP_SIZE", "224",
    "DATA.TRAIN_JITTER_SCALES", "[256, 320]",
    "AUG.AA_TYPE", "rand-m15-n2-mstd0.5-inc1",
    "AUG.ENABLE", "True",
    "AUG.RE_PROB", "0.0",
    "EPICKITCHENS.ANNOTATIONS_DIR", "<EPIC-KITCHENS-100-ANNOTATIONS>",
    "EPICKITCHENS.NUM_CLASSES", "[97, 300]",
    "EPICKITCHENS.PARTICIPANT_FIRST", "False",
    "EPICKITCHENS.TEST_LIST", "EPIC_100_validation.pkl",
    "EPICKITCHENS.TEST_SPLIT", "validation",
    "EPICKITCHENS.TRAIN_LIST", "EPIC_100_train.pkl",
    "EPICKITCHENS.TRAIN_PLUS_VAL", "False",
    "EPICKITCHENS.VAL_LIST", "EPIC_100_validation.pkl",
    "EPICKITCHENS.VISUAL_DATA_DIR", "<EPIC-KITCHENS-100-VIDEO>",
    "SOLVER.BASE_LR", "0.005",
    "SOLVER.LRS", "[1, 0.1, 0.01]",
    "SOLVER.LR_POLICY", "steps_with_relative_lrs",
    "SOLVER.MAX_EPOCH", "15",
    "SOLVER.MOMENTUM", "0.9",
    "SOLVER.OPTIMIZING_METHOD", "sgd",
    "SOLVER.STEPS", "[0, 11, 14]",
    "SOLVER.WEIGHT_DECAY", "0.0001",
    "MODEL.ARCH", "timesformer",
    "MODEL.DROPOUT_RATE", "0.5",
    "MODEL.LOSS_FUNC", "cross_entropy",
    "MODEL.MODEL_NAME", "TimeSformer",
    "MODEL.NUM_CLASSES", "400",
    "TIMESFORMER.ATTENTION_TYPE", "divided_space_time",
    "TOME.ENABLE", "True",
    "TOME.MODE", "merge",
    "TOME.PROP_ATTN", "True",
    "TOME.R_VALUE", "18",
    "TEST.BATCH_SIZE", "128",
    "TEST.CHECKPOINT_FILE_PATH", "",
    "TEST.DATASET", "epickitchens",
    "TEST.ENABLE", "True",
    "TEST.NUM_ENSEMBLE_VIEWS", "1",
    "TEST.NUM_SPATIAL_CROPS", "1",
    "DATA_LOADER.NUM_WORKERS", "12",
    "DATA_LOADER.PIN_MEMORY", "True",
    "TPU.COMPUTE_DTYPE", "bfloat16",
    "NUM_GPUS", "1",
    "NUM_SHARDS", "1",
    "RNG_SEED", "0",
    "OUTPUT_DIR", "<OUTPUT-DIR>",
]

# configs/vivit/kinetics/tome_vivit_8x32_224.yaml, key by
# key, with the checkpoint placeholder replaced by "" (random weights).
VIVIT_OPTS = [
    "TRAIN.AUTO_RESUME", "True",
    "TRAIN.BATCH_SIZE", "8",
    "TRAIN.CHECKPOINT_PERIOD", "5",
    "TRAIN.DATASET", "kinetics",
    "TRAIN.ENABLE", "True",
    "TRAIN.EVAL_PERIOD", "5",
    "DATA.INPUT_CHANNEL_NUM", "[3]",
    "DATA.NUM_FRAMES", "32",
    "DATA.PATH_PREFIX", "<KINETICS-400-PATH-PREFIX>",
    "DATA.PATH_TO_DATA_DIR", "<KINETICS-400-VIDEO>",
    "DATA.SAMPLING_RATE", "2",
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
    "MODEL.ARCH", "vivit",
    "MODEL.LOSS_FUNC", "cross_entropy",
    "MODEL.MODEL_NAME", "ViViT",
    "MODEL.NUM_CLASSES", "400",
    "VIVIT.CONFIG_PATH", "configs/vivit/kinetics/tome_vivit_8x32_224.json",
    "TOME.ENABLE", "True",
    "TOME.MODE", "merge",
    "TOME.PROP_ATTN", "True",
    "TOME.R_VALUE", "300",
    "TEST.BATCH_SIZE", "16",
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

# configs/vivit/epickitchens/tome_train_vivit_8x32_224.yaml, key by
# key, with the test-checkpoint placeholder replaced by "".
VIVIT_TRAIN_OPTS = [
    "TRAIN.AUTO_RESUME", "True",
    "TRAIN.BATCH_SIZE", "64",
    "TRAIN.CHECKPOINT_FILE_PATH", "<TRAIN-CHECKPOINT>",
    "TRAIN.CHECKPOINT_PERIOD", "5",
    "TRAIN.DATASET", "epickitchens",
    "TRAIN.ENABLE", "True",
    "TRAIN.EVAL_PERIOD", "5",
    "DATA.INPUT_CHANNEL_NUM", "[3]",
    "DATA.NUM_FRAMES", "32",
    "DATA.PATH_PREFIX", "None",
    "DATA.PATH_TO_DATA_DIR", "None",
    "DATA.SAMPLING_RATE", "2",
    "DATA.TEST_CROP_SIZE", "224",
    "DATA.TRAIN_CROP_SIZE", "224",
    "DATA.TRAIN_JITTER_SCALES", "[256, 320]",
    "EPICKITCHENS.ANNOTATIONS_DIR", "<EPIC-KITCHENS-100-ANNOTATIONS>",
    "EPICKITCHENS.NUM_CLASSES", "[97, 300]",
    "EPICKITCHENS.PARTICIPANT_FIRST", "False",
    "EPICKITCHENS.TEST_LIST", "EPIC_100_validation.pkl",
    "EPICKITCHENS.TEST_SPLIT", "validation",
    "EPICKITCHENS.TRAIN_LIST", "EPIC_100_train.pkl",
    "EPICKITCHENS.TRAIN_PLUS_VAL", "False",
    "EPICKITCHENS.VAL_LIST", "EPIC_100_validation.pkl",
    "EPICKITCHENS.VISUAL_DATA_DIR", "<EPIC-KITCHENS-100-VIDEO>",
    "SOLVER.BASE_LR", "0.003125",
    "SOLVER.COSINE_AFTER_WARMUP", "True",
    "SOLVER.LRS", "[]",
    "SOLVER.LR_POLICY", "cosine",
    "SOLVER.MAX_EPOCH", "15",
    "SOLVER.MOMENTUM", "0.9",
    "SOLVER.OPTIMIZING_METHOD", "sgd",
    "SOLVER.STEPS", "[]",
    "SOLVER.WARMUP_EPOCHS", "2.5",
    "SOLVER.WARMUP_START_LR", "0.0",
    "SOLVER.WEIGHT_DECAY", "0.0001",
    "MODEL.ARCH", "vivit",
    "MODEL.LOSS_FUNC", "cross_entropy",
    "MODEL.MODEL_NAME", "ViViT",
    "MODEL.NUM_CLASSES", "400",
    "VIVIT.CONFIG_PATH", "configs/vivit/epickitchens/tome_vivit_8x32_224.json",
    "TOME.ENABLE", "True",
    "TOME.MODE", "merge",
    "TOME.PROP_ATTN", "True",
    "TOME.R_VALUE", "300",
    "TEST.BATCH_SIZE", "64",
    "TEST.CHECKPOINT_FILE_PATH", "",
    "TEST.DATASET", "epickitchens",
    "TEST.ENABLE", "True",
    "TEST.NUM_ENSEMBLE_VIEWS", "1",
    "TEST.NUM_SPATIAL_CROPS", "1",
    "DATA_LOADER.NUM_WORKERS", "12",
    "DATA_LOADER.PIN_MEMORY", "True",
    "TPU.COMPUTE_DTYPE", "bfloat16",
    "NUM_GPUS", "1",
    "NUM_SHARDS", "1",
    "RNG_SEED", "0",
    "OUTPUT_DIR", "<OUTPUT-DIR>",
]

# What every training run here changes in that config: no files (random
# weights, the synthetic dataset's 16 clips), batch 8, output under build/.
TRAIN_OUT = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_train"
TRAIN_RUN_OPTS = [
    "SOLVER.COSINE_END_LR", "2e-06",  # as a number: the cosine schedule compares it
    "TRAIN.CHECKPOINT_FILE_PATH", "",
    "TRAIN.DATASET", "synthetic",
    "TRAIN.BATCH_SIZE", "8",
    "DATA_LOADER.NUM_WORKERS", "4",
]
# The step that is timed: one head of 400 classes, AdamW at a constant 1e-4
# with weight decay 0.05, no layer decay, no stochastic depth.
TRAIN_STEP_OPTS = TRAIN_RUN_OPTS + [
    "EPICKITCHENS.NUM_CLASSES", "None",
    "SOLVER.BASE_LR", "0.0001",
    "SOLVER.LR_POLICY", "steps_with_relative_lrs",
    "SOLVER.LRS", "[1]",
    "SOLVER.STEPS", "[0]",
    "SOLVER.WARMUP_EPOCHS", "0.0",
    "SOLVER.LAYER_DECAY", "1.0",
    "VIDEOMAE.DROP_PATH_RATE", "0.0",
]
# The entry point's own run: the config as shipped (twin heads, layer decay
# 0.75, stochastic depth 0.1, cosine schedule) cut to two epochs of two
# steps, one of them warm-up.
TRAIN_ENTRY_OPTS = TRAIN_RUN_OPTS + [
    "SOLVER.MAX_EPOCH", "2",
    "SOLVER.WARMUP_EPOCHS", "1.0",
    "TRAIN.CHECKPOINT_PERIOD", "2",
    "TRAIN.EVAL_PERIOD", "2",
]
# The same three for Motionformer: the config's AdamW is already 1e-4 with
# weight decay 0.05, and it has no layer decay or stochastic depth.
MF_TRAIN_RUN_OPTS = ["TRAIN.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "8"]
MF_TRAIN_STEP_OPTS = MF_TRAIN_RUN_OPTS + [
    "EPICKITCHENS.NUM_CLASSES", "None",
    "SOLVER.LRS", "[1]",
    "SOLVER.STEPS", "[0]",
]
MF_TRAIN_ENTRY_OPTS = MF_TRAIN_RUN_OPTS + [
    "SOLVER.MAX_EPOCH", "2",
    "TRAIN.CHECKPOINT_PERIOD", "2",
    "TRAIN.EVAL_PERIOD", "2",
]
# TimeSformer and ViViT: the configs' SGD (momentum 0.9, weight decay 1e-4)
# at their base learning rate, constant; ViViT's cosine schedule with its
# warm-up from 0 becomes one warm-up epoch and one cosine epoch in the
# entry-point run.
TS_TRAIN_RUN_OPTS = ["TRAIN.CHECKPOINT_FILE_PATH", "", "TRAIN.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "8",
                     "DATA_LOADER.NUM_WORKERS", "4"]
TS_TRAIN_STEP_OPTS = TS_TRAIN_RUN_OPTS + [
    "EPICKITCHENS.NUM_CLASSES", "None",
    "SOLVER.LRS", "[1]",
    "SOLVER.STEPS", "[0]",
]
TS_TRAIN_ENTRY_OPTS = TS_TRAIN_RUN_OPTS + [
    "SOLVER.MAX_EPOCH", "2",
    "TRAIN.CHECKPOINT_PERIOD", "2",
    "TRAIN.EVAL_PERIOD", "2",
]
VIVIT_TRAIN_STEP_OPTS = TS_TRAIN_RUN_OPTS + [
    "EPICKITCHENS.NUM_CLASSES", "None",
    "SOLVER.LR_POLICY", "steps_with_relative_lrs",
    "SOLVER.LRS", "[1]",
    "SOLVER.STEPS", "[0]",
    "SOLVER.WARMUP_EPOCHS", "0.0",
]
VIVIT_TRAIN_ENTRY_OPTS = TS_TRAIN_RUN_OPTS + [
    "SOLVER.MAX_EPOCH", "2",
    "SOLVER.WARMUP_EPOCHS", "1.0",
    "TRAIN.CHECKPOINT_PERIOD", "2",
    "TRAIN.EVAL_PERIOD", "2",
]
# the first steps still grow the allocator's pools (every merged layer has
# its own shapes), so the warm-up is longer than the serve phases'
TRAIN_WARMUP, TRAIN_ITERS = 4, 8
VIVIT_TRAIN_WARMUP, VIVIT_TRAIN_ITERS = 2, 4  # a ViViT step is several times as long

# Tokens entering each of the 12 layers at r=150, and the final count.
MERGED_COUNTS = (1568, 1418, 1268, 1118, 968, 818, 668, 518, 368, 218, 109, 55, 28)
MERGED_K1_PER_FORWARD = 9  # K1 runs for N >= 256: layers 0-8
# K1 at the serve and train paths' B8 shapes, a small odd case, and the eval
# path's: every length K1 takes at the test batch of 32 (layers 0-8)
KERNEL_SHAPES = [(8, 12, n, 64) for n in (1568, 1418, 368, 256, 3137, 437)] + [(2, 2, 37, 16)] + [
    (32, 12, n, 64) for n in MERGED_COUNTS[:MERGED_K1_PER_FORWARD]]
# ... and the duplication path's lengths at its batch of 8 (the dup phase)
KERNEL_SHAPES += [(8, 12, n, 64) for n in (1437, 1306, 1175, 1044, 913, 782, 651, 520, 389, 258)]
TIMED = ((1568, False), (368, False), (3137, True))  # (N, biased): VideoMAE's layers 0 and 8, ViViT's layer 0
# K1 against attention_core's plain branch where the two meet: VideoMAE's
# layers 8-10 (368, 218, 109), ViViT's layer 9 (437), and the 256-token
# threshold itself; measured, not acted on (models/common.py keeps 256)
CROSSOVER_N = (109, 218, 256, 368, 437)
# K2 at the training paths' shapes (VideoMAE's layers 0, 1 and 8; ViViT's
# layers 0 and 9), the shortest row it takes, a small odd one, and rows
# shorter than one tile at d = 64; without the residuals at the smaller
BWD_SHAPES = [(8, 12, n, 64) for n in (1568, 1418, 368, 257, 3137, 437)] + [(2, 3, 296, 16), (2, 3, 37, 64)]
BWD_SHAPES_NO_RESIDUALS = [(8, 12, n, 64) for n in (368, 257)] + [(2, 3, 296, 16)]
# K2's bits: the sha256 of dq, dk, dv and dbias given K1's residuals, bf16
# B2 H12 d64, at numpy-seeded inputs (N, biased). Printed, not checked: a
# compiler or a change of the loop may move the bits of a correct kernel
K2_DIGEST_CASES = ((1568, False), (437, True))
# K1's lse against its plain version's: fp32 sums of the same logits in
# another order, within this much of max(1, the largest |lse|)
LSE_TOL = 1e-4
FP32_TOL = 1e-4
BF16_FLOOR = 1e-2
BLOCK_TOL = 1e-4
GRAD_TOL = 1e-4  # of the largest entry of each gradient tensor
SERVE_WARMUP, SERVE_ITERS = 2, 10
# Published peaks of one H100 SXM (NVIDIA's data sheet): dense bf16 tensor
# cores, and device memory.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
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
# s=441 (the 336 crop) at B1; odd H and a small d at s=37; and the eval
# path's: every length K3 takes at the test batch of 32 (layers 0-9)
FRAME_SHAPES = [(8, 12, n, 64) for n in (1568, 1424, 272)] + [(1, 12, 3528, 64), (2, 3, 296, 16)] + [
    (32, 12, n, 64) for n in MF_BODY_COUNTS[:MF_K3_PER_FORWARD["merged"]]]
FRAME_TIMED = ((1568, False), (848, True))  # (N', biased): layer 0, and a merged layer
# K4 at the training path's shapes (s = 196, 178, 106, 34), the 336 crop's
# s=441, and the odd-head ragged case
FRAME_BWD_SHAPES = [(8, 12, n, 64) for n in (1568, 1424, 848, 272)] + [(1, 12, 3528, 64), (2, 3, 296, 16)]
FRAME_BWD_SHAPES_NO_RESIDUALS = [(8, 12, 272, 64), (2, 3, 296, 16)]
COUNTERS = ("LAUNCHES", "BWD_LAUNCHES", "FRAME_LAUNCHES", "FRAME_BWD_LAUNCHES",
            "BLOCKDIAG_LAUNCHES", "BLOCKDIAG_BWD_LAUNCHES")
PROB_SUM_TOL = 1e-3
# Unmerged / merged GFLOP per clip, 573.8 / 260.1, from XLA's cost analysis
# (BENCH_FAMILIES.json): the ratio's device-independent ceiling.
MF_FLOP_CEILING = 573.8 / 260.1

# TimeSformer: 8 frames of 196 patches plus the broadcast CLS. Patches per
# frame entering each layer at r=18, and the final count; K5a runs in every
# layer at every length, merged and unmerged.
TS_FRAMES = 8
TS_PATCH_COUNTS = (196, 178, 160, 142, 124, 106, 88, 70, 52, 34, 17, 9, 5)
TS_K5_PER_FORWARD = {"merged": 12, "unmerged": 12}
# K5a and K5b at (B, H, F, s, d): the path's frame lengths s = patches + 1,
# one long frame (the 448 crop's s = 785) and a narrow odd case
BLOCKDIAG_SHAPES = [(8, 12, TS_FRAMES, s_, 64) for s_ in (197, 179, 125, 35, 18, 10)] + [
    (1, 12, 2, 785, 64), (2, 3, 4, 37, 16)]
# K5a at every frame length of the TimeSformer path (layers 0-11), and
# F = 7 at s = 10 and 18, which the packed tiles (6 and 3 frames) do not
# divide
TS_FRAME_LENS = tuple(c + 1 for c in TS_PATCH_COUNTS[:12])
BLOCKDIAG_FWD_SHAPES = [(8, 12, TS_FRAMES, s_, 64) for s_ in TS_FRAME_LENS] + [
    (8, 12, 7, 10, 64), (8, 12, 7, 18, 64)] + BLOCKDIAG_SHAPES[-2:]
# K5b at the same shapes and K5a's F = 7 cases (s 10 and 18 packed, the
# clip's last block holding fewer frames); without the residuals at two
BLOCKDIAG_BWD_SHAPES = BLOCKDIAG_SHAPES + [(8, 12, 7, 10, 64), (8, 12, 7, 18, 64)]
BLOCKDIAG_BWD_SHAPES_NO_RESIDUALS = [(8, 12, TS_FRAMES, 35, 64), (8, 12, 7, 10, 64)]
BLOCKDIAG_MODES = ((False, False), (True, False), (True, True))  # (biased, exclude_first_row)
# (s, biased, exclude_first_row): layer 0, and merged layers 5, 9, 10 and 11
# (s 18 and 10: 3 and 6 frames packed a block)
BLOCKDIAG_TIMED = ((197, False, False), (107, True, True), (35, True, True), (18, True, True), (10, True, True))
BLOCKDIAG_FP32_TOL = 1e-5  # of the largest entry
# Unmerged / merged GFLOP per clip, 397.1 / 183.4, from XLA's cost analysis
# (BENCH_FAMILIES.json): the ratio's device-independent ceiling.
TS_FLOP_CEILING = 397.1 / 183.4
# The k third of a fused qkv bias shifts a whole row of logits, which a
# softmax does not see: its gradient is zero analytically (spatial and
# temporal attention alike).
TS_ZERO_GRADIENTS = (("attn.qkv.bias", slice(768, 1536)),)

# ViViT: 16 x 14 x 14 tubelets plus the protected CLS token. Tokens entering
# each layer at r=300 (r is capped at half the unprotected tokens from layer
# 9 on), and the final count; the biased K1 runs for N >= 256: layers 0-9.
VIVIT_COUNTS = (3137, 2837, 2537, 2237, 1937, 1637, 1337, 1037, 737, 437, 219, 110, 56)
VIVIT_K1_PER_FORWARD = {"merged": 10, "unmerged": 12}
# Unmerged / merged GFLOP per clip, 910.6 / 364.6 (BENCH_FAMILIES.json).
VIVIT_FLOP_CEILING = 910.6 / 364.6
# The key projection's bias shifts a whole row of logits, which a softmax
# does not see: its gradient is zero analytically.
VIVIT_ZERO_GRADIENTS = ("attention.key.bias",)
# ViViT's three projections are what the other families fuse into one qkv.
# With random weights the attention is nearly uniform, so the query and key
# gradients are orders of magnitude below the value's, and the fp32 rounding
# they carry on either path is large against their own size (reported by
# the phase) and small against the fused tensor's.
VIVIT_GRAD_GROUPS = (("attention.query.", "attention.key.", "attention.value."),)

# The evaluation entry point (test_net.test) on the synthetic dataset at the
# shipped test batch of 32, each phase with an OUTPUT_DIR of its own that
# holds no checkpoint (so the weights are the seeded init): VideoMAE's
# Kinetics config at 2 views x 3 crops (32 videos, 192 clips, 6 batches),
# Motionformer's EPIC-KITCHENS config with its verb/noun heads at 1 view x 3
# crops (96 clips, 3 batches).
EVAL_OUT = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_eval"
EVAL_OPTS = ["TEST.DATASET", "synthetic", "TEST.NUM_ENSEMBLE_VIEWS", "2", "TEST.NUM_SPATIAL_CROPS", "3"]
MF_EVAL_OPTS = ["TEST.DATASET", "synthetic", "TEST.NUM_ENSEMBLE_VIEWS", "1", "TEST.NUM_SPATIAL_CROPS", "3"]
EVAL_VIDEOS = 32
# Each video's ensemble against the fp64 sum of the same clips' outputs from
# a second build of the same weights, forwarded in the same batches: equal
# unless a library call picks another algorithm for the second build
EVAL_SUM_TOL = 1e-3


# The merge variants at the configs' own r (experiments.sh's rows): a drop or
# a hybrid group leaves as many tokens as a merge, so each kernel's launches a
# forward are the merge mode's. ViViT hybrid at THRESHOLD 0.4
# (experiments.sh:360), VideoMAE's at 0.8 (:363), each test_net pass over 8
# synthetic videos of 1 view x 1 crop.
VARIANTS_OUT = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_variants"
VARIANT_EVAL_OPTS = ["TEST.DATASET", "synthetic", "TEST.NUM_ENSEMBLE_VIEWS", "1", "TEST.NUM_SPATIAL_CROPS", "1",
                     "TEST.BATCH_SIZE", "8"]
VIVIT_HYBRID_THRESHOLD, VIDEOMAE_HYBRID_THRESHOLD = 0.4, 0.8
# Layer duplication (examples/layer_duplication_example.py:7-8): VideoMAE's
# block 0 run 12 times at R 131 (11 metric-only steps, then the full block),
# blocks 1-11 unmerged. The tokens entering each of the 23 steps follow from
# the policy, and K1 runs at each step whose row length attention_core sends
# to it.
DUP_OPTS = ("TOME.LAYER_TO_DUPLICATE", "0", "TOME.LAYER_QUANTITY", "12", "TOME.R_VALUE", "131")
DUP_COUNTS = MergePolicy(rs=(131,) * 12 + (0,) * 11, mode="merge").token_counts(1568)
DUP_K1_PER_FORWARD = sum(_FLASH_MIN_SEQ <= n <= _FLASH_MAX_SEQ for n in DUP_COUNTS[:-1])


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cfg_maker(base_opts):
    """A function of further --opts that returns ``get_cfg()`` with
    ``base_opts`` and then those merged in."""
    def make(*opts):
        cfg = get_cfg()
        cfg.merge_from_list(base_opts + list(opts))
        return cfg
    return make


main_cfg, train_cfg = cfg_maker(MAIN_PATH_OPTS), cfg_maker(TRAIN_OPTS)
mf_cfg, mf_train_cfg = cfg_maker(MOTIONFORMER_OPTS), cfg_maker(MF_TRAIN_OPTS)
ts_cfg, ts_train_cfg = cfg_maker(TS_OPTS), cfg_maker(TS_TRAIN_OPTS)
vivit_cfg, vivit_train_cfg = cfg_maker(VIVIT_OPTS), cfg_maker(VIVIT_TRAIN_OPTS)


def launch_counts() -> dict:
    """The six kernels' launch counts."""
    return {c: getattr(flash_attention, c) for c in COUNTERS}


def zero_launch_counts() -> None:
    for c in COUNTERS:
        setattr(flash_attention, c, 0)
    for name in ab_attention.AB_LAUNCHES:
        ab_attention.AB_LAUNCHES[name] = 0


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


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over the bf16 tensor-core peak and the bytes (each input read once,
    each output written once) over the device-memory rate."""
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms), bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def in_turns(kernel, plain, library) -> dict:
    """ms per call by CUDA events, taken in turns: plain, kernel, library,
    kernel, plain; then the kernel's device time (``kernel_device_ms``: 20
    calls queued behind a kernel that holds the stream, so the host's cost
    of a call, which the events include, is hidden; at K5a's short frames
    the events read the host's launch rate)."""
    p1, k1, lib, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(library), cuda_ms(kernel), cuda_ms(plain)
    return dict(kernel_ms=(k1 + k2) / 2, kernel_device_ms=device_ms(kernel, 20), plain_ms=(p1 + p2) / 2,
                library_ms=lib)


def timed_inputs(gen, n: int, biased: bool):
    """B8 H12 d64 bf16 q, k, v as split_heads views of a fused projection,
    and the key bias."""
    q, k, v = heads(torch.randn((8, n, 3 * 768), generator=gen, device="cuda").to(torch.bfloat16), 12)
    bias = torch.log(torch.rand((8, n), generator=gen, device="cuda") * 4 + 1) if biased else None
    return q, k, v, bias


def sdpa_bias(bias):
    return None if bias is None else bias[:, None, None, :].to(torch.bfloat16)


def dense_sdpa(q, k, v, bias):
    """The one PyTorch call that computes K1: the yardstick, never on a
    model's path."""
    q, k, v = (t.contiguous() for t in (q, k, v))
    mask = sdpa_bias(bias)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=0.125)


def frame_sdpa_operands(q, k, v, bias):
    """K3's operands for one scaled_dot_product_attention call: the frames
    become a batch dim, q repeated for each of them ([B*F, H, N, d] against
    [B*F, H, s, d])."""
    b, h, n, d = q.shape
    s_ = n // MF_FRAMES
    qf = q[:, None].expand(b, MF_FRAMES, h, n, d).reshape(b * MF_FRAMES, h, n, d)
    kf, vf = (t.reshape(b, h, MF_FRAMES, s_, d).transpose(1, 2).reshape(b * MF_FRAMES, h, s_, d)
              for t in (k, v))
    mask = None if bias is None else bias.reshape(b * MF_FRAMES, 1, 1, s_).to(torch.bfloat16)
    return qf, kf, vf, mask


def frame_sdpa(q, k, v, bias):
    """K3 as one scaled_dot_product_attention call; the output comes
    frame-major, not token-major."""
    qf, kf, vf, mask = frame_sdpa_operands(q, k, v, bias)
    return lambda: F.scaled_dot_product_attention(qf, kf, vf, attn_mask=mask, scale=0.125)


def time_against_plain(kernel, plain, library, cases, out_factor: int) -> dict:
    """ms per call at B8 H12 d64 bf16 for each (N, biased) case: the kernel,
    its plain version and the library call, with the kernel's bound
    (4 B H N^2 d operations; q, k, v read and an ``out_factor`` times
    larger output written, plus the bias)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    times = {}
    for n, biased in cases:
        q, k, v, bias = timed_inputs(gen, n, biased)
        with torch.inference_mode():
            t = in_turns(lambda: kernel(q, k, v, bias, 0.125), lambda: plain(q, k, v, bias, 0.125),
                         library(q, k, v, bias))
        flops = 4 * 8 * 12 * n * n * 64
        nbytes = (3 + out_factor) * 8 * 12 * n * 64 * 2 + (8 * n * 4 if biased else 0)
        times[str(n)] = dict(biased=biased, **t, kernel_tflops=flops / t["kernel_ms"] / 1e9,
                             **bound(flops, nbytes))
    return times


def phase_kernel(phase: str, smi: str, kernel, plain, library, shapes, timed, out_factor: int) -> dict:
    """A kernel against its plain version at its path's shapes; returns
    the largest difference and the times of the first timed case."""
    rows, worst_vs_plain = check_against_plain(kernel, plain, shapes)
    times = time_against_plain(kernel, plain, library, timed, out_factor)
    emit(phase, checks=rows, max_abs_err_vs_plain=worst_vs_plain, timing_bf16_B8_H12_d64=times,
         nvidia_smi=smi)
    first = times[str(timed[0][0])]
    return dict(max_abs_err=worst_vs_plain, ms=first["kernel_ms"], device_ms=first["kernel_device_ms"],
                plain_ms=first["plain_ms"],
                bound_ms=first["bound_ms"], bound_by=first["bound_by"], library_ms=first["library_ms"])


def check_lse(shapes):
    """K1's lse residual against its plain version's, biased and unbiased,
    fp32 and bf16, on the strided views the model hands over."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = 0.0
    for b, h, n, d in shapes:
        for biased in (False, True):
            bias = torch.log(torch.rand((b, n), generator=gen, device="cuda") * 4 + 1) if biased else None
            fused = torch.randn((b, n + 1, 3 * h * d), generator=gen, device="cuda")
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = heads(fused.to(dtype)[:, 1:], h)
                _, lse = flash_attention._forward(q, k, v, bias, d ** -0.5, want_lse=True)
                _, want = _reference(q, k, v, bias, d ** -0.5, want_lse=True)
                err = (lse - want).abs().max().item() / max(1.0, want.abs().max().item())
                check(err <= LSE_TOL, f"K1 lse err {err} > {LSE_TOL} at {(b, h, n, d)} {dtype} bias={biased}")
                worst = max(worst, err)
    torch.cuda.synchronize()
    return worst


def crossover(gen) -> dict:
    """K1 against attention_core's plain branch (``_reference``) at
    CROSSOVER_N, unbiased and biased, in turns: plain, kernel, kernel,
    plain."""
    out = {}
    for n in CROSSOVER_N:
        for biased in (False, True):
            q, k, v, bias = timed_inputs(gen, n, biased)
            with torch.inference_mode():
                kernel_call = lambda: tome_flash_attention(q, k, v, bias, 0.125)
                plain_call = lambda: _reference(q, k, v, bias, 0.125)
                p1, k1, k2, p2 = (cuda_ms(f) for f in (plain_call, kernel_call, kernel_call, plain_call))
            out[f"{n}{'_biased' if biased else ''}"] = dict(kernel_ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2)
    return out


def phase_dense_kernel(smi: str) -> dict:
    """K1 against its plain version, its lse residual, and its time with and
    without the lse write (serving writes none, a train step's forward
    does), taken in turns: without, with, with, without."""
    rows, worst_vs_plain = check_against_plain(tome_flash_attention, _reference, KERNEL_SHAPES)
    lse_err = check_lse(KERNEL_SHAPES)
    times = time_against_plain(tome_flash_attention, _reference, dense_sdpa, TIMED, out_factor=1)
    gen = torch.Generator(device="cuda").manual_seed(12)
    for n, biased in TIMED:
        q, k, v, bias = timed_inputs(gen, n, biased)
        with torch.inference_mode():
            plain_call = lambda: flash_attention._forward(q, k, v, bias, 0.125)
            lse_call = lambda: flash_attention._forward(q, k, v, bias, 0.125, want_lse=True)
            w1, l1, l2, w2 = cuda_ms(plain_call), cuda_ms(lse_call), cuda_ms(lse_call), cuda_ms(plain_call)
        times[str(n)].update(without_lse_ms=(w1 + w2) / 2, with_lse_ms=(l1 + l2) / 2)
    emit("kernel", checks=rows, max_abs_err_vs_plain=worst_vs_plain, lse_rel_err=lse_err,
         timing_bf16_B8_H12_d64=times, crossover_bf16_B8_H12_d64=crossover(gen),
         resources=kernel_build.kernel_resources("flash_attention_fwd.cu"), nvidia_smi=smi)
    first = times[str(TIMED[0][0])]
    return dict(max_abs_err=worst_vs_plain, ms=first["kernel_ms"], device_ms=first["kernel_device_ms"],
                plain_ms=first["plain_ms"],
                bound_ms=first["bound_ms"], bound_by=first["bound_by"], library_ms=first["library_ms"])


def grad_errors(got, want):
    """Per gradient (dq, dk, dv, dbias): the largest difference, absolute
    and relative to the largest entry of ``want``."""
    out = {}
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is not None:
            err = (a.float() - w.float()).abs().max().item()
            out[name] = (err, err / w.float().abs().max().item())
    return out


def check_backward_against_plain(name, backward, plain, shapes, make_do, seed: int):
    """A backward kernel against its plain version, each called as
    f(q, k, v, key_bias, do, scale): biased and unbiased, fp32 and bf16, on
    split_heads views offset by one row with a strided ``do`` from
    ``make_do(gen, b, h, n, d)``. fp32 gradients must agree within FP32_TOL
    of their largest entry; bf16 gradients must stay within bf16_tol of an
    fp32 computation, relative to the largest entry. The kernel must give
    the same bits twice, dbias too. Returns (rows, largest absolute
    difference from the plain version)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows, worst_abs = [], 0.0
    for b, h, n, d in shapes:
        scale = d ** -0.5
        for biased in (False, True):
            bias = torch.log(torch.rand((b, n), generator=gen, device="cuda") * 4 + 1) if biased else None
            fused = torch.randn((b, n + 1, 3 * h * d), generator=gen, device="cuda")
            do32 = make_do(gen, b, h, n, d)
            q32, k32, v32 = heads(fused[:, 1:], h)
            check(not do32.is_contiguous() and not q32.is_contiguous(), "inputs are strided views")
            got32 = backward(q32, k32, v32, bias, do32, scale)
            err32 = grad_errors(got32, plain(q32, k32, v32, bias, do32, scale))
            check(len(err32) == (4 if biased else 3), "dbias comes with a bias and only then")
            for g, (_, rel) in err32.items():
                check(rel <= FP32_TOL, f"{name} fp32 {g} err {rel} > {FP32_TOL} at {(b, h, n, d)} bias={biased}")
            q, k, v = heads(fused.to(torch.bfloat16)[:, 1:], h)
            do = do32.to(torch.bfloat16)  # dense and permuted: keeps its strides
            check(do.stride() == do32.stride(), "the bf16 do is the same strided view")
            got = backward(q, k, v, bias, do, scale)
            again = backward(q, k, v, bias, do, scale)
            check(all(torch.equal(x, y) for x, y in zip(got, again) if x is not None),
                  f"{name} differs from run to run")
            ref = plain(q.float(), k.float(), v.float(), bias, do.float(), scale)
            base = plain(q, k, v, bias, do, scale)
            err_k, err_p = grad_errors(got, ref), grad_errors(base, ref)
            for g in err_k:
                tol = bf16_tol(err_p[g][1])
                check(err_k[g][1] <= tol,
                      f"{name} bf16 {g} err {err_k[g][1]} > {tol} at {(b, h, n, d)} bias={biased}")
            vs_plain = grad_errors(got, base)
            worst_abs = max([worst_abs] + [e for e, _ in vs_plain.values()] + [e for e, _ in err32.values()])
            rows.append(dict(shape=[b, h, n, d], biased=biased,
                             fp32_rel_err={k_: r for k_, (_, r) in err32.items()},
                             bf16_rel_err={k_: r for k_, (_, r) in err_k.items()},
                             bf16_plain_rel_err={k_: r for k_, (_, r) in err_p.items()}))
    torch.cuda.synchronize()
    return rows, worst_abs


def emit_backward(phase: str, smi: str, rows, worst_abs: float, times: dict, first: str = "1568") -> dict:
    emit(phase, checks=rows, max_abs_err_vs_plain=worst_abs, timing_bf16_B8_H12_d64=times, nvidia_smi=smi)
    first = times[first]
    return dict(max_abs_err=worst_abs, ms=first["kernel_ms"], device_ms=first["kernel_device_ms"],
                plain_ms=first["plain_ms"],
                bound_ms=first["bound_ms"], bound_by=first["bound_by"], library_ms=first["library_ms"])


def k2_given_residuals(q, k, v, bias, do, scale, need_dbias=True):
    """K2 as a train step runs it: K1 writes (out, lse), then the backward
    takes them."""
    out, lse = flash_attention._forward(q, k, v, bias, scale, want_lse=True)
    return tome_flash_attention_backward(q, k, v, bias, do, scale, need_dbias, out=out, lse=lse)


def k4_given_residuals(q, k, v, bias, do, scale, need_dbias=True):
    """K4 as a train step runs it: K3 writes (out, lse), then the backward
    takes them."""
    out, lse = flash_attention._frame_forward(q, k, v, bias, scale, MF_FRAMES, want_lse=True)
    return tome_frame_attention_backward(q, k, v, bias, do, scale, MF_FRAMES, need_dbias, out=out, lse=lse)


def k5b_given_residuals(q, k, v, bias, do, scale, frames, masked, need_dbias=True):
    """K5b as a train step runs it: K5a writes (out, lse), then the
    backward takes them."""
    out, lse = flash_attention._blockdiag_forward(q, k, v, bias, scale, frames, masked, want_lse=True)
    return tome_blockdiag_attention_backward(q, k, v, bias, do, scale, frames, masked, need_dbias,
                                             out=out, lse=lse)


def k2_digest() -> str:
    """The sha256 of K2's bits (dq, dk, dv and dbias given K1's residuals)
    at K2_DIGEST_CASES, bf16 B2 H12 d64, inputs from numpy's generator."""
    digest = hashlib.sha256()
    for n, biased in K2_DIGEST_CASES:
        rng = np.random.default_rng(n)
        fused = torch.from_numpy(rng.standard_normal((2, n, 3 * 768)).astype(np.float32)).cuda()
        q, k, v = heads(fused.to(torch.bfloat16), 12)
        do = torch.from_numpy(rng.standard_normal((2, n, 12, 64)).astype(np.float32)).cuda()
        do = do.to(torch.bfloat16).transpose(1, 2)
        bias = torch.from_numpy(np.log(rng.uniform(1, 5, (2, n))).astype(np.float32)).cuda() if biased else None
        for g in k2_given_residuals(q, k, v, bias, do, 0.125):
            if g is not None:
                digest.update(g.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return digest.hexdigest()


def phase_bwd_kernel(smi: str) -> dict:
    """K2 against its plain version (the TPU kernel's softmax form), with a
    token-major do: given K1's residuals, and without them."""
    token_major_do = lambda gen, b, h, n, d: torch.randn((b, n, h, d), generator=gen, device="cuda").transpose(1, 2)
    rows, worst_abs = check_backward_against_plain(
        "K2", k2_given_residuals, _backward_reference, BWD_SHAPES, token_major_do, seed=6)
    rows_alone, worst_alone = check_backward_against_plain(
        "K2 without residuals", tome_flash_attention_backward, _backward_reference, BWD_SHAPES_NO_RESIDUALS,
        token_major_do, seed=10)
    # times at B8 H12 d64 bf16 given the residuals, without dbias as on the
    # training paths (VideoMAE unbiased, ViViT with the key bias): 10 B H N^2 d
    # operations (the five products the function needs); q, k, v, do (and
    # the bias) read and dq, dk, dv written: the function's own bytes, not
    # the residuals this kernel chooses to read
    gen = torch.Generator(device="cuda").manual_seed(7)
    times = {}
    for n, biased in TIMED:
        q, k, v, bias = timed_inputs(gen, n, biased)
        do = torch.randn((8, n, 12, 64), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
        with torch.inference_mode():
            out, lse = flash_attention._forward(q, k, v, bias, 0.125, want_lse=True)
        leaves = [t.detach().contiguous().requires_grad_() for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=sdpa_bias(bias), scale=0.125)
        do_c = do.contiguous()
        t = in_turns(
            lambda: tome_flash_attention_backward(q, k, v, bias, do, 0.125, need_dbias=False, out=out, lse=lse),
            lambda: _backward_reference(q, k, v, bias, do, 0.125),
            lambda: torch.autograd.grad(sdpa_out, leaves, do_c, retain_graph=True))
        flops = 10 * 8 * 12 * n * n * 64
        nbytes = 7 * 8 * 12 * n * 64 * 2 + (8 * n * 4 if biased else 0)
        times[str(n)] = dict(biased=biased, **t, kernel_tflops=flops / t["kernel_ms"] / 1e9,
                             **bound(flops, nbytes))
        del sdpa_out, leaves  # the plain version at N 3137 keeps several [B, H, N, N] tensors
    emit("bwd_kernel_without_residuals", checks=rows_alone, max_abs_err_vs_plain=worst_alone, nvidia_smi=smi)
    emit("bwd_kernel_bits", sha256=k2_digest(), cases=K2_DIGEST_CASES)
    emit("fwd_kernel_bits", sha256=forward_digests(), cases=FWD_DIGEST_CASES)
    return emit_backward("bwd_kernel", smi, rows, max(worst_abs, worst_alone), times)


def phase_frame_bwd_kernel(smi: str) -> dict:
    """K4 against its plain version (the TPU kernel's softmax form), given
    K3's residuals as a train step passes them, and without them (the
    wrapper then runs K3 first). ``do`` is token-major [B, N', F, H, d],
    here a permuted view of a frame-major buffer, so every one of its
    strides differs from the contiguous layout's."""
    frame_major_do = lambda gen, b, h, n, d: torch.randn(
        (b, MF_FRAMES, n, h, d), generator=gen, device="cuda").transpose(1, 2)
    plain = functools.partial(_frame_backward_reference, frames=MF_FRAMES)
    rows, worst_abs = check_backward_against_plain(
        "K4", k4_given_residuals, plain, FRAME_BWD_SHAPES, frame_major_do, seed=8)
    rows_alone, worst_alone = check_backward_against_plain(
        "K4 without residuals", functools.partial(tome_frame_attention_backward, frames=MF_FRAMES), plain,
        FRAME_BWD_SHAPES_NO_RESIDUALS, frame_major_do, seed=14)
    # times at B8 H12 d64 F8 bf16 given K3's residuals, with the contiguous
    # do autograd hands over and, as on the training path, no dbias. The
    # library call: autograd's backward of frame_sdpa's one
    # scaled_dot_product_attention call, with its sum over the F copies of q.
    gen = torch.Generator(device="cuda").manual_seed(9)
    times = {}
    for n, biased in FRAME_TIMED:
        q, k, v, bias = timed_inputs(gen, n, biased)
        do = torch.randn((8, n, MF_FRAMES, 12, 64), generator=gen, device="cuda").to(torch.bfloat16)
        with torch.inference_mode():
            out, lse = flash_attention._frame_forward(q, k, v, bias, 0.125, MF_FRAMES, want_lse=True)
        leaves = [t.detach().contiguous().requires_grad_() for t in (q, k, v)]
        qf, kf, vf, mask = frame_sdpa_operands(*leaves, bias)
        sdpa_out = F.scaled_dot_product_attention(qf, kf, vf, attn_mask=mask, scale=0.125)
        # the cotangent in SDPA's frame-major layout [B*F, H, N', d]
        do_fm = do.permute(0, 2, 3, 1, 4).reshape(8 * MF_FRAMES, 12, n, 64).contiguous()
        t = in_turns(
            lambda: tome_frame_attention_backward(q, k, v, bias, do, 0.125, MF_FRAMES, need_dbias=False,
                                                  out=out, lse=lse),
            lambda: _frame_backward_reference(q, k, v, bias, do, 0.125, MF_FRAMES),
            lambda: torch.autograd.grad(sdpa_out, leaves, do_fm, retain_graph=True))
        # 10 B H N'^2 d operations; q, k, v and the bias read, do (F times
        # the size of q) read, dq, dk, dv written: the function's bytes, not
        # the residuals (out, lse) this kernel chooses to read
        flops = 10 * 8 * 12 * n * n * 64
        nbytes = (6 + MF_FRAMES) * 8 * 12 * n * 64 * 2 + (8 * n * 4 if biased else 0)
        times[str(n)] = dict(biased=biased, **t, kernel_tflops=flops / t["kernel_ms"] / 1e9,
                             **bound(flops, nbytes))
        del sdpa_out, leaves
    emit("frame_bwd_kernel_without_residuals", checks=rows_alone, max_abs_err_vs_plain=worst_alone, nvidia_smi=smi)
    emit("frame_bwd_kernel_resources", resources=kernel_build.kernel_resources("frame_attention_bwd.cu"))
    return emit_backward("frame_bwd_kernel", smi, rows, max(worst_abs, worst_alone), times)


def blockdiag_views(fused: torch.Tensor, b: int, h: int, f: int):
    """q, k, v [B, H, F*s, d] as the model hands them to K5: views of the
    (b t) batch's fused qkv projection [(B*F), s, 3*H*d], a clip's frames
    being contiguous."""
    s_, d = fused.shape[1], fused.shape[2] // (3 * h)
    return [t.transpose(1, 2) for t in fused.view(b, f * s_, 3, h, d).unbind(dim=2)]


def blockdiag_bias(gen, b: int, f: int, s_: int) -> torch.Tensor:
    """[0, log size] per frame: fp32 [B, F*s], entry 0 of each frame 0."""
    bias = torch.log(torch.rand((b, f, s_), generator=gen, device="cuda") * 4 + 1)
    bias[:, :, 0] = 0.0
    return bias.view(b, f * s_)


def blockdiag_sdpa_operands(fused: torch.Tensor, bias, masked: bool, f: int):
    """K5's operands for one scaled_dot_product_attention call on the (b t)
    batch: contiguous [(B*F), H, s, d], and the bias as an additive mask
    [(B*F), 1, s, s] (the row mask times the key bias)."""
    q, k, v = (t.contiguous() for t in heads(fused, 12))
    mask = None
    if bias is not None:
        s_ = fused.shape[1]
        rows = torch.ones(s_, device="cuda")
        if masked:
            rows[0] = 0.0
        mask = (rows[:, None] * bias.view(-1, 1, 1, s_)).to(torch.bfloat16)
    return q, k, v, mask


def blockdiag_bound(s_: int, biased: bool, products: int, tensors: int) -> dict:
    """K5a: 2 products and 4 tensors (q, k, v, out); K5b: 5 and 7 (q, k, v,
    do read, dq, dk, dv written: not the residuals the kernel reads)."""
    flops = 2 * products * 8 * 12 * TS_FRAMES * s_ * s_ * 64
    nbytes = tensors * 8 * 12 * TS_FRAMES * s_ * 64 * 2 + (8 * TS_FRAMES * s_ * 4 if biased else 0)
    return dict(flops=flops, **bound(flops, nbytes))


def phase_blockdiag_kernel(smi: str) -> dict:
    """K5a against its plain version: fp32 within BLOCKDIAG_FP32_TOL of the
    largest entry, bf16 within bf16_tol of an fp32 reference; unbiased,
    biased, and biased with the row mask; strided views of a fused buffer."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    rows, worst = [], 0.0
    for b, h, f, s_, d in BLOCKDIAG_FWD_SHAPES:
        scale = d ** -0.5
        for biased, masked in BLOCKDIAG_MODES:
            bias = blockdiag_bias(gen, b, f, s_) if biased else None
            fused = torch.randn((b * f, s_, 3 * h * d), generator=gen, device="cuda")
            q32, k32, v32 = blockdiag_views(fused, b, h, f)
            check(not q32.is_contiguous(), "q is a strided view")
            out32 = tome_blockdiag_attention(q32, k32, v32, bias, scale, f, masked)
            ref32 = _blockdiag_reference(q32, k32, v32, bias, scale, f, masked)
            check(tuple(out32.shape) == (b, f * s_, h * d), f"K5a output shape {tuple(out32.shape)}")
            err32 = (out32 - ref32).abs().max().item()
            tol32 = BLOCKDIAG_FP32_TOL * ref32.abs().max().item()
            check(err32 <= tol32, f"K5a fp32 err {err32} > {tol32} at {(b, h, f, s_, d)} {biased} {masked}")
            q, k, v = blockdiag_views(fused.to(torch.bfloat16), b, h, f)
            out = tome_blockdiag_attention(q, k, v, bias, scale, f, masked)
            ref = _blockdiag_reference(q.float(), k.float(), v.float(), bias, scale, f, masked)
            base = _blockdiag_reference(q, k, v, bias, scale, f, masked)
            err_k = (out.float() - ref).abs().max().item()
            err_p = (base.float() - ref).abs().max().item()
            check(err_k <= bf16_tol(err_p), f"K5a bf16 err {err_k} > {bf16_tol(err_p)} at {(b, h, f, s_, d)} {biased} {masked}")
            vs_plain = (out.float() - base.float()).abs().max().item()
            worst = max(worst, vs_plain, err32)
            rows.append(dict(shape=[b, h, f, s_, d], biased=biased, exclude_first_row=masked, fp32_err=err32,
                             bf16_err=err_k, bf16_plain_err=err_p, bf16_vs_plain=vs_plain))
    torch.cuda.synchronize()
    # times at B8 H12 d64 F8 bf16, beside the plain version and one
    # scaled_dot_product_attention call on the (b t) batch
    gen = torch.Generator(device="cuda").manual_seed(11)
    times = {}
    for s_, biased, masked in BLOCKDIAG_TIMED:
        fused = torch.randn((8 * TS_FRAMES, s_, 3 * 768), generator=gen, device="cuda").to(torch.bfloat16)
        bias = blockdiag_bias(gen, 8, TS_FRAMES, s_) if biased else None
        q, k, v = blockdiag_views(fused, 8, 12, TS_FRAMES)
        qs, ks, vs, mask = blockdiag_sdpa_operands(fused, bias, masked, TS_FRAMES)
        with torch.inference_mode():
            t = in_turns(lambda: tome_blockdiag_attention(q, k, v, bias, 0.125, TS_FRAMES, masked),
                         lambda: _blockdiag_reference(q, k, v, bias, 0.125, TS_FRAMES, masked),
                         lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, scale=0.125))
        bnd = blockdiag_bound(s_, biased, products=2, tensors=4)
        times[str(s_)] = dict(biased=biased, exclude_first_row=masked, **t,
                              kernel_tflops=bnd.pop("flops") / t["kernel_ms"] / 1e9, **bnd)
    emit("blockdiag_kernel", checks=rows, max_abs_err_vs_plain=worst, timing_bf16_B8_H12_d64_F8=times,
         resources=kernel_build.kernel_resources("blockdiag_attention_fwd.cu"), nvidia_smi=smi)
    first = times[str(BLOCKDIAG_TIMED[0][0])]
    return dict(max_abs_err=worst, ms=first["kernel_ms"], device_ms=first["kernel_device_ms"],
                plain_ms=first["plain_ms"],
                bound_ms=first["bound_ms"], bound_by=first["bound_by"], library_ms=first["library_ms"])


def check_blockdiag_backward(name: str, backward, shapes, seed: int):
    """K5b, called as backward(q, k, v, bias, do, scale, frames, masked),
    against its plain version (the TPU kernel's softmax form) at ``shapes``
    in every mode, with a permuted (strided) token-major cotangent: dq, dk,
    dv and dbias, the masked dbias included; fp32 within
    BLOCKDIAG_FP32_TOL and bf16 within bf16_tol of each gradient's largest
    entry; the same bits twice. Returns (rows, largest absolute
    difference)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows, worst_abs = [], 0.0
    for b, h, f, s_, d in shapes:
        scale, n = d ** -0.5, f * s_
        for biased, masked in BLOCKDIAG_MODES:
            bias = blockdiag_bias(gen, b, f, s_) if biased else None
            fused = torch.randn((b * f, s_, 3 * h * d), generator=gen, device="cuda")
            do32 = torch.randn((n, b, h * d), generator=gen, device="cuda").transpose(0, 1)
            q32, k32, v32 = blockdiag_views(fused, b, h, f)
            # (at B = 1 the permuted cotangent is contiguous again)
            check((b == 1 or not do32.is_contiguous()) and not q32.is_contiguous(), "inputs are strided views")
            got32 = backward(q32, k32, v32, bias, do32, scale, f, masked)
            err32 = grad_errors(got32, _blockdiag_backward_reference(q32, k32, v32, bias, do32, scale, f, masked))
            check(len(err32) == (4 if biased else 3), "dbias comes with a bias and only then")
            for g, (_, rel) in err32.items():
                check(rel <= BLOCKDIAG_FP32_TOL,
                      f"{name} fp32 {g} err {rel} > {BLOCKDIAG_FP32_TOL} at {(b, h, f, s_, d)} {biased} {masked}")
            q, k, v = blockdiag_views(fused.to(torch.bfloat16), b, h, f)
            do = do32.to(torch.bfloat16)  # dense and permuted: keeps its strides
            check(do.stride() == do32.stride(), "the bf16 do is the same strided view")
            got = backward(q, k, v, bias, do, scale, f, masked)
            again = backward(q, k, v, bias, do, scale, f, masked)
            check(all(torch.equal(x, y) for x, y in zip(got, again) if x is not None), f"{name} differs from run to run")
            ref = _blockdiag_backward_reference(q.float(), k.float(), v.float(), bias, do.float(), scale, f, masked)
            base = _blockdiag_backward_reference(q, k, v, bias, do, scale, f, masked)
            err_k, err_p = grad_errors(got, ref), grad_errors(base, ref)
            for g in err_k:
                tol = bf16_tol(err_p[g][1])
                check(err_k[g][1] <= tol, f"{name} bf16 {g} err {err_k[g][1]} > {tol} at {(b, h, f, s_, d)} {biased} {masked}")
            vs_plain = grad_errors(got, base)
            worst_abs = max([worst_abs] + [e for e, _ in vs_plain.values()] + [e for e, _ in err32.values()])
            rows.append(dict(shape=[b, h, f, s_, d], biased=biased, exclude_first_row=masked,
                             fp32_rel_err={k_: r for k_, (_, r) in err32.items()},
                             bf16_rel_err={k_: r for k_, (_, r) in err_k.items()},
                             bf16_plain_rel_err={k_: r for k_, (_, r) in err_p.items()}))
    torch.cuda.synchronize()
    return rows, worst_abs


def phase_blockdiag_bwd_kernel(smi: str) -> dict:
    """K5b against its plain version given K5a's residuals, and without
    them (the wrapper then runs K5a first); timed given the residuals."""
    rows, worst_abs = check_blockdiag_backward("K5b", k5b_given_residuals, BLOCKDIAG_BWD_SHAPES, seed=12)
    rows_alone, worst_alone = check_blockdiag_backward(
        "K5b without residuals", tome_blockdiag_attention_backward, BLOCKDIAG_BWD_SHAPES_NO_RESIDUALS, seed=15)
    # times at B8 H12 d64 F8 bf16 given K5a's residuals, with the contiguous
    # do autograd hands over and no dbias, beside autograd's backward of one
    # scaled_dot_product_attention call on the (b t) batch
    gen = torch.Generator(device="cuda").manual_seed(13)
    times = {}
    for s_, biased, masked in BLOCKDIAG_TIMED:
        fused = torch.randn((8 * TS_FRAMES, s_, 3 * 768), generator=gen, device="cuda").to(torch.bfloat16)
        bias = blockdiag_bias(gen, 8, TS_FRAMES, s_) if biased else None
        q, k, v = blockdiag_views(fused, 8, 12, TS_FRAMES)
        do = torch.randn((8, TS_FRAMES * s_, 768), generator=gen, device="cuda").to(torch.bfloat16)
        with torch.inference_mode():
            out, lse = flash_attention._blockdiag_forward(q, k, v, bias, 0.125, TS_FRAMES, masked, want_lse=True)
        qs, ks, vs, mask = blockdiag_sdpa_operands(fused, bias, masked, TS_FRAMES)
        leaves = [t.requires_grad_() for t in (qs, ks, vs)]
        sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=0.125)
        do_bt = do.view(8 * TS_FRAMES, s_, 12, 64).transpose(1, 2).contiguous()
        t = in_turns(
            lambda: tome_blockdiag_attention_backward(q, k, v, bias, do, 0.125, TS_FRAMES, masked, need_dbias=False,
                                                      out=out, lse=lse),
            lambda: _blockdiag_backward_reference(q, k, v, bias, do, 0.125, TS_FRAMES, masked),
            lambda: torch.autograd.grad(sdpa_out, leaves, do_bt, retain_graph=True))
        bnd = blockdiag_bound(s_, biased, products=5, tensors=7)
        times[str(s_)] = dict(biased=biased, exclude_first_row=masked, **t,
                              kernel_tflops=bnd.pop("flops") / t["kernel_ms"] / 1e9, **bnd)
    emit("blockdiag_bwd_kernel_without_residuals", checks=rows_alone, max_abs_err_vs_plain=worst_alone, nvidia_smi=smi)
    emit("blockdiag_bwd_kernel_resources", resources=kernel_build.kernel_resources("blockdiag_attention_bwd.cu"))
    return emit_backward("blockdiag_bwd_kernel", smi, rows, max(worst_abs, worst_alone), times,
                         first=str(BLOCKDIAG_TIMED[0][0]))


@contextlib.contextmanager
def recording(module, name: str):
    """While open, every result of ``module.name`` is appended to the list
    it yields (the matcher's Matchings, the hybrid's kept-dst masks)."""
    seen, original = [], getattr(module, name)

    def record(*args, **kwargs):
        out = original(*args, **kwargs)
        seen.append(out)
        return out

    setattr(module, name, record)
    try:
        yield seen
    finally:
        setattr(module, name, original)


def phase_blocks(phase: str, cfg, seed: int, block_kwargs: dict, launch_count, final_tokens: int,
                 launches_expected: int, frames: int = 16, blocks: str = "blocks", attn: str = "attn",
                 generator_seed=None) -> None:
    """Teacher-forced full-width blocks (fp32, TF32 off, B2): each executed
    step (``layer_schedule``: a block may run at several steps, some
    metric-only) gets the plain chain's input through the kernel path and
    the plain path, which must make identical Matching indices (those the
    matcher made in each path) and sizes and outputs within BLOCK_TOL.
    ``generator_seed``: the random modes' scores come from a CUDA generator
    seeded anew for each path at each step. ``blocks`` and ``attn`` name the
    model's block list and a block's attention module."""
    model = build_model(cfg, "cuda").module
    model_blocks = getattr(model, blocks)
    steps = model.layer_schedule or range(len(model_blocks))
    steps = [s if isinstance(s, tuple) else (s, False) for s in steps]
    video = torch.from_numpy(
        np.random.default_rng(seed).random((2, frames, 224, 224, 3), dtype=np.float32)
    ).cuda()
    launches0, rows = launch_count(), []
    with torch.inference_mode(), recording(merge_bipartite, "_match") as matchings:
        x = model.embed(video)
        size = None
        for i, (b, metric_only) in enumerate(steps):
            blk, outs = model_blocks[b], {}
            kwargs = dict(block_kwargs, metric_only=True) if metric_only else block_kwargs
            for path in ("kernel", "plain"):
                getattr(blk, attn).use_kernel = path == "kernel"
                generator = None
                if generator_seed is not None:
                    generator = torch.Generator(device="cuda").manual_seed(generator_seed + i)
                matchings.clear()
                y, st = blk(x, MergeState(size=size, generator=generator), layer=i, **kwargs)
                outs[path] = (y, st.size, matchings[0] if matchings else None)
            getattr(blk, attn).use_kernel = True
            (yk, sk, mk), (yp, sp, mp) = outs["kernel"], outs["plain"]
            check((mk is None) == (mp is None), f"{phase} {i}: a matching in one path only")
            for name in ("unm_idx", "src_idx", "dst_idx") if mk is not None else ():
                check(torch.equal(getattr(mk, name), getattr(mp, name)),
                      f"{phase} {i}: {name} differs between kernel and plain paths")
            check(torch.equal(sk, sp), f"{phase} {i}: sizes differ")
            err = (yk - yp).abs().max().item()
            check(err <= BLOCK_TOL, f"{phase} {i}: output err {err} > {BLOCK_TOL}")
            rows.append(dict(layer=i, block=b, tokens=x.shape[1], err=err))
            x, size = yp, sp
    check(x.shape[1] == final_tokens, f"{phase}: final tokens {x.shape[1]}")
    launches = launch_count() - launches0
    check(launches == launches_expected, f"{phase}: {launches} kernel launches")
    emit(phase, layers=rows, kernel_launches=launches)


def zero_part(name: str, zero_gradients):
    """The part of parameter ``name``'s gradient that is zero analytically:
    None (no part), a slice of its first dim, or slice(None) (all of it).
    ``zero_gradients`` holds name substrings, alone or with a slice."""
    for z in zero_gradients:
        key, part = (z, slice(None)) if isinstance(z, str) else z
        if key in name:
            return part
    return None


def group_scale(name: str, grads: dict, grad_groups):
    """The largest gradient entry among ``name`` and its siblings in
    ``grad_groups`` (tuples of name parts that stand for one fused
    parameter), or None when ``name`` is in no group."""
    for group in grad_groups:
        for part in group:
            if part in name:
                return max(grads[name.replace(part, other)].abs().max().item() for other in group)
    return None


def phase_train_blocks(phase: str, cfg, fwd: str, bwd: str, launches_expected: int,
                       final_tokens: int, train_mode: bool = False, zero_gradients=(),
                       frames: int = 16, blocks: str = "blocks", attn: str = "attn", grad_groups=()) -> None:
    """Loss and every parameter's gradient of a full-width fp32 model (TF32
    off, B2, merged, drop rates 0) through its forward and backward kernels
    (the counters ``fwd`` and ``bwd``) against the plain path, gradients
    within GRAD_TOL of each tensor's largest entry. ``train_mode`` makes a
    Motionformer return logits instead of probabilities. Parameters whose
    name holds one of ``zero_gradients`` have a gradient that is zero
    analytically: on both paths it must be rounding noise, below 1e-6 of
    the largest entry of any gradient. An entry of ``zero_gradients`` may
    name a slice of the parameter's first dim; the rest is compared.
    ``blocks`` and ``attn`` name the model's block list and a block's
    attention module. ``grad_groups`` names separate parameters that the
    other families hold as one fused tensor (ViViT's query, key and value
    projections): each is measured against the largest entry of the
    group, as a fused qkv gradient is, and its error against its own
    largest entry is reported.

    Both runs merge by the plain run's Matching objects: a layer's metric
    is computed before its attention, so on the same input both paths
    match identically (the block phases and layer 0 here hold that), but
    the 1e-6 that a kernel differs by reaches later layers' metrics and can
    swap two near-tied tokens, after which gradients are of two different
    programs. How many layers matched identically on their own is
    reported."""
    model = build_model(cfg, "cuda", fp32_params=True).module.train()
    if train_mode:
        model.train_mode = True
    rng = np.random.default_rng(7)
    video = torch.from_numpy(rng.random((2, frames, 224, 224, 3), dtype=np.float32)).cuda()
    labels = torch.from_numpy(rng.integers(0, 400, 2)).cuda()
    match = merge_bipartite.bipartite_soft_matching
    plain_matchings, own_matchings = [], []

    def record(metric, r, *args):
        plain_matchings.append(match(metric, r, *args))
        return plain_matchings[-1]

    def forced(metric, r, *args):
        own_matchings.append(match(metric, r, *args))
        return plain_matchings[len(own_matchings) - 1]

    before = launch_counts()
    runs = {}
    try:
        for path, matcher in (("plain", record), ("kernel", forced)):
            merge_bipartite.bipartite_soft_matching = matcher
            for blk in getattr(model, blocks):
                getattr(blk, attn).use_kernel = path == "kernel"
            model.zero_grad(set_to_none=True)
            logits, state = model(video)
            loss = F.cross_entropy(logits, labels)
            loss.backward()
            runs[path] = (loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()},
                          state.size)
    finally:
        merge_bipartite.bipartite_soft_matching = match
    launches = {c: n - before[c] for c, n in launch_counts().items()}
    expected = {c: launches_expected if c in (fwd, bwd) else 0 for c in COUNTERS}
    check(launches == expected, f"{phase}: kernel launches {launches}")
    check(len(plain_matchings) == len(own_matchings) == 12, f"{phase}: one matching per layer")
    same = [all(torch.equal(getattr(a_, name), getattr(b_, name))
                for name in ("unm_idx", "src_idx", "dst_idx"))
            for a_, b_ in zip(own_matchings, plain_matchings)]
    check(same[0], f"{phase}: layer 0 matches differently on the same input")
    (lk, gk, sk), (lp, gp, sp) = runs["kernel"], runs["plain"]
    check(torch.equal(sk, sp) and sk.shape[1] == final_tokens, f"{phase}: sizes differ")
    check(abs(lk - lp) <= BLOCK_TOL, f"{phase}: loss {lk} vs {lp}")
    worst, worst_name, worst_own, worst_own_name = 0.0, "", 0.0, ""
    noise = 1e-6 * max(g.abs().max().item() for g in gp.values())
    for name, g in gp.items():
        part, g_k = zero_part(name, zero_gradients), gk[name]
        if part is not None:
            size = max(g[part].abs().max().item(), g_k[part].abs().max().item())
            check(size <= noise, f"{phase}: gradient of {name} should be zero, has an entry of {size}")
            if part == slice(None):
                continue
            keep = torch.ones(g.shape[0], dtype=torch.bool, device=g.device)
            keep[part] = False
            g, g_k = g[keep], g_k[keep]
        diff, scale = (g_k - g).abs().max().item(), group_scale(name, gp, grad_groups)
        if scale is not None and diff / g.abs().max().item() > worst_own:
            worst_own, worst_own_name = diff / g.abs().max().item(), name
        rel = diff / (scale or g.abs().max().item())
        check(rel <= GRAD_TOL, f"{phase}: gradient of {name} off by {rel} of its largest entry")
        if rel > worst:
            worst, worst_name = rel, name
    emit(phase, loss_kernel=lk, loss_plain=lp, parameters=len(gp),
         analytically_zero_gradients=sum(zero_part(n, zero_gradients) is not None for n in gp),
         worst_grad_rel_err=worst,
         worst_grad=worst_name, worst_grouped_grad_own_rel_err=worst_own, worst_grouped_grad=worst_own_name,
         forward_kernel_launches=launches[fwd], backward_kernel_launches=launches[bwd],
         layers_matching_identically_unforced=sum(same))


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
    zero_launch_counts()  # this path's counts start here
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
    zero_launch_counts()  # this path's counts start here
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


def phase_family_serve(phase: str, smi: str, cfg_fn, num_frames: int, seed: int, counter: str,
                       stats_key: str, per_forward: dict, counts, tokens_of, blocks_of,
                       flop_ceiling: float) -> int:
    """``model_benchmark`` merged and unmerged at full width and depth, B8
    bf16, for a family whose forward kernel counts in ``counter`` (and in
    ``stats_key`` of the benchmark's statistics): launches per forward,
    ``counts`` (what ``tokens_of`` makes of the tokens entering each block
    and leaving the last), the policy's schedule, finite logits of the
    expected shape, clips/s. Returns the kernel's launches in the phase."""
    video = torch.from_numpy(
        np.random.default_rng(seed).random((8, num_frames, 224, 224, 3), dtype=np.float32)
    ).cuda()
    runs = {}
    zero_launch_counts()  # this path's counts start here
    for label, opts, want_counts in (
        ("merged", (), tuple(counts)),
        ("unmerged", ("TOME.ENABLE", "False"), (counts[0],) * 13),
    ):
        cfg = cfg_fn("TEST.BATCH_SIZE", "8", "MODEL_BENCHMARK.WARMUP_ITERATIONS", str(SERVE_WARMUP),
                     "MODEL_BENCHMARK.ITERATIONS", str(SERVE_ITERS), *opts)
        before = getattr(flash_attention, counter)
        stats = model_benchmark(cfg)
        bundle = build_model(cfg, "cuda")
        seen = []
        blocks = blocks_of(bundle.module)
        hooks = [blk.register_forward_pre_hook(lambda m, a: seen.append(tokens_of(a[0].shape[1])))
                 for blk in blocks]
        hooks.append(blocks[-1].register_forward_hook(lambda m, a, o: seen.append(tokens_of(o[0].shape[1]))))
        with torch.inference_mode():
            logits, _ = bundle.module(video)
        torch.cuda.synchronize()
        for hk in hooks:
            hk.remove()
        launches = getattr(flash_attention, counter) - before
        check(tuple(logits.shape) == (8, 400), f"{phase} {label}: logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), f"{phase} {label}: non-finite logits")
        check(tuple(seen) == want_counts, f"{phase} {label}: token counts {seen}")
        check(tuple(bundle.policy.token_counts(counts[0])) == want_counts, f"{phase} {label}: schedule")
        check(stats[stats_key] == per_forward[label],
              f"{phase} {label}: {stats[stats_key]} launches per forward")
        forwards = SERVE_WARMUP + SERVE_ITERS + 1
        check(launches == per_forward[label] * forwards, f"{phase} {label}: {launches} launches in {forwards} forwards")
        runs[label] = dict(clips_per_sec=stats["clips_per_sec"], launches=launches,
                           launches_per_forward=stats[stats_key], token_counts=list(want_counts))
    total = launch_counts()  # read right after the path ran
    check(total[counter] > 0, f"the {phase} path launched no {counter} kernel")
    check(all(n == 0 for c, n in total.items() if c != counter),
          f"the {phase} path launched another path's kernels: {total}")
    emit(
        phase,
        merged=runs["merged"],
        unmerged=runs["unmerged"],
        speedup=runs["merged"]["clips_per_sec"] / runs["unmerged"]["clips_per_sec"],
        flop_ceiling=flop_ceiling,
        batch=8, dtype="bfloat16", nvidia_smi=smi,
    )
    return total[counter]


@contextlib.contextmanager
def recording_test_net():
    """While open, ``test_net`` keeps every meter it makes, and each meter
    the seconds of each batch by its own iteration timer (the loader, the
    copy in, the forward and the logits read to the host)."""
    seen = []
    saved = {name: getattr(test_net, name) for name in ("TestMeter", "EPICTestMeter")}

    def recording(base):
        class Recording(base):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                self.batch_seconds = []
                seen.append(self)

            def iter_toc(self):
                super().iter_toc()
                self.batch_seconds.append(self.iter_timer.seconds())
        return Recording

    for name, base in saved.items():
        setattr(test_net, name, recording(base))
    try:
        yield seen
    finally:
        for name, value in saved.items():
            setattr(test_net, name, value)


def phase_eval(phase: str, smi: str, cfg_fn, opts, counter: str, per_batch: int, stats_keys) -> int:
    """``test_net.test`` on the card at full width and depth, bf16: every
    video's clip count, its ensemble against the sum of a direct forward of
    its clips, the kernel's launches per batch (``counter``; no other kernel
    launched), the stats finite. Returns the kernel's launches in the phase."""
    out = EVAL_OUT / phase
    shutil.rmtree(out, ignore_errors=True)
    cfg = cfg_fn(*opts, "OUTPUT_DIR", str(out))
    clips = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    batches = -(-EVAL_VIDEOS * clips // cfg.TEST.BATCH_SIZE)
    zero_launch_counts()  # this path's counts start here
    start = time.perf_counter()
    with recording_test_net() as seen:
        results = test_net.test(cfg)
    seconds = time.perf_counter() - start
    total = launch_counts()  # read right after the path ran
    check(total[counter] == per_batch * batches,
          f"{phase}: {total[counter]} {counter} in {batches} batches, not {per_batch} a batch")
    check(all(n == 0 for c, n in total.items() if c != counter), f"{phase}: another path's kernels: {total}")
    check(len(results) == 1 and len(seen) == 1, f"{phase}: {len(results)} results")
    (views, stats), meter = results[0], seen[0]
    check(len(meter.batch_seconds) == batches, f"{phase}: {len(meter.batch_seconds)} batches timed")
    check(set(stats) == set(stats_keys) | {"split"}, f"{phase}: stats keys {sorted(stats)}")
    check(all(np.isfinite(float(stats[k])) for k in stats_keys), f"{phase}: stats {stats}")
    check(meter.clip_count.shape == (EVAL_VIDEOS,) and bool((meter.clip_count == clips).all()),
          f"{phase}: clip counts {meter.clip_count.tolist()}")
    preds = [meter.video_preds] if hasattr(meter, "video_preds") else [meter.verb_preds, meter.noun_preds]
    check(all(p.dtype == np.float64 and np.isfinite(p).all() for p in preds), f"{phase}: ensembles")

    # the same clips through a second build of the same weights, summed per
    # video in fp64; the seconds spent waiting on the loader and on the card
    bundle = checkpoints.load_test_checkpoint(cfg, build_model(cfg, "cuda"))
    sums = [np.zeros_like(p) for p in preds]
    wait = {"loader": 0.0, "card": 0.0}
    with torch.inference_mode():
        batches_in = iter(construct_loader(cfg, "test"))
        while True:
            tick = time.perf_counter()
            batch = next(batches_in, None)
            tock = time.perf_counter()
            wait["loader"] += tock - tick
            if batch is None:
                break
            outs, _ = bundle.module(torch.as_tensor(batch["frames"], device="cuda"))
            outs = [o.float().cpu().numpy() for o in (outs if isinstance(outs, tuple) else (outs,))]
            wait["card"] += time.perf_counter() - tock  # copy in, forward, logits out
            vids = np.asarray(batch["index"]) // clips
            for s, o in zip(sums, outs):
                np.add.at(s, vids, o.astype(np.float64))
    ensemble_err = max(float(np.abs(p - s).max()) for p, s in zip(preds, sums))
    check(ensemble_err <= EVAL_SUM_TOL, f"{phase}: ensembles {ensemble_err} from the sum of a direct forward")
    emit(
        phase,
        views=views, crops=cfg.TEST.NUM_SPATIAL_CROPS, videos=EVAL_VIDEOS, clips=EVAL_VIDEOS * clips,
        batches=batches, batch=cfg.TEST.BATCH_SIZE, stats=stats, launches=total[counter],
        launches_per_batch=total[counter] / batches, ensemble_max_abs_err=ensemble_err,
        clips_per_sec=EVAL_VIDEOS * clips / sum(meter.batch_seconds),
        steady_clips_per_sec=(EVAL_VIDEOS * clips - cfg.TEST.BATCH_SIZE) / sum(meter.batch_seconds[1:]),
        batch_seconds=meter.batch_seconds, test_seconds=seconds, second_pass_loader_seconds=wait["loader"], second_pass_card_seconds=wait["card"],
        dtype=cfg.TPU.COMPUTE_DTYPE, nvidia_smi=smi,
    )
    return total[counter]


def variant_eval(tag: str, cfg_fn, *opts):
    """``test_net.test`` on the card over 8 synthetic videos in one batch of
    8, with a fresh OUTPUT_DIR: (stats, the meter's fp64 ensembles, the
    kernels' launches in the run)."""
    out = VARIANTS_OUT / tag
    shutil.rmtree(out, ignore_errors=True)
    before = launch_counts()
    with recording_test_net() as seen:
        results = test_net.test(cfg_fn(*VARIANT_EVAL_OPTS, "OUTPUT_DIR", str(out), *opts))
    check(len(results) == 1 and len(seen) == 1, f"{tag}: {len(results)} results")
    stats, meter = results[0][1], seen[0]
    check(all(np.isfinite(float(stats[k])) for k in ("top1_acc", "top5_acc")), f"{tag}: stats {stats}")
    check(bool((meter.clip_count == 1).all()) and meter.video_preds.shape == (8, 400), f"{tag}: ensembles")
    launches = {c: n - before[c] for c, n in launch_counts().items()}
    return stats, meter.video_preds.copy(), launches


def phase_variants(smi: str) -> dict:
    """The drop, random and hybrid merge modes at full width and depth, bf16,
    through the entry points, each first teacher-forced against its plain
    path (fp32 B2, identical Matching indices):
      * ViViT hybrid, r 300 at THRESHOLD 0.4, through test_net (the biased
        K1): the groups each layer drops; if 0.4 drops none on random
        weights, a second run at the median of layer 0's edge scores;
      * VideoMAE drop r 150 through model_benchmark (K1), timed in turns
        with merge and hybrid at the same r;
      * Motionformer drop r 18 through model_benchmark (K3);
      * TimeSformer random_drop r 18 through test_net (K5a): one seed twice
        gives the same bits, another seed others.
    Returns each kernel's launches in the phase."""
    zero_launch_counts()  # this path's counts start here
    vivit_hybrid = ("TOME.MODE", "hybrid", "TOME.THRESHOLD", str(VIVIT_HYBRID_THRESHOLD))
    phase_blocks("vivit_hybrid_blocks", vivit_cfg("TPU.COMPUTE_DTYPE", "float32", "TEST.BATCH_SIZE", "2",
                                                  *vivit_hybrid),
                 17, {}, lambda: flash_attention.LAUNCHES, VIVIT_COUNTS[-1], VIVIT_K1_PER_FORWARD["merged"],
                 frames=32, blocks="layer", attn="attention")
    with recording(merge_bipartite, "_dst_kept") as kept, recording(merge_bipartite, "_match") as matchings:
        stats, _, launches = variant_eval("vivit_hybrid", vivit_cfg, *vivit_hybrid)
        check(len(kept) == len(matchings) == 12, f"vivit hybrid: {len(kept)} thresholded layers")
        dropped = [int((k == 0).sum()) for k in kept]
        threshold = VIVIT_HYBRID_THRESHOLD
        first_scores = matchings[0].src_score
        runs = [dict(threshold=threshold, dropped_groups=dropped, stats=stats)]
        if sum(dropped) == 0:
            threshold = float(first_scores.median())
            kept.clear()
            stats, _, more = variant_eval("vivit_hybrid_median", vivit_cfg, "TOME.MODE", "hybrid",
                                          "TOME.THRESHOLD", repr(threshold))
            launches = {c: launches[c] + more[c] for c in launches}
            dropped = [int((k == 0).sum()) for k in kept[:12]]
            runs.append(dict(threshold=threshold, dropped_groups=dropped, stats=stats))
            check(sum(dropped) > 0, f"vivit hybrid at the median {threshold}: no group dropped")
    check(all(0 <= d <= 8 * 300 for d in dropped), f"vivit hybrid: dropped {dropped}")
    per_run = VIVIT_K1_PER_FORWARD["merged"]
    check(launches["LAUNCHES"] == per_run * len(runs) and
          all(n == 0 for c, n in launches.items() if c != "LAUNCHES"), f"vivit hybrid: launches {launches}")

    # VideoMAE drop, and merge / drop / hybrid timed in turns at r 150
    phase_blocks("videomae_drop_blocks", main_cfg("TPU.COMPUTE_DTYPE", "float32", "TEST.BATCH_SIZE", "2",
                                                  "TOME.MODE", "drop"),
                 1, {}, lambda: flash_attention.LAUNCHES, MERGED_COUNTS[-1], MERGED_K1_PER_FORWARD)
    serve = {}
    modes = {"merge": (), "drop": ("TOME.MODE", "drop"),
             "hybrid": ("TOME.MODE", "hybrid", "TOME.THRESHOLD", str(VIDEOMAE_HYBRID_THRESHOLD))}
    for turn, mode in enumerate(("merge", "drop", "hybrid", "hybrid", "drop", "merge")):
        cfg = main_cfg("TEST.BATCH_SIZE", "8", "MODEL_BENCHMARK.WARMUP_ITERATIONS", str(SERVE_WARMUP),
                       "MODEL_BENCHMARK.ITERATIONS", str(SERVE_ITERS), *modes[mode])
        stats = model_benchmark(cfg)
        check(stats["attention_kernel_launches"] == MERGED_K1_PER_FORWARD,
              f"videomae {mode}: {stats['attention_kernel_launches']} K1 launches a forward")
        serve.setdefault(mode, []).append(stats["clips_per_sec"])

    # Motionformer drop r 18 (K3)
    phase_blocks("mf_drop_blocks", mf_cfg("TPU.COMPUTE_DTYPE", "float32", "TEST.BATCH_SIZE", "2", "TOME.MODE", "drop"),
                 4, {"num_frames": MF_FRAMES}, lambda: flash_attention.FRAME_LAUNCHES, MF_BODY_COUNTS[-1] + 1,
                 MF_K3_PER_FORWARD["merged"])
    mf_stats = model_benchmark(mf_cfg("TEST.BATCH_SIZE", "8", "MODEL_BENCHMARK.WARMUP_ITERATIONS", str(SERVE_WARMUP),
                                      "MODEL_BENCHMARK.ITERATIONS", str(SERVE_ITERS), "TOME.MODE", "drop"))
    check(mf_stats["frame_attention_kernel_launches"] == MF_K3_PER_FORWARD["merged"],
          f"motionformer drop: {mf_stats['frame_attention_kernel_launches']} K3 launches a forward")

    # TimeSformer random_drop r 18 through test_net (K5a), per-batch generators
    phase_blocks("ts_random_drop_blocks", ts_cfg("TPU.COMPUTE_DTYPE", "float32", "TEST.BATCH_SIZE", "2",
                                                 "TOME.MODE", "random_drop"),
                 14, {"b": 2, "t": TS_FRAMES}, lambda: flash_attention.BLOCKDIAG_LAUNCHES,
                 1 + TS_FRAMES * TS_PATCH_COUNTS[-1], TS_K5_PER_FORWARD["merged"], frames=TS_FRAMES,
                 generator_seed=100)
    # one set of weights from a file, so that RNG_SEED moves only the draws
    weights = VARIANTS_OUT / "ts_weights.pyth"
    weights.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model_state": build_model(ts_cfg(), "cuda").module.state_dict()}, weights)
    ts_random = ("TOME.MODE", "random_drop", "TEST.CHECKPOINT_FILE_PATH", str(weights))
    before = flash_attention.BLOCKDIAG_LAUNCHES
    _, first, _ = variant_eval("ts_random_drop", ts_cfg, *ts_random)
    _, again, _ = variant_eval("ts_random_drop", ts_cfg, *ts_random)
    _, other, _ = variant_eval("ts_random_drop", ts_cfg, *ts_random, "RNG_SEED", "1")
    weights.unlink()
    check(np.array_equal(first, again), "timesformer random_drop: one seed, two results")
    check(not np.array_equal(first, other), "timesformer random_drop: two seeds, one result")
    check(flash_attention.BLOCKDIAG_LAUNCHES - before == 3 * TS_K5_PER_FORWARD["merged"],
          f"timesformer random_drop: {flash_attention.BLOCKDIAG_LAUNCHES - before} K5a launches in 3 batches")

    total = launch_counts()  # read right after the path ran
    check(all(total[c] > 0 for c in ("LAUNCHES", "FRAME_LAUNCHES", "BLOCKDIAG_LAUNCHES")),
          f"the variants path left a kernel unlaunched: {total}")
    check(all(n == 0 for c, n in total.items() if c not in ("LAUNCHES", "FRAME_LAUNCHES", "BLOCKDIAG_LAUNCHES")),
          f"the variants path launched a backward kernel: {total}")
    emit(
        "variants",
        vivit_hybrid=runs, vivit_layer0_median_score=float(first_scores.median()),
        videomae_clips_per_sec=serve,
        videomae_ratio_to_merge={m: float(np.median(v) / np.median(serve["merge"])) for m, v in serve.items()},
        motionformer_drop_clips_per_sec=mf_stats["clips_per_sec"],
        timesformer_random_drop=dict(same_seed_same_bits=True, other_seed_differs=True,
                                     max_abs_diff_other_seed=float(np.abs(first - other).max())),
        launches=total, batch=8, dtype="bfloat16", nvidia_smi=smi,
    )
    return total


def phase_dup(smi: str) -> int:
    """Layer duplication: VideoMAE's block 0 run 12 times at R 131, B8 bf16
    (teacher-forced first, fp32 B2, metric-only steps included). The
    tokens entering each executed step equal ``token_counts`` of the grown
    schedule; K1 runs DUP_K1_PER_FORWARD times a forward. Returns K1's
    launches in the phase."""
    zero_launch_counts()  # this path's counts start here
    phase_blocks("dup_blocks", main_cfg("TPU.COMPUTE_DTYPE", "float32", "TEST.BATCH_SIZE", "2", *DUP_OPTS),
                 3, {}, lambda: flash_attention.LAUNCHES, DUP_COUNTS[-1], DUP_K1_PER_FORWARD)
    cfg = main_cfg("TEST.BATCH_SIZE", "8", *DUP_OPTS)
    bundle = build_model(cfg, "cuda")
    schedule = bundle.module.layer_schedule
    check(len(schedule) == 23 and sum(m for _, m in schedule) == 11, f"dup: schedule {schedule}")
    check(tuple(bundle.policy.token_counts(1568)) == DUP_COUNTS, "dup: the policy's token counts")
    seen = []
    hooks = [blk.register_forward_pre_hook(lambda m, a: seen.append(a[0].shape[1])) for blk in bundle.module.blocks]
    video = torch.from_numpy(np.random.default_rng(8).random((8, 16, 224, 224, 3), dtype=np.float32)).cuda()
    before = flash_attention.LAUNCHES
    with torch.inference_mode():
        logits, state = bundle.apply(video)
    torch.cuda.synchronize()
    for hk in hooks:
        hk.remove()
    launches = flash_attention.LAUNCHES - before
    check(tuple(seen) == DUP_COUNTS[:-1] and state.size.shape[1] == DUP_COUNTS[-1], f"dup: token counts {seen}")
    check(launches == DUP_K1_PER_FORWARD, f"dup: {launches} K1 launches in a forward")
    check(tuple(logits.shape) == (8, 400) and bool(torch.isfinite(logits).all()), "dup: logits")
    with torch.inference_mode():
        ms = cuda_ms(lambda: bundle.apply(video), iters=5, warmup=1)
    total = launch_counts()  # read right after the path ran
    check(total["LAUNCHES"] == DUP_K1_PER_FORWARD * (1 + 5 + 1) + DUP_K1_PER_FORWARD,
          f"dup: K1 launches {total['LAUNCHES']}")
    check(all(n == 0 for c, n in total.items() if c != "LAUNCHES"), f"dup: another kernel launched: {total}")
    emit("dup", token_counts=list(DUP_COUNTS), k1_per_forward=DUP_K1_PER_FORWARD, forward_ms=ms,
         launches=total["LAUNCHES"], batch=8, dtype="bfloat16", nvidia_smi=smi)
    return total["LAUNCHES"]


def phase_source(smi: str) -> int:
    """Source tracking: VideoMAE r 150 at B2, bf16, ``bundle.apply(...,
    trace_source=True)``: every entry 0 or 1, each original token in one
    group (columns sum to 1), each group's row summing to its size; one
    spatio-temporal merge-group sheet written through vtm_torch.vis to a
    temporary directory. Returns K1's launches."""
    import tempfile

    zero_launch_counts()  # this path's counts start here
    bundle = build_model(main_cfg("TEST.BATCH_SIZE", "2"), "cuda")
    video = torch.from_numpy(np.random.default_rng(9).random((2, 16, 224, 224, 3), dtype=np.float32)).cuda()
    with torch.inference_mode():
        _, plain = bundle.apply(video)
        logits, state = bundle.apply(video, trace_source=True)
    torch.cuda.synchronize()
    total = launch_counts()  # read right after the path ran
    check(total["LAUNCHES"] == 2 * MERGED_K1_PER_FORWARD and
          all(n == 0 for c, n in total.items() if c != "LAUNCHES"), f"source: launches {total}")
    source = state.source
    check(plain.source is None and source.dtype == torch.bfloat16, "source: traced for one call only")
    check(tuple(source.shape) == (2, MERGED_COUNTS[-1], 1568), f"source: shape {tuple(source.shape)}")
    check(bool(((source == 0) | (source == 1)).all()), "source: an entry other than 0 or 1")
    check(bool((source.float().sum(dim=1) == 1).all()), "source: a token in no group or in two")
    check(torch.equal(source.float().sum(dim=2, keepdim=True), state.size), "source: rows against sizes")
    check(bool(torch.isfinite(logits).all()), "source: logits")
    clip = video[0].float().cpu().numpy()
    frames = np.transpose((clip - clip.min()) / (np.ptp(clip) + 1e-8), (0, 3, 1, 2))
    images, _ = make_spatiotemporal_video_visualization(
        frames, source[0].float().cpu().numpy(), patch_size=(16, 16, 2), class_token=False)
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "videomae_source.png"
        concatenate_images(images, ncols=8, nrows=2).save(path)
        png_bytes = path.stat().st_size
    check(images.shape == (16, 224, 224, 3) and png_bytes > 0, "source: the sheet")
    emit("source", groups=int(source.shape[1]), tokens=int(source.shape[2]),
         largest_group=int(state.size.max()), png_bytes=png_bytes, launches=total["LAUNCHES"],
         batch=2, dtype="bfloat16", nvidia_smi=smi)
    return total["LAUNCHES"]


def fixed_batch(cfg):
    """The first training batch of the synthetic dataset, on the card."""
    batch = next(iter(construct_loader(cfg, "train")))
    return torch.from_numpy(batch["frames"]).cuda(), torch.from_numpy(np.asarray(batch["label"])).cuda()


# Motionformer gradients that are zero analytically: a softmax does not see
# a shift of its logits (the k half of proj_kv's bias), and only the CLS row
# of the last block reaches the head (its trajectory projections).
MF_ZERO_GRADIENTS = ("attn.proj_kv.bias", "blocks.11.attn.proj_q.", "blocks.11.attn.proj_kv.")

# What phase_train drives: the config and its run lists, the counters of the
# forward and backward kernels on that path and their names in the output,
# launches per step, and the parameters that may stay where they were.
VIDEOMAE_TRAIN = dict(
    phase="train", cfg=train_cfg, step_opts=TRAIN_STEP_OPTS, entry_opts=TRAIN_ENTRY_OPTS,
    fwd=("LAUNCHES", "k1"), bwd=("BWD_LAUNCHES", "k2"),
    per_step={"merged": MERGED_K1_PER_FORWARD, "unmerged": 12}, zero_gradients=(),
)
MOTIONFORMER_TRAIN = dict(
    phase="mf_train", cfg=mf_train_cfg, step_opts=MF_TRAIN_STEP_OPTS, entry_opts=MF_TRAIN_ENTRY_OPTS,
    fwd=("FRAME_LAUNCHES", "k3"), bwd=("FRAME_BWD_LAUNCHES", "k4"),
    per_step=MF_K3_PER_FORWARD, zero_gradients=MF_ZERO_GRADIENTS,
)
# SGD with weight decay moves every parameter, the k biases too
TIMESFORMER_TRAIN = dict(
    phase="ts_train", cfg=ts_train_cfg, step_opts=TS_TRAIN_STEP_OPTS, entry_opts=TS_TRAIN_ENTRY_OPTS,
    fwd=("BLOCKDIAG_LAUNCHES", "k5a"), bwd=("BLOCKDIAG_BWD_LAUNCHES", "k5b"),
    per_step=TS_K5_PER_FORWARD, zero_gradients=(), num_frames=8,
    optimizer="sgd(0.005, momentum 0.9, wd 1e-4)",
)
VIVIT_TRAIN = dict(
    phase="vivit_train", cfg=vivit_train_cfg, step_opts=VIVIT_TRAIN_STEP_OPTS, entry_opts=VIVIT_TRAIN_ENTRY_OPTS,
    fwd=("LAUNCHES", "k1"), bwd=("BWD_LAUNCHES", "k2"),
    per_step=VIVIT_K1_PER_FORWARD, zero_gradients=(), num_frames=32,
    optimizer="sgd(0.003125, momentum 0.9, wd 1e-4)", heads=("verb_classifier", "noun_classifier"),
    warmup=VIVIT_TRAIN_WARMUP, iters=VIVIT_TRAIN_ITERS,
)


def phase_train(smi: str, phase, cfg, step_opts, entry_opts, fwd, bwd, per_step, zero_gradients,
                num_frames: int = 16, optimizer: str = "adamw(1e-4, wd 0.05)", heads=("head0", "head1"),
                warmup: int = TRAIN_WARMUP, iters: int = TRAIN_ITERS) -> int:
    """Train steps on one fixed batch, merged and unmerged, then the train
    entry point on the shipped config. The loss is the cross-entropy of
    what the model returns in eval mode (probabilities for a Motionformer
    built from a config, as in its train step). Returns the launches of
    the backward kernel in the whole phase."""
    (fwd, fwd_name), (bwd, bwd_name) = fwd, bwd
    out_dir = TRAIN_OUT / phase
    shutil.rmtree(out_dir, ignore_errors=True)
    runs = {}
    zero_launch_counts()  # this path's counts start here
    for label, opts in (("merged", ()), ("unmerged", ("TOME.ENABLE", "False"))):
        out = str(out_dir / label)
        run_cfg = cfg(*step_opts, "OUTPUT_DIR", out, *opts)
        torch.cuda.reset_peak_memory_stats()
        trainer = build_trainer(run_cfg)
        frames, labels = fixed_batch(run_cfg)
        check(tuple(frames.shape) == (8, num_frames, 224, 224, 3), f"batch shape {tuple(frames.shape)}")
        start = {n: p.detach().clone() for n, p in trainer.module.named_parameters()}
        check(all(p.dtype == torch.float32 for p in start.values()), "training parameters are fp32")
        loss_before = F.cross_entropy(trainer.eval_step(frames), labels).item()
        set_lr(trainer.optimizer, trainer.lr_at(0.0))
        losses = []
        before = launch_counts()

        def step():
            losses.append(trainer.train_step(frames, labels)[0])

        seconds = device_seconds(step, iters, warmup, torch.device("cuda"))
        steps = warmup + iters
        n_fwd, n_bwd = (getattr(flash_attention, c) - before[c] for c in (fwd, bwd))
        check(n_bwd == per_step[label] * steps, f"{phase} {label}: {n_bwd} {bwd_name} launches in {steps} steps")
        check(n_fwd == per_step[label] * steps, f"{phase} {label}: {n_fwd} {fwd_name} launches in {steps} steps")
        loss_after = F.cross_entropy(trainer.eval_step(frames), labels).item()
        step_losses = [l.item() for l in losses]
        check(all(np.isfinite(step_losses)) and np.isfinite(loss_after), f"{phase} {label}: loss not finite")
        check(loss_after < loss_before, f"{phase} {label}: loss {loss_before} -> {loss_after}")
        still = []
        for n, p in trainer.module.named_parameters():
            check(bool(torch.isfinite(p).all()), f"{phase} {label}: {n} is not finite")
            if torch.equal(p, start[n]):
                still.append(n)
        check(all(any(z in n for z in zero_gradients) for n in still),
              f"{phase} {label}: parameters that did not change: {still}")
        run = {"train_clips_per_sec": 8 * iters / seconds, "step_ms": seconds / iters * 1e3,
               "loss_before": loss_before, "loss_after": loss_after, "step_losses": step_losses,
               f"{fwd_name}_launches_per_step": n_fwd // steps, f"{bwd_name}_launches_per_step": n_bwd // steps,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        if label == "merged":
            # a checkpoint saved and reloaded gives the same next losses: the
            # first shows the parameters came back, the second the moments
            path = checkpoints.save_checkpoint(out, trainer.module, trainer.optimizer, 0, run_cfg)
            twin = build_trainer(run_cfg)
            epoch, restored = checkpoints.load_checkpoint(
                checkpoints.get_last_checkpoint(out), twin.module, twin.optimizer)
            check((epoch, restored) == (0, True), f"checkpoint {path}: epoch {epoch}, optimizer {restored}")
            nxt = [[t.train_step(frames, labels)[0].item() for _ in range(2)] for t in (trainer, twin)]
            check(nxt[0][0] == nxt[1][0], f"{phase}: next loss after reload {nxt[1][0]} != {nxt[0][0]}")
            check(abs(nxt[0][1] - nxt[1][1]) <= 1e-3 * abs(nxt[0][1]),
                  f"{phase}: second loss after reload {nxt[1][1]} != {nxt[0][1]}")
            run["next_losses"], run["next_losses_reloaded"] = nxt
            del twin
            shutil.rmtree(out)  # a ViT-B checkpoint with its moments is over 1 GB
        runs[label] = run
        del trainer
        torch.cuda.empty_cache()

    # the entry point itself, on the config as shipped: two epochs of two steps
    out = str(out_dir / "entry")
    entry_cfg = cfg(*entry_opts, "OUTPUT_DIR", out)
    before = launch_counts()
    t0 = time.perf_counter()
    module = train(entry_cfg)
    torch.cuda.synchronize()
    entry_seconds = time.perf_counter() - t0
    n_fwd, n_bwd = (getattr(flash_attention, c) - before[c] for c in (fwd, bwd))
    # 4 train steps; the eval epoch's 2 forwards launch the forward kernel only
    check(n_bwd == 4 * per_step["merged"], f"{phase} entry point: {n_bwd} {bwd_name} launches")
    check(n_fwd == 6 * per_step["merged"], f"{phase} entry point: {n_fwd} {fwd_name} launches")
    check(module.config.multi_head and [getattr(module, h).out_features for h in heads] == [97, 300],
          f"{phase} entry point: twin heads")
    check(all(bool(torch.isfinite(p).all()) for p in module.parameters()), f"{phase} entry point: NaN")
    last = checkpoints.get_last_checkpoint(out)
    check(last is not None and last.endswith("epoch_00001.pyth"), f"{phase} entry point: checkpoint {last}")
    total = launch_counts()  # read right after the path ran
    check(total[bwd] > 0 and total[fwd] > 0, f"the {phase} path launched its kernels")
    check(all(n == 0 for c, n in total.items() if c not in (fwd, bwd)),
          f"the {phase} path launched another path's kernels: {total}")
    shutil.rmtree(out_dir, ignore_errors=True)
    emit(
        phase,
        merged=runs["merged"],
        unmerged=runs["unmerged"],
        speedup=runs["merged"]["train_clips_per_sec"] / runs["unmerged"]["train_clips_per_sec"],
        entry_point={"seconds": entry_seconds, f"{fwd_name}_launches": n_fwd, f"{bwd_name}_launches": n_bwd,
                     "epochs": 2, "steps": 4},
        batch=8, dtype="bfloat16 compute, float32 parameters", optimizer=optimizer,
        nvidia_smi=smi,
    )
    return total[bwd]


# The A/B kernels: id -> (source, the TPU kernel's call site, the mode whose
# numbers stand on the ``kernels`` line; every mode is on the ab_kernels line).
AB_KERNELS = {
    "T1": ("ab_chain.cu", "tools/ab_bisect.py:37", "per-batch bias"),
    "T2": ("ab_qk_probe.cu", "tools/ab_mxu_pack.py:84", ""),
    "T3": ("ab_qk_probe.cu", "tools/ab_mxu_pack.py:116", ""),
    "T4": ("ab_dense_variants.cu", "tools/ab_mxu_pack.py:203", "unbiased"),
    "T5": ("ab_chain.cu", "tools/ab_b32.py:51", ""),
    "T6": ("ab_qk_probe.cu", "tools/ab_decomp.py:69", ""),
    "T7": ("ab_qk_probe.cu", "tools/ab_decomp.py:97", ""),
    "T8": ("ab_chain.cu", "tools/ab_decomp.py:144", "full"),
    "T9": ("ab_chain.cu", "tools/ab_decomp.py:248", "1d"),
    "T10": ("ab_chain.cu", "tools/ab_decomp.py:324", ""),
    "T11": ("ab_dense_variants.cu", "tools/ab_dense_v2.py:156", "v2_sum, unbiased"),
    "T12": ("ab_chain.cu", "tools/ab_block_attn.py:110", ""),
}


# ab_chain.cu's instances of the Hopper tile loop, (kernel, biased, policy):
# K1's unbiased (T5, T12, T8 full) and biased (T1, T9 1d) ones, T8 linear's
# and nosmax's, T9 2d's, and T10's (K1's biased one under an occupancy
# target). Each must build without spills, in at most 128 registers, and fit
# 4 blocks an SM.
AB_CHAIN_HOPPER_INSTANCES = {
    ("ab_attention_wgmma", 0, "Softmax"), ("ab_attention_wgmma", 1, "Softmax"),
    ("ab_attention_wgmma", 0, "LinearChain"), ("ab_attention_wgmma", 0, "NoSoftmax"),
    ("ab_attention_wgmma", 1, "StagedBias"), ("ab_attention_hinted_wgmma", 1, "Softmax")}
AB_CHAIN_BLOCKS_PER_SM = 4
# ab_qk_probe.cu's bf16 instances of ab_qk_probe_wgmma<depth, rowsum>: T2,
# T6 at depth 64, T3, T7 at 128
AB_QK_PROBE_INSTANCES = {(64, 0), (64, 1), (128, 0), (128, 1)}


def phase_ab_kernels(smi: str) -> dict:
    """T1-T12, every mode (``ab_dense.exp_kernels``, by the entry point's
    own rule): against the plain version in fp32 at a small ragged shape
    and in bf16 at B8 H12 d64, then timed at the bf16 shape, twice 20 calls
    in turns with the plain version (5 calls) and the one PyTorch call that
    computes the same function (SDPA, or an einsum for the four probes),
    and by device time (``kernel_times.device_ms``, 20 calls, twice); then
    T5's, T12's, T8 ``full``'s, T1's, T9's (both modes) and T10's bf16
    bits against K1's (``ab_dense.k1_bits``); ptxas's figures and the
    occupancy of ab_chain.cu's and ab_qk_probe.cu's Hopper kernels.
    Returns the ``kernels`` line's numbers per T id."""
    device = torch.device("cuda")
    bench = ab_dense.Bench(device, ab_dense.Sizes(), 0, 2, 20)
    with contextlib.redirect_stdout(io.StringIO()):
        small = {(r["function"], r.get("mode", "")): r for r in ab_dense.exp_kernels(
            ab_dense.Bench(device, ab_dense.SMALL_SIZES, 0, 1, 1, dtype=torch.float32))}
        full = ab_dense.exp_kernels(bench)
    k1_bits = ab_dense.k1_bits(bench)  # raises unless T1's, T5's, T8 full's, T9's, T10's and T12's bf16 bits are K1's
    by_id = {}
    for row in full:
        tid, mode = row["kernel"], row.get("mode", "")
        fp32 = small[row["function"], mode]
        row.update(ms=row["ms"]["median"], fp32_small_rel_err=fp32["rel_err_vs_fp32ref"],
                   library_ms=row.get("library_ms"), **bound(row.get("bound_flops", row["flops"]), row["nbytes"]))
        if "bound_flops" in row:
            row["product_bound_ms"] = row["flops"] / PEAK_BF16_FLOPS * 1e3
        if "issued_flops" in row:
            row["issued_product_ms"] = row["issued_flops"] / PEAK_BF16_FLOPS * 1e3
        if "cancelled_rows" in row:
            row["cancelled_rows_fp32_small"] = fp32["cancelled_rows"]
        if mode == AB_KERNELS[tid][2]:
            by_id[tid] = dict(
                mode=mode, function=row["function"],
                max_abs_err=max(row["max_abs_err_vs_plain"], fp32["max_abs_err_vs_plain"]),
                ms=row["ms"], device_ms=row["device_ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=row["library_ms"])
    check(set(by_id) == set(AB_KERNELS), f"ab_kernels: ids checked {sorted(by_id)}")
    resources = {source: kernel_build.kernel_resources(source)
                 for source in ("ab_chain.cu", "ab_dense_variants.cu", "ab_qk_probe.cu")}
    hopper = [r for r in resources["ab_chain.cu"] if r["kernel"].endswith("_wgmma")]
    check({(r["kernel"], r["template_args"][0], r.get("policy")) for r in hopper} == AB_CHAIN_HOPPER_INSTANCES
          and not any(r.get("spill_store_bytes", 0) or r.get("spill_load_bytes", 0) for r in hopper)
          and all(r["registers"] <= 128 for r in hopper),
          f"ab_kernels: ab_chain.cu's Hopper instances {hopper}")
    # every variant's bf16 kernel: blocks an SM by the runtime's calculator,
    # at the shared bytes the wrapper mirrors
    occupancy = {code: ab_attention.chain_occupancy(torch.bfloat16, code) for code in ab_attention.CHAIN_CODES}
    check(all(blocks == AB_CHAIN_BLOCKS_PER_SM and nbytes == ab_attention.chain_smem_bytes(code)
              for code, (blocks, nbytes) in occupancy.items()),
          f"ab_kernels: ab_chain.cu's bf16 (blocks an SM, shared bytes) by variant {occupancy}")
    probes = [r for r in resources["ab_qk_probe.cu"] if r["kernel"] == "ab_qk_probe_wgmma"]
    check(sorted(tuple(r["template_args"]) for r in probes) == sorted(AB_QK_PROBE_INSTANCES)
          and not any(r.get("spill_store_bytes", 0) or r.get("spill_load_bytes", 0) for r in probes),
          f"ab_kernels: ab_qk_probe.cu's Hopper instances {probes}")
    # each probe kernel: the blocks an SM its shared memory allows, by the
    # runtime's calculator (so the registers allow them too)
    probe_occupancy = {(depth, rowsum): ab_attention.probe_occupancy(depth, bool(rowsum))
                       for depth, rowsum in sorted(AB_QK_PROBE_INSTANCES)}
    check(all((blocks, nbytes) == (ab_attention.PROBE_TILING[depth]["blocks_per_sm"],
                                   ab_attention.PROBE_TILING[depth]["smem_bytes"])
              for (depth, _), (blocks, nbytes) in probe_occupancy.items()),
          f"ab_kernels: ab_qk_probe.cu's (blocks an SM, shared bytes) by (depth, rowsum) {probe_occupancy}")
    emit("ab_kernels", cases=full, fp32_shape=dataclasses.asdict(ab_dense.SMALL_SIZES),
         bf16_shape=dataclasses.asdict(ab_dense.Sizes()), k1_bits=k1_bits, resources=resources,
         chain_occupancy={code: dict(blocks_per_sm=b, smem_bytes=s) for code, (b, s) in occupancy.items()},
         probe_occupancy={f"depth {d}, rowsum {r}": dict(blocks_per_sm=b, smem_bytes=nbytes,
                                                         row_tiles=ab_attention.PROBE_TILING[d]["row_tiles"],
                                                         stages=ab_attention.PROBE_TILING[d]["stages"])
                          for (d, r), (b, nbytes) in probe_occupancy.items()},
         nvidia_smi=smi)
    return by_id


def phase_ab_dense() -> dict:
    """The A/B entry point as a user runs it, every experiment once (each
    row is held against its plain version as it is printed). Returns the
    launches per function, and K1's under ``"K1"``."""
    zero_launch_counts()  # this path's counts start here
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        ab_dense.main(["--exp", "all", "--reps", "1", "--iters", "3"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ab_attention.AB_LAUNCHES, K1=flash_attention.LAUNCHES)  # read right after the path ran
    total = launch_counts()
    rows = [json.loads(line) for line in out.getvalue().splitlines()]
    check({r["exp"] for r in rows} == set(ab_dense.EXPERIMENTS), "ab_dense: an experiment printed no row")
    worst = {}
    for r in rows:
        check(r["ms"]["median"] > 0 and r["device"] == torch.cuda.get_device_name(0), f"ab_dense: row {r}")
        if "kernel" in r:
            check(r["rel_err_vs_fp32ref"] <= r["tol"], f"ab_dense: {r['exp']} {r['name']}: {r}")
            worst[r["kernel"]] = max(worst.get(r["kernel"], 0.0), r["err_vs_plain"])
    check(set(worst) == set(AB_KERNELS) | {"K1"}, f"ab_dense: kernels with a row: {sorted(worst)}")
    check(all(n > 0 for n in launches.values()), f"the A/B entry point launched no kernel of: {launches}")
    check(all(n == 0 for c, n in total.items() if c != "LAUNCHES"),
          f"the A/B entry point launched another path's kernels: {total}")
    medians = {exp: {r["name"]: r["ms"]["median"] for r in rows if r["exp"] == exp} for exp in ab_dense.EXPERIMENTS}
    cancelled = [r["cancelled_rows"] for r in rows if "cancelled_rows" in r]
    emit("ab_dense", seconds=seconds, rows=len(rows), launches=launches, worst_err_vs_plain=worst,
         cancelled_rows=cancelled, ms=medians)
    return launches


def kernel_row(name: str, source: str, replaces: str, launches: int, r: dict) -> dict:
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                max_abs_err=r["max_abs_err"], ms=r["ms"], device_ms=r["device_ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"])


def main() -> int:
    t0 = time.perf_counter()
    smi = phase_device()
    # full fp32 for every fp32 product and convolution (the block checks)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    kernel = phase_dense_kernel(smi)
    bwd_kernel = phase_bwd_kernel(smi)
    frame_kernel = phase_kernel(
        "frame_kernel",
        smi,
        functools.partial(tome_frame_attention, frames=MF_FRAMES),
        functools.partial(_frame_reference, frames=MF_FRAMES),
        frame_sdpa,
        FRAME_SHAPES,
        FRAME_TIMED,
        out_factor=MF_FRAMES,
    )
    frame_bwd_kernel = phase_frame_bwd_kernel(smi)
    blockdiag_kernel = phase_blockdiag_kernel(smi)
    blockdiag_bwd_kernel = phase_blockdiag_bwd_kernel(smi)
    ab_kernels = phase_ab_kernels(smi)
    fp32_b2 = ("TPU.COMPUTE_DTYPE", "float32", "TEST.BATCH_SIZE", "2")
    phase_blocks("blocks", main_cfg(*fp32_b2), 1, {}, lambda: flash_attention.LAUNCHES,
                 MERGED_COUNTS[-1], MERGED_K1_PER_FORWARD)
    phase_blocks("mf_blocks", mf_cfg(*fp32_b2), 4, {"num_frames": MF_FRAMES},
                 lambda: flash_attention.FRAME_LAUNCHES, MF_BODY_COUNTS[-1] + 1,
                 MF_K3_PER_FORWARD["merged"])
    phase_train_blocks("train_blocks", main_cfg(*fp32_b2), "LAUNCHES", "BWD_LAUNCHES",
                       MERGED_K1_PER_FORWARD, MERGED_COUNTS[-1])
    phase_train_blocks("mf_train_blocks", mf_cfg(*fp32_b2), "FRAME_LAUNCHES", "FRAME_BWD_LAUNCHES",
                       MF_K3_PER_FORWARD["merged"], MF_BODY_COUNTS[-1] // MF_FRAMES, train_mode=True,
                       zero_gradients=MF_ZERO_GRADIENTS)
    phase_blocks("ts_blocks", ts_cfg(*fp32_b2), 14, {"b": 2, "t": TS_FRAMES},
                 lambda: flash_attention.BLOCKDIAG_LAUNCHES, 1 + TS_FRAMES * TS_PATCH_COUNTS[-1],
                 TS_K5_PER_FORWARD["merged"], frames=TS_FRAMES)
    phase_train_blocks("ts_train_blocks", ts_cfg(*fp32_b2), "BLOCKDIAG_LAUNCHES", "BLOCKDIAG_BWD_LAUNCHES",
                       TS_K5_PER_FORWARD["merged"], TS_PATCH_COUNTS[-1], zero_gradients=TS_ZERO_GRADIENTS,
                       frames=TS_FRAMES)
    vivit_modules = dict(frames=32, blocks="layer", attn="attention")
    phase_blocks("vivit_blocks", vivit_cfg(*fp32_b2), 17, {}, lambda: flash_attention.LAUNCHES,
                 VIVIT_COUNTS[-1], VIVIT_K1_PER_FORWARD["merged"], **vivit_modules)
    phase_train_blocks("vivit_train_blocks", vivit_cfg(*fp32_b2), "LAUNCHES", "BWD_LAUNCHES",
                       VIVIT_K1_PER_FORWARD["merged"], VIVIT_COUNTS[-1],
                       zero_gradients=VIVIT_ZERO_GRADIENTS, grad_groups=VIVIT_GRAD_GROUPS, **vivit_modules)
    # model_benchmark falls back to the last checkpoint of its OUTPUT_DIR, ".":
    # there must be none, or the serve phases would not run the seeded weights
    check(checkpoints.get_last_checkpoint(".") is None, "a checkpoint under ./checkpoints")
    launches = phase_serve(smi)
    frame_launches = phase_mf_serve(smi)
    blockdiag_launches = phase_family_serve(
        "ts_serve", smi, ts_cfg, TS_FRAMES, 15, "BLOCKDIAG_LAUNCHES", "blockdiag_attention_kernel_launches",
        TS_K5_PER_FORWARD, TS_PATCH_COUNTS, lambda n: (n - 1) // TS_FRAMES, lambda m: m.blocks,
        TS_FLOP_CEILING)
    launches += phase_family_serve(
        "vivit_serve", smi, vivit_cfg, 32, 16, "LAUNCHES", "attention_kernel_launches",
        VIVIT_K1_PER_FORWARD, VIVIT_COUNTS, lambda n: n, lambda m: m.layer, VIVIT_FLOP_CEILING)
    launches += phase_eval("eval", smi, main_cfg, EVAL_OPTS, "LAUNCHES", MERGED_K1_PER_FORWARD,
                           ("top1_acc", "top5_acc"))
    frame_launches += phase_eval("mf_eval", smi, mf_train_cfg, MF_EVAL_OPTS, "FRAME_LAUNCHES",
                                 MF_K3_PER_FORWARD["merged"],
                                 [f"{t}_top{k}_acc" for t in ("verb", "noun", "action") for k in (1, 5)])
    variants = phase_variants(smi)
    launches += variants["LAUNCHES"]
    frame_launches += variants["FRAME_LAUNCHES"]
    blockdiag_launches += variants["BLOCKDIAG_LAUNCHES"]
    launches += phase_dup(smi)
    launches += phase_source(smi)
    bwd_launches = phase_train(smi, **VIDEOMAE_TRAIN)
    frame_bwd_launches = phase_train(smi, **MOTIONFORMER_TRAIN)
    blockdiag_bwd_launches = phase_train(smi, **TIMESFORMER_TRAIN)
    bwd_launches += phase_train(smi, **VIVIT_TRAIN)
    ab_launches = phase_ab_dense()
    launches += ab_launches["K1"]  # the prod rows
    emit("done", seconds=time.perf_counter() - t0)
    csrc = "vtm_torch/ops/csrc/"
    print(json.dumps({"kernels": [
        kernel_row("tome_flash_attention", csrc + "flash_attention_fwd.cu",
                   "vtm/ops/flash_attention.py:269", launches, kernel),
        kernel_row("tome_flash_attention_backward", csrc + "flash_attention_bwd.cu",
                   "vtm/ops/flash_attention.py:505", bwd_launches, bwd_kernel),
        kernel_row("tome_frame_attention", csrc + "frame_attention_fwd.cu",
                   "vtm/ops/flash_attention.py:915", frame_launches, frame_kernel),
        kernel_row("tome_frame_attention_backward", csrc + "frame_attention_bwd.cu",
                   "vtm/ops/flash_attention.py:1231", frame_bwd_launches, frame_bwd_kernel),
        kernel_row("tome_blockdiag_attention", csrc + "blockdiag_attention_fwd.cu",
                   "vtm/ops/flash_attention.py:1463", blockdiag_launches, blockdiag_kernel),
        kernel_row("tome_blockdiag_attention_backward", csrc + "blockdiag_attention_bwd.cu",
                   "vtm/ops/flash_attention.py:1578", blockdiag_bwd_launches, blockdiag_bwd_kernel),
    ] + [
        dict(kernel_row(r["function"], csrc + source, replaces, ab_launches[r["function"]], r), id=tid, mode=r["mode"])
        for tid, (source, replaces, _) in AB_KERNELS.items() for r in (ab_kernels[tid],)
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
