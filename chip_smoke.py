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
     mf_divided -- Motionformer with divided space-time attention: a B8
                  bf16 serving forward merged at r 18 equals the unmerged
                  one bit for bit (divided blocks never merge), clips/s;
                  four train steps (fp32 parameters, AdamW) with nonzero
                  gradients into every timeattn and norm3 parameter; two
                  teacher-forced fp32 B1 blocks, card against the port on
                  the CPU. No kernel launches.
     mf_approx -- Motionformer's trajectory attention with each
                  approximate spatial step (nystrom, orthoformer,
                  performer; 128 landmarks), merged and unmerged: clips/s,
                  body token counts, which blocks' outputs are finite; one
                  teacher-forced fp32 B1 block each, card against CPU
                  (Performer given one projection, Orthoformer's landmarks
                  compared), and bf16 against fp32 on the card. K3 is not
                  launched.
     videomae_options -- VideoMAE merged at r 150 with class pooling and
                  with layer scale (init_values 0.1): clips/s, token counts,
                  K1 9 a forward, teacher-forced blocks kernel path against
                  plain path; model_benchmark with TRACE_DIR, whose Chrome
                  trace must hold K1's kernels with device time
     slowfast  -- the conv families (SlowFast, ResNet, X3D; no attention
                  kernel), fp32: SlowFast 8x8 R50 (``SLOWFAST_OPTS``: the
                  values of configs/slowfast/kinetics/SLOWFAST_8x8_R50.yaml)
                  at full width with its BatchNorms moved off their init
                  (each block's final one about 1, then about 0.2), a B2
                  eval forward on the card (fp32 with TF32 off and on, fp64)
                  and the CPU (fp32), each against the CPU's fp64: the
                  card's fp32 error at most 4 times the CPU's, and within
                  SF_CPU_TOL of the CPU's fp32 where the CPU's own error
                  allows that comparison; model_benchmark at B8 on
                  32 x 256 clips, TF32 off and on; test_net.test on 8
                  synthetic videos x 10 views x 3 crops; 4 train steps at B8
                  with dropout 0.5 (the loss falls), where one step's
                  device time goes (torch.profiler, TF32 off and on, by
                  kind of kernel), precise BN over 2 batches, a checkpoint that reloads to the same next loss
                  (cuDNN deterministic); two gloo ranks sharing the card, 4
                  clips each, BatchNorm statistics over the global batch,
                  and the one-process B8 step against the step in fp64
                  (the ranks' error at most 4 times the one process's);
                  small I3D (non-local)
                  and X3D-XS eval forwards checked as SlowFast's. Asserts that
                  no K1-K5b (nor T1-T12) launched, the ranks' included
     ptv       -- the PTV families, fp32: CSN 32x2 R101 and R(2+1)D 16x4
                  R50 (``CSN_OPTS``, ``R2PLUS1D_OPTS``: what the names of
                  PySlowFast's pytorchvideo configs fix) at full width, the
                  card against the CPU at B1 / B2 (TF32 off, BatchNorms
                  moved); perform_benchmark at B8 on 224, TF32 off and on;
                  CSN's depthwise conv_b timed forward and weight gradient
                  beside its bound; 3 train steps at B8 with BN.NORM_TYPE
                  sub_batchnorm, 2 splits (every split statistic moves, the
                  fold into the eval statistics holds, a reload gives the
                  same next loss). No K1-K5b
     multigrid -- train_net.train under the long cycle on R(2+1)D (the
                  schedule squeezed to one epoch a shape: B16 T4 S158, B8
                  T8 S158, B4 T8 S224, B2 T16 S224), each epoch's batches
                  the schedule's, its BatchNorm splits its NORM_TYPE's,
                  parameters and optimizer state the same bits across each
                  flip; the short cycle on SlowFast (B8 at 112, B4 at 158,
                  B2 at 224). A line an epoch. No K1-K5b
     charades  -- multi-label R(2+1)D (157 classes, bce_logit) on a
                  Charades frame-list set written under build/: one epoch of
                  train_net.train with the val mAP, then test_net.test over
                  2 views x 3 crops, the mAP finite in [0, 1]. No K1-K5b
     mvit      -- MViTv2-S (``MVITV2_S_OPTS``: what
                  configs/Kinetics/MVITv2_S_16x4.yaml of PySlowFast fixes) at
                  full width: the card against the CPU at B1 in fp32 (TF32
                  off); perform_benchmark at B8 in bf16; the 48 depthwise
                  pooling convs of a forward timed (forward, input and weight
                  gradients, by CUDA events, beside their bound) with their
                  share of the serve forward and of a train step, and where
                  each one's device time goes (torch.profiler); 3 train steps
                  at B8 with drop path 0.2 (the loss finite), a checkpoint
                  that reloads to the same next loss; train_net.train for one
                  epoch of 16 synthetic clips; one step with
                  MODEL.ACT_CHECKPOINT against the plain stack (cuDNN
                  deterministic): loss and every gradient bit for bit, a
                  lower peak; test_net.test over 2 views; PTVMViT built.
                  No K1-K5b
     mvit_rev  -- Rev-MViT-B (``REV_MVIT_B_OPTS``: configs/Kinetics/
                  REV_MVIT_B_16x4_CONV.yaml) at full width: perform_benchmark
                  at B8 in bf16, the card against the CPU at B1, and a B8
                  step through the reversible backward against plain
                  autograd on the same masks, fp32 and bf16: the loss bit for
                  bit, each parameter group's largest gradient error, both
                  peaks (the reversible one lower). No K1-K5b
     maskfeat  -- MaskFeat on MViTv2-S (``MASKFEAT_OPTS``: HOG targets
                  at block 15, the loader's 3-D block masks over 40% of an
                  8 x 7 x 7 window) at full width: the card against the CPU
                  at B1 in fp32 (predictions, masks); 3 bf16 AdamW steps at
                  B8 with the HOG targets made on the card (losses, ms a
                  step, clips/s, the targets' ms, peak), a checkpoint that
                  reloads to the same next loss, train_net.train for one
                  epoch of 16 clips; the HOG targets of the batch on the
                  card against the CPU's (no bin may differ); the 48
                  pooling convs' share of a step. No K1-K5b
     mae       -- MAE on ViT-B (``MAE_VIT_B_OPTS``: 1568 tokens, 156 kept,
                  a decoder of 4 blocks 512 wide): the card against the CPU
                  at B1 in fp32 under the same injected noise; the training
                  of maskfeat with the noise from each step's generator;
                  mae_visualize of one batch, every visible patch of the
                  reconstruction the input's. No K1-K5b
     contrastive -- contrastive pretraining on Slow R50 8x8 at 224, fp32
                  (``CONTRASTIVE_MOCO_OPTS``, ``CONTRASTIVE_BYOL_OPTS``: the
                  shape of PySlowFast's contrastive_ssl Slow R50 recipes):
                  one MoCo step at B2, the card against the CPU (loss,
                  positive and negative logits, the queue rows written, ptr,
                  the momentum encoder's parameters and statistics); 3 MoCo
                  steps (a 65536-key queue, a 239975-row kNN bank) and 3
                  BYOL steps under LARS at B8 (ms a step, videos/s, peak;
                  ptr, the momentum encoder bit for bit against its formula,
                  one LARS update against its formula), where a MoCo step's
                  device time goes; SimCLR, SwAV (its gate, queue and flag)
                  and mem (only the batch's bank rows change) at B4;
                  MViTv2-S with the MLP head under SimCLR at B2;
                  train_net.train of MoCo for 2 epochs of 16 clips (the
                  queue warm-up, the kNN eval, a checkpoint, an auto-resume
                  equal to the uninterrupted run bit for bit: every later
                  loss and the final state; the stems' max pool has a
                  deterministic backward). No K1-K5b
     ava       -- AVA spatio-temporal action detection on SlowFast 32x2
                  R50 with the ROI head (``AVA_OPTS``: the shape of
                  PySlowFast's configs/AVA/SLOWFAST_32x2_R50_SHORT.yaml),
                  fp32, on an AVA tree the phase writes under build/
                  (``write_ava``: frame lists, 256 x 340 JPEGs, ground
                  truth, predicted boxes, a 60-of-80 labelmap, an excluded
                  keyframe): a B2 test batch's box scores and pooled ROI
                  features, card against the CPU's fp64 (at most 4 times
                  the CPU's fp32 error); B8 keyframes of 224 x 297 served
                  with TF32 off and on (keyframes/s; the backbone's and the
                  ROI head's device ms by torch.profiler); 3 train steps at
                  B8 with dropout 0.5 from each step's generator (ms,
                  keyframes/s, peak) and a checkpoint reload to the same
                  next loss; test_net.test over the tree (a row a loaded
                  box, the excluded keyframe out of the scoring,
                  detections_latest.csv, the frame mAP in [0, 1]); one epoch
                  of train_net.train with its val pass; MViTv2-S with the
                  ROI head at 1/32, card against CPU. No K1-K5b or T1-T12
     vis       -- the visualisation and demo tail (vtm_torch/vis; tools
                  demo_net, ava_demo_precomputed_boxes, benchmark): Grad-CAM
                  at block 5 of VideoMAE ViT-B merged at r 150 (fp32, B2),
                  through K1 (9 launches) and K2 (3, blocks 6-8) against the
                  same map through the plain versions on the card, the plain
                  run's Matchings put in place (the layers whose own
                  Matching differed are reported), within VIS_CAM_TOL;
                  Grad-CAM at s5 of SlowFast 8x8 R50, card against CPU;
                  demo_net on VideoMAE ViT-B (bf16) over a 64-frame video
                  with the threaded manager and two spawned drawing workers
                  (K1 9 a clip, every frame written and read back); the AVA
                  demo on write_ava's first video with the ROI head on
                  SlowFast 32x2 R50 (no K1-K5b); the loader benchmark over
                  32 Kinetics videos written with cv2 and over the
                  synthetic set (batches/s, clips/s). Matplotlib (the
                  overlay, the figures) is not on the card's machine: those
                  run in the CPU tests only
     dist      -- the parallel paths (vtm_torch/parallel) at ViT-B width,
                  bf16, B8, each against the same run in this process: NCCL
                  at world size 1, train_net's DDP step on the EPIC config
                  equal to the one-process step bit for bit (loss, every
                  gradient, every parameter; cuDNN's deterministic
                  algorithms on both sides); then two ranks sharing the card
                  over gloo (NCCL refuses two ranks on one GPU): a
                  data-parallel train step of merged VideoMAE, 4 clips a
                  rank, against the one-process B8 step; tensor-parallel
                  (2 ways) merged VideoMAE at r 150 and ViViT at r 300
                  serving: logits, per-layer token counts, the same
                  Matchings on both ranks, K1 9 (ViViT: 10, biased) a
                  forward a rank at 6 heads; test_net.test on two data
                  ranks, stats equal to one process's. One JSON line a
                  check, with seconds; the ranks' launches count in the
                  kernels line
     tp        -- tensor parallelism (2 gloo ranks, one model group,
                  probes run in dist's launch): TimeSformer, Motionformer
                  (merged and unmerged) and MViTv2-S serving at B8 bf16
                  against one process (logits, Matchings, K5a 12 and K3
                  10 / 12 a rank at 6 heads); one bf16 B4 train step each,
                  every leaf's gradient against one process's fp32 one
                  within twice one process's bf16 error, the parameters
                  one process's optimizer step on those gradients;
                  LOG_MODEL_INFO of VideoMAE ViT-B, card GFLOP = CPU
     ab_dense  -- the A/B entry point (vtm_torch.tools.ab_dense --exp all,
                  one repeat of three calls a row): every row checked
                  against its plain version as it is printed, all twelve
                  launched
Each serve, eval, train, dist, tp or vis phase, and ab_dense, sets the kernels' launch counts
to 0 just before it and reads them just after (dist adds its spawned ranks'). Then a ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": ...}``. Any failure raises and the script exits
nonzero without the last line.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
import functools
import hashlib
import io
import json
import math
import pathlib
import pickle
import random
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from vtm_torch.checkpoints import checkpoint as checkpoints
from vtm_torch.config import get_cfg
from vtm_torch.data import construct_loader, masking
from vtm_torch.eval import ava_eval
from vtm_torch.merge import MergePolicy, MergeState
from vtm_torch.merge import bipartite as merge_bipartite
from vtm_torch.models import build_model
from vtm_torch.models import contrastive, convnet, motionformer_approx
from vtm_torch.models import masked as masked_model
from vtm_torch.models import mvit as mvit_model
from vtm_torch.models.common import _FLASH_MAX_SEQ, _FLASH_MIN_SEQ, split_heads
from vtm_torch.models.videomae import VideoMAE
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
from vtm_torch.parallel import probes
from vtm_torch.parallel.launch import launch_job
from vtm_torch.tools import ab_dense
from vtm_torch.tools.kernel_times import FWD_DIGEST_CASES, device_ms, forward_digests
from vtm_torch.train.lr_policy import get_lr_at_epoch
from vtm_torch.utils import model_info
from vtm_torch.tools import test_net
from vtm_torch.tools.model_benchmark import model_benchmark, perform_benchmark
from vtm_torch.tools import train_net
from vtm_torch.tools.train_net import build_trainer, refresh_bn_stats, train
from vtm_torch.train import optimizer as train_optimizer
from vtm_torch.train.optimizer import construct_optimizer, set_lr
from vtm_torch.train.train_step import make_contrastive_train_step
from vtm_torch.utils.benchmark import device_seconds
from vtm_torch.vis import concatenate_images, make_spatiotemporal_video_visualization
from vtm_torch.vis.gradcam import GradCAM
from vtm_torch.vis.mae_vis import mae_visualize

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

# configs/slowfast/kinetics/SLOWFAST_8x8_R50.yaml, key by key.
SLOWFAST_OPTS = [
    "TRAIN.ENABLE", "True",
    "TRAIN.DATASET", "kinetics",
    "TRAIN.BATCH_SIZE", "64",
    "TRAIN.EVAL_PERIOD", "10",
    "TRAIN.CHECKPOINT_PERIOD", "5",
    "TRAIN.AUTO_RESUME", "True",
    "DATA.PATH_TO_DATA_DIR", "<KINETICS-400-ANNOTATIONS>",
    "DATA.NUM_FRAMES", "32",
    "DATA.SAMPLING_RATE", "2",
    "DATA.TRAIN_JITTER_SCALES", "[256, 320]",
    "DATA.TRAIN_CROP_SIZE", "224",
    "DATA.TEST_CROP_SIZE", "256",
    "DATA.INPUT_CHANNEL_NUM", "[3, 3]",
    "SLOWFAST.ALPHA", "4",
    "SLOWFAST.BETA_INV", "8",
    "SLOWFAST.FUSION_CONV_CHANNEL_RATIO", "2",
    "SLOWFAST.FUSION_KERNEL_SZ", "7",
    "RESNET.ZERO_INIT_FINAL_BN", "True",
    "RESNET.WIDTH_PER_GROUP", "64",
    "RESNET.NUM_GROUPS", "1",
    "RESNET.DEPTH", "50",
    "RESNET.TRANS_FUNC", "bottleneck_transform",
    "RESNET.STRIDE_1X1", "False",
    "RESNET.NUM_BLOCK_TEMP_KERNEL", "[[3, 3], [4, 4], [6, 6], [3, 3]]",
    "RESNET.SPATIAL_STRIDES", "[[1, 1], [2, 2], [2, 2], [2, 2]]",
    "RESNET.SPATIAL_DILATIONS", "[[1, 1], [1, 1], [1, 1], [1, 1]]",
    "NONLOCAL.LOCATION", "[[[], []], [[], []], [[], []], [[], []]]",
    "NONLOCAL.GROUP", "[[1, 1], [1, 1], [1, 1], [1, 1]]",
    "NONLOCAL.INSTANTIATION", "dot_product",
    "BN.USE_PRECISE_STATS", "True",
    "BN.NUM_BATCHES_PRECISE", "200",
    "SOLVER.BASE_LR", "0.8",
    "SOLVER.LR_POLICY", "cosine",
    "SOLVER.MAX_EPOCH", "196",
    "SOLVER.MOMENTUM", "0.9",
    "SOLVER.WEIGHT_DECAY", "'1e-4'",  # PyYAML reads the yaml's 1e-4 as a string
    "SOLVER.WARMUP_EPOCHS", "34.0",
    "SOLVER.WARMUP_START_LR", "0.01",
    "SOLVER.OPTIMIZING_METHOD", "sgd",
    "MODEL.MODEL_NAME", "SlowFast",
    "MODEL.NUM_CLASSES", "400",
    "MODEL.ARCH", "slowfast",
    "MODEL.LOSS_FUNC", "cross_entropy",
    "MODEL.DROPOUT_RATE", "0.5",
    "TEST.ENABLE", "True",
    "TEST.DATASET", "kinetics",
    "TEST.BATCH_SIZE", "64",
    "DATA_LOADER.NUM_WORKERS", "8",
    "DATA_LOADER.PIN_MEMORY", "True",
    "NUM_GPUS", "8",
    "NUM_SHARDS", "1",
    "RNG_SEED", "0",
    "OUTPUT_DIR", ".",
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

# The rest of Motionformer and VideoMAE's options, on MOTIONFORMER_OPTS and
# MAIN_PATH_OPTS with one key changed. Divided blocks and the approximate
# spatial steps are plain products (as in vtm): no kernel launches there.
MF_DIVIDED = ("MOTIONFORMER.ATTN_LAYER", "divided")
MF_APPROX_TYPES = ("nystrom", "orthoformer", "performer")
MF_APPROX_DIM = 128  # APPROX_ATTN_DIM: landmarks of nystrom and orthoformer
OPTION_WARMUP, OPTION_ITERS = 2, 5
# Card against the port on the CPU, fp32 with TF32 off, teacher-forced
# blocks at B1: the largest difference over the largest entry of the CPU's
# output.
CPU_BLOCK_TOL = 1e-4
# A bf16 approximate attention against the fp32 one on the card, the
# largest difference over the largest fp32 entry. bf16 keeps 8 bits, and
# Nyström's pseudo-inverse runs its six Newton-Schulz steps in bf16 too, as
# in vtm: this bound only separates rounding from a broken path (a wrong
# layout or a failed inverse is off by the size of the output itself).
BF16_APPROX_TOL = 0.1
# Orthoformer's landmarks on the card and on the CPU may differ only where
# the two picks' scores (largest |cosine| to the landmarks so far) were
# this close at the step where the two selections part.
ORTHO_TIE_TOL = 1e-5
TRACE_OUT = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_trace"
K1_KERNEL_NAME = "attention_fwd_wgmma"  # K1's bf16 __global__ (flash_attention_fwd.cu)
LAYER_SCALE = 0.1  # VideoMAE's init_values in the videomae_options phase

# The dist phase: the parallel paths on the one card, ViT-B width and depth,
# bf16, B8. NCCL refuses two ranks on one GPU, so the card runs NCCL at world
# size 1 and two ranks that share it over gloo, whose collectives take CUDA
# tensors; a run across distinct cards needs a 4-chip machine.
DIST_OUT = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_dist"
DIST_TIMEOUT = datetime.timedelta(seconds=300)  # a collective one rank never joins fails after it
DIST_JOIN_TIMEOUT = 900.0
DIST_EVAL_OPTS = ["TEST.DATASET", "synthetic", "TEST.NUM_ENSEMBLE_VIEWS", "1", "TEST.NUM_SPATIAL_CROPS", "3"]
# the data-parallel step against the one-process B8 step: the global loss
# within DIST_LOSS_REL of it; after one AdamW step an element moves by about
# lr whatever its gradient, so one whose bf16 gradient is near zero may move
# the other way: at most DIST_FLIP_SHARE of the elements may differ by more
# than lr, none by more than 2 lr
DIST_LOSS_REL = 5e-3
DIST_FLIP_SHARE = 0.01
DIST_HEADS = 6  # ViT-B's 12 heads cut 2 ways
DIST_EPOCH = 5.0  # the EPIC config's warm-up starts at lr 0: its step at the end of the warm-up
TP_OUT = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_tp"
TP_TRAIN_BATCH = 4  # clips of a tensor-parallel train step (both ranks take all of them)
# A tensor-parallel bf16 train step's gradient, leaf by leaf, against one
# process's fp32 gradient: within TP_GRAD_FACTOR times one process's own
# bf16 error on that leaf (at least the median leaf's). A missing or doubled
# all-reduce leaves a leaf some 0.5 to 1 of its norm away. Its parameters
# after the step: one process's optimizer step on the ranks' gradients,
# within TP_REPLAY_TOL (the same elementwise arithmetic on cut pieces).
TP_GRAD_FACTOR = 2.0
TP_REPLAY_TOL = 1e-6
# XLA's cost analysis of vtm's VideoMAE ViT-B forward on the TPU (BENCH_DETAIL.json), GFLOP a clip
XLA_GFLOPS_PER_CLIP = {"unmerged": 365.6, "merged": 151.7}


# The slowfast phase (the conv families, fp32 as vtm computes them): the
# shipped config on synthetic clips at B8, with precise BN over 2 batches in
# place of 200; a full-width eval forward on the card and on the CPU, each
# against the CPU's fp64 forward (``conv_card_against_cpu``); the two-gloo-rank step and the
# one-process B8 step both against the same step in fp64, the ranks' error in
# each tensor (parameters and statistics) and in the loss at most SF_DP_FACTOR
# times the one process's own (plus two fp32 spacings of its values); small
# I3D (non-local) and X3D-XS forwards the same way.
SF_OUT = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_slowfast"
SF_RUN_OPTS = ["TRAIN.DATASET", "synthetic", "TEST.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "8",
               "TEST.BATCH_SIZE", "8", "BN.NUM_BATCHES_PRECISE", "2", "TRAIN.AUTO_RESUME", "False"]
SF_CPU_TOL = 1e-4
# the eval forwards card against CPU, both against the CPU's fp64 forward, at
# two inits of each block's final BatchNorm: weights about 1, as every other
# BatchNorm, where the residual sums grow block by block, and about 0.2
SF_FINAL_BN_SCALES = (1.0, 0.2)
SF_FP64_FACTOR = 4.0
SF_FP64_FLOOR = 1e-6  # about eight fp32 spacings of the largest entry
SF_FP64_TOL = 1e-8  # the card's fp64 against the CPU's
SF_DP_FACTOR = 4.0
SF_TRAIN_STEPS = 4
I3D_OPTS = ["MODEL.MODEL_NAME", "ResNet", "MODEL.ARCH", "i3d", "MODEL.NUM_CLASSES", "400", "RESNET.DEPTH", "50",
            "RESNET.ZERO_INIT_FINAL_BN", "True", "DATA.NUM_FRAMES", "8", "DATA.TRAIN_CROP_SIZE", "112",
            "DATA.TEST_CROP_SIZE", "112", "NONLOCAL.LOCATION", "[[[]], [[1, 3]], [[1, 3, 5]], [[]]]",
            "NONLOCAL.GROUP", "[[1], [1], [1], [1]]", "NONLOCAL.INSTANTIATION", "softmax",
            "NONLOCAL.POOL", "[[[1, 2, 2], [1, 2, 2]], [[1, 2, 2], [1, 2, 2]], [[1, 2, 2], [1, 2, 2]], "
                             "[[1, 2, 2], [1, 2, 2]]]"]
X3D_XS_OPTS = ["MODEL.MODEL_NAME", "X3D", "MODEL.ARCH", "x3d", "MODEL.NUM_CLASSES", "400",
               "RESNET.TRANS_FUNC", "x3d_transform", "RESNET.ZERO_INIT_FINAL_BN", "True", "X3D.WIDTH_FACTOR", "2.0",
               "X3D.DEPTH_FACTOR", "2.2", "X3D.BOTTLENECK_FACTOR", "2.25", "X3D.DIM_C5", "2048",
               "X3D.DIM_C1", "12", "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "160", "DATA.TEST_CROP_SIZE", "160"]

# The PTV families. The repo ships no PTV yaml: these lists hold what the
# names of PySlowFast's public configs fix, and take the port's defaults for
# the rest. configs/Kinetics/pytorchvideo/CSN_32x2_R101.yaml:
CSN_OPTS = [
    "MODEL.MODEL_NAME", "PTVCSN",
    "RESNET.DEPTH", "101",
    "RESNET.WIDTH_PER_GROUP", "64",
    "DATA.NUM_FRAMES", "32",
    "DATA.SAMPLING_RATE", "2",
    "DATA.TRAIN_CROP_SIZE", "224",
    "DATA.TEST_CROP_SIZE", "224",
    "MODEL.NUM_CLASSES", "400",
]
# configs/Kinetics/pytorchvideo/R2PLUS1D_16x4_R50.yaml:
R2PLUS1D_OPTS = [
    "MODEL.MODEL_NAME", "PTVR2plus1D",
    "RESNET.DEPTH", "50",
    "RESNET.WIDTH_PER_GROUP", "64",
    "DATA.NUM_FRAMES", "16",
    "DATA.SAMPLING_RATE", "4",
    "DATA.TRAIN_CROP_SIZE", "224",
    "DATA.TEST_CROP_SIZE", "224",
    "MODEL.NUM_CLASSES", "400",
]
# MViT. The repo ships no MViT yaml either: these lists hold the values that
# define the architecture in PySlowFast's public configs, and take the port's
# defaults for the rest. configs/Kinetics/MVITv2_S_16x4.yaml:
_MVIT_TRUNK = [
    "MODEL.MODEL_NAME", "MViT",
    "MODEL.ARCH", "mvit",
    "MODEL.NUM_CLASSES", "400",
    "DATA.NUM_FRAMES", "16",
    "DATA.SAMPLING_RATE", "4",
    "DATA.TRAIN_CROP_SIZE", "224",
    "DATA.TEST_CROP_SIZE", "224",
    "MVIT.EMBED_DIM", "96",
    "MVIT.NUM_HEADS", "1",
    "MVIT.DEPTH", "16",
    "MVIT.MLP_RATIO", "4.0",
    "MVIT.QKV_BIAS", "True",
    "MVIT.PATCH_KERNEL", "[3, 7, 7]",
    "MVIT.PATCH_STRIDE", "[2, 4, 4]",
    "MVIT.PATCH_PADDING", "[1, 3, 3]",
    "MVIT.MODE", "conv",
    "MVIT.DIM_MUL", "[[1, 2.0], [3, 2.0], [14, 2.0]]",
    "MVIT.HEAD_MUL", "[[1, 2.0], [3, 2.0], [14, 2.0]]",
    "MVIT.POOL_KVQ_KERNEL", "[3, 3, 3]",
    "MVIT.POOL_KV_STRIDE_ADAPTIVE", "[1, 8, 8]",
    "MVIT.DROPPATH_RATE", "0.2",
]
MVITV2_S_OPTS = _MVIT_TRUNK + [
    "MVIT.CLS_EMBED_ON", "True",
    "MVIT.USE_ABS_POS", "False",
    "MVIT.REL_POS_SPATIAL", "True",
    "MVIT.REL_POS_TEMPORAL", "True",
    "MVIT.RESIDUAL_POOLING", "True",
    "MVIT.DIM_MUL_IN_ATT", "True",
    "MVIT.POOL_Q_STRIDE", str([[i, 1, 2, 2] if i in (1, 3, 14) else [i, 1, 1, 1] for i in range(16)]),
]
# configs/Kinetics/REV_MVIT_B_16x4_CONV.yaml: the same trunk, separate
# position embeddings, no class token, Q pooled at the three stage
# transitions only, the reversible encoder with the conv residual path
REV_MVIT_B_OPTS = _MVIT_TRUNK + [
    "MVIT.SEP_POS_EMBED", "True",
    "MVIT.CLS_EMBED_ON", "False",
    "MVIT.POOL_Q_STRIDE", "[[1, 1, 2, 2], [3, 1, 2, 2], [14, 1, 2, 2]]",
    "MVIT.REV.ENABLE", "True",
    "MVIT.REV.BUFFER_LAYERS", "[1, 3, 14]",
    "MVIT.REV.RES_PATH", "conv",
    "MVIT.REV.RESPATH_FUSE", "concat",
]
# Masked pretraining (models/masked.py), whose configs PySlowFast keeps under
# configs/masked_ssl/ and the repo does not ship. MaskFeat: the MViTv2-S
# trunk above as MaskMViT, HOG targets at its last block (8 x 7 x 7
# positions, 3 x 9 x (32 / 8)^2 = 432 values each), the loader's 3-D block
# masks over 40% of an 8 x 7 x 7 window (the MaskFeat paper's).
MASKFEAT_OPTS = MVITV2_S_OPTS + [
    "MODEL.MODEL_NAME", "MaskMViT",
    "MODEL.LOSS_FUNC", "multi_mse",
    "MASK.ENABLE", "True",
    "MASK.PRED_HOG", "True",
    "MASK.PRETRAIN_DEPTH", "[15]",
    "AUG.GEN_MASK_LOADER", "True",
    "AUG.MASK_RATIO", "0.4",
    "AUG.MASK_WINDOW_SIZE", "[8, 7, 7]",
]
# MAE: ViT-B 16x224 as an MViT without pooling (patches 2 x 16 x 16, so
# 1568 tokens; 12 blocks 768 wide with 12 heads), 90% of the tokens dropped
# at random (156 kept), a decoder of 4 blocks 512 wide, per-patch
# normalised pixel targets (768 values at each of 1568 positions): the
# layout of PySlowFast's configs/masked_ssl/k400_VIT_B_16x4_MAE_PT.yaml and
# the MAE-ST paper (Feichtenhofer et al., 2022). PERF.md names the values
# not checked against that file.
MAE_VIT_B_OPTS = [
    "MODEL.MODEL_NAME", "MaskMViT",
    "MODEL.ARCH", "mvit",
    "MODEL.LOSS_FUNC", "multi_mse",
    "DATA.NUM_FRAMES", "16",
    "DATA.SAMPLING_RATE", "4",
    "DATA.TRAIN_CROP_SIZE", "224",
    "DATA.TEST_CROP_SIZE", "224",
    "MVIT.EMBED_DIM", "768",
    "MVIT.NUM_HEADS", "12",
    "MVIT.DEPTH", "12",
    "MVIT.MLP_RATIO", "4.0",
    "MVIT.QKV_BIAS", "True",
    "MVIT.PATCH_KERNEL", "[2, 16, 16]",
    "MVIT.PATCH_STRIDE", "[2, 16, 16]",
    "MVIT.PATCH_PADDING", "[0, 0, 0]",
    "MVIT.SEP_POS_EMBED", "True",
    "MVIT.DROPPATH_RATE", "0.0",
    "MASK.ENABLE", "True",
    "MASK.MAE_ON", "True",
    "MASK.MAE_RND_MASK", "True",
    "MASK.PRETRAIN_DEPTH", "[11]",
    "MASK.DECODER_EMBED_DIM", "512",
    "MASK.DECODER_DEPTH", "4",
    "MASK.DECODER_SEP_POS_EMBED", "True",
    "MASK.NORM_PRED_PIXEL", "True",
    "MASK.TIME_STRIDE_LOSS", "True",
    "AUG.MASK_RATIO", "0.9",
]
# Contrastive pretraining (models/contrastive.py), whose configs PySlowFast
# keeps under configs/contrastive_ssl/ and the repo does not ship. The
# backbone is its Slow R50 8x8 at 224 (the port's defaults are that ResNet's
# values; one pathway, 8 frames at a rate of 8, two temporal views a
# video), fp32, no dropout before the projection. The two recipes are in the
# shape of the Slow R50 rhoMoCo and rhoBYOL recipes of Feichtenhofer et al.,
# CVPR 2021 ("A Large-Scale Study on
# Unsupervised Spatiotemporal Representation Learning"); their values are
# chosen here, not copied from those files: MoCo with a 65536-key queue, a
# 3-layer 2048-wide MLP with BatchNorms, the momentum 0.994 annealed, a kNN
# bank of the Kinetics-400 train set's 239975 rows, SGD with momentum 0.9;
# BYOL with a 2-layer 4096-wide MLP and a predictor of depth 2, 256 wide, the
# momentum 0.99 annealed, under LARS.
_SLOW_R50_SSL = [
    "MODEL.MODEL_NAME", "ContrastiveModel",
    "MODEL.ARCH", "slow",
    "RESNET.DEPTH", "50",
    "RESNET.ZERO_INIT_FINAL_BN", "True",
    "DATA.NUM_FRAMES", "8",
    "DATA.SAMPLING_RATE", "8",
    "DATA.TRAIN_CROP_SIZE", "224",
    "DATA.TEST_CROP_SIZE", "224",
    "DATA.TRAIN_CROP_NUM_TEMPORAL", "2",
    "TPU.COMPUTE_DTYPE", "float32",
    "MODEL.DROPOUT_RATE", "0.0",
    "SOLVER.OPTIMIZING_METHOD", "sgd",
    "SOLVER.MOMENTUM", "0.9",
    "SOLVER.MAX_EPOCH", "200",
    "CONTRASTIVE.KNN_ON", "True",
    "CONTRASTIVE.LENGTH", "239975",
    "CONTRASTIVE.BN_MLP", "True",
    "CONTRASTIVE.MOMENTUM_ANNEALING", "True",
]
CONTRASTIVE_MOCO_OPTS = _SLOW_R50_SSL + [
    "CONTRASTIVE.TYPE", "moco",
    "CONTRASTIVE.T", "0.1",
    "CONTRASTIVE.DIM", "128",
    "MODEL.NUM_CLASSES", "128",
    "CONTRASTIVE.QUEUE_LEN", "65536",
    "CONTRASTIVE.MOMENTUM", "0.994",
    "CONTRASTIVE.NUM_MLP_LAYERS", "3",
    "CONTRASTIVE.MLP_DIM", "2048",
]
CONTRASTIVE_BYOL_OPTS = _SLOW_R50_SSL + [
    "CONTRASTIVE.TYPE", "byol",
    "CONTRASTIVE.DIM", "256",
    "MODEL.NUM_CLASSES", "256",
    "CONTRASTIVE.MOMENTUM", "0.99",
    "CONTRASTIVE.NUM_MLP_LAYERS", "2",
    "CONTRASTIVE.MLP_DIM", "4096",
    "CONTRASTIVE.PREDICTOR_DEPTHS", "[2]",
    "SOLVER.LARS_ON", "True",
]
CONTRASTIVE_OUT = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_contrastive"
CONTRASTIVE_STEPS = 3
CONTRASTIVE_BATCH = 8
# the card's fp32 figures (TF32 off) against the CPU's, of each one's largest entry
CONTRASTIVE_CPU_TOL = 1e-4
# SimCLR, SwAV and mem at B4: a crop of 128, the nearest to 112 whose map the
# head's pool (crop // 32) takes to 1 x 1 (at 112 it leaves 2 x 2, and the
# projection would be 4 x DIM wide, not the banks' DIM)
CONTRASTIVE_SMALL_CROP = 128
MASKED_OUT = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_masked"
MASKED_TRAIN_STEPS = 3
# the card's fp32 predictions (TF32 off) against the CPU's, of the largest
MASKED_CPU_TOL = 1e-4
# the mvit and mvit_rev phases: B8 on synthetic clips, AdamW, fresh output
# directories under build/
MVIT_OUT = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_mvit"
MVIT_RUN_OPTS = ["TRAIN.DATASET", "synthetic", "TEST.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "8",
                 "TEST.BATCH_SIZE", "8", "TRAIN.AUTO_RESUME", "False", "SOLVER.OPTIMIZING_METHOD", "adamw",
                 "SOLVER.BASE_LR", "0.0001", "MODEL_BENCHMARK.ITERATIONS", "10",
                 "MODEL_BENCHMARK.WARMUP_ITERATIONS", "3"]
MVIT_CPU_TOL = 1e-4  # the card's fp32 logits (TF32 off) against the CPU's, of the largest
MVIT_TRAIN_STEPS = 3
# kinds of a step's kernels, by name (the layout transposes before "conv")
MVIT_KERNEL_KINDS = (
    ("layout_transposes", "nhwcToNchw"), ("layout_transposes", "nchwToNhwc"), ("layout_transposes", "convertTensor"),
    ("conv_weight_gradient", "wgrad"), ("conv_input_gradient", "dgrad"), ("conv_forward", "fprop"),
    ("conv", "onv"), ("products", "gemm"), ("softmax", "softmax"), ("layer_norm", "layer_norm"),
    ("optimizer", "multi_tensor_apply"), ("reductions", "reduce_kernel"), ("elementwise", "elementwise"),
)
PTV_OUT = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_ptv"
PTV_RUN_OPTS = ["TRAIN.DATASET", "synthetic", "TEST.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "8",
                "TEST.BATCH_SIZE", "8", "TRAIN.AUTO_RESUME", "False", "SOLVER.OPTIMIZING_METHOD", "sgd",
                "SOLVER.BASE_LR", "0.01"]
PTV_SUB_BN = ["BN.NORM_TYPE", "sub_batchnorm", "BN.NUM_SPLITS", "2"]
PTV_CPU_TOL = 1e-4  # the card's fp32 logits (TF32 off) against the CPU's, of the largest
PTV_TRAIN_STEPS = 3
PEAK_FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores (a depthwise conv's)
# the multigrid phase: the long cycle on R(2+1)D 16x4 R50 squeezed to one
# epoch a shape (T 4 at 158 B16, T 8 at 158 B8, T 8 at 224 B4, T 16 at 224 B2
# from B2, with 16 synthetic clips: 1, 2, 4 and 8 iterations), then the
# short cycle on SlowFast 8x8 R50 (its head pools globally there; R(2+1)D's
# pool does not fit a short-cycle crop, ROADMAP.md Queue 3): one epoch of
# the three phases, B8 at 112, B4 at 158, B2 at 224
MG_LONG_OPTS = ["TRAIN.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "2", "TRAIN.AUTO_RESUME", "False",
                "TRAIN.EVAL_PERIOD", "100", "TRAIN.CHECKPOINT_PERIOD", "100", "SOLVER.OPTIMIZING_METHOD", "sgd",
                "SOLVER.BASE_LR", "0.001", "SOLVER.LR_POLICY", "steps_with_relative_lrs", "SOLVER.STEPS", "[0, 3]",
                "SOLVER.LRS", "[1, 0.1]", "SOLVER.MAX_EPOCH", "8", "MULTIGRID.LONG_CYCLE", "True",
                "MULTIGRID.EPOCH_FACTOR", "0.5"]
MG_SHORT_OPTS = ["TRAIN.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "2", "TRAIN.AUTO_RESUME", "False",
                 "SOLVER.MAX_EPOCH", "1", "MULTIGRID.SHORT_CYCLE", "True", "MULTIGRID.EPOCH_FACTOR", "1.0"]
# the charades phase: R(2+1)D 16x4 R50, 157 classes, multi-label, on frame
# lists written under build/ (8 videos of 64 JPEG frames)
CHARADES_OUT = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_charades"
CHARADES_VIDEOS, CHARADES_FRAMES, CHARADES_CLASSES = 8, 64, 157
# AVA detection (models/roi_head.py, data/ava.py, eval/ava_eval.py): the
# values of PySlowFast's configs/AVA/SLOWFAST_32x2_R50_SHORT.yaml that
# differ from the SlowFast config above: 32 frames at stride 2, s5 at 1/16
# (stride 1, dilation 2), the ROI head (aligned, 7 x 7 at scale 1/16), 80
# classes with the sigmoid at eval and bce_logit in training (vtm's loss
# registry has no "bce"), predicted boxes above 0.8, SGD with momentum 0.9.
AVA_OPTS = SLOWFAST_OPTS + [
    "TRAIN.DATASET", "ava",
    "TEST.DATASET", "ava",
    "DATA.NUM_FRAMES", "32",
    "DATA.SAMPLING_RATE", "2",
    "DATA.TRAIN_JITTER_SCALES", "[256, 320]",
    "DATA.TRAIN_CROP_SIZE", "224",
    "DATA.TEST_CROP_SIZE", "224",
    "SLOWFAST.ALPHA", "4",
    "SLOWFAST.BETA_INV", "8",
    "RESNET.SPATIAL_STRIDES", "[[1, 1], [2, 2], [2, 2], [1, 1]]",
    "RESNET.SPATIAL_DILATIONS", "[[1, 1], [1, 1], [1, 1], [2, 2]]",
    "DETECTION.ENABLE", "True",
    "DETECTION.ALIGNED", "True",
    "DETECTION.SPATIAL_SCALE_FACTOR", "16",
    "DETECTION.ROI_XFORM_RESOLUTION", "7",
    "MODEL.NUM_CLASSES", "80",
    "MODEL.HEAD_ACT", "sigmoid",
    "MODEL.DROPOUT_RATE", "0.5",
    "MODEL.LOSS_FUNC", "bce_logit",
    "AVA.DETECTION_SCORE_THRESH", "0.8",
    "SOLVER.OPTIMIZING_METHOD", "sgd",
    "SOLVER.MOMENTUM", "0.9",
]
# The AVA tree the phase writes (``write_ava``): 4 videos of 185 JPEG frames
# of 256 x 340, keyframes at seconds 902-905 (each one's 64-frame window in
# the list), 1-3 person boxes a keyframe with 1-3 labels each, the labelmap's
# 60 evaluated ids of 80, predicted boxes (the ground truth jittered at
# 0.85-0.99, and one below the threshold a keyframe), one excluded keyframe.
AVA_OUT = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_ava"
AVA_VIDEOS, AVA_FRAMES, AVA_HW, AVA_SECS = 4, 185, (256, 340), (902, 903, 904, 905)
AVA_EVALUATED = tuple(i for i in range(1, 81) if i % 4)
AVA_EXCLUDED = ("ava002", 903)
AVA_TRAIN_STEPS = 3
# The vis phase (vtm_torch/vis, tools/{demo_net,ava_demo_precomputed_boxes,
# visualization,benchmark}.py): Grad-CAM on VideoMAE ViT-B merged at r 150
# (fp32, B2) at block 5, whose backward runs K2 through blocks 6-8 (668, 518
# and 368 tokens; blocks 9-11 are below K1's 256); the map through the kernels
# against the map through the plain versions, both on the card, of [0, 1]
# values: within VIS_CAM_TOL; SlowFast's map at s5, card against CPU, the
# same; a 64-frame demo video (4 clips of 16 frames at rate 1); the loader
# benchmark over VIS_VIDEOS videos, VIS_EPOCHS epochs.
VIS_OUT = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_vis"
VIS_TARGET, VIS_K2_PER_MAP = "blocks_5", 3
VIS_CAM_TOL = 1e-3
VIS_DEMO_FRAMES, VIS_DEMO_HW = 64, (240, 320)
VIS_VIDEOS, VIS_VIDEO_FRAMES, VIS_VIDEO_HW, VIS_EPOCHS = 32, 96, (256, 340), 2
# the ROI head's kernels by kind (its products, the temporal mean, the max)
ROI_KERNEL_KINDS = (("products", "gemm"), ("products", "cutlass"), ("products", "sm90_xmma"),
                    ("reductions", "reduce_kernel"), ("elementwise", "elementwise"))


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
sf_cfg = cfg_maker(SLOWFAST_OPTS)
csn_cfg, r2plus1d_cfg = cfg_maker(CSN_OPTS), cfg_maker(R2PLUS1D_OPTS)
mvit_cfg, rev_mvit_cfg = cfg_maker(MVITV2_S_OPTS), cfg_maker(REV_MVIT_B_OPTS)
maskfeat_cfg, mae_cfg = cfg_maker(MASKFEAT_OPTS), cfg_maker(MAE_VIT_B_OPTS)
moco_cfg, byol_cfg = cfg_maker(CONTRASTIVE_MOCO_OPTS), cfg_maker(CONTRASTIVE_BYOL_OPTS)
ava_cfg = cfg_maker(AVA_OPTS)


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
                 generator_seed=None, model=None) -> None:
    """Teacher-forced full-width blocks (fp32, TF32 off, B2): each executed
    step (``layer_schedule``: a block may run at several steps, some
    metric-only) gets the plain chain's input through the kernel path and
    the plain path, which must make identical Matching indices (those the
    matcher made in each path) and sizes and outputs within BLOCK_TOL.
    ``generator_seed``: the random modes' scores come from a CUDA generator
    seeded anew for each path at each step. ``blocks`` and ``attn`` name the
    model's block list and a block's attention module. ``model`` replaces
    the one ``cfg`` builds (an option no config key reaches)."""
    model = model or build_model(cfg, "cuda").module
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


@contextlib.contextmanager
def watching_blocks(blocks, tokens_of):
    """While open, the tokens entering each of ``blocks`` (``tokens_of`` of
    its input's length) and leaving the last one, every forward; and for
    the first forward only (no extra work in the timed ones) a device flag
    for each block: is its output finite."""
    seen, finite = [], []

    def pre(m, args):
        seen.append(tokens_of(args[0].shape[1]))

    def post(m, args, out):
        if len(finite) < len(blocks):
            finite.append(torch.isfinite(out[0]).all())

    hooks = [blk.register_forward_pre_hook(pre) for blk in blocks]
    hooks += [blk.register_forward_hook(post) for blk in blocks]
    hooks.append(blocks[-1].register_forward_hook(lambda m, a, o: seen.append(tokens_of(o[0].shape[1]))))
    try:
        yield seen, finite
    finally:
        for hk in hooks:
            hk.remove()


def option_serve(label: str, module, cfg, counts, k1_per_forward: int, tokens_of=lambda n: n,
                 finite_from=None) -> dict:
    """``perform_benchmark`` (what ``model_benchmark`` times) on ``module``
    at B8 bf16: clips/s, the tokens entering each block and leaving the
    last in every forward equal ``counts``, K1's launches a forward, no
    other kernel, and which blocks' outputs are finite: all of them, or
    those before ``finite_from``."""
    blocks = module.blocks
    before = launch_counts()
    with watching_blocks(blocks, tokens_of) as (seen, finite):
        stats = perform_benchmark(module, cfg, torch.device("cuda"))
    forwards = OPTION_WARMUP + OPTION_ITERS
    launches = {c: n - before[c] for c, n in launch_counts().items()}
    check(launches == {c: k1_per_forward * forwards if c == "LAUNCHES" else 0 for c in COUNTERS},
          f"{label}: kernel launches {launches} in {forwards} forwards")
    check(stats["attention_kernel_launches"] == k1_per_forward, f"{label}: {stats}")
    check(seen == list(counts) * forwards, f"{label}: token counts {seen[:len(counts)]}")
    flags = [bool(f) for f in finite]
    want = [finite_from is None or i < finite_from for i in range(len(blocks))]
    check(flags == want, f"{label}: finite block outputs {flags}, expected {want}")
    return dict(clips_per_sec=stats["clips_per_sec"], launches_per_forward=k1_per_forward,
                token_counts=list(counts), finite_blocks=sum(flags))


def card_and_cpu(cfg):
    """One fp32 model on the card and the same weights on the CPU."""
    card = build_model(cfg, "cuda").module
    cpu = build_model(cfg, "cpu").module
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    return card, cpu


@contextlib.contextmanager
def cpu_matchings_on_the_card(cpu_matchings, own):
    """While open, the matcher on the card returns the CPU's Matching of
    the same call (moved to the card) and appends its own to ``own``, so
    a merged block runs the CPU's merge on both devices."""
    real = merge_bipartite._match

    def forced(*args, **kwargs):
        own.append(real(*args, **kwargs))
        m = cpu_matchings[len(own) - 1]
        if m is None:
            return None
        return dataclasses.replace(m, unm_idx=m.unm_idx.cuda(), src_idx=m.src_idx.cuda(),
                                   dst_idx=m.dst_idx.cuda(), src_score=m.src_score.cuda())

    merge_bipartite._match = forced
    try:
        yield
    finally:
        merge_bipartite._match = real


def blocks_against_cpu(phase: str, card, cpu, video, n_blocks: int, check_output=lambda i: True) -> list:
    """The first ``n_blocks`` blocks of ``card`` (on the card) and ``cpu``
    (on the CPU), teacher-forced: each gets the CPU chain's input, and a
    merged block the CPU's Matching. Each block's output within
    CPU_BLOCK_TOL of the largest CPU entry (unless ``check_output(i)`` is
    false), and whether the card matched identically on its own."""
    rows = []
    with torch.inference_mode():
        x, size = cpu.embed(video), None
        for i in range(n_blocks):
            with recording(merge_bipartite, "_match") as cpu_matchings:
                yc, sc = cpu.blocks[i](x, MergeState(size=size), layer=i, num_frames=MF_FRAMES)
            own = []
            with cpu_matchings_on_the_card(cpu_matchings, own):
                yk, sk = card.blocks[i](x.cuda(), MergeState(size=None if size is None else size.cuda()),
                                        layer=i, num_frames=MF_FRAMES)
            same = all((a is None and b is None) or all(
                torch.equal(getattr(a, n).cpu(), getattr(b, n)) for n in ("unm_idx", "src_idx", "dst_idx"))
                for a, b in zip(own, cpu_matchings))
            err = ((yk.cpu() - yc).abs().max() / yc.abs().max()).item()
            if check_output(i):
                check(err <= CPU_BLOCK_TOL, f"{phase} block {i}: card against CPU {err} > {CPU_BLOCK_TOL}")
            check((sk.size is None) == (sc.size is None), f"{phase} block {i}: sizes on one device only")
            if sc.size is not None:
                check(torch.equal(sk.size.cpu(), sc.size), f"{phase} block {i}: sizes differ")
            rows.append(dict(block=i, tokens=int(x.shape[1]), rel_err=err, matched_identically=same))
            x, size = yc, sc.size
    return rows


def phase_mf_divided(smi: str) -> None:
    """Motionformer with divided space-time attention (``MF_DIVIDED``) at
    full width and depth. Serving at B8 bf16 with TOME on at r 18: the
    blocks merge nothing (the logits equal TOME off's bit for bit, every
    token count stays 1568) and no kernel launches; clips/s. Four train
    steps (fp32 parameters, AdamW, the EPIC config's single-head run
    lists): finite losses, nonzero gradients into every ``timeattn`` and
    ``norm3`` parameter. Two teacher-forced blocks at B1 in fp32, card
    against the CPU."""
    zero_launch_counts()  # this path's counts start here
    t0 = time.perf_counter()
    serve_opts = ("TEST.BATCH_SIZE", "8", "MODEL_BENCHMARK.WARMUP_ITERATIONS", str(OPTION_WARMUP),
                  "MODEL_BENCHMARK.ITERATIONS", str(OPTION_ITERS), *MF_DIVIDED)
    on, off = (build_model(mf_cfg(*serve_opts, *opts), "cuda") for opts in ((), ("TOME.ENABLE", "False")))
    check(on.policy.rs[0] == 18 and off.policy.mode == "none", "mf_divided: the policies")
    video = torch.from_numpy(np.random.default_rng(21).random((8, 16, 224, 224, 3), dtype=np.float32)).cuda()
    with torch.inference_mode():
        probs_on, state_on = on.module(video)
        probs_off, _ = off.module(video)
    check(torch.equal(probs_on, probs_off) and state_on.size is None,
          "mf_divided: TOME changed a divided model's output")
    check(tuple(probs_on.shape) == (8, 400) and bool(torch.isfinite(probs_on).all()), "mf_divided: output")
    row_err = (probs_on.sum(dim=-1) - 1).abs().max().item()
    check(row_err <= PROB_SUM_TOL, f"mf_divided: rows sum to 1 within {row_err}")
    serve = option_serve("mf_divided", on.module, mf_cfg(*serve_opts), (MF_BODY_COUNTS[0],) * 13, 0,
                         tokens_of=lambda n: n - 1)
    del on, off

    cfg = mf_train_cfg(*MF_TRAIN_STEP_OPTS, *MF_DIVIDED)
    trainer = build_trainer(cfg)
    frames, labels = fixed_batch(cfg)
    grads = {}
    for name, p in trainer.module.named_parameters():
        if "timeattn" in name or "norm3" in name:
            p.register_hook(lambda g, n=name: grads.__setitem__(n, max(grads.get(n, 0.0), g.abs().max().item())))
    set_lr(trainer.optimizer, trainer.lr_at(0.0))
    losses = [trainer.train_step(frames, labels)[0].item() for _ in range(4)]
    check(all(np.isfinite(losses)), f"mf_divided: train losses {losses}")
    depth = trainer.module.config.depth
    check(len(grads) == 6 * depth and all(g > 0 for g in grads.values()),
          f"mf_divided: timeattn/norm3 gradients {sorted(n for n, g in grads.items() if not g > 0)}")
    del trainer
    torch.cuda.empty_cache()

    card, cpu = card_and_cpu(mf_cfg("TPU.COMPUTE_DTYPE", "float32", "TEST.BATCH_SIZE", "1", *MF_DIVIDED))
    clip = torch.from_numpy(np.random.default_rng(22).random((1, 16, 224, 224, 3), dtype=np.float32))
    rows = blocks_against_cpu("mf_divided", card, cpu, clip, 2)
    total = launch_counts()  # read right after the path ran
    check(all(n == 0 for n in total.values()), f"mf_divided: kernel launches {total}")
    emit("mf_divided", serve=serve, max_row_sum_err=row_err, train_losses=losses,
         smallest_timeattn_norm3_grad=min(grads.values()), blocks_against_cpu=rows, launches=total,
         seconds=time.perf_counter() - t0, batch=8, dtype="bfloat16", nvidia_smi=smi)


def landmark_gap(q: torch.Tensor, cpu_order: torch.Tensor, card_order: torch.Tensor) -> float:
    """How close a call it was where Orthoformer's selection on the card
    (``card_order``) first parted from the CPU's (``cpu_order``), both [B, M]
    in the order picked from q [B, N, D]: replaying the CPU's selection, the
    difference of the two picks' scores at that step, the largest over the
    rows of B that parted."""
    b, _, d = q.shape
    qk = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    score = torch.full(q.shape[:2], -float("inf"), dtype=q.dtype)
    parted = torch.zeros(b, dtype=torch.bool)
    gap = 0.0
    for t in range(1, cpu_order.shape[1]):
        cur = cpu_order[:, t - 1]
        picked = qk.gather(1, cur[:, None, None].expand(b, 1, d))
        score = torch.maximum(score, torch.bmm(qk, picked.transpose(1, 2))[:, :, 0].abs())
        score.scatter_(1, cur[:, None], 10.0)
        now = (cpu_order[:, t] != card_order[:, t]) & ~parted
        for i in now.nonzero().flatten().tolist():
            gap = max(gap, (score[i, card_order[i, t]] - score[i, cpu_order[i, t]]).abs().item())
        parted |= now
    return gap


@contextlib.contextmanager
def recording_landmarks(seen):
    """While open, every call of Orthoformer's selection appends (q on the
    CPU, the rows it picked in order, on the CPU) to ``seen``."""
    real = motionformer_approx.greedy_landmark_order

    def record(q, num_landmarks=64, init_idx=None, generator=None):
        order = real(q, num_landmarks, init_idx, generator)
        seen.append((q.float().cpu(), order.cpu()))
        return order

    motionformer_approx.greedy_landmark_order = record
    try:
        yield
    finally:
        motionformer_approx.greedy_landmark_order = real


@contextlib.contextmanager
def one_projection():
    """While open, Performer draws one fixed projection (256 x 64, from a
    CPU generator seeded 0) on every device and at every layer."""
    real = motionformer_approx.create_projection_matrix
    fixed = real(256, 64, torch.Generator().manual_seed(0))
    motionformer_approx.create_projection_matrix = lambda m, d, generator: fixed
    try:
        yield
    finally:
        motionformer_approx.create_projection_matrix = real


def approx_block_against_cpu(kind: str) -> dict:
    """Block 0 of an fp32 B1 model at full width, merged at r 18, card
    against CPU (Performer given one projection; Orthoformer's selections
    compared: where they part, only at a near-tie, with the gap printed,
    and the block's output is compared only if the rows picked are the
    same); then its attention in bf16 against fp32 on the card."""
    opts = ("TPU.COMPUTE_DTYPE", "float32", "TEST.BATCH_SIZE", "1", "MOTIONFORMER.APPROX_ATTN_TYPE", kind,
            "MOTIONFORMER.APPROX_ATTN_DIM", str(MF_APPROX_DIM))
    card, cpu = card_and_cpu(mf_cfg(*opts))
    clip = torch.from_numpy(np.random.default_rng(23).random((1, 16, 224, 224, 3), dtype=np.float32))
    landmarks, out = [], {}
    with one_projection() if kind == "performer" else contextlib.nullcontext(), recording_landmarks(landmarks):
        if kind == "orthoformer":
            with torch.inference_mode():
                x = cpu.embed(clip)
                cpu.blocks[0].attn(cpu.blocks[0].norm1(x), MF_FRAMES)
                card.blocks[0].attn(card.blocks[0].norm1(x.cuda()), MF_FRAMES)
            (q, cpu_order), (_, card_order) = landmarks[-2:]
            # the attention reads the rows picked, in index order
            out["landmarks_equal"] = bool(torch.equal(cpu_order.sort(1).values, card_order.sort(1).values))
            out["order_equal"] = bool(torch.equal(cpu_order, card_order))
            if not out["order_equal"]:
                out["landmark_gap"] = landmark_gap(q, cpu_order, card_order)
                print(f"mf_approx orthoformer: the selections part at a gap of {out['landmark_gap']}", flush=True)
                check(out["landmark_gap"] <= ORTHO_TIE_TOL,
                      f"mf_approx orthoformer: the selections part at a gap of {out['landmark_gap']}")
        same_landmarks = out.get("landmarks_equal", True)
        out["blocks_against_cpu"] = blocks_against_cpu(f"mf_approx {kind}", card, cpu, clip, 1,
                                                       check_output=lambda i: same_landmarks)
        with torch.inference_mode():
            xk = card.embed(clip.cuda())
            blk = card.blocks[0]
            ref, _ = blk.attn(blk.norm1(xk), MF_FRAMES)
            low, _ = blk.attn(blk.norm1(xk.bfloat16()), MF_FRAMES)
    out["bf16_rel_err"] = ((low.float() - ref).abs().max() / ref.abs().max()).item()
    if kind == "nystrom":
        check(out["bf16_rel_err"] <= BF16_APPROX_TOL, f"mf_approx nystrom: bf16 against fp32 {out['bf16_rel_err']}")
    return out


def phase_mf_approx(smi: str) -> None:
    """Motionformer's trajectory attention with each approximate spatial
    step (APPROX_ATTN_DIM 128) at full width and depth, B8 bf16, merged
    (r 18, proportional attention) and unmerged: clips/s, the body token
    counts (MF_BODY_COUNTS merged), no kernel launches (K3 is bypassed),
    finite block outputs (Nyström's merged layer 11 excepted, as in vtm); then
    one teacher-forced block each, card against CPU, and bf16 against
    fp32 on the card."""
    zero_launch_counts()  # this path's counts start here
    t0 = time.perf_counter()
    runs = {}
    for kind in MF_APPROX_TYPES:
        runs[kind] = {}
        for label, opts, counts in (("merged", (), MF_BODY_COUNTS),
                                    ("unmerged", ("TOME.ENABLE", "False"), (MF_BODY_COUNTS[0],) * 13)):
            cfg = mf_cfg("TEST.BATCH_SIZE", "8", "MODEL_BENCHMARK.WARMUP_ITERATIONS", str(OPTION_WARMUP),
                         "MODEL_BENCHMARK.ITERATIONS", str(OPTION_ITERS), "MOTIONFORMER.APPROX_ATTN_TYPE", kind,
                         "MOTIONFORMER.APPROX_ATTN_DIM", str(MF_APPROX_DIM), *opts)
            bundle = build_model(cfg, "cuda")
            # Nyström averages segments of N' // 128 tokens: with fewer body
            # tokens than landmarks (72 at r 18's layer 11) a segment is empty
            # and the body rows turn NaN, in vtm too. Only layer 11 runs on
            # so few; its CLS row, all the head reads, stays finite.
            few = [i for i, n in enumerate(counts[:-1]) if n < MF_APPROX_DIM]
            finite_from = few[0] if kind == "nystrom" and few else None
            runs[kind][label] = option_serve(f"mf_approx {kind} {label}", bundle.module, cfg, counts, 0,
                                             tokens_of=lambda n: n - 1, finite_from=finite_from)
            del bundle
        runs[kind]["block"] = approx_block_against_cpu(kind)
        torch.cuda.empty_cache()
    total = launch_counts()  # read right after the path ran
    check(all(n == 0 for n in total.values()), f"mf_approx: kernel launches {total}")
    emit("mf_approx", runs=runs, approx_attn_dim=MF_APPROX_DIM, launches=total,
         seconds=time.perf_counter() - t0, batch=8, dtype="bfloat16", nvidia_smi=smi)


def trace_k1(path: str) -> dict:
    """K1's kernels in a Chrome trace: their count and device time."""
    events = json.loads(pathlib.Path(path).read_text())["traceEvents"]
    k1 = [e for e in events if e.get("cat") == "kernel" and K1_KERNEL_NAME in e.get("name", "")]
    return dict(k1_events=len(k1), k1_device_us=sum(e.get("dur", 0) for e in k1),
                kernel_events=sum(e.get("cat") == "kernel" for e in events))


def phase_videomae_options(smi: str) -> int:
    """VideoMAE ViT-B merged at r 150, B8 bf16, with class pooling
    (``VIDEOMAE.USE_MEAN_POOLING False``: norm over every token, then
    token 0) and with layer scale (``init_values`` 0.1, which no config
    key sets: the model is built from the config's own with it added):
    clips/s, token counts, K1 9 times a forward, teacher-forced fp32 B2
    blocks kernel path against plain path. Class pooling through
    ``model_benchmark`` with ``TRACE_DIR``: the trace holds K1's kernel with
    device time. Returns K1's launches in the phase."""
    zero_launch_counts()  # this path's counts start here
    t0 = time.perf_counter()
    shutil.rmtree(TRACE_OUT, ignore_errors=True)
    cls = ("VIDEOMAE.USE_MEAN_POOLING", "False")
    serve_opts = ("TEST.BATCH_SIZE", "8", "MODEL_BENCHMARK.WARMUP_ITERATIONS", str(OPTION_WARMUP),
                  "MODEL_BENCHMARK.ITERATIONS", str(OPTION_ITERS))
    fp32_b2 = ("TPU.COMPUTE_DTYPE", "float32", "TEST.BATCH_SIZE", "2")
    runs = {}

    cfg = main_cfg(*serve_opts, *cls, "MODEL_BENCHMARK.TRACE_DIR", str(TRACE_OUT))
    before = flash_attention.LAUNCHES
    stats = model_benchmark(cfg)
    forwards = OPTION_WARMUP + OPTION_ITERS + 1  # the traced forward too
    check(flash_attention.LAUNCHES - before == MERGED_K1_PER_FORWARD * forwards,
          f"class pooling: {flash_attention.LAUNCHES - before} K1 launches in {forwards} forwards")
    check(stats["attention_kernel_launches"] == MERGED_K1_PER_FORWARD, f"class pooling: {stats}")
    trace = trace_k1(stats["trace_file"])
    check(trace["k1_events"] == MERGED_K1_PER_FORWARD and trace["k1_device_us"] > 0,
          f"class pooling: the trace's K1 kernels {trace}")
    cfg = main_cfg(*serve_opts, *cls)
    bundle = build_model(cfg, "cuda")
    module = bundle.module
    check(not hasattr(module, "fc_norm") and not module.config.use_mean_pooling, "class pooling: the head")
    runs["cls_pooling"] = option_serve("class pooling", module, cfg, MERGED_COUNTS, MERGED_K1_PER_FORWARD)
    last = []
    hook = module.blocks[-1].register_forward_hook(lambda m, a, o: last.append(o[0]))
    video = torch.from_numpy(np.random.default_rng(24).random((8, 16, 224, 224, 3), dtype=np.float32)).cuda()
    with torch.inference_mode():
        logits, _ = module(video)
        pooled = module.head(module.norm(last[0])[:, 0].float())
    hook.remove()
    check(torch.equal(logits, pooled) and bool(torch.isfinite(logits).all()), "class pooling: logits")
    runs["cls_pooling"].update(model_benchmark_clips_per_sec=stats["clips_per_sec"], trace=trace)
    del bundle, module
    phase_blocks("videomae_cls_blocks", main_cfg(*fp32_b2, *cls), 25, {}, lambda: flash_attention.LAUNCHES,
                 MERGED_COUNTS[-1], MERGED_K1_PER_FORWARD)

    def layer_scaled(cfg, dtype):
        base = build_model(cfg, "cuda")
        config = dataclasses.replace(base.module.config, init_values=LAYER_SCALE)
        return VideoMAE(config, policy=base.policy, dtype=dtype, seed=cfg.RNG_SEED).cuda().eval()

    cfg = main_cfg(*serve_opts)
    module = layer_scaled(cfg, torch.bfloat16)
    gammas = [n for n, _ in module.named_parameters() if "gamma" in n]
    check(len(gammas) == 24 and module.blocks[0].gamma_1.dtype == torch.float32, f"layer scale: {gammas[:2]}")
    runs["layer_scale"] = option_serve("layer scale", module, cfg, MERGED_COUNTS, MERGED_K1_PER_FORWARD)
    del module
    cfg = main_cfg(*fp32_b2)
    phase_blocks("videomae_layer_scale_blocks", cfg, 26, {}, lambda: flash_attention.LAUNCHES,
                 MERGED_COUNTS[-1], MERGED_K1_PER_FORWARD, model=layer_scaled(cfg, torch.float32))
    torch.cuda.empty_cache()
    total = launch_counts()  # read right after the path ran
    check(total["LAUNCHES"] > 0 and all(n == 0 for c, n in total.items() if c != "LAUNCHES"),
          f"videomae_options: launches {total}")
    emit("videomae_options", runs=runs, init_values=LAYER_SCALE, launches=total["LAUNCHES"],
         seconds=time.perf_counter() - t0, batch=8, dtype="bfloat16", nvidia_smi=smi)
    return total["LAUNCHES"]


def dist_batch(cfg, n: int = 8):
    """The first n clips of the synthetic training set and their labels,
    as numpy (the global batch every rank takes its rows of)."""
    batch = next(iter(construct_loader(cfg, "train")))
    labels = batch["label"]
    labels = {k: np.asarray(v[:n]) for k, v in labels.items()} if isinstance(labels, dict) else np.asarray(labels[:n])
    return np.asarray(batch["frames"][:n]), labels


def check_matchings_agree(what: str, a: list, b: list) -> None:
    check(len(a) == len(b), f"{what}: {len(a)} and {len(b)} Matchings")
    for i, (x, y) in enumerate(zip(a, b)):
        check((x is None) == (y is None), f"{what}: Matching {i} made in one run only")
        if x is None:
            continue
        check((x["n"], x["r"]) == (y["n"], y["r"]), f"{what}: Matching {i} sizes")
        for k in ("unm_idx", "src_idx", "dst_idx"):
            check(np.array_equal(x[k], y[k]), f"{what}: Matching {i} {k} differs")


def matching_agreement(a: list, b: list) -> list:
    """Layer by layer, the share of merged (src, dst) pairs two runs'
    Matchings share, row by row as sets (a Matching lists its pairs in
    score order, which a rounding change reorders). A layer after the
    first that differs sees other tokens, so the first layers say most."""
    shares = []
    for x, y in zip(a, b):
        if x is None or y is None:
            continue
        same = sum(len(set(zip(xs, xd)) & set(zip(ys, yd)))
                   for xs, xd, ys, yd in zip(x["src_idx"].tolist(), x["dst_idx"].tolist(),
                                             y["src_idx"].tolist(), y["dst_idx"].tolist()))
        shares.append(same / max(x["src_idx"].size, 1))
    return shares


def dist_serve_check(name: str, ones: dict, ranks: dict, counts: dict, per_forward, seconds: list, smi: str,
                     counter: str = "LAUNCHES", heads_key: str = "k1_heads"):
    """Tensor-parallel serving on two ranks (merged and unmerged, or the
    labels ``ranks`` has) against the one-process forward of the same bf16
    weights. Exact: the token counts (``counts[label]``, and the one
    process's), the kernel's launches a rank (``counter``, ``per_forward``;
    none where ``counter`` is None) at 6 heads, both ranks' logits and
    Matchings. The logits: no further from the one-process fp32 forward's
    than twice the one-process bf16 forward is (or BF16_FLOOR of their
    largest): the cut's partial sums round like any other bf16 product,
    and a merged forward may flip a near tie that bf16 flips as well."""
    rows = {}
    for label, got_ranks in ranks.items():
        one = ones[label]
        for r, got in enumerate(got_ranks):
            check(got["mesh"] == {"data": 1, "model": 2}, f"{name} {label}: mesh {got['mesh']}")
            check(tuple(got["tokens"]) == tuple(one["bf16"]["tokens"])
                  and (counts is None or tuple(got["tokens"]) == tuple(counts[label])),
                  f"{name} {label} rank {r}: tokens {got['tokens']}")
            if counter is not None:
                seen = got["seen"].get(heads_key, [])
                check(got["launches"][counter] == per_forward[label], f"{name} {label} rank {r}: {got['launches']}")
                check(set(seen) == {DIST_HEADS} and len(seen) == per_forward[label],
                      f"{name} {label} rank {r}: heads {seen}")
            check(torch.equal(got["logits"], got_ranks[0]["logits"]), f"{name} {label}: rank {r}'s logits differ")
            check_matchings_agree(f"{name} {label} rank {r} against rank 0", got["matchings"],
                                  got_ranks[0]["matchings"])
            check((len(got["matchings"]) > 0) == (label == "merged"), f"{name} {label}: Matchings made")
        if counter is not None:
            check(set(one["bf16"]["seen"].get(heads_key, [])) == {2 * DIST_HEADS}, f"{name} {label}: one-process heads")
        logits, bf16, fp32 = got_ranks[0]["logits"], one["bf16"]["logits"], one["fp32"]["logits"]
        check(bool(torch.isfinite(logits).all()) and logits.shape == bf16.shape, f"{name} {label}: logits")
        err = float((logits - fp32).abs().max())
        bf16_err = float((bf16 - fp32).abs().max())
        scale = float(fp32.abs().max())
        tol = max(2 * bf16_err, BF16_FLOOR * scale)
        check(err <= tol, f"{name} {label}: logits {err} from fp32, one process's bf16 {bf16_err}")
        rows[label] = dict(logits_max_abs_err_vs_fp32=err, one_process_bf16_err_vs_fp32=bf16_err, tol=tol,
                           logits_max_abs_err_vs_one_process_bf16=float((logits - bf16).abs().max()),
                           logits_largest=scale, tokens=got_ranks[0]["tokens"],
                           launches_per_rank=got_ranks[0]["launches"],
                           matching_agreement_with_one_process=matching_agreement(
                               got_ranks[0]["matchings"], one["bf16"]["matchings"]))
    first = next(iter(ranks.values()))[0]
    emit(f"dist_{name}", seconds=seconds, ranks=2, backend="gloo", mesh={"data": 1, "model": 2}, batch=8,
         heads_a_rank=DIST_HEADS if counter is not None else None, kernel_counter=counter,
         matchings_equal_across_ranks=True, **rows,
         cut_shapes={k: list(v) for k, v in list(first["cut_shapes"].items())[:3]},
         dtype="bfloat16", nvidia_smi=smi)


def one_process_serves(cfg_fn, video, labels=("merged", "unmerged")) -> dict:
    """The one-process forwards a tensor-parallel serve is held against:
    merged and unmerged (or ``labels``), bf16 and fp32."""
    cuda = torch.device("cuda")
    out = {}
    for label in labels:
        opts = ("TOME.ENABLE", "False") if label == "unmerged" else ()
        out[label] = {dtype: probes.eval_probe(cfg_fn("TEST.BATCH_SIZE", "8", "TPU.COMPUTE_DTYPE", dtype, *opts),
                                               cuda, None, video)
                      for dtype in ("bfloat16", "float32")}
        out[label]["bf16"], out[label]["fp32"] = out[label].pop("bfloat16"), out[label].pop("float32")
        torch.cuda.empty_cache()
    return out


def phase_dist(smi: str) -> tuple:
    """The parallel paths (``vtm_torch/parallel``) at ViT-B width and depth,
    bf16, B8, through the entry points' own code: ``train_net``'s trainer,
    ``probes.eval_probe``'s cut model and ``test_net.test``, each against
    the same run in this process. Its gloo ranks run ``tp_plan``'s probes
    too, after their own (the launch's seconds include them). Returns the
    kernels' launches in the phase, the ranks' included, and (each rank's
    ``tp`` parts, their context) for ``phase_tp``."""
    shutil.rmtree(DIST_OUT, ignore_errors=True)
    cuda = torch.device("cuda")
    zero_launch_counts()  # this path's counts start here
    ranks_launched = dict.fromkeys(COUNTERS, 0)

    # 1. NCCL at world size 1: train_net's DDP step on the EPIC config (twin
    # heads, layer decay, stochastic depth drawn from the step's generator)
    # is the one-process step bit for bit: loss, every gradient the optimizer
    # sees, every parameter after. cuDNN's deterministic algorithms on both
    # sides, so that the bits compare DDP, not a convolution's atomics.
    cfg = train_cfg(*TRAIN_RUN_OPTS)
    frames, labels = dist_batch(cfg)
    step = dict(want_state=False, generators=True, epoch=DIST_EPOCH)
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        again = [probes.train_probe(cfg, cuda, None, frames, labels, **step) for _ in range(2)]
        one_seconds = time.perf_counter() - t0
        check(again[0]["state"] == again[1]["state"] and again[0]["loss"] == again[1]["loss"],
              "dist: the one-process step does not repeat itself")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        nccl = launch_job(cfg, dist_rank, ["cuda:0"], backend="nccl", timeout=DIST_TIMEOUT,
                          join_timeout=DIST_JOIN_TIMEOUT, args=("nccl", [("train", cfg, (None, frames, labels), step)]))
        nccl_seconds = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = False
    got, one = nccl[0][0]["result"], again[0]
    check(got["mesh"] == {"data": 1, "model": 1}, f"dist nccl: mesh {got['mesh']}")
    check(got["loss"] == one["loss"] and got["aux"] == one["aux"],
          f"dist nccl: loss {got['loss']} {got['aux']} != {one['loss']} {one['aux']}")
    differ = [n for n in one["state"] if got["state"][n] != one["state"][n] or got["grads"][n] != one["grads"][n]]
    check(not differ, f"dist nccl: {len(differ)} parameters or gradients differ, first {differ[:3]}")
    for c in COUNTERS:
        ranks_launched[c] += nccl[0][0]["launches"][c]
    check(got["launches"]["LAUNCHES"] == got["launches"]["BWD_LAUNCHES"] == MERGED_K1_PER_FORWARD,
          f"dist nccl: launches {got['launches']}")
    emit("dist_nccl_world1", seconds=nccl_seconds, one_process_seconds=one_seconds, ranks=1, backend="nccl",
         loss=got["loss"], aux=got["aux"], parameters_equal=len(one["state"]),
         gradients_equal=len(one["grads"]), k1_launches=got["launches"]["LAUNCHES"],
         k2_launches=got["launches"]["BWD_LAUNCHES"], cudnn_deterministic=True, nvidia_smi=smi)

    # 2. two gloo ranks sharing the card: a data-parallel train step (4 clips
    # a rank), tensor-parallel VideoMAE (r 150) and ViViT (r 300, the biased
    # K1) serving, and test_net on two data ranks, in one launch
    dp_cfg = train_cfg(*TRAIN_STEP_OPTS, "OUTPUT_DIR", str(DIST_OUT / "dp"))
    dp_frames, dp_labels = dist_batch(dp_cfg)
    tp = ("TPU.MODEL_PARALLEL", "2", "TEST.BATCH_SIZE", "8")
    unmerged = ("TOME.ENABLE", "False")
    video = np.random.default_rng(21).random((8, 16, 224, 224, 3), dtype=np.float32)
    vivit_video = np.random.default_rng(22).random((8, 32, 224, 224, 3), dtype=np.float32)
    eval_cfgs = {n: main_cfg(*DIST_EVAL_OPTS, "OUTPUT_DIR", str(DIST_OUT / n),
                             "TEST.SAVE_RESULTS_PATH", str(DIST_OUT / n / "results.pkl"))
                 for n in ("test_one", "test_two")}
    for n in eval_cfgs:
        (DIST_OUT / n).mkdir(parents=True)
    tp_probes, tp_context = tp_plan()
    plan = [
        ("train", dp_cfg, (None, dp_frames, dp_labels), dict(want_state=False, checkpoint_dir=str(DIST_OUT / "dp"))),
        ("eval", main_cfg(*tp), (None, video), {}),
        ("eval", main_cfg(*tp, *unmerged), (None, video), {}),
        ("eval", vivit_cfg(*tp), (None, vivit_video), {}),
        ("eval", vivit_cfg(*tp, *unmerged), (None, vivit_video), {}),
        ("test_net", eval_cfgs["test_two"], (), {}),
    ]
    own = len(plan)
    t0 = time.perf_counter()
    gloo = launch_job(dp_cfg, dist_rank, ["cuda:0", "cuda:0"], backend="gloo", timeout=DIST_TIMEOUT,
                      join_timeout=DIST_JOIN_TIMEOUT, args=("gloo", plan + tp_probes))
    gloo_seconds = time.perf_counter() - t0
    tp_parts, gloo = [rank[own:] for rank in gloo], [rank[:own] for rank in gloo]
    for rank in gloo:
        for part in rank:
            for c in COUNTERS:
                ranks_launched[c] += part["launches"][c]
    seconds = lambda i: [rank[i]["seconds"] for rank in gloo]  # noqa: E731

    # 2a. the data-parallel step against the one-process B8 step
    dp = [rank[0]["result"] for rank in gloo]
    one = probes.train_probe(dp_cfg, cuda, None, dp_frames, dp_labels)
    for r, got in enumerate(dp):
        check(got["mesh"] == {"data": 2, "model": 1} and got["loss"] == dp[0]["loss"], f"dist dp rank {r}")
        check(got["launches"]["LAUNCHES"] == got["launches"]["BWD_LAUNCHES"] == MERGED_K1_PER_FORWARD,
              f"dist dp rank {r}: launches {got['launches']}")
    loss_err = abs(dp[0]["loss"] - one["loss"])
    check(loss_err <= DIST_LOSS_REL * abs(one["loss"]), f"dist dp: loss {dp[0]['loss']} {one['loss']}")
    saved = torch.load(dp[0]["checkpoint"], map_location="cpu", weights_only=True)
    check(not any(k.startswith("module.") for k in saved["model_state"]), "dist dp: a DDP prefix in the file")
    lr = dp_cfg.SOLVER.BASE_LR  # constant, no layer decay
    worst, flipped, total = 0.0, 0, 0
    for name, want in one["state"].items():
        diff = np.abs(saved["model_state"][name].float().numpy() - want)
        worst = max(worst, float(diff.max()))
        flipped += int((diff > lr).sum())
        total += diff.size
    check(worst <= 2 * lr * (1 + 1e-3) + 1e-6, f"dist dp: a parameter {worst} from the one-process step's")
    check(flipped <= DIST_FLIP_SHARE * total, f"dist dp: {flipped} of {total} elements moved the other way")
    del saved, one
    emit("dist_dp_train", seconds=seconds(0), ranks=2, backend="gloo", clips_a_rank=4, loss=dp[0]["loss"],
         loss_abs_err=loss_err, parameter_max_abs_err=worst, lr=lr, flipped_elements=flipped,
         elements=total, k1_launches_per_rank=dp[0]["launches"]["LAUNCHES"],
         k2_launches_per_rank=dp[0]["launches"]["BWD_LAUNCHES"], checkpoint="whole, no module. prefix",
         nvidia_smi=smi)
    torch.cuda.empty_cache()

    # 2b, 2c. tensor-parallel serving against one process
    dist_serve_check("tp_videomae", one_process_serves(main_cfg, video),
                     {"merged": [rank[1]["result"] for rank in gloo], "unmerged": [rank[2]["result"] for rank in gloo]},
                     {"merged": MERGED_COUNTS, "unmerged": (1568,) * 13},
                     {"merged": MERGED_K1_PER_FORWARD, "unmerged": 12}, seconds(1) + seconds(2), smi)
    dist_serve_check("tp_vivit", one_process_serves(vivit_cfg, vivit_video),
                     {"merged": [rank[3]["result"] for rank in gloo], "unmerged": [rank[4]["result"] for rank in gloo]},
                     {"merged": VIVIT_COUNTS, "unmerged": (3137,) * 13}, VIVIT_K1_PER_FORWARD,
                     seconds(3) + seconds(4), smi)

    # 2d. test_net on two data ranks against one process
    t0 = time.perf_counter()
    before = launch_counts()
    one_stats = test_net.test(eval_cfgs["test_one"])
    one_k1 = flash_attention.LAUNCHES - before["LAUNCHES"]
    one_seconds = time.perf_counter() - t0
    two_stats = [rank[5]["result"] for rank in gloo]
    check(two_stats[0] == two_stats[1] == one_stats, f"dist test_net: stats {two_stats} != {one_stats}")
    preds = {}
    for n in eval_cfgs:
        with open(DIST_OUT / n / "results.pkl", "rb") as f:
            preds[n] = pickle.load(f)  # written by this script's own runs
    check(np.array_equal(preds["test_one"]["labels"], preds["test_two"]["labels"]), "dist test_net: labels")
    preds_err = float(np.abs(preds["test_one"]["preds"] - preds["test_two"]["preds"]).max())
    check(preds_err <= EVAL_SUM_TOL, f"dist test_net: per-video predictions {preds_err} apart")
    clips = 3 * EVAL_VIDEOS
    batches = -(-clips // eval_cfgs["test_one"].TEST.BATCH_SIZE)
    check(one_k1 == MERGED_K1_PER_FORWARD * batches, f"dist test_net: {one_k1} K1 launches in one process")
    emit("dist_test_net", seconds=seconds(5), one_process_seconds=one_seconds, ranks=2, backend="gloo",
         stats=one_stats[0][1], clips=clips, batches=batches, rows_a_rank=eval_cfgs["test_one"].TEST.BATCH_SIZE // 2,
         preds_max_abs_err=preds_err, nvidia_smi=smi)

    total = launch_counts()  # read right after the path ran
    for c in COUNTERS:
        total[c] += ranks_launched[c]
    check(total["LAUNCHES"] > 0 and total["BWD_LAUNCHES"] > 0, "dist: K1 and K2 launched")
    check(all(n == 0 for c, n in total.items() if c not in ("LAUNCHES", "BWD_LAUNCHES")),
          f"dist: another path's kernels: {total}")
    shutil.rmtree(DIST_OUT, ignore_errors=True)
    emit("dist", seconds_gloo_launch=gloo_seconds, launches=total, ranks_launches=ranks_launched, nvidia_smi=smi)
    return total, (tp_parts, tp_context)


def dist_rank(cfg, device, backend: str, plan) -> list:
    """What each spawned rank of the dist phase runs: the same full-fp32
    product and convolution settings as this script, then the plan's
    probes, each with the kernels' launches it made in this rank."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = backend == "nccl"
    out = []
    for step in plan:
        before = probes.launch_counts()
        part = probes.run_probes(cfg, device, [step])[0]
        part["launches"] = {c: n - before[c] for c, n in probes.launch_counts().items()}
        out.append(part)
    return out


def replay_step(cfg, grads: dict) -> dict:
    """One process's optimizer step for ``cfg`` from the seeded start that
    ``build_trainer`` makes, at DIST_EPOCH's learning rate, on the given
    gradients (by name): the parameters after, fp32 on the CPU."""
    trainer = build_trainer(cfg)
    set_lr(trainer.optimizer, trainer.lr_at(DIST_EPOCH))
    for n, p in trainer.module.named_parameters():
        p.grad = grads[n].to(p.device, p.dtype)
    trainer.optimizer.step()
    return {n: p.detach().float().cpu() for n, p in trainer.module.named_parameters()}


def relative_error(got: np.ndarray, want: np.ndarray) -> float:
    """||got - want|| / ||want|| in fp64 (want not all zero)."""
    want = want.astype(np.float64)
    return float(np.linalg.norm(got.astype(np.float64) - want) / np.linalg.norm(want))


def tp_train_check(name: str, cfg_fn, opts, got_ranks: list, frames, labels, fwd: str, bwd, per_step: int,
                   seconds: list, smi: str, zero_gradients=()) -> dict:
    """A tensor-parallel train step (two ranks, one model group, B4, bf16)
    against one process, leaf by leaf: the loss within DIST_LOSS_REL of
    one process's bf16 loss; each parameter's gradient on the ranks
    (gathered whole) within TP_GRAD_FACTOR times one process's own bf16
    gradient error on that leaf, both by relative L2 norm against one
    process's fp32 gradient, that error taken at least at the median
    leaf's; a gradient zero in fp32 zero on the ranks too (the parameters in
    ``zero_gradients``, zero analytically, are rounding noise in every run
    and not compared); the ranks' parameters after the step one process's
    optimizer step on the ranks' gradients within TP_REPLAY_TOL. The
    kernels' launches a rank (``fwd``, ``bwd``: counters, or None) as one
    process's. Returns each leaf's (ranks', one process's) gradient error."""
    cuda = torch.device("cuda")
    cfg = cfg_fn(*opts)
    one = probes.train_probe(cfg, cuda, None, frames, labels, generators=True, epoch=DIST_EPOCH)
    fp32 = probes.train_probe(cfg_fn(*opts, "TPU.COMPUTE_DTYPE", "float32"), cuda, None, frames, labels,
                              generators=True, epoch=DIST_EPOCH)["grads"]
    lr = get_lr_at_epoch(cfg, DIST_EPOCH)
    check(lr > 0, f"tp {name}: lr {lr} at epoch {DIST_EPOCH}")
    for r, got in enumerate(got_ranks):
        check(got["mesh"] == {"data": 1, "model": 2} and got["loss"] == got_ranks[0]["loss"], f"tp {name} rank {r}")
        for counter in (fwd, bwd):
            if counter is not None:
                check(got["launches"][counter] == one["launches"][counter] == per_step,
                      f"tp {name} rank {r}: {counter} {got['launches']} one process {one['launches']}")
    loss_err = abs(got_ranks[0]["loss"] - one["loss"])
    check(loss_err <= DIST_LOSS_REL * abs(one["loss"]), f"tp {name}: loss {got_ranks[0]['loss']} {one['loss']}")

    grads = torch.load(TP_OUT / name / "grads.pt", map_location="cpu", weights_only=True)
    check(grads.keys() == fp32.keys(), f"tp {name}: the ranks' gradients name other parameters")
    leaves, zero = {}, 0
    for pname, want in fp32.items():
        if any(z in pname for z in zero_gradients):
            continue
        got = grads[pname].numpy()
        if not want.any():
            check(not got.any(), f"tp {name}: {pname}'s gradient is zero in one process, not on the ranks")
            zero += 1
            continue
        leaves[pname] = (relative_error(got, want), relative_error(one["grads"][pname], want))
    floor = float(np.median([e for _, e in leaves.values()]))
    ratio = {n: t / (TP_GRAD_FACTOR * max(o, floor)) for n, (t, o) in leaves.items()}
    worst_leaf = max(ratio, key=ratio.get)
    check(ratio[worst_leaf] <= 1.0, f"tp {name}: {worst_leaf}'s gradient {leaves[worst_leaf][0]} from fp32's, "
          f"one process's {leaves[worst_leaf][1]} (median leaf {floor})")

    saved = torch.load(got_ranks[0]["checkpoint"], map_location="cpu", weights_only=True)["model_state"]
    replayed = replay_step(cfg, grads)
    replay_err = max(float((saved[n].float() - p).abs().max()) for n, p in replayed.items())
    check(replay_err <= TP_REPLAY_TOL, f"tp {name}: the ranks' parameters {replay_err} from one process's "
          "optimizer step on the ranks' gradients")
    row = dict(seconds=seconds, ranks=2, backend="gloo", mesh={"data": 1, "model": 2}, clips=len(frames),
               loss=got_ranks[0]["loss"], one_process_loss=one["loss"], loss_abs_err=loss_err,
               grad_leaves=len(leaves), grad_leaves_zero=zero, grad_leaves_noise=len(fp32) - len(leaves) - zero,
               grad_rel_err_max=max(t for t, _ in leaves.values()),
               grad_rel_err_one_process_median=floor, grad_rel_err_one_process_max=max(o for _, o in leaves.values()),
               # the leaves bf16 cannot resolve: one process's own error above a quarter
               grad_leaves_one_process_over_quarter=sum(o > 0.25 for _, o in leaves.values()),
               ranks_over_one_process_max=max(t / max(o, floor) for t, o in leaves.values()),
               worst_leaf=worst_leaf, worst_leaf_errs=leaves[worst_leaf],
               worst_leaf_share_of_limit=ratio[worst_leaf], replay_max_abs_err=replay_err, lr=lr,
               launches_per_rank=got_ranks[0]["launches"], cut_parameters=len(got_ranks[0]["cut_shapes"]),
               checkpoint="whole", nvidia_smi=smi)
    emit(f"tp_{name}_train", **row)
    del saved, one, fp32, grads, replayed
    torch.cuda.empty_cache()
    return leaves


def tp_plan() -> tuple:
    """The ``tp`` phase's probes for two gloo ranks sharing the card as one
    model group (they run in the ``dist`` phase's launch, after its own, so
    that the ranks start once), and what its checks need. Serving at B8,
    bf16: TimeSformer ViT-B 8 x 224 and Motionformer ViT-B 16 x 224 (r 18,
    merged and unmerged), MViTv2-S 16 x 4; one train step each at B4."""
    shutil.rmtree(TP_OUT, ignore_errors=True)
    tp = ("TPU.MODEL_PARALLEL", "2", "TEST.BATCH_SIZE", "8")
    unmerged = ("TOME.ENABLE", "False")
    videos = dict(ts=np.random.default_rng(31).random((8, 8, 224, 224, 3), dtype=np.float32),
                  mf=np.random.default_rng(32).random((8, 16, 224, 224, 3), dtype=np.float32),
                  mvit=np.random.default_rng(33).random((8, 16, 224, 224, 3), dtype=np.float32))
    # all three steps in bf16, as users train; tp_train_check holds their
    # gradients, not the optimizer's moves (a first AdamW step moves an
    # element by lr whatever its gradient's size)
    trains = {
        "timesformer": (ts_train_cfg, TS_TRAIN_STEP_OPTS, "BLOCKDIAG_LAUNCHES", "BLOCKDIAG_BWD_LAUNCHES",
                        TS_K5_PER_FORWARD["merged"], ()),
        "motionformer": (mf_train_cfg, MF_TRAIN_STEP_OPTS, "FRAME_LAUNCHES", "FRAME_BWD_LAUNCHES",
                         MF_K3_PER_FORWARD["merged"], MF_ZERO_GRADIENTS),
        "mvit": (mvit_cfg, MVIT_RUN_OPTS, None, None, 0, ("attn.norm_k.bias",)),
    }
    batches, plan = {}, [
        ("eval", ts_cfg(*tp), (None, videos["ts"]), {}),
        ("eval", ts_cfg(*tp, *unmerged), (None, videos["ts"]), {}),
        ("eval", mf_cfg(*tp), (None, videos["mf"]), {}),
        ("eval", mf_cfg(*tp, *unmerged), (None, videos["mf"]), {}),
        ("eval", mvit_cfg(*tp), (None, videos["mvit"]), {}),
    ]
    for name, (cfg_fn, opts, *_) in trains.items():
        cfg = cfg_fn(*opts, "TRAIN.BATCH_SIZE", str(TP_TRAIN_BATCH))
        batches[name] = dist_batch(cfg, TP_TRAIN_BATCH)
        (TP_OUT / name).mkdir(parents=True)
        plan.append(("train", cfg_fn(*opts, "TRAIN.BATCH_SIZE", str(TP_TRAIN_BATCH), "TPU.MODEL_PARALLEL", "2"),
                     (None, *batches[name]), dict(want_state=False, generators=True, epoch=DIST_EPOCH,
                                                  checkpoint_dir=str(TP_OUT / name),
                                                  grads_file=str(TP_OUT / name / "grads.pt"))))
    return plan, dict(videos=videos, trains=trains, batches=batches)


def phase_tp(smi: str, gloo: list, context: dict) -> dict:
    """Tensor parallelism beyond VideoMAE and ViViT at full width: the
    ranks' results of ``tp_plan`` (``gloo``: each rank's parts) against the
    same runs in this process. Serving: K5a 12 and K3 10 / 12 launches a
    rank at 6 heads, MViTv2-S's one-head first block whole. Train steps,
    all bf16 (``tp_train_check``): K5a + K5b, K3 + K4, MViT's plain
    products. Then
    ``LOG_MODEL_INFO``'s statistics of VideoMAE ViT-B merged and unmerged:
    the card's GFLOP (the kernels' own products added) equal to the CPU
    count of the same model. Returns the kernels' launches in the phase,
    the ranks' included."""
    t_phase = time.perf_counter()
    zero_launch_counts()  # this path's counts start here
    ranks_launched = dict.fromkeys(COUNTERS, 0)
    unmerged = ("TOME.ENABLE", "False")
    videos, trains, batches = context["videos"], context["trains"], context["batches"]
    ts_video, mf_video, mvit_video = videos["ts"], videos["mf"], videos["mvit"]
    for rank in gloo:
        for part in rank:
            for c in COUNTERS:
                ranks_launched[c] += part["launches"][c]
    seconds = lambda i: [rank[i]["seconds"] for rank in gloo]  # noqa: E731
    result = lambda i: [rank[i]["result"] for rank in gloo]  # noqa: E731

    dist_serve_check("tp_timesformer", one_process_serves(ts_cfg, ts_video),
                     {"merged": result(0), "unmerged": result(1)}, None, TS_K5_PER_FORWARD,
                     seconds(0) + seconds(1), smi, counter="BLOCKDIAG_LAUNCHES", heads_key="k5a_heads")
    dist_serve_check("tp_motionformer", one_process_serves(mf_cfg, mf_video),
                     {"merged": result(2), "unmerged": result(3)}, None, MF_K3_PER_FORWARD,
                     seconds(2) + seconds(3), smi, counter="FRAME_LAUNCHES", heads_key="k3_heads")
    mvit_ranks = result(4)
    whole = [n for n in ("blocks.0.attn.qkv.weight", "blocks.1.attn.qkv.weight") if n not in mvit_ranks[0]["cut_shapes"]]
    check(whole == ["blocks.0.attn.qkv.weight"], f"tp mvit: attentions left whole {whole}")
    dist_serve_check("tp_mvit", one_process_serves(mvit_cfg, mvit_video, labels=("unmerged",)),
                     {"unmerged": mvit_ranks}, None, None, seconds(4), smi, counter=None)
    for i, (name, (cfg_fn, opts, fwd, bwd, per_step, zero)) in enumerate(trains.items()):
        tp_train_check(name, cfg_fn, (*opts, "TRAIN.BATCH_SIZE", str(TP_TRAIN_BATCH)), result(5 + i),
                       *batches[name], fwd, bwd, per_step, seconds(5 + i), smi, zero)

    # LOG_MODEL_INFO: VideoMAE ViT-B on the card, its count against the CPU's
    info = {}
    for label, opts in (("merged", ()), ("unmerged", unmerged)):
        cfg = main_cfg("TEST.BATCH_SIZE", "1", *opts)
        bundle = build_model(cfg, torch.device("cuda"))
        before = launch_counts()
        stats = model_info.log_model_info(bundle, cfg)
        k1 = flash_attention.LAUNCHES - before["LAUNCHES"]
        del bundle
        # the same model on the CPU, in fp32 (the dtype changes no product)
        cpu_cfg = main_cfg("TEST.BATCH_SIZE", "1", "TPU.COMPUTE_DTYPE", "float32", *opts)
        sample = torch.zeros((1, cpu_cfg.DATA.NUM_FRAMES, 224, 224, 3))
        cpu_module = build_model(cpu_cfg, torch.device("cpu")).module
        cpu_flops = model_info.flop_count(cpu_module, sample)
        check(stats["gflops_per_clip"] == round(cpu_flops / 1e9, 3),
              f"model info {label}: card {stats['gflops_per_clip']} GFLOP, CPU {cpu_flops / 1e9}")
        check(k1 == (MERGED_K1_PER_FORWARD if label == "merged" else 12), f"model info {label}: {k1} K1 launches")
        check(stats["params"] == model_info.params_count(cpu_module) and stats["hbm_bytes_limit"] > 0,
              f"model info {label}: {stats}")
        info[label] = dict(stats, cpu_gflops=cpu_flops / 1e9, k1_launches=k1,
                           xla_gflops_per_clip=XLA_GFLOPS_PER_CLIP[label])
        del cpu_module
        torch.cuda.empty_cache()
    emit("tp_model_info", **info, nvidia_smi=smi)

    total = launch_counts()  # read right after the path ran
    for c in COUNTERS:
        total[c] += ranks_launched[c]
    for c in ("FRAME_LAUNCHES", "FRAME_BWD_LAUNCHES", "BLOCKDIAG_LAUNCHES", "BLOCKDIAG_BWD_LAUNCHES"):
        check(ranks_launched[c] > 0, f"tp: {c} never launched on the ranks")
    shutil.rmtree(TP_OUT, ignore_errors=True)
    emit("tp", seconds=time.perf_counter() - t_phase, rank_seconds=[sum(p["seconds"] for p in rank) for rank in gloo],
         launches=total, ranks_launches=ranks_launched, nvidia_smi=smi)
    return total


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


@contextlib.contextmanager
def tf32(on: bool):
    """cuDNN's convolutions and cuBLAS's fp32 products in TF32 (on) or full
    fp32 (off) inside, this script's setting (full fp32) after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@torch.no_grad()
def moved_bn(module: torch.nn.Module, seed: int, final_scale: float) -> None:
    """Every BatchNorm's weight, bias and running statistics drawn from
    numpy's ``seed``: weights about 1, except each block's final BatchNorm
    (which the seeded init leaves at 0, so that its residual branch would
    compute nothing), whose weights are about ``final_scale``. The draws do
    not depend on ``final_scale``."""
    rng = np.random.default_rng(seed)
    for bn in convnet.batchnorms(module):
        c = bn.weight.numel()
        scale = final_scale if bn.zero_init else 1.0
        for t, v in ((bn.weight, scale * (1 + 0.1 * rng.standard_normal(c))), (bn.bias, 0.1 * rng.standard_normal(c)),
                     (bn.running_mean, 0.1 * rng.standard_normal(c)), (bn.running_var, np.exp(0.2 * rng.standard_normal(c)))):
            t.copy_(torch.from_numpy(v.astype(np.float32)))


def conv_card_against_cpu(tag: str, cfg, batch: int, seed: int) -> dict:
    """One eval forward of ``cfg``'s model at the test crop for each of
    SF_FINAL_BN_SCALES (``moved_bn``): in fp64 on the CPU (the truth), in
    fp32 on the CPU, in fp32 on the card with TF32 off and on, and in fp64 on
    the card; the probabilities, and the projection's logits averaged over
    T, H, W. Each error is of the largest entry of the CPU's fp64 output.
    Checks, with TF32 off: the card's fp32 error at most SF_FP64_FACTOR times
    the CPU's own plus SF_FP64_FLOOR; the card's fp64 within SF_FP64_TOL;
    and, where the CPU's fp32 is itself within SF_CPU_TOL / SF_FP64_FACTOR
    of fp64, the card's fp32 within SF_CPU_TOL of the CPU's fp32."""
    t, s = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
    module = build_model(cfg, "cpu").module
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((batch, t, s, s, 3)).astype(np.float32))

    def outputs(x):
        """The probabilities, and the projection's logits averaged over T, H, W."""
        seen = []
        hook = module.head.projection.register_forward_hook(lambda m, a, out: seen.append(out))
        try:
            probs = module(x)[0]
        finally:
            hook.remove()
        return {"softmax": probs.double().cpu().numpy(), "logits": seen[0].mean(dim=(1, 2, 3)).double().cpu().numpy()}

    result = {"batch": batch, "frames": t, "crop": s}
    for final_scale in SF_FINAL_BN_SCALES:
        module.to("cpu", torch.float32)
        moved_bn(module, seed, final_scale)
        with torch.inference_mode():
            runs = {"cpu_fp32": outputs(x)}
            module.double()
            runs["cpu_fp64"] = outputs(x.double())
            module.to("cuda")
            runs["card_fp64"] = outputs(x.cuda().double())
            module.float()
            for on in (False, True):
                with tf32(on):
                    runs[f"card_fp32_tf32_{'on' if on else 'off'}"] = outputs(x.cuda())
        truth = runs.pop("cpu_fp64")
        here = {}
        for act in truth:
            check(np.isfinite(truth[act]).all() and truth[act].shape == (batch, 400),
                  f"{tag}: CPU output {truth[act].shape}")
            scale = np.abs(truth[act]).max()
            err = {run: float(np.abs(out[act] - truth[act]).max() / scale) for run, out in runs.items()}
            card_cpu = float(np.abs(runs["card_fp32_tf32_off"][act] - runs["cpu_fp32"][act]).max() / scale)
            held = err["cpu_fp32"] <= SF_CPU_TOL / SF_FP64_FACTOR
            what = f"{tag}, final BatchNorms about {final_scale}, {act}"
            check(err["card_fp32_tf32_off"] <= SF_FP64_FACTOR * err["cpu_fp32"] + SF_FP64_FLOOR,
                  f"{what}: card fp32 {err['card_fp32_tf32_off']} from fp64, CPU fp32 {err['cpu_fp32']}")
            check(err["card_fp64"] <= SF_FP64_TOL, f"{what}: card fp64 {err['card_fp64']} from the CPU's")
            check(not held or card_cpu <= SF_CPU_TOL, f"{what}: card against CPU, TF32 off: {card_cpu}")
            here[act] = dict(largest=float(scale), rel_err_to_fp64=err, card_vs_cpu_tf32_off=card_cpu,
                             card_vs_cpu_checked=held)
        result[f"final_bn_{final_scale}"] = here
    module.to("cpu", torch.float32)
    return result


# (kind, substring of a kernel's name), first match wins: where a conv
# family's train step spends its device time
CONV_KERNEL_KINDS = (
    ("conv_weight_gradient", "wgrad"), ("conv_input_gradient", "dgrad"), ("conv_forward", "fprop"),
    ("conv_forward", "convolveNd"), ("conv_forward", "conv"), ("layout_transposes", "nhwcToNchw"),
    ("layout_transposes", "nchwToNhwc"), ("layout_transposes", "convertTensor"),
    ("optimizer", "multi_tensor_apply"), ("reductions", "reduce_kernel"), ("elementwise", "elementwise"),
)


def device_time_by_kind(step, kinds) -> dict:
    """One synchronised call of ``step`` under torch.profiler: its kernels'
    device ms in all, by kind (``kinds``), and the 6 longest by name."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by_name = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
    check(bool(by_name), "torch.profiler recorded no device time")
    by_kind = {}
    for name, ms in by_name.items():
        kind = next((k for k, key in kinds if key in name), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(kernel_ms=sum(by_name.values()), by_kind_ms=by_kind, top_kernels_ms=[[n[:100], ms] for n, ms in top])


def phase_slowfast(smi: str) -> None:
    """SlowFast 8x8 R50 (Kinetics-400) at full width through the conv
    families' paths on the card, fp32: card against CPU; ``model_benchmark``
    at B8 on 32 x 256 clips, TF32 off and on; ``test_net.test`` with the
    config's 10 views x 3 crops; train steps with dropout 0.5, precise BN, a
    checkpoint reload; two gloo ranks' step with the statistics of the
    global batch against the one-process B8 step; small I3D and X3D. No
    attention kernel may launch. One JSON line a check, with seconds."""
    shutil.rmtree(SF_OUT, ignore_errors=True)
    cuda = torch.device("cuda")
    zero_launch_counts()  # this path's counts start here
    ranks_launched = {c: 0 for c in COUNTERS}

    t0 = time.perf_counter()
    cpu = conv_card_against_cpu("slowfast", sf_cfg(*SF_RUN_OPTS), 2, 31)
    emit("slowfast_card_vs_cpu", seconds=time.perf_counter() - t0, tol=SF_CPU_TOL, factor=SF_FP64_FACTOR,
         floor=SF_FP64_FLOOR, fp64_tol=SF_FP64_TOL, **cpu, nvidia_smi=smi)

    bench = {}
    for label, on in (("tf32_off", False), ("tf32_on", True)):
        t0 = time.perf_counter()
        with tf32(on):
            stats = model_benchmark(sf_cfg(*SF_RUN_OPTS, "MODEL_BENCHMARK.ITERATIONS", "10",
                                           "MODEL_BENCHMARK.WARMUP_ITERATIONS", "3"))
        check(stats["batch_size"] == 8 and stats["clips_per_sec"] > 0, f"slowfast model_benchmark {stats}")
        bench[label] = dict(clips_per_sec=stats["clips_per_sec"], seconds=time.perf_counter() - t0)
    emit("slowfast_model_benchmark", batch=8, frames=32, crop=256, iterations=10, **bench,
         tf32_speedup=bench["tf32_on"]["clips_per_sec"] / bench["tf32_off"]["clips_per_sec"], nvidia_smi=smi)

    t0 = time.perf_counter()
    cfg = sf_cfg(*SF_RUN_OPTS, "OUTPUT_DIR", str(SF_OUT / "test"))
    with recording_test_net() as seen:
        results = test_net.test(cfg)
    views, stats = results[0]
    meter = seen[0]
    clips = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    check((views, clips) == (10, 30), f"slowfast test_net: {views} views, {clips} clips a video")
    check(bool((meter.clip_count == clips).all()), f"slowfast test_net: clip counts {meter.clip_count.tolist()}")
    sums = meter.video_preds.sum(axis=1)  # each clip's probabilities sum to 1
    check(np.isfinite(meter.video_preds).all() and bool(np.abs(sums - clips).max() <= 1e-3),
          f"slowfast test_net: ensembles sum to {sums.tolist()}")
    check(all(np.isfinite(float(stats[k])) for k in ("top1_acc", "top5_acc")), f"slowfast test_net: {stats}")
    videos = len(meter.clip_count)
    emit("slowfast_test_net", seconds=time.perf_counter() - t0, views=views, crops=cfg.TEST.NUM_SPATIAL_CROPS,
         videos=videos, clips=videos * clips, batch=cfg.TEST.BATCH_SIZE, stats=stats,
         clips_per_sec=videos * clips / sum(meter.batch_seconds),
         steady_clips_per_sec=(videos * clips - cfg.TEST.BATCH_SIZE) / sum(meter.batch_seconds[1:]),
         nvidia_smi=smi)

    # train steps on one fixed batch with dropout on, precise BN, a reload
    t0 = time.perf_counter()
    cfg = sf_cfg(*SF_RUN_OPTS, "OUTPUT_DIR", str(SF_OUT / "train"))
    torch.cuda.reset_peak_memory_stats()
    trainer = build_trainer(cfg)
    frames, labels = fixed_batch(cfg)
    check(tuple(frames.shape) == (8, 32, 224, 224, 3), f"slowfast batch {tuple(frames.shape)}")
    set_lr(trainer.optimizer, trainer.lr_at(0.0))
    losses, step_seconds = [], []
    for i in range(SF_TRAIN_STEPS):
        gen = torch.Generator(device="cuda").manual_seed(i)
        tick = time.perf_counter()
        losses.append(float(trainer.train_step(frames, labels, gen)[0]))
        torch.cuda.synchronize()
        step_seconds.append(time.perf_counter() - tick)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"slowfast train: losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    profiles = {}
    for label, on in (("tf32_off", False), ("tf32_on", True)):
        with tf32(on):
            profiles[label] = device_time_by_kind(lambda: trainer.train_step(frames, labels), CONV_KERNEL_KINDS)
    before = {k: v.clone() for k, v in trainer.module.named_buffers()}
    tick = time.perf_counter()
    refresh_bn_stats(cfg, trainer.module, construct_loader(cfg, "train"), cuda, 0)
    precise_seconds = time.perf_counter() - tick
    moved = sum(not torch.equal(v, before[k]) for k, v in trainer.module.named_buffers())
    check(moved == len(before) and all(bool(torch.isfinite(v).all()) for v in trainer.module.buffers()),
          f"slowfast precise BN: {moved} of {len(before)} statistics moved")
    torch.backends.cudnn.deterministic = True  # the same bits twice
    try:
        path = checkpoints.save_checkpoint(str(SF_OUT / "train"), trainer.module, trainer.optimizer, 0, cfg)
        twin = build_trainer(cfg)
        checkpoints.load_checkpoint(path, twin.module, twin.optimizer)
        nxt = [float(t.train_step(frames, labels, torch.Generator(device="cuda").manual_seed(9))[0])
               for t in (trainer, twin)]
    finally:
        torch.backends.cudnn.deterministic = False
    check(nxt[0] == nxt[1], f"slowfast: next loss after reload {nxt[1]} != {nxt[0]}")
    emit("slowfast_train", seconds=time.perf_counter() - t0, steps=SF_TRAIN_STEPS, batch=8, losses=losses,
         step_seconds=step_seconds, train_clips_per_sec=8 * (SF_TRAIN_STEPS - 1) / sum(step_seconds[1:]),
         peak_memory_gb=peak, dropout=cfg.MODEL.DROPOUT_RATE, precise_bn_batches=2,
         precise_bn_seconds=precise_seconds, next_losses=nxt, optimizer="sgd(momentum 0.9, wd 1e-4)",
         step_device_time=profiles, nvidia_smi=smi)
    del trainer, twin
    shutil.rmtree(SF_OUT / "train", ignore_errors=True)
    torch.cuda.empty_cache()

    # two gloo ranks sharing the card, 4 clips each, statistics over the
    # global batch, against the one-process B8 step (dropout off: the
    # ranks and the one process would draw other masks)
    t0 = time.perf_counter()
    step_cfg = sf_cfg(*SF_RUN_OPTS, "MODEL.DROPOUT_RATE", "0.0", "OUTPUT_DIR", str(SF_OUT / "dp"))
    np_frames, np_labels = frames.cpu().numpy(), labels.cpu().numpy()
    plan = [("train", step_cfg, (None, np_frames, np_labels),
             dict(want_state=False, checkpoint_dir=str(SF_OUT / "dp")))]
    gloo = launch_job(step_cfg, dist_rank, ["cuda:0", "cuda:0"], backend="gloo", timeout=DIST_TIMEOUT,
                      join_timeout=DIST_JOIN_TIMEOUT, args=("gloo", plan))
    for rank in gloo:
        for c in COUNTERS:
            ranks_launched[c] += rank[0]["launches"][c]
    dp = [rank[0]["result"] for rank in gloo]
    check(all(r["mesh"] == {"data": 2, "model": 1} for r in dp) and dp[0]["loss"] == dp[1]["loss"]
          and dp[0]["buffers"] == dp[1]["buffers"], "slowfast dp: the ranks disagree")
    two = torch.load(dp[0]["checkpoint"], map_location="cpu", weights_only=True)["model_state"]
    one = probes.train_probe(step_cfg, cuda, None, np_frames, np_labels, want_state=False,
                             checkpoint_dir=str(SF_OUT / "one"))
    one_sd = torch.load(one["checkpoint"], map_location="cpu", weights_only=True)["model_state"]
    # the same step in fp64 on the card: the truth both fp32 steps are held
    # to, each tensor's error no more than SF_DP_FACTOR times the one
    # process's own (plus two fp32 spacings of its values)
    bundle = build_model(step_cfg, cuda, fp32_params=True)
    bundle.module.double()
    ref = build_trainer(step_cfg, cuda, bundle=bundle)
    set_lr(ref.optimizer, ref.lr_at(0.0))
    ref_loss = float(ref.train_step(frames.double(), labels)[0])
    truth = {k: v.detach().cpu() for k, v in ref.module.state_dict().items()}
    del ref, bundle
    torch.cuda.empty_cache()

    def slack(x: float) -> float:
        return 2 * float(np.spacing(np.float32(abs(x))))

    loss_err = (abs(one["loss"] - ref_loss), abs(dp[0]["loss"] - ref_loss))
    check(loss_err[1] <= SF_DP_FACTOR * loss_err[0] + slack(ref_loss),
          f"slowfast dp: loss {dp[0]['loss']}, one process {one['loss']}, fp64 {ref_loss}")
    worst = {"params": 0.0, "stats": 0.0}
    for k, want in truth.items():
        errs = [float((sd[k].double() - want).abs().max()) for sd in (one_sd, two)]
        room = slack(float(want.abs().max()))
        check(errs[1] <= SF_DP_FACTOR * errs[0] + room,
              f"slowfast dp: {k} {errs[1]} from the fp64 step's, one process {errs[0]}")
        kind = "stats" if "running" in k else "params"
        worst[kind] = max(worst[kind], (errs[1] - room) / errs[0] if errs[0] else 0.0)
    emit("slowfast_dp_train", seconds=time.perf_counter() - t0, ranks=2, backend="gloo", clips_a_rank=4,
         loss=dp[0]["loss"], one_process_loss=one["loss"], fp64_loss=ref_loss, loss_errs_one_two=loss_err,
         worst_ratio_to_one_process=worst, factor=SF_DP_FACTOR,
         rank_seconds=[rank[0]["seconds"] for rank in gloo], nvidia_smi=smi)
    del two, one_sd
    shutil.rmtree(SF_OUT, ignore_errors=True)

    for tag, opts in (("i3d", I3D_OPTS), ("x3d_xs", X3D_XS_OPTS)):
        t0 = time.perf_counter()
        small = get_cfg()
        small.merge_from_list(opts)
        errors = conv_card_against_cpu(tag, small, 2, 41)
        emit(f"slowfast_{tag}_card_vs_cpu", seconds=time.perf_counter() - t0, tol=SF_CPU_TOL,
             factor=SF_FP64_FACTOR, floor=SF_FP64_FLOOR, fp64_tol=SF_FP64_TOL, **errors, nvidia_smi=smi)

    total = launch_counts()  # read right after the path ran
    check(all(n == 0 for n in total.values()) and all(n == 0 for n in ranks_launched.values())
          and all(n == 0 for n in ab_attention.AB_LAUNCHES.values()),
          f"the conv families launched an attention kernel: {total}, ranks {ranks_launched}")
    emit("slowfast", launches=total, ranks_launches=ranks_launched, nvidia_smi=smi)


@contextlib.contextmanager
def patched(obj, **attrs):
    """``obj``'s attributes set to ``attrs`` inside, restored after."""
    saved = {name: getattr(obj, name) for name in attrs}
    for name, value in attrs.items():
        setattr(obj, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(obj, name, value)


def check_no_attention_launches(phase: str) -> dict:
    """The kernels' counts, read right after a path that must launch none."""
    total = launch_counts()
    check(all(n == 0 for n in total.values()) and all(n == 0 for n in ab_attention.AB_LAUNCHES.values()),
          f"{phase} launched an attention kernel: {total}, {ab_attention.AB_LAUNCHES}")
    return total


def ptv_card_against_cpu(cfg, batch: int, seed: int) -> dict:
    """One eval forward of ``cfg``'s model at B``batch``, every BatchNorm
    moved off its init (``moved_bn``, each block's final one about 0.2), on
    the CPU and on the card in fp32 with TF32 off: the projection's logits
    averaged over T, H, W; the card's largest error relative to the CPU's
    largest logit, within PTV_CPU_TOL."""
    module = build_model(cfg, "cpu").module
    moved_bn(module, seed, 0.2)
    t, s = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((batch, t, s, s, 3)).astype(np.float32))

    def logits(x):
        seen = []
        hook = module.head.projection.register_forward_hook(lambda m, a, out: seen.append(out))
        try:
            with torch.inference_mode():
                module(x)
        finally:
            hook.remove()
        return seen[0].mean(dim=(1, 2, 3)).double().cpu().numpy()

    tick = time.perf_counter()
    cpu = logits(x)
    cpu_seconds = time.perf_counter() - tick
    module.to("cuda")
    with tf32(False):
        card = logits(x.cuda())
    scale = float(np.abs(cpu).max())
    err = float(np.abs(card - cpu).max()) / scale
    check(np.isfinite(cpu).all() and cpu.shape == (batch, cfg.MODEL.NUM_CLASSES) and err <= PTV_CPU_TOL,
          f"{cfg.MODEL.MODEL_NAME}: card against CPU {err} of the largest logit {scale}")
    return dict(batch=batch, frames=t, crop=s, largest_logit=scale, rel_err=err, cpu_seconds=cpu_seconds)


def depthwise_conv_times(module, cfg) -> list:
    """CSN's depthwise ``conv_b`` (3x3x3, groups = width) of blocks 0 and 1
    of each stage at the shapes a B8 forward gives them: the cuDNN
    forward and weight gradient by CUDA events in fp32 (TF32 off; no tensor
    core takes a depthwise conv), with the input in ``channels_last_3d`` (as
    the model keeps it) and in NCDHW, beside the bound: the larger of the
    bytes (input, output, weight once each) at 3.35 TB/s and 2 x 27 flops an
    output element at fp32's 67 TFLOP/s."""
    shapes = {}
    hooks = []
    for i in (2, 3, 4, 5):
        for j in (0, 1):
            conv = getattr(module, f"s{i}")._modules[f"res_{j}"].branch2.conv_b
            hooks.append(conv.register_forward_hook(
                lambda m, a, out, key=(i, j): shapes.__setitem__(key, (m, tuple(a[0].shape), tuple(out.shape)))))
    t, s = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
    try:
        with torch.inference_mode():
            module(torch.zeros(cfg.TEST.BATCH_SIZE, t, s, s, 3, device="cuda"))
    finally:
        for h in hooks:
            h.remove()
    rows = []
    with tf32(False):
        for (i, j), (conv, xin, xout) in sorted(shapes.items()):
            w = conv.weight.detach()
            flops = 2.0 * 27 * int(np.prod(xout))
            row = dict(stage=f"s{i}.res_{j}", input=xin, output=xout, stride=conv.stride, **{
                f"bound_ms_{what}": max(4.0 * (int(np.prod(xin)) + int(np.prod(xout)) + w.numel()) / PEAK_BYTES_PER_S,
                                        flops / PEAK_FP32_FLOPS) * 1e3 for what in ("fwd", "wgrad")})
            for label, fmt in (("channels_last_3d", torch.channels_last_3d), ("ncdhw", torch.contiguous_format)):
                x = torch.randn(xin, device="cuda").contiguous(memory_format=fmt)
                grad = torch.randn(xout, device="cuda").contiguous(memory_format=fmt)
                wf = w.contiguous(memory_format=fmt)
                row[f"fwd_ms_{label}"] = cuda_ms(lambda: F.conv3d(x, wf, None, conv.stride, conv.padding,
                                                                  conv.dilation, conv.groups), iters=10)
                row[f"wgrad_ms_{label}"] = cuda_ms(lambda: torch.ops.aten.convolution_backward(
                    grad, x, wf, None, conv.stride, conv.padding, conv.dilation, False, [0, 0, 0], conv.groups,
                    [False, True, False]), iters=10)
            rows.append(row)
            del x, grad, wf
    torch.cuda.empty_cache()
    return rows


def check_subbn_fold(module) -> float:
    """After ``refresh_bn_stats`` under ``sub_batchnorm``: each BatchNorm's
    eval mean the mean of its split means (bit for bit, the same reduction),
    its eval variance the mean of the split variances plus the variance of
    the split means. Returns the variance's largest relative error."""
    worst = 0.0
    for bn in convnet.batchnorms(module):
        k = bn.num_splits
        mean, var = bn.split_bn.running_mean.view(k, -1), bn.split_bn.running_var.view(k, -1)
        check(torch.equal(bn.bn.running_mean, mean.mean(dim=0)), "sub-BN fold: the eval mean is not the splits'")
        want = var.mean(dim=0) + (mean - mean.mean(dim=0)).square().mean(dim=0)
        worst = max(worst, float(((bn.bn.running_var - want).abs() / want.abs().max()).max()))
    check(worst <= 1e-6, f"sub-BN fold: the eval variance {worst} from the splits'")
    return worst


def phase_ptv(smi: str) -> None:
    """CSN 32x2 R101 and R(2+1)D 16x4 R50 (``CSN_OPTS``, ``R2PLUS1D_OPTS``)
    at full width, fp32: the card against the CPU at B1 / B2
    (``ptv_card_against_cpu``); ``perform_benchmark`` at B8, TF32 off and
    on; CSN's depthwise conv (``depthwise_conv_times``); then 3 train steps
    at B8 under ``BN.NORM_TYPE sub_batchnorm`` with 2 splits (the loss
    finite, every split statistic moved), where one step's device time goes
    (torch.profiler), the fold of the split statistics
    (``refresh_bn_stats``, ``check_subbn_fold``), and a checkpoint that
    reloads to the same next loss (cuDNN deterministic). No K1-K5b may
    launch. One JSON line a check, with seconds."""
    shutil.rmtree(PTV_OUT, ignore_errors=True)
    cuda = torch.device("cuda")
    zero_launch_counts()
    start = time.perf_counter()
    for tag, cfg_fn, cpu_batch in (("csn", csn_cfg, 1), ("r2plus1d", r2plus1d_cfg, 2)):
        t0 = time.perf_counter()
        errors = ptv_card_against_cpu(cfg_fn(*PTV_RUN_OPTS), cpu_batch, 51)
        emit(f"ptv_{tag}_card_vs_cpu", seconds=time.perf_counter() - t0, tol=PTV_CPU_TOL, **errors, nvidia_smi=smi)

        t0 = time.perf_counter()
        cfg = cfg_fn(*PTV_RUN_OPTS, "MODEL_BENCHMARK.ITERATIONS", "10", "MODEL_BENCHMARK.WARMUP_ITERATIONS", "3")
        module = build_model(cfg, cuda).module
        bench = {}
        for label, on in (("tf32_off", False), ("tf32_on", True)):
            with tf32(on):
                stats = perform_benchmark(module, cfg, cuda)
            check(stats["batch_size"] == 8 and stats["clips_per_sec"] > 0, f"{tag} perform_benchmark {stats}")
            bench[label] = stats["clips_per_sec"]
        extra = {"depthwise_conv_b": depthwise_conv_times(module, cfg)} if tag == "csn" else {}
        del module
        torch.cuda.empty_cache()
        emit(f"ptv_{tag}_serve", seconds=time.perf_counter() - t0, batch=8, frames=cfg.DATA.NUM_FRAMES,
             crop=cfg.DATA.TEST_CROP_SIZE, iterations=10, clips_per_sec=bench,
             tf32_speedup=bench["tf32_on"] / bench["tf32_off"], **extra, nvidia_smi=smi)

        t0 = time.perf_counter()
        cfg = cfg_fn(*PTV_RUN_OPTS, *PTV_SUB_BN, "OUTPUT_DIR", str(PTV_OUT / tag))
        torch.cuda.reset_peak_memory_stats()
        trainer = build_trainer(cfg)
        check({bn.num_splits for bn in convnet.batchnorms(trainer.module)} == {2}, f"{tag}: not 2 splits")
        frames, labels = fixed_batch(cfg)
        check(tuple(frames.shape) == (8, cfg.DATA.NUM_FRAMES, 224, 224, 3), f"{tag} batch {tuple(frames.shape)}")
        splits = {k: v.clone() for k, v in trainer.module.named_buffers() if ".split_bn." in k}
        set_lr(trainer.optimizer, trainer.lr_at(0.0))
        losses, step_seconds = [], []
        for i in range(PTV_TRAIN_STEPS):
            gen = torch.Generator(device="cuda").manual_seed(i)
            tick = time.perf_counter()
            losses.append(float(trainer.train_step(frames, labels, gen)[0]))
            torch.cuda.synchronize()
            step_seconds.append(time.perf_counter() - tick)
        check(all(np.isfinite(losses)), f"{tag} train: losses {losses}")
        buffers = dict(trainer.module.named_buffers())
        moved = sum(not torch.equal(buffers[k], v) for k, v in splits.items())
        check(moved == len(splits) > 0, f"{tag}: {moved} of {len(splits)} split statistics moved")
        peak = torch.cuda.max_memory_allocated() / 1e9
        profile = device_time_by_kind(lambda: trainer.train_step(frames, labels), CONV_KERNEL_KINDS)
        refresh_bn_stats(cfg, trainer.module, [], cuda, 0)
        fold_err = check_subbn_fold(trainer.module)
        torch.backends.cudnn.deterministic = True  # the same bits twice
        try:
            path = checkpoints.save_checkpoint(str(PTV_OUT / tag), trainer.module, trainer.optimizer, 0, cfg)
            twin = build_trainer(cfg)
            checkpoints.load_checkpoint(path, twin.module, twin.optimizer)
            nxt = [float(t.train_step(frames, labels, torch.Generator(device="cuda").manual_seed(9))[0])
                   for t in (trainer, twin)]
        finally:
            torch.backends.cudnn.deterministic = False
        check(nxt[0] == nxt[1] and np.isfinite(nxt[0]), f"{tag}: next loss after reload {nxt[1]} != {nxt[0]}")
        emit(f"ptv_{tag}_train", seconds=time.perf_counter() - t0, steps=PTV_TRAIN_STEPS, batch=8,
             norm_type="sub_batchnorm", num_splits=2, losses=losses, step_seconds=step_seconds,
             train_clips_per_sec=8 * (PTV_TRAIN_STEPS - 1) / sum(step_seconds[1:]), peak_memory_gb=peak,
             split_statistics_moved=moved, fold_var_rel_err=fold_err, next_losses=nxt,
             step_device_time_tf32_off=profile, nvidia_smi=smi)
        del trainer, twin, frames, labels
        shutil.rmtree(PTV_OUT / tag, ignore_errors=True)
        torch.cuda.empty_cache()
    emit("ptv", seconds=time.perf_counter() - start, launches=check_no_attention_launches("ptv"), nvidia_smi=smi)


def multigrid_train(cfg) -> tuple:
    """``train_net.train(cfg)`` on the card with its epochs and flips
    watched: each epoch's cfg shape and BN settings, every batch's shape,
    loss and seconds (the step read to the host); at each long-cycle flip,
    every parameter the same tensor with the same bits and every optimizer
    state tensor the same bits across ``adapt_batch_stats``. Returns
    (epochs, flips)."""
    epochs, flips, held = [], [], {}
    build, adapt, run_epoch = train_net.build_trainer, train_net.adapt_batch_stats, train_net.train_epoch

    def capturing_build(*args, **kwargs):
        held["trainer"] = build(*args, **kwargs)
        return held["trainer"]

    def watched_adapt(module, rebuilt):
        optimizer = held["trainer"].optimizer
        params = dict(module.named_parameters())
        bits = {n: p.detach().clone() for n, p in params.items()}
        state = {n: {k: v.clone() for k, v in optimizer.state[p].items() if torch.is_tensor(v)}
                 for n, p in params.items()}
        splits = sorted({bn.num_splits for bn in convnet.batchnorms(module)})
        adapt(module, rebuilt)
        after = dict(module.named_parameters())
        check(all(after[n] is p and torch.equal(p, bits[n]) for n, p in params.items()),
              "multigrid: a parameter changed at a flip")
        check(all(torch.equal(optimizer.state[params[n]][k], v) for n, s in state.items() for k, v in s.items()),
              "multigrid: the optimizer's state changed at a flip")
        flips.append(dict(splits=[splits, sorted({bn.num_splits for bn in convnet.batchnorms(module)})],
                          state_tensors=sum(len(s) for s in state.values()), parameters=len(params)))

    def watched_epoch(loader, train_step, optimizer, lr_at, cur_epoch, meter, cfg, device, *args, **kwargs):
        rows = []

        def step(frames, labels, generator=None):
            tick = time.perf_counter()
            out = train_step(frames, labels, generator)
            rows.append((tuple(frames.shape), float(out[0]), time.perf_counter() - tick))
            return out

        run_epoch(loader, step, optimizer, lr_at, cur_epoch, meter, cfg, device, *args, **kwargs)
        ms = [r[2] * 1e3 for r in rows]
        epochs.append(dict(
            epoch=cur_epoch, B=cfg.TRAIN.BATCH_SIZE, T=cfg.DATA.NUM_FRAMES, S=cfg.DATA.TRAIN_CROP_SIZE,
            norm_type=cfg.BN.NORM_TYPE, num_splits=cfg.BN.NUM_SPLITS,
            module_splits=sorted({bn.num_splits for bn in convnet.batchnorms(held["trainer"].module)}),
            iterations=len(rows), batch_shapes=[list(r[0]) for r in rows], losses=[r[1] for r in rows],
            ms_per_iter=float(np.mean(ms)), ms_per_iter_after_first=float(np.mean(ms[1:])) if len(ms) > 1 else None))

    with patched(train_net, build_trainer=capturing_build, adapt_batch_stats=watched_adapt,
                 train_epoch=watched_epoch):
        train(cfg)
    return epochs, flips


def phase_multigrid(smi: str) -> None:
    """``train_net.train`` under multigrid on synthetic clips at full width,
    fp32 with TF32 off. The long cycle on R(2+1)D 16x4 R50
    (``MG_LONG_OPTS``: every one of the four shapes one epoch): each
    epoch's batches the schedule's (B, T, S), its BatchNorms' splits the
    epoch's ``NORM_TYPE`` (sub_batchnorm 2, batchnorm, sync_batchnorm),
    parameters and optimizer state unchanged across each flip
    (``multigrid_train``). The short cycle on SlowFast 8x8 R50: the three
    phases' batches (B8 at 112, B4 at 158, B2 at 224). A line an epoch (B,
    T, S, NORM_TYPE, NUM_SPLITS, ms an iteration, losses). No K1-K5b may
    launch."""
    from vtm_torch.train.multigrid import MultigridSchedule, get_current_long_cycle_shape

    out = PTV_OUT / "multigrid"
    shutil.rmtree(out, ignore_errors=True)
    zero_launch_counts()
    start = time.perf_counter()
    cfg = r2plus1d_cfg(*MG_LONG_OPTS, "OUTPUT_DIR", str(out / "long"))
    schedule = MultigridSchedule()
    want_cfg = schedule.init_multigrid(r2plus1d_cfg(*MG_LONG_OPTS))
    epochs, flips = multigrid_train(cfg)
    check(len(epochs) == want_cfg.SOLVER.MAX_EPOCH == 4, f"multigrid: {len(epochs)} epochs")
    for e in epochs:
        b, t, s = get_current_long_cycle_shape(schedule.schedule, e["epoch"])
        want = [b * want_cfg.MULTIGRID.DEFAULT_B, t, s, s, 3]
        check((e["B"], e["T"], e["S"]) == tuple(want[:3]) and e["iterations"] == 16 // want[0]
              and all(shape == want for shape in e["batch_shapes"]), f"multigrid epoch {e['epoch']}: {e}")
        splits = e["num_splits"] if e["norm_type"] == "sub_batchnorm" else 1
        check(e["module_splits"] == [splits] and all(np.isfinite(e["losses"])), f"multigrid epoch {e}")
        emit("multigrid_long_epoch", model="PTVR2plus1D", **e, nvidia_smi=smi)
    check(len({(e["B"], e["T"], e["S"]) for e in epochs}) == 4 and len(flips) == 4
          and {e["norm_type"] for e in epochs} == {"sub_batchnorm", "batchnorm", "sync_batchnorm"},
          f"multigrid: shapes {[(e['B'], e['T'], e['S']) for e in epochs]}, {len(flips)} flips")
    emit("multigrid_long", seconds=time.perf_counter() - start, schedule=schedule.schedule, flips=flips,
         solver_steps=want_cfg.SOLVER.STEPS, solver_lrs=want_cfg.SOLVER.LRS, nvidia_smi=smi)

    t0 = time.perf_counter()
    epochs, flips = multigrid_train(sf_cfg(*SF_RUN_OPTS, *MG_SHORT_OPTS, "OUTPUT_DIR", str(out / "short")))
    phases = [shape for e in epochs for shape in e["batch_shapes"]]
    check(len(epochs) == 1 and not flips and phases[:3] == [[8, 32, 112, 112, 3], [4, 32, 158, 158, 3],
                                                            [2, 32, 224, 224, 3]]
          and all(np.isfinite(epochs[0]["losses"])), f"multigrid short cycle: {phases}")
    for e in epochs:
        emit("multigrid_short_epoch", model="SlowFast", **e, nvidia_smi=smi)
    emit("multigrid_short", seconds=time.perf_counter() - t0, nvidia_smi=smi)
    shutil.rmtree(out, ignore_errors=True)
    emit("multigrid", seconds=time.perf_counter() - start, launches=check_no_attention_launches("multigrid"),
         nvidia_smi=smi)


def write_charades(root: pathlib.Path) -> None:
    """A Charades frame-list set: ``train.csv`` and ``val.csv`` (the same
    videos) over CHARADES_VIDEOS videos of CHARADES_FRAMES JPEG frames of
    128 x 171, each frame labelled with the 1-3 actions of its video that
    span it (actions drawn from numpy's seed 0)."""
    import cv2

    rng = np.random.default_rng(0)
    lines = ["original_vido_id video_id frame_id path labels"]
    for v in range(CHARADES_VIDEOS):
        vid = f"vid{v:03d}"
        (root / "frames" / vid).mkdir(parents=True, exist_ok=True)
        actions = [(int(c), *sorted(rng.integers(0, CHARADES_FRAMES, 2)))
                   for c in rng.choice(CHARADES_CLASSES, 3, replace=False)]
        for f in range(CHARADES_FRAMES):
            rel = f"{vid}/{vid}_{f:06d}.jpg"
            cv2.imwrite(str(root / "frames" / rel), rng.integers(0, 255, (128, 171, 3), dtype=np.uint8))
            labels = [c for c, lo, hi in actions if lo <= f <= hi] or [actions[0][0]]
            lines.append(f"{vid} {v} {f} {rel} \"{','.join(str(c) for c in sorted(labels))}\"")
    for split in ("train", "val"):
        (root / f"{split}.csv").write_text("\n".join(lines) + "\n")


def phase_charades(smi: str) -> None:
    """The multi-label path: R(2+1)D 16x4 R50 with 157 classes,
    ``bce_logit`` and ``DATA.MULTI_LABEL`` on a frame-list set written under
    build/ (``write_charades``): one epoch of ``train_net.train`` (B4, the
    losses finite, the val epoch's mAP), then ``test_net.test`` of its
    checkpoint over 2 views x 3 crops a video (every video's 6 clips, its
    multi-hot label, the mAP finite in [0, 1]). No K1-K5b may launch."""
    shutil.rmtree(CHARADES_OUT, ignore_errors=True)
    zero_launch_counts()
    start = time.perf_counter()
    write_charades(CHARADES_OUT)
    written = time.perf_counter() - start
    cfg = r2plus1d_cfg(
        "DATA.PATH_TO_DATA_DIR", str(CHARADES_OUT), "DATA.PATH_PREFIX", str(CHARADES_OUT / "frames"),
        "MODEL.NUM_CLASSES", str(CHARADES_CLASSES), "MODEL.LOSS_FUNC", "bce_logit", "DATA.MULTI_LABEL", "True",
        "TRAIN.DATASET", "charades", "TEST.DATASET", "charades", "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "8",
        "SOLVER.MAX_EPOCH", "1", "TRAIN.EVAL_PERIOD", "1", "TRAIN.CHECKPOINT_PERIOD", "1",
        "TRAIN.AUTO_RESUME", "False", "SOLVER.OPTIMIZING_METHOD", "sgd", "SOLVER.BASE_LR", "0.01",
        "TEST.NUM_ENSEMBLE_VIEWS", "2", "TEST.NUM_SPATIAL_CROPS", "3", "OUTPUT_DIR", str(CHARADES_OUT / "out"))
    val, losses = [], []
    update = train_net.TrainMeter.update_stats

    class RecordingVal(train_net.ValMeter):
        def log_epoch_stats(self, cur_epoch):
            val.append(super().log_epoch_stats(cur_epoch))
            return val[-1]

    def recording_update(meter, top1, top5, loss, lr, mb):
        losses.append(float(loss))
        return update(meter, top1, top5, loss, lr, mb)

    t0 = time.perf_counter()
    with patched(train_net, ValMeter=RecordingVal), patched(train_net.TrainMeter, update_stats=recording_update):
        train(cfg)
    train_seconds = time.perf_counter() - t0
    check(len(losses) == CHARADES_VIDEOS // 4 and all(np.isfinite(losses)), f"charades train: losses {losses}")
    check(len(val) == 1 and 0.0 <= val[0]["map"] <= 1.0, f"charades val: {val}")

    t0 = time.perf_counter()
    with recording_test_net() as seen:
        results = test_net.test(cfg)
    views, stats = results[0]
    meter = seen[0]
    clips = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    check(views == 2 and bool((meter.clip_count == clips).all()), f"charades test: {views} views, {meter.clip_count}")
    check(meter.video_labels.shape == (CHARADES_VIDEOS, CHARADES_CLASSES)
          and bool((meter.video_labels.sum(axis=1) >= 1).all()), "charades test: the video labels")
    test_map = float(stats["map"]) / 100.0
    check(np.isfinite(meter.video_preds).all() and 0.0 <= test_map <= 1.0, f"charades test: {stats}")
    emit("charades", seconds=time.perf_counter() - start, write_seconds=written, train_seconds=train_seconds,
         train_losses=losses, val_map=val[0]["map"], test_map=test_map, test_views=views,
         test_crops=cfg.TEST.NUM_SPATIAL_CROPS, test_clips=CHARADES_VIDEOS * clips,
         test_seconds=time.perf_counter() - t0,
         test_clips_per_sec=CHARADES_VIDEOS * clips / sum(meter.batch_seconds),
         launches=check_no_attention_launches("charades"), nvidia_smi=smi)
    shutil.rmtree(CHARADES_OUT, ignore_errors=True)


def mvit_card_against_cpu(cfg, seed: int) -> dict:
    """One fp32 eval forward of ``cfg``'s model at B1 on the CPU and on the
    card (TF32 off): the head's logits (``head.projection``), the card's
    largest error relative to the CPU's largest logit, within MVIT_CPU_TOL."""
    cfg = cfg.clone()
    cfg.merge_from_list(["TPU.COMPUTE_DTYPE", "float32"])
    module = build_model(cfg, "cpu").module
    t, s = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((1, t, s, s, 3)).astype(np.float32))

    def logits(x):
        seen = []
        hook = module.head.projection.register_forward_hook(lambda m, a, out: seen.append(out))
        try:
            with torch.inference_mode():
                module(x)
        finally:
            hook.remove()
        return seen[0].double().cpu().numpy()

    tick = time.perf_counter()
    cpu = logits(x)
    cpu_seconds = time.perf_counter() - tick
    module.to("cuda")
    with tf32(False):
        card = logits(x.cuda())
    scale = float(np.abs(cpu).max())
    err = float(np.abs(card - cpu).max()) / scale
    check(np.isfinite(cpu).all() and cpu.shape == (1, cfg.MODEL.NUM_CLASSES) and err <= MVIT_CPU_TOL,
          f"{cfg.MODEL.MODEL_NAME}: card against CPU {err} of the largest logit {scale}")
    return dict(batch=1, frames=t, crop=s, largest_logit=scale, rel_err=err, tol=MVIT_CPU_TOL,
                cpu_seconds=cpu_seconds)


def mvit_serve(cfg) -> dict:
    """``perform_benchmark`` at B8 in bf16 (the config's compute dtype)."""
    module = build_model(cfg, torch.device("cuda")).module
    stats = perform_benchmark(module, cfg, torch.device("cuda"))
    check(stats["batch_size"] == 8 and stats["clips_per_sec"] > 0 and stats["attention_kernel_launches"] == 0,
          f"{cfg.MODEL.MODEL_NAME} perform_benchmark {stats}")
    return dict(module=module, clips_per_sec=stats["clips_per_sec"],
                forward_ms=1e3 * cfg.TEST.BATCH_SIZE / stats["clips_per_sec"])


def pool_conv_shapes(module, cfg, *inputs) -> dict:
    """The depthwise pooling convs of one B``TEST.BATCH_SIZE`` forward (of
    zero clips and ``inputs`` after them):
    ((N, C, T, H, W), kernel, stride) -> how many run at that shape."""
    counts = {}
    real = mvit_model.attention_pool

    def recording(x, thw, kernel, stride, mode, has_cls, *args, **kwargs):
        if mode == "conv" and kernel:
            key = ((x.shape[0] * x.shape[1], x.shape[3]) + tuple(thw), tuple(kernel), tuple(stride))
            counts[key] = counts.get(key, 0) + 1
        return real(x, thw, kernel, stride, mode, has_cls, *args, **kwargs)

    t, s = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
    with patched(mvit_model, attention_pool=recording), torch.inference_mode():
        module(torch.zeros(cfg.TEST.BATCH_SIZE, t, s, s, 3, device="cuda"), *inputs)
    return counts


def pool_conv_times(counts: dict) -> dict:
    """Each pooling conv shape's cuDNN forward, input gradient and weight
    gradient by CUDA events, in fp32 (the pooled q, k, v are fp32; TF32
    off, and no tensor core takes a depthwise conv), the input in
    ``channels_last_3d`` as the model gives it; beside each its bound: the
    larger of the bytes (the two activations and the kernel once each) at
    3.35 TB/s and 2 x 27 flops an output element at fp32's 67 TFLOP/s.
    Totals weighted by how many convs run at each shape."""
    rows, totals = [], {"fwd_ms": 0.0, "dgrad_ms": 0.0, "wgrad_ms": 0.0, "bound_ms": 0.0}
    with tf32(False):
        for (shape, kernel, stride), n in sorted(counts.items()):
            c = shape[1]
            pad = tuple(k // 2 for k in kernel)
            x = torch.randn(shape, device="cuda").contiguous(memory_format=torch.channels_last_3d)
            w = torch.randn((c, 1) + kernel, device="cuda")
            out = F.conv3d(x, w, None, stride, pad, 1, c)
            grad = torch.randn_like(out)
            row = dict(input=list(shape), output=list(out.shape), kernel=list(kernel), stride=list(stride), count=n)
            row["fwd_ms"] = cuda_ms(lambda: F.conv3d(x, w, None, stride, pad, 1, c), iters=10)
            for what, mask in (("dgrad_ms", [True, False, False]), ("wgrad_ms", [False, True, False])):
                row[what] = cuda_ms(lambda: torch.ops.aten.convolution_backward(
                    grad, x, w, None, stride, pad, (1, 1, 1), False, [0, 0, 0], c, mask), iters=10)
            nbytes = 4.0 * (x.numel() + out.numel() + w.numel())
            row["bound_ms"] = max(nbytes / PEAK_BYTES_PER_S, 2.0 * 27 * out.numel() / PEAK_FP32_FLOPS) * 1e3
            for key in totals:
                totals[key] += n * row[key]
            rows.append(row)
            del x, w, out, grad
    torch.cuda.empty_cache()
    return dict(shapes=rows, convs=sum(counts.values()), **{f"total_{k}": v for k, v in totals.items()})


def grad_group(name: str) -> str:
    """A parameter's group: its block or layer, else its top module."""
    parts = name.split(".")
    if parts[0] == "blocks" or parts[:2] == ["rev_backbone", "layers"]:
        return ".".join(parts[:3] if parts[0] == "rev_backbone" else parts[:2])
    return parts[0]


def rev_grad_errors(got: dict, want: dict) -> dict:
    """Each parameter group's largest gradient error, relative to each
    tensor's largest entry; the k pool's LayerNorm bias (zero analytically:
    a shift of every key's logit alike) left out."""
    groups = {}
    for k, w in want.items():
        if k.endswith("attn.norm_k.bias"):
            continue
        err = float((got[k] - w).abs().max() / w.abs().max().clamp_min(1e-30))
        groups[grad_group(k)] = max(groups.get(grad_group(k), 0.0), err)
    return groups


def step_memory(step) -> tuple:
    """(``step``'s result, its peak allocation above what was allocated before it, GB)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = step()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 1e9


def mvit_train_step(module, frames, labels, seed: int):
    """Forward (train mode, masks from a CUDA generator of ``seed``), cross
    entropy and backward: (loss, gradients)."""
    module.train().zero_grad(set_to_none=True)
    logits, _ = module(frames, generator=torch.Generator(device="cuda").manual_seed(seed))
    loss = F.cross_entropy(logits.float(), labels)
    loss.backward()
    out = loss.detach(), {k: p.grad.detach().float().clone() for k, p in module.named_parameters()}
    module.zero_grad(set_to_none=True)
    return out


def phase_mvit(smi: str) -> None:
    """MViTv2-S (``MVITV2_S_OPTS``) at full width: ``perform_benchmark`` at
    B8 in bf16; the card against the CPU at B1 in fp32; the depthwise
    pooling convs timed (``pool_conv_times``) beside their share of the
    serve forward and of a train step, and where the device time of each
    goes (torch.profiler); 3 train steps at B8 (drop path 0.2; the loss
    finite), a checkpoint that reloads to the same next loss;
    ``train_net.train`` for one epoch of 16 synthetic clips;
    ``MODEL.ACT_CHECKPOINT`` against the plain stack on one step, cuDNN
    deterministic: loss and every gradient bit for bit, and a lower peak;
    ``test_net.test`` over 2 views; ``PTVMViT`` built. No K1-K5b may launch."""
    shutil.rmtree(MVIT_OUT, ignore_errors=True)
    cuda = torch.device("cuda")
    zero_launch_counts()
    start = time.perf_counter()
    t0 = time.perf_counter()
    errors = mvit_card_against_cpu(mvit_cfg(*MVIT_RUN_OPTS), 61)
    emit("mvit_card_vs_cpu", seconds=time.perf_counter() - t0, **errors, nvidia_smi=smi)

    t0 = time.perf_counter()
    cfg = mvit_cfg(*MVIT_RUN_OPTS)
    serve = mvit_serve(cfg)
    module = serve.pop("module")
    counts = pool_conv_shapes(module, cfg)
    check(sum(counts.values()) == 48, f"MViTv2-S ran {sum(counts.values())} pooling convs a forward, not 48")
    video = torch.from_numpy(np.random.default_rng(3).random((8, 16, 224, 224, 3), dtype=np.float32)).cuda()

    def forward():
        with torch.inference_mode():
            module(video)

    serve_profile = device_time_by_kind(forward, MVIT_KERNEL_KINDS)
    del module
    torch.cuda.empty_cache()
    convs = pool_conv_times(counts)
    emit("mvit_serve", seconds=time.perf_counter() - t0, batch=8, dtype="bfloat16", **serve,
         pool_convs=convs, pool_conv_share_of_forward=convs["total_fwd_ms"] / serve["forward_ms"],
         forward_device_time=serve_profile, nvidia_smi=smi)

    t0 = time.perf_counter()
    cfg = mvit_cfg(*MVIT_RUN_OPTS, "OUTPUT_DIR", str(MVIT_OUT / "steps"))
    trainer = build_trainer(cfg)
    frames, labels = fixed_batch(cfg)
    set_lr(trainer.optimizer, trainer.lr_at(0.0))
    losses, step_seconds = [], []
    for i in range(MVIT_TRAIN_STEPS):
        gen = torch.Generator(device="cuda").manual_seed(i)
        tick = time.perf_counter()
        (loss, _, _), peak = step_memory(lambda: trainer.train_step(frames, labels, gen))
        losses.append(float(loss))
        step_seconds.append(time.perf_counter() - tick)
    check(all(np.isfinite(losses)), f"mvit train: losses {losses}")
    step_profile = device_time_by_kind(lambda: trainer.train_step(frames, labels), MVIT_KERNEL_KINDS)
    step_ms = 1e3 * sum(step_seconds[1:]) / (MVIT_TRAIN_STEPS - 1)
    torch.backends.cudnn.deterministic = True  # the same bits twice
    try:
        path = checkpoints.save_checkpoint(str(MVIT_OUT / "steps"), trainer.module, trainer.optimizer, 0, cfg)
        twin = build_trainer(cfg)
        checkpoints.load_checkpoint(path, twin.module, twin.optimizer)
        nxt = [float(t.train_step(frames, labels, torch.Generator(device="cuda").manual_seed(9))[0])
               for t in (trainer, twin)]
    finally:
        torch.backends.cudnn.deterministic = False
    check(nxt[0] == nxt[1] and np.isfinite(nxt[0]), f"mvit: next loss after reload {nxt[1]} != {nxt[0]}")
    del trainer, twin
    torch.cuda.empty_cache()
    emit("mvit_train", seconds=time.perf_counter() - t0, steps=MVIT_TRAIN_STEPS, batch=8, droppath_rate=0.2,
         losses=losses, step_seconds=step_seconds, train_clips_per_sec=8e3 / step_ms, peak_step_memory_gb=peak,
         next_losses=nxt, pool_conv_share_of_step=(convs["total_fwd_ms"] + convs["total_dgrad_ms"]
                                                   + convs["total_wgrad_ms"]) / step_ms,
         step_device_time=step_profile, nvidia_smi=smi)

    t0 = time.perf_counter()
    entry = mvit_cfg(*MVIT_RUN_OPTS, "SOLVER.MAX_EPOCH", "1", "TRAIN.EVAL_PERIOD", "1", "TRAIN.CHECKPOINT_PERIOD",
                     "1", "OUTPUT_DIR", str(MVIT_OUT / "train"))
    entry_losses = []
    update = train_net.TrainMeter.update_stats

    def recording_update(meter, top1, top5, loss, lr, mb):
        entry_losses.append(float(loss))
        return update(meter, top1, top5, loss, lr, mb)

    with patched(train_net.TrainMeter, update_stats=recording_update):
        trained = train(entry)
    saved = torch.load(checkpoints.get_last_checkpoint(str(MVIT_OUT / "train")), map_location="cuda",
                       weights_only=True)["model_state"]
    check(len(entry_losses) == 2 and all(np.isfinite(entry_losses))
          and all(torch.equal(saved[k], v) for k, v in trained.state_dict().items()),
          f"mvit train_net.train: losses {entry_losses}, or its checkpoint is not the module")
    del trained, saved
    torch.cuda.empty_cache()
    emit("mvit_train_net", seconds=time.perf_counter() - t0, epochs=1, clips=16, losses=entry_losses, nvidia_smi=smi)

    t0 = time.perf_counter()
    results, peaks = [], {}
    torch.backends.cudnn.deterministic = True
    try:
        for act in (False, True):
            trainer = build_trainer(mvit_cfg(*MVIT_RUN_OPTS, "MODEL.ACT_CHECKPOINT", str(act)))
            grads = {}
            hooks = [p.register_hook(lambda g, k=k: grads.__setitem__(k, g.detach().clone()))
                     for k, p in trainer.module.named_parameters()]
            (loss, _, _), peaks[f"act_checkpoint_{act}"] = step_memory(
                lambda: trainer.train_step(frames, labels, torch.Generator(device="cuda").manual_seed(21)))
            for h in hooks:
                h.remove()
            results.append((loss, grads))
            del trainer
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    (loss_a, grads_a), (loss_b, grads_b) = results
    differ = sorted(k for k in grads_a if not torch.equal(grads_a[k], grads_b[k]))
    check(torch.equal(loss_a, loss_b) and not differ and len(grads_a) == len(grads_b),
          f"ACT_CHECKPOINT: loss {float(loss_b)} against {float(loss_a)}, gradients differ: {differ[:6]}")
    check(peaks["act_checkpoint_True"] < peaks["act_checkpoint_False"], f"ACT_CHECKPOINT peak memory {peaks}")
    n_grads = len(grads_a)
    del results, grads_a, grads_b
    emit("mvit_act_checkpoint", seconds=time.perf_counter() - t0, batch=8, loss=float(loss_a), bit_equal=True,
         gradients=n_grads, peak_step_memory_gb=peaks, nvidia_smi=smi)

    t0 = time.perf_counter()
    cfg = mvit_cfg(*MVIT_RUN_OPTS, "TEST.NUM_ENSEMBLE_VIEWS", "2", "TEST.NUM_SPATIAL_CROPS", "1",
                   "OUTPUT_DIR", str(MVIT_OUT / "test"))
    with recording_test_net() as seen:
        views, stats = test_net.test(cfg)[0]
    meter = seen[0]
    check(views == 2 and bool((meter.clip_count == 2).all()) and np.isfinite(meter.video_preds).all()
          and np.isfinite(float(stats["top1_acc"])), f"mvit test_net: {views} views, {stats}")
    ptv = build_model(mvit_cfg("MODEL.MODEL_NAME", "PTVMViT"), cuda)
    check(isinstance(ptv.module, mvit_model.MViTModel) and ptv.name == "PTVMViT", "PTVMViT is not MViT")
    del ptv
    torch.cuda.empty_cache()
    emit("mvit_test_net", seconds=time.perf_counter() - t0, views=views, clips=int(meter.clip_count.sum()),
         top1_acc=float(stats["top1_acc"]), ptv_mvit_built=True, nvidia_smi=smi)
    emit("mvit", seconds=time.perf_counter() - start, launches=check_no_attention_launches("mvit"), nvidia_smi=smi)
    shutil.rmtree(MVIT_OUT, ignore_errors=True)


def phase_mvit_rev(smi: str) -> None:
    """Rev-MViT-B (``REV_MVIT_B_OPTS``) at full width: ``perform_benchmark``
    at B8 in bf16; the card against the CPU at B1 in fp32; a B8 train step
    (forward, cross entropy, backward; drop path 0.2 from one CUDA
    generator) through the reversible backward against the same step under
    plain autograd (``use_rev_backward`` off, the same masks), in fp32 and
    in bf16: the loss bit for bit, each parameter group's largest gradient
    error, and each step's peak memory (the reversible one lower). No K1-K5b
    may launch."""
    cuda = torch.device("cuda")
    zero_launch_counts()
    start = time.perf_counter()
    t0 = time.perf_counter()
    cfg = rev_mvit_cfg(*MVIT_RUN_OPTS)
    serve = mvit_serve(cfg)
    del serve["module"]
    torch.cuda.empty_cache()
    emit("mvit_rev_serve", seconds=time.perf_counter() - t0, batch=8, dtype="bfloat16", **serve, nvidia_smi=smi)
    t0 = time.perf_counter()
    errors = mvit_card_against_cpu(cfg, 62)
    emit("mvit_rev_card_vs_cpu", seconds=time.perf_counter() - t0, **errors, nvidia_smi=smi)

    frames, labels = fixed_batch(cfg)
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        module = build_model(rev_mvit_cfg(*MVIT_RUN_OPTS, "TPU.COMPUTE_DTYPE", dtype), cuda,
                             fp32_params=True).module
        runs, peaks = {}, {}
        for rev in (True, False):
            module.rev_backbone.use_rev_backward = rev
            runs[rev], peaks[f"rev_backward_{rev}"] = step_memory(lambda: mvit_train_step(module, frames, labels, 31))
        module.rev_backbone.use_rev_backward = True
        (loss_rev, grads_rev), (loss_plain, grads_plain) = runs[True], runs[False]
        errors = rev_grad_errors(grads_rev, grads_plain)
        check(torch.equal(loss_rev, loss_plain) and np.isfinite(float(loss_rev)),
              f"rev {dtype}: loss {float(loss_rev)} against plain autograd's {float(loss_plain)}")
        check(peaks["rev_backward_True"] < peaks["rev_backward_False"], f"rev {dtype}: peak memory {peaks}")
        del module, runs, grads_rev, grads_plain
        torch.cuda.empty_cache()
        emit(f"mvit_rev_backward_{dtype}", seconds=time.perf_counter() - t0, batch=8, droppath_rate=0.2,
             loss=float(loss_rev), max_rel_grad_err=max(errors.values()), rel_grad_err_by_group=errors,
             peak_step_memory_gb=peaks, nvidia_smi=smi)
    emit("mvit_rev", seconds=time.perf_counter() - start, launches=check_no_attention_launches("mvit_rev"),
         nvidia_smi=smi)


def masked_batch(cfg, seed: int):
    """The first training batch of the synthetic dataset and its loader
    masks (the global ``random`` seeded with ``seed``; None without
    ``AUG.GEN_MASK_LOADER``), on the card."""
    random.seed(seed)
    batch = next(iter(construct_loader(cfg, "train")))
    mask = batch.get("mask")
    return torch.from_numpy(batch["frames"]).cuda(), None if mask is None else torch.from_numpy(mask).cuda()


def masked_card_against_cpu(cfg, seed: int) -> dict:
    """One fp32 forward of ``cfg``'s MaskMViT at B1 on the CPU and on the
    card (TF32 off), the same weights and the same loader mask (MaskFeat)
    or injected noise (MAE): each float output's largest error relative to
    the CPU's largest entry, within MASKED_CPU_TOL; the boolean masks equal."""
    cfg = cfg.clone()
    cfg.merge_from_list(["TPU.COMPUTE_DTYPE", "float32"])
    module = build_model(cfg, "cpu", fp32_params=True).module
    t, s = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, t, s, s, 3)).astype(np.float32))
    if cfg.MASK.MAE_ON:
        mask, noise = None, torch.from_numpy(rng.random((1, math.prod(module.spec.patch_dims)), dtype=np.float32))
        names = ("preds", "labels", "masks")
    else:
        random.seed(seed)
        mask, noise = torch.from_numpy(masking.gen_mask(cfg)[None].astype(np.float32)), None
        names = ("preds", "masks")

    def run(device):
        kw = {} if noise is None else {"noise": noise.to(device)}
        with torch.inference_mode():
            return module(x.to(device), None if mask is None else mask.to(device), **kw)

    tick = time.perf_counter()
    cpu = run("cpu")
    cpu_seconds = time.perf_counter() - tick
    module.to("cuda")
    with tf32(False):
        card = run("cuda")
    out = dict(batch=1, tol=MASKED_CPU_TOL, cpu_seconds=cpu_seconds)
    for name, wants, gots in zip(names, cpu, card):
        for i, (want, got) in enumerate(zip(wants, gots)):
            got = got.cpu()
            if want.dtype == torch.bool:
                check(torch.equal(got, want), f"{cfg.MODEL.MODEL_NAME}: the card's {name}[{i}] differ from the CPU's")
                out[f"{name}_{i}_masked_positions"] = int(want.sum())
                continue
            scale = float(want.double().abs().max())
            err = float((got.double() - want.double()).abs().max()) / scale
            check(bool(torch.isfinite(want).all()) and err <= MASKED_CPU_TOL,
                  f"{cfg.MODEL.MODEL_NAME}: card against CPU {err} of the largest {name}[{i}] entry {scale}")
            out[f"{name}_{i}"] = dict(shape=list(want.shape), largest=scale, rel_err=err)
    return out


def hog_card_against_cpu(cfg, spec, frames) -> dict:
    """MaskFeat's HOG targets of a batch made on the card against the same
    made on the CPU: how many orientation bins differ (``hog_bins`` of the
    frames the targets read; must be none), the largest target error (at
    most 1e-5: the cell sums add in another order), and the card's ms to
    make them."""
    depths = cfg.MASK.PRETRAIN_DEPTH
    sub = frames[:, ::spec.patch_stride[0]]
    sub = sub.reshape((-1,) + tuple(sub.shape[2:]))
    bins_card = masked_model.hog_bins(sub)[1].cpu()
    bins_cpu = masked_model.hog_bins(sub.cpu())[1]
    differ = int((bins_card != bins_cpu).sum())
    card = masked_model.maskfeat_hog_labels(spec, depths, frames)
    cpu = masked_model.maskfeat_hog_labels(spec, depths, frames.cpu())
    err = max(float((c.cpu() - w).abs().max()) for c, w in zip(card, cpu))
    check(differ == 0 and err <= 1e-5, f"HOG targets: {differ} bins differ, largest error {err}")
    label_ms = cuda_ms(lambda: masked_model.maskfeat_labels(cfg, spec, frames), iters=10)
    return dict(frames=int(sub.shape[0]), bins=int(bins_cpu.numel()), differing_bins=differ, max_abs_err=err,
                label_shapes=[list(c.shape) for c in card], label_ms=label_ms)


def masked_train(phase: str, make_cfg, smi: str, label_ms_of) -> dict:
    """``MASKED_TRAIN_STEPS`` bf16 AdamW steps of ``train_net``'s masked step
    at B8 on one synthetic batch with its loader masks (the MAE draws its
    noise from a CUDA generator a step): the losses finite, ms a step after
    the first, train clips/s, the peak; one more step's device time by kind
    (torch.profiler); the ms a step spends making its
    targets (``label_ms_of(cfg, trainer, frames)``); a checkpoint that
    reloads to the same next loss (cuDNN deterministic); then
    ``train_net.train`` for one epoch of 16 synthetic clips (2 iterations,
    no eval epoch), its losses finite and its checkpoint the module. Returns
    the step's figures and the trainer's module, cfg and batch."""
    t0 = time.perf_counter()
    out = MASKED_OUT / phase
    cfg = make_cfg(*MVIT_RUN_OPTS, "OUTPUT_DIR", str(out / "steps"))
    trainer = build_trainer(cfg)
    frames, mask = masked_batch(cfg, 5)
    set_lr(trainer.optimizer, trainer.lr_at(0.0))
    losses, step_seconds, peak = [], [], 0.0
    for i in range(MASKED_TRAIN_STEPS):
        gen = torch.Generator(device="cuda").manual_seed(i)
        tick = time.perf_counter()
        (loss, _), peak = step_memory(lambda: trainer.train_step(frames, mask, gen))
        losses.append(float(loss))
        step_seconds.append(time.perf_counter() - tick)
    check(all(np.isfinite(losses)), f"{phase} train: losses {losses}")
    step_ms = 1e3 * sum(step_seconds[1:]) / (MASKED_TRAIN_STEPS - 1)
    step_profile = device_time_by_kind(lambda: trainer.train_step(frames, mask, gen), MVIT_KERNEL_KINDS)
    label_ms = label_ms_of(cfg, trainer, frames)
    torch.backends.cudnn.deterministic = True  # the same bits twice
    try:
        path = checkpoints.save_checkpoint(str(out / "steps"), trainer.module, trainer.optimizer, 0, cfg)
        twin = build_trainer(cfg)
        checkpoints.load_checkpoint(path, twin.module, twin.optimizer)
        nxt = [float(t.train_step(frames, mask, torch.Generator(device="cuda").manual_seed(9))[0])
               for t in (trainer, twin)]
    finally:
        torch.backends.cudnn.deterministic = False
    check(nxt[0] == nxt[1] and np.isfinite(nxt[0]), f"{phase}: next loss after reload {nxt[1]} != {nxt[0]}")
    del twin
    torch.cuda.empty_cache()
    figures = dict(steps=MASKED_TRAIN_STEPS, batch=8, dtype=cfg.TPU.COMPUTE_DTYPE, losses=losses,
                   step_seconds=step_seconds, step_ms=step_ms, train_clips_per_sec=8e3 / step_ms,
                   label_ms=label_ms, label_share_of_step=label_ms / step_ms, peak_step_memory_gb=peak,
                   next_losses=nxt, step_device_time=step_profile)
    emit(f"{phase}_train", seconds=time.perf_counter() - t0, **figures, nvidia_smi=smi)

    t0 = time.perf_counter()
    entry = make_cfg(*MVIT_RUN_OPTS, "SOLVER.MAX_EPOCH", "1", "TRAIN.EVAL_PERIOD", "1", "TRAIN.CHECKPOINT_PERIOD",
                     "1", "OUTPUT_DIR", str(out / "train"))
    entry_losses = []
    update = train_net.TrainMeter.update_stats

    def recording_update(meter, top1, top5, loss, lr, mb):
        entry_losses.append(float(loss))
        return update(meter, top1, top5, loss, lr, mb)

    with patched(train_net.TrainMeter, update_stats=recording_update):
        trained = train(entry)
    saved = torch.load(checkpoints.get_last_checkpoint(str(out / "train")), map_location="cuda",
                       weights_only=True)["model_state"]
    check(len(entry_losses) == 2 and all(np.isfinite(entry_losses))
          and all(torch.equal(saved[k], v) for k, v in trained.state_dict().items()),
          f"{phase} train_net.train: losses {entry_losses}, or its checkpoint is not the module")
    del trained, saved
    torch.cuda.empty_cache()
    emit(f"{phase}_train_net", seconds=time.perf_counter() - t0, epochs=1, clips=16, losses=entry_losses,
         nvidia_smi=smi)
    return dict(figures, trainer=trainer, cfg=cfg, frames=frames, mask=mask)


def phase_maskfeat(smi: str) -> None:
    """MaskFeat on MViTv2-S (``MASKFEAT_OPTS``) at full width: the card
    against the CPU at B1 in fp32 (predictions, masks); the HOG targets of a
    B8 batch made on the card against the CPU's, bin for bin;
    ``masked_train`` (bf16 AdamW at B8, the HOG targets made on the card
    each step, a checkpoint reload, ``train_net.train``); the 48 depthwise
    pooling convs' share of a step (``pool_conv_times``). No K1-K5b may
    launch."""
    shutil.rmtree(MASKED_OUT / "maskfeat", ignore_errors=True)
    zero_launch_counts()
    start = time.perf_counter()
    t0 = time.perf_counter()
    errors = masked_card_against_cpu(maskfeat_cfg(*MVIT_RUN_OPTS), 71)
    emit("maskfeat_card_vs_cpu", seconds=time.perf_counter() - t0, **errors, nvidia_smi=smi)

    def label_ms(cfg, trainer, frames):
        return cuda_ms(lambda: masked_model.maskfeat_labels(cfg, trainer.module.spec, frames), iters=10)

    run = masked_train("maskfeat", maskfeat_cfg, smi, label_ms)
    trainer, cfg, frames, step_ms = run["trainer"], run["cfg"], run["frames"], run["step_ms"]
    t0 = time.perf_counter()
    hog = hog_card_against_cpu(cfg, trainer.module.spec, frames)
    emit("maskfeat_hog", seconds=time.perf_counter() - t0, **hog, nvidia_smi=smi)

    t0 = time.perf_counter()
    counts = pool_conv_shapes(trainer.module, cfg, torch.zeros((8,) + tuple(cfg.AUG.MASK_WINDOW_SIZE), device="cuda"))
    check(sum(counts.values()) == 48, f"MaskFeat ran {sum(counts.values())} pooling convs a forward, not 48")
    del trainer, run, frames
    torch.cuda.empty_cache()
    convs = pool_conv_times(counts)
    emit("maskfeat_pool_convs", seconds=time.perf_counter() - t0, pool_convs=convs, step_ms=step_ms,
         pool_conv_share_of_step=(convs["total_fwd_ms"] + convs["total_dgrad_ms"] + convs["total_wgrad_ms"])
         / step_ms, nvidia_smi=smi)
    emit("maskfeat", seconds=time.perf_counter() - start, launches=check_no_attention_launches("maskfeat"),
         nvidia_smi=smi)
    shutil.rmtree(MASKED_OUT / "maskfeat", ignore_errors=True)


def phase_mae(smi: str) -> None:
    """MAE on ViT-B (``MAE_VIT_B_OPTS``) at full width: the card against the
    CPU at B1 in fp32 under the same injected noise (predictions, pixel
    targets, masks); ``masked_train`` (bf16 AdamW at B8, 156 of 1568 tokens
    kept, the noise from each step's CUDA generator, the targets made in the
    forward); ``mae_visualize`` of one batch, whose reconstruction keeps
    every visible patch of the input bit for bit. No K1-K5b may launch."""
    shutil.rmtree(MASKED_OUT / "mae", ignore_errors=True)
    zero_launch_counts()
    start = time.perf_counter()
    t0 = time.perf_counter()
    errors = masked_card_against_cpu(mae_cfg(*MVIT_RUN_OPTS), 73)
    check(errors["masks_0_masked_positions"] == 1568 - 156, f"MAE kept {1568 - errors['masks_0_masked_positions']}")
    emit("mae_card_vs_cpu", seconds=time.perf_counter() - t0, **errors, nvidia_smi=smi)

    def label_ms(cfg, trainer, frames):
        p, u = cfg.MVIT.PATCH_STRIDE[1], cfg.MVIT.PATCH_STRIDE[0]
        return cuda_ms(lambda: masked_model.mae_pixel_labels(frames, u, p, cfg.MASK.TIME_STRIDE_LOSS,
                                                             cfg.MASK.NORM_PRED_PIXEL), iters=10)

    run = masked_train("mae", mae_cfg, smi, label_ms)
    trainer, cfg, frames = run["trainer"], run["cfg"], run["frames"]
    t0 = time.perf_counter()
    module = trainer.module.eval()
    with torch.inference_mode():
        preds, _, masks = module(frames, None, generator=torch.Generator(device="cuda").manual_seed(31))
    u, p = cfg.MVIT.PATCH_STRIDE[0], cfg.MVIT.PATCH_STRIDE[1]
    dropped = masks[0].cpu().numpy()
    orig, masked_clip, recon = mae_visualize(frames.cpu().numpy(), preds[0].float().cpu().numpy(), dropped, u, p)
    tokens = masked_model._patchify_pixels(orig, p, 1)
    check(orig.shape == recon.shape == masked_clip.shape == (8, 8, 224, 224, 3)
          and np.array_equal(masked_model._patchify_pixels(recon, p, 1)[~dropped], tokens[~dropped])
          and not masked_model._patchify_pixels(masked_clip, p, 1)[dropped].any()
          and np.isfinite(recon).all(), "mae_visualize: the reconstruction does not keep the visible patches")
    del trainer, run, module, frames, preds
    torch.cuda.empty_cache()
    emit("mae_visualize", seconds=time.perf_counter() - t0, clips=8, frames=8, visible_patches=int((~dropped).sum()),
         dropped_patches=int(dropped.sum()), visible_bit_equal=True, nvidia_smi=smi)
    emit("mae", seconds=time.perf_counter() - start, launches=check_no_attention_launches("mae"), nvidia_smi=smi)
    shutil.rmtree(MASKED_OUT / "mae", ignore_errors=True)


def ssl_views(cfg, batch: int, seed: int, device, crop=None):
    """Two views of ``batch`` random videos as one-pathway clips, and their
    rows of the banks (distinct, from the whole of ``CONTRASTIVE.LENGTH``).
    Each video has a colour offset of its own, as real videos differ: the
    pooled features of white noise are near equal across a batch, and the
    MLP's BatchNorm over them would cancel their digits away."""
    gen = torch.Generator(device=device).manual_seed(seed)
    t, s = cfg.DATA.NUM_FRAMES, crop or cfg.DATA.TRAIN_CROP_SIZE
    offset = 2 * torch.randn(batch, 1, 1, 1, 3, generator=gen, device=device)
    clips = [[torch.randn(batch, t, s, s, 3, generator=gen, device=device) + offset] for _ in range(2)]
    index = torch.randperm(cfg.CONTRASTIVE.LENGTH, generator=gen, device=device)[:batch]
    return clips, index


def ssl_trainer(cfg, device="cuda"):
    """(model, optimizer, lr_at, step) as ``train_net.train_contrastive`` builds them."""
    model, _ = contrastive.build_contrastive_model(cfg, device)
    optimizer, lr_at = construct_optimizer(cfg, model)
    return model, optimizer, lr_at, make_contrastive_train_step(model, optimizer)


def contrastive_card_against_cpu(smi: str) -> dict:
    """One MoCo train step of the full-width model at B2, fp32 (TF32 off), on
    the CPU and on the card from the same weights and state (BatchNorms
    moved, the momentum encoder a perturbed copy one update in), and the
    step's forward in fp64 on the CPU (the truth: every figure below comes
    from the forward): the loss, the positive and the negative logits, the
    queue rows written, the momentum encoder's parameters and statistics.
    As in ``conv_card_against_cpu``, with errors of each one's largest fp64
    entry: the card's error at most SF_FP64_FACTOR times the CPU's fp32 one
    plus SF_FP64_FLOOR, and where the CPU's own is within CONTRASTIVE_CPU_TOL /
    SF_FP64_FACTOR, the card within CONTRASTIVE_CPU_TOL of the CPU's fp32
    (the key projections pass BatchNorms over 2 videos, whose differences
    carry fewer digits than the features). ``ptr`` the same."""
    cfg = moco_cfg()
    model, _ = contrastive.build_contrastive_model(cfg, "cpu")
    moved_bn(model.backbone, 81, 0.2)
    model.backbone_hist.load_state_dict(model.backbone.state_dict())
    gen = torch.Generator().manual_seed(82)
    last = model.cc.queue_len - 2  # the queue's last two rows: the write ends at its end
    with torch.no_grad():
        for h in model.backbone_hist.parameters():
            h.mul_(1 + 0.01 * torch.randn(h.shape, generator=gen))
        model.iter.fill_(1)
        model.ptr.fill_(last)
    clips, index = ssl_views(cfg, 2, 83, "cpu")
    card, truth = copy.deepcopy(model).cuda(), copy.deepcopy(model).double().train()

    def figures(m, loss, logits):
        return dict(loss=loss.reshape(1).cpu(), positive=logits[:, 0].cpu(), negative=logits[:, 1:].cpu(),
                    queue_rows=m.queue_x[last:].cpu(), ptr=int(m.ptr),
                    hist_parameters=[p.detach().cpu() for p in m.backbone_hist.parameters()],
                    hist_statistics=[b.cpu() for n, b in m.backbone_hist.named_buffers() if "running" in n])

    got = {}
    for where, m, device in (("cpu", model, "cpu"), ("card", card, "cuda")):
        optimizer, lr_at = construct_optimizer(cfg, m)
        set_lr(optimizer, lr_at(0.5))
        tick = time.perf_counter()
        loss, logits = make_contrastive_train_step(m, optimizer)([[c[0].to(device)] for c in clips],
                                                                 index.to(device), 0.5)
        got[where] = dict(figures(m, loss, logits), seconds=time.perf_counter() - tick)
    tick = time.perf_counter()
    with torch.no_grad():
        logits, loss = truth([[c[0].double()] for c in clips], index, epoch_exact=0.5)
    got["fp64"] = dict(figures(truth, loss, logits), seconds=time.perf_counter() - tick)
    cpu, dev, fp64 = got["cpu"], got["card"], got["fp64"]
    check(cpu["ptr"] == dev["ptr"] == fp64["ptr"] == 0, f"ptr after the step: {cpu['ptr']}, {dev['ptr']}")
    out = dict(batch=2, tol=CONTRASTIVE_CPU_TOL, cpu_step_seconds=cpu["seconds"],
               cpu_fp64_forward_seconds=fp64["seconds"], ptr=dev["ptr"])
    failed = []
    for name in ("loss", "positive", "negative", "queue_rows", "hist_parameters", "hist_statistics"):
        pairs = list(zip(*(x[name] if isinstance(x[name], list) else [x[name]] for x in (dev, cpu, fp64))))
        card_err = max(rel_error(d, t) for d, _, t in pairs)
        cpu_err = max(rel_error(c, t) for _, c, t in pairs)
        card_cpu = max(rel_error(d, c) for d, c, _ in pairs)
        held = cpu_err <= CONTRASTIVE_CPU_TOL / SF_FP64_FACTOR
        out[name] = dict(card_to_fp64=card_err, cpu_to_fp64=cpu_err, card_vs_cpu=card_cpu, card_vs_cpu_checked=held)
        if not (card_err <= SF_FP64_FACTOR * cpu_err + SF_FP64_FLOOR and (not held or card_cpu <= CONTRASTIVE_CPU_TOL)):
            failed.append(name)
    check(not failed, f"contrastive card against CPU: {failed} of {out}")
    del card, model, truth
    torch.cuda.empty_cache()
    return out


def rel_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest error relative to the largest entry of ``want`` (NaN fails every bound)."""
    got, want = got.double(), want.double()
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / max(scale, 1e-30)
    return err if torch.isfinite(got).all() and torch.isfinite(want).all() else float("nan")


def ssl_timed_steps(tag: str, cfg, smi: str) -> tuple:
    """CONTRASTIVE_STEPS train steps of ``cfg``'s model at B8 on 224, each on
    fresh views, epoch_exact 0, 0.01, 0.02: the losses finite; ms a step by
    CUDA events; videos/s (a video is its two views); the peak; ``ptr`` 8
    further each MoCo step; the momentum encoder the online parameters
    before the step (a copy at iter 0, then ``mmt h + (1 - mmt) p``), bit for
    bit. Returns (figures, model, optimizer, lr_at, step)."""
    model, optimizer, lr_at, step = ssl_trainer(cfg)
    cc = model.cc
    losses, step_ms = [], []
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for i in range(CONTRASTIVE_STEPS):
        epoch = 0.01 * i
        clips, index = ssl_views(cfg, CONTRASTIVE_BATCH, 90 + i, "cuda")
        set_lr(optimizer, lr_at(epoch))
        online = [p.detach().clone() for p in model.backbone.parameters()]
        hist = [h.clone() for h in model.backbone_hist.parameters()]
        first, ptr = int(model.iter) == 0, int(getattr(model, "ptr", 0))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss, _ = step(clips, index, epoch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(loss))
        mmt = contrastive.momentum_anneal_cosine(cc, epoch)
        check(all(torch.equal(h, p if first else p * (1.0 - mmt) + g * mmt)
                  for h, p, g in zip(model.backbone_hist.parameters(), online, hist)),
              f"{tag} step {i}: the momentum encoder is not mmt h + (1 - mmt) p of the step's parameters")
        if cc.type == "moco":
            check(int(model.ptr) == (ptr + CONTRASTIVE_BATCH) % cc.queue_len, f"{tag}: ptr {int(model.ptr)}")
        del online, hist
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    check(all(np.isfinite(losses)), f"{tag}: losses {losses}")
    ms = sum(step_ms[1:]) / (CONTRASTIVE_STEPS - 1)
    figures = dict(steps=CONTRASTIVE_STEPS, batch=CONTRASTIVE_BATCH, views=2, losses=losses, step_ms=step_ms,
                   ms_per_step=ms, videos_per_sec=CONTRASTIVE_BATCH * 1e3 / ms, peak_step_memory_gb=peak,
                   iter=int(model.iter))
    return figures, model, optimizer, lr_at, step


def lars_step_check(model, optimizer, cfg) -> dict:
    """One more BYOL step taken by hand: after the backward (and the clip,
    none here), each LARS group's matrix gradient against
    (g + wd p) 0.001 |p| / (|g| + |p| wd + 1e-8) recomputed from that step's
    gradients in fp64, the 1-D ones unchanged; then the optimizer's step."""
    clips, index = ssl_views(cfg, CONTRASTIVE_BATCH, 99, "cuda")
    model.train()
    loss = model(clips, index, epoch_exact=0.03)[1]
    loss.backward()
    train_optimizer.clip_gradients(optimizer)
    grads = {id(p): p.grad.clone() for g in optimizer.param_groups for p in g["params"] if p.grad is not None}
    train_optimizer.lars_gradients(optimizer)
    worst, adapted, passed = 0.0, 0, 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            g0 = grads[id(p)]
            if not group.get("lars") or p.dim() <= 1:
                check(torch.equal(p.grad, g0), "LARS changed a gradient it must pass through")
                passed += 1
                continue
            wd, p64, g64 = group["lars_weight_decay"], p.detach().double(), g0.double()
            pn, gn = p64.norm(), g64.norm()
            want = (g64 + wd * p64) * (0.001 * pn / (gn + pn * wd + 1e-8))
            worst = max(worst, rel_error(p.grad, want))
            adapted += 1
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    check(adapted > 0 and worst <= 1e-5, f"LARS: {adapted} matrices, largest error {worst}")
    return dict(adapted=adapted, not_adapted=passed, max_rel_err=worst, tol=1e-5, loss=float(loss))


def ssl_small(smi: str) -> dict:
    """SimCLR, SwAV and mem, one step each (SwAV three) at B4 on
    CONTRASTIVE_SMALL_CROP: SimCLR's loss finite; SwAV (no weight decay) at
    epoch 0.5 leaves its prototypes their normalised selves bit for bit, at
    epoch 16 with a queue of 4 rows it fills the queue (the flag still off)
    and at the next step sets the flag; mem with the 239975-row bank changes
    the rows at the batch's index and no other."""
    crop = ("DATA.TRAIN_CROP_SIZE", str(CONTRASTIVE_SMALL_CROP))
    out = {}
    cfg = moco_cfg(*crop, "CONTRASTIVE.TYPE", "simclr")
    model, optimizer, lr_at, step = ssl_trainer(cfg)
    clips, index = ssl_views(cfg, 4, 100, "cuda")
    out["simclr_loss"] = float(step(clips, index, 0.5)[0])
    check(np.isfinite(out["simclr_loss"]), f"SimCLR loss {out['simclr_loss']}")

    cfg = moco_cfg(*crop, "CONTRASTIVE.TYPE", "swav", "CONTRASTIVE.SWAV_QEUE_LEN", "4", "SOLVER.WEIGHT_DECAY", "0.0")
    model, optimizer, lr_at, step = ssl_trainer(cfg)
    protos = contrastive.l2_normalize(model.swav_prototypes.weight.detach(), dim=1)
    losses = [float(step(*ssl_views(cfg, 4, 101, "cuda"), 0.5)[0])]
    check(torch.equal(model.swav_prototypes.weight, protos), "SwAV's prototypes moved in the gated epoch")
    check(not model.queue_swav.any(), "SwAV's queue filled before epoch 15")
    losses.append(float(step(*ssl_views(cfg, 4, 102, "cuda"), 16.0)[0]))
    filled = bool((model.queue_swav != 0).any(dim=-1).all())
    flag_after_fill = bool(model.swav_use_the_queue)
    losses.append(float(step(*ssl_views(cfg, 4, 103, "cuda"), 16.1)[0]))
    check(filled and not flag_after_fill and bool(model.swav_use_the_queue) and all(np.isfinite(losses)),
          f"SwAV queue: filled {filled}, flag {flag_after_fill} then {bool(model.swav_use_the_queue)}, {losses}")
    out.update(swav_losses=losses, swav_queue_filled=filled, swav_flag=bool(model.swav_use_the_queue))

    cfg = moco_cfg(*crop, "CONTRASTIVE.TYPE", "mem")
    model, optimizer, lr_at, step = ssl_trainer(cfg)
    clips, index = ssl_views(cfg, 4, 104, "cuda")
    bank = model.memory.clone()
    out["mem_loss"] = float(step(clips, index, 0.5)[0])
    changed = (model.memory != bank).any(dim=1).nonzero().flatten()
    check(torch.equal(changed, index.sort().values) and np.isfinite(out["mem_loss"]),
          f"mem: rows {changed.tolist()} changed, the batch's are {index.sort().values.tolist()}")
    out.update(mem_bank_rows=int(bank.shape[0]), mem_rows_changed=changed.tolist())
    del model, optimizer, bank
    torch.cuda.empty_cache()
    return out


def ssl_mvit(smi: str) -> dict:
    """MViTv2-S (``MVITV2_S_OPTS``, bf16 compute, fp32 parameters) with the
    3-layer MLP head under SimCLR: one step at B2, the loss finite."""
    cfg = mvit_cfg("MODEL.MODEL_NAME", "ContrastiveModel", "CONTRASTIVE.TYPE", "simclr", "MODEL.NUM_CLASSES", "128",
                   "CONTRASTIVE.DIM", "128", "CONTRASTIVE.NUM_MLP_LAYERS", "3", "CONTRASTIVE.MLP_DIM", "2048",
                   "CONTRASTIVE.BN_MLP", "True", "CONTRASTIVE.LENGTH", "239975")
    model, optimizer, lr_at, step = ssl_trainer(cfg)
    check(isinstance(model.backbone.head.projection, convnet.MLPHead), "MViT's head is not the MLP")
    clips, index = ssl_views(cfg, 2, 105, "cuda")
    torch.cuda.synchronize()
    tick = time.perf_counter()
    loss = float(step(clips, index, 0.5)[0])
    seconds = time.perf_counter() - tick
    check(np.isfinite(loss), f"MViTv2-S SimCLR loss {loss}")
    del model, optimizer
    torch.cuda.empty_cache()
    return dict(batch=2, loss=loss, step_seconds=seconds, dtype=cfg.TPU.COMPUTE_DTYPE)


def ssl_train_net(smi: str) -> dict:
    """``train_net.train`` of MoCo at full width on 16 synthetic videos (two
    views each) at B4 with a queue of 8 and a bank of 16 rows, 2 epochs: the
    first 2 iterations of epoch 0 fill the queue without an update, a kNN
    top-1 an epoch (finite, in [0, 1]), a checkpoint an epoch. Then a run
    whose output directory holds only that run's checkpoint of epoch 0
    auto-resumes from it: the queue, ptr, iter, the momentum encoder and the
    bank restored bit for bit, and every loss of its epoch 1 and its final
    model state (parameters, statistics, queue, bank) those of the
    uninterrupted run bit for bit (cuDNN deterministic; the stems' max pool
    has a deterministic backward, ``convnet.max_pool3d``)."""
    def run(name):
        return moco_cfg("TRAIN.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "4", "CONTRASTIVE.QUEUE_LEN", "8",
                        "CONTRASTIVE.LENGTH", "16", "SOLVER.MAX_EPOCH", "2", "TRAIN.EVAL_PERIOD", "1",
                        "TRAIN.CHECKPOINT_PERIOD", "1", "OUTPUT_DIR", str(CONTRASTIVE_OUT / name))

    seen = {"update": [], "loss": [], "knn": []}
    make, knn = train_net.make_contrastive_train_step, train_net.knn_eval

    def make_recording(model, optimizer):
        step = make(model, optimizer)

        def recorded(*args, update_param=True, **kw):
            seen["update"].append(update_param)
            out = step(*args, update_param=update_param, **kw)
            seen["loss"].append(float(out[0]))
            return out
        return recorded

    def knn_recording(*args):
        seen["knn"].append(knn(*args))
        return seen["knn"][-1]

    torch.backends.cudnn.deterministic = True
    try:
        with patched(train_net, make_contrastive_train_step=make_recording, knn_eval=knn_recording):
            tick = time.perf_counter()
            whole = train(run("whole"))
            whole_seconds = time.perf_counter() - tick
            whole_seen = {k: list(v) for k, v in seen.items()}
            for v in seen.values():
                v.clear()
            first = pathlib.Path(checkpoints.checkpoint_dir(str(CONTRASTIVE_OUT / "whole"))) / "epoch_00000.pyth"
            (CONTRASTIVE_OUT / "resume" / "checkpoints").mkdir(parents=True)
            shutil.copy(first, CONTRASTIVE_OUT / "resume" / "checkpoints" / first.name)
            saved = torch.load(first, map_location="cuda", weights_only=True)["model_state"]
            restored, _ = contrastive.build_contrastive_model(run("resume"), "cuda")
            checkpoints.load_checkpoint(str(first), restored)
            resumed = train(run("resume"))
    finally:
        torch.backends.cudnn.deterministic = False
    state_names = [k for k in saved if k in ("queue_x", "ptr", "iter", "knn_mem") or k.startswith("backbone_hist.")]
    check(all(torch.equal(restored.state_dict()[k], saved[k]) for k in state_names),
          "the resumed model's state is not the checkpoint's")
    check(whole_seen["update"][:4] == [False, False, True, True] and all(whole_seen["update"][4:]),
          f"MoCo's warm-up: {whole_seen['update']}")
    check(len(whole_seen["knn"]) == 2 and all(0.0 <= k <= 1.0 for k in whole_seen["knn"]),
          f"kNN top-1 {whole_seen['knn']}")
    drift = max(abs(a - b) for a, b in zip(seen["loss"], whole_seen["loss"][4:]))
    check(seen["update"] == [True] * 4 and seen["loss"] == whole_seen["loss"][4:]
          and all(np.isfinite(whole_seen["loss"] + seen["loss"])),
          f"the resumed run's losses {seen['loss']} against {whole_seen['loss'][4:]} (drift {drift})")
    unequal = [k for k, v in resumed.state_dict().items() if not torch.equal(v, whole.state_dict()[k])]
    check(not unequal, f"the resumed run's final state differs from the uninterrupted run's: {unequal[:5]}")
    del whole, resumed, restored, saved
    torch.cuda.empty_cache()
    return dict(epochs=2, videos=16, batch=4, update=whole_seen["update"], losses=whole_seen["loss"],
                knn_top1=whole_seen["knn"], resumed_losses=seen["loss"], resumed_loss_drift=drift,
                restored_entries=len(state_names), seconds_two_epochs=whole_seconds)


def phase_contrastive(smi: str) -> None:
    """Contrastive pretraining at full width (``CONTRASTIVE_MOCO_OPTS``,
    ``CONTRASTIVE_BYOL_OPTS``: Slow R50 8x8 at 224, fp32): the card against
    the CPU (MoCo, B2); 3 MoCo and 3 BYOL-with-LARS steps at B8 (ms a step,
    videos/s, peak; ptr, the momentum encoder, one LARS update against its
    formula) and one MoCo step's device time by kind; SimCLR, SwAV and mem
    at B4; MViTv2-S with the MLP head under SimCLR; ``train_net.train`` of
    MoCo with the kNN eval and an auto-resume. No K1-K5b or T1-T12 may launch."""
    shutil.rmtree(CONTRASTIVE_OUT, ignore_errors=True)
    zero_launch_counts()
    start = time.perf_counter()
    t0 = time.perf_counter()
    figures = contrastive_card_against_cpu(smi)
    emit("contrastive_card_vs_cpu", seconds=time.perf_counter() - t0, **figures, nvidia_smi=smi)
    t0 = time.perf_counter()
    moco, model, optimizer, lr_at, step = ssl_timed_steps("moco", moco_cfg(), smi)
    clips, index = ssl_views(moco_cfg(), CONTRASTIVE_BATCH, 96, "cuda")
    moco["step_device_time"] = device_time_by_kind(lambda: step(clips, index, 0.03), MVIT_KERNEL_KINDS)
    moco.update(queue_rows=int(model.queue_x.shape[0]), knn_bank_rows=int(model.knn_mem.shape[0]))
    del model, optimizer, step, clips
    torch.cuda.empty_cache()
    emit("contrastive_moco", seconds=time.perf_counter() - t0, **moco, nvidia_smi=smi)
    t0 = time.perf_counter()
    byol, model, optimizer, lr_at, step = ssl_timed_steps("byol", byol_cfg(), smi)
    byol["lars"] = lars_step_check(model, optimizer, byol_cfg())
    del model, optimizer, step
    torch.cuda.empty_cache()
    emit("contrastive_byol", seconds=time.perf_counter() - t0, **byol, nvidia_smi=smi)
    t0 = time.perf_counter()
    figures = ssl_small(smi)
    emit("contrastive_small", seconds=time.perf_counter() - t0, **figures, nvidia_smi=smi)
    t0 = time.perf_counter()
    figures = ssl_mvit(smi)
    emit("contrastive_mvit", seconds=time.perf_counter() - t0, **figures, nvidia_smi=smi)
    t0 = time.perf_counter()
    figures = ssl_train_net(smi)
    emit("contrastive_train_net", seconds=time.perf_counter() - t0, **figures, nvidia_smi=smi)
    emit("contrastive", seconds=time.perf_counter() - start, launches=check_no_attention_launches("contrastive"),
         nvidia_smi=smi)
    shutil.rmtree(CONTRASTIVE_OUT, ignore_errors=True)


def write_ava(root: pathlib.Path) -> dict:
    """The AVA tree under ``root`` (the comment at AVA_OUT): frames/,
    frame_lists/{train,val}.csv, annotations/ (train and val ground truth,
    the predicted boxes, the labelmap, the exclusions), from numpy's seed 0.
    Returns the --opts that point the AVA keys at it."""
    import cv2

    rng = np.random.default_rng(0)
    for d in ("frames", "frame_lists", "annotations"):
        (root / d).mkdir(parents=True, exist_ok=True)
    lines = ["original_vido_id video_id frame_id path labels"]
    names = [f"ava{v:03d}" for v in range(AVA_VIDEOS)]
    for v, name in enumerate(names):
        (root / "frames" / name).mkdir(exist_ok=True)
        for f in range(AVA_FRAMES):
            rel = f"{name}/{name}_{f:06d}.jpg"
            cv2.imwrite(str(root / "frames" / rel), rng.integers(0, 255, AVA_HW + (3,), dtype=np.uint8))
            lines.append(f'{name} {v} {f} {rel} ""')
    for split in ("train", "val"):
        (root / "frame_lists" / f"{split}.csv").write_text("\n".join(lines) + "\n")
    gt, pred = [], []
    for name in names:
        for sec in AVA_SECS:
            for person in range(int(rng.integers(1, 4))):
                x1, y1 = rng.uniform(0.0, 0.5, 2)
                box = np.clip([x1, y1, x1 + rng.uniform(0.2, 0.5), y1 + rng.uniform(0.3, 0.5)], 0.0, 1.0)
                for label in sorted(rng.choice(AVA_EVALUATED, int(rng.integers(1, 4)), replace=False)):
                    gt.append(f"{name},{sec},{box[0]:.3f},{box[1]:.3f},{box[2]:.3f},{box[3]:.3f},{label},{person}")
                jit = np.clip(box + rng.normal(0, 0.02, 4), 0.0, 1.0)
                pred.append(f"{name},{sec},{jit[0]:.3f},{jit[1]:.3f},{jit[2]:.3f},{jit[3]:.3f},,"
                            f"{rng.uniform(0.85, 0.99):.6f}")
            pred.append(f"{name},{sec},0.100,0.100,0.600,0.700,,{rng.uniform(0.3, 0.7):.6f}")  # dropped
    ann = root / "annotations"
    (ann / "ava_train_v2.2.csv").write_text("\n".join(gt) + "\n")
    (ann / "ava_val_v2.2.csv").write_text("\n".join(gt) + "\n")
    (ann / "ava_val_predicted_boxes.csv").write_text("\n".join(pred) + "\n")
    (ann / "labels.pbtxt").write_text("".join(f'item {{\n  name: "action{i}"\n  id: {i}\n}}\n'
                                              for i in AVA_EVALUATED))
    (ann / "exclusions.csv").write_text(f"{AVA_EXCLUDED[0]},{AVA_EXCLUDED[1]:04d}\n")
    return ["AVA.FRAME_DIR", str(root / "frames"), "AVA.FRAME_LIST_DIR", str(root / "frame_lists"),
            "AVA.ANNOTATION_DIR", str(ann), "AVA.LABEL_MAP_FILE", "labels.pbtxt",
            "AVA.EXCLUSION_FILE", "exclusions.csv", "AVA.GROUNDTRUTH_FILE", "ava_val_v2.2.csv",
            "AVA.TRAIN_GT_BOX_LISTS", "['ava_train_v2.2.csv']",
            "AVA.TEST_PREDICT_BOX_LISTS", "['ava_val_predicted_boxes.csv']",
            "TRAIN.BATCH_SIZE", "8", "TEST.BATCH_SIZE", "8", "BN.NUM_BATCHES_PRECISE", "2",
            "TRAIN.AUTO_RESUME", "False"]


def ava_batch(cfg, split: str, batch: int) -> dict:
    """The first batch of ``split`` at B``batch`` as tensors on the card:
    frames, boxes, labels."""
    cfg = cfg.clone()
    cfg.merge_from_list(["TRAIN.BATCH_SIZE", str(batch), "TEST.BATCH_SIZE", str(batch)])
    b = next(iter(construct_loader(cfg, split)))
    return dict(frames=torch.from_numpy(b["frames"]).cuda(), boxes=torch.from_numpy(b["boxes"]).cuda(),
                labels=torch.from_numpy(np.asarray(b["label"], np.float32)).cuda())


def ava_card_against_cpu(cfg, b: dict) -> dict:
    """One eval forward of the detection SlowFast (every BatchNorm moved,
    ``moved_bn``, each block's final one about 0.2, so that no sigmoid
    saturates) on ``b``: in fp64 on the CPU (the truth), fp32 on the CPU
    and fp32 on the card with TF32 off; each box's sigmoid row and its
    pooled ROI features (the projection's input). The card's fp32 error at
    most SF_FP64_FACTOR times the CPU's own plus SF_FP64_FLOOR, each of the
    largest entry of the truth (the slowfast phase's rule)."""
    module = build_model(cfg, "cpu").module
    moved_bn(module, 61, SF_FINAL_BN_SCALES[1])
    frames, boxes = b["frames"].cpu(), b["boxes"].cpu()

    def outputs(x, bx):
        seen = []
        hook = module.head.projection.register_forward_hook(lambda m, a, out: seen.append(a[0]))
        try:
            with torch.inference_mode():
                scores = module(x, bboxes=bx)[0]
        finally:
            hook.remove()
        return {"scores": scores.double().cpu().numpy(), "pooled": seen[0].double().cpu().numpy()}

    tick = time.perf_counter()
    runs = {"cpu_fp32": outputs(frames, boxes)}
    module.double()
    truth = outputs(frames.double(), boxes.double())
    cpu_seconds = time.perf_counter() - tick
    module.float().to("cuda")
    with tf32(False):
        runs["card_fp32_tf32_off"] = outputs(frames.cuda(), boxes.cuda())
    out = dict(batch=int(frames.shape[0]), boxes=int(boxes.shape[0]), clip=list(frames.shape[1:4]),
               cpu_seconds=cpu_seconds)
    for key in truth:
        scale = float(np.abs(truth[key]).max())
        err = {run: float(np.abs(o[key] - truth[key]).max()) / scale for run, o in runs.items()}
        check(np.isfinite(truth[key]).all() and
              err["card_fp32_tf32_off"] <= SF_FP64_FACTOR * err["cpu_fp32"] + SF_FP64_FLOOR,
              f"ava card against CPU, {key}: card {err['card_fp32_tf32_off']}, CPU {err['cpu_fp32']} from fp64")
        out[key] = dict(largest=scale, rel_err_to_fp64=err)
    check(truth["scores"].shape == (int(boxes.shape[0]), 80), f"ava scores {truth['scores'].shape}")
    return out


def ava_serve(cfg, b: dict) -> dict:
    """B8 keyframes of the test split (224 x 297 clips) through the eval
    step, TF32 off and on: keyframes/s by CUDA events; and one forward's
    device time by torch.profiler, the backbone's (``module.body``) and the
    ROI head's (temporal mean, ``roi_align``, max, projection) apart."""
    module = build_model(cfg, "cuda").module
    step = test_net.make_detection_eval_step(module)
    frames, boxes = b["frames"], b["boxes"]
    out = dict(batch=int(frames.shape[0]), boxes=int(boxes.shape[0]), clip=list(frames.shape[1:4]))
    for label, on in (("tf32_off", False), ("tf32_on", True)):
        with tf32(on):
            ms = cuda_ms(lambda: step(frames, boxes), iters=10, warmup=3)
            with torch.inference_mode():
                xs = module.body(frames)
                backbone = device_time_by_kind(lambda: module.body(frames), CONV_KERNEL_KINDS)
                head = device_time_by_kind(lambda: module.head(xs, boxes), ROI_KERNEL_KINDS)
        out[label] = dict(ms=ms, keyframes_per_sec=1e3 * frames.shape[0] / ms, backbone_device=backbone,
                          roi_head_device=head)
        check(np.isfinite(ms) and head["kernel_ms"] > 0, f"ava serve {label}: {ms} ms, head {head}")
    del module
    torch.cuda.empty_cache()
    return out


def ava_train_steps(cfg, b: dict) -> dict:
    """AVA_TRAIN_STEPS steps of ``train_net``'s detection step at B8 (the
    train split's first batch, 224 x 224; dropout 0.5 from each step's
    generator): ms a step, keyframes/s, peak memory, finite losses, one
    step's device time by kind; then a checkpoint that reloads to the same
    next loss with cuDNN's deterministic algorithms; and ``roi_align``'s
    backward (two products, no atomics) the same bits twice."""
    frames, boxes, labels = b["frames"], b["boxes"], b["labels"]
    trainer = build_trainer(cfg)
    set_lr(trainer.optimizer, trainer.lr_at(0.0))
    losses, seconds = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(AVA_TRAIN_STEPS):
        gen = torch.Generator(device="cuda").manual_seed(i)
        tick = time.perf_counter()
        losses.append(float(trainer.train_step(frames, boxes, labels, generator=gen)[0]))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - tick)
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)), f"ava train: losses {losses}")
    profile = device_time_by_kind(lambda: trainer.train_step(frames, boxes, labels), CONV_KERNEL_KINDS)
    torch.backends.cudnn.deterministic = True
    try:
        path = checkpoints.save_checkpoint(str(AVA_OUT / "steps"), trainer.module, trainer.optimizer, 0, cfg)
        twin = build_trainer(cfg)
        checkpoints.load_checkpoint(path, twin.module, twin.optimizer)
        nxt = [float(t.train_step(frames, boxes, labels, generator=torch.Generator(device="cuda").manual_seed(9))[0])
               for t in (trainer, twin)]
    finally:
        torch.backends.cudnn.deterministic = False
    check(nxt[0] == nxt[1], f"ava: next loss after reload {nxt[1]} != {nxt[0]}")
    with torch.no_grad():
        maps = twin.module.body(frames)
    grads = []
    for _ in range(2):
        leaves = [m.detach().requires_grad_() for m in maps]
        twin.module.head.pooled(leaves, boxes).square().sum().backward()
        grads.append([leaf.grad for leaf in leaves])
    check(all(torch.equal(a, b) for a, b in zip(*grads)), "ava: roi_align's backward gave other bits")
    del trainer, twin, maps, grads
    torch.cuda.empty_cache()
    return dict(steps=AVA_TRAIN_STEPS, batch=int(frames.shape[0]), boxes=int(boxes.shape[0]), losses=losses,
                step_seconds=seconds, ms_per_step=1e3 * float(np.mean(seconds[1:])),
                keyframes_per_sec=frames.shape[0] * (len(seconds) - 1) / sum(seconds[1:]), peak_memory_gb=peak,
                step_device_time=profile, next_losses=nxt, roi_backward_bits_twice=True)


def ava_test_net(cfg) -> dict:
    """``test_net.test`` over the test split: one row of scores a loaded box
    (the predicted boxes above the threshold), the excluded keyframe in the
    csv and out of the scoring, ``detections_latest.csv`` written with a row
    a box and evaluated class, the frame mAP finite in [0, 1]."""
    rows, scored = [], set()

    class Recording(test_net.AVAMeter):
        def update_stats(self, preds, ori_boxes, metadata, loss=None, lr=None):
            rows.append(len(preds))
            return super().update_stats(preds, ori_boxes, metadata, loss, lr)

    class Scored(ava_eval.PascalDetectionEvaluator):
        def add_single_detected_image_info(self, image_key, boxes, classes, scores):
            scored.add(image_key)
            return super().add_single_detected_image_info(image_key, boxes, classes, scores)

    tick = time.perf_counter()
    with patched(test_net, AVAMeter=Recording), patched(ava_eval, PascalDetectionEvaluator=Scored):
        (views, stats), = test_net.test(cfg)
    seconds = time.perf_counter() - tick
    ds = construct_loader(cfg, "test").dataset
    loaded = sum(len(boxes) for video in ds._keyframe_boxes_and_labels for boxes in video)
    csv = pathlib.Path(cfg.OUTPUT_DIR) / "detections_latest.csv"
    lines = csv.read_text().splitlines() if csv.exists() else []
    excluded = f"{AVA_EXCLUDED[0]},{AVA_EXCLUDED[1]:04d}"
    check(sum(rows) == loaded and len(lines) == loaded * len(AVA_EVALUATED),
          f"ava test_net: {sum(rows)} rows of {loaded} boxes, {len(lines)} csv lines")
    check(excluded not in scored and any(line.startswith(excluded) for line in lines)
          and len(scored) == len(ds) - 1, f"ava test_net: scored {sorted(scored)}")
    check(stats["split"] == "test_final" and np.isfinite(stats["map"]) and 0.0 <= stats["map"] <= 1.0,
          f"ava test_net: {stats}")
    return dict(seconds=seconds, keyframes=len(ds), boxes=loaded, batches=len(rows), csv_rows=len(lines),
                frame_map=stats["map"], keyframes_per_sec=len(ds) / seconds)


def ava_train_net(cfg) -> dict:
    """``train_net.train`` for one epoch of the 16 train keyframes at B8
    (precise BatchNorm over the backbone, a checkpoint) and its val pass
    over the ``sec % 4 == 0`` keyframes: finite losses, the val mAP in
    [0, 1], ``detections_latest.csv`` and the checkpoint written."""
    losses, maps = [], []

    class Recording(train_net.AVAMeter):
        def update_stats(self, preds, ori_boxes, metadata, loss=None, lr=None):
            if self.mode == "train":
                losses.append(float(loss))
            return super().update_stats(preds, ori_boxes, metadata, loss, lr)

        def finalize_metrics(self, log: bool = True):
            stats = super().finalize_metrics(log)
            maps.append((self.mode, stats["map"]))
            return stats

    tick = time.perf_counter()
    with patched(train_net, AVAMeter=Recording):
        train(cfg)
    seconds = time.perf_counter() - tick
    out = pathlib.Path(cfg.OUTPUT_DIR)
    check(len(losses) == AVA_VIDEOS * len(AVA_SECS) // 8 and all(np.isfinite(losses)),
          f"ava train_net: losses {losses}")
    check([m for m, _ in maps] == ["val"] and 0.0 <= maps[0][1] <= 1.0, f"ava train_net: val {maps}")
    check((out / "detections_latest.csv").exists() and checkpoints.get_last_checkpoint(str(out)) is not None,
          "ava train_net: the csv or the checkpoint is missing")
    return dict(seconds=seconds, losses=losses, val_map=maps[0][1])


def ava_mvit_card_against_cpu() -> dict:
    """MViTv2-S (``MVITV2_S_OPTS``) with the ROI head at 1/32, fp32, B1 on a
    16 x 224 x 224 clip (its relative positions take the configured grid
    only, as in ``vtm``) with three boxes: the card's sigmoid rows and
    pooled features against the CPU's, within MVIT_CPU_TOL of the largest."""
    cfg = mvit_cfg("DETECTION.ENABLE", "True", "DETECTION.SPATIAL_SCALE_FACTOR", "32", "MODEL.NUM_CLASSES", "80",
                   "MODEL.HEAD_ACT", "sigmoid", "TPU.COMPUTE_DTYPE", "float32")
    module = build_model(cfg, "cpu").module
    x = torch.from_numpy(np.random.default_rng(71).standard_normal((1, 16, 224, 224, 3)).astype(np.float32))
    boxes = torch.tensor([[0.0, 10.0, 20.0, 120.0, 200.0], [0.0, 100.0, 50.0, 223.0, 223.0],
                          [0.0, -8.0, 150.0, 40.0, 240.0]])

    def outputs(x, bx):
        seen = []
        hook = module.head.projection.register_forward_hook(lambda m, a, out: seen.append(a[0]))
        try:
            with torch.inference_mode():
                scores = module(x, bboxes=bx)[0]
        finally:
            hook.remove()
        return {"scores": scores.double().cpu().numpy(), "pooled": seen[0].double().cpu().numpy()}

    tick = time.perf_counter()
    cpu = outputs(x, boxes)
    cpu_seconds = time.perf_counter() - tick
    module.to("cuda")
    with tf32(False):
        card = outputs(x.cuda(), boxes.cuda())
    out = dict(batch=1, frames=16, crop=224, boxes=3, cpu_seconds=cpu_seconds, tol=MVIT_CPU_TOL)
    for key in cpu:
        scale = float(np.abs(cpu[key]).max())
        err = float(np.abs(card[key] - cpu[key]).max()) / scale
        check(np.isfinite(cpu[key]).all() and err <= MVIT_CPU_TOL, f"ava MViTv2-S {key}: {err} of {scale}")
        out[key] = dict(largest=scale, rel_err=err)
    check(cpu["scores"].shape == (3, 80), f"ava MViTv2-S scores {cpu['scores'].shape}")
    return out


def phase_ava(smi: str) -> None:
    """AVA detection at full width (``AVA_OPTS``: SlowFast 32x2 R50 with
    the ROI head, fp32, TF32 off but where said) on a tree written under
    build/ (``write_ava``): a B2 test batch card against CPU and fp64;
    serving at B8, TF32 off and on, with the backbone's and the ROI head's
    device ms; 3 train steps at B8 and a reload; ``test_net.test`` over the
    tree; one epoch of ``train_net.train`` with its val pass; MViTv2-S with
    the ROI head card against CPU. No K1-K5b or T1-T12 may launch."""
    shutil.rmtree(AVA_OUT, ignore_errors=True)
    zero_launch_counts()
    start = time.perf_counter()
    data = write_ava(AVA_OUT / "data")
    written = time.perf_counter() - start
    cfg = ava_cfg(*data, "OUTPUT_DIR", str(AVA_OUT / "out"))
    t0 = time.perf_counter()
    figures = ava_card_against_cpu(cfg, ava_batch(cfg, "test", 2))
    emit("ava_card_vs_cpu", seconds=time.perf_counter() - t0, factor=SF_FP64_FACTOR, floor=SF_FP64_FLOOR,
         **figures, nvidia_smi=smi)
    t0 = time.perf_counter()
    figures = ava_serve(cfg, ava_batch(cfg, "test", 8))
    emit("ava_serve", seconds=time.perf_counter() - t0, **figures,
         tf32_speedup=figures["tf32_off"]["ms"] / figures["tf32_on"]["ms"], nvidia_smi=smi)
    t0 = time.perf_counter()
    figures = ava_train_steps(cfg, ava_batch(cfg, "train", 8))
    emit("ava_train", seconds=time.perf_counter() - t0, **figures, optimizer="sgd(momentum 0.9, wd 1e-4)",
         dropout=cfg.MODEL.DROPOUT_RATE, nvidia_smi=smi)
    t0 = time.perf_counter()
    figures = ava_test_net(ava_cfg(*data, "OUTPUT_DIR", str(AVA_OUT / "test")))
    emit("ava_test_net", **figures, nvidia_smi=smi)
    t0 = time.perf_counter()
    figures = ava_train_net(ava_cfg(*data, "OUTPUT_DIR", str(AVA_OUT / "train_net"), "SOLVER.MAX_EPOCH", "1",
                                    "TRAIN.EVAL_PERIOD", "1", "TRAIN.CHECKPOINT_PERIOD", "1"))
    emit("ava_train_net", **figures, nvidia_smi=smi)
    t0 = time.perf_counter()
    figures = ava_mvit_card_against_cpu()
    emit("ava_mvit_card_vs_cpu", seconds=time.perf_counter() - t0, **figures, nvidia_smi=smi)
    emit("ava", seconds=time.perf_counter() - start, write_seconds=written,
         launches=check_no_attention_launches("ava"), nvidia_smi=smi)
    shutil.rmtree(AVA_OUT, ignore_errors=True)


def vis_videomae_gradcam() -> dict:
    """Grad-CAM at ``VIS_TARGET`` of VideoMAE ViT-B merged (fp32, B2): the map
    through the plain versions (``use_kernel=False`` in every block), then
    through K1 and K2 (launches counted: K1 9 in the forward, K2 3 in the
    backward) with the plain run's Matchings put in place, so that both runs
    merge the same tokens (``cpu_matchings_on_the_card``; the layers whose own
    Matching differed, by fp32 rounding on near ties, are reported); the maps
    within VIS_CAM_TOL, the predictions within BLOCK_TOL of the largest."""
    bundle = build_model(main_cfg("TPU.COMPUTE_DTYPE", "float32", "TEST.BATCH_SIZE", "2"), "cuda")
    video = torch.from_numpy(np.random.default_rng(31).random((2, 16, 224, 224, 3), dtype=np.float32)).cuda()
    cam = GradCAM(bundle, VIS_TARGET)
    for blk in bundle.module.blocks:
        blk.attn.use_kernel = False
    zero_launch_counts()
    with recording(merge_bipartite, "_match") as plain_matchings:
        tick = time.perf_counter()
        pmaps, ppreds = cam.localization_map(video)
        pseconds = time.perf_counter() - tick
    pcounts = launch_counts()
    for blk in bundle.module.blocks:
        blk.attn.use_kernel = True
    own = []
    zero_launch_counts()
    with cpu_matchings_on_the_card(plain_matchings, own):
        tick = time.perf_counter()
        maps, preds = cam.localization_map(video)
        seconds = time.perf_counter() - tick
    counts = launch_counts()
    check(counts["LAUNCHES"] == MERGED_K1_PER_FORWARD and counts["BWD_LAUNCHES"] == VIS_K2_PER_MAP
          and all(n == 0 for c, n in counts.items() if c not in ("LAUNCHES", "BWD_LAUNCHES")),
          f"vis Grad-CAM: launches {counts}")
    check(not any(pcounts.values()), f"vis Grad-CAM plain run: launches {pcounts}")
    check(len(own) == len(plain_matchings) == len(MERGED_COUNTS) - 1, f"vis Grad-CAM: {len(own)} Matchings")
    differed = [i for i, (a, b) in enumerate(zip(own, plain_matchings)) if not all(
        torch.equal(getattr(a, n), getattr(b, n)) for n in ("unm_idx", "src_idx", "dst_idx"))]
    check(maps.shape == (2, 1568) and np.isfinite(maps).all() and maps.min() >= 0 and maps.max() <= 1,
          f"vis Grad-CAM: map {maps.shape}")
    err = float(np.abs(maps - pmaps).max())
    pred_err = float(np.abs(preds - ppreds).max() / np.abs(ppreds).max())
    check(err <= VIS_CAM_TOL and pred_err <= BLOCK_TOL, f"vis Grad-CAM: kernel against plain {err}, preds {pred_err}")
    del bundle
    torch.cuda.empty_cache()
    return dict(target=VIS_TARGET, batch=2, dtype="float32", launches=counts, map_max_abs_err=err, tol=VIS_CAM_TOL,
                preds_rel_err=pred_err, own_matching_differed_at_layers=differed, seconds_kernel=seconds,
                seconds_plain=pseconds)


def vis_slowfast_gradcam() -> dict:
    """Grad-CAM at s5 of SlowFast 8x8 R50 (fp32, BatchNorms moved as the
    slowfast phase moves them), B2 at the test crop: the card's map against
    the CPU's within VIS_CAM_TOL; the probabilities' error is reported."""
    cfg = sf_cfg()
    t, s = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
    cpu = build_model(cfg, "cpu")
    moved_bn(cpu.module, 33, 1.0)
    card = build_model(cfg, "cuda")
    card.module.load_state_dict(cpu.module.state_dict())
    x = np.random.default_rng(33).standard_normal((2, t, s, s, 3)).astype(np.float32)
    maps, preds = GradCAM(card).localization_map(x)
    cpu_maps, cpu_preds = GradCAM(cpu).localization_map(x)
    err = float(np.abs(maps - cpu_maps).max())
    pred_err = float(np.abs(preds - cpu_preds).max() / np.abs(cpu_preds).max())
    check(maps.shape == cpu_maps.shape and maps.ndim == 4 and np.isfinite(maps).all(), f"vis SlowFast map {maps.shape}")
    check(err <= VIS_CAM_TOL, f"vis SlowFast Grad-CAM: card against CPU {err} (probabilities {pred_err})")
    del card, cpu
    torch.cuda.empty_cache()
    return dict(target="s5", batch=2, frames=t, crop=s, grid=list(maps.shape[1:]), map_max_abs_err=err,
                tol=VIS_CAM_TOL, preds_rel_err=pred_err)


def write_video(path: pathlib.Path, frames: int, hw, fourcc: str, seed: int) -> None:
    """A video of ``frames`` smooth random frames of ``hw`` through cv2."""
    import cv2

    rng = np.random.default_rng(seed)
    h, w = hw
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 30, (w, h))
    base = rng.integers(0, 255, (h // 8, w // 8, 3), dtype=np.uint8)
    for f in range(frames):
        frame = cv2.resize(np.roll(base, f, axis=1), (w, h), interpolation=cv2.INTER_LINEAR)
        writer.write(frame)
    writer.release()


def count_frames(path) -> int:
    import cv2

    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def vis_demo() -> dict:
    """``demo_net.run_demo`` on VideoMAE ViT-B merged (bf16) over a
    VIS_DEMO_FRAMES-frame video, with the threaded video manager and two
    spawned drawing workers: a clip every 16 frames, K1's launches those of
    a forward a clip, the output video read back with every frame."""
    from vtm_torch.tools.demo_net import run_demo

    src, out = VIS_OUT / "demo_in.avi", VIS_OUT / "demo_out.mp4"
    write_video(src, VIS_DEMO_FRAMES, VIS_DEMO_HW, "MJPG", 34)
    cfg = main_cfg("DEMO.ENABLE", "True", "DEMO.INPUT_VIDEO", str(src), "DEMO.OUTPUT_FILE", str(out),
                   "DEMO.THREAD_ENABLE", "True", "DEMO.NUM_VIS_INSTANCES", "2", "OUTPUT_DIR", str(VIS_OUT))
    zero_launch_counts()
    tick = time.perf_counter()
    clips = run_demo(cfg)
    seconds = time.perf_counter() - tick
    counts = launch_counts()
    written = count_frames(out)
    expected = VIS_DEMO_FRAMES // (cfg.DATA.NUM_FRAMES * cfg.DATA.SAMPLING_RATE)
    check(clips == expected and written == VIS_DEMO_FRAMES, f"vis demo: {clips} clips, {written} frames written")
    check(counts["LAUNCHES"] == clips * MERGED_K1_PER_FORWARD and sum(counts.values()) == counts["LAUNCHES"],
          f"vis demo: launches {counts}")
    return dict(clips=clips, frames=written, seconds=seconds, frames_per_s=written / seconds, launches=counts,
                workers=2, threaded=True)


def vis_ava_demo(data_opts) -> dict:
    """``ava_demo_precomputed_boxes.run_demo`` on SlowFast 32x2 R50 with the
    ROI head over a video made of ``write_ava``'s first video's frames and
    its predicted boxes: the output video has every frame, and the frames
    around a drawn keyframe differ from the input's."""
    import cv2

    from vtm_torch.tools.ava_demo_precomputed_boxes import run_demo

    name = "ava000"
    frames = sorted((AVA_OUT / "data" / "frames" / name).glob("*.jpg"))
    src, out = VIS_OUT / f"{name}.avi", VIS_OUT / "ava_demo_out.mp4"
    writer = cv2.VideoWriter(str(src), cv2.VideoWriter_fourcc(*"MJPG"), 30, AVA_HW[::-1])
    for f in frames:
        writer.write(cv2.imread(str(f)))
    writer.release()
    cfg = ava_cfg(*data_opts, "DEMO.INPUT_VIDEO", str(src), "DEMO.OUTPUT_FILE", str(out),
                  "DEMO.PREDS_BOXES", str(AVA_OUT / "data" / "annotations" / "ava_val_predicted_boxes.csv"),
                  "DEMO.STARTING_SECOND", "900", "OUTPUT_DIR", str(VIS_OUT))
    tick = time.perf_counter()
    path = run_demo(cfg)
    seconds = time.perf_counter() - tick
    written = count_frames(path)
    check(written == len(frames), f"vis AVA demo: {written} of {len(frames)} frames")
    return dict(frames=written, demo_seconds=seconds)


def vis_loader_benchmark() -> dict:
    """``benchmark.benchmark_data_loading`` (VIS_EPOCHS epochs, shuffled) of
    VideoMAE's train loader (16 x 224 clips at sampling rate 1, B8, 4 workers) over
    VIS_VIDEOS Kinetics videos written with cv2, and over the synthetic
    dataset."""
    from vtm_torch.tools.benchmark import benchmark_data_loading

    root = VIS_OUT / "kinetics"
    root.mkdir(parents=True)
    rows = []
    for v in range(VIS_VIDEOS):
        write_video(root / f"v{v:02d}.avi", VIS_VIDEO_FRAMES, VIS_VIDEO_HW, "MJPG", 40 + v)
        rows.append(f"{root / f'v{v:02d}.avi'} {v % 4}")
    (root / "train.csv").write_text("\n".join(rows) + "\n")
    common = ("TRAIN.BATCH_SIZE", "8", "DATA_LOADER.NUM_WORKERS", "4", "BENCHMARK.NUM_EPOCHS", str(VIS_EPOCHS),
              "BENCHMARK.LOG_PERIOD", "1000", "OUTPUT_DIR", str(VIS_OUT))
    figures = {}
    for dataset, opts in (("kinetics", ("DATA.PATH_TO_DATA_DIR", str(root))), ("synthetic", ())):
        stats = benchmark_data_loading(main_cfg(*common, "TRAIN.DATASET", dataset, *opts))
        check(stats["total_batches"] == VIS_EPOCHS * (VIS_VIDEOS if dataset == "kinetics" else 16) // 8,
              f"vis benchmark {dataset}: {stats['total_batches']} batches")
        figures[dataset] = {k: stats[k] for k in ("total_batches", "batches_per_sec", "clips_per_sec",
                                                   "peak_rss_bytes")}
    return dict(batch=8, workers=4, epochs=VIS_EPOCHS, videos=VIS_VIDEOS, video_frames=VIS_VIDEO_FRAMES, video_hw=list(VIS_VIDEO_HW),
                **figures)


def phase_vis(smi: str) -> int:
    """The visualisation and demo tail (``vtm_torch/vis``, tools/{demo_net,
    ava_demo_precomputed_boxes,benchmark}.py) at full width: Grad-CAM on
    VideoMAE ViT-B through K1 and K2 against the plain versions on the card;
    Grad-CAM on SlowFast card against CPU; the demo with its threaded manager
    and spawned drawing workers; the AVA demo on ``write_ava``'s tree; the
    loader benchmark. Returns (K1, K2) launches of the Grad-CAM and demo runs."""
    shutil.rmtree(VIS_OUT, ignore_errors=True)
    shutil.rmtree(AVA_OUT, ignore_errors=True)
    VIS_OUT.mkdir(parents=True)
    start = time.perf_counter()
    t0 = time.perf_counter()
    gradcam = vis_videomae_gradcam()
    emit("vis_gradcam", seconds=time.perf_counter() - t0, **gradcam, nvidia_smi=smi)
    t0 = time.perf_counter()
    figures = vis_slowfast_gradcam()
    emit("vis_slowfast_gradcam", seconds=time.perf_counter() - t0, **figures, nvidia_smi=smi)
    demo = vis_demo()
    emit("vis_demo", **demo, nvidia_smi=smi)
    t0 = time.perf_counter()
    zero_launch_counts()
    figures = vis_ava_demo(write_ava(AVA_OUT / "data"))
    emit("vis_ava_demo", seconds=time.perf_counter() - t0, **figures,
         launches=check_no_attention_launches("vis_ava_demo"), nvidia_smi=smi)
    t0 = time.perf_counter()
    figures = vis_loader_benchmark()
    emit("vis_benchmark", seconds=time.perf_counter() - t0, **figures, nvidia_smi=smi)
    emit("vis", seconds=time.perf_counter() - start, nvidia_smi=smi)
    shutil.rmtree(VIS_OUT, ignore_errors=True)
    shutil.rmtree(AVA_OUT, ignore_errors=True)
    return (gradcam["launches"]["LAUNCHES"] + demo["launches"]["LAUNCHES"], gradcam["launches"]["BWD_LAUNCHES"])


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
    phase_mf_divided(smi)
    phase_mf_approx(smi)
    launches += phase_videomae_options(smi)
    bwd_launches = phase_train(smi, **VIDEOMAE_TRAIN)
    frame_bwd_launches = phase_train(smi, **MOTIONFORMER_TRAIN)
    blockdiag_bwd_launches = phase_train(smi, **TIMESFORMER_TRAIN)
    bwd_launches += phase_train(smi, **VIVIT_TRAIN)
    dist, tp_parts = phase_dist(smi)
    launches += dist["LAUNCHES"]
    bwd_launches += dist["BWD_LAUNCHES"]
    tp = phase_tp(smi, *tp_parts)
    launches += tp["LAUNCHES"]
    frame_launches += tp["FRAME_LAUNCHES"]
    frame_bwd_launches += tp["FRAME_BWD_LAUNCHES"]
    blockdiag_launches += tp["BLOCKDIAG_LAUNCHES"]
    blockdiag_bwd_launches += tp["BLOCKDIAG_BWD_LAUNCHES"]
    phase_slowfast(smi)
    phase_ptv(smi)
    phase_multigrid(smi)
    phase_charades(smi)
    phase_mvit(smi)
    phase_mvit_rev(smi)
    phase_maskfeat(smi)
    phase_mae(smi)
    phase_contrastive(smi)
    phase_ava(smi)
    vis_k1, vis_k2 = phase_vis(smi)
    launches += vis_k1
    bwd_launches += vis_k2
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
