#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (cl_ica_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, nvcc (the kernels are built from ops/csrc at first
use) and no network, and it exits non-zero on any failure. Phases:

  0 device   the card's name and power limit; TF32 off for the references
  1 build    build the native library (g++: the Hungarian solver and the
             packed store's gather), then (one nvcc per source, started
             together) load the four libraries of hand-written kernels,
             with build seconds and ptxas reports
  2 kernels  fused_neg_lse's and fused_dot_lse's three kernels each against
             their plain PyTorch version: values and both grads under a
             non-constant cotangent; ragged, rectangular and full-size
             shapes; rolled inputs (exact matches); for the dot kernels
             also three temperatures, unit-sphere and normal inputs, and
             logits of order 1e4, and both losses at the column slices
             main_3dident's split loss hands them (512 rows, n = 3 at
             p = 2 and n = 8); both losses' three kernels also at shapes
             that cut their chunks unevenly, at n = 3, 8, 10, 12, 13, 16
             and 17 (every instance of the tiled forwards and of the
             dot's tiled gradients, and the first versions past them),
             fused_neg_lse's at collapsed and far-apart inputs against
             float64; both losses at tau = 1e38, whose 1 / tau is not a
             normal float (the libraries send it to the first
             versions), against float64; two forward calls on the same
             inputs, bit for bit. The stem's three kernels (stem_fwd,
             stem_bwd, stem_dx) against theirs, float32 and bfloat16:
             small ragged shapes, tied inputs, C of 256 vectors, and the
             full (1024, 112, 112, 64); two backward calls, bit for bit.
             The minres norm's four kernels (bn_stats, bn_apply, bn_bwd,
             bn_dx; the "bn" part) at every norm shape of ResNet18 and of
             ResNet-50's blocks at 1024 images (C = 64 to 2048, 112x112 down
             to 7x7) and two ragged ones, float32 and bfloat16, for each of
             bn_relu, bn_add_relu and bn_only: the statistics against
             float64 sums, apply (y), the backward sums (with bn_add_relu's
             g) and dx against their plain versions given the plain
             version's a, b and sums, two calls bit for bit; bn_add_relu's
             backward with two upstream gradients (a block junction's)
             against PyTorch's add of them and the one-addend backward, the
             sums, g and dx bit for bit; then the three functions whole
             (forward and backward through the kernels) against float64 at
             (16, 28, 28, 64)
  3 parity   loss and every encoder grad of one training step at full
             width (n=10, 100-500-500-500-500-100, B=6144), fused vs not,
             for three configurations
  4 main     cli.main_mlp.main three times (4a README headline sphere+vMF
             p=2, 4b box+Laplace p=1, 4c sphere+vMF p=0 SimCLR with the
             fixed-sphere head): launch counters, finite and falling
             losses, finite scores; then a run stopped at a checkpoint and
             resumed against the uninterrupted run, loss for loss
  5 times    kernel vs plain vs PyTorch's own calls at B=6144 and at
             main_3dident's two column slices (device time: CUDA graphs of
             10 calls, median of 15 replays), each kernel's bound, and the
             training step's pairs/s at p=2 and p=0
  6 3dident  a synthetic 3DIdent fixture (4096 renders at 224x224, written
             under runs/chip_smoke/), then cli.main_3dident at full width
             (ResNet18, batch 512, both views in one forward of 1024
             images): 6a unsupervised with --fused-stem, where the six loss
             and three stem kernels are launched once per step and no bn
             kernel; 6b the same seed on the default path (--norm-kind
             minres: MINRES_STEP, the stem's norm, relu and pool on the
             argmax-code kernels, no stem kernel)
             against 6a's first losses; 6c --mode test on
             6a's saved model; 6d 6a stopped at a checkpoint and resumed,
             loss for loss; 6e 6a's seed with --no-fused-loss against
             6a's first losses, the six loss counters at 0
  7 times    the stem's kernels, the whole backward (stem_bwd and stem_dx),
             the three tensor passes stem_dx replaced, the whole fused
             function and PyTorch's own calls at (1024, 112, 112, 64),
             float32 and bfloat16, with each kernel's bound; the four bn
             kernels there in bn_relu's mode against their plain versions
             and PyTorch's SyncBatchNorm calls; the 3DIdent step's pairs/s
             and peak GiB on the default path (minres), with --norm-kind
             fast and with --fused-stem, in turns, float32 and --bf16
  8 kitti    a synthetic KITTI Masks corpus (150 sequences x 30 frames,
             seed 0, written under runs/chip_smoke/kitti) on the card; the
             three Lp kernels at main_kitti's shape (M = N = 32, n = 10,
             p = 1, tau = 1; rolled rows and an encoder's codes) against
             their plain versions; then cli.main_kitti at full width
             (ConvEncoder64, batch 64 = 32 pairs, z_dim 10, p = 1, lr
             1e-4): 8a its default configuration for 2,000 steps and the
             automatic evaluation (the three Lp kernels launched once per
             step; MCC >= KITTI_MCC_BAR_DEFAULT), then the same with
             --augment, the configuration of the JAX record at 2k steps
             (MCC >= KITTI_MCC_BAR); 8b 600 steps against 300, stopped at
             a checkpoint and resumed; 8c two lanes (--seeds 2) against
             serial seeds 0 and 1; 8d --augment for 200 steps, and both
             warps on the card against the CPU; 8e 8a's default
             configuration with --no-fused-loss against the fused run's
             first losses. 8b and 8c bit for bit under
             cudnn.deterministic. Then the step's pairs/s and device ms,
             and the three Lp kernels' times at its shape
  9 capture  the training step captured as a CUDA graph and replayed
             (train/capture.py), as the drivers run it on the card: for
             main_mlp p=2 and p=0 (B=6144), main_kitti default and
             --augment, and main_3dident --scan --fused-stem, --scan on
             the default path and --scan --optimizer sgd --lr-cosine on it
             (ResNet18, B=512), and --scan --bf16 --encoder rn50 on it
             (ResNet-50, B=512: RN50_STEP, the 53 norms' kernels, 15
             block junctions and the stem's code and scatter; ResNet18's
             MINRES_STEP has 7), a lane's eager steps
             against another lane's warm-up,
             capture and replays from the same seed, losses and
             parameters bit for bit (KITTI and 3DIdent under
             cudnn.deterministic); the replays under
             torch.cuda.set_sync_debug_mode("error"); the samplers'
             fallback count 0; the launch counters equal to replays x
             each kernel's launches in one step; then pairs/s and device
             ms a step, eager against captured in turns (the default
             3DIdent lane's eager rate is phase 7's). Phases 4d, 6d
             (--scan), 8b and 8c already run the captured step
 10 prefetch main_3dident on phase 6's fixture kept on the host, as a store
             beyond the device budget is: 10a the native gather of 1024
             random rows against numpy's, bit for bit, and both rates;
             10b PrefetchingPairLoader with one worker against the device
             store's batches from the same seed, 20 batches, latents and
             uint8 renders bit for bit; 10c cli.main_3dident at full width
             on the default path with CL_ICA_TPU_DEVICE_IMAGE_BUDGET below
             the fixture and --workers 1 against the device store's run of
             the same seed, loss for loss and the evaluation under
             cudnn.deterministic, with the loss and bn counters; 10d
             --workers 4 and 0 (finite losses, the queue within its
             slots), --mode supervised and --mode test over budget; 10e
             pairs/s and peak GiB of the device store against the host path
             at --workers 1, 4 and 0, in turns, float32 and --bf16
 11 mesh     the data-parallel mesh (--mesh N, parallel/). The script needs
             one GPU, and NCCL takes one rank a device, so: 11a world
             size 1 over NCCL in a spawned rank on cuda:0, every collective
             called: main_mlp's box p=1 and p=0 lanes at full width (n=10,
             B=6144) and main_3dident's default minres step (ResNet18,
             B=512, phase 6's fixture), each against a lane of the same
             seed taking the eager single-device step, outputs, parameters
             and buffers bit for bit (cudnn.deterministic), with the launch
             counters of the mesh steps (loss kernels once a step, the bn
             kernels 20 times); 11b two gloo ranks on cuda:0 (the parallel
             API's backend and rank-to-device map, no driver flag):
             main_mlp --mesh 2 for 20 steps at B=6144 (each rank's Lp
             kernels at (3072, 6144)) and main_3dident --mesh 2 for 5 steps
             at B=512, against the one-device run of the seed (step 1 within
             1e-5, then finite and falling); 11c the Lp (p=1, 2) and dot
             kernels at a rank's (B/W, B) block for W = 2, 4, 8 against
             their plain versions at phase 2's bars, with device ms and
             bounds (the kernels line's "rect"); 11a also runs main_3dident
             --norm-kind minres8's step so, and takes the mesh lane's images
             from the row-sharded store. 11d --mesh-model on gloo ranks on
             cuda:0: main_mlp --mesh 2 --mesh-model 2 and --mesh 4
             --mesh-model 2 at B=6144 against 11b's one-device run (step 1
             within 1e-5, then finite and falling); main_3dident --mesh 4
             --mesh-model 2 (ResNet18, num_filters 64, B=64, 3 steps,
             float32 and --bf16) against --mesh 2 (step 1 within 1e-5, and
             a bfloat16 ulp), the loss kernels once and the bn kernels 20
             times a step on rank 0; the stem, minres, minres8 and argmax
             pool kernels at the channel-split shapes (64, 112, 112, C) for
             C = 32 and 16, float32 and bfloat16, against their plain
             versions. 11e the row-sharded store: at world size 1 over NCCL
             the uint8 reduce-scatter on the card and store_gather_scatter
             against direct indexing; two gloo ranks: the --mesh 2 step on
             the row-sharded store bit-equal, loss for loss, to the whole
             store's path, and the bytes a rank holds (N_padded / 2 renders).
             11f the captured mesh step at world size 1 over NCCL: main_mlp's
             mesh lane (box p=1, B=6144) captured with its collectives,
             against its body run eagerly, 22 steps bit for bit, the replays
             under sync debug mode "error"; eager against captured ms a
             step in turns
 12 options  the ResNet's remaining options. 12a the float8 modes of the
             bn kernels (bn_apply8, bn_bwd8, bn_dx8; ops/bn_minres8.py) at
             every norm shape of ResNet18 at 1024 images and two ragged
             ones, float32 and bfloat16, in each of bn_relu, bn_add_relu and
             bn_only, against their plain versions: xq byte-equal (also past
             e4m3fn's range, where it is NaN), y bit-equal to the minres
             apply kernel's, the sums and dx at the bn bars; xhat at 448,
             464, 465, 500, inf and -500 (C9); the argmax pool's code and
             scatter kernels (pool_code, pool_scatter; ops/pool_minres.py)
             at (1024, 112, 112, 64), one image, one window, a W/2 that no
             strip divides, C of 256 vectors, tied inputs and all-zero
             windows (a < 0): pooled and codes equal, a second code launch
             bit-equal, dz equal to the plain version's and within a
             rounding of max_pool2d_with_indices_backward's; the code
             kernel's plan, blocks an SM and shared memory; their times and
             bounds, and stem_fwd's (row 7) in the same turns.
             12b cli.main_3dident --norm-kind minres8 at full width (ResNet18,
             B=512, phase 6's fixture), 10 steps, step 1 bit-equal to
             minres's, finite and falling, the float8 modes 20 times a step;
             its --scan step against its eager step, bit for bit. 12c the
             model options at B=512 (1024 random images of 224x224), one
             training step each: stem_pool='argmax' against 'xla' (output
             1e-5, gradients 1e-4 relative), stem='s2d_exact' against conv7
             on the same weights, remat=True against none bit for bit with
             the running buffers (cudnn.deterministic), stem='s2d' finite.
             12d step ms and peak GiB, minres against minres8 and the xla
             stem pool against argmax, in turns, float32 and --bf16; 12a
             also times PyTorch's calls for the code (eval-mode batch_norm,
             relu, max_pool2d with indices), its pooled values held to the
             plain version's first
 13 rest     the rest of the JAX package. 13a each driver at full width
             with and without --profile-dir (main_mlp 4b for 201 steps at
             --n-log-steps 100, main_kitti default for 200 steps,
             main_3dident's default path for 5 eager steps), under
             cudnn.deterministic: losses (KITTI: logs and final parameters)
             bit for bit, the trace parsed and its CUDA kernel events
             counted against the launch counters (each counter's launch is
             one main kernel, graph replays included), its size; then the
             profiler's cost a step on the three lanes in turns. 13b
             CL_ICA_TPU_DEBUG=1: main_mlp 4b's captured lane for 200 steps
             bit for bit against the flag off, its replays under sync debug
             mode "error"; a NaN encoder weight raises ValueError at the
             first window boundary (main_mlp, main_kitti, captured) and at
             the first step (main_3dident, eager); main_3dident --scan
             exits naming the flag. 13c GIN and GLOW CouplingFlow (n = 10,
             8 blocks, B = 6144), SlowVAELoss at main_mlp's width, the
             same noise, ConvDecoder64 (batch 64, nc 1, (64, 1, 34, 34)),
             PositionalEncoding2D on 1024 images of 224x224x3 and
             generate_3dident_latents --n-points 1000000, each against the
             CPU: float64 equal to 1e-5, float32 no further from float64
             than 4x the CPU's (the flows at 8 blocks and SlowVAE's
             kl_normal keep fewer float32 digits than 1e-5 on either
             device), gradients to 1e-4, the encoding exactly, the latents'
             contracts

``--only a,b`` runs a subset of {mlp, stem, bn, 3dident, times, kitti,
capture, prefetch, mesh, options, rest} (the build
always runs) for a short look at one part. Such a run is no pass: it
prints {"ok": false, "partial": [...]} and exits 1; the kernels line and
the ok line are printed by the full run only.

The line before the last is a JSON object describing every kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import csv
import functools
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import torch.nn.functional as F

from cl_ica_tpu_torch.cli import kitti_solver, main_3dident, main_kitti, main_mlp
from cl_ica_tpu_torch import native, parallel
from cl_ica_tpu_torch.data import (
    PrefetchingPairLoader,
    ThreeDIdentBatchSampler,
    kitti,
    normalize_3dident,
)
from cl_ica_tpu_torch.data import threedident as data3d
from cl_ica_tpu_torch.models import (
    ConvEncoder64,
    MinResBN2d,
    MinResBNPool,
    construct_invertible_mlp,
    get_mlp,
)
from cl_ica_tpu_torch.ops import (
    bn_minres,
    bn_minres8,
    build,
    collectives,
    infonce,
    infonce_dot,
    pool_minres,
    stem,
)
from cl_ica_tpu_torch.spaces.utils import fallback_count, reset_fallback_counts
from cl_ica_tpu_torch.tools import make_synthetic_3dident, make_synthetic_kitti
from cl_ica_tpu_torch.train import (
    CapturedStep,
    checkpoint,
    make_optimizer,
    make_synthetic_train_step,
)
from cl_ica_tpu_torch.train.capture import WARMUP_STEPS

N_FEAT = 10
BATCH = 6144
TAU = 0.7
VALUE_BAR = 1e-5  # max|a-b| / max|b|, the compiled-TPU kernels' bar
GRAD_BAR = 1e-4
# Encoder grads of one step, against the float64 step: the fused step's
# error is at most 1e-4 of the largest grad of the tensor, or at most
# twice the materialized float32 step's error.
STEP_GRAD_BAR = 1e-4
STEP_FACTOR = 2.0
# main_mlp's --save-dir artifacts of phase 4, inside the checkout (runs/
# is not tracked)
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "runs", "chip_smoke")
# Published peaks of one H100 SXM at its 700 W limit: float32 outside the
# tensor cores, and device memory.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
LP = ("fwd", "dz1", "dz3")               # fused_neg_lse's launch counters
DOT = ("dot_fwd", "dot_dz1", "dot_dz3")  # fused_dot_lse's
STEM = ("stem_fwd", "stem_bwd", "stem_dx")  # the stem tail's
BN = ("bn_stats", "bn_apply", "bn_bwd", "bn_dx")  # the blocks' minres norm's
STEM_FULL = (1024, 112, 112, 64)         # conv7's output for 1024 images of 224x224
# float32: the kernel and the plain version round x*a and +b separately and
# add at most four g's in one order, so pooled and dy should be equal; the
# bar leaves one float32 rounding. The channel sums and dx are added in
# another order than torch.sum's.
STEM_MAP_BAR = 1e-6
STEM_SUM_BAR = 1e-5
# The minres norm (ops/bn_minres.py) at every norm shape of ResNet18 at 1024
# images (the stem's, then stages 1-4), its three functions and their modes
RN18_NORMS = (STEM_FULL, (1024, 56, 56, 64), (1024, 28, 28, 128),
              (1024, 14, 14, 256), (1024, 7, 7, 512))
BN_FUNCTIONS = (("bn_relu", False, True), ("bn_add_relu", True, True),
                ("bn_only", False, False))  # (name, residual add, relu)
BN_NORMS_A_STEP = 20  # ResNet18's norms, each one launch of each bn kernel
# the block outputs whose backward takes two upstream gradients (every
# block's but the last, whose one edge is the mean pool): bn_junctions
BN_JUNCTIONS_A_STEP = 7
# every norm of ResNet-50's bottleneck blocks at 1024 images (its stem's is
# ResNet18's): at (7, 7, 2048) a bfloat16 row is one block's threads, so a
# block takes one position a pass and the sums write a (2, 528, 2048)
# partial for their reduction
RN50_NORMS = tuple((1024, h, h, c) for h, c in (
    (56, 64), (56, 128), (56, 256), (28, 128), (28, 256), (28, 512),
    (14, 256), (14, 512), (14, 1024), (7, 512), (7, 2048)))
RN50_NORMS_A_STEP = 53
RN50_JUNCTIONS_A_STEP = 15
POOL = ("pool_code", "pool_scatter")  # the argmax-code pool's
# the default minres path a step: the stem's norm, relu and pool are
# ops/pool_minres.py bn_relu_pool (its statistics, the code and scatter,
# and bn_relu's backward sums and dx), the other 19 norms minres's
MINRES_STEP = {"bn_stats": BN_NORMS_A_STEP, "bn_apply": BN_NORMS_A_STEP - 1,
               "bn_bwd": BN_NORMS_A_STEP, "bn_dx": BN_NORMS_A_STEP,
               "bn_junctions": BN_JUNCTIONS_A_STEP,
               **dict.fromkeys(POOL, 1)}
# the same path with ResNet-50's 53 norms
RN50_STEP = {**dict.fromkeys(BN, RN50_NORMS_A_STEP),
             "bn_apply": RN50_NORMS_A_STEP - 1,
             "bn_junctions": RN50_JUNCTIONS_A_STEP, **dict.fromkeys(POOL, 1)}
# The statistics against float64 sums (the kernel adds in double, so its
# error is a float32 rounding or two); the channel sums against torch.sum's
# float32 sums; y, g and dx as the stem's maps.
BN_STATS_BAR = 1e-6
BN_SUM_BAR = 1e-5
EPS = 1e-5
BF16_ULP = 2.0 ** -7  # bfloat16: one unit in the last place, relative
KERNELS = {  # launch counter -> (name, source, the Pallas body it replaces)
    "fwd": ("neg_lse_fwd_tiled<PM, NF> + lse_reduce_kernel",
            "cl_ica_tpu_torch/ops/csrc/infonce_lp.cu",
            "cl_ica_tpu/ops/infonce_pallas.py:84"),
    "dz1": ("neg_lse_dz1", "cl_ica_tpu_torch/ops/csrc/infonce_lp.cu",
            "cl_ica_tpu/ops/infonce_pallas.py:110"),
    "dz3": ("neg_lse_dz3", "cl_ica_tpu_torch/ops/csrc/infonce_lp.cu",
            "cl_ica_tpu/ops/infonce_pallas.py:148"),
    "dot_fwd": ("dot_lse_fwd_tiled<NF> + lse_reduce_kernel",
                "cl_ica_tpu_torch/ops/csrc/infonce_dot.cu",
                "cl_ica_tpu/ops/infonce_pallas.py:319"),
    "dot_dz1": ("dot_lse_grad_kernel<NF, false> + grad_reduce_kernel",
                "cl_ica_tpu_torch/ops/csrc/infonce_dot.cu",
                "cl_ica_tpu/ops/infonce_pallas.py:345"),
    "dot_dz3": ("dot_lse_grad_kernel<NF, true> + grad_reduce_kernel",
                "cl_ica_tpu_torch/ops/csrc/infonce_dot.cu",
                "cl_ica_tpu/ops/infonce_pallas.py:369"),
    "stem_fwd": ("stem_fwd", "cl_ica_tpu_torch/ops/csrc/stem_pool.cu",
                 "cl_ica_tpu/ops/stem_pallas.py:223"),
    "stem_bwd": ("stem_bwd_kernel + stem_reduce_kernel",
                 "cl_ica_tpu_torch/ops/csrc/stem_pool.cu",
                 "cl_ica_tpu/ops/stem_pallas.py:235"),
    "stem_dx": ("stem_dx_kernel", "cl_ica_tpu_torch/ops/csrc/stem_pool.cu",
                "cl_ica_tpu/ops/stem_pallas.py:429 (XLA pass, not a pallas_call)"),
    "bn_stats": ("bn_stats_kernel<T> + bn_reduce_kernel",
                 "cl_ica_tpu_torch/ops/csrc/bn_minres.cu",
                 "cl_ica_tpu/ops/bn_minres.py:56 (_channel_stats; XLA passes, "
                 "not a pallas_call)"),
    "bn_apply": ("bn_apply_kernel<T, M>", "cl_ica_tpu_torch/ops/csrc/bn_minres.cu",
                 "cl_ica_tpu/ops/bn_minres.py:128 (the forwards' affine and "
                 "relu; XLA pass, not a pallas_call)"),
    "bn_bwd": ("bn_bwd_kernel<T, M> + bn_reduce_kernel",
               "cl_ica_tpu_torch/ops/csrc/bn_minres.cu",
               "cl_ica_tpu/ops/bn_minres.py:96 (_bn_bwd_core's sums and "
               "_mask_grad; XLA pass, not a pallas_call)"),
    "bn_dx": ("bn_dx_kernel<T, M>", "cl_ica_tpu_torch/ops/csrc/bn_minres.cu",
              "cl_ica_tpu/ops/bn_minres.py:106 (_bn_bwd_core's dx; XLA pass, "
              "not a pallas_call)"),
    "bn_apply8": ("bn_apply_kernel<T, M, true>",
                  "cl_ica_tpu_torch/ops/csrc/bn_minres.cu",
                  "cl_ica_tpu/ops/bn_minres8.py:76 (_quantize, with the "
                  "forwards' affine and relu; XLA pass, not a pallas_call)"),
    "bn_bwd8": ("bn_bwd_kernel<T, M, true> + bn_reduce_kernel",
                "cl_ica_tpu_torch/ops/csrc/bn_minres.cu",
                "cl_ica_tpu/ops/bn_minres8.py:92 (_bwd_core8's sums and "
                "_mask8 :111; XLA pass, not a pallas_call)"),
    "bn_dx8": ("bn_dx_kernel<T, M, true>", "cl_ica_tpu_torch/ops/csrc/bn_minres.cu",
               "cl_ica_tpu/ops/bn_minres8.py:106 (_bwd_core8's dx; XLA pass, "
               "not a pallas_call)"),
    "pool_code": ("pool_code_kernel<T>",
                  "cl_ica_tpu_torch/ops/csrc/stem_pool.cu",
                  "cl_ica_tpu/ops/pool_minres.py:48 (_pool_fwd_core; XLA "
                  "reduce_window, not a pallas_call)"),
    "pool_scatter": ("pool_scatter_kernel<T>",
                     "cl_ica_tpu_torch/ops/csrc/stem_pool.cu",
                     "cl_ica_tpu/ops/pool_minres.py:92 (_dz_stencil; XLA "
                     "pass, not a pallas_call)"),
}
# every launch counter (ops.launch_counts): the kernels' and bn_junctions
COUNTERS = (*KERNELS, "bn_junctions")
_RUN = ("--n 10 --batch-size 6144 --only-unsupervised --n-steps 100 "
        "--n-log-steps 50 --num-eval-batches 2 --seed 0").split()
HEADLINE = "--space-type sphere --c-p 0 --c-param 20 --p 2".split() + _RUN
BOX = "--space-type box --c-p 1 --p 1 --box-norm".split() + _RUN
SIMCLR = "--space-type sphere --c-p 0 --c-param 20 --p 0".split() + _RUN
CONFIGS = {"sphere": HEADLINE, "box": BOX, "simclr": SIMCLR}


TIMES = []  # every "[5 times]"/"[7 times]" line, printed again at the end


def _say_time(line: str) -> None:
    """Print a measurement and keep it: main() repeats them together just
    before the result lines, past the runs' own output."""
    print(line)
    TIMES.append(line)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"[0 device] {name}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; python {sys.version.split()[0]}")
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = native.build_library()
    print(f"[1 build] the native library (g++: the Hungarian solver and the "
          f"packed store's gather) {lib.name} ready in "
          f"{time.perf_counter() - t0:.1f} s")
    libraries = build.LIBRARIES
    t0 = time.perf_counter()
    build.build_libraries(libraries)
    for module in (infonce, infonce_dot, stem, bn_minres):
        module.load_kernels()
    secs = time.perf_counter() - t0
    print(f"[1 build] {', '.join(build.library_path(n).name for n in libraries)} "
          f"ready in {secs:.1f} s (one nvcc per source, in parallel)")
    for name in libraries:
        ptxas = [ln.strip() for ln in build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        print(f"[1 build] {name}: ptxas, {len(ptxas)} lines")
        for ln in ptxas:
            print(f"    {ln}")


def _pair(m: int, n: int, rng, n_feat: int = N_FEAT) -> tuple[np.ndarray, np.ndarray]:
    """z1 (m, n_feat) and z3 (n, n_feat) with z3[(i+1) % n] = z1[i]: every
    row of z1 has one exact match in z3, as z3_rec = roll(z1_rec, 1) gives."""
    z1 = (0.5 * rng.normal(size=(m, n_feat))).astype(np.float32)
    z3 = (0.5 * rng.normal(size=(n, n_feat))).astype(np.float32)
    for i in range(min(m, n)):
        z3[(i + 1) % n] = z1[i]
    return z1, z3


def _value_and_grads(fn, z1, z3, ct, dtype=torch.float32):
    a = torch.tensor(z1, device="cuda", dtype=dtype, requires_grad=True)
    b = torch.tensor(z3, device="cuda", dtype=dtype, requires_grad=True)
    lse = fn(a, b)
    (lse * ct.to(dtype)).sum().backward()
    torch.cuda.synchronize()
    return lse.detach(), a.grad, b.grad


def _hold(tag: str, names, got, want, worst: dict) -> None:
    """One kernel triple against its plain version, to the bar; ``worst``
    keeps each kernel's largest absolute error."""
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    for k, g, w in zip(names, got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{k} {tag}: non-finite output")
        worst[k] = max(worst.get(k, 0.0), float((g - w).abs().max()))
    print(f"[2 kernels] {tag}: rel err value {errs[0]:.2e} dz1 {errs[1]:.2e} "
          f"dz3 {errs[2]:.2e}")
    if errs[0] > VALUE_BAR or max(errs[1:]) > GRAD_BAR:
        raise AssertionError(
            f"kernel vs plain {tag}: {errs} above the bar "
            f"(value {VALUE_BAR}, grads {GRAD_BAR})")


def _cotangent(m: int, rng) -> torch.Tensor:
    return torch.tensor(rng.uniform(0.5, 1.5, m).astype(np.float32), device="cuda")


def _unit(z: np.ndarray) -> np.ndarray:
    return (z / np.linalg.norm(z, axis=1, keepdims=True)).astype(np.float32)


SHAPES = ((50, 50), (32, 96), (96, 32), (BATCH, BATCH))
SPLIT_B, SPLIT_NA, SPLIT_N = 512, 3, 11  # main_3dident: batch, position columns, latents


def _hold_split_slices(rng, worst: dict) -> None:
    """The six loss kernels at the shapes main_3dident's split loss gives
    them (phase 6a launches them so): the encoder's (2B, 11) output, z1 its
    first B = 512 rows, z3 = roll(z1, 1); fused_neg_lse at p = 2 on the 3
    position columns and fused_dot_lse on the 8 angular ones (rows of one
    radius, as the learnable-radius head leaves them), tau = 1, each
    operand a column slice made contiguous as the losses make it."""
    h = rng.normal(size=(2 * SPLIT_B, SPLIT_N)).astype(np.float32)
    h[:, SPLIT_NA:] = 1.3 * _unit(h[:, SPLIT_NA:])
    h = torch.tensor(h, device="cuda")
    ct = _cotangent(SPLIT_B, rng)

    def run(fn, cols):
        z = h.clone().requires_grad_()
        z1 = z[:SPLIT_B, cols]
        a, b = z1.contiguous(), torch.roll(z1, 1, dims=0).contiguous()
        a.retain_grad()
        b.retain_grad()
        lse = fn(a, b)
        (lse * ct).sum().backward()
        torch.cuda.synchronize()
        return lse.detach(), a.grad, b.grad

    pos, ang = slice(0, SPLIT_NA), slice(SPLIT_NA, SPLIT_N)
    _hold(f"neg_lse p=2 tau=1 n={SPLIT_NA} M=N={SPLIT_B} (3DIdent position columns)",
          LP, run(lambda a, b: infonce.fused_neg_lse(a, b, 2.0, 1.0), pos),
          run(lambda a, b: infonce.neg_lse_reference(a, b, 2.0, 1.0), pos), worst)
    _hold(f"dot_lse tau=1 n={SPLIT_N - SPLIT_NA} M=N={SPLIT_B} (3DIdent angular columns)",
          DOT, run(lambda a, b: infonce_dot.fused_dot_lse(a, b, 1.0), ang),
          run(lambda a, b: infonce_dot.dot_lse_reference(a, b, 1.0), ang), worst)


def _hold_uneven_splits(rng, worst: dict) -> None:
    """fused_neg_lse's three kernels at shapes that cut the other operand
    into chunks of unequal length and leave ragged row blocks (ops/infonce.py:
    split_plan), p = 1 and 2, at a width of each instance of the tiled
    forward (n = 3, 8, 10, 12 and 13, 16: NF = 4, 8, 10, 12, 16, a runtime
    n zero-padded; the tiled gradients are built for n = 3, 8, 10) and at
    n = 17, the first version's edge."""
    for n_feat in (3, 8, 10, 12, 13, 16, 17):
        for p in (1.0, 2.0):
            for m, n in ((BATCH, 700), (33, BATCH)):
                z1, z3 = _pair(m, n, rng, n_feat)
                ct = _cotangent(m, rng)
                _hold(f"neg_lse p={p:g} n={n_feat} M={m} N={n} (uneven chunks)", LP,
                      _value_and_grads(lambda a, b: infonce.fused_neg_lse(a, b, p, TAU),
                                       z1, z3, ct),
                      _value_and_grads(lambda a, b: infonce.neg_lse_reference(a, b, p, TAU),
                                       z1, z3, ct),
                      worst)


def _hold_dot_uneven_splits(rng, worst: dict) -> None:
    """fused_dot_lse's gradients at the shapes of _hold_uneven_splits, at a
    width of each instance of the tiled kernel (n = 3, 8, 10, 12 and 13,
    16: NF = 4, 8, 10, 12, 16, a runtime n zero-padded) and at n = 17, the
    first version's edge, at tau = 0.7 and 0.05."""
    for n_feat in (3, 8, 10, 12, 13, 16, 17):
        for tau in (TAU, 0.05):
            for m, n in ((BATCH, 700), (33, BATCH)):
                z1, z3 = _pair(m, n, rng, n_feat)
                ct = _cotangent(m, rng)
                _hold(f"dot_lse tau={tau:g} n={n_feat} M={m} N={n} (uneven chunks)",
                      DOT,
                      _value_and_grads(lambda a, b: infonce_dot.fused_dot_lse(a, b, tau),
                                       z1, z3, ct),
                      _value_and_grads(lambda a, b: infonce_dot.dot_lse_reference(a, b, tau),
                                       z1, z3, ct),
                      worst)


C6_TAU = 1e38  # 1 / tau = 1e-38 is below the smallest normal float


def _hold_unnormal_rtau(rng) -> None:
    """Both losses' forward and gradients at tau = C6_TAU, where quotient()
    cannot stand for the division and the libraries run the first versions
    of the forwards and of the dot's gradients. The gradients are of order
    1 / tau, near float32's smallest normal, where the float32 plain
    version's own products round to few bits: the kernels are held to the
    bars against the plain version in float64, the float32 plain version's
    error printed beside."""
    m, n = BATCH, 700
    z1, z3 = _pair(m, n, rng)
    ct = _cotangent(m, rng)
    cases = [(f"neg_lse p={p:g}", LP,
              lambda a, b, p=p: infonce.fused_neg_lse(a, b, p, C6_TAU),
              lambda a, b, p=p: infonce.neg_lse_reference(a, b, p, C6_TAU))
             for p in (1.0, 2.0)]
    cases.append(("dot_lse", DOT,
                  lambda a, b: infonce_dot.fused_dot_lse(a, b, C6_TAU),
                  lambda a, b: infonce_dot.dot_lse_reference(a, b, C6_TAU)))
    for tag, names, kern_fn, plain_fn in cases:
        infonce.reset_launch_counts()
        kern = _value_and_grads(kern_fn, z1, z3, ct)
        launched = infonce.launch_counts()
        exact = _value_and_grads(plain_fn, z1, z3, ct, torch.float64)
        plain = _value_and_grads(plain_fn, z1, z3, ct)
        e_kern = [rel_err(g.double(), w) for g, w in zip(kern, exact)]
        e_plain = [rel_err(g.double(), w) for g, w in zip(plain, exact)]
        print(f"[2 kernels] {tag} tau={C6_TAU:g} M={m} N={n}, rel err vs float64 "
              f"(value, dz1, dz3): kernel {e_kern[0]:.2e} {e_kern[1]:.2e} "
              f"{e_kern[2]:.2e}; float32 plain {e_plain[0]:.2e} {e_plain[1]:.2e} "
              f"{e_plain[2]:.2e}; launches {launched}")
        if any(launched[k] != 1 for k in names):
            raise AssertionError(f"{tag} tau={C6_TAU:g}: launches {launched}")
        if not all(torch.isfinite(g).all() for g in kern):
            raise AssertionError(f"{tag} tau={C6_TAU:g}: non-finite output")
        if e_kern[0] > VALUE_BAR or max(e_kern[1:]) > GRAD_BAR:
            raise AssertionError(f"{tag} tau={C6_TAU:g} vs float64: {e_kern}")
    infonce.reset_launch_counts()


def _hold_forward_repeats(rng) -> None:
    """Two forward calls on the same inputs give the same lse bit for bit:
    both losses at B = BATCH (n = 10, the forwards' chunks merged by
    lse_reduce_kernel) and at main_3dident's slices."""
    for m, n_feat in ((BATCH, N_FEAT), (SPLIT_B, SPLIT_NA), (SPLIT_B, SPLIT_N - SPLIT_NA)):
        a, b = (torch.tensor(z, device="cuda") for z in _pair(m, m, rng, n_feat))
        for tag, fn in (("neg_lse p=1", lambda: infonce.fused_neg_lse(a, b, 1.0, TAU)),
                        ("neg_lse p=2", lambda: infonce.fused_neg_lse(a, b, 2.0, TAU)),
                        ("dot_lse", lambda: infonce_dot.fused_dot_lse(a, b, TAU))):
            first, again = fn(), fn()
            torch.cuda.synchronize()
            if not torch.equal(first.view(torch.int32), again.view(torch.int32)):
                raise AssertionError(f"{tag} M=N={m} n={n_feat}: two forward "
                                     f"calls differ")
    print(f"[2 kernels] forward repeats: two calls bit-equal at M=N={BATCH} "
          f"n={N_FEAT} and M=N={SPLIT_B} n={SPLIT_NA}, {SPLIT_N - SPLIT_NA}, "
          f"p=1, p=2 and dot")


def _dot_radii_errors(rng) -> tuple[list, list, bool]:
    """Large logits with near-ties: rows of radii uniform in (0, 30], no
    exact match, tau = 0.05, M = N = BATCH. The relative errors (value, dz1,
    dz3) of the kernels and of the float32 plain version, both against the
    plain version in float64, and whether the kernels' outputs are finite."""
    z1 = _unit(rng.normal(size=(BATCH, N_FEAT))) * rng.uniform(0, 30, (BATCH, 1))
    z3 = _unit(rng.normal(size=(BATCH, N_FEAT))) * rng.uniform(0, 30, (BATCH, 1))
    z1, z3 = z1.astype(np.float32), z3.astype(np.float32)
    ct = _cotangent(BATCH, rng)
    kern = _value_and_grads(lambda a, b: infonce_dot.fused_dot_lse(a, b, 0.05), z1, z3, ct)
    exact = _value_and_grads(lambda a, b: infonce_dot.dot_lse_reference(a, b, 0.05),
                             z1, z3, ct, torch.float64)
    plain = _value_and_grads(
        lambda a, b: infonce_dot.dot_lse_reference(a, b, 0.05), z1, z3, ct)
    e_kern = [rel_err(g.double(), w) for g, w in zip(kern, exact)]
    e_plain = [rel_err(g.double(), w) for g, w in zip(plain, exact)]
    finite = all(bool(torch.isfinite(g).all()) for g in kern)
    del kern, plain, exact
    torch.cuda.empty_cache()
    return e_kern, e_plain, finite


def _lp_inputs(kind: str, rng) -> tuple[np.ndarray, np.ndarray]:
    """z1, z3 (BATCH, N_FEAT). "collapsed": every row one point plus noise
    of 1e-3, z3's rows shifted by 3e-3 in every feature, so that every w is
    near 1/N and nearly all terms of a row share a sign (an encoder early in
    training). "far-apart": rows of N(0, 5^2), no match, so that the logits
    reach ~1e3 and each row's weight rests on a few columns."""
    if kind == "collapsed":
        c = rng.normal(size=(1, N_FEAT))
        z1 = c + 1e-3 * rng.normal(size=(BATCH, N_FEAT))
        z3 = c + 3e-3 + 1e-3 * rng.normal(size=(BATCH, N_FEAT))
    else:
        z1, z3 = (5.0 * rng.normal(size=(BATCH, N_FEAT)) for _ in range(2))
    return z1.astype(np.float32), z3.astype(np.float32)


def _hold_vs_float64(kind: str, p: float, rng) -> None:
    """The kernels and the float32 plain version, both against the plain
    version in float64, under the rule of the radii case below: the
    kernel's error may be at most the bar, or STEP_FACTOR times the float32
    plain version's own. Their absolute errors are kept apart from those of
    the ordinary inputs, as the radii case's are."""
    z1, z3 = _lp_inputs(kind, rng)
    ct = _cotangent(BATCH, rng)
    kern = _value_and_grads(lambda a, b: infonce.fused_neg_lse(a, b, p, TAU), z1, z3, ct)
    plain = _value_and_grads(lambda a, b: infonce.neg_lse_reference(a, b, p, TAU), z1, z3, ct)
    exact = _value_and_grads(lambda a, b: infonce.neg_lse_reference(a, b, p, TAU),
                             z1, z3, ct, torch.float64)
    e_kern = [rel_err(g.double(), w) for g, w in zip(kern, exact)]
    e_plain = [rel_err(g.double(), w) for g, w in zip(plain, exact)]
    print(f"[2 kernels] neg_lse {kind} p={p:g} M=N={BATCH}, rel err vs float64 "
          f"(value, dz1, dz3): kernel {e_kern[0]:.2e} {e_kern[1]:.2e} "
          f"{e_kern[2]:.2e}; float32 plain {e_plain[0]:.2e} {e_plain[1]:.2e} "
          f"{e_plain[2]:.2e}")
    if not all(torch.isfinite(g).all() for g in kern):
        raise AssertionError(f"neg_lse {kind} p={p:g}: non-finite output")
    for e, ep, bar in zip(e_kern, e_plain, (VALUE_BAR, GRAD_BAR, GRAD_BAR)):
        if e > max(bar, STEP_FACTOR * ep):
            raise AssertionError(f"neg_lse {kind} p={p:g} vs float64: kernel "
                                 f"{e_kern}, float32 plain {e_plain}")
    del kern, plain, exact
    torch.cuda.empty_cache()


def phase_kernels() -> dict:
    rng = np.random.default_rng(0)
    worst = {k: 0.0 for k in LP + DOT}
    for p in (1.0, 2.0, 3.0):
        for m, n in ((50, 50), (32, 96), (BATCH, BATCH)):
            z1, z3 = _pair(m, n, rng)
            ct = _cotangent(m, rng)
            got = _value_and_grads(
                lambda a, b: infonce.fused_neg_lse(a, b, p, TAU), z1, z3, ct)
            want = _value_and_grads(
                lambda a, b: infonce.neg_lse_reference(a, b, p, TAU), z1, z3, ct)
            _hold(f"neg_lse p={p:g} M={m} N={n}", LP, got, want, worst)

    def dot_pair(tau, z1, z3, ct, dtype=torch.float32):
        kern = _value_and_grads(
            lambda a, b: infonce_dot.fused_dot_lse(a, b, tau), z1, z3, ct)
        plain = _value_and_grads(
            lambda a, b: infonce_dot.dot_lse_reference(a, b, tau), z1, z3, ct,
            dtype)
        return kern, plain

    for m, n in SHAPES:
        z1, z3 = _pair(m, n, rng)  # N(0, 0.5²), rolled
        inputs = {"normal": (z1, z3), "sphere": (_unit(z1), _unit(z3))}
        ct = _cotangent(m, rng)
        for kind, (a, b) in inputs.items():
            for tau in (0.05, 0.7, 1.0):
                got, want = dot_pair(tau, a, b, ct)
                _hold(f"dot_lse {kind} tau={tau:g} M={m} N={n}", DOT, got,
                      want, worst)
        # logits of order 1e4: rows of norm 30 at tau = 0.05. Rolled, every
        # row's match z1_i.z3_(i+1)/tau = 18000 stands far above the rest.
        # Held to the same relative bar; the absolute errors (ulps of 1e4)
        # are kept apart from those of the ordinary inputs.
        got, want = dot_pair(0.05, 30 * inputs["sphere"][0],
                             30 * inputs["sphere"][1], ct)
        _hold(f"dot_lse |z|=30 tau=0.05 M={m} N={n}", DOT, got, want, {})

    # the wide variants of the kernels (16 < n <= 64), which main_mlp's
    # n = 10 never reaches
    z1, z3 = _pair(70, 45, rng, n_feat=40)
    ct = _cotangent(70, rng)
    _hold("neg_lse p=2 n=40 M=70 N=45", LP,
          _value_and_grads(lambda a, b: infonce.fused_neg_lse(a, b, 2.0, TAU), z1, z3, ct),
          _value_and_grads(lambda a, b: infonce.neg_lse_reference(a, b, 2.0, TAU), z1, z3, ct),
          worst)
    _hold("dot_lse n=40 M=70 N=45", DOT, *dot_pair(TAU, z1, z3, ct), worst)

    _hold_split_slices(rng, worst)
    _hold_uneven_splits(rng, worst)
    for p in (1.0, 2.0):
        for kind in ("collapsed", "far-apart"):
            _hold_vs_float64(kind, p, rng)

    # Large logits with near-ties: radii uniform in (0, 30], no exact match.
    # A logit near 1e4 carries a float32 rounding error of ~1e-3, and where
    # a row's two largest logits are within a few units of each other the
    # softmax weights inherit that as a relative error, in the kernel and
    # in the float32 plain version alike. So both are held against the
    # plain version in float64: the kernel's error may be at most the bar,
    # or STEP_FACTOR times the float32 plain version's own error.
    e_kern, e_plain, finite = _dot_radii_errors(rng)
    print(f"[2 kernels] dot_lse radii<=30 tau=0.05 M=N={BATCH}, rel err vs "
          f"float64 (value, dz1, dz3): kernel {e_kern[0]:.2e} {e_kern[1]:.2e} "
          f"{e_kern[2]:.2e}; float32 plain {e_plain[0]:.2e} {e_plain[1]:.2e} "
          f"{e_plain[2]:.2e}")
    if not finite:
        raise AssertionError("dot_lse radii<=30: non-finite output")
    for e, ep, bar in zip(e_kern, e_plain, (VALUE_BAR, GRAD_BAR, GRAD_BAR)):
        if e > max(bar, STEP_FACTOR * ep):
            raise AssertionError(
                f"dot_lse radii<=30 vs float64: kernel {e_kern}, float32 "
                f"plain {e_plain}")
    _hold_dot_uneven_splits(rng, worst)
    _hold_unnormal_rtau(rng)
    _hold_forward_repeats(rng)
    return worst


def _headline_model(config: str):
    args = main_mlp.parse_args(CONFIGS[config])
    latent = main_mlp.build_latent_space(args, torch.device("cuda"))
    g = construct_invertible_mlp(
        n=N_FEAT, n_layers=3, act_fct="leaky_relu", cond_thresh_ratio=0.0,
        n_iter_cond_thresh=25000, rng=np.random.default_rng(0)).cuda()
    f = get_mlp(N_FEAT, N_FEAT, [100, 500, 500, 500, 500, 100],
                output_normalization=main_mlp.output_normalization_of(args),
                generator=torch.Generator().manual_seed(0)).cuda()
    return args, latent, g, f


def _loss_of(args, use_fused: bool):
    args.fused_loss, args.no_fused_loss = use_fused, not use_fused
    return main_mlp.make_loss(args)


def _step_grads(f, g, z1, z2, args, use_fused):
    """Loss and every encoder grad of one training step's objective."""
    loss_fn = _loss_of(args, use_fused)
    f.zero_grad(set_to_none=True)
    with torch.no_grad():
        x1, x2 = g(z1), g(z2)
    z1_rec, z2_rec = f(x1), f(x2)
    total, _, _ = loss_fn(z1, z2, None, z1_rec, z2_rec,
                          torch.roll(z1_rec, 1, dims=0))
    total.backward()
    torch.cuda.synchronize()
    return (total.detach().double(),
            {k: v.grad.detach().double() for k, v in f.named_parameters()})


def phase_step_parity() -> None:
    """The fused and the materialized float32 steps, each held against the
    same step in float64 (materialized). Relative error alone cannot be the
    bar: the Lp loss is invariant to translating z, so the last layer's bias
    has a true gradient of 0 and its float32 values are rounding noise."""
    for config in CONFIGS:
        args, latent, g, f = _headline_model(config)
        gen = torch.Generator(device="cuda").manual_seed(0)
        z1, z2 = latent.sample_pair(gen, BATCH)
        fused = _step_grads(f, g, z1, z2, args, True)
        plain = _step_grads(f, g, z1, z2, args, False)
        exact = _step_grads(copy.deepcopy(f).double(), copy.deepcopy(g).double(),
                            z1.double(), z2.double(), args, False)
        loss_err = {k: float(abs(r[0] - exact[0]) / abs(exact[0]))
                    for k, r in (("fused", fused), ("plain", plain))}
        worst_name, worst = "", -1.0
        for name, want in exact[1].items():
            e_fused = float((fused[1][name] - want).abs().max())
            e_plain = float((plain[1][name] - want).abs().max())
            bound = max(STEP_FACTOR * e_plain,
                        STEP_GRAD_BAR * float(want.abs().max()))
            if e_fused / bound > worst:
                worst_name, worst = name, e_fused / bound
        print(f"[3 parity] {config} p={args.p} B={BATCH}: loss fused "
              f"{float(fused[0]):.7f} plain {float(plain[0]):.7f} float64 "
              f"{float(exact[0]):.7f}; loss rel err vs float64 fused "
              f"{loss_err['fused']:.2e} plain {loss_err['plain']:.2e}; grads "
              f"vs float64, worst fused error / bound over {len(exact[1])} "
              f"tensors {worst:.3f} ({worst_name})")
        if loss_err["fused"] > VALUE_BAR or worst > 1.0:
            raise AssertionError(f"step parity {config}: loss {loss_err}, "
                                 f"grad error / bound {worst} at {worst_name}")


def _run_main(tag: str, argv: list[str], path: tuple) -> dict:
    """One main-path run, with every launch count set to 0 just before it
    and read just after: the kernels of ``path`` must each have been
    launched once per step, and no other kernel at all."""
    save = os.path.join(OUT_DIR, tag)
    shutil.rmtree(save, ignore_errors=True)  # log.csv is appended to
    infonce.reset_launch_counts()
    t0 = time.perf_counter()
    lin, perm = main_mlp.main(argv + ["--save-dir", save], device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    grew = infonce.launch_counts()
    with open(os.path.join(save, "log.csv")) as fh:
        rows = list(csv.DictReader(fh))
    steps = int(rows[-1]["step"])
    losses = [float(r[k]) for r in rows for k in ("loss", "mean_loss")]
    first = next(float(r["mean_loss"]) for r in rows if int(r["step"]) == 51)
    last = float(rows[-1]["mean_loss"])
    pps = float(rows[-1]["pairs_per_sec"])
    print(f"[4 main] {tag}: {secs:.1f} s, {steps} steps; launches "
          f"{grew}; mean loss steps 2-51 {first:.5f} -> last 50 {last:.5f}; "
          f"linear {lin:.4f} perm {perm:.4f}; logged pairs/s {pps:.0f} "
          f"(windows include evaluation)")
    want = {k: steps if k in path else 0 for k in grew}
    if grew != want:
        raise AssertionError(f"{tag}: launches {grew}, expected {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag}: non-finite logged loss")
    if not last < first:
        raise AssertionError(f"{tag}: loss did not fall ({first} -> {last})")
    if not (math.isfinite(lin) and math.isfinite(perm)):
        raise AssertionError(f"{tag}: non-finite scores {lin}, {perm}")
    return grew


class _Stopped(Exception):
    pass


def phase_resume() -> None:
    """Run 4c's configuration for 40 steps with a checkpoint every 20:
    once uninterrupted, once stopped right after its first checkpoint
    (step 21, the first evaluation window past 20) and resumed. The loss
    histories must be equal: no kernel of the port uses atomics."""
    argv = SIMCLR[:SIMCLR.index("--n-steps")] + (
        "--n-steps 40 --more-unsupervised 1 --n-log-steps 10 "
        "--num-eval-batches 2 --seed 0 --save-every 20").split()
    dirs = {k: os.path.join(OUT_DIR, f"4d_resume_{k}") for k in ("whole", "cut")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)

    def losses_of(d):
        _, state = checkpoint.load_resume_state(os.path.join(d, "resume"))
        return state["step"], state["lane"]["losses"]

    whole = main_mlp.main(argv + ["--save-dir", dirs["whole"]], device="cuda")
    save = checkpoint.save_resume_state

    def save_then_stop(*args):
        save(*args)
        raise _Stopped

    checkpoint.save_resume_state = save_then_stop
    try:
        main_mlp.main(argv + ["--save-dir", dirs["cut"]], device="cuda")
        raise AssertionError("resume check: the run was not stopped")
    except _Stopped:
        pass
    finally:
        checkpoint.save_resume_state = save
    stopped_at, _ = losses_of(dirs["cut"])
    resumed = main_mlp.main(argv + ["--save-dir", dirs["cut"], "--resume"],
                            device="cuda")
    (_, want), (_, got) = losses_of(dirs["whole"]), losses_of(dirs["cut"])
    same = sum(a == b for a, b in zip(got, want))
    print(f"[4 main] 4d resume: stopped at step {stopped_at}, resumed to "
          f"{len(got)}; {same} of {len(want)} losses equal the uninterrupted "
          f"run's; final scores {resumed} vs {whole}")
    if stopped_at != 21 or len(want) != 40 or got != want or resumed != whole:
        raise AssertionError("resume check: the resumed run differs")


def _event_ms(fn, calls: int) -> float:
    """Device ms per call of ``calls`` back-to-back calls of fn."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _median_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median over reps of the device time per call. A sub-millisecond call
    is timed in runs of up to 10 between one pair of events: a single call
    on an idle device is charged the host's time to enqueue it, which
    depends on the host more than on the card."""
    for _ in range(warmup):
        fn()
    calls = max(1, min(10, int(5.0 / max(_event_ms(fn, 1), 1e-3))))
    return statistics.median(_event_ms(fn, calls) for _ in range(reps))


def _graph_ms(fn, calls: int = 10, reps: int = 15, prepare=None) -> float:
    """Median device ms per call of fn: ``calls`` calls captured in one
    CUDA graph on a side stream, the graph replayed ``reps`` times between
    two events, so that no host time is counted (at main_3dident's shapes,
    and for the redesigned gradients at B = 6144, launching a call takes
    the host longer than the card takes to run it). ``prepare`` runs on
    that stream first: a gradient's forward goes there, so that autograd
    runs its backward on the stream being captured. A failed capture
    raises."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        if prepare is not None:
            prepare()
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def _time_loss(impl, m: int = BATCH, n_feat: int = N_FEAT) -> dict:
    """Device ms (_graph_ms) of the forward, each gradient alone, and
    forward+backward of impl(z1, z3) at m x m, n_feat features."""
    rng = np.random.default_rng(1)
    z1, z3 = _pair(m, m, rng, n_feat)
    ct = torch.ones(m, device="cuda")

    def leaves(g1: bool, g3: bool):
        return (torch.tensor(z1, device="cuda", requires_grad=g1),
                torch.tensor(z3, device="cuda", requires_grad=g3))

    a, b = leaves(False, False)
    out = {"fwd": _graph_ms(lambda: impl(a, b))}
    for k, (g1, g3) in (("dz1", (True, False)), ("dz3", (False, True))):
        a, b = leaves(g1, g3)
        wrt = a if g1 else b
        held = {}

        def forward():
            held["lse"] = impl(a, b)

        out[k] = _graph_ms(
            lambda: torch.autograd.grad(held["lse"], wrt, ct, retain_graph=True),
            prepare=forward)
        del held
    a, b = leaves(True, True)
    out["fwd+bwd"] = _graph_ms(lambda: impl(a, b).backward(ct))
    return out


def _step_pairs_per_sec(config: str) -> float:
    """Steady training steps of one of phase 4's configurations."""
    args, latent, g, f = _headline_model(config)
    opt, _ = make_optimizer(f.parameters(), args.lr)
    step = make_synthetic_train_step(latent.sample_pair, g, f,
                                     main_mlp.make_loss(args), opt, BATCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(5):
        step(gen)
    torch.cuda.synchronize()
    n = 50
    t0 = time.perf_counter()
    for _ in range(n):
        step(gen)
    torch.cuda.synchronize()
    return n * BATCH / (time.perf_counter() - t0)


def _bounds(m: int, n_rows: int, n: int) -> dict:
    """The least ms the card could take for each of a loss's three kernels
    at these shapes, and which resource sets it. Operations: a pair-feature
    term of the logit costs two flops (dot: multiply, add; Lp: subtract,
    accumulate), and a gradient recomputes the logits and accumulates a
    second product, two more. Bytes: every input read once, every output
    written once. Against the fp32 rate outside the tensor cores and the
    device-memory rate at the 700 W limit."""
    terms = m * n_rows * n
    operands = (m + n_rows) * n
    floats = {"fwd": operands + m,                     # lse out
              "dz1": operands + 2 * m + m * n,         # lse, ct in; dz1 out
              "dz3": operands + 2 * m + n_rows * n}    # lse, ct in; dz3 out
    out = {}
    for k, count in floats.items():
        ops = (2 if k == "fwd" else 4) * terms
        t_ops, t_bytes = ops / PEAK_FP32_FLOPS, 4 * count / PEAK_BYTES_PER_S
        out[k] = (1e3 * max(t_ops, t_bytes),
                  "operations" if t_ops >= t_bytes else "bytes")
    return out


def _loss_cases(p: float, tau: float) -> tuple:
    """(kernel, plain, library) of one loss: fused_neg_lse at p >= 1,
    fused_dot_lse at p = 0. The library yardstick is PyTorch's own calls
    for the same function, two calls that materialize the M x N matrix; the
    port never calls them on its main path with the kernel route on."""
    if p == 0:
        return (lambda a, b: infonce_dot.fused_dot_lse(a, b, tau),
                lambda a, b: infonce_dot.dot_lse_reference(a, b, tau),
                lambda a, b: torch.logsumexp(a @ b.T / tau, 1))
    return (lambda a, b: infonce.fused_neg_lse(a, b, p, tau),
            lambda a, b: infonce.neg_lse_reference(a, b, p, tau),
            lambda a, b: torch.logsumexp(-_cdist_pow(a, b, p) / tau, 1))


def _cdist_pow(a, b, p: float):
    d = torch.cdist(a, b, p=p)
    return d if p == 1 else d ** p


# label -> (p, tau, M = N, n): main_mlp's three at B = 6144, then the two
# column slices of main_3dident's split loss (phase 6a)
TIMED = {"p=1": (1.0, TAU, BATCH, N_FEAT), "p=2": (2.0, TAU, BATCH, N_FEAT),
         "p=0": (0.0, TAU, BATCH, N_FEAT),
         "p=2 3dident": (2.0, 1.0, SPLIT_B, SPLIT_NA),
         "p=0 3dident": (0.0, 1.0, SPLIT_B, SPLIT_N - SPLIT_NA)}


def phase_times(smi: str) -> dict:
    """{label: (kernel, plain, library)} of device ms dicts (_graph_ms),
    for every entry of TIMED."""
    times = {}
    for label, (p, tau, m, n_feat) in TIMED.items():
        kernel, plain, library = _loss_cases(p, tau)
        # alternate which goes first: plain, kernel, kernel, plain
        turns = [_time_loss(f, m, n_feat) for f in (plain, library, kernel,
                                                    kernel, library, plain)]
        best = lambda x, y: {k: min(x[k], y[k]) for k in x}
        times[label] = (best(turns[2], turns[3]), best(turns[0], turns[5]),
                        best(turns[1], turns[4]))
        kern, pl, lib = times[label]
        _say_time(f"[5 times] {label} M=N={m} n={n_feat} tau={tau:g} device ms "
                  f"(kernel / plain / library), CUDA graph of 10 calls, median of "
                  f"15 replays, better of two turns, on {smi}: "
                  + "; ".join(f"{k} {kern[k]:.3f} / {pl[k]:.3f} / {lib[k]:.3f}"
                              for k in kern))
    for m, n_feat in ((BATCH, N_FEAT), (SPLIT_B, SPLIT_NA), (SPLIT_B, SPLIT_N - SPLIT_NA)):
        for k, (ms, by) in _bounds(m, m, n_feat).items():
            _say_time(f"[5 times] bound {k} at M=N={m} n={n_feat}: {ms:.6f} ms, "
                      f"set by {by} (67 TFLOP/s fp32, 3.35 TB/s)")
    for config in ("sphere", "simclr"):
        pps = _step_pairs_per_sec(config)
        _say_time(f"[5 times] training step, {config} B={BATCH} n={N_FEAT}, "
                  f"50 steady steps: {pps:.0f} pairs/s on {smi}")
    return times


# ---------------------------------------------------------------------------
# the stem tail's kernels and the 3DIdent path
# ---------------------------------------------------------------------------


def _stem_inputs(shape, dtype, gen, tied: bool = False):
    """x like a convolution's output (per-channel scale and offset), the
    norm's scale and bias, and a pooled-shape cotangent, on the card. With
    ``tied`` x takes five levels, so that most windows hold equal values."""
    n, h, w, c = shape
    dev = "cuda"
    x = torch.randn(shape, device=dev, generator=gen)
    if tied:
        x = torch.round(x)
    else:
        x = x * (0.5 + torch.rand(c, device=dev, generator=gen)) \
            + 0.3 * torch.randn(c, device=dev, generator=gen)
    x = x.to(dtype)
    scale = 1.0 + 0.5 * torch.randn(c, device=dev, generator=gen)
    bias = 0.1 * torch.randn(c, device=dev, generator=gen)
    g = torch.randn((n, h // 2, w // 2, c), device=dev, generator=gen).to(dtype)
    return x, scale, bias, g


def _fold(x, scale, bias, eps=1e-5):
    """The per-channel a, b (in x's dtype), mean and rstd the kernels take."""
    mean, _, rstd = stem.batch_statistics(x, eps)
    a = (rstd * scale).to(x.dtype)
    b = (bias - mean * rstd * scale).to(x.dtype)
    return a, b, mean, rstd


def _map_err(got, want, dtype) -> tuple[float, float]:
    """(max abs error, error over the bar) of a pooled or dy map. float32:
    max|a-b| / max|b| against STEM_MAP_BAR. bfloat16: every element within
    one bfloat16 ulp of the plain version's."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if dtype == torch.bfloat16:
        over = float((diff / (BF16_ULP * want.abs() + 1e-30)).max())
    else:
        over = float(diff.max() / want.abs().max() / STEM_MAP_BAR)
    return float(diff.max()), over


def _dx_factors(x, scale, mean, rstd, sb, sg):
    """The dx kernel's per-channel factors, as _BnReluPool.backward forms
    them: k1, -k2, -k3*rstd."""
    m = x.shape[0] * x.shape[1] * x.shape[2]
    k1 = scale * rstd
    return k1, -(k1 * sb / m), -(k1 * sg / m * rstd)


def _three_pass_dx(x, dy, k1, nk2, nk3, mean):
    """dx as the backward formed it before stem_dx (the parent's three
    tensor passes and a cast): the yardstick of the dx kernel's time."""
    dx = torch.addcmul(nk2, dy, k1)
    dx.addcmul_(x.float() - mean, nk3)
    return dx.to(x.dtype)


def _hold_stem(tag, shape, dtype, gen, worst, tied=False) -> None:
    x, scale, bias, g = _stem_inputs(shape, dtype, gen, tied)
    a, b, mean, rstd = _fold(x, scale, bias)
    pooled = stem.launch_stem_fwd(x, a, b)
    dy, sb, sg = stem.launch_stem_bwd(x, g, a, b, mean, rstd)
    factors = _dx_factors(x, scale, mean, rstd, sb, sg)
    dx = stem.launch_stem_dx(x, dy, *factors, mean)
    # two calls on the same inputs: the same bits (no atomics anywhere)
    again = stem.launch_stem_bwd(x, g, a, b, mean, rstd)
    again += (stem.launch_stem_dx(x, dy, *factors, mean),)
    torch.cuda.synchronize()
    repeats = all(torch.equal(p, q) for p, q in zip((dy, sb, sg, dx), again))
    del again
    pooled_p = stem.stem_fwd_reference(x, a, b)
    dy_p, sb_p, sg_p = stem.stem_bwd_reference(x, g, a, b, mean, rstd)
    dx_p = stem.stem_dx_reference(x, dy, *factors, mean)
    e_fwd, o_fwd = _map_err(pooled, pooled_p, dtype)
    e_dy, o_dy = _map_err(dy, dy_p, dtype)
    e_dxk, o_dxk = _map_err(dx, dx_p, dtype)
    e_sum = max(rel_err(sb, sb_p), rel_err(sg, sg_p))
    del pooled, pooled_p, dy, dy_p, dx, dx_p

    # the whole function through autograd, kernel route against plain route
    def grads(fn):
        xs = x.detach().requires_grad_()
        sc, bi = scale.clone().requires_grad_(), bias.clone().requires_grad_()
        out, _, _ = fn(xs, sc, bi)
        (out.float() * g.float()).sum().backward()
        torch.cuda.synchronize()
        return xs.grad, sc.grad, bi.grad

    got, want = grads(stem.bn_relu_pool_train), grads(stem.bn_relu_pool_reference)
    e_dx, e_ds, e_db = (rel_err(a_.float(), b_.float()) for a_, b_ in zip(got, want))
    dx_bar = BF16_ULP if dtype == torch.bfloat16 else STEM_SUM_BAR
    worst["stem_fwd"] = max(worst.get("stem_fwd", 0.0), e_fwd)
    worst["stem_bwd"] = max(worst.get("stem_bwd", 0.0), e_dy)
    worst["stem_dx"] = max(worst.get("stem_dx", 0.0), e_dxk)
    worst["stem_sums_rel"] = max(worst.get("stem_sums_rel", 0.0), e_sum)
    name = str(dtype).removeprefix("torch.")
    print(f"[2 kernels] stem {tag} {tuple(shape)} {name}: max abs err pooled "
          f"{e_fwd:.2e} dy {e_dy:.2e} dx kernel {e_dxk:.2e} (error/bar "
          f"{o_fwd:.2f}, {o_dy:.2f}, {o_dxk:.2f}); rel err sums {e_sum:.2e}; "
          f"whole function dx {e_dx:.2e} dscale {e_ds:.2e} dbias {e_db:.2e}; "
          f"two calls {'bit-equal' if repeats else 'DIFFER'}")
    if (o_fwd > 1.0 or o_dy > 1.0 or o_dxk > 1.0 or e_sum > STEM_SUM_BAR
            or e_dx > dx_bar or max(e_ds, e_db) > STEM_SUM_BAR or not repeats):
        raise AssertionError(f"stem kernels vs plain, {tag} {shape} {name}")


def phase_stem_kernels(worst: dict) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        # ragged strips and segments of the backward's tiles, more channels
        # than one block's slice (16 vectors) and, last, C of 256 vectors,
        # the widest the kernels take
        widest = (2, 6, 10, 256 * stem.vector_width(dtype))
        for shape in ((3, 16, 16, 8), (2, 12, 20, 16), (5, 6, 10, 24),
                      (1, 2, 2, 8), (7, 30, 14, 64), (1, 40, 36, 8),
                      (2, 4, 6, 320), (2, 8, 70, 64), widest):
            _hold_stem("ragged", shape, dtype, gen, worst)
            _hold_stem("tied", shape, dtype, gen, worst, tied=True)
        _hold_stem("full", STEM_FULL, dtype, gen, worst)
        _hold_stem("full tied", STEM_FULL, dtype, gen, worst, tied=True)
        torch.cuda.empty_cache()
    # what the wrappers refuse
    x = torch.zeros((2, 8, 8, 8), device="cuda")
    v = torch.ones(8, device="cuda")
    for bad, exc in ((x.permute(0, 2, 1, 3), ValueError),   # not dense
                     (x[:, :7], ValueError),                # odd H
                     (x.cpu(), ValueError),                 # not on the card
                     (x.double(), TypeError)):
        vb = v.to(bad.dtype).to(bad.device)
        for launch in (lambda: stem.launch_stem_fwd(bad, vb, vb),
                       lambda: stem.launch_stem_dx(bad, bad, v, v, v, v)):
            try:
                launch()
            except exc:
                continue
            raise AssertionError(f"a stem wrapper took {bad.shape} {bad.dtype}")
    print("[2 kernels] stem wrappers raise on a strided, odd, CPU or float64 x")


# ---------------------------------------------------------------------------
# the minres norm's kernels
# ---------------------------------------------------------------------------


def _bn_inputs(shape, dtype, gen):
    """x like a convolution's output (per-channel scale and offset), a
    residual, a cotangent, and the norm's scale and bias, on the card."""
    c = shape[-1]
    dev = "cuda"
    x = torch.randn(shape, device=dev, generator=gen)
    x = (x * (0.5 + torch.rand(c, device=dev, generator=gen))
         + 0.3 * torch.randn(c, device=dev, generator=gen)).to(dtype)
    res = torch.randn(shape, device=dev, generator=gen).to(dtype)
    dy = torch.randn(shape, device=dev, generator=gen).to(dtype)
    scale = 1.0 + 0.5 * torch.randn(c, device=dev, generator=gen)
    bias = 0.1 * torch.randn(c, device=dev, generator=gen)
    return x, res, dy, scale, bias


def _stats64(x, eps=EPS):
    """(mean, var, rstd) as the kernel defines them (the square in x's
    dtype), summed in float64."""
    dims = tuple(range(x.ndim - 1))
    mean = x.double().mean(dim=dims)
    var = (x.square().double().mean(dim=dims) - mean * mean).clamp(min=0)
    return mean, var, torch.rsqrt(var + eps)


def _same_map(got, want, dtype) -> tuple[float, float]:
    """(max abs error, error over the bar) of y or g: float32 bit-equal (over
    the bar is 0 or inf), bfloat16 within one ulp of the plain version."""
    if dtype == torch.bfloat16:
        return _map_err(got, want, dtype)
    err = float((got - want).abs().max())
    return err, 0.0 if torch.equal(got, want) else math.inf


def _hold_junction(x, dy, dy_res, k, a, b, y) -> bool:
    """bn_add_relu's backward at a block junction, both upstream gradients
    handed over, against PyTorch's add of the two on the card (autograd's
    at the junction) followed by the one-addend backward: the sums, g and
    dx bit for bit."""
    two = bn_minres.launch_bwd(x, dy, a, b, y, dy_res=dy_res)
    one = bn_minres.launch_bwd(x, dy + dy_res, a, b, y)
    dx_two = bn_minres.launch_dx(x, two[2], k, a, b, relu=False)
    dx_one = bn_minres.launch_dx(x, one[2], k, a, b, relu=False)
    torch.cuda.synchronize()
    return (all(torch.equal(p, q) for p, q in zip(two, one))
            and torch.equal(dx_two, dx_one))


def _hold_bn(shape, dtype, gen, worst: dict) -> None:
    """The four kernels at one shape against their plain versions: the
    statistics (and two calls bit for bit) against float64 sums; then, for
    each function, apply, the backward sums (two calls bit for bit) and dx
    given the plain version's a, b, sums and (bn_add_relu's mask) output y,
    so that no relu mask can flip between the routes; bn_add_relu's g from
    the sums' pass, its dx on the plain version's g, and its backward with
    two upstream gradients against their add (``_hold_junction``)."""
    x, res, dy, scale, bias = _bn_inputs(shape, dtype, gen)
    stats = bn_minres.launch_stats(x, EPS)
    again = bn_minres.launch_stats(x, EPS)
    torch.cuda.synchronize()
    repeats = all(torch.equal(p, q) for p, q in zip(stats, again))
    plain = bn_minres.channel_stats(x, EPS)
    exact = _stats64(x)
    e_stats = max(rel_err(k.double(), e) for k, e in zip(stats, exact))
    e_plain = max(rel_err(p.double(), e) for p, e in zip(plain, exact))
    worst["bn_stats"] = max(worst.get("bn_stats", 0.0), max(
        float((k - p).abs().max()) for k, p in zip(stats, plain)))
    worst["bn_stats_rel64"] = max(worst.get("bn_stats_rel64", 0.0), e_stats)
    mean, _, rstd = plain
    a, b = bn_minres.affine(scale, bias, mean, rstd, dtype)
    count = x.numel() // shape[-1]
    name = str(dtype).removeprefix("torch.")
    fails = [] if e_stats <= BN_STATS_BAR and repeats else ["stats"]
    parts = []
    for fn, with_res, relu in BN_FUNCTIONS:
        r = res if with_res else None
        y_p = bn_minres.bn_apply_reference(x, a, b, r, relu)
        e_y, o_y = _same_map(bn_minres.launch_apply(x, a, b, r, relu), y_p, dtype)
        y = y_p if with_res else None  # bn_add_relu's backward reads its output
        del y_p
        first = bn_minres.launch_bwd(x, dy, a, b, y, relu)
        again = bn_minres.launch_bwd(x, dy, a, b, y, relu)
        torch.cuda.synchronize()
        repeats_sums = all(p is q is None or torch.equal(p, q)
                           for p, q in zip(first, again))
        *sums, g = first
        *sums_p, g_p = bn_minres.bn_bwd_reference(x, dy, a, b, y, relu)
        e_sums = max(rel_err(k, p) for k, p in zip(sums, sums_p))
        _, _, k = bn_minres.dx_factors(scale, mean, rstd, *sums_p, count, dtype)
        # bn_add_relu's dx is bn_only's mode on its g
        d, r = (g_p, False) if with_res else (dy, relu)
        dx = bn_minres.launch_dx(x, d, k, a, b, r)
        dx_p = bn_minres.bn_dx_reference(x, d, k, a, b, r)
        e_dx, o_dx = _map_err(dx, dx_p, dtype)
        e_g, o_g = _same_map(g, g_p, dtype) if with_res else (0.0, 0.0)
        junction = (_hold_junction(x, dy, res, k, a, b, y) if with_res
                    else True)
        del dx, g, dx_p, g_p, y, d, first, again
        worst["bn_apply"] = max(worst.get("bn_apply", 0.0), e_y)
        worst["bn_bwd"] = max(worst.get("bn_bwd", 0.0), max(
            float((p - q).abs().max()) for p, q in zip(sums, sums_p)))
        worst["bn_sums_rel"] = max(worst.get("bn_sums_rel", 0.0), e_sums)
        worst["bn_dx"] = max(worst.get("bn_dx", 0.0), e_dx, e_g)
        parts.append(f"{fn}: y {e_y:.2e} (over bar {o_y:.2f}) sums rel "
                     f"{e_sums:.2e} dx {e_dx:.2e} ({o_dx:.2f})"
                     + (f" g {e_g:.2e} ({o_g:.2f}); two upstream gradients "
                        f"vs their add: sums, g and dx "
                        f"{'bit-equal' if junction else 'DIFFER'}"
                        if with_res else "")
                     + f"; sums twice {'bit-equal' if repeats_sums else 'DIFFER'}")
        if (o_y > 1.0 or e_sums > BN_SUM_BAR or o_dx > 1.0 or o_g > 1.0
                or not repeats_sums or not junction):
            fails.append(fn)
    print(f"[2 kernels] bn {tuple(shape)} {name}: stats rel err vs float64 "
          f"{e_stats:.2e} (plain float32 {e_plain:.2e}), two calls "
          f"{'bit-equal' if repeats else 'DIFFER'}; " + "; ".join(parts))
    if fails:
        raise AssertionError(f"bn kernels vs plain, {shape} {name}: {fails}")


def _minres64(x, res, scale, bias, relu):
    """The function in float64 through autograd of the plain composition
    (the gradient through the statistics included)."""
    dims = tuple(range(x.ndim - 1))
    mean = x.mean(dim=dims)
    var = (x.square().mean(dim=dims) - mean * mean).clamp(min=0)
    a = scale * torch.rsqrt(var + EPS)
    z = x * a + (bias - mean * a)
    z = z if res is None else z + res
    return torch.relu(z) if relu else z


def _hold_bn_functions(gen, worst: dict) -> None:
    """The three Functions whole on CUDA tensors (the kernels, forward and
    backward) against float64 at (16, 28, 28, 64), where a relu mask that
    float32 rounding flips is improbable: y, dx, dres, dscale, dbias;
    bn_add_relu with a cotangent on each of its two edges (a block
    junction's), float64 with their sum."""
    x, res, dy, scale, bias = _bn_inputs((16, 28, 28, 64), torch.float32, gen)
    dy_res = torch.randn(x.shape, device="cuda", generator=gen)
    for fn, with_res, relu in BN_FUNCTIONS:
        got, want = [], []
        for route in ("kernels", "float64"):
            leaves = [t.clone().double() if route == "float64" else t.clone()
                      for t in ([x, res] if with_res else [x]) + [scale, bias]]
            for t in leaves:
                t.requires_grad_()
            if route == "kernels":
                out = getattr(bn_minres, fn)(*leaves, EPS)
                y = out[0]
                loss = (y * dy).sum() + ((out[1] * dy_res).sum() if with_res
                                         else 0.0)
            else:
                r = leaves[1] if with_res else None
                y = _minres64(leaves[0], r, leaves[-2], leaves[-1], relu)
                cot = dy + dy_res if with_res else dy
                loss = (y * cot.double()).sum()
            loss.backward()
            (got if route == "kernels" else want).extend(
                [y.detach()] + [t.grad for t in leaves])
        errs = [rel_err(p.double(), q) for p, q in zip(got, want)]
        worst["bn_fn_rel64"] = max(worst.get("bn_fn_rel64", 0.0), *errs)
        print(f"[2 kernels] bn {fn} whole, kernels vs float64 at (16, 28, 28, "
              f"64): rel err y {errs[0]:.2e}, grads "
              + " ".join(f"{e:.2e}" for e in errs[1:]))
        if errs[0] > VALUE_BAR or max(errs[1:]) > GRAD_BAR:
            raise AssertionError(f"bn {fn} whole function vs float64: {errs}")


def phase_bn_kernels(worst: dict) -> None:
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        # every norm shape of ResNet18 and ResNet-50 at 1024 images, and two
        # that cut C into slices (more than 256 vectors) or end a block's
        # pass early
        for shape in RN18_NORMS + RN50_NORMS + ((3, 5, 7, 2064), (2, 3, 5, 24)):
            _hold_bn(shape, dtype, gen, worst)
            torch.cuda.empty_cache()
    _hold_bn_functions(gen, worst)
    # what the wrappers refuse
    x = torch.zeros((2, 8, 8, 16), device="cuda")
    v = torch.ones(16, device="cuda")
    for bad, exc in ((x.permute(0, 2, 1, 3), ValueError),   # not dense
                     (torch.zeros((2, 8, 8, 6), device="cuda"),
                      ValueError),                          # C not of vectors
                     (x.cpu(), ValueError),                 # not on the card
                     (x.double(), TypeError)):
        for launch in (lambda: bn_minres.launch_stats(bad, EPS),
                       lambda: bn_minres.launch_apply(bad, v, v)):
            try:
                launch()
            except exc:
                continue
            raise AssertionError(f"a bn wrapper took {bad.shape} {bad.dtype}")
    print(f"[2 kernels] bn wrappers raise on a strided, ragged-C, CPU or "
          f"float64 x; bn part {time.perf_counter() - t0:.1f} s")


FIXTURE = os.path.join(OUT_DIR, "fixture_3dident")
_RUN3D = ["--offline-dataset", FIXTURE, "--batch-size", "512", "--encoder",
          "rn18", "--seed", "0"]


def phase_fixture() -> None:
    shutil.rmtree(FIXTURE, ignore_errors=True)
    t0 = time.perf_counter()
    make_synthetic_3dident.main(["--output-folder", FIXTURE, "--n-points",
                                 "4096", "--image-size", "224", "--seed", "0"])
    size = os.path.getsize(os.path.join(FIXTURE, "images_packed_224x224.u8"))
    print(f"[6 3dident] fixture: 4096 renders at 224x224, 11 latent columns, "
          f"{size / 1e9:.2f} GB packed, written in "
          f"{time.perf_counter() - t0:.1f} s")


def _run_3dident(tag: str, argv: list[str]) -> tuple[dict, dict, float]:
    """One main_3dident run with every launch count set to 0 just before it
    and read just after."""
    infonce.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = main_3dident.main(_RUN3D + argv, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    grew = infonce.launch_counts()
    print(f"[6 3dident] {tag}: {secs:.1f} s, {len(out['losses'])} steps; "
          f"launches {grew}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"{tag}: non-finite loss")
    return out, grew, secs


def phase_3dident() -> dict:
    run_dir = os.path.join(OUT_DIR, "6_3dident")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    model = os.path.join(run_dir, "6a_model.pt")
    steps = 40
    unsup = ["--mode", "unsupervised", "--n-log-steps", "20"]

    # 6a: the split loss is LpSimCLR(p=2) on the 3 position columns plus
    # SimCLR on the 8 angular ones, and --fused-stem forces the plain 'fast'
    # norm elsewhere: a step launches the six loss and three stem kernels
    # once and no bn kernel
    out_a, grew_a, _ = _run_3dident(
        "6a unsupervised --fused-stem",
        unsup + ["--fused-stem", "--iterations", str(steps), "--save-model",
                 model, "--log-dir", os.path.join(run_dir, "6a_log")])
    first, lastw = np.mean(out_a["losses"][:10]), np.mean(out_a["losses"][-10:])
    print(f"[6 3dident] 6a: mean loss steps 1-10 {first:.5f} -> last 10 "
          f"{lastw:.5f}; MCC {out_a['mcc']:.4f} linear R2 {out_a['lin']:.4f} "
          f"mean |hz| {out_a['mean_znorm']:.4f} (evaluation at step 21)")
    if grew_a != {k: steps if k in LP + DOT + STEM else 0 for k in COUNTERS}:
        raise AssertionError(f"6a: launches {grew_a}, expected {steps} of each "
                             "loss and stem kernel, no bn kernel")
    if not lastw < first:
        raise AssertionError(f"6a: loss did not fall ({first} -> {lastw})")
    if not (math.isfinite(out_a["mcc"]) and math.isfinite(out_a["lin"])):
        raise AssertionError("6a: non-finite scores")

    # 6b: the default path, --norm-kind minres: the twenty norms through
    # the bn kernels, the stem's with the code and scatter kernels
    # (MINRES_STEP), no stem kernel. The same
    # mathematics; from the same seed the first loss differs by the order
    # of float32 sums only, and Adam then amplifies that difference step by
    # step
    bn_minres.reset_dy_copies()
    out_b, grew_b, _ = _run_3dident(
        "6b unsupervised, default (minres norms)", unsup + ["--iterations", "10"])
    rel = [abs(b - a) / abs(a) for a, b in zip(out_a["losses"], out_b["losses"])]
    print("[6 3dident] 6b: |loss - 6a's| / |6a's| per step: "
          + " ".join(f"{r:.1e}" for r in rel)
          + f"; upstream gradients made dense by a copy: "
            f"{bn_minres.dy_copies()} over 10 steps")
    if (any(grew_b[k] for k in STEM) or any(grew_b[k] != 10 for k in LP + DOT)
            or any(grew_b[k] != 10 * v for k, v in MINRES_STEP.items())):
        raise AssertionError(f"6b: launches {grew_b}")
    if rel[0] > 1e-5 or max(rel[:3]) > 1e-3:
        raise AssertionError(f"6b: first losses differ from 6a's: {rel[:3]}")

    # 6e: 6a's seed with the materialized loss (--no-fused-loss): the six
    # loss kernels, here on column slices at n = 3 and n = 8, against their
    # plain versions inside the whole step
    out_e, grew_e, _ = _run_3dident(
        "6e unsupervised --fused-stem --no-fused-loss",
        unsup + ["--fused-stem", "--no-fused-loss", "--iterations", "10"])
    rel = [abs(e - a) / abs(a) for a, e in zip(out_a["losses"], out_e["losses"])]
    print("[6 3dident] 6e: |loss - 6a's| / |6a's| per step: "
          + " ".join(f"{r:.1e}" for r in rel))
    if (any(grew_e[k] for k in LP + DOT + BN)
            or any(grew_e[k] != 10 for k in STEM)):
        raise AssertionError(f"6e: launches {grew_e}")
    if rel[0] > 1e-5 or max(rel[:3]) > 1e-3:
        raise AssertionError(f"6e: first losses differ from 6a's: {rel[:3]}")

    # 6c: test mode sweeps the rendered set without replacement and runs no
    # loss and no training-mode stem, so no kernel
    out_c, grew_c, _ = _run_3dident(
        "6c test mode on 6a's model",
        ["--mode", "test", "--fused-stem", "--load-model", model])
    print(f"[6 3dident] 6c: MCC {out_c['mcc']:.4f} linear R2 {out_c['lin']:.4f}")
    if any(grew_c.values()):
        raise AssertionError(f"6c: launches {grew_c}")
    if not (math.isfinite(out_c["mcc"]) and math.isfinite(out_c["lin"])):
        raise AssertionError("6c: non-finite scores")

    # 6d: stopped at the step-3 checkpoint and resumed, against the
    # uninterrupted run, both with the step captured (--scan). cuDNN's
    # default convolution gradients may use atomics, so this check (and
    # only it) asks for its deterministic algorithms; the port's own
    # kernels have no atomics.
    def resume_argv(name):
        return unsup + ["--fused-stem", "--scan", "--iterations", "6",
                        "--save-every", "3",
                        "--save-model", os.path.join(run_dir, f"6d_{name}.pt")]

    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    save = checkpoint.save_resume_state

    def save_then_stop(*args):
        save(*args)
        raise _Stopped

    try:
        whole, _, secs_det = _run_3dident("6d uninterrupted", resume_argv("whole"))
        checkpoint.save_resume_state = save_then_stop
        try:
            main_3dident.main(_RUN3D + resume_argv("cut"), device="cuda")
            raise AssertionError("6d: the run was not stopped")
        except _Stopped:
            pass
        finally:
            checkpoint.save_resume_state = save
        resumed, _, _ = _run_3dident("6d resumed",
                                     resume_argv("cut") + ["--resume"])
    finally:
        torch.backends.cudnn.deterministic = was
    same = sum(a == b for a, b in zip(resumed["losses"], whole["losses"]))
    print(f"[6 3dident] 6d: {same} of {len(whole['losses'])} losses equal the "
          f"uninterrupted run's after the resume from step 3")
    if len(whole["losses"]) != 6 or resumed["losses"] != whole["losses"]:
        raise AssertionError(f"6d: resumed {resumed['losses']} vs {whole['losses']}")
    return {k: grew_a[k] + grew_b[k] for k in COUNTERS}


def _stem_bounds(shape, dtype) -> dict:
    """The least ms for the stem's kernels at this shape: bytes over the
    memory rate (forward: x read, a quarter of it written; backward: x and
    g read, dy written; dx: x and dy read, dx written) against operations
    over the float32 rate (forward: per input element a multiply and an
    add, and 9/4 comparisons; backward: nine window recomputes of three
    operations per input element, plus the mask and the two sums; dx: five
    operations per element). "stem_bwd+dx" is the whole backward, the
    function from (x, g) to dx: dx needs the channel sums of the whole
    batch, so x and g are read once for the sums and once more for dx,
    which is written, 3.5 x elements x size; dy need not reach memory, so
    its round trip between the two kernels is not counted."""
    n, h, w, c = shape
    elems = n * h * w * c
    size = 2 if dtype == torch.bfloat16 else 4
    out = {}
    for k, nbytes, ops in (("stem_fwd", elems * size * 1.25, elems * 4.25),
                           ("stem_bwd", elems * size * 2.25, elems * 32),
                           ("stem_dx", elems * size * 3, elems * 5),
                           ("stem_bwd+dx", elems * size * 3.5, elems * 37)):
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_FLOPS
        out[k] = (1e3 * max(t_bytes, t_ops),
                  "bytes" if t_bytes >= t_ops else "operations")
    return out


def _library_stem(x_nchw, scale, bias):
    """PyTorch's own calls for the same function (training-mode batch norm,
    relu, max pool); timed here and used nowhere in the port."""
    return F.max_pool2d(F.relu(F.batch_norm(x_nchw, None, None, scale, bias,
                                            True, 0.1, 1e-5)), 3, 2, 1)


STEM_TIMED = ("fwd", "bwd", "dx", "bwd+dx", "fn fwd", "fn fwd+bwd")


def _time_stem(dtype, smi: str) -> dict:
    """ms at STEM_FULL: the three kernels alone and the whole backward
    (stem_bwd, then stem_dx on its sums) against their plain versions; the
    whole function (statistics, kernels, dx) forward and forward+backward
    on the kernel route, the plain route and through PyTorch's own calls;
    and the three tensor passes that formed dx before stem_dx. PyTorch's
    call for dx alone is torch.batch_norm_backward_elemt, SyncBatchNorm's,
    on the same dy and channel sums (channels_last views of x and dy); it
    is held to the kernel's dx first, so that it is known to compute the
    same function."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    x, scale, bias, g = _stem_inputs(STEM_FULL, dtype, gen)
    a, b, mean, rstd = _fold(x, scale, bias)
    dy, sb, sg = stem.stem_bwd_reference(x, g, a, b, mean, rstd)
    factors = _dx_factors(x, scale, mean, rstd, sb, sg)
    x_nchw, g_nchw = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    lib_dx_args = (dy.permute(0, 3, 1, 2), x_nchw, mean, rstd, scale, sb,
                   sg / rstd,  # Σdy·(x − mean)
                   torch.tensor([x.numel() // x.shape[3]], device="cuda",
                                dtype=torch.int32))
    lib_dx = torch.batch_norm_backward_elemt(*lib_dx_args).permute(0, 2, 3, 1)
    plain_dx = stem.stem_dx_reference(x, dy, *factors, mean)
    lib_err = (lib_dx.float() - plain_dx.float()).abs().max().item()
    # a loose bar, there to catch another function, not to rank roundings:
    # a thousandth of the largest |dx| in float32, two bfloat16 ulps of it
    lib_bar = (2.0**-7 if dtype == torch.bfloat16 else 1e-3) \
        * plain_dx.float().abs().max().item()
    del lib_dx, plain_dx
    sc = scale.clone().requires_grad_()
    bi = bias.clone().requires_grad_()
    reps = 9

    def fwd_bwd(fn, xin, gin):
        xs = xin.detach().requires_grad_()
        out = fn(xs, sc, bi)
        (out[0] if isinstance(out, tuple) else out).backward(gin)

    def lib_bwd_only():
        xs = x_nchw.detach().requires_grad_()
        out = _library_stem(xs, sc, bi)
        return lambda: torch.autograd.grad(out, (xs, sc, bi), g_nchw,
                                           retain_graph=True)

    def whole_bwd(bwd, dx):
        def run():
            d, s1, s2 = bwd(x, g, a, b, mean, rstd)
            return dx(x, d, *_dx_factors(x, scale, mean, rstd, s1, s2), mean)
        return run

    lib_bwd = lib_bwd_only()
    cases = {
        "kernel": {
            "fwd": lambda: stem.launch_stem_fwd(x, a, b),
            "bwd": lambda: stem.launch_stem_bwd(x, g, a, b, mean, rstd),
            "dx": lambda: stem.launch_stem_dx(x, dy, *factors, mean),
            "bwd+dx": whole_bwd(stem.launch_stem_bwd, stem.launch_stem_dx),
            "fn fwd": lambda: stem.bn_relu_pool_train(x, scale, bias),
            "fn fwd+bwd": lambda: fwd_bwd(stem.bn_relu_pool_train, x, g)},
        "plain": {
            "fwd": lambda: stem.stem_fwd_reference(x, a, b),
            "bwd": lambda: stem.stem_bwd_reference(x, g, a, b, mean, rstd),
            "dx": lambda: stem.stem_dx_reference(x, dy, *factors, mean),
            "bwd+dx": whole_bwd(stem.stem_bwd_reference, stem.stem_dx_reference),
            "fn fwd": lambda: stem.bn_relu_pool_reference(x, scale, bias),
            "fn fwd+bwd": lambda: fwd_bwd(stem.bn_relu_pool_reference, x, g)},
        "library": {
            "fwd": lambda: _library_stem(x_nchw, scale, bias),
            "bwd": lib_bwd,
            "dx": lambda: torch.batch_norm_backward_elemt(*lib_dx_args),
            "bwd+dx": lib_bwd,
            "fn fwd": lambda: _library_stem(x_nchw, scale, bias),
            "fn fwd+bwd": lambda: fwd_bwd(_library_stem, x_nchw, g_nchw)},
        "three passes": {
            "dx": lambda: _three_pass_dx(x, dy, *factors, mean)},
    }
    # in turns: plain, library, kernel, three passes, three passes, kernel,
    # library, plain
    order = ("plain", "library", "kernel", "three passes")
    turns = [(who, {k: _median_ms(f, reps=reps, warmup=2)
                    for k, f in cases[who].items()})
             for who in order + order[::-1]]
    out = {}
    for who, t in turns:
        out[who] = {k: min(v, out.get(who, {}).get(k, v)) for k, v in t.items()}
    for who in order:
        out[who] = {k: out[who].get(k) for k in STEM_TIMED}
    name = str(dtype).removeprefix("torch.")
    ms = lambda v: "-" if v is None else f"{v:.3f}"
    _say_time(f"[7 times] stem {STEM_FULL} {name} ms (kernel / plain / library), "
              f"median of {reps} after warm-up, better of two turns, on {smi}: "
              + "; ".join(f"{k} {ms(out['kernel'][k])} / {ms(out['plain'][k])} / "
                          f"{ms(out['library'][k])}" for k in STEM_TIMED))
    _say_time(f"[7 times]   dx as three tensor passes (before stem_dx) "
              f"{ms(out['three passes']['dx'])} ms; library bwd = library "
              "bwd+dx, PyTorch's autograd of the library forward, which includes "
              "the norm's backward; library fwd = fn fwd (F.batch_norm takes the "
              "statistics itself); library dx = torch.batch_norm_backward_elemt "
              f"on the same dy and sums, {lib_err:.3g} from the plain dx at most "
              f"(bar {lib_bar:.3g})")
    if not lib_err <= lib_bar:
        raise AssertionError(f"7 times: batch_norm_backward_elemt is {lib_err} "
                             f"from the plain dx (bar {lib_bar}): not the same "
                             "function")
    for k, (t, by) in _stem_bounds(STEM_FULL, dtype).items():
        _say_time(f"[7 times] bound {k} {name}: {t:.3f} ms, set by {by} "
                  f"(3.35 TB/s, 67 TFLOP/s fp32)")
    return out


def _bn_bounds(shape, dtype) -> dict:
    """The least ms for the bn kernels at this shape in bn_relu's mode (the
    stem's norm): bytes over the memory rate (stats: x read; apply: x read,
    y written; bwd: x and dy read; dx: x and dy read, dx written) against
    operations over the float32 rate (stats 3, apply 3, bwd 5, dx 6 per
    element)."""
    elems = math.prod(shape)
    size = 2 if dtype == torch.bfloat16 else 4
    out = {}
    for k, passes, ops in (("bn_stats", 1, 3), ("bn_apply", 2, 3),
                           ("bn_bwd", 2, 5), ("bn_dx", 3, 6)):
        t_bytes = elems * size * passes / PEAK_BYTES_PER_S
        t_ops = elems * ops / PEAK_FP32_FLOPS
        out[k] = (1e3 * max(t_bytes, t_ops),
                  "bytes" if t_bytes >= t_ops else "operations")
    return out


BN_TIMED = ("stats", "apply", "bwd", "dx")


def _time_bn(dtype, smi: str) -> dict:
    """ms of the four bn kernels at STEM_FULL in bn_relu's mode against
    their plain versions and PyTorch's own calls (SyncBatchNorm's:
    torch.batch_norm_stats, batch_norm_elemt, batch_norm_backward_reduce
    and batch_norm_backward_elemt on channels_last views), in turns. The
    library calls have no relu: each is held first to the plain version of
    bn_only, the same function, at a loose bar (a thousandth of the largest
    value in float32, four bfloat16 ulps of it: the plain version rounds a
    and b to bfloat16 first), and used nowhere in the port."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    x, _, dy, scale, bias = _bn_inputs(STEM_FULL, dtype, gen)
    mean, _, rstd = bn_minres.channel_stats(x, EPS)
    a, b = bn_minres.affine(scale, bias, mean, rstd, dtype)
    count = x.numel() // x.shape[-1]
    _, _, k = bn_minres.dx_factors(
        scale, mean, rstd, *bn_minres.bn_bwd_reference(x, dy, a, b)[:2], count,
        dtype)
    # bn_only's sums and dx: what the library's backward calls compute
    s_dy, s_dyx, _ = bn_minres.bn_bwd_reference(x, dy, a, b, relu=False)
    _, _, k_only = bn_minres.dx_factors(scale, mean, rstd, s_dy, s_dyx, count, dtype)
    x4, dy4 = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    s_dyxmu = s_dyx - mean * s_dy  # Σdy·(x − mean)
    count_t = torch.tensor([count], device="cuda", dtype=torch.int32)
    library = {
        "stats": lambda: torch.batch_norm_stats(x4, EPS),
        "apply": lambda: torch.batch_norm_elemt(x4, scale, bias, mean, rstd, EPS),
        "bwd": lambda: torch.batch_norm_backward_reduce(dy4, x4, mean, rstd, scale,
                                                        True, True, True),
        "dx": lambda: torch.batch_norm_backward_elemt(dy4, x4, mean, rstd, scale,
                                                      s_dy, s_dyxmu, count_t),
    }
    wants = {
        "stats": lambda out: ((out[0], mean), (out[1], rstd)),
        "apply": lambda out: ((out.permute(0, 2, 3, 1),
                               bn_minres.bn_apply_reference(x, a, b, relu=False)),),
        "bwd": lambda out: ((out[0], s_dy), (out[1], s_dyxmu)),
        "dx": lambda out: ((out.permute(0, 2, 3, 1), bn_minres.bn_dx_reference(
            x, dy, k_only, a, b, relu=False)),),
    }
    loose = 2.0 ** -5 if dtype == torch.bfloat16 else 1e-3
    held = {}
    for key in BN_TIMED:
        pairs = wants[key](library[key]())
        held[key] = max(float((p.float() - q.float()).abs().max())
                        / float(q.float().abs().max()) for p, q in pairs)
        if not held[key] <= loose:
            raise AssertionError(f"7 times: the library's {key} is {held[key]} "
                                 f"from bn_only's plain version: not the same "
                                 "function")
        del pairs
    cases = {
        "kernel": {
            "stats": lambda: bn_minres.launch_stats(x, EPS),
            "apply": lambda: bn_minres.launch_apply(x, a, b),
            "bwd": lambda: bn_minres.launch_bwd(x, dy, a, b),
            "dx": lambda: bn_minres.launch_dx(x, dy, k, a, b)},
        "plain": {
            "stats": lambda: bn_minres.channel_stats(x, EPS),
            "apply": lambda: bn_minres.bn_apply_reference(x, a, b),
            "bwd": lambda: bn_minres.bn_bwd_reference(x, dy, a, b),
            "dx": lambda: bn_minres.bn_dx_reference(x, dy, k, a, b)},
        "library": library,
    }
    order = ("plain", "library", "kernel")
    out = {}
    for who in order + order[::-1]:
        t = {key: _median_ms(f, reps=9, warmup=2) for key, f in cases[who].items()}
        out[who] = {key: min(v, out.get(who, {}).get(key, v)) for key, v in t.items()}
    for who in order:
        out[who] = {key: out[who].get(key) for key in BN_TIMED}
    name = str(dtype).removeprefix("torch.")
    ms = lambda v: "-" if v is None else f"{v:.3f}"
    _say_time(f"[7 times] bn kernels {STEM_FULL} {name}, bn_relu's mode, ms "
              f"(kernel / plain / library), median of 9 after warm-up, better "
              f"of two turns, on {smi}: "
              + "; ".join(f"{key} {ms(out['kernel'][key])} / {ms(out['plain'][key])}"
                          f" / {ms(out['library'][key])}" for key in BN_TIMED)
              + "; the library's calls (no relu) from bn_only's plain version: "
              + ", ".join(f"{key} {v:.2e}" for key, v in held.items()))
    for key, (t, by) in _bn_bounds(STEM_FULL, dtype).items():
        _say_time(f"[7 times] bound {key} {name}: {t:.3f} ms, set by {by} "
                  f"(3.35 TB/s, 67 TFLOP/s fp32)")
    return out


# main_3dident's norm paths timed in phase 7: the default (minres norms),
# the plain norm under autograd, and the fused stem with the plain norm
NORM_PATHS = {"minres": (), "fast": ("--norm-kind", "fast"),
              "fused": ("--fused-stem",)}


def _step3d_pairs_per_sec(sampler, flags: tuple, bf16: bool, stem_pool: str = "xla"
                          ) -> tuple[float, float]:
    """(pairs/s, peak GiB) of steady unsupervised steps of main_3dident's
    default configuration (ResNet18, B = 512, everything on the card) with
    ``flags`` (and the backbone's ``stem_pool``): main_3dident's own
    ``train_step`` on its own model and loss."""
    argv = _RUN3D + ["--mode", "unsupervised", *flags] + (["--bf16"] if bf16 else [])
    args = main_3dident.parse_args(argv)
    _, n_non_ang, n_ang = main_3dident.setup_latent_space(args)
    model = main_3dident.build_encoder(
        args, n_non_ang + n_ang, n_non_ang,
        torch.Generator().manual_seed(0), stem_pool=stem_pool).cuda().train()
    loss = main_3dident.build_split_loss(args, n_non_ang)
    opt, _ = make_optimizer(model.parameters(), args.lr)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def step():
        main_3dident.train_step(model, loss, opt, None, sampler, gen)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    pps = n * args.batch_size / (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model, opt
    torch.cuda.empty_cache()
    return pps, peak


def phase_times_3dident(smi: str) -> tuple[dict, dict]:
    times = {dtype: _time_stem(dtype, smi)
             for dtype in (torch.float32, torch.bfloat16)}
    torch.cuda.empty_cache()
    times_bn = {dtype: _time_bn(dtype, smi)
                for dtype in (torch.float32, torch.bfloat16)}
    torch.cuda.empty_cache()
    args = main_3dident.parse_args(_RUN3D + ["--mode", "unsupervised"])
    latent_space, _, _ = main_3dident.setup_latent_space(args)
    sampler = ThreeDIdentBatchSampler(FIXTURE, latent_space, 512, device="cuda")
    turns = ("minres", "fast", "fused", "fused", "fast", "minres")
    for bf16 in (False, True):
        runs = [_step3d_pairs_per_sec(sampler, NORM_PATHS[k], bf16) for k in turns]
        _say_time(f"[7 times] 3DIdent step, ResNet18 B=512 (1024 images of "
                  f"224x224) {'--bf16' if bf16 else 'float32, TF32 off'}, 10 "
                  f"steady steps, pairs/s (peak GiB) in turns "
                  + ", ".join(f"{k} {p:.1f} ({m:.3f})" for k, (p, m) in zip(turns, runs))
                  + f" on {smi}")
    # what 6d's determinism costs: the fused float32 step once more with
    # cuDNN held to its deterministic algorithms
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        pps, _ = _step3d_pairs_per_sec(sampler, NORM_PATHS["fused"], False)
    finally:
        torch.backends.cudnn.deterministic = was
    _say_time(f"[7 times] the same fused float32 step with "
              f"cudnn.deterministic: {pps:.0f} pairs/s on {smi}")
    return times, times_bn


# ---------------------------------------------------------------------------
# the KITTI Masks experiment
# ---------------------------------------------------------------------------

KITTI_DIR = os.path.join(OUT_DIR, "kitti")
KITTI_CORPUS = os.path.join(KITTI_DIR, "corpus")
KITTI_PAIRS, KITTI_Z = 32, 10  # batch 64 = 32 pairs; z_dim
_RUNK = ["--dset-dir", KITTI_CORPUS, "--batch-size", "64", "--z-dim", "10",
         "--p", "1", "--lr", "1e-4", "--seed", "0"]
# The JAX package's record at 2k steps, 0.953, is of --augment
# (EXPERIMENTS.md:470-484); without it the record is 0.934 at 5k steps.
KITTI_MCC_BAR = 0.90
KITTI_MCC_BAR_DEFAULT = 0.85


def phase_kitti_corpus() -> None:
    shutil.rmtree(KITTI_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    make_synthetic_kitti.main(["--output-dir", KITTI_CORPUS, "--n-sequences",
                               "150", "--frames", "30", "--seed", "0"])
    sampler = kitti.KittiDeviceSampler(kitti.KittiMasks(KITTI_CORPUS, max_delta_t=1),
                                       "cuda")
    print(f"[8 kitti] corpus: 150 sequences x 30 frames, {sampler.n_pairs} pairs, "
          f"{sampler.nbytes} bytes on the card, written and loaded in "
          f"{time.perf_counter() - t0:.1f} s")


def _kitti_args(tag: str, *extra, seed: int = 0):
    """main_kitti's parsed args for a Solver driven directly (no evaluation),
    with its own output and checkpoint folders under runs/chip_smoke/kitti."""
    args = main_kitti.build_parser().parse_args(_RUNK + list(extra))
    args.seed, args.num_channel = seed, 1
    args.output_dir = os.path.join(KITTI_DIR, tag, "out", str(seed))
    args.ckpt_dir = os.path.join(KITTI_DIR, tag, "ck", str(seed))
    for d in (args.output_dir, args.ckpt_dir):
        os.makedirs(d, exist_ok=True)
    return args


def _kitti_outcome(args, net) -> tuple[list, list]:
    with open(os.path.join(args.output_dir, "log.csv")) as fh:
        rows = fh.read().splitlines()
    return rows, [p.detach().clone() for p in net.parameters()]


def _same(a: tuple, b: tuple) -> bool:
    return a[0] == b[0] and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


def _kitti_8a(tag: str, extra: tuple, bar: float) -> dict:
    """main_kitti.main for 2,000 steps and its evaluation, the counters set
    to 0 just before and read just after."""
    out = os.path.join(KITTI_DIR, tag)
    infonce.reset_launch_counts()
    t0 = time.perf_counter()
    main_kitti.main(_RUNK + list(extra) + [
        "--max-iter", "2000", "--log-step", "100", "--output-dir",
        os.path.join(out, "out"), "--ckpt-dir", os.path.join(out, "ck")], device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    grew = infonce.launch_counts()
    run = os.path.join(out, "out", "kittimasks_1", "1_0", "0")
    with open(os.path.join(run, "log.csv")) as fh:
        rows = [float(v) for v in fh.read().splitlines()[1:]]
    with open(os.path.join(run, "evaluation", "last", "mean", "mcc",
                           "evaluation_results.json")) as fh:
        mcc = json.load(fh)["meanabscorr"]
    print(f"[8 kitti] {tag} main_kitti {' '.join(extra + ('--max-iter 2000',))} + evaluation: "
          f"{secs:.1f} s; launches {grew}; loss (mean of 100) {rows[0]:.5f} -> "
          f"{rows[-1]:.5f}; MCC {mcc:.4f} (bar {bar})")
    want = {k: 2000 if k in LP else 0 for k in grew}
    if grew != want:
        raise AssertionError(f"{tag}: launches {grew}, expected {want}")
    if len(rows) != 20 or not all(math.isfinite(v) for v in rows):
        raise AssertionError(f"{tag}: log.csv {rows}")
    if not rows[-1] < rows[0]:
        raise AssertionError(f"{tag}: loss did not fall ({rows[0]} -> {rows[-1]})")
    if not mcc >= bar:
        raise AssertionError(f"{tag}: MCC {mcc} below {bar}")
    return grew


def _hold_kitti_shape(ds, worst: dict) -> None:
    """fused_neg_lse's three kernels at main_kitti's shape (M = N = 32, n =
    10, p = 1, tau = 1, z3 = roll(z1, 1)) against the plain version: on
    rolled N(0, 0.5^2) rows, and on the codes a ConvEncoder64 gives a batch
    of the corpus."""
    rng = np.random.default_rng(8)
    fused = lambda a, b: infonce.fused_neg_lse(a, b, 1.0, 1.0)
    plain = lambda a, b: infonce.neg_lse_reference(a, b, 1.0, 1.0)
    net = ConvEncoder64(z_dim=KITTI_Z, nc=1,
                        generator=torch.Generator().manual_seed(0)).cuda()
    x1, x2 = kitti_solver.sample_inputs(
        kitti.KittiDeviceSampler(ds, "cuda"),
        torch.Generator(device="cuda").manual_seed(0), KITTI_PAIRS, False)
    with torch.no_grad():
        codes = kitti_solver.encode_pairs(net, x1, x2)[0].cpu().numpy()
    for kind, (z1, z3) in (("rolled rows", _pair(KITTI_PAIRS, KITTI_PAIRS, rng, KITTI_Z)),
                           ("encoder codes", (codes, np.roll(codes, 1, axis=0)))):
        ct = _cotangent(KITTI_PAIRS, rng)
        _hold(f"neg_lse p=1 tau=1 n={KITTI_Z} M=N={KITTI_PAIRS} (KITTI, {kind})", LP,
              _value_and_grads(fused, z1, z3, ct), _value_and_grads(plain, z1, z3, ct),
              worst)


def _kitti_repeats(ds) -> None:
    """8b: 600 steps against a run stopped at its step-300 checkpoint and
    resumed; 8c: two lanes against serial seeds 0 and 1. Bit for bit, under
    cuDNN's deterministic algorithms (the port's kernels have no atomics)."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    save = kitti_solver.EnsembleSolver.save_checkpoint

    def save_then_stop(self, filename):
        save(self, filename)
        raise _Stopped

    try:
        extra = ("--max-iter", "600", "--log-step", "100", "--save-step", "300")
        whole = _kitti_args("8b_whole", *extra)
        solver = kitti_solver.Solver(whole, ds, "cuda")
        solver.train()
        want = _kitti_outcome(whole, solver.net)
        cut = _kitti_args("8b_cut", *extra)
        kitti_solver.EnsembleSolver.save_checkpoint = save_then_stop
        try:
            kitti_solver.Solver(cut, ds, "cuda").train()
            raise AssertionError("8b: the run was not stopped")
        except _Stopped:
            pass
        finally:
            kitti_solver.EnsembleSolver.save_checkpoint = save
        cut.resume = True
        resumed = kitti_solver.Solver(cut, ds, "cuda")
        stopped_at = resumed.global_iter
        resumed.train()
        got = _kitti_outcome(cut, resumed.net)
        print(f"[8 kitti] 8b resume: stopped at step {stopped_at}, resumed to "
              f"600; log rows {'equal' if got[0] == want[0] else 'DIFFER'} "
              f"({len(want[0]) - 1}), parameters "
              f"{'bit-equal' if _same(got, want) else 'DIFFER'}")
        if stopped_at != 300 or len(want[0]) != 7 or not _same(got, want):
            raise AssertionError("8b: the resumed run differs")

        extra = ("--max-iter", "200", "--log-step", "50")
        lanes = [_kitti_args("8c_lanes", *extra, seed=s) for s in (0, 1)]
        ensemble = kitti_solver.EnsembleSolver(
            lanes[0], ds, [0, 1], [a.output_dir for a in lanes],
            [a.ckpt_dir for a in lanes], "cuda")
        ensemble.train()
        for i, seed in enumerate((0, 1)):
            serial_args = _kitti_args("8c_serial", *extra, seed=seed)
            serial = kitti_solver.Solver(serial_args, ds, "cuda")
            serial.train()
            same = _same(_kitti_outcome(lanes[i], ensemble.lanes[i].net),
                         _kitti_outcome(serial_args, serial.net))
            print(f"[8 kitti] 8c lane {i} (seed {seed}) against the serial run: "
                  f"log rows and parameters {'bit-equal' if same else 'DIFFER'}")
            if not same:
                raise AssertionError(f"8c: lane {i} differs from serial seed {seed}")
    finally:
        torch.backends.cudnn.deterministic = was


def _kitti_augment(root_ds) -> None:
    """8d: --augment for 200 steps with finite losses; both warps on the
    card against their CPU results for the same drawn parameters."""
    args = _kitti_args("8d", "--max-iter", "200", "--log-step", "50", "--augment")
    ds = kitti.return_data(args)[0]
    kitti_solver.Solver(args, ds, "cuda").train()
    with open(os.path.join(args.output_dir, "log.csv")) as fh:
        rows = [float(v) for v in fh.read().splitlines()[1:]]
    x1, x2, _, _ = root_ds.sample_pair_batch(256, np.random.default_rng(0))
    x1, x2 = torch.from_numpy(x1), torch.from_numpy(x2)
    agree = {}
    for name, draw, warp in (("fast", kitti.draw_shift, kitti.warp_shift),
                             ("exact", kitti.draw_affine, kitti.warp_affine)):
        params = draw(torch.Generator().manual_seed(0), 256)
        host = warp(x1, x2, *params)
        card = warp(x1.cuda(), x2.cuda(), *(p.cuda() for p in params))
        agree[name] = all(torch.equal(h, c.cpu()) for h, c in zip(host, card))
    print(f"[8 kitti] 8d --augment 200 steps: loss {rows}; warps on the card "
          f"against the CPU at 256 pairs: {agree}")
    if len(rows) != 4 or not all(math.isfinite(v) for v in rows):
        raise AssertionError(f"8d: log.csv {rows}")
    if not all(agree.values()):
        raise AssertionError(f"8d: a warp on the card differs from the CPU: {agree}")


def _kitti_unfused() -> None:
    """8e: 8a's configuration for 20 steps, each logged, fused against
    --no-fused-loss, the counters read around each run."""
    losses, grew = {}, {}
    for tag, extra in (("fused", ()), ("unfused", ("--no-fused-loss",))):
        args = _kitti_args(f"8e_{tag}", "--max-iter", "20", "--log-step", "1", *extra)
        infonce.reset_launch_counts()
        kitti_solver.Solver(args, kitti.return_data(args)[0], "cuda").train()
        torch.cuda.synchronize()
        grew[tag] = infonce.launch_counts()
        with open(os.path.join(args.output_dir, "log.csv")) as fh:
            losses[tag] = [float(v) for v in fh.read().splitlines()[1:]]
    rel = [abs(u - f) / abs(f) for f, u in zip(losses["fused"], losses["unfused"])]
    print(f"[8 kitti] 8e --no-fused-loss: launches {grew['unfused']} (fused run "
          f"{grew['fused']}); |loss - fused| / |fused| per step: "
          + " ".join(f"{r:.1e}" for r in rel))
    if any(grew["unfused"][k] for k in LP + DOT) or any(
            grew["fused"][k] != 20 for k in LP):
        raise AssertionError(f"8e: launches {grew}")
    if len(rel) != 20 or rel[0] > 1e-5 or max(rel[:3]) > 1e-3:
        raise AssertionError(f"8e: the first losses differ from the fused run's: {rel[:3]}")


def _kitti_step_rate(ds, smi: str) -> tuple[float, float, float]:
    """The steady KITTI step, fused and unfused loss, in alternating turns
    of 200 steps (fused, unfused, unfused, fused, fused, unfused):
    pairs/s of each turn's wall time (device-synchronised) and device ms
    a step between two CUDA events; the medians of each."""
    lanes = {}
    for tag, extra in (("fused", ()), ("unfused", ("--no-fused-loss",))):
        args = _kitti_args(f"times_{tag}", *extra)
        lanes[tag] = kitti_solver.Solver(args, ds, "cuda")
    turns = {"fused": [], "unfused": []}
    n = 200
    for tag in ("fused", "unfused", "unfused", "fused", "fused", "unfused"):
        solver = lanes[tag]
        lane = solver.lanes[0]
        for _ in range(5):
            lane.step(KITTI_PAIRS, False, solver.sampler)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            lane.step(KITTI_PAIRS, False, solver.sampler)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        turns[tag].append((n * KITTI_PAIRS / wall, start.elapsed_time(end) / n))
    out = {}
    for tag, runs in turns.items():
        out[tag] = (statistics.median(r[0] for r in runs),
                    statistics.median(r[1] for r in runs))
        _say_time(f"[8 times] KITTI step, ConvEncoder64 B=64 (32 pairs) z=10 "
                  f"p=1, {tag} loss, turns of {n} steps: pairs/s "
                  + ", ".join(f"{r[0]:.0f}" for r in runs)
                  + "; device ms a step (CUDA events) "
                  + ", ".join(f"{r[1]:.4f}" for r in runs)
                  + f"; medians {out[tag][0]:.0f} pairs/s, {out[tag][1]:.4f} ms, "
                  f"on {smi}")
    return out


def phase_kitti(smi: str, worst: dict) -> tuple[dict, dict]:
    """(launches of 8a, {label: (kernel, plain, library)} at the KITTI shape)."""
    phase_kitti_corpus()
    ds = kitti.KittiMasks(KITTI_CORPUS, max_delta_t=1)
    _hold_kitti_shape(ds, worst)
    grew = _kitti_8a("8a", (), KITTI_MCC_BAR_DEFAULT)
    _kitti_8a("8a_augment", ("--augment",), KITTI_MCC_BAR)
    _kitti_repeats(ds)
    _kitti_augment(ds)
    _kitti_unfused()
    _kitti_step_rate(ds, smi)
    kernel, plain, library = _loss_cases(1.0, 1.0)
    turns = [_time_loss(f, KITTI_PAIRS, KITTI_Z)
             for f in (plain, library, kernel, kernel, library, plain)]
    best = lambda x, y: {k: min(x[k], y[k]) for k in x}
    times = (best(turns[2], turns[3]), best(turns[0], turns[5]),
             best(turns[1], turns[4]))
    kern, pl, lib = times
    _say_time(f"[8 times] p=1 kitti M=N={KITTI_PAIRS} n={KITTI_Z} tau=1 device ms "
              f"(kernel / plain / library), CUDA graph of 10 calls, median of 15 "
              f"replays, better of two turns, on {smi}: "
              + "; ".join(f"{k} {kern[k]:.4f} / {pl[k]:.4f} / {lib[k]:.4f}"
                          for k in kern))
    for k, (ms, by) in _bounds(KITTI_PAIRS, KITTI_PAIRS, KITTI_Z).items():
        _say_time(f"[8 times] bound {k} at M=N={KITTI_PAIRS} n={KITTI_Z}: "
                  f"{ms:.3e} ms, set by {by} (67 TFLOP/s fp32, 3.35 TB/s)")
    return grew, times


# ---------------------------------------------------------------------------
# the captured step
# ---------------------------------------------------------------------------


def _mlp_capture_lane(config: str):
    """A main_mlp lane at seed 0 in its unsupervised phase: (its
    CapturedStep, its parameters)."""
    args = main_mlp.parse_args(CONFIGS[config])
    dev = torch.device("cuda")
    lane = main_mlp.Lane(args, 0, dev, main_mlp.build_latent_space(args, dev),
                         main_mlp.make_loss(args))
    lane.start_phase(False, args.n_steps)
    return lane.step, lambda: list(lane.f.parameters())


def _kitti_capture_lane(*extra):
    args = _kitti_args("9_capture", *extra)
    solver = kitti_solver.Solver(args, kitti.return_data(args)[0], "cuda")
    return solver.steps[0], lambda: list(solver.net.parameters())


def _3dident_capture_lane(sampler, *extra):
    """main_3dident --scan's step (with ``extra`` flags) on its own model,
    loss, optimizer and generator at seed 0, as the driver builds them."""
    args = main_3dident.parse_args(_RUN3D + ["--mode", "unsupervised", "--scan",
                                             *extra])
    _, n_non_ang, n_ang = main_3dident.setup_latent_space(args)
    model = main_3dident.build_encoder(
        args, n_non_ang + n_ang, n_non_ang,
        torch.Generator().manual_seed(0)).cuda().train()
    loss = main_3dident.build_split_loss(args, n_non_ang)
    opt, sched = make_optimizer(
        model.parameters(), args.lr, args.weight_decay,
        cosine_steps=args.iterations if args.lr_cosine else None,
        kind=args.optimizer)
    gen = torch.Generator(device="cuda").manual_seed(0)
    step = CapturedStep(
        lambda: main_3dident.train_step(model, loss, opt, sched, sampler, gen),
        [gen], "cuda")
    return step, lambda: list(model.parameters()) + list(model.buffers())


def _eager(step: CapturedStep) -> torch.Tensor:
    """One eager call of a captured step's body, stacked as a replay is."""
    return torch.stack([t.float() for t in step.body()])


def _hold_capture(tag: str, make, per_step: dict, replays: int,
                  label: str = "[9 capture]") -> None:
    """Two lanes from one seed: WARMUP_STEPS + replays eager steps on one,
    the warm-up, the capture and ``replays`` replays on the other, held bit
    for bit (every loss output and every parameter and buffer). The
    replays after the capture run under sync debug mode "error"; the
    samplers' fallbacks are counted over both lanes' steps; ``per_step``
    is each counter's launches in one step (others 0)."""
    reset_fallback_counts()
    eager_step, eager_params = make()
    cap_step, cap_params = make()
    n = WARMUP_STEPS + replays
    want = torch.stack([_eager(eager_step) for _ in range(n)])
    got = [cap_step() for _ in range(WARMUP_STEPS + 1)]  # the capture is in the last
    infonce.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got += [cap_step() for _ in range(replays - 1)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    grew = infonce.launch_counts()
    got = torch.stack(got)
    fallbacks = int(fallback_count("cuda"))
    same_out = torch.equal(got, want)
    pairs = list(zip(cap_params(), eager_params()))
    same_params = sum(torch.equal(a, b) for a, b in pairs)
    worst = max(float((a.detach().double() - b.detach().double()).abs().max())
                for a, b in pairs)
    per_step = {k: per_step.get(k, 0) for k in grew}
    print(f"{label} {tag}: {n} steps, eager vs warm-up + capture + "
          f"{replays} replays: outputs {'bit-equal' if same_out else 'DIFFER'} "
          f"(max |diff| {float((got - want).abs().max()):.3e}); "
          f"{same_params} of {len(pairs)} parameter and buffer tensors "
          f"bit-equal (max |diff| {worst:.3e}); launches a replay "
          f"{cap_step.per_replay}; over {replays - 1} replays under sync debug "
          f"mode 'error' {grew}; sampler fallbacks {fallbacks}")
    if not cap_step.captured or cap_step.per_replay != per_step:
        raise AssertionError(f"{label} {tag}: launches a replay {cap_step.per_replay}, "
                             f"expected {per_step}")
    if grew != {k: (replays - 1) * v for k, v in per_step.items()}:
        raise AssertionError(f"{label} {tag}: launches {grew} over {replays - 1} replays")
    if fallbacks:
        raise AssertionError(f"{label} {tag}: {fallbacks} sampler fallbacks")
    if not same_out or same_params != len(pairs):
        raise AssertionError(f"{label} {tag}: the captured steps differ from the eager ones")


def _capture_rate(tag: str, make, pairs: int, steps: int, smi: str,
                  label: str = "[9 times]") -> None:
    """pairs/s (device-synchronised wall time) and device ms a step between
    two CUDA events, eager and captured in turns (eager, captured,
    captured, eager), on two fresh lanes warmed up (and captured) under the
    drivers' own cuDNN settings, each going on from where it stood."""
    eager_step, cap_step = make(), make()
    eager_step, cap_step = eager_step[0], cap_step[0]
    for _ in range(WARMUP_STEPS + 1):
        _eager(eager_step)
        cap_step()
    runs = {"eager": [], "captured": []}
    torch.cuda.reset_peak_memory_stats()
    for kind in ("eager", "captured", "captured", "eager"):
        fn = (lambda: _eager(eager_step)) if kind == "eager" else cap_step
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(steps):
            fn()
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[kind].append((steps * pairs / wall, start.elapsed_time(end) / steps))
    _say_time(f"{label} {tag}, turns of {steps} steps (eager, captured, "
              f"captured, eager): "
              + "; ".join(f"{k} pairs/s " + ", ".join(f"{r[0]:.0f}" for r in v)
                          + " device ms a step " + ", ".join(f"{r[1]:.4f}" for r in v)
                          for k, v in runs.items())
              + f"; peak memory of both lanes "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; on {smi}")


def phase_capture(smi: str) -> None:
    """Phase 9: the captured step of each driver against its eager step,
    then their speeds."""
    t0 = time.perf_counter()
    cases = [(f"main_mlp {config} p={main_mlp.parse_args(CONFIGS[config]).p} "
              f"B={BATCH}", functools.partial(_mlp_capture_lane, config),
              dict.fromkeys(path, 1), 20, BATCH, 50)
             for config, path in (("sphere", LP), ("simclr", DOT))]
    if not os.path.exists(os.path.join(KITTI_CORPUS, kitti.FNAME)):
        phase_kitti_corpus()
    cases += [(f"main_kitti {' '.join(extra) or 'default'} B=64",
               functools.partial(_kitti_capture_lane, *extra),
               dict.fromkeys(LP, 1), 20, KITTI_PAIRS, 200)
              for extra in ((), ("--augment",))]
    if not os.path.exists(os.path.join(FIXTURE, "raw_latents.npy")):
        phase_fixture()
    args = main_3dident.parse_args(_RUN3D + ["--mode", "unsupervised"])
    sampler = ThreeDIdentBatchSampler(
        FIXTURE, main_3dident.setup_latent_space(args)[0], 512, device="cuda")
    cases.append(("main_3dident --scan --fused-stem ResNet18 B=512",
                  functools.partial(_3dident_capture_lane, sampler, "--fused-stem"),
                  dict.fromkeys(LP + DOT + STEM, 1), 6, 512, 10))
    # the default path (minres norms, the stem's on the code and scatter)
    default_path = {**dict.fromkeys(LP + DOT, 1), **MINRES_STEP}
    cases.append(("main_3dident --scan ResNet18 B=512 (default, minres norms)",
                  functools.partial(_3dident_capture_lane, sampler),
                  default_path, 6, 512, None))
    # SGD under the cosine schedule: the fused update reads the schedule's
    # lr tensor on the device
    cases.append(("main_3dident --scan --optimizer sgd --lr-cosine ResNet18 "
                  "B=512 (default path)",
                  functools.partial(_3dident_capture_lane, sampler, "--optimizer",
                                    "sgd", "--lr-cosine"),
                  default_path, 6, 512, None))
    # ResNet-50's bottleneck blocks in bfloat16 (the benchmark's rn50 cell):
    # a step's activations take half the card, and the lanes' steps run in
    # turn, each freeing its own
    cases.append(("main_3dident --scan --bf16 --encoder rn50 ResNet-50 B=512 "
                  "(default path)",
                  functools.partial(_3dident_capture_lane, sampler, "--bf16",
                                    "--encoder", "rn50"),
                  {**dict.fromkeys(LP + DOT, 1), **RN50_STEP}, 3, 512, None))
    was = torch.backends.cudnn.deterministic
    for tag, make, per_step, replays, pairs, steps in cases:
        # bit for bit needs cuDNN's deterministic algorithms (KITTI,
        # 3DIdent); the speeds are taken with the drivers' own setting
        torch.backends.cudnn.deterministic = True
        try:
            _hold_capture(tag, make, per_step, replays)
        finally:
            torch.backends.cudnn.deterministic = was
        gc.collect()
        torch.cuda.empty_cache()
        if steps is None:  # phase 7 times this step's path eager
            continue
        _capture_rate(tag, make, pairs, steps, smi)
        gc.collect()
        torch.cuda.empty_cache()
    del sampler
    print(f"[9 capture] {time.perf_counter() - t0:.1f} s")

# ---------------------------------------------------------------------------
# the host-prefetch image path
# ---------------------------------------------------------------------------

# below the 588 MiB fixture: the store stays on the host, as a user's would
PREFETCH_BUDGET = str(256 << 20)


def _hold_gather(packed) -> None:
    """10a: the native gather of 1024 random rows against numpy's fancy
    index of the memmap, bit for bit, and the rate of both."""
    rows = np.random.default_rng(0).integers(0, len(packed), 1024)
    gather = native.PackedGather(packed.filename, packed.shape[1:], len(packed))
    try:
        got = gather.gather(rows)
        want = packed[rows]
        if not np.array_equal(got, want):
            raise AssertionError("10a: the native gather differs from numpy's")
        rates = {}
        for name, fn in (("native", lambda: gather.gather(rows, out=got)),
                         ("numpy", lambda: packed[rows])):
            fn()
            t0 = time.perf_counter()
            for _ in range(5):
                fn()
            rates[name] = 5 * got.nbytes / (time.perf_counter() - t0) / 1e9
    finally:
        gather.close()
    _say_time(f"[10 times] 10a gather of 1024 random rows of 224x224x3 "
              f"({got.nbytes / 1e6:.1f} MB), bit-equal to numpy's: native "
              f"{rates['native']:.2f} GB/s ({os.cpu_count()} threads), numpy "
              f"{rates['numpy']:.2f} GB/s; host of {os.cpu_count()} cores")


def _hold_loader(host, device) -> None:
    """10b: one worker from seed s against the device store's own batches
    from a generator of seed s, 20 batches: latents and uint8 renders bit
    for bit (the pinned slots are reused six times over), and the
    normalised views against ``sample_with_images``."""
    loader = PrefetchingPairLoader(
        host, torch.Generator(device="cuda").manual_seed(7), num_workers=1)
    ref = torch.Generator(device="cuda").manual_seed(7)
    ref_views = torch.Generator(device="cuda").manual_seed(7)
    busy = torch.randn(4096, 4096, device="cuda")
    try:
        for i in range(20):
            (z, zt), (x, xt) = next(loader)
            busy = busy @ busy / 64  # the training stream is busy meanwhile
            idx_z, idx_zt, wz, wzt = device.sample_latent_batch(ref)
            (_, _), (vx, vxt) = device.sample_with_images(ref_views)
            same = (torch.equal(z, wz) and torch.equal(zt, wzt)
                    and torch.equal(x, device.device_store[idx_z])
                    and torch.equal(xt, device.device_store[idx_zt])
                    and torch.equal(normalize_3dident(x), vx)
                    and torch.equal(normalize_3dident(xt), vxt))
            if not same:
                raise AssertionError(f"10b: batch {i} of the loader differs from "
                                     "the device store's")
    finally:
        loader.close()
    print(f"[10 prefetch] 10b: 20 batches of one worker (seed 7, {loader.slots} "
          f"pinned slots) bit-equal to the device store's (latents, uint8 "
          f"renders, normalised views)")


def _run_prefetch(tag: str, argv: list[str], budget: str | None
                  ) -> tuple[dict, dict, float]:
    """One main_3dident run under the device budget ``budget`` (None: the
    default), the launch counts set to 0 just before it."""
    was = os.environ.get(data3d.BUDGET_ENV)
    if budget is None:
        os.environ.pop(data3d.BUDGET_ENV, None)
    else:
        os.environ[data3d.BUDGET_ENV] = budget
    try:
        out, grew, secs = _run_3dident(tag, argv)
    finally:
        if was is None:
            os.environ.pop(data3d.BUDGET_ENV, None)
        else:
            os.environ[data3d.BUDGET_ENV] = was
    print(f"[10 prefetch] {tag}: data path {out['data_path']}, loader "
          f"{out['loader']}")
    return out, grew, secs


def _prefetch_pairs_per_sec(host, workers: int | None, bf16: bool
                            ) -> tuple[float, float, float]:
    """(pairs/s, peak GiB, GiB held before the steps) of steady default-path
    steps (ResNet18, B = 512) of main_3dident's own ``train_step``: from
    the store uploaded for this turn alone (workers None) or from a loader
    of ``workers`` threads over the host store ``host``."""
    argv = _RUN3D + ["--mode", "unsupervised"] + (["--bf16"] if bf16 else [])
    args = main_3dident.parse_args(argv)
    _, n_non_ang, n_ang = main_3dident.setup_latent_space(args)
    model = main_3dident.build_encoder(
        args, n_non_ang + n_ang, n_non_ang,
        torch.Generator().manual_seed(0)).cuda().train()
    loss = main_3dident.build_split_loss(args, n_non_ang)
    opt, _ = make_optimizer(model.parameters(), args.lr)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batches = (ThreeDIdentBatchSampler(FIXTURE, host.latent_space, 512, device="cuda")
               if workers is None else
               PrefetchingPairLoader(host, gen, num_workers=workers or os.cpu_count()))
    try:
        step = lambda: main_3dident.train_step(model, loss, opt, None, batches, gen)
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        n = 8 if not bf16 else 20
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        pps = n * args.batch_size / (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        if workers is not None:
            batches.close()
    del model, opt, batches, step
    gc.collect()
    torch.cuda.empty_cache()
    return pps, peak, held


def phase_prefetch(smi: str) -> dict:
    """Phase 10: main_3dident on a store beyond the device budget."""
    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(FIXTURE, "raw_latents.npy")):
        phase_fixture()
    run_dir = os.path.join(OUT_DIR, "10_prefetch")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    args = main_3dident.parse_args(_RUN3D + ["--mode", "unsupervised"])
    space = main_3dident.setup_latent_space(args)[0]
    host = ThreeDIdentBatchSampler(FIXTURE, space, 512, device_images=False,
                                   device="cuda")
    device = ThreeDIdentBatchSampler(FIXTURE, space, 512, device="cuda")
    _hold_gather(host.images._packed)
    _hold_loader(host, device)
    del device
    gc.collect()
    torch.cuda.empty_cache()

    # 10c: the driver at full width on the host store, one worker, against
    # the device store's run of the same seed, bit for bit
    steps = 6
    model = os.path.join(run_dir, "10c_model.pt")
    unsup = ["--mode", "unsupervised", "--n-log-steps", "100", "--iterations"]
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        on_device, grew_d, _ = _run_prefetch("10c device store",
                                             unsup + [str(steps)], None)
        on_host, grew_h, _ = _run_prefetch(
            "10c host store, --workers 1",
            unsup + [str(steps), "--workers", "1", "--save-model", model],
            PREFETCH_BUDGET)
    finally:
        torch.backends.cudnn.deterministic = was
    if (on_device["data_path"], on_host["data_path"]) != ("device-store",
                                                          "host-prefetch"):
        raise AssertionError(f"10c: data paths {on_device['data_path']}, "
                             f"{on_host['data_path']}")
    want = {k: steps if k in LP + DOT else steps * MINRES_STEP.get(k, 0)
            for k in COUNTERS}
    if grew_h != want or grew_d != want:
        raise AssertionError(f"10c: launches {grew_h} (host), {grew_d} (device); "
                             f"expected {want}")
    same = sum(a == b for a, b in zip(on_host["losses"], on_device["losses"]))
    print(f"[10 prefetch] 10c: {same} of {steps} losses of the host path equal "
          f"the device store's; MCC {on_host['mcc']:.6f} / {on_device['mcc']:.6f}")
    if len(on_host["losses"]) != steps or on_host["losses"] != on_device["losses"]:
        raise AssertionError(f"10c: {on_host['losses']} vs {on_device['losses']}")
    if on_host["mcc"] != on_device["mcc"] or on_host["lin"] != on_device["lin"]:
        raise AssertionError("10c: the evaluations differ")

    # 10d: more workers, and the other two modes, over budget
    for workers in (4, 0):
        out, _, _ = _run_prefetch(f"10d --workers {workers}",
                                  unsup + ["4", "--workers", str(workers)],
                                  PREFETCH_BUDGET)
        loader = out["loader"]
        if out["data_path"] != "host-prefetch" or not all(
                math.isfinite(x) for x in out["losses"]):
            raise AssertionError(f"10d --workers {workers}: {out}")
        if loader["workers"] != (workers or os.cpu_count()):
            raise AssertionError(f"10d --workers {workers}: {loader}")
        if not loader["peak_ready"] <= loader["slots"]:
            raise AssertionError(f"10d: the queue grew past its slots: {loader}")
    for mode, extra in (("supervised", ["--iterations", "3", "--n-eval-samples",
                                        "1024"]),
                        ("test", ["--load-model", model])):
        out, _, _ = _run_prefetch(f"10d --mode {mode}", ["--mode", mode, *extra],
                                  PREFETCH_BUDGET)
        if out["data_path"] != "host-gather" or not (
                math.isfinite(out["lin"]) and all(math.isfinite(x)
                                                  for x in out["losses"])):
            raise AssertionError(f"10d --mode {mode}: {out}")

    # 10e: pairs/s and peak GiB, the device store (uploaded for its turn
    # alone) against the host path at three worker counts, in turns
    turns = (None, 1, 4, 0, 0, 4, 1, None)
    name = lambda w: "device store" if w is None else f"host --workers {w}"
    for bf16 in (False, True):
        runs = [_prefetch_pairs_per_sec(host, w, bf16) for w in turns]
        _say_time(f"[10 times] 10e 3DIdent default step, ResNet18 B=512 "
                  f"{'--bf16' if bf16 else 'float32, TF32 off'}, pairs/s (peak "
                  f"GiB; GiB held before the steps) in turns: "
                  + ", ".join(f"{name(w)} {p:.1f} ({m:.3f}; {h:.3f})"
                              for w, (p, m, h) in zip(turns, runs))
                  + f"; --workers 0 = {os.cpu_count()}; on {smi}")
    del host
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[10 prefetch] {time.perf_counter() - t0:.1f} s")
    return {k: grew_h[k] for k in COUNTERS}


# ---------------------------------------------------------------------------
# phase 11: the data-parallel mesh (--mesh N, parallel/)
# ---------------------------------------------------------------------------

MESH_STEPS = 3       # 11a: steps held bit for bit
MESH_MLP_STEPS = 20  # 11b: main_mlp --mesh 2's steps
MESH_3D_STEPS = 5    # 11b: main_3dident --mesh 2's steps
MESH_WORLDS = (2, 4, 8)  # 11c: the rectangular kernels at (B/W, B)


def _params_equal(a, b) -> tuple[int, int]:
    pairs = list(zip(a, b))
    return sum(torch.equal(x, y) for x, y in pairs), len(pairs)


def _mesh_w1_rank(smi: str, device) -> dict:
    """11a, as the one rank of an NCCL group on cuda:0: each lane twice from
    seed 0, one with the single-device eager step, one with the eager mesh
    step at world size 1 (every collective called), MESH_STEPS steps each;
    their outputs and tensors, and the mesh steps' launch counts. Then, in
    the same rank, 11e's uint8 reduce-scatter and 11f's captured mesh step
    (their lines are printed here; the times are handed back)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    mesh = parallel.make_mesh(1, device)
    out = {"backend": torch.distributed.get_backend()}
    for config in ("box", "simclr"):
        args = main_mlp.parse_args(CONFIGS[config])
        lanes = [main_mlp.Lane(args, 0, device,
                               main_mlp.build_latent_space(args, device),
                               main_mlp.make_loss(args), m) for m in (None, mesh)]
        lanes[1].captured = False  # 11a holds the eager mesh step; 11f captures it
        for lane in lanes:
            lane.start_phase(False, args.n_steps)
        want = torch.stack([_eager(lanes[0].step) for _ in range(MESH_STEPS)])
        infonce.reset_launch_counts()
        got = torch.stack([lanes[1].step() for _ in range(MESH_STEPS)])
        torch.cuda.synchronize()
        out[config] = {"outputs_equal": torch.equal(got, want),
                       "max_diff": float((got - want).abs().max()),
                       "tensors": _params_equal(lanes[0].f.parameters(),
                                                lanes[1].f.parameters()),
                       "launches": infonce.launch_counts()}
    for tag, extra in (("3dident", ()), ("3dident minres8", ("--norm-kind", "minres8"))):
        out[tag] = _mesh_w1_3dident(mesh, device, extra)
    gc.collect()
    torch.cuda.empty_cache()
    out["store"] = _store_w1(mesh, device)
    out["capture_s"] = _capture_mesh_w1(mesh, device, smi)
    out["times"] = list(TIMES)
    return out


def _mesh_w1_3dident(mesh, device, extra: tuple) -> dict:
    """11a's main_3dident lane (with the driver flags ``extra``): the eager
    one-device step (the whole store on the device) against the mesh step
    at world size 1 on the row-sharded store (its one block, the batch
    taken by the uint8 reduce-scatter over NCCL)."""
    args = main_3dident.parse_args(_RUN3D + ["--mode", "unsupervised", *extra])
    space, na, n_ang = main_3dident.setup_latent_space(args)
    sampler = ThreeDIdentBatchSampler(FIXTURE, space, 512, device=device)
    sharded = ThreeDIdentBatchSampler(FIXTURE, space, 512, device=device, mesh=mesh)

    def lane(wrap=None):
        model = main_3dident.build_encoder(
            args, na + n_ang, na, torch.Generator().manual_seed(0)).to(device).train()
        opt, sched = make_optimizer(model.parameters(), args.lr, kind=args.optimizer)
        loss = main_3dident.build_split_loss(args, na, wrap=wrap)
        return model, opt, sched, loss, torch.Generator(device=device).manual_seed(0)

    model, opt, sched, loss, gen = lane()
    want = torch.stack([torch.stack(main_3dident.train_step(
        model, loss, opt, sched, sampler, gen)) for _ in range(MESH_STEPS)])
    model2, opt2, sched2, loss2, gen2 = lane(
        functools.partial(parallel.gspmd_safe_loss, mesh))
    step = parallel.make_sharded_3dident_train_step(mesh, model2, loss2, opt2, sched2)
    rows = parallel.mesh_rows(mesh, 512)
    infonce.reset_launch_counts()
    got = torch.stack([torch.stack(step(*main_3dident.draw_rank_views(
        sharded, gen2, rows)[1::2])) for _ in range(MESH_STEPS)])
    torch.cuda.synchronize()
    return {"outputs_equal": torch.equal(got, want),
            "max_diff": float((got - want).abs().max()),
            "tensors": _params_equal(
                list(model.parameters()) + list(model.buffers()),
                list(model2.parameters()) + list(model2.buffers())),
            "launches": infonce.launch_counts()}


def _store_w1(mesh, device) -> dict:
    """11e at world size 1 over NCCL: the uint8 reduce-scatter on the card
    (ops.collectives.reduce_scatter_rows) and store_gather_scatter over the
    fixture's padded store, against direct indexing."""
    t0 = time.perf_counter()
    packed = np.load(os.path.join(FIXTURE, "images_packed_224x224.u8"), mmap_mode="r")
    store = data3d.RowShardedStore(packed, mesh, device)
    idx = torch.randint(0, packed.shape[0], (512,),
                        generator=torch.Generator().manual_seed(11)).to(device)
    rows = store.rows_of(idx)
    direct = store.block[idx]
    contrib = (direct % 7).contiguous()
    summed = collectives.reduce_scatter_rows(contrib.clone(), mesh.data_group)
    torch.cuda.synchronize()
    return {"dtype": str(rows.dtype), "equal": torch.equal(rows, direct),
            "scatter_equal": torch.equal(summed, contrib),
            "scatter_dtype": str(summed.dtype), "block_bytes": store.nbytes,
            "shape": list(store.shape), "s": time.perf_counter() - t0}


MESH_CAPTURE_REPLAYS = 20  # 11f: replays held bit for bit (22 steps in all)


def _capture_mesh_w1(mesh, device, smi: str) -> float:
    """11f: main_mlp's mesh lane at world size 1 over NCCL, captured as the
    driver captures it (its collectives in the graph), against the same
    lane's body run eagerly: _hold_capture's check over WARMUP_STEPS +
    MESH_CAPTURE_REPLAYS steps, the replays under sync debug mode "error",
    then eager against captured ms a step in turns. Returns its seconds."""
    t0 = time.perf_counter()
    args = main_mlp.parse_args(CONFIGS["box"])

    def make():
        lane = main_mlp.Lane(args, 0, device, main_mlp.build_latent_space(args, device),
                             main_mlp.make_loss(args), mesh)
        lane.start_phase(False, args.n_steps)
        if not isinstance(lane.step, CapturedStep):
            raise AssertionError(f"11f: the mesh lane over {torch.distributed.get_backend()} "
                                 "is not captured")
        return lane.step, lambda: list(lane.f.parameters())

    tag = f"main_mlp box p=1 B={BATCH} --mesh at world size 1 over NCCL"
    _hold_capture(tag, make, dict.fromkeys(LP, 1), MESH_CAPTURE_REPLAYS,
                  label="[11 mesh] 11f")
    gc.collect()
    torch.cuda.empty_cache()
    _capture_rate(tag, make, BATCH, 50, smi, label="[11 times] 11f")
    secs = time.perf_counter() - t0
    print(f"[11 mesh] 11f {secs:.1f} s")
    return secs


def _hold_mesh_w1(smi: str) -> dict:
    """11a: world size 1 through NCCL, bit for bit against the eager step;
    11e's reduce-scatter and 11f's captured mesh step in the same rank."""
    t0 = time.perf_counter()
    got = parallel.launch(_mesh_w1_rank, 1, args=(smi,), device="cuda")
    TIMES.extend(t for t in got["times"] if t not in TIMES)
    launches = {k: 0 for k in COUNTERS}
    per_step = {"box": {k: 1 for k in LP}, "simclr": {k: 1 for k in DOT},
                "3dident": {**{k: 1 for k in LP + DOT}, **MINRES_STEP},
                "3dident minres8": MINRES8_STEP}
    for tag, want in per_step.items():
        r = got[tag]
        grew = {k: v for k, v in r["launches"].items() if v}
        print(f"[11 mesh] 11a {tag}: world size 1 over {got['backend']}, "
              f"{MESH_STEPS} steps against the eager single-device step from "
              f"seed 0: outputs {'bit-equal' if r['outputs_equal'] else 'DIFFER'} "
              f"(max |diff| {r['max_diff']:.3e}); {r['tensors'][0]} of "
              f"{r['tensors'][1]} parameter (and buffer) tensors bit-equal; "
              f"launches {grew}")
        expected = {k: MESH_STEPS * v for k, v in want.items()}
        if grew != expected:
            raise AssertionError(f"11a {tag}: launches {grew}, expected {expected}")
        if (got["backend"] != "nccl" or not r["outputs_equal"]
                or r["tensors"][0] != r["tensors"][1]):
            raise AssertionError(f"11a {tag}: the mesh step differs from the "
                                 f"single-device step: {r}")
        for k, v in r["launches"].items():
            launches[k] += v
    st = got["store"]
    print(f"[11 mesh] 11e world size 1 over NCCL: store {st['shape']} in one block "
          f"of {st['block_bytes']} bytes; 512 rows by store_gather_scatter "
          f"{st['dtype']}, {'equal' if st['equal'] else 'DIFFER'} to direct "
          f"indexing; reduce_scatter_rows of uint8 on the card "
          f"{'equal' if st['scatter_equal'] else 'DIFFERS'} ({st['scatter_dtype']}); "
          f"{st['s']:.1f} s")
    if not (st["equal"] and st["scatter_equal"] and st["dtype"] == "torch.uint8"
            and st["scatter_dtype"] == "torch.uint8"):
        raise AssertionError(f"11e world size 1: {st}")
    print(f"[11 mesh] 11a, 11e (world size 1) and 11f "
          f"{time.perf_counter() - t0:.1f} s (11f {got['capture_s']:.1f} s of it)")
    return launches


def _mesh_mlp_argv(save_dir: str) -> list:
    return BOX[:BOX.index("--n-steps")] + [
        "--n-steps", str(MESH_MLP_STEPS), "--more-unsupervised", "1",
        "--n-log-steps", "5", "--num-eval-batches", "1", "--seed", "0",
        "--save-dir", save_dir]


def _falling(losses: list) -> bool:
    k = max(1, len(losses) // 4)
    return (all(math.isfinite(x) for x in losses)
            and np.mean(losses[-k:]) < np.mean(losses[:k]))


def _hold_mesh_two_ranks() -> None:
    """11b: two gloo ranks on the one card (both on cuda:0, the gloo
    collectives staging CUDA tensors through the host), main_mlp and
    main_3dident each with --mesh 2 through the parallel API's launcher,
    against the single-device run of the same seed."""
    t0 = time.perf_counter()
    run_dir = os.path.join(OUT_DIR, "11_mesh")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    two = dict(backend="gloo", devices=["cuda:0", "cuda:0"])
    # log.csv's loss at each logged step (the phase's last step is logged
    # twice: after its window and by the final evaluation)
    logged = lambda d: list({int(r["step"]): float(r["loss"]) for r in
                             csv.DictReader(open(os.path.join(d, "log.csv")))}.values())
    one_dir, mesh_dir = os.path.join(run_dir, "mlp_one"), os.path.join(run_dir, "mlp_two")
    main_mlp.main(_mesh_mlp_argv(one_dir), device="cuda")
    t1 = time.perf_counter()
    parallel.launch(main_mlp.main, 2, args=(_mesh_mlp_argv(mesh_dir) + ["--mesh", "2"],),
                    device="cuda", **two)
    mesh_s = time.perf_counter() - t1
    want, got = logged(one_dir), logged(mesh_dir)
    first = abs(got[0] - want[0]) / abs(want[0])
    print(f"[11 mesh] 11b main_mlp box p=1 --mesh 2, two gloo ranks on cuda:0, "
          f"B={BATCH} (each rank's Lp kernels at ({BATCH // 2}, {BATCH}, "
          f"{N_FEAT})), {MESH_MLP_STEPS} steps in {mesh_s:.1f} s: step 1 loss "
          f"{got[0]:.7f} vs one device {want[0]:.7f} (rel {first:.2e}); losses "
          f"at steps 1, 6, 11, 16, 20: {[round(x, 6) for x in got]}; one "
          f"device's {[round(x, 6) for x in want]}")
    if len(got) != len(want) or first > 1e-5 or not _falling(got):
        raise AssertionError(f"11b main_mlp: {got} vs {want}")

    argv = _RUN3D + ["--mode", "unsupervised", "--iterations", str(MESH_3D_STEPS),
                     "--n-log-steps", "100", "--n-eval-samples", "1024"]
    one = main_3dident.main(argv, device="cuda")
    gc.collect()
    torch.cuda.empty_cache()  # the ranks' two halves of the batch need the card
    t1 = time.perf_counter()
    mesh = parallel.launch(main_3dident.main, 2, args=(argv + ["--mesh", "2"],),
                           device="cuda", **two)
    mesh_s = time.perf_counter() - t1
    first = abs(mesh["losses"][0] - one["losses"][0]) / abs(one["losses"][0])
    print(f"[11 mesh] 11b main_3dident --mesh 2 (minres), two gloo ranks on "
          f"cuda:0, B=512 (each rank one forward of 512 images; Lp and dot "
          f"kernels at (256, 512)), {len(mesh['losses'])} steps in {mesh_s:.1f} s: "
          f"losses {[round(x, 6) for x in mesh['losses']]} vs one device "
          f"{[round(x, 6) for x in one['losses']]} (step 1 rel {first:.2e}); "
          f"MCC {mesh['mcc']:.4f} / {one['mcc']:.4f}")
    if (len(mesh["losses"]) != MESH_3D_STEPS or first > 1e-5
            or not _falling(mesh["losses"])):
        raise AssertionError(f"11b main_3dident: {mesh['losses']} vs {one['losses']}")
    print(f"[11 mesh] 11b {time.perf_counter() - t0:.1f} s")


def _time_rect(impl, m: int, n_rows: int, n_feat: int = N_FEAT) -> dict:
    """Device ms (_graph_ms) of the forward and each gradient alone of
    impl(z1, z3) at (m, n_rows), as _time_loss does for a square call."""
    rng = np.random.default_rng(1)
    z1, z3 = _pair(m, n_rows, rng, n_feat)
    ct = torch.ones(m, device="cuda")
    a = torch.tensor(z1, device="cuda")
    b = torch.tensor(z3, device="cuda")
    out = {"fwd": _graph_ms(lambda: impl(a, b))}
    for k, (g1, g3) in (("dz1", (True, False)), ("dz3", (False, True))):
        a = torch.tensor(z1, device="cuda", requires_grad=g1)
        b = torch.tensor(z3, device="cuda", requires_grad=g3)
        wrt = a if g1 else b
        held = {}

        def forward():
            held["lse"] = impl(a, b)

        out[k] = _graph_ms(
            lambda: torch.autograd.grad(held["lse"], wrt, ct, retain_graph=True),
            prepare=forward)
    return out


def _rect_kernels(worst: dict, smi: str) -> dict:
    """11c: the loss kernels at a rank's rectangular (B/W, B) block against
    their plain versions at the phase 2 bars, and their device ms beside
    the plain versions' and the bound."""
    rng = np.random.default_rng(11)
    rect = {}
    for p, label in ((1.0, "p=1"), (2.0, "p=2"), (0.0, "p=0")):
        kernel, plain, _ = _loss_cases(p, TAU)
        names = DOT if p == 0 else LP
        for world in MESH_WORLDS:
            m = BATCH // world
            z1, z3 = _pair(m, BATCH, rng)
            ct = _cotangent(m, rng)
            got = _value_and_grads(kernel, z1, z3, ct)
            want = _value_and_grads(plain, z1, z3, ct)
            _hold(f"11c {label} ({m}, {BATCH}, {N_FEAT})", names, got, want, worst)
            kern, pl = _time_rect(kernel, m, BATCH), _time_rect(plain, m, BATCH)
            bounds = _bounds(m, BATCH, N_FEAT)
            for key, k in zip(names, ("fwd", "dz1", "dz3")):
                rect.setdefault(key, {}).setdefault(label, {})[f"W={world}"] = {
                    "shape": [m, BATCH, N_FEAT], "ms": kern[k], "plain_ms": pl[k],
                    "bound_ms": bounds[k][0], "bound_by": bounds[k][1]}
            _say_time(f"[11 times] 11c {label} at ({m}, {BATCH}, {N_FEAT}) (W={world}) "
                      "kernel / plain ms: " + ", ".join(
                          f"{k} {kern[k]:.4f} / {pl[k]:.4f} (bound {bounds[k][0]:.4f})"
                          for k in ("fwd", "dz1", "dz3")) + f"; on {smi}")
    return rect


TP_MLP_MESHES = ((2, 2), (4, 2))  # 11d: main_mlp's (--mesh, --mesh-model)
TP_3D_B, TP_3D_STEPS = 64, 3      # 11d: main_3dident's batch and steps
TP_SPLIT_C = (32, 16)             # 11d: the stem's channels over 2 and 4 model ranks
STORE_B, STORE_STEPS = 128, 3     # 11e: the two ranks' batch and steps


def _gloo_ranks(world: int) -> dict:
    """parallel.launch's arguments for ``world`` gloo ranks on cuda:0."""
    return dict(device="cuda", backend="gloo", devices=["cuda:0"] * world)


def _logged_losses(save_dir: str) -> list:
    """log.csv's loss at each logged step (the phase's last step is logged
    twice: after its window and by the final evaluation)."""
    with open(os.path.join(save_dir, "log.csv")) as fh:
        return list({int(r["step"]): float(r["loss"]) for r in csv.DictReader(fh)}.values())


def _mesh_rank_runs(runs: list, device) -> list:
    """The rank of 11d's and 11e's gloo launches: each (what, argv) of
    ``runs`` as this rank of the group, "mlp" and "3dident" a driver's
    ``main`` with every launch count set to 0 just before it and read just
    after, "store" _store_rank: [(what each returned, the counts)] (rank
    0's is kept)."""
    out = []
    for what, argv in runs:
        infonce.reset_launch_counts()
        if what == "store":
            got = _store_rank(device)
        else:
            got = {"mlp": main_mlp.main, "3dident": main_3dident.main}[what](
                argv, device=device)
        torch.cuda.synchronize()
        out.append((got, infonce.launch_counts()))
    return out


def _store_rank(device) -> dict:
    """11e as a rank of two gloo ranks on cuda:0: main_3dident's mesh step
    for STORE_STEPS steps from seed 0 twice, once with the whole store on
    the device and the rank's rows gathered from it (the path every rank
    took before the store was row-sharded), once on the row-sharded store
    (the rank's half, the rows by the uint8 reduce-scatter): the losses,
    and the bytes of store each held. Runs last in its rank (it sets
    cudnn.deterministic)."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    mesh = parallel.make_mesh(2, device)
    args = main_3dident.parse_args(_RUN3D + ["--mode", "unsupervised"])
    space, na, n_ang = main_3dident.setup_latent_space(args)
    rows = parallel.mesh_rows(mesh, STORE_B)

    def run(sampler, views):
        model = main_3dident.build_encoder(
            args, na + n_ang, na, torch.Generator().manual_seed(0)).to(device).train()
        opt, sched = make_optimizer(model.parameters(), args.lr, kind=args.optimizer)
        step = parallel.make_sharded_3dident_train_step(
            mesh, model, main_3dident.build_split_loss(
                args, na, wrap=functools.partial(parallel.gspmd_safe_loss, mesh)),
            opt, sched)
        gen = torch.Generator(device=device).manual_seed(0)
        out = []
        for _ in range(STORE_STEPS):
            idx_z, idx_zt, _, _ = sampler.sample_latent_batch(gen)
            out.append(float(step(normalize_3dident(views(idx_z)),
                                  normalize_3dident(views(idx_zt)))[0]))
        return out

    whole = ThreeDIdentBatchSampler(FIXTURE, space, STORE_B, device=device)
    got = {"whole": run(whole, lambda idx: whole.images_of(idx[rows])),
           "whole_bytes": whole.device_store.numel()}
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    sharded = ThreeDIdentBatchSampler(FIXTURE, space, STORE_B, device=device, mesh=mesh)
    got.update({"sharded": run(sharded, sharded.rank_images_of),
                "bytes": sharded.sharded_store.nbytes,
                "shape": list(sharded.sharded_store.shape),
                "s": time.perf_counter() - t0})
    return got


def _hold_mesh_tp(worst: dict, smi: str) -> dict:
    """11d: --mesh-model on gloo ranks sharing the card (NCCL takes one rank
    a device): main_mlp at the published width against 11b's one-device
    run; main_3dident --mesh 4 --mesh-model 2 (ResNet18's widths, the
    default minres path, float32 and --bf16) against --mesh 2; the norm,
    stem and pool kernels at the channel-split shapes against their plain
    versions. 11e's two-rank part runs in 11d's two-rank launch (each
    launch's ranks take seconds to start). Returns the drivers' launches
    (rank 0's)."""
    t0 = time.perf_counter()
    run_dir = os.path.join(OUT_DIR, "11_mesh")
    mlp = {world: (os.path.join(run_dir, f"mlp_tp_{world}x{model}"),
                   ["--mesh", str(world), "--mesh-model", str(model)])
           for world, model in TP_MLP_MESHES}
    argv = _RUN3D + ["--mode", "unsupervised", "--batch-size", str(TP_3D_B),
                     "--iterations", str(TP_3D_STEPS), "--n-log-steps", "100",
                     "--n-eval-samples", str(2 * TP_3D_B)]
    runs = [("float32", argv, VALUE_BAR), ("bf16", argv + ["--bf16"], BF16_ULP)]
    gc.collect()
    torch.cuda.empty_cache()
    took = {}
    for world, mesh_3d in ((2, ["--mesh", "2"]), (4, ["--mesh", "4", "--mesh-model", "2"])):
        save, flags = mlp[world]
        t1 = time.perf_counter()
        took[world] = parallel.launch(_mesh_rank_runs, world, args=(
            [("mlp", _mesh_mlp_argv(save) + flags)]
            + [("3dident", a + mesh_3d) for _, a, _ in runs]
            + ([("store", None)] if world == 2 else []),), **_gloo_ranks(world))
        print(f"[11 mesh] 11d{' and 11e' if world == 2 else ''}: {world} gloo "
              f"ranks on cuda:0 took {time.perf_counter() - t1:.1f} s (gloo, one card)")
    want = _logged_losses(os.path.join(run_dir, "mlp_one"))
    launches = {k: 0 for k in COUNTERS}
    for world, model in TP_MLP_MESHES:
        save, flags = mlp[world]
        grew = {k: v for k, v in took[world][0][1].items() if v}
        got = _logged_losses(save)
        first = abs(got[0] - want[0]) / abs(want[0])
        print(f"[11 mesh] 11d main_mlp box p=1 {' '.join(flags)} "
              f"({world // model} data x {model} model), gloo ranks on cuda:0, "
              f"B={BATCH}, {MESH_MLP_STEPS} steps: step 1 loss {got[0]:.7f} vs one "
              f"device {want[0]:.7f} (rel {first:.2e}); losses "
              f"{[round(x, 6) for x in got]}; rank 0's launches {grew}")
        if (len(got) != len(want) or first > VALUE_BAR or not _falling(got)
                or grew != dict.fromkeys(LP, MESH_MLP_STEPS)):
            raise AssertionError(f"11d main_mlp {flags}: {got} vs {want}, {grew}")
        for k, v in grew.items():
            launches[k] += v
    # the stem's block of 32 channels is whole vectors: the code and scatter
    per_step = {**dict.fromkeys(LP + DOT, TP_3D_STEPS),
                **{k: v * TP_3D_STEPS for k, v in MINRES_STEP.items()}}
    for (label, _, bar), (got, grew), (one, _) in zip(runs, took[4][1:], took[2][1:]):
        first = abs(got["losses"][0] - one["losses"][0]) / abs(one["losses"][0])
        grew = {k: v for k, v in grew.items() if v}
        print(f"[11 mesh] 11d main_3dident --mesh 4 --mesh-model 2 (2 data x 2 "
              f"model) {label}, ResNet18 (num_filters 64: each rank's convs at "
              f"half the output channels, its norms at C/2), B={TP_3D_B}, gloo "
              f"ranks on cuda:0: losses {[round(x, 6) for x in got['losses']]} "
              f"vs --mesh 2 {[round(x, 6) for x in one['losses']]} (step 1 rel "
              f"{first:.2e}, bar {bar:g}); MCC {got['mcc']:.4f} / {one['mcc']:.4f}; "
              f"store {got['data_path']}, {got['store_bytes']} bytes a rank; rank "
              f"0's launches {grew}")
        if (len(got["losses"]) != TP_3D_STEPS or first > bar or grew != per_step
                or not all(math.isfinite(x) for x in got["losses"])):
            raise AssertionError(f"11d main_3dident {label}: {got['losses']} vs "
                                 f"{one['losses']}, {grew}")
        for k, v in grew.items():
            launches[k] += v
    _hold_store_two_ranks(took[2][-1][0])
    t1 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(16)
    for c in TP_SPLIT_C:
        shape = (TP_3D_B, 112, 112, c)  # the stem of a rank's 2B/D images at C/M
        for dtype in (torch.float32, torch.bfloat16):
            _hold_stem(f"11d C={c}", shape, dtype, gen, worst)
            _hold_bn(shape, dtype, gen, worst)
            _hold_bn8(shape, dtype, gen, worst)
            _hold_pool(shape, dtype, gen, worst)
            torch.cuda.empty_cache()
    print(f"[11 mesh] 11d the stem, pool, minres and minres8 kernels held at "
          f"({TP_3D_B}, 112, 112, C) for C = {TP_SPLIT_C}, float32 and bfloat16 in "
          f"{time.perf_counter() - t1:.1f} s; 11d and 11e's two ranks "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


def _hold_store_two_ranks(got: dict) -> None:
    """11e with two gloo ranks on cuda:0 (``got``, rank 0's _store_rank):
    the row-sharded store bit-equal, loss for loss, to the whole store's
    path; the bytes a rank holds."""
    n_pad, row = got["shape"][0], int(np.prod(got["shape"][1:]))
    print(f"[11 mesh] 11e --mesh 2 main_3dident step (ResNet18, B={STORE_B}, "
          f"two gloo ranks on cuda:0), {STORE_STEPS} steps: row-sharded store "
          f"{got['sharded']} vs the whole store's path {got['whole']}: "
          f"{'bit-equal' if got['sharded'] == got['whole'] else 'DIFFER'}; a rank "
          f"holds {got['bytes']} bytes = {n_pad} / 2 renders x {row} bytes "
          f"(the whole store {got['whole_bytes']}); {got['s']:.1f} s in its ranks")
    if got["sharded"] != got["whole"] or got["bytes"] != n_pad // 2 * row:
        raise AssertionError(f"11e two ranks: {got}")


def phase_mesh(worst: dict, smi: str) -> tuple[dict, dict]:
    """Phase 11: world size 1 over NCCL (11a, 11e's reduce-scatter, 11f),
    two gloo ranks on the card (11b), the rectangular loss kernels (11c),
    --mesh-model on gloo ranks (11d) and, in 11d's two-rank launch, the
    row-sharded store (11e). Returns the 11a and 11d launches and 11c's
    times."""
    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(FIXTURE, "raw_latents.npy")):
        phase_fixture()
    launches = _hold_mesh_w1(smi)
    _hold_mesh_two_ranks()
    rect = _rect_kernels(worst, smi)
    for k, v in _hold_mesh_tp(worst, smi).items():
        launches[k] += v
    print(f"[11 mesh] {time.perf_counter() - t0:.1f} s")
    return launches, rect


# ---------------------------------------------------------------------------
# phase 12: the ResNet's remaining options (minres8, the argmax-code stem
# pool, the s2d stems, remat)
# ---------------------------------------------------------------------------

BN8 = ("bn_apply8", "bn_bwd8", "bn_dx8")     # minres8's modes of the bn kernels
MINRES8_STEP = {**dict.fromkeys(LP + DOT, 1), "bn_stats": BN_NORMS_A_STEP,
                **dict.fromkeys(BN8, BN_NORMS_A_STEP)}
# xhat values that pin the conversion past e4m3fn's range (C9): NaN past
# 464 with the sign, 464 itself to 448
E4M3_EDGES = (448.0, 464.0, 465.0, 500.0, math.inf, -500.0)
OPTIONS_B = 512  # 12c: one forward of 1024 images of 224x224


def _hold_bn8(shape, dtype, gen, worst: dict) -> None:
    """The three float8 modes at one shape against their plain versions, in
    each of bn_relu, bn_add_relu and bn_only: xq byte-equal (also at
    inputs whose xhat passes e4m3fn's range: a channel's rstd times 300),
    y bit-equal to the minres apply kernel's, the sums (two calls bit for
    bit) and dx (with g) at the bn bars, given the plain version's
    statistics, sums and factors."""
    x, res, dy, scale, bias = _bn_inputs(shape, dtype, gen)
    mean, _, rstd = bn_minres.channel_stats(x, EPS)
    a, b = bn_minres.affine(scale, bias, mean, rstd, dtype)
    s, t = scale.to(dtype), bias.to(dtype)
    count = x.numel() // shape[-1]
    big = rstd.clone()
    big[: shape[-1] // 2] *= 300.0  # |xhat| past 464 in half the channels
    name = str(dtype).removeprefix("torch.")
    fails, parts, nans = [], [], 0
    for fn, with_res, relu in BN_FUNCTIONS:
        r = res if with_res else None
        y8, xq = bn_minres8.launch_apply8(x, a, b, mean, rstd, r, relu)
        y = bn_minres.launch_apply(x, a, b, r, relu)
        y_p, xq_p = bn_minres8.apply8_reference(x, a, b, mean, rstd, r, relu)
        same_y = torch.equal(y8, y)
        e_y, o_y = _same_map(y8, y_p, dtype)
        same_q = torch.equal(xq.view(torch.uint8), xq_p.view(torch.uint8))
        _, xq_big = bn_minres8.launch_apply8(x, a, b, mean, big, r, relu)
        q_big = bn_minres8.quantize_reference(x, mean, big).view(torch.uint8)
        same_big = torch.equal(xq_big.view(torch.uint8), q_big)
        nans += int(((q_big & 0x7F) == 0x7F).sum())
        del y8, y, y_p, xq_big, q_big
        sums = bn_minres8.launch_bwd8(xq, dy, s, t, r, relu)
        sums2 = bn_minres8.launch_bwd8(xq, dy, s, t, r, relu)
        torch.cuda.synchronize()
        repeats = all(torch.equal(p, q) for p, q in zip(sums, sums2))
        sums_p = bn_minres8.bwd8_reference(xq_p, dy, s, t, r, relu)
        e_sums = max(rel_err(k, p) for k, p in zip(sums, sums_p))
        k = bn_minres8.dx8_factors(scale, rstd, *sums_p, count, dtype)
        dx, g = bn_minres8.launch_dx8(xq, dy, k, s, t, r, relu)
        dx_p, g_p = bn_minres8.dx8_reference(xq_p, dy, k, s, t, r, relu)
        e_dx, o_dx = _map_err(dx, dx_p, dtype)
        e_g, o_g = _same_map(g, g_p, dtype) if with_res else (0.0, 0.0)
        del dx, g, dx_p, g_p, xq, xq_p
        worst["bn_apply8"] = max(worst.get("bn_apply8", 0.0), e_y)
        worst["bn_bwd8"] = max(worst.get("bn_bwd8", 0.0), max(
            float((p - q).abs().max()) for p, q in zip(sums, sums_p)))
        worst["bn_sums8_rel"] = max(worst.get("bn_sums8_rel", 0.0), e_sums)
        worst["bn_dx8"] = max(worst.get("bn_dx8", 0.0), e_dx, e_g)
        parts.append(f"{fn}8: xq {'byte-equal' if same_q else 'DIFFER'} (past "
                     f"464 {'byte-equal' if same_big else 'DIFFER'}), y "
                     f"{'bit-equal to minres' if same_y else 'DIFFERS from minres'}"
                     f" ({e_y:.2e} from plain), sums rel {e_sums:.2e} "
                     f"(twice {'bit-equal' if repeats else 'DIFFER'}), dx "
                     f"{e_dx:.2e} ({o_dx:.2f})"
                     + (f" g {e_g:.2e} ({o_g:.2f})" if with_res else ""))
        if (not (same_q and same_big and same_y and repeats) or o_y > 1.0
                or e_sums > BN_SUM_BAR or o_dx > 1.0 or o_g > 1.0):
            fails.append(fn)
    print(f"[12 options] bn8 {tuple(shape)} {name}: " + "; ".join(parts)
          + f"; NaN bytes past 464: {nans}")
    if fails or not nans:
        raise AssertionError(f"12a float8 modes vs plain, {shape} {name}: {fails}")


def _hold_e4m3_edges() -> None:
    """xhat at 448, 464, 465, 500, inf, -500 (C9): the kernel's bytes equal
    the plain version's, which are the JAX package's: 0x7e 0x7e 0x7f 0x7f
    0x7f 0xff."""
    c = 8
    x = torch.tensor(E4M3_EDGES, device="cuda").repeat_interleave(c).reshape(
        len(E4M3_EDGES), 1, 1, c)
    zero, one = torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")
    _, xq = bn_minres8.launch_apply8(x, one, zero, zero, one, None, False)
    got = xq.view(torch.uint8)[:, 0, 0, 0].tolist()
    want = bn_minres8.quantize_reference(x, zero, one).view(torch.uint8)[:, 0, 0, 0]
    print(f"[12 options] e4m3 bytes of xhat {E4M3_EDGES}: kernel "
          f"{[hex(v) for v in got]}, plain {[hex(v) for v in want.tolist()]}")
    if got != want.tolist() or got != [0x7E, 0x7E, 0x7F, 0x7F, 0x7F, 0xFF]:
        raise AssertionError(f"12a e4m3 edges: {got}")


def _hold_pool(shape, dtype, gen, worst: dict, mode: str = "normal") -> None:
    """The code and the scatter at one shape: pooled equal to the plain
    version's and to F.max_pool2d of the minres apply kernel's output, the
    codes byte-equal, a second launch of the code bit-equal to the first; dz
    of the scatter equal to the plain version's (the same additions in the
    same order) and to the library's max_pool2d_with_indices_backward within
    a rounding (it adds in float32 and rounds once). ``mode`` "tied": x on
    five levels; "neg": x >= 0, a < 0 and b <= 0, so that every window is
    all zeros and each code names its window's first position in the
    image."""
    x, scale, bias, g = _stem_inputs(shape, dtype, gen, mode == "tied")
    mean, _, rstd = bn_minres.channel_stats(x, EPS)
    a, b = bn_minres.affine(scale, bias, mean, rstd, dtype)
    if mode == "neg":
        x, a, b = x.abs(), -a.abs(), -b.abs()
    pooled, code = pool_minres.launch_pool_code(x, a, b)
    again = pool_minres.launch_pool_code(x, a, b)
    torch.cuda.synchronize()
    repeats = torch.equal(pooled, again[0]) and torch.equal(code, again[1])
    del again
    pooled_p, code_p = pool_minres.pool_code_reference(x, a, b)
    z = bn_minres.launch_apply(x, a, b).permute(0, 3, 1, 2)
    lib_pooled, idx = F.max_pool2d(z, 3, 2, 1, return_indices=True)
    same_p = torch.equal(pooled, pooled_p)
    same_lib = torch.equal(pooled, lib_pooled.permute(0, 2, 3, 1))
    same_c = torch.equal(code, code_p)
    zeros = mode != "neg" or not bool(pooled.any())
    worst["pool_code"] = max(worst.get("pool_code", 0.0),
                             float((pooled.float() - pooled_p.float()).abs().max()))
    del pooled_p, lib_pooled, code_p
    n, h, w, c = shape
    dz = pool_minres.launch_pool_scatter(g, code, h, w)
    dz_p = pool_minres.pool_scatter_reference(g, code, h, w)
    same_dz = torch.equal(dz, dz_p)
    worst["pool_scatter"] = max(worst.get("pool_scatter", 0.0),
                                float((dz.float() - dz_p.float()).abs().max()))
    lib = torch.ops.aten.max_pool2d_with_indices_backward(
        g.permute(0, 3, 1, 2), z, [3, 3], [2, 2], [1, 1], [1, 1], False,
        idx).permute(0, 2, 3, 1)
    # the library adds a position's (at most four) gradients in float32 and
    # rounds once; the kernel, as the JAX stencil, rounds each sum to the
    # map's dtype: float32 within STEM_MAP_BAR, bfloat16 within two ulps of
    # the map's largest value
    e_lib = float((dz.float() - lib.float()).abs().max())
    o_lib = e_lib / float(lib.float().abs().max()) / (
        2 * BF16_ULP if dtype == torch.bfloat16 else STEM_MAP_BAR)
    del z, idx, lib, dz_p
    name = str(dtype).removeprefix("torch.")
    print(f"[12 options] pool {tuple(shape)} {name} {mode}: pooled "
          f"{'equal' if same_p else 'DIFFER'} to plain, "
          f"{'equal' if same_lib else 'DIFFER'} to max_pool2d(bn_relu)"
          f"{'' if zeros else ', NOT ALL ZERO'}; codes "
          f"{'byte-equal' if same_c else 'DIFFER'}; two launches "
          f"{'bit-equal' if repeats else 'DIFFER'}; dz "
          f"{'equal' if same_dz else 'DIFFER'} to plain, {e_lib:.2e} from the "
          f"library's backward (over bar {o_lib:.2f})")
    if not (same_p and same_lib and same_c and repeats and zeros and same_dz) \
            or o_lib > 1.0:
        raise AssertionError(f"12a argmax pool kernels, {shape} {name} {mode}")


# 12a's shapes of the argmax pool's kernels, (shape, mode), C a number of
# channels or "256v", 256 vectors of the dtype (the widest the kernels take):
# the main path's, one image, one window, a W/2 that no strip divides, the
# widest C, more vectors than a block's slice, ties, all-zero windows
POOL_SHAPES = ((STEM_FULL, "normal"), ((1, 112, 112, 64), "normal"),
               ((1, 2, 2, 64), "normal"), ((2, 10, 70, 64), "tied"),
               ((1, 14, 18, "256v"), "normal"), ((3, 4, 8, 1024), "normal"),
               ((2, 6, 10, 16), "tied"), ((2, 6, 10, 16), "neg"),
               ((4, 20, 22, 64), "neg"))


def _pool_code_report(smi: str) -> None:
    """The code kernel's plan at STEM_FULL, its blocks an SM and its dynamic
    shared memory a block (ptxas's registers are phase 1's)."""
    lib = stem.load_kernels()
    for dtype in (torch.float32, torch.bfloat16):
        cv, _, ws, _ = stem.tile_geometry(STEM_FULL[2], STEM_FULL[3], dtype)
        slots = stem._slots(0, "pool_code", cv, ws, int(dtype == torch.bfloat16))
        plan = pool_minres.pool_code_plan(*STEM_FULL, dtype, slots)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        print(f"[12 options] pool_code_kernel {str(dtype).removeprefix('torch.')} "
              f"at {STEM_FULL}: plan {tuple(plan)} (cv, slices, ws, strips, ks, "
              f"segs, tiles, grid), {slots // sms} blocks an SM of {sms}, "
              f"{lib.clica_pool_code_smem(cv, ws)} bytes of dynamic shared "
              f"memory a block, on {smi}")


def _bn8_bounds(shape, dtype) -> dict:
    """The least ms of the five kernels of phase 12 at this shape (the f8
    modes in bn_relu's mode): bytes over the memory rate against operations
    over the float32 rate. apply8: x read, y written, xq written (1 byte);
    bwd8: xq and dy read; dx8: xq and dy read, dx written; pool_code: x
    read, pooled and the codes (a quarter of x's positions) written;
    pool_scatter: dp and codes read, dz written."""
    elems = math.prod(shape)
    size = 2 if dtype == torch.bfloat16 else 4
    out = {}
    for k, nbytes, ops in (("bn_apply8", elems * (2 * size + 1), elems * 6),
                           ("bn_bwd8", elems * (size + 1), elems * 6),
                           ("bn_dx8", elems * (2 * size + 1), elems * 7),
                           ("pool_code", elems * (1.25 * size + 0.25), elems * 6),
                           ("pool_scatter", elems * (1.25 * size + 0.25),
                            elems * 3)):
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_FLOPS
        out[k] = (1e3 * max(t_bytes, t_ops),
                  "bytes" if t_bytes >= t_ops else "operations")
    return out


OPTIONS_TIMED = BN8 + POOL


def _library_pool(x4, scale, bias, mean, var):
    """PyTorch's calls for the code kernel's function: the norm with the
    batch's statistics, the relu and the 3x3/2 max pool with its argmax
    (int64 indices where the kernel keeps an int8 code), on the logical
    NCHW view of the NHWC tensor."""
    z = F.relu(F.batch_norm(x4, mean, var, scale, bias, False, 0.0, EPS))
    return F.max_pool2d(z, 3, 2, 1, return_indices=True)


def _time_options(dtype, smi: str) -> dict:
    """ms of the five kernels at STEM_FULL (the f8 modes in bn_relu's mode)
    against their plain versions and PyTorch's own calls, in turns: for the
    code, batch_norm + relu + max_pool2d with indices (its pooled values
    held to the plain version's first); for the scatter,
    max_pool2d_with_indices_backward (held to it in _hold_pool). No single
    PyTorch call computes the f8 modes: PyTorch's e4m3 cast saturates where
    the JAX package's gives NaN (C9)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    x, _, dy, scale, bias = _bn_inputs(STEM_FULL, dtype, gen)
    mean, var, rstd = bn_minres.channel_stats(x, EPS)
    a, b = bn_minres.affine(scale, bias, mean, rstd, dtype)
    s, t = scale.to(dtype), bias.to(dtype)
    xq = bn_minres8.quantize_reference(x, mean, rstd)
    k = bn_minres8.dx8_factors(scale, rstd, *bn_minres8.bwd8_reference(
        xq, dy, s, t), x.numel() // x.shape[-1], dtype)
    code = pool_minres.pool_code_reference(x, a, b)[1]
    n, h, w, c = STEM_FULL
    g = torch.randn(code.shape, device="cuda", generator=gen).to(dtype)
    z = bn_minres.bn_apply_reference(x, a, b).permute(0, 3, 1, 2)
    _, idx = F.max_pool2d(z, 3, 2, 1, return_indices=True)
    g4 = g.permute(0, 3, 1, 2)
    x4 = x.permute(0, 3, 1, 2)
    lib_pooled = _library_pool(x4, scale, bias, mean, var)[0].permute(0, 2, 3, 1)
    plain_pooled = pool_minres.pool_code_reference(x, a, b)[0]
    pool_err = rel_err(lib_pooled.float(), plain_pooled.float())
    # the library folds the norm as (x - mean)·rstd·scale + bias, the plain
    # version as x·a + b: a rounding apart (a bfloat16 ulp is 2^-8)
    if pool_err > (1e-5 if dtype == torch.float32 else 2.0 ** -7):
        raise AssertionError(f"12a: PyTorch's pool of {dtype} is {pool_err} from "
                             f"the plain version's")
    del lib_pooled, plain_pooled
    cases = {
        "kernel": {
            "bn_apply8": lambda: bn_minres8.launch_apply8(x, a, b, mean, rstd),
            "bn_bwd8": lambda: bn_minres8.launch_bwd8(xq, dy, s, t),
            "bn_dx8": lambda: bn_minres8.launch_dx8(xq, dy, k, s, t),
            "pool_code": lambda: pool_minres.launch_pool_code(x, a, b),
            "pool_scatter": lambda: pool_minres.launch_pool_scatter(g, code, h, w),
            # row 7, the stem's forward, beside the code kernel it shared
            # its thread a window with
            "stem_fwd": lambda: stem.launch_stem_fwd(x, a, b)},
        "plain": {
            "bn_apply8": lambda: bn_minres8.apply8_reference(x, a, b, mean, rstd),
            "bn_bwd8": lambda: bn_minres8.bwd8_reference(xq, dy, s, t),
            "bn_dx8": lambda: bn_minres8.dx8_reference(xq, dy, k, s, t),
            "pool_code": lambda: pool_minres.pool_code_reference(x, a, b),
            "pool_scatter": lambda: pool_minres.pool_scatter_reference(g, code, h, w)},
        "library": {
            "pool_code": lambda: _library_pool(x4, scale, bias, mean, var),
            "pool_scatter": lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                g4, z, [3, 3], [2, 2], [1, 1], [1, 1], False, idx)},
    }
    order = ("plain", "library", "kernel")
    out = {}
    for who in order + order[::-1]:
        times = {key: _median_ms(f, reps=7, warmup=2) for key, f in cases[who].items()}
        out[who] = {key: min(v, out.get(who, {}).get(key, v)) for key, v in times.items()}
    row7 = out["kernel"]["stem_fwd"]
    for who in order:
        out[who] = {key: out[who].get(key) for key in OPTIONS_TIMED}
    out["kernel"]["stem_fwd"] = row7
    name = str(dtype).removeprefix("torch.")
    ms = lambda v: "-" if v is None else f"{v:.3f}"
    _say_time(f"[12 times] {STEM_FULL} {name}, ms (kernel / plain / library), "
              f"median of 7 after warm-up, better of two turns, on {smi}: "
              + "; ".join(f"{key} {ms(out['kernel'][key])} / {ms(out['plain'][key])}"
                          f" / {ms(out['library'][key])}" for key in OPTIONS_TIMED)
              + f"; stem_fwd (row 7, kernel) {row7:.3f}")
    for key, (tb, by) in _bn8_bounds(STEM_FULL, dtype).items():
        _say_time(f"[12 times] bound {key} {name}: {tb:.3f} ms, set by {by} "
                  f"(3.35 TB/s, 67 TFLOP/s fp32)")
    return out


def _options_kernels(worst: dict, smi: str) -> dict:
    """12a: the five kernels against their plain versions, then their
    times."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(4)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in RN18_NORMS + ((3, 5, 7, 2064), (2, 3, 5, 24)):
            _hold_bn8(shape, dtype, gen, worst)
            torch.cuda.empty_cache()
        for (n, h, w, c), mode in POOL_SHAPES:
            if c == "256v":
                c = 256 * stem.vector_width(dtype)
            _hold_pool((n, h, w, c), dtype, gen, worst, mode)
            torch.cuda.empty_cache()
    _pool_code_report(smi)
    _hold_e4m3_edges()
    # the scatter and the code refuse what they cannot take
    for bad in (lambda: pool_minres.launch_pool_code(
                    torch.zeros((2, 7, 8, 16), device="cuda"),
                    torch.ones(16, device="cuda"), torch.ones(16, device="cuda")),
                lambda: bn_minres8.launch_bwd8(
                    torch.zeros((2, 4, 4, 16), device="cuda"),
                    torch.zeros((2, 4, 4, 16), device="cuda"),
                    torch.ones(16, device="cuda"), torch.ones(16, device="cuda"))):
        try:
            bad()
        except ValueError:
            continue
        raise AssertionError("12a: a wrapper took an odd H or a float32 xq")
    print(f"[12 options] 12a kernels held in {time.perf_counter() - t0:.1f} s")
    times = {dtype: _time_options(dtype, smi)
             for dtype in (torch.float32, torch.bfloat16)}
    torch.cuda.empty_cache()
    return times


def _options_driver() -> dict:
    """12b: main_3dident --norm-kind minres8 at full width, then its
    captured step against its eager step. Returns the launches of the
    driver's run."""
    t0 = time.perf_counter()
    unsup = ["--mode", "unsupervised", "--n-log-steps", "100",
             "--n-eval-samples", "1024"]
    first, _, _ = _run_3dident("12b default (minres), 1 step",
                               unsup + ["--iterations", "1"])
    out, grew, secs = _run_3dident("12b --norm-kind minres8",
                                   unsup + ["--norm-kind", "minres8",
                                            "--iterations", "10"])
    losses = out["losses"]
    print(f"[12 options] 12b main_3dident --norm-kind minres8, ResNet18 B=512: "
          f"losses {[round(v, 6) for v in losses]}; step 1 "
          f"{'bit-equal' if losses[0] == first['losses'][0] else 'DIFFERS'} to "
          f"minres's ({first['losses'][0]!r}); launches {grew}")
    want = {k: 10 * MINRES8_STEP.get(k, 0) for k in COUNTERS}
    if grew != want:
        raise AssertionError(f"12b minres8: launches {grew}, expected {want}")
    if losses[0] != first["losses"][0] or not _falling(losses):
        raise AssertionError(f"12b minres8: {losses} (minres {first['losses']})")
    args = main_3dident.parse_args(_RUN3D + ["--mode", "unsupervised"])
    sampler = ThreeDIdentBatchSampler(
        FIXTURE, main_3dident.setup_latent_space(args)[0], 512, device="cuda")
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _hold_capture("main_3dident --scan --norm-kind minres8 ResNet18 B=512",
                      functools.partial(_3dident_capture_lane, sampler,
                                        "--norm-kind", "minres8"),
                      MINRES8_STEP, 4)
    finally:
        torch.backends.cudnn.deterministic = was
    del sampler
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[12 options] 12b {time.perf_counter() - t0:.1f} s")
    return grew


def _grads_of(model, x):
    """(output, {name: grad}, {name: buffer}) of one training forward and
    the backward of the sum of squares of the output."""
    out = model(x)
    out.square().sum().backward()
    return (out.detach(), {k: p.grad for k, p in model.named_parameters()},
            {k: v.clone() for k, v in model.named_buffers()})


def _rel_max(got: dict, want: dict) -> float:
    """The largest rel_err over the tensors of ``want`` (none all zero)."""
    return max(rel_err(got[k].double(), want[k].double())
               for k in want if want[k].abs().max() > 0)


def _hold_stem_route() -> None:
    """12c: the default minres stem (MinResBNPool, on bn_relu_pool's
    kernels) against the composition MinResBN2d -> F.max_pool2d at
    STEM_FULL, float32 and bfloat16: the pooled map and the running buffers
    bit for bit, the gradients' largest gaps (x, scale, bias) within two
    bfloat16 ulps or 1e-5 of the largest, and each side's launches."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    n, h, w, c = STEM_FULL
    scale = 1.0 + 0.3 * torch.randn(c, device="cuda", generator=gen)
    bias = 0.2 * torch.randn(c, device="cuda", generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((n, c, h, w), device="cuda", generator=gen).to(
            dtype).contiguous(memory_format=torch.channels_last)
        g = torch.randn((n, c, h // 2, w // 2), device="cuda", generator=gen).to(
            dtype).contiguous(memory_format=torch.channels_last)
        sides = []
        for fused in (True, False):
            norm = (MinResBNPool(c) if fused else MinResBN2d(c)).cuda().train()
            with torch.no_grad():
                norm.weight.copy_(scale)
                norm.bias.copy_(bias)
            xs = x.detach().requires_grad_()
            infonce.reset_launch_counts()
            p = norm(xs) if fused else F.max_pool2d(norm(xs), 3, 2, 1)
            p.backward(g)
            torch.cuda.synchronize()
            sides.append(((p.detach(), norm.running_mean, norm.running_var),
                          (xs.grad, norm.weight.grad, norm.bias.grad),
                          {k: v for k, v in infonce.launch_counts().items() if v}))
            del xs, p, norm
        (vals, grads, grew), (want_vals, want_grads, want_grew) = sides
        same = all(torch.equal(a, b) for a, b in zip(vals, want_vals))
        gaps = [rel_err(a.double(), b.double()) for a, b in zip(grads, want_grads)]
        bar = 2 * 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
        print(f"[12 options] 12c the default stem vs MinResBN2d -> F.max_pool2d at "
              f"{STEM_FULL} {dtype}: pooled and running buffers "
              f"{'bit-equal' if same else 'DIFFER'}; gradient gaps (x, scale, bias) "
              + ", ".join(f"{e:.3e}" for e in gaps) + f" (bar {bar:g}); launches "
              f"{grew} against {want_grew}")
        if (not same or max(gaps) > bar
                or grew != {"bn_stats": 1, "pool_code": 1, "pool_scatter": 1,
                            "bn_bwd": 1, "bn_dx": 1}
                or want_grew != dict.fromkeys(BN, 1)):
            raise AssertionError(f"12c stem route {dtype}: same {same}, gaps {gaps}, "
                                 f"launches {grew} / {want_grew}")
        del sides, vals, grads, want_vals, want_grads, x, g
        torch.cuda.empty_cache()


def _options_models() -> dict:
    """12c: the model options at full width, ResNet18 on 1024 images of
    224x224 (B = 512 pairs), one training forward and backward each:
    stem_pool='argmax' and the composition MinResBN2d -> F.max_pool2d
    against the default stem (output 1e-5, gradients 1e-4 relative, the
    running buffers), the stem alone against that composition
    (_hold_stem_route), s2d_exact against conv7 on the same
    weights (the net's output, and the stem's output and weight gradient
    against float64), remat against none bit for bit (cudnn.deterministic, the
    buffers included; the launches of the recompute counted) and s2d
    finite. Returns the argmax run's launches."""
    from cl_ica_tpu_torch.models import ResNet18
    from cl_ica_tpu_torch.models.resnet import s2d_exact_weight, space_to_depth

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn((2 * OPTIONS_B, 3, 224, 224), device="cuda", generator=gen)

    def run(plain_stem=False, **kw):
        model = ResNet18(num_classes=110, generator=torch.Generator().manual_seed(0),
                         **kw)
        if plain_stem:  # the composition MinResBN2d -> F.max_pool2d
            model.bn_init = MinResBN2d(64)
        model = model.cuda().train()
        infonce.reset_launch_counts()
        out = _grads_of(model, x)
        torch.cuda.synchronize()
        grew = {k: v for k, v in infonce.launch_counts().items() if v}
        del model
        return out, grew

    (o_x, g_x, b_x), grew_x = run(norm_kind="minres")
    (o_a, g_a, b_a), grew_a = run(norm_kind="minres", stem_pool="argmax")
    (o_c, g_c, b_c), grew_c = run(plain_stem=True, norm_kind="minres")
    for tag, (o, g, b), grew, want in (
            ("stem_pool='argmax' vs 'xla'", (o_a, g_a, b_a), grew_a, MINRES_STEP),
            ("the composition MinResBN2d -> F.max_pool2d vs the default stem",
             (o_c, g_c, b_c), grew_c, {**dict.fromkeys(BN, BN_NORMS_A_STEP),
                                       "bn_junctions": BN_JUNCTIONS_A_STEP})):
        e_out, e_grad, e_buf = rel_err(o, o_x), _rel_max(g, g_x), _rel_max(b, b_x)
        print(f"[12 options] 12c {tag} (minres): output rel {e_out:.2e}, "
              f"gradients rel {e_grad:.2e}, running buffers rel {e_buf:.2e}; "
              f"launches {grew} (default: {grew_x})")
        if (e_out > VALUE_BAR or e_grad > GRAD_BAR or e_buf > VALUE_BAR
                or grew != want or grew_x != MINRES_STEP):
            raise AssertionError(f"12c {tag}: {e_out}, {e_grad}, {e_buf}, {grew}")
    del g_c, b_c
    _hold_stem_route()
    (o_e, _, _), _ = run(norm_kind="minres", stem="s2d_exact")
    e_out = rel_err(o_e, o_x)
    del g_x, b_x
    # the stem itself, conv7 and the 4x4 kernel over the space-to-depth
    # input, on the same weight and images: output and weight gradient
    # (under one upstream gradient) against float64. The whole net's
    # gradients are no yardstick here: at its initial norms a 1e-6 change
    # of the forward moved some leaves' gradients by 6e-3 (measured on the
    # H100 at these inputs), through the norms' cancellations
    w = ResNet18(num_classes=110, generator=torch.Generator().manual_seed(0)
                 ).conv_init.weight.detach().cuda().requires_grad_()
    gy = torch.randn((2 * OPTIONS_B, 64, 112, 112), device="cuda", generator=gen)
    routes = {"conv7": lambda v, k: F.conv2d(v, k, None, 2, 3),
              "s2d_exact": lambda v, k: F.conv2d(F.pad(space_to_depth(v), (2, 1, 2, 1)),
                                                 s2d_exact_weight(k))}
    with torch.no_grad():
        y64 = routes["conv7"](x[:64].double(), w.double())
    g64 = torch.nn.grad.conv2d_weight(x.double(), w.shape, gy.double(), stride=2,
                                      padding=3)
    stem_err = {}
    for name, f in routes.items():
        y = f(x, w)
        (gw,) = torch.autograd.grad(y, w, gy)
        stem_err[name] = (rel_err(y[:64].detach().double(), y64),
                          rel_err(gw.double(), g64))
        del y, gw
    del g64, gy
    (f7, w7), (fs, ws) = stem_err["conv7"], stem_err["s2d_exact"]
    print(f"[12 options] 12c stem='s2d_exact' vs conv7 on the same weights: "
          f"the net's output rel {e_out:.2e}; the stem against float64, "
          f"output (64 images) {fs:.2e} (conv7 {f7:.2e}), weight gradient "
          f"{ws:.2e} (conv7 {w7:.2e})")
    if (e_out > VALUE_BAR or fs > max(2 * f7, VALUE_BAR)
            or ws > max(2 * w7, GRAD_BAR)):
        raise AssertionError(f"12c s2d_exact: {e_out}, {stem_err}")
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        (o_n, g_n, b_n), grew_n = run(norm_kind="minres")
        (o_r, g_r, b_r), grew_r = run(norm_kind="minres", remat=True)
    finally:
        torch.backends.cudnn.deterministic = was
    same = (torch.equal(o_r, o_n) and all(torch.equal(g_r[k], g_n[k]) for k in g_n)
            and all(torch.equal(b_r[k], b_n[k]) for k in b_n))
    print(f"[12 options] 12c remat=True vs none (cudnn.deterministic): output, "
          f"{len(g_n)} gradients and {len(b_n)} buffers "
          f"{'bit-equal' if same else 'DIFFER'}; launches {grew_r} (the "
          f"recompute runs the 19 block norms' statistics and apply again; "
          f"none: {grew_n})")
    recompute = BN_NORMS_A_STEP - 1
    want_r = {**grew_n, "bn_stats": grew_n["bn_stats"] + recompute,
              "bn_apply": grew_n["bn_apply"] + recompute}
    if not same or grew_r != want_r:
        raise AssertionError(f"12c remat: same {same}, launches {grew_r}")
    del g_n, b_n, g_r, b_r, g_a, b_a
    (o_s, g_s, _), _ = run(norm_kind="minres", stem="s2d")
    finite = bool(torch.isfinite(o_s).all()) and all(
        bool(torch.isfinite(v).all()) for v in g_s.values())
    print(f"[12 options] 12c stem='s2d': output {tuple(o_s.shape)}, output and "
          f"gradients {'finite' if finite else 'NOT finite'}")
    if not finite:
        raise AssertionError("12c s2d: not finite")
    del x, g_s
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[12 options] 12c {time.perf_counter() - t0:.1f} s")
    return {k: v for k, v in grew_a.items() if k in POOL}


def _options_steps(smi: str) -> None:
    """12d: step ms and peak GiB of main_3dident's unsupervised step, minres
    against minres8 and the xla stem pool against argmax, in turns, float32
    and --bf16."""
    args = main_3dident.parse_args(_RUN3D + ["--mode", "unsupervised"])
    sampler = ThreeDIdentBatchSampler(
        FIXTURE, main_3dident.setup_latent_space(args)[0], 512, device="cuda")
    paths = {"minres": ((), "xla"), "minres8": (("--norm-kind", "minres8"), "xla"),
             "argmax": ((), "argmax")}
    turns = ("minres", "minres8", "argmax", "argmax", "minres8", "minres")
    for bf16 in (False, True):
        runs = [_step3d_pairs_per_sec(sampler, paths[k][0], bf16, paths[k][1])
                for k in turns]
        _say_time(f"[12 times] 3DIdent step, ResNet18 B=512 "
                  f"{'--bf16' if bf16 else 'float32, TF32 off'}, 10 steady "
                  f"steps, ms a step (peak GiB) in turns "
                  + ", ".join(f"{k} {512e3 / p:.3f} ({m:.3f})"
                              for k, (p, m) in zip(turns, runs))
                  + f" on {smi}")
    del sampler


def phase_options(worst: dict, smi: str) -> tuple[dict, dict]:
    """Phase 12. Returns the main paths' launches (12b, 12c) and 12a's
    times."""
    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(FIXTURE, "raw_latents.npy")):
        phase_fixture()
    times = _options_kernels(worst, smi)
    launches = _options_driver()
    for k, v in _options_models().items():
        launches[k] = launches.get(k, 0) + v
    _options_steps(smi)
    print(f"[12 options] {time.perf_counter() - t0:.1f} s")
    return launches, times


# ---------------------------------------------------------------------------
# phase 13: the rest (--profile-dir, the CL_ICA_TPU_DEBUG=1 guards, the
# coupling flows, the SlowVAE loss and its decoder, the positional encoding,
# the latents tool)
# ---------------------------------------------------------------------------

REST_DIR = os.path.join(OUT_DIR, "13_rest")
# the symbols of each launch counter's main kernel (its reduce kernels
# aside): the tiled kernel or the first version, whichever the library runs
TRACE_SYMBOLS = {
    "fwd": ("neg_lse_fwd_tiled", "neg_lse_fwd_kernel"),
    "dz1": ("neg_lse_grad_kernel", "neg_lse_dz1_kernel"),
    "dz3": ("neg_lse_grad_kernel", "neg_lse_dz3_kernel"),
    "dot_fwd": ("dot_lse_fwd_tiled", "dot_lse_fwd_kernel"),
    "dot_dz1": ("dot_lse_grad_kernel", "dot_lse_dz1_kernel"),
    "dot_dz3": ("dot_lse_grad_kernel", "dot_lse_dz3_kernel"),
    "stem_fwd": ("stem_fwd_kernel",), "stem_bwd": ("stem_bwd_kernel",),
    "stem_dx": ("stem_dx_kernel",), "bn_stats": ("bn_stats_kernel",),
    "bn_apply": ("bn_apply_kernel",), "bn_bwd": ("bn_bwd_kernel",),
    "bn_dx": ("bn_dx_kernel",), "pool_code": ("pool_code_kernel",),
    "pool_scatter": ("pool_scatter_kernel",),
}
MAIN_SYMBOLS = sorted({sym for syms in TRACE_SYMBOLS.values() for sym in syms})
REST_MLP = BOX + ["--n-steps", "201", "--more-unsupervised", "1", "--n-log-steps",
                  "100", "--save-every", "201"]
REST_KITTI_STEPS = 200
REST_3D_STEPS = 5


@contextlib.contextmanager
def _debug_flag(value):
    """CL_ICA_TPU_DEBUG set to ``value`` (None: unset) within."""
    was = os.environ.pop("CL_ICA_TPU_DEBUG", None)
    if value is not None:
        os.environ["CL_ICA_TPU_DEBUG"] = value
    try:
        yield
    finally:
        os.environ.pop("CL_ICA_TPU_DEBUG", None)
        if was is not None:
            os.environ["CL_ICA_TPU_DEBUG"] = was


def _trace_kernels(prof_dir: str) -> tuple[dict, int, int]:
    """The one trace under ``prof_dir``, parsed: (count of each main kernel
    symbol among its CUDA kernel events, its kernel events, its bytes)."""
    paths = [os.path.join(prof_dir, f) for f in os.listdir(prof_dir)
             if f.endswith(".pt.trace.json")]
    if len(paths) != 1:
        raise AssertionError(f"13a: {len(paths)} traces under {prof_dir}")
    with open(paths[0]) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    found = {sym: sum(sym in name for name in kernels) for sym in MAIN_SYMBOLS}
    return found, len(kernels), os.path.getsize(paths[0])


def _hold_trace(tag: str, prof_dir: str, grew: dict) -> int:
    """The trace's kernel events name every hand-written kernel the run
    launched, as many times as the launch counters counted (each counter's
    launch is one main kernel). Returns the trace's bytes."""
    found, n_kernels, size = _trace_kernels(prof_dir)
    seen = {sym: n for sym, n in found.items() if n}
    launched = {k: v for k, v in grew.items() if v and k in KERNELS}
    print(f"[13 rest] 13a {tag}: trace {size / 1e6:.1f} MB, {n_kernels} CUDA "
          f"kernel events; hand-written kernels in it {seen}; launch counters "
          f"{launched}")
    missing = [k for k in launched
               if not any(found[sym] for sym in TRACE_SYMBOLS[k])]
    if missing or sum(found.values()) != sum(launched.values()):
        raise AssertionError(
            f"13a {tag}: the trace's kernel events {seen} do not account for the "
            f"launches {launched} (missing {missing}); the trace holds "
            f"{n_kernels} kernel events in all")
    return size


def _overhead(tag: str, step, steps: int, prof_dir: str, smi: str) -> None:
    """ms a step of ``step`` (a warmed-up lane), without and with the
    profiler (utils.profiling.trace_context), in turns."""
    from cl_ica_tpu_torch.utils import trace_context

    ms = {"plain": [], "profiled": []}
    export = []
    for kind in ("plain", "profiled", "profiled", "plain"):
        ctx = (trace_context(os.path.join(prof_dir, f"turn{len(export)}"), "cuda")
               if kind == "profiled" else contextlib.nullcontext())
        t_enter = time.perf_counter()
        with ctx:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            ms[kind].append((time.perf_counter() - t0) * 1e3 / steps)
            t_loop = time.perf_counter()
        if kind == "profiled":
            export.append(time.perf_counter() - t_loop)
    _say_time(f"[13 times] {tag}, {steps} steps a turn (plain, profiled, "
              f"profiled, plain), ms a step: plain "
              + ", ".join(f"{v:.4f}" for v in ms["plain"]) + "; profiled "
              + ", ".join(f"{v:.4f}" for v in ms["profiled"])
              + "; the trace's stop and export " + ", ".join(f"{v:.2f}" for v in export)
              + f" s; on {smi}")


def _rest_mlp(smi: str) -> dict:
    """13a's main_mlp 4b (box + Laplace p=1, B=6144), 201 steps at
    --n-log-steps 100, with and without --profile-dir: the lane's losses
    (its phase-boundary checkpoint) and scores bit-equal, the trace."""
    runs = {}
    for tag in ("plain", "profiled"):
        save = os.path.join(REST_DIR, f"mlp_{tag}")
        prof = os.path.join(REST_DIR, f"mlp_{tag}_trace")
        shutil.rmtree(save, ignore_errors=True)
        shutil.rmtree(prof, ignore_errors=True)
        argv = REST_MLP + ["--save-dir", save] + (
            ["--profile-dir", prof] if tag == "profiled" else [])
        infonce.reset_launch_counts()
        t0 = time.perf_counter()
        scores = main_mlp.main(argv, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        grew = infonce.launch_counts()
        _, state = checkpoint.load_resume_state(os.path.join(save, "resume"))
        runs[tag] = (state["lane"]["losses"], scores, grew, secs, prof)
    (lp, sp, gp, tp, _), (lq, sq, gq, tq, prof) = runs["plain"], runs["profiled"]
    size = _hold_trace("main_mlp 4b (box p=1) B=6144, 201 steps", prof, gq)
    print(f"[13 rest] 13a main_mlp 4b: {len(lq)} losses "
          f"{'bit-equal' if lq == lp else 'DIFFER'} with and without the "
          f"profiler, scores {sq} / {sp}; run {tq:.1f} s / {tp:.1f} s; trace "
          f"{size / 1e6:.1f} MB on {smi}")
    want = {k: 201 if k in LP else 0 for k in COUNTERS}
    if gq != want or gp != want:
        raise AssertionError(f"13a main_mlp: launches {gq} / {gp}, expected {want}")
    if lq != lp or sq != sp or len(lq) != 201:
        raise AssertionError("13a main_mlp: the profiled run differs")
    return gq


def _rest_kitti(smi: str) -> dict:
    """13a's main_kitti default (ConvEncoder64, batch 64, z_dim 10, p=1),
    200 steps, with and without --profile-dir, under cudnn.deterministic:
    the logs and the final checkpoint's parameters bit-equal, the trace."""
    if not os.path.exists(os.path.join(KITTI_CORPUS, kitti.FNAME)):
        phase_kitti_corpus()
    runs = {}
    for tag in ("plain", "profiled"):
        out = os.path.join(REST_DIR, f"kitti_{tag}")
        prof = os.path.join(REST_DIR, f"kitti_{tag}_trace")
        shutil.rmtree(out, ignore_errors=True)
        shutil.rmtree(prof, ignore_errors=True)
        argv = _RUNK + ["--max-iter", str(REST_KITTI_STEPS), "--log-step", "100",
                        "--output-dir", os.path.join(out, "out"),
                        "--ckpt-dir", os.path.join(out, "ck")] + (
            ["--profile-dir", prof] if tag == "profiled" else [])
        infonce.reset_launch_counts()
        main_kitti.main(argv, device="cuda")
        torch.cuda.synchronize()
        grew = infonce.launch_counts()
        run = os.path.join(out, "out", "kittimasks_1", "1_0", "0")
        with open(os.path.join(run, "log.csv")) as fh:
            log = fh.read()
        ckpt = kitti_solver.load_checkpoint_file(
            os.path.join(out, "ck", "kittimasks_1", "1_0", "0", "last"))
        runs[tag] = (log, ckpt["model_states"]["net"], grew, prof)
    (lp, np_, gp, _), (lq, nq, gq, prof) = runs["plain"], runs["profiled"]
    same = all(torch.equal(nq[k], np_[k]) for k in np_)
    size = _hold_trace("main_kitti default B=64, 200 steps", prof, gq)
    print(f"[13 rest] 13a main_kitti: log.csv {'equal' if lq == lp else 'DIFFERS'}, "
          f"final parameters {'bit-equal' if same else 'DIFFER'} with and "
          f"without the profiler; trace {size / 1e6:.1f} MB on {smi}")
    want = {k: REST_KITTI_STEPS if k in LP else 0 for k in COUNTERS}
    if gq != want or gp != want:
        raise AssertionError(f"13a main_kitti: launches {gq} / {gp}, expected {want}")
    if lq != lp or not same:
        raise AssertionError("13a main_kitti: the profiled run differs")
    return gq


def _rest_3dident(smi: str) -> dict:
    """13a's main_3dident default path (ResNet18 minres, B=512, phase 6's
    fixture), 5 eager steps, with and without --profile-dir, under
    cudnn.deterministic: losses and evaluation bit-equal, the trace."""
    if not os.path.exists(os.path.join(FIXTURE, "raw_latents.npy")):
        phase_fixture()
    runs = {}
    for tag in ("plain", "profiled"):
        prof = os.path.join(REST_DIR, f"3dident_{tag}_trace")
        shutil.rmtree(prof, ignore_errors=True)
        argv = ["--mode", "unsupervised", "--iterations", str(REST_3D_STEPS),
                "--n-log-steps", str(REST_3D_STEPS), "--n-eval-samples", "1024"] + (
            ["--profile-dir", prof] if tag == "profiled" else [])
        out, grew, secs = _run_3dident(f"13a {tag}", argv)
        runs[tag] = (out, grew, secs, prof)
    (op, gp, tp, _), (oq, gq, tq, prof) = runs["plain"], runs["profiled"]
    size = _hold_trace("main_3dident default ResNet18 B=512, 5 steps", prof, gq)
    same = oq["losses"] == op["losses"] and oq["mcc"] == op["mcc"]
    print(f"[13 rest] 13a main_3dident: losses {oq['losses']} "
          f"{'bit-equal' if same else 'DIFFER'} with and without the profiler "
          f"(MCC {oq['mcc']} / {op['mcc']}); run {tq:.1f} s / {tp:.1f} s; trace "
          f"{size / 1e6:.1f} MB on {smi}")
    want = {**dict.fromkeys(COUNTERS, 0), **dict.fromkeys(LP + DOT, REST_3D_STEPS),
            **{k: v * REST_3D_STEPS for k, v in MINRES_STEP.items()}}
    if gq != want or gp != want:
        raise AssertionError(f"13a main_3dident: launches {gq} / {gp}, expected {want}")
    if not same:
        raise AssertionError("13a main_3dident: the profiled run differs")
    return gq


def _rest_overheads(smi: str) -> None:
    """The profiler's cost a step: the captured main_mlp and main_kitti
    lanes and the eager main_3dident step, each without and with a trace,
    in turns."""
    prof = os.path.join(REST_DIR, "overhead_traces")
    shutil.rmtree(prof, ignore_errors=True)
    step, _ = _mlp_capture_lane("box")
    for _ in range(WARMUP_STEPS + 1):
        step()
    _overhead(f"main_mlp 4b captured step B={BATCH}", step, 200,
              os.path.join(prof, "mlp"), smi)
    step, _ = _kitti_capture_lane()
    for _ in range(WARMUP_STEPS + 1):
        step()
    _overhead("main_kitti default captured step B=64", step, 200,
              os.path.join(prof, "kitti"), smi)
    args = main_3dident.parse_args(_RUN3D + ["--mode", "unsupervised"])
    sampler = ThreeDIdentBatchSampler(
        FIXTURE, main_3dident.setup_latent_space(args)[0], 512, device="cuda")
    step, _ = _3dident_capture_lane(sampler)
    for _ in range(2):
        _eager(step)
    _overhead("main_3dident default eager step ResNet18 B=512",
              lambda: _eager(step), 5, os.path.join(prof, "3dident"), smi)
    del sampler, step
    gc.collect()
    torch.cuda.empty_cache()


def _mlp_rest_lane(nan: bool = False):
    """A main_mlp 4b lane at seed 0 in its unsupervised phase, its encoder's
    first weight NaN with ``nan``."""
    args = main_mlp.parse_args(CONFIGS["box"])
    dev = torch.device("cuda")
    lane = main_mlp.Lane(args, 0, dev, main_mlp.build_latent_space(args, dev),
                         main_mlp.make_loss(args))
    lane.start_phase(False, args.n_steps)
    if nan:
        with torch.no_grad():
            lane.f.linears[0].weight.fill_(float("nan"))
    return lane


def _raises(tag: str, fn, error, needle: str) -> None:
    try:
        fn()
    except error as err:
        if needle not in str(err):
            raise AssertionError(f"13b {tag}: {type(err).__name__} {err!r} does not "
                                 f"name {needle!r}") from err
        print(f"[13 rest] 13b {tag}: {type(err).__name__}: {err}")
        return
    raise AssertionError(f"13b {tag}: no {error.__name__}")


def _rest_guards() -> None:
    """13b: CL_ICA_TPU_DEBUG=1 on the card. main_mlp 4b's captured lane, 200
    steps in windows of 100, with the flag against without: losses and
    parameters bit-equal and the same launches a replay, every replay under
    sync debug mode "error" (the guard reads the window after it); then a
    NaN encoder weight raises at the first window boundary in main_mlp
    (captured) and main_kitti (captured), at the first step in main_3dident
    (eager), and main_3dident --scan exits naming the flag."""
    lanes = {}
    for flag in (None, "1"):
        with _debug_flag(flag):
            lane = _mlp_rest_lane()
            captured = lane.step

            def strict(captured=captured):
                torch.cuda.set_sync_debug_mode("error" if captured.captured else 0)
                try:
                    return captured()
                finally:
                    torch.cuda.set_sync_debug_mode(0)

            lane.step = strict
            for n in (WARMUP_STEPS + 1, 100, 100 - WARMUP_STEPS - 1):
                main_mlp.train_steps([lane], n)
            lanes[flag] = (lane, captured)
    (off, cap_off), (on, cap_on) = lanes[None], lanes["1"]
    pairs = list(zip(off.f.parameters(), on.f.parameters()))
    same = sum(torch.equal(a, b) for a, b in pairs)
    print(f"[13 rest] 13b main_mlp 4b captured lane, 200 steps: losses "
          f"{'bit-equal' if off.losses == on.losses else 'DIFFER'} and {same} of "
          f"{len(pairs)} parameters bit-equal with CL_ICA_TPU_DEBUG=1 and without; "
          f"launches a replay {cap_on.per_replay} / {cap_off.per_replay}; replays "
          f"under sync debug mode 'error'")
    if (off.losses != on.losses or same != len(pairs) or len(on.losses) != 200
            or cap_on.per_replay != cap_off.per_replay or not cap_on.captured):
        raise AssertionError("13b: the flag changed the captured main_mlp lane")
    del lanes, off, on, pairs
    with _debug_flag("1"):
        lane = _mlp_rest_lane(nan=True)
        _raises("main_mlp 4b captured, NaN weight",
                lambda: main_mlp.train_steps([lane], 10), ValueError,
                "non-finite values in loss")
        if not lane.step.captured or lane.losses:
            raise AssertionError("13b main_mlp: the NaN window was not the captured "
                                 "one, or a loss was kept")
        build = kitti_solver.ConvEncoder64

        def nan_encoder(*a, **kw):
            net = build(*a, **kw)
            with torch.no_grad():
                net.convs[0].weight.fill_(float("nan"))
            return net

        kitti_solver.ConvEncoder64 = nan_encoder
        try:
            args = _kitti_args("13b_nan", "--max-iter", "20", "--log-step", "10")
            solver = kitti_solver.Solver(args, kitti.return_data(args)[0], "cuda")
            _raises("main_kitti default captured, NaN weight", solver.train,
                    ValueError, "non-finite values in loss")
        finally:
            kitti_solver.ConvEncoder64 = build
        if not solver.steps[0].captured or solver.global_iter != 10:
            raise AssertionError(f"13b main_kitti: raised at step "
                                 f"{solver.global_iter}, not at the window's end")
        build3 = main_3dident.build_encoder
        forwards = [0]

        def nan_model(*a, **kw):
            model = build3(*a, **kw)
            with torch.no_grad():
                model.dense.weight.fill_(float("nan"))
            model.register_forward_pre_hook(
                lambda m, i: forwards.__setitem__(0, forwards[0] + torch.is_grad_enabled()))
            return model

        main_3dident.build_encoder = nan_model
        try:
            _raises("main_3dident default eager, NaN weight",
                    lambda: main_3dident.main(_RUN3D + ["--mode", "unsupervised",
                                                        "--iterations", "3"],
                                              device="cuda"),
                    ValueError, "non-finite values in unsupervised loss")
        finally:
            main_3dident.build_encoder = build3
        if forwards[0] != 1:
            raise AssertionError(f"13b main_3dident: {forwards[0]} steps ran")
        _raises("main_3dident --scan",
                lambda: main_3dident.main(_RUN3D + ["--mode", "unsupervised",
                                                    "--scan"], device="cuda"),
                SystemExit, "CL_ICA_TPU_DEBUG")
    gc.collect()
    torch.cuda.empty_cache()


def _rest_modules(smi: str) -> None:
    """13c: the new modules on the card, each against the same call on the
    CPU."""
    from cl_ica_tpu_torch.losses import SlowVAELoss
    from cl_ica_tpu_torch.models import (
        ConvDecoder64,
        PositionalEncoding2D,
        get_flow,
    )
    from cl_ica_tpu_torch.tools import generate_3dident_latents

    gen = lambda seed: torch.Generator().manual_seed(seed)
    x = torch.randn(BATCH, N_FEAT, generator=gen(1))
    for coupling in ("gin", "glow"):
        flow = get_flow(N_FEAT, N_FEAT, coupling_block=coupling, generator=gen(0))
        out = {}
        with torch.no_grad():
            for dtype in (torch.float32, torch.float64):
                for key, device in (("cpu", "cpu"), ("card", "cuda")):
                    f = copy.deepcopy(flow).to(device=device, dtype=dtype)
                    y, ld = f.forward_with_logdet(x.to(device=device, dtype=dtype))
                    out[key, dtype] = (y.cpu().double(), ld.cpu().double(),
                                       f.inverse(y).cpu().double())
        (y64, ld64, back64), x64 = out["card", torch.float64], x.double()
        # the same function: float64 on the card against float64 on the CPU
        # (GIN's log-det is 0 up to rounding: its difference, absolute)
        y64_cpu, ld64_cpu, back64_cpu = out["cpu", torch.float64]
        same = max(rel_err(y64, y64_cpu), rel_err(back64, back64_cpu),
                   rel_err(ld64, ld64_cpu) if coupling == "glow"
                   else float((ld64 - ld64_cpu).abs().max()))
        rt64 = rel_err(back64, x64)
        # float32 on each device against float64: at 8 blocks the flow's
        # outputs reach 1e5 and float32 keeps fewer digits than 1e-5 of them
        # on either device, so the card is held to the CPU's float32 accuracy
        # (within a factor 4: two roundings of one ill-conditioned sample)
        acc = {dev: (rel_err(out[dev, torch.float32][0], y64),
                     rel_err(out[dev, torch.float32][1], ld64)
                     if coupling == "glow" else
                     float(out[dev, torch.float32][1].abs().max()))
               for dev in ("cpu", "card")}
        y32, ld32 = out["card", torch.float32][:2]
        cross = (rel_err(y32, out["cpu", torch.float32][0]),
                 rel_err(ld32, out["cpu", torch.float32][1]) if coupling == "glow"
                 else float(ld32.abs().max()))
        rt32 = rel_err(out["card", torch.float32][2], x64)
        print(f"[13 rest] 13c {coupling.upper()} CouplingFlow n={N_FEAT}, 8 blocks, "
              f"B={BATCH}, max |y| {float(y64.abs().max()):.3g}: float64 card vs CPU "
              f"{same:.2e}, inverse∘forward {rt64:.2e}; float32 against float64, "
              f"forward / log-det{' (max |.|)' if coupling == 'gin' else ''}: card "
              f"{acc['card'][0]:.2e} / {acc['card'][1]:.2e}, CPU {acc['cpu'][0]:.2e} / "
              f"{acc['cpu'][1]:.2e}; float32 card vs CPU {cross[0]:.2e} / "
              f"{cross[1]:.2e}; float32 inverse∘forward {rt32:.2e}")
        worse = [acc["card"][i] > max(4 * acc["cpu"][i], VALUE_BAR) for i in (0, 1)]
        if same > VALUE_BAR or rt64 > VALUE_BAR or any(worse):
            raise AssertionError(f"13c {coupling}: {same}, {rt64}, {acc}")

    # SlowVAE at main_mlp's width: get_mlp encoders with 2n outputs, an MLP
    # decoder, the frozen mixing, the same noise on both devices
    class FixedNoise(SlowVAELoss):
        def _reparametrize(self, generator, mu, logvar):
            return mu + torch.exp(logvar / 2.0) * self.noise.to(mu.device, mu.dtype)

    widths = [N_FEAT * 10, N_FEAT * 50, N_FEAT * 50, N_FEAT * 50, N_FEAT * 50,
              N_FEAT * 10]
    enc = get_mlp(N_FEAT, 2 * N_FEAT, widths, generator=gen(2))
    dec = get_mlp(N_FEAT, N_FEAT, widths, generator=gen(3))
    g = construct_invertible_mlp(n=N_FEAT, n_layers=3, cond_thresh_ratio=0.0,
                                 n_iter_cond_thresh=1000, rng=np.random.default_rng(0))
    z1 = torch.rand(BATCH, N_FEAT, generator=gen(4)) * 2 - 1
    z2 = (z1 + 0.1 * torch.randn(BATCH, N_FEAT, generator=gen(5))).clamp(-1, 1)
    noise = torch.randn(2 * BATCH, N_FEAT, generator=gen(6))
    res = {}
    for dtype in (torch.float32, torch.float64):
        for key, device in (("cpu", "cpu"), ("card", "cuda")):
            e, d, gg = (copy.deepcopy(m).to(device=device, dtype=dtype)
                        for m in (enc, dec, g))
            loss = FixedNoise(dec_h=d, g=gg, n=N_FEAT, decoder_dist="gaussian")
            loss.noise = noise
            a, b = z1.to(device, dtype), z2.to(device, dtype)
            total, _, comps = loss(a, b, None, e(gg(a)), e(gg(b)), None,
                                   generator=torch.Generator(device=device))
            total.backward()
            res[key, dtype] = ([v.detach().cpu().double() for v in [total, *comps]],
                               [p.grad.cpu().double() for p in e.parameters()])
    values64, grads64 = res["card", torch.float64]
    same = max(rel_err(a, b) for a, b in zip(values64 + grads64,
                                             sum(res["cpu", torch.float64], [])))
    # float32 against float64: kl_normal is a difference of two sums of
    # order 10 that leaves 0.025, so float32 keeps about 3e-5 of it on
    # either device; the card is held to the CPU's float32 accuracy, as the
    # flows are
    acc = {dev: [rel_err(a, b) for a, b in zip(res[dev, torch.float32][0], values64)]
           for dev in ("cpu", "card")}
    value_err = max(rel_err(a, b) for a, b in zip(res["card", torch.float32][0],
                                                  res["cpu", torch.float32][0]))
    grad_err = max(rel_err(a, b) for a, b in zip(res["card", torch.float32][1],
                                                 res["cpu", torch.float32][1]))
    print(f"[13 rest] 13c SlowVAELoss (gaussian, MLP encoder 2n and decoder, "
          f"n={N_FEAT}, B={BATCH}): float64 card vs CPU {same:.2e}; float32 "
          f"[loss, recon, kl_normal, kl_laplace] against float64, card "
          + ", ".join(f"{v:.2e}" for v in acc["card"]) + "; CPU "
          + ", ".join(f"{v:.2e}" for v in acc["cpu"])
          + f"; float32 card vs CPU: values {value_err:.2e}, encoder gradients "
          f"{grad_err:.2e}")
    worse = [c > max(4 * p, VALUE_BAR) for c, p in zip(acc["card"], acc["cpu"])]
    if same > VALUE_BAR or any(worse) or grad_err > GRAD_BAR:
        raise AssertionError(f"13c SlowVAE: {same}, {acc}, {grad_err}")

    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        decoder = ConvDecoder64(z_dim=KITTI_Z, nc=1, generator=gen(7))
        z = torch.randn(2 * KITTI_PAIRS, KITTI_Z, generator=gen(8))
        with torch.no_grad():
            want = decoder(z)
            got = copy.deepcopy(decoder).cuda()(z.cuda())
    finally:
        torch.backends.cudnn.deterministic = was
    err = rel_err(got.cpu(), want)
    print(f"[13 rest] 13c ConvDecoder64 batch {2 * KITTI_PAIRS}: output "
          f"{tuple(got.shape)}, card vs CPU {err:.2e}")
    if tuple(got.shape) != (2 * KITTI_PAIRS, 1, 34, 34) or err > VALUE_BAR:
        raise AssertionError(f"13c ConvDecoder64: {tuple(got.shape)}, {err}")

    images = torch.randint(0, 256, (1024, 224, 224, 3), dtype=torch.uint8,
                           generator=torch.Generator(device="cuda").manual_seed(9),
                           device="cuda")
    x_card = normalize_3dident(images)
    pe = PositionalEncoding2D()
    got = pe(x_card)
    want = pe(x_card.cpu())
    equal = torch.equal(got.cpu(), want)
    print(f"[13 rest] 13c PositionalEncoding2D on 1024 images of 224x224x3: "
          f"output {tuple(got.shape)}, card {'equal to' if equal else 'DIFFERS from'} "
          f"the CPU's, channels_last {got.is_contiguous(memory_format=torch.channels_last)}")
    if not equal or tuple(got.shape) != (1024, 5, 224, 224):
        raise AssertionError("13c PositionalEncoding2D differs")
    del images, x_card, got, want

    out = os.path.join(REST_DIR, "latents")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    generate_3dident_latents.main(["--n-points", "1000000", "--output-folder", out],
                                  device="cuda")
    secs = time.perf_counter() - t0
    raw = np.load(os.path.join(out, "raw_latents.npy"))
    ren = np.load(os.path.join(out, "latents.npy"))
    norms = np.linalg.norm(raw[:, 3:], axis=1)
    print(f"[13 rest] 13c generate_3dident_latents --n-points 1000000 on the card: "
          f"{secs:.1f} s, raw {raw.shape}, renderer {ren.shape}, sphere norms "
          f"{norms.min():.6f}-{norms.max():.6f}, angles {ren[:, 3:9].min():.4f}-"
          f"{ren[:, 3:9].max():.4f}, positions |x|,|y| <= {abs(ren[:, :2]).max():.4f},"
          f" z {ren[:, 2].min():.4f}-{ren[:, 2].max():.4f}")
    ok = (raw.shape == (1000000, 11) and ren.shape == (1000000, 10)
          and np.allclose(norms, 1.0, rtol=1e-5)
          and ren[:, 3:9].min() >= 0.0 and ren[:, 3:9].max() <= 2 * np.pi + 1e-5
          and abs(ren[:, :2]).max() <= 3.0 + 1e-6
          and ren[:, 2].min() >= 0.0 and ren[:, 2].max() <= 3.0 + 1e-6)
    if not ok:
        raise AssertionError("13c generate_3dident_latents: a contract fails")


def phase_rest(smi: str) -> dict:
    """Phase 13. Returns the launches of 13a's profiled driver runs."""
    t0 = time.perf_counter()
    os.makedirs(REST_DIR, exist_ok=True)
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        launches = _rest_mlp(smi)
        for k, v in _rest_kitti(smi).items():
            launches[k] += v
        for k, v in _rest_3dident(smi).items():
            launches[k] += v
    finally:
        torch.backends.cudnn.deterministic = was
    _rest_overheads(smi)
    _rest_guards()
    _rest_modules(smi)
    shutil.rmtree(REST_DIR, ignore_errors=True)
    print(f"[13 rest] {time.perf_counter() - t0:.1f} s")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="",
                    help="comma-separated subset of mlp,stem,bn,3dident,times,"
                         "kitti,capture,prefetch,mesh,options,rest")
    only = set(filter(None, ap.parse_args().only.split(",")))
    unknown = only - {"mlp", "stem", "bn", "3dident", "times", "kitti", "capture",
                      "prefetch", "mesh", "options", "rest"}
    if unknown:
        raise SystemExit(f"chip_smoke: unknown --only parts {sorted(unknown)}")
    run = lambda part: not only or part in only
    name, smi = phase_device()
    phase_build()
    worst, launches = {}, {k: 0 for k in COUNTERS}
    if run("mlp"):
        worst.update(phase_kernels())
    if run("stem"):
        phase_stem_kernels(worst)
    if run("bn"):
        phase_bn_kernels(worst)
    if run("mlp"):
        phase_step_parity()
        for tag, argv, path in (("4a_sphere_vmf_p2", HEADLINE, LP),
                                ("4b_box_laplace_p1", BOX, LP),
                                ("4c_sphere_vmf_p0", SIMCLR, DOT)):
            for k, v in _run_main(tag, argv, path).items():
                launches[k] += v
        phase_resume()
        times = phase_times(smi)
    if run("3dident") or run("times"):
        phase_fixture()
    if run("3dident"):
        for k, v in phase_3dident().items():
            launches[k] += v
    if run("times"):
        times3d, times_bn = phase_times_3dident(smi)
    if run("kitti"):
        grew, times_kitti = phase_kitti(smi, worst)
        for k, v in grew.items():
            launches[k] += v
    if run("capture"):
        phase_capture(smi)
    if run("prefetch"):
        for k, v in phase_prefetch(smi).items():
            launches[k] += v
    if run("mesh"):
        grew, rect = phase_mesh(worst, smi)
        for k, v in grew.items():
            launches[k] += v
    if run("options"):
        grew, times_options = phase_options(worst, smi)
        for k, v in grew.items():
            launches[k] += v
    if run("rest"):
        for k, v in phase_rest(smi).items():
            launches[k] += v
    if only:
        print(json.dumps({"ok": False, "partial": sorted(only)}))
        return 1
    print("\n".join(["chip_smoke: the measurements once more"] + TIMES))
    bounds = _bounds(BATCH, BATCH, N_FEAT)
    stem_bounds = _stem_bounds(STEM_FULL, torch.float32)
    stem_bounds16 = _stem_bounds(STEM_FULL, torch.bfloat16)
    bn_bounds = _bn_bounds(STEM_FULL, torch.float32)
    bn_bounds16 = _bn_bounds(STEM_FULL, torch.bfloat16)
    options_bounds = _bn8_bounds(STEM_FULL, torch.float32)
    options_bounds16 = _bn8_bounds(STEM_FULL, torch.bfloat16)
    kernels = []
    for key, (kname, source, replaces) in KERNELS.items():
        entry = {"name": kname, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[key],
                 "max_abs_err": worst[key]}
        if key in BN8 + POOL:
            t32, t16 = times_options[torch.float32], times_options[torch.bfloat16]
            entry.update({
                "ms": t32["kernel"][key], "plain_ms": t32["plain"][key],
                "bound_ms": options_bounds[key][0],
                "bound_by": options_bounds[key][1],
                "library_ms": t32["library"][key], "shape": list(STEM_FULL),
                "ms_bf16": t16["kernel"][key], "plain_ms_bf16": t16["plain"][key],
                "bound_ms_bf16": options_bounds16[key][0],
                "library_ms_bf16": t16["library"][key]})
            if key in BN8:
                entry["mode"] = "bn_relu"
            if key == "bn_bwd8":
                entry["sums_max_rel_err"] = worst["bn_sums8_rel"]
        elif key in BN:
            k = key.removeprefix("bn_")
            t32, t16 = times_bn[torch.float32], times_bn[torch.bfloat16]
            entry.update({
                "ms": t32["kernel"][k], "plain_ms": t32["plain"][k],
                "bound_ms": bn_bounds[key][0], "bound_by": bn_bounds[key][1],
                "library_ms": t32["library"][k], "shape": list(STEM_FULL),
                "mode": "bn_relu", "ms_bf16": t16["kernel"][k],
                "plain_ms_bf16": t16["plain"][k],
                "bound_ms_bf16": bn_bounds16[key][0],
                "library_ms_bf16": t16["library"][k]})
            if key == "bn_stats":
                entry["max_rel_err_vs_float64"] = worst["bn_stats_rel64"]
            if key == "bn_bwd":
                entry["sums_max_rel_err"] = worst["bn_sums_rel"]
            if key == "bn_dx":
                entry["functions_max_rel_err_vs_float64"] = worst["bn_fn_rel64"]
        elif key in STEM:
            k = key.removeprefix("stem_")
            t32, t16 = times3d[torch.float32], times3d[torch.bfloat16]
            entry.update({
                "ms": t32["kernel"][k], "plain_ms": t32["plain"][k],
                "bound_ms": stem_bounds[key][0], "bound_by": stem_bounds[key][1],
                "library_ms": t32["library"][k], "shape": list(STEM_FULL),
                "ms_bf16": t16["kernel"][k], "plain_ms_bf16": t16["plain"][k],
                "bound_ms_bf16": stem_bounds16[key][0],
                "library_ms_bf16": t16["library"][k]})
            if key == "stem_fwd":  # timed again in 12a's turns
                entry.update({
                    "ms_12a": times_options[torch.float32]["kernel"]["stem_fwd"],
                    "ms_12a_bf16": times_options[torch.bfloat16]["kernel"]["stem_fwd"]})
            if key == "stem_bwd":
                entry["sums_max_rel_err"] = worst["stem_sums_rel"]
            if key == "stem_dx":
                # the whole backward, and the tensor passes dx replaced
                entry.update({
                    "three_pass_ms": t32["three passes"]["dx"],
                    "three_pass_ms_bf16": t16["three passes"]["dx"],
                    "bwd_dx_ms": t32["kernel"]["bwd+dx"],
                    "bwd_dx_ms_bf16": t16["kernel"]["bwd+dx"],
                    "bwd_dx_bound_ms": stem_bounds["stem_bwd+dx"][0],
                    "bwd_dx_bound_ms_bf16": stem_bounds16["stem_bwd+dx"][0],
                    "library_bwd_ms": t32["library"]["bwd+dx"],
                    "library_bwd_ms_bf16": t16["library"]["bwd+dx"]})
        else:
            k = key.removeprefix("dot_")
            kern, plain, lib = times["p=0" if key in DOT else "p=2"]
            entry.update({"ms": kern[k], "plain_ms": plain[k],
                          "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
                          "library_ms": lib[k]})
            if key in LP:
                kern1, plain1, lib1 = times["p=1"]
                entry.update({"p": 2, "ms_p1": kern1[k], "plain_ms_p1": plain1[k],
                              "library_ms_p1": lib1[k]})
            # main_3dident's column slice of this loss (phase 6a's shapes)
            label = "p=0 3dident" if key in DOT else "p=2 3dident"
            _, _, m, n_feat = TIMED[label]
            kern3, plain3, lib3 = times[label]
            bound3 = _bounds(m, m, n_feat)[k]
            entry.update({"shape_3dident": [m, m, n_feat], "ms_3dident": kern3[k],
                          "plain_ms_3dident": plain3[k], "bound_ms_3dident": bound3[0],
                          "bound_by_3dident": bound3[1], "library_ms_3dident": lib3[k]})
            # a rank's rectangular block under --mesh W (phase 11c)
            entry["rect"] = rect[key]
            if key in LP:
                # main_kitti's step (phase 8a's shape, p = 1, tau = 1)
                kernk, plaink, libk = times_kitti
                boundk = _bounds(KITTI_PAIRS, KITTI_PAIRS, KITTI_Z)[k]
                entry.update({
                    "shape_kitti": [KITTI_PAIRS, KITTI_PAIRS, KITTI_Z],
                    "ms_kitti": kernk[k], "plain_ms_kitti": plaink[k],
                    "bound_ms_kitti": boundk[0], "bound_by_kitti": boundk[1],
                    "library_ms_kitti": libk[k]})
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
