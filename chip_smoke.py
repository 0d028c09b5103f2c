"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the Hopper kernels from ``deep_video_interpolation_extrapolation_tpu_torch/csrc``
(one nvcc per source, all at once; and the Triton one), then, in order:

1. kernels: each serving kernel against its plain PyTorch version on the
   card, in bf16 at the main-path shapes (B=1, 512x1024; the 4-part head
   ``ups_head_taps4`` of ``--highres_large`` included),
   max|d|/max|ref| <= 2e-2, with median CUDA-event times of both (K1's
   three sites and K2's three blocks each timed on a row of their own,
   host issue included and by device time alone, as the 4-part head is,
   K1 beside one ``F.conv2d`` with its bias; K1 at 2x37x130 at Cin 64 and
   256, K2 at 1x66x260 in its three block forms and the 4-part head at
   1x37x130 (its pyramid at 19x65, 10x33, 5x17) checked too: tiles cut at
   the edges); the
   stage-3 window attention at its serving shape (B=1 and B=2,
   128x256x128; k1 = v1 and k2 = v2 as on the path, and distinct values,
   the kernel's general route): out max|d|/max|ref| <= 2e-2 and flow
   agreement >= 90% on random inputs, and on an input whose k1 is q rolled
   by a known shift, that shift as the flow on every interior pixel; each
   case timed on a row of its own (``window_attention``, ``_b2``, ``_kv``,
   ``_kv_b2``), host issue included and on the card alone; and a ragged
   1x37x70, checked;
2. slice: InterNet/HRNet at full width, 128x256, B=2, bf16, kernels against
   the plain model with the same seed weights: rgb max|d| <= 5e-2 *
   max(1, max|ref|), seg argmax agreement >= 98%;
3. serving: ``registry.build_model`` + ``serve.rollout`` for 3 steps at
   512x1024, B=2, bf16 after one warm-up rollout; every kernel's launch
   counter must move by its count per forward (K1 18, K2 4, K3 2, K4 1);
   outputs finite, seg ids in [0, 20); frames/s;
4. train kernels: the stem, Bottleneck and BasicBlock chain kernels
   (forward and backward; the stem also at 2x36x120, the s1 and y its
   forward stores for the backward held as outputs, and timed on a row of
   their own, ``stem_fwd_saved``; its backward on the
   s1 and y its kernel forward kept, against ``stem_bwd_saved_plain`` on
   random inputs and against the recomputing ``stem_bwd_plain`` on
   fixed-mask ones, and timed by device time alone too; the chain at C =
   64, 24x128x128, N = 4 and N =
   1, at C = 128, 24x64x64 (branch 1 of the recipe), and at C = 256,
   24x16x32 (branch 2 of a 24x64x128 input), all N = 4; and the chain's
   weight-grad kernel on the C = 64 chain's 8 weights) and K4's h mode
   against their plain versions at the recipe shapes (bf16):
   outputs by max|d|/max|ref| <= 2e-2, weight and bias grads by rel-L2 <=
   1e-2; each backward on inputs whose lrelu masks are fixed per channel
   (dx by max|d|/max|ref| <= 2e-2) and on random inputs, whose masks vary
   per pixel (dx by rel-L2 <= 1e-2); the Bottleneck at block 0 (Ci = 64,
   kres) and block 1 (Ci = 256), each timed, and its weight-grad launch on
   its own; K1's backward (autograd of its plain version recomputed)
   against plain autograd, now that the train step no longer runs it; and
   K4's whole backward (``ups_head_taps_bwd``, bf16 products) against its
   f32-operand form, timed;
5. training: the INTER train step (``train/inter.make_train_step``) of
   InterNet/HRNet at full width on seeded 24x128x128 batches, bf16 with f32
   masters, frozen seeded VGG19, default loss weights:
   - one step's gradient, kernel model and plain bf16 model, each against
     the plain model in f32 (TF32 off): the kernel model's rel-L2 error
     <= 1.5 x the plain bf16 model's + 1e-3, for the whole gradient and
     for each of the 33 train-chain leaves on its own (stem, layer1 and
     the branch-0 BasicBlocks of stages 2 and 3), and every loss term
     within 2e-2 relative of the plain bf16 model's;
   - 20 Adamax steps on one fixed batch per model: loss_all falls for
     both, and the kernel model ends within 10% of the plain model;
   - the launches of one counted step (stem fwd/bwd 1/1, Bottleneck
     fwd/bwd/weight grads 4/4/4, BasicBlock chain fwd/bwd 8/8 (one per
     block) and its weight grads 2 (one per chain), K1 0, K2 0, K3 2, K4
     taps 1 and h mode 1, every other kernel 0);
   - samples/s of both models: median of the 18 steps after 2 warm-ups;
   all under the default ``DVIE_BBCHAIN=b0``; then the same step under
   ``0`` (branch 0 on K1: 16 launches), ``rest`` (branch 1 on the C = 128
   chain, 8/8, branch 0 on K1) and ``all`` (branches 0 and 1 on the
   chain), and under ``all`` at 24x64x128 (branch 2 on the C = 256 chain
   too, 4/4): per mode one gradient check as above over the leaves of
   the branches it runs on the train kernels (49 or 57 leaves), the
   launches of one counted step, samples/s of the kernel model;
6. highres_large: the 4-branch model (``--highres_large``), kernels
   against the plain model at 2x128x256 as in phase 2, then
   ``registry.build_model`` + ``serve.rollout`` for 3 steps at 2x512x1024
   bf16 after a warm-up: launches per forward K1 26, K2 4, K3 2, the
   4-part head 1, K4 0; outputs finite; frames/s;
7. stage3: InterStage3Net (HRNet -> SRNRefine -> MSResAttnRefine,
   ``--n_sc 1``), kernels against the plain model at 2x128x256 as in phase
   2 on the final (stage-3) frame, plus flow-map agreement >= 90%; then the
   3-step rollout at 2x512x1024: launches per forward K1 18, K2 4, K3 2, K4
   1, window attention 1;
8. vae: the video VAE (``--model VAE``, ``--vid_len 2``, 128x128, bf16):
   the kernel model against the plain model at 2x128x128 on the same
   weights and ``z_m`` (the warped ``output`` by max|d|/max|ref| <= 2e-2,
   ``y_pred`` as the slice phase's rgb, flows and masks within 1e-3 of
   their max: no kernel runs before the warp); then 3 timed eval forwards
   (``serve.predict_video``) at 8x128x128 after a warm-up, the code drawn
   from a seeded generator:
   launches per forward grid_sample 2 (one per step, unbounded), every
   other kernel 0 (the bounded mode has a counter of its own,
   grid_sample_bounded); outputs finite; frames/s;
9. runner: the port's runner layer through its launcher (``cli/main``,
   ``train/runner.Runner``): the INTER recipe on synthetic data at
   24x128x128 bf16, ``--epochs 2`` (8 steps each, ``--disp_interval 1``),
   ``--train_coarse``, ``b0``: the launches of the 16 steps (the train
   step's per step), finite losses, each epoch's samples/s with the log's
   load/comp split and checkpoint times beside the bare step's rate in
   this process; the writer's val metrics (launches of the 4 val forwards
   at 24x128x128: stem, Bottleneck and BasicBlock-chain forwards 1/4/8,
   K3 2, K4 1, the shift add 1), then the ``--checkepoch_range`` sweep of
   both checkpoints, whose epoch-2 metrics must equal the writer's within
   1e-3 relative after an epoch-1 forward (stale kernel weight units
   would fail it); ``--r --checkepoch 1``: its epoch-2 ``loss_all``
   within 2e-2 of the uninterrupted run's; ``--split cycgen`` at
   2x512x1024 from the epoch-2 checkpoint (the serving forward's launches,
   4 forwards), its 72 PNGs decoded back by the zlib + numpy decoder of
   ``native/png.py``; and one ``--dataset cityscape`` epoch (2 steps, 4
   loader workers) on a 150 px PNG tree and clip pkl the phase writes to a
   temporary directory.

The kernel phase also holds the shift-add kernel (the heads' tail in
every HRNet forward and train step: one launch each, counted in phases 3
and 5-7), bit for bit against its plain version at B=1 and B=2 512x1024,
at the train shape 24x128x128 and at a ragged 1x37x70, each timed on a row
of its own, host issue included and on the card alone; the grid sample
bounded (R = 8: flows up to 6 px, a band beyond the window that must give
0, a known integer shift) and unbounded (flows up to 40 px) at
8x512x1024x3 bf16, and unbounded at the VideoVAE's 8x128x128x3 (row
``grid_sample_vae``, also on the card alone); and the dual head
(``fused_dual_head``) on the InterNet serving forward's own 1x512x1024x448
concat map and head weights, against its plain version and against the
model's K4-route heads.

K3's rows are timed on the card alone too, as K1's and K2's are.

Every rollout asserts every kernel's launches, the ones not named above at
0.  Prints the card's name and power limit, one JSON line of per-kernel
results (``launches``: the serve rollout's count plus the counted train
step's plus the highres_large, stage3, vae and runner runs', as counted
there: 0
for the dual head and the bounded grid sample, which no model runs; the
chain forward's N = 1 row, ``bb_chain_fwd_n1``, reads the chain's counter,
one launch per block, and the Bottleneck's block-0 rows,
``bottleneck_fwd_b0`` and ``bottleneck_bwd_b0``, read the counters of all
four blocks; ``bound_ms``: the least time of the timed call from its
bytes and operations; ``library_ms``: one PyTorch call of the same
function where there is one, else null), and last ``{"ok": true,
"device": {...}}``.  Any failed phase raises: the exit code is then
non-zero and no result line is printed.  Needs a CUDA card of
compute capability (9, 0); there is no CPU fallback.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from deep_video_interpolation_extrapolation_tpu_torch import serve
from deep_video_interpolation_extrapolation_tpu_torch.cli.main import (
    get_logger,
    run,
)
from deep_video_interpolation_extrapolation_tpu_torch.cli.options import (
    parse_args,
)
from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.models.hrnet import (
    _concat_pyramid,
    _encode_inputs,
)
from deep_video_interpolation_extrapolation_tpu_torch.native import png
from deep_video_interpolation_extrapolation_tpu_torch.train import (
    inter,
    state as state_lib,
)
from deep_video_interpolation_extrapolation_tpu_torch.train.runner import (
    Runner,
)
from deep_video_interpolation_extrapolation_tpu_torch.train.common import (
    init_vgg_frozen,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops import (
    _build,
    bbchain as bb,
    bottleneck_tail as k2,
    conv3x3 as k1,
    dual_head as dh,
    fuse0 as k3,
    shiftadd as sa,
    trainchain as tc,
    upshead as k4,
    warp,
    window_attn as wa,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.resize import (
    nchw,
    nhwc,
)

KERNEL_TOL = 2e-2          # max|d| / max|ref|, bf16 kernel vs plain
WGRAD_TOL = 1e-2           # rel-L2 of a weight grad, kernel vs plain
DX_L2_TOL = 1e-2           # rel-L2 of dx on random inputs, kernel vs plain
SLICE_RGB_TOL = 5e-2       # rgb max|d| / max(1, max|ref|)
SLICE_SEG_AGREE = 0.98     # seg argmax agreement
PER_FORWARD = {"conv3x3_bias_res_lrelu": 18, "bottleneck_tail": 4,
               "fuse_out0": 2, "ups_head_taps": 1, "ups_head_taps4": 0,
               "shifted_add_bias": 1}
# --highres_large: stage4's branch 0 adds 8 K1 launches; the 4-part head
# replaces K4
PER_FORWARD_HL = {**PER_FORWARD, "conv3x3_bias_res_lrelu": 26,
                  "ups_head_taps": 0, "ups_head_taps4": 1}
# one train step at 24x128x128: the train chain for stem + layer1 and for
# the 8 branch-0 BasicBlocks of stages 2 and 3, no K1, no K2
PER_TRAIN_STEP = {"stem_fwd": 1, "stem_bwd": 1, "bottleneck_fwd": 4,
                  "bottleneck_bwd": 4, "bottleneck_wgrad": 4,
                  "bb_chain_fwd": 8, "bb_chain_bwd": 8,
                  "bb_chain_wgrad": 2,
                  "conv3x3_bias_res_lrelu": 0, "bottleneck_tail": 0,
                  "fuse_out0": 2, "ups_head_taps": 1, "ups_head_1x1": 1,
                  "shifted_add_bias": 1}
# the same step under each other DVIE_BBCHAIN mode: "0" runs branch 0 on
# K1 (2 convs x 4 blocks x 2 stages), "rest" branch 1 (128 ch) on the
# chain and branch 0 on K1, "all" branches 0 and 1 on the chain; branch 2
# (256 ch at 32x32) fails bb_fits in every mode; one weight-grad launch
# per chain
_NO_CHAIN = {"bb_chain_fwd": 0, "bb_chain_bwd": 0, "bb_chain_wgrad": 0}
PER_TRAIN_STEP_MODE = {
    "0": {**PER_TRAIN_STEP, **_NO_CHAIN, "conv3x3_bias_res_lrelu": 16},
    "rest": {**PER_TRAIN_STEP, **_NO_CHAIN, "conv3x3_bias_res_lrelu": 16,
             "bb_chain_fwd_c128": 8, "bb_chain_bwd_c128": 8,
             "bb_chain_wgrad": 2},
    "all": {**PER_TRAIN_STEP, "bb_chain_fwd_c128": 8, "bb_chain_bwd_c128": 8,
            "bb_chain_wgrad": 4},
}
# DVIE_BBCHAIN=all at 24x64x128: branch 2 (256 ch at 16x32) fits too
SMALL_ALL = (24, 64, 128)
PER_TRAIN_STEP_SMALL_ALL = {**PER_TRAIN_STEP_MODE["all"],
                            "bb_chain_fwd_c256": 4, "bb_chain_bwd_c256": 4,
                            "bb_chain_wgrad": 5}
GRAD_RATIO, GRAD_FLOOR = 1.5, 1e-3   # kernel grad error <= 1.5 x plain's + 1e-3
LOSS_TOL = 2e-2            # each loss term, kernel vs plain bf16, relative
TRAJ_TOL = 0.10            # final loss_all, kernel vs plain, relative
PKG = "deep_video_interpolation_extrapolation_tpu_torch"
META = {
    "conv3x3_bias_res_lrelu": ("cuda", f"{PKG}/csrc/conv3x3.cu",
                               "deep_video_interpolation_extrapolation_tpu/ops/pallas_ae_conv.py:400"),
    "conv3x3_stem": ("cuda", f"{PKG}/csrc/conv3x3.cu",
                     "deep_video_interpolation_extrapolation_tpu/ops/pallas_ae_conv.py:400"),
    "conv3x3_trans0": ("cuda", f"{PKG}/csrc/conv3x3.cu",
                       "deep_video_interpolation_extrapolation_tpu/ops/pallas_ae_conv.py:400"),
    "bottleneck_tail": ("cuda", f"{PKG}/csrc/bottleneck_tail.cu",
                        "deep_video_interpolation_extrapolation_tpu/ops/pallas_chain.py:495"),
    "bottleneck_tail_b0": ("cuda", f"{PKG}/csrc/bottleneck_tail.cu",
                           "deep_video_interpolation_extrapolation_tpu/ops/pallas_chain.py:495"),
    "bottleneck_tail_b3": ("cuda", f"{PKG}/csrc/bottleneck_tail.cu",
                           "deep_video_interpolation_extrapolation_tpu/ops/pallas_chain.py:495"),
    "fuse_out0": ("triton", f"{PKG}/ops/fuse0.py",
                  "deep_video_interpolation_extrapolation_tpu/ops/pallas_fuse0.py:419"),
    "ups_head_taps": ("cuda", f"{PKG}/csrc/upshead.cu",
                      "deep_video_interpolation_extrapolation_tpu/ops/pallas_upshead.py:342"),
    "ups_head_1x1": ("cuda", f"{PKG}/csrc/upshead.cu",
                     "deep_video_interpolation_extrapolation_tpu/ops/pallas_upshead.py:362"),
    "stem_fwd": ("cuda", f"{PKG}/csrc/trainchain_stem.cu",
                 "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:530"),
    "stem_fwd_saved": ("cuda", f"{PKG}/csrc/trainchain_stem.cu",
                       "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:530"),
    "stem_bwd": ("cuda", f"{PKG}/csrc/trainchain_stem.cu",
                 "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:565"),
    "bottleneck_fwd": ("cuda", f"{PKG}/csrc/trainchain_bottleneck.cu",
                       "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:400"),
    "bottleneck_bwd": ("cuda", f"{PKG}/csrc/trainchain_bottleneck.cu",
                       "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:445"),
    "bottleneck_wgrad": ("cuda", f"{PKG}/csrc/trainchain_bottleneck.cu",
                         "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:445"),
    "bottleneck_fwd_b0": ("cuda", f"{PKG}/csrc/trainchain_bottleneck.cu",
                          "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:400"),
    "bottleneck_bwd_b0": ("cuda", f"{PKG}/csrc/trainchain_bottleneck.cu",
                          "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:445"),
    "bb_chain_fwd": ("cuda", f"{PKG}/csrc/trainchain_basicblock.cu",
                     "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:704"),
    "bb_chain_bwd": ("cuda", f"{PKG}/csrc/trainchain_basicblock.cu",
                     "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:741"),
    "ups_head_taps4": ("cuda", f"{PKG}/csrc/upshead4.cu",
                       "deep_video_interpolation_extrapolation_tpu/ops/pallas_upshead.py:1096"),
    "window_attention": ("cuda", f"{PKG}/csrc/window_attn.cu",
                         "deep_video_interpolation_extrapolation_tpu/ops/pallas_corr.py:196"),
    "window_attention_b2": ("cuda", f"{PKG}/csrc/window_attn.cu",
                           "deep_video_interpolation_extrapolation_tpu/ops/pallas_corr.py:196"),
    "window_attention_kv": ("cuda", f"{PKG}/csrc/window_attn.cu",
                           "deep_video_interpolation_extrapolation_tpu/ops/pallas_corr.py:196"),
    "window_attention_kv_b2": ("cuda", f"{PKG}/csrc/window_attn.cu",
                              "deep_video_interpolation_extrapolation_tpu/ops/pallas_corr.py:196"),
    "shifted_add_bias": ("cuda", f"{PKG}/csrc/shiftadd.cu",
                         "deep_video_interpolation_extrapolation_tpu/ops/pallas_shiftadd.py:111"),
    "shifted_add_bias_b2": ("cuda", f"{PKG}/csrc/shiftadd.cu",
                           "deep_video_interpolation_extrapolation_tpu/ops/pallas_shiftadd.py:111"),
    "shifted_add_bias_train": ("cuda", f"{PKG}/csrc/shiftadd.cu",
                              "deep_video_interpolation_extrapolation_tpu/ops/pallas_shiftadd.py:111"),
    "shifted_add_bias_ragged": ("cuda", f"{PKG}/csrc/shiftadd.cu",
                               "deep_video_interpolation_extrapolation_tpu/ops/pallas_shiftadd.py:111"),
    "grid_sample": ("cuda", f"{PKG}/csrc/grid_sample.cu",
                    "deep_video_interpolation_extrapolation_tpu/ops/pallas_warp.py:134"),
    "grid_sample_vae": ("cuda", f"{PKG}/csrc/grid_sample.cu",
                        "deep_video_interpolation_extrapolation_tpu/ops/pallas_warp.py:134"),
    "grid_sample_bounded": ("cuda", f"{PKG}/csrc/grid_sample.cu",
                            "deep_video_interpolation_extrapolation_tpu/ops/pallas_warp.py:134"),
    "dual_head": ("cuda", f"{PKG}/csrc/upshead.cu",
                  "deep_video_interpolation_extrapolation_tpu/ops/pallas_head.py:147"),
    "bb_chain_fwd_n1": ("cuda", f"{PKG}/csrc/trainchain_basicblock.cu",
                        "deep_video_interpolation_extrapolation_tpu/ops/pallas_resblock.py:307"),
    "bb_chain_fwd_c128": ("cuda", f"{PKG}/csrc/trainchain_basicblock.cu",
                          "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:704"),
    "bb_chain_bwd_c128": ("cuda", f"{PKG}/csrc/trainchain_basicblock.cu",
                          "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:741"),
    "bb_chain_fwd_c256": ("cuda", f"{PKG}/csrc/trainchain_basicblock.cu",
                          "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:704"),
    "bb_chain_bwd_c256": ("cuda", f"{PKG}/csrc/trainchain_basicblock.cu",
                          "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:741"),
    "bb_chain_wgrad": ("cuda", f"{PKG}/csrc/trainchain_basicblock.cu",
                       "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:741"),
}
# a row timed on another row's counter: the chain forward launches once per
# block, so each of its launches computes the one-block function; the
# Bottleneck's block-0 rows (Ci = 64, kres) share the counters of blocks
# 1-3; K1's stem conv2 and trans_0 rows and K2's block-0 and block-3 rows
# share their kernel's counter, as does the stem forward that stores s1; so
# do the window attention's, the shifted add's and the grid sample's rows
# at other shapes (each row computes the one function of its kernel)
COUNTER = {"bb_chain_fwd_n1": "bb_chain_fwd",
           "stem_fwd_saved": "stem_fwd",
           "bottleneck_fwd_b0": "bottleneck_fwd",
           "bottleneck_bwd_b0": "bottleneck_bwd",
           "conv3x3_stem": "conv3x3_bias_res_lrelu",
           "conv3x3_trans0": "conv3x3_bias_res_lrelu",
           "bottleneck_tail_b0": "bottleneck_tail",
           "bottleneck_tail_b3": "bottleneck_tail",
           "window_attention_b2": "window_attention",
           "window_attention_kv": "window_attention",
           "window_attention_kv_b2": "window_attention",
           "shifted_add_bias_b2": "shifted_add_bias",
           "shifted_add_bias_train": "shifted_add_bias",
           "shifted_add_bias_ragged": "shifted_add_bias",
           "grid_sample_vae": "grid_sample"}
# the video VAE serving forward: one grid sample per step
VAE_T = 2
PER_FORWARD_VAE = {"grid_sample": VAE_T}
VAE_FLOW_TOL = 1e-3        # flows and masks, kernel vs plain model, of max
WA_FLOW_AGREE = 0.90       # window-attention flow agreement, kernel vs plain
# the window attention's rows, by (B, k is v): B=1 with k = v is the row
# of the InterStage3Net forward's launch at 1x512x1024
WA_ROWS = {(1, True): "window_attention", (2, True): "window_attention_b2",
           (1, False): "window_attention_kv", (2, False): "window_attention_kv_b2"}
# the shifted add's rows: (row, label, (B, H, W)) -- the serving forward's
# B=1 and B=2, the train step's and a ragged shape
SHIFTADD_CASES = (("shifted_add_bias", "B=1 512x1024", (1, 512, 1024)),
                  ("shifted_add_bias_b2", "B=2 512x1024", (2, 512, 1024)),
                  ("shifted_add_bias_train", "24x128x128", (24, 128, 128)),
                  ("shifted_add_bias_ragged", "ragged 1x37x70", (1, 37, 70)))
# InterStage3Net: the coarse HRNet as InterNet, one window attention
PER_FORWARD_S3 = {**PER_FORWARD, "window_attention": 1}
SLICE_FLOW_AGREE = 0.90    # stage-3 flow maps, kernel vs plain model
# the rows of the kernel-phase loop timed on the card alone too
# (``median_ms(spin=True)``); the window attention's and the shifted add's
# rows are, in their own checks
DEVICE_TIMED = ("conv3x3_bias_res_lrelu", "bottleneck_tail", "fuse_out0",
                "ups_head_taps4", "stem_fwd", "stem_bwd")
# H100 SXM data sheet: HBM rate, dense bf16 tensor-core and f32 CUDA-core
# peaks (at the 700 W limit)
HBM_RATE, BF16_PEAK, F32_PEAK = 3.35e12, 989e12, 67e12


def _tensors(obj):
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)


def moved_bytes(*objs) -> int:
    """Bytes of the distinct tensors among ``objs``: each input read once,
    each output written once (an operand passed twice counts once)."""
    return sum({t.data_ptr(): t.nbytes for t in _tensors(objs)}.values())


def _px(t) -> int:
    return t[..., 0].numel()


def _nz(*ws) -> int:
    """Multiply-adds per pixel of these weights: their nonzeros (the
    zero half of K4's taps matrix is no work)."""
    return sum(int(torch.count_nonzero(w)) for w in _tensors(ws))


# the arguments of each kernel that hold the weights of the convolutions
# and matmuls it computes (biases, 1-D, are left out)
WEIGHT_ARGS = {
    "conv3x3_bias_res_lrelu": slice(1, 2), "bottleneck_tail": slice(2, None),
    "ups_head_taps": slice(3, None), "ups_head_taps4": slice(4, None),
    "ups_head_1x1": slice(3, None), "dual_head": slice(1, None),
    "stem_fwd": slice(1, None),
    "stem_bwd": slice(4, None), "bottleneck_fwd": slice(1, None),
    "bottleneck_bwd": slice(2, None), "bb_chain_fwd": slice(1, None),
    "bb_chain_bwd": slice(2, 3), "bb_chain_fwd_c128": slice(1, None),
    "bb_chain_bwd_c128": slice(2, 3), "bb_chain_fwd_c256": slice(1, None),
    "bb_chain_bwd_c256": slice(2, 3)}
# a backward without saved activations recomputes its forward (3 passes);
# the chain's and the stem's backwards read the kept ones (2: the input
# grads, the weight grads)
PASSES = {"stem_bwd": 2, "bottleneck_bwd": 3, "bb_chain_bwd": 2,
          "bb_chain_bwd_c128": 2, "bb_chain_bwd_c256": 2}


def operations(name, args):
    """(operations, the card's peak rate for them) of one call of kernel
    ``name`` on ``args``: 2 per multiply-add of what it computes, on bf16
    operands (the tensor-core peak); K3, the shifted add and the grid
    sample are elementwise in f32 (K3: the 4 taps of each bilinear part,
    the adds and the lrelu; the shifted add: 8 adds and the bias per
    output; the grid sample: 9 per channel of the 4-corner blend and ~10
    per pixel for the coordinates and weights)."""
    if name == "fuse_out0":
        ups = sum(t is not None for t in args[1:])
        return args[0].numel() * (2 + 8 * ups), F32_PEAK
    if name == "shifted_add_bias":
        return 9 * _px(args[0]) * args[1].numel(), F32_PEAK
    if name.startswith("grid_sample"):
        return _px(args[0]) * (9 * args[0].shape[-1] + 10), F32_PEAK
    if name == "bb_chain_wgrad":   # 9 taps of a C x C product per pixel
        return sum(2 * 9 * a.shape[-1] * d.shape[-1] * _px(a)
                   for a, d in args[0]), BF16_PEAK
    if name == "bottleneck_wgrad":  # dk1, dk2 (9 taps), dk3, dkres per pixel
        ci = args[0].shape[-1]
        res = ci * 256 if ci != 256 else 0
        return 2 * _px(args[0]) * (ci * 64 + 9 * 64 * 64 + 64 * 256 + res), \
            BF16_PEAK
    if name == "window_attention":
        q, _, _, v1, _, win_h, win_w = args
        return (2 * _px(q) * 2 * win_h * win_w * (q.shape[-1] + v1.shape[-1]),
                BF16_PEAK)
    ws = [w for w in _tensors(args[WEIGHT_ARGS[name]]) if w.dim() >= 2]
    return 2 * PASSES.get(name, 1) * _px(args[0]) * _nz(ws), BF16_PEAK


def bound(name, args, out):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over their peak."""
    t_bytes = moved_bytes(args, out) / HBM_RATE
    ops, peak = operations(name, args)
    t_ops = ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def require_card() -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); the port's kernels need an H100")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: compute capability {cap}, need (9, 0)")
    return torch.device("cuda:0")


def rel_err(out, ref):
    d = (out.float() - ref.float()).abs().max().item()
    return d, d / max(ref.float().abs().max().item(), 1e-30)


SPIN_CYCLES = 20_000_000   # ~10 ms of the card's clock


def median_ms(fn, iters=10, reps=5, spin=False):
    """Median over ``reps`` of the mean CUDA-event time of ``iters``
    back-to-back calls (after two warm-up calls).  The window counts the
    host's issue time wherever the host queues slower than the card runs
    (a wrapper's Python against a 0.1 ms kernel).  With ``spin`` each
    window opens behind a spin of the card (``torch.cuda._sleep``) while
    the host queues the window's calls, so the time is the card's alone
    (K1's and K2's rows print both)."""
    fn()
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def kernel_phase(dev):
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    def w(*shape):      # torch conv weight, lecun-normal scale, f32 master
        fan_in = shape[1] * shape[2] * shape[3]
        return torch.randn(shape, generator=g, device=dev) / fan_in ** 0.5

    B, H, W = 1, 512, 1024
    cases = {}
    # K1: stem conv2 (bias), transition1 trans_0 (Cin 256), BasicBlock
    # conv2 (residual: 16 of the 18 launches per forward), each timed on
    # its own row; and a ragged shape (tiles cut at both edges), checked
    x64, x256, res = rnd(B, H, W, 64), rnd(B, H, W, 256), rnd(B, H, W, 64)
    w64, w256, bias = w(64, 64, 3, 3), w(64, 256, 3, 3), w(64, 1, 1, 1).flatten()
    xr, rr, xr256 = rnd(2, 37, 130, 64), rnd(2, 37, 130, 64), \
        rnd(2, 37, 130, 256)
    cases["conv3x3_bias_res_lrelu"] = [
        ("conv3x3_stem", "stem conv2", (x64, w64, bias, None, True)),
        ("conv3x3_trans0", "trans_0", (x256, w256, None, None, True)),
        ("conv3x3_bias_res_lrelu", "basicblock conv2",
         (x64, w64, None, res, True)),
        (None, "ragged 2x37x130", (xr, w64, bias, rr, True)),
        (None, "ragged 2x37x130 trans_0", (xr256, w256, None, None, True)),
    ]
    # K2: block 0 (projection residual), blocks 1-2, block 3 (no next h1),
    # each timed; and a ragged shape, checked
    h1 = torch.nn.functional.leaky_relu(rnd(B, H, W, 64), 0.2)
    w2, w3 = w(64, 64, 3, 3), w(256, 64, 1, 1)
    wres, w1n = w(256, 64, 1, 1), w(64, 256, 1, 1)
    h1r = torch.nn.functional.leaky_relu(rnd(1, 66, 260, 64), 0.2)
    cases["bottleneck_tail"] = [
        ("bottleneck_tail_b0", "block 0", (h1, x64, w2, w3, wres, w1n)),
        ("bottleneck_tail_b3", "block 3", (h1, x256, w2, w3, None, None)),
        ("bottleneck_tail", "block 1", (h1, x256, w2, w3, None, w1n)),
        (None, "ragged 1x66x260 block 1",
         (h1r, rnd(1, 66, 260, 256), w2, w3, None, w1n)),
        (None, "ragged 1x66x260 block 0",
         (h1r, rnd(1, 66, 260, 64), w2, w3, wres, w1n)),
        (None, "ragged 1x66x260 block 3",
         (h1r, rnd(1, 66, 260, 256), w2, w3, None, None)),
    ]
    # K3: stage2 (no t2), stage3 (with t2)
    t1, t2 = rnd(B, H // 2, W // 2, 64), rnd(B, H // 4, W // 4, 64)
    cases["fuse_out0"] = [(None, "stage2", (x64, t1, None)),
                          ("fuse_out0", "stage3", (x64, t1, t2))]
    # K4: the head at its one site
    p1, p2 = rnd(B, H // 2, W // 2, 128), rnd(B, H // 4, W // 4, 256)
    w1 = w(896, 448, 1, 1)[:, :, 0, 0].t()
    b1 = w(896, 1, 1, 1).flatten()
    w2t = k4.build_dual_tap_kernel(w(3, 448, 3, 3), w(20, 448, 3, 3),
                                   torch.bfloat16)
    cases["ups_head_taps"] = [("ups_head_taps", "heads",
                                (x64, p1, p2, w1, b1, w2t))]
    # the 4-part head of --highres_large
    p3 = rnd(B, H // 8, W // 8, 512)
    w1_4 = w(1920, 960, 1, 1)[:, :, 0, 0].t()
    b1_4 = w(1920, 1, 1, 1).flatten()
    w2t_4 = k4.build_dual_tap_kernel(w(3, 960, 3, 3), w(20, 960, 3, 3),
                                     torch.bfloat16)
    cases["ups_head_taps4"] = [
        ("ups_head_taps4", "heads", (x64, p1, p2, p3, w1_4, b1_4, w2t_4)),
        # not fits4: tiles and the x2/x4/x8 parts cut at the edge
        (None, "ragged 1x37x130", (rnd(1, 37, 130, 64), rnd(1, 19, 65, 128),
                                   rnd(1, 10, 33, 256), rnd(1, 5, 17, 512),
                                   w1_4, b1_4, w2t_4))]

    fns = {"conv3x3_bias_res_lrelu": (k1.conv3x3_bias_res_lrelu,
                                      k1.conv3x3_bias_res_lrelu_plain),
           "bottleneck_tail": (k2.bottleneck_tail, k2.bottleneck_tail_plain),
           "fuse_out0": (k3.fuse_out0, k3.fuse_out0_plain),
           "ups_head_taps": (k4.ups_head_taps, k4.ups_head_taps_plain),
           "ups_head_taps4": (k4.ups_head_taps4, k4.ups_head_taps4_plain)}
    results = {}
    for name, variants in cases.items():
        kern, plain = fns[name]
        worst_rel, err = 0.0, {}
        for _, label, args in variants:
            out, ref = kern(*args), plain(*args)
            torch.cuda.synchronize()
            outs = out if isinstance(out, tuple) else (out,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            for o, r in zip(outs, refs):
                if (o is None) != (r is None):
                    raise AssertionError(f"{name} [{label}]: output mismatch")
                if o is None:
                    continue
                if o.shape != r.shape or not torch.isfinite(o).all():
                    raise AssertionError(f"{name} [{label}]: shape "
                                         f"{tuple(o.shape)} vs {tuple(r.shape)}"
                                         " or non-finite output")
                d, rel = rel_err(o, r)
                print(f"  {name} [{label}] max|d|={d:.6g} "
                      f"max|d|/max|ref|={rel:.6g}")
                err[label] = max(err.get(label, 0.0), d)
                worst_rel = max(worst_rel, rel)
        if worst_rel > KERNEL_TOL:
            raise AssertionError(f"{name}: max|d|/max|ref| {worst_rel:.4g} > "
                                 f"{KERNEL_TOL}")
        for row, label, args in variants:
            if row is None:
                continue
            fs = {"": lambda: kern(*args), "plain_": lambda: plain(*args)}
            if name == "conv3x3_bias_res_lrelu":   # product + bias alone
                fs["library_"] = lambda: k1_library(*args)
            ms = {k: median_ms(f) for k, f in fs.items()}
            device = ({f"{k}device_ms": median_ms(f, spin=True)
                       for k, f in fs.items()}
                      if name in DEVICE_TIMED else None)
            results[row] = timed(name, label, args, kern(*args), err[label],
                                 ms[""], ms["plain_"], ms.get("library_"),
                                 device)
    results.update(window_attention_check(dev))
    results.update(shifted_add_check(dev))
    results.update(grid_sample_check(dev))
    results["dual_head"] = dual_head_check(dev)
    return results


def k1_library(x, w, bias, res, relu):
    """K1's library call: one cuDNN ``F.conv2d`` of the channels_last bf16
    view with the bias, no residual and no lrelu (the port never calls
    it)."""
    return torch.nn.functional.conv2d(
        nchw(x), w.to(x.dtype), None if bias is None else bias.to(x.dtype),
        padding=1)


def _held(name, label, out, ref, tol=KERNEL_TOL):
    """max|d| of a kernel output against its reference; raises past
    ``tol`` of max|ref| or for a bad shape or non-finite values."""
    if out.shape != ref.shape or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name} [{label}]: shape {tuple(out.shape)} vs "
                             f"{tuple(ref.shape)} or non-finite output")
    d, rel = rel_err(out, ref)
    print(f"  {name} [{label}] max|d|={d:.6g} max|d|/max|ref|={rel:.6g}")
    if rel > tol:
        raise AssertionError(f"{name} [{label}]: max|d|/max|ref| {rel:.4g} > "
                             f"{tol}")
    return d


def shifted_add_check(dev):
    """The heads' shifted add + bias (co = 23) against its plain version,
    bit for bit and within KERNEL_TOL: at the serving shapes (B=1 and B=2
    512x1024: yt (B,512,1024,207) bf16), the train shape 24x128x128 and a
    ragged 1x37x70 (strips and row blocks cut at the edges).  Each is timed
    on a row of its own, host issue included and on the card alone; its
    library time is one ``F.conv2d`` of yt with the fixed one-hot (23, 207,
    3, 3) kernel and b2, the same function."""
    g = torch.Generator(device=dev).manual_seed(8)
    co = 23
    b2 = torch.randn((co,), generator=g, device=dev)
    onehot = torch.zeros((co, 9 * co, 3, 3), device=dev, dtype=torch.bfloat16)
    for t in range(9):
        onehot[torch.arange(co), t * co + torch.arange(co), t // 3, t % 3] = 1
    bias = b2.to(torch.bfloat16)
    rows = {}
    for row, label, shape in SHIFTADD_CASES:
        yt = torch.randn(shape + (9 * co,), generator=g, device=dev).to(
            torch.bfloat16)
        out, ref = sa.shifted_add_bias(yt, b2), sa.shifted_add_bias_plain(
            yt, b2)
        torch.cuda.synchronize()
        d = _held("shifted_add_bias", label, out, ref)
        if not torch.equal(out, ref):
            raise AssertionError(f"shifted_add_bias [{label}]: not bit-equal "
                                 "to the plain version (the same f32 adds)")

        def library(yt=yt):
            return nhwc(torch.nn.functional.conv2d(nchw(yt), onehot, bias,
                                                   padding=1))
        _held("shifted_add_bias", f"{label}, library conv2d vs plain",
              library(), ref)
        args = (yt, b2)
        fs = {"": lambda: sa.shifted_add_bias(*args),
              "plain_": lambda: sa.shifted_add_bias_plain(*args),
              "library_": library}
        rows[row] = timed(
            "shifted_add_bias", label, args, out, d,
            *(median_ms(f) for f in fs.values()),
            {f"{k}device_ms": median_ms(f, spin=True) for k, f in fs.items()})
        del yt, out, ref
    return rows


def grid_sample_check(dev):
    """The grid sample at 8x512x1024x3 bf16 (the shape warp.py:130 names).
    Bounded (R = 8): flows up to 6 px, except a band of 64 rows per image
    displaced 12 px in x, beyond the window, which must give exactly 0;
    and a uniform (3, -2) px shift, which must reproduce the image on the
    interior.  Unbounded: flows up to 40 px; its library time is
    ``F.grid_sample(align_corners=True, padding_mode="zeros")``, which
    takes its grid in the input's dtype: a bf16 grid would move samples by
    up to ~2 px at 1024 wide, so it is timed in f32 (x and grid)."""
    g = torch.Generator(device=dev).manual_seed(9)
    b, h, w, c, r = 8, 512, 1024, 3, 8
    x = torch.randn((b, h, w, c), generator=g, device=dev).to(torch.bfloat16)
    base = warp.make_base_grid(h, w, device=dev)[None]
    px = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1)], device=dev)

    def grid_of(flow_px):
        return (base + flow_px * px).expand(b, h, w, 2).contiguous()

    small = (torch.rand((b, h, w, 2), generator=g, device=dev) * 2 - 1) * 6
    small[:, :64, :, 0] = 12.0                     # beyond the window
    grid_b = grid_of(small)
    out, ref = warp.grid_sample(x, grid_b, r), warp.grid_sample_plain(
        x, grid_b, r)
    torch.cuda.synchronize()
    d_b = _held("grid_sample", "bounded, R=8", out, ref)
    band = out[:, :64].float().abs().max().item()
    print(f"  grid_sample [bounded, band beyond R] max|out|={band:.6g}")
    if band != 0.0:
        raise AssertionError(f"grid_sample bounded: {band} beyond the window")
    shifted = warp.grid_sample(
        x, grid_of(torch.tensor([3.0, -2.0], device=dev)), r)
    torch.cuda.synchronize()
    _held("grid_sample", "bounded, known (3, -2) px shift",
          shifted[:, 2:, :-3], x[:, :-2, 3:])
    args_b = (x, grid_b, r)
    rows = {"grid_sample_bounded": timed(
        "grid_sample_bounded", "R=8", args_b, out, d_b,
        median_ms(lambda: warp.grid_sample(*args_b)),
        median_ms(lambda: warp.grid_sample_plain(*args_b), iters=3, reps=3))}

    far = (torch.rand((b, h, w, 2), generator=g, device=dev) * 2 - 1) * 40
    grid_u = grid_of(far)
    out, ref = warp.grid_sample(x, grid_u), warp.grid_sample_plain(x, grid_u)
    torch.cuda.synchronize()
    d_u = _held("grid_sample", "unbounded, 40 px", out, ref)
    x32 = nchw(x.float()).contiguous()

    def library():
        return torch.nn.functional.grid_sample(
            x32, grid_u, mode="bilinear", padding_mode="zeros",
            align_corners=True)
    _held("grid_sample", "library F.grid_sample (f32) vs plain",
          nhwc(library()), ref.float())
    args_u = (x, grid_u)
    rows["grid_sample"] = timed(
        "grid_sample", "unbounded", args_u, out, d_u,
        median_ms(lambda: warp.grid_sample(*args_u)),
        median_ms(lambda: warp.grid_sample_plain(*args_u), iters=3, reps=3),
        median_ms(library))

    # the shape the VideoVAE forward runs (models/vae_video.py: one warp of
    # its 8x128x128x3 frame per step), flows up to 10 px, unbounded
    hv = wv = 128
    xv = torch.randn((b, hv, wv, c), generator=g, device=dev).to(
        torch.bfloat16)
    flow_v = (torch.rand((b, hv, wv, 2), generator=g, device=dev) * 2 - 1) * 10
    grid_v = (warp.make_base_grid(hv, wv, device=dev)[None] + flow_v
              * torch.tensor([2.0 / (wv - 1), 2.0 / (hv - 1)], device=dev)
              ).contiguous()
    out, ref = warp.grid_sample(xv, grid_v), warp.grid_sample_plain(xv, grid_v)
    torch.cuda.synchronize()
    d_v = _held("grid_sample", "unbounded, VAE 8x128x128", out, ref)
    xv32 = nchw(xv.float()).contiguous()

    def library_v():
        return torch.nn.functional.grid_sample(
            xv32, grid_v, mode="bilinear", padding_mode="zeros",
            align_corners=True)
    args_v = (xv, grid_v)
    fs = {"": lambda: warp.grid_sample(*args_v),
          "plain_": lambda: warp.grid_sample_plain(*args_v),
          "library_": library_v}
    rows["grid_sample_vae"] = timed(
        "grid_sample", "unbounded, VAE 8x128x128", args_v, out, d_v,
        *(median_ms(f) for f in fs.values()),
        {f"{k}device_ms": median_ms(f, spin=True) for k, f in fs.items()})
    return rows


def dual_head_check(dev):
    """The dual head at (1,512,1024,448) bf16 on the InterNet serving
    forward's own concat map (``_concat_pyramid`` of its backbone's
    pyramid) with the model's own head weights: against its plain version
    (each output by max|d|/max|ref| <= KERNEL_TOL) and against the same
    model's K4-route heads (rgb by the slice phase's bound, seg argmax
    agreement >= SLICE_SEG_AGREE)."""
    hrnet = registry.build_model(CFG, device=dev, seed=0).coarse_model
    imgs, ids = _inputs(dev, 1, 512, 1024, 10)
    rgb = torch.cat(imgs, -1) * 2 - 1
    seg = torch.cat([serve.seg_oh(i) for i in ids], -1)
    with torch.inference_mode():
        parts = hrnet._backbone(_encode_inputs(rgb, seg, hrnet.seg_encoder,
                                               hrnet.dtype))
        feat = _concat_pyramid(parts)
        k4_rgb, k4_seg = hrnet._apply_heads(parts)
        heads = []
        for layer in (hrnet.rgb_layer, hrnet.seg_layer):
            heads += [layer[0].weight[:, :, 0, 0].t(), layer[0].bias,
                      layer[2].weight.permute(2, 3, 1, 0), layer[2].bias]
        args = (feat, *heads)
        out, ref = dh.fused_dual_head(*args), dh.fused_dual_head_plain(*args)
        torch.cuda.synchronize()
        d = max(_held("dual_head", f"{n} vs plain", o, r)
                for n, o, r in zip(("rgb", "seg"), out, ref))
        rd = (out[0].float() - k4_rgb.float()).abs().max().item()
        limit = SLICE_RGB_TOL * max(1.0, k4_rgb.float().abs().max().item())
        agree = (out[1].argmax(-1) == k4_seg.argmax(-1)).float().mean().item()
        print(f"  dual_head [vs the K4-route heads] rgb max|d|={rd:.6g} "
              f"(bound {limit:.4g}), seg argmax agreement {agree:.6f}")
        if rd > limit or agree < SLICE_SEG_AGREE:
            raise AssertionError(f"dual_head vs K4 route: rgb {rd:.4g}, seg "
                                 f"agreement {agree:.4f}")
        return timed("dual_head", "serving", args, out, d,
                     median_ms(lambda: dh.fused_dual_head(*args), iters=3,
                               reps=3),
                     median_ms(lambda: dh.fused_dual_head_plain(*args),
                               iters=3, reps=3))


def timed(name, label, args, out, max_abs_err, ms, plain_ms,
          library_ms=None, device=None):
    """A kernel's row of the result line, from its timed call; ``device``:
    the same calls' device times (``median_ms(spin=True)``), by key."""
    bound_ms, bound_by = bound(name, args, out)
    lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
    dev = "" if device is None else "; device " + ", ".join(
        f"{k.replace('device_ms', '').rstrip('_') or 'kernel'} {v:.4f} ms"
        for k, v in device.items())
    print(f"  {name} [{label}] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
          f"{lib}{dev}, bound {bound_ms:.4f} ms ({bound_by})")
    return dict(max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                **(device or {}))


def flow_agreement(a, b) -> float:
    """Share of pixels whose flow vectors are equal."""
    return (a == b).all(-1).float().mean().item()


def window_attention_check(dev):
    """The window attention against its plain version at the serving shape
    (B=1 and B=2, 128x256x128 bf16: the 1/4-resolution features of
    512x1024), with k1 = v1 and k2 = v2 as on the path (one slab per
    neighbour) and with distinct values (the general route): on random
    inputs out max|d|/max|ref| <= KERNEL_TOL and flow agreement >=
    WA_FLOW_AGREE (near-tied similarities can flip under sums taken in
    another order); with k1 = q rolled by (1, 2) the flow is (dx, dy) =
    (-2, -1) on every interior pixel.  Each case is timed on a row of its
    own, host issue included and on the card alone."""
    g = torch.Generator(device=dev).manual_seed(7)
    rows = {}
    for b in (1, 2):
        q, f, bk, v1, v2 = (torch.randn((b, 128, 256, 128), generator=g,
                                        device=dev).to(torch.bfloat16)
                            for _ in range(5))
        cases = {"k = v": (q, f, bk, f, bk, 5, 9),
                 "k != v": (q, f, bk, v1, v2, 5, 9)}
        for label, args in cases.items():
            label = f"B={b}, {label}"
            (out, flow), (ref, ref_flow) = wa.window_attention(*args), \
                wa.window_attention_plain(*args)
            torch.cuda.synchronize()
            if out.shape != ref.shape or not torch.isfinite(out).all():
                raise AssertionError(f"window_attention [{label}]: bad shape "
                                     "or non-finite out")
            d, rel = rel_err(out, ref)
            agree = flow_agreement(flow, ref_flow)
            print(f"  window_attention [{label}] out max|d|={d:.6g} "
                  f"max|d|/max|ref|={rel:.6g}, flow agreement {agree:.6f}")
            if rel > KERNEL_TOL or agree < WA_FLOW_AGREE:
                raise AssertionError(
                    f"window_attention [{label}]: out {rel:.4g} (bound "
                    f"{KERNEL_TOL}), flow agreement {agree:.4f} (bound "
                    f"{WA_FLOW_AGREE})")
            fs = {"": lambda: wa.window_attention(*args),
                  "plain_": lambda: wa.window_attention_plain(*args)}
            ms = median_ms(fs[""])
            plain_ms = median_ms(fs["plain_"], iters=3, reps=3)
            device = {"device_ms": median_ms(fs[""], spin=True),
                      "plain_device_ms": median_ms(fs["plain_"], iters=3,
                                                   reps=3, spin=True)}
            rows[WA_ROWS[(b, label.endswith("k = v"))]] = timed(
                "window_attention", label, args, (out, flow), d, ms,
                plain_ms, None, device)
        k1 = torch.roll(q, shifts=(-1, -2), dims=(1, 2))
        for label, args in (("k = v", (q, k1, bk, k1, bk)),
                            ("k != v", (q, k1, bk, v1, v2))):
            _, shift_flow = wa.window_attention(*args, 5, 9)
            inner = shift_flow[:, 2:-2, 4:-4, :2]
            want = torch.tensor([-2.0, -1.0], device=dev)
            hit = (inner == want).all(-1).float().mean().item()
            print(f"  window_attention [B={b}, {label}, known shift] interior "
                  f"flow == (-2, -1) on {hit:.6f} of the pixels")
            if hit != 1.0:
                raise AssertionError(f"window_attention: known shift found on "
                                     f"{hit:.4f} of the interior")
        del q, f, bk, v1, v2, k1
    # a ragged map: query tiles and key slabs cut at the right and bottom
    q, f, bk = (torch.randn((1, 37, 70, 128), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(3))
    (out, flow), (ref, ref_flow) = wa.window_attention(q, f, bk, f, bk, 5, 9), \
        wa.window_attention_plain(q, f, bk, f, bk, 5, 9)
    torch.cuda.synchronize()
    _held("window_attention", "ragged 1x37x70, k = v", out, ref)
    agree = flow_agreement(flow, ref_flow)
    print(f"  window_attention [ragged 1x37x70] flow agreement {agree:.6f}")
    if agree < WA_FLOW_AGREE:
        raise AssertionError(f"window_attention [ragged]: flow agreement "
                             f"{agree:.4f} (bound {WA_FLOW_AGREE})")
    return rows


def rel_l2(out, ref):
    ref = ref.double()
    return ((out.double() - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def _carrier_inputs(dev, g, B, H, W):
    """Backward-check inputs whose pre-activations all stay >= ~0.3 away
    from zero, so both sides take the same lrelu masks and dx can be held
    by its max.  Near zero a mask can differ between two correct
    implementations that sum in another order, and one such element moves
    dx by a few percent of its max (one run on random data moved the
    stem's dx by 3.5%).  The stem's convs add N(0, 0.12)-sized terms to a
    +-1 bias; the Bottleneck has no bias, so channel 0 of x, h1 and h2
    carries a constant 1 that k1, k2 and k3 turn into a +-1 (+-2 for k3)
    offset per output channel.  Every mask is then the same at all pixels
    of a channel, so these inputs cannot see a mask taken from the wrong
    pixel: the random-input cases of ``train_kernel_phase`` do."""
    def u(*shape):
        return torch.rand(shape, generator=g, device=dev) * 2 - 1

    def n(*shape, std):
        return torch.randn(shape, generator=g, device=dev) * std

    def sign(c):
        return torch.where(torch.rand(c, generator=g, device=dev) < 0.5,
                           -1.0, 1.0)

    stem = (u(B, H, W, 14).to(torch.bfloat16),
            n(64, 14, 3, 3, std=0.12 / 42 ** 0.5), sign(64),
            n(64, 64, 3, 3, std=0.12 / 300 ** 0.5), sign(64))

    def block(ci, proj):
        x = u(B, H, W, ci)
        x[..., 0] = 1.0
        k1 = n(64, ci, 1, 1, std=0.12 / (ci / 3) ** 0.5)
        k1[:, 0, 0, 0] = sign(64)
        k1[0] = 0.0
        k1[0, 0, 0, 0] = 1.0               # h1[..., 0] == 1
        k2 = n(64, 64, 3, 3, std=0.12 / 300 ** 0.5)
        k2[:, 0, 1, 1] = sign(64)
        k2[0] = 0.0
        k2[0, 0, 1, 1] = 1.0               # h2[..., 0] == 1
        k3 = n(256, 64, 1, 1, std=0.12 / 32 ** 0.5)
        k3[:, 0, 0, 0] = 2 * sign(256)
        kres = n(256, ci, 1, 1, std=0.2 / (ci / 3) ** 0.5) if proj else None
        return x.to(torch.bfloat16), k1, k2, k3, kres

    return stem, block(64, True), block(256, False)


def _carrier_chain(dev, g, B, H, W, n, c=64):
    """``_carrier_inputs`` for a chain of n BasicBlocks at c channels: channel 0 of x
    carries a constant 1, which k1 turns into a +-1 offset per h channel
    (and copies to h's channel 0) and k2 into a +-2 offset per output
    channel (0 for channel 0, whose output stays x's 1).  The +-2 signs are
    the same in every block, so an output channel grows or stays near
    -0.5 block after block and never crosses zero; x's other channels lie
    in [-0.5, 0.5) and the weights' noise adds <= ~0.1."""
    def n_(*shape, std):
        return torch.randn(shape, generator=g, device=dev) * std

    def sign(c):
        return torch.where(torch.rand(c, generator=g, device=dev) < 0.5,
                           -1.0, 1.0)

    x = torch.rand((B, H, W, c), generator=g, device=dev) - 0.5
    x[..., 0] = 1.0
    s2 = 2 * sign(c)
    pairs = []
    for _ in range(n):
        k1 = n_(c, c, 3, 3, std=8e-4)
        k1[:, 0, 1, 1] = sign(c)
        k1[0] = 0.0
        k1[0, 0, 1, 1] = 1.0               # h[..., 0] == 1
        k2 = n_(c, c, 3, 3, std=8e-4)
        k2[:, 0, 1, 1] = s2
        k2[0] = 0.0                        # y[..., 0] == x[..., 0] == 1
        pairs.append((k1, k2))
    return x.to(torch.bfloat16), pairs


def _stem_bwd_plain_own(x, dy, s1, y, k1, b1, k2, b2):
    """The plain backward on its own forward (``stem_bwd_plain``
    recomputes pre1, s1 and pre2 from x): on the carrier inputs no mask
    can flip, so each side runs its own forward."""
    return tc.stem_bwd_plain(x[..., :k1.shape[1]], dy, k1, b1, k2, b2)


def _stem_fwd_saved(x, k1, b1, k2, b2):
    """The stem forward of the train step: (y, s1), s1 stored."""
    return tc.stem_fwd_kernel(x, k1, b1, k2, b2, save=True)


def _stem_fwd_saved_plain(x, k1, b1, k2, b2):
    """(y, s1) of the plain stem: s1 = lrelu(conv3x3(x, k1) + b1)."""
    s1 = tc._lrelu(tc._conv(x, k1) + b1.to(x.dtype))
    return tc.stem_plain(x, k1, b1, k2, b2), s1


def _flat_grads(dx, grads):
    return (dx, *(d for pair in grads for d in pair))


def _bb_bwd_kernel(x, dy, pairs, saved):
    """The chain's backward kernels on what the kernel forward kept
    (``saved`` = (block outputs, h per block)), as the train step's
    backward runs them; (dx, dk1_0, dk2_0, ...)."""
    return _flat_grads(*bb.bb_chain_bwd_kernel(x, dy, pairs, *saved))


def _bb_bwd_plain(x, dy, pairs, saved):
    """The hand-written plain backward on the kernel forward's block
    inputs (it recomputes h itself).  Given its own forward's block
    outputs instead, on random data, the two sides differ by more than the
    kernels do: the two forwards' outputs part by bf16 rounding, the
    backward's lrelu masks at near-zero pre-activations follow them, and
    dx moved by rel-L2 2.4e-2 at N = 4 (forward outputs 2.2e-3 apart at
    block 4) against 9e-4 at N = 1 (H100, 24x128x128)."""
    return _flat_grads(*bb.bb_chain_bwd_plain(x, dy, pairs, saved[0][:-1]))


def _bb_bwd_plain_own(x, dy, pairs, saved):
    """The plain backward on its own forward: on the carrier inputs no
    mask can flip, so each side runs its own forward."""
    return _flat_grads(*bb.bb_chain_bwd_plain(x, dy, pairs))


def _wgrad_plain(pairs_ad):
    """The weight grads of ``bb.bb_chain_wgrad_kernel``, plain: f32 OIHW."""
    return tuple(tc._conv_wgrad(a, d, (d.shape[-1], a.shape[-1], 3, 3))
                 for a, d in pairs_ad)


def _wgrad_kernel(pairs_ad):
    return tuple(bb.bb_chain_wgrad_kernel(pairs_ad))


def k1_backward_check(dev):
    """K1's backward (``ops/recompute.py``: autograd of the plain version
    recomputed) against plain autograd at the BasicBlock conv2 site, 64 ch,
    24x128x128 bf16: dx and dres by max|d|/max|ref| <= KERNEL_TOL, dw by
    rel-L2 <= WGRAD_TOL.  The train step no longer launches K1, so this
    keeps its backward checked on the card.  That backward is by design
    the plain version's autograd, recomputed, so the grads match to the
    bit: what this holds is K1's forward and the recompute's plumbing
    (saved inputs, casts, the residual's grad), not a backward kernel."""
    g = torch.Generator(device=dev).manual_seed(6)
    B, H, W = 24, 128, 128
    x, res, dy = (torch.randn((B, H, W, 64), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(3))
    w = torch.randn((64, 64, 3, 3), generator=g, device=dev) / 24

    def grads(fn):
        xs, rs, ws = (t.detach().clone().requires_grad_() for t in (x, res, w))
        out = fn(xs, ws, None, rs, True)
        out.backward(dy)
        return out.detach(), xs.grad, rs.grad, ws.grad

    got = grads(k1.conv3x3_bias_res_lrelu)
    want = grads(k1.conv3x3_bias_res_lrelu_plain)
    torch.cuda.synchronize()
    for label, o, r in zip(("y", "dx", "dres"), got[:3], want[:3]):
        _, rel = rel_err(o, r)
        print(f"  conv3x3_bias_res_lrelu backward [{label}] "
              f"max|d|/max|ref|={rel:.6g}")
        if not torch.isfinite(o).all() or rel > KERNEL_TOL:
            raise AssertionError(f"K1 backward: {label} {rel:.4g}")
    l2 = rel_l2(got[3], want[3])
    print(f"  conv3x3_bias_res_lrelu backward [dw] rel-L2={l2:.6g}")
    if not torch.isfinite(got[3]).all() or l2 > WGRAD_TOL:
        raise AssertionError(f"K1 backward: dw rel-L2 {l2:.4g}")


def k4_backward_check(dev):
    """K4's backward (``upshead.ups_head_taps_bwd``: h by the kernel's h
    mode, then the products on bf16 operands, dh and dcat rounded once to
    bf16, dw1 and dw2t f32 results) at the recipe shape, 24x128x128,
    against its f32-operand form: the same function on f32 copies of the
    operands and of the same h, TF32 off.  dp0, dp1, dp2 by max|d|/max|ref|
    <= KERNEL_TOL (bf16 results), dw1, db1, dw2t by rel-L2 <= WGRAD_TOL.
    Prints the median CUDA-event ms of both forms."""
    g = torch.Generator(device=dev).manual_seed(10)

    def act(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    def w(*shape):
        return torch.randn(shape, generator=g, device=dev) / (
            shape[1] * shape[2] * shape[3]) ** 0.5

    B, H, W = 24, 128, 128
    args = (act(B, H, W, 64), act(B, H // 2, W // 2, 128),
            act(B, H // 4, W // 4, 256), w(896, 448, 1, 1)[:, :, 0, 0].t(),
            w(896, 1, 1, 1).flatten(),
            k4.build_dual_tap_kernel(w(3, 448, 3, 3), w(20, 448, 3, 3),
                                     torch.float32),
            act(B, H, W, 207, scale=1e-2))
    h32 = k4.ups_head_1x1(*args[:5]).float()

    def f32_form():
        return k4.ups_head_taps_bwd(*(t.float() for t in args), h=h32)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got, ref = k4.ups_head_taps_bwd(*args), f32_form()
        torch.cuda.synchronize()
        for name, o, r in zip(("dp0", "dp1", "dp2"), got[:3], ref[:3]):
            if o.dtype != torch.bfloat16:
                raise AssertionError(f"K4 backward {name}: dtype {o.dtype}")
            _held("ups_head_taps_bwd", name, o, r)
        for name, o, r in zip(("dw1", "db1", "dw2t"), got[3:], ref[3:]):
            l2 = rel_l2(o, r)
            print(f"  ups_head_taps_bwd [{name}] rel-L2={l2:.6g}")
            if (o.dtype != torch.float32 or not torch.isfinite(o).all()
                    or l2 > WGRAD_TOL):
                raise AssertionError(f"K4 backward {name}: rel-L2 {l2:.4g} "
                                     f"or dtype {o.dtype}")
        ms = median_ms(lambda: k4.ups_head_taps_bwd(*args), iters=3, reps=3)
        f32_ms = median_ms(f32_form, iters=3, reps=3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"  ups_head_taps_bwd [24x128x128] bf16 {ms:.4f} ms (h mode "
          f"included), f32-operand form {f32_ms:.4f} ms")
    return ms


def train_kernel_phase(dev):
    """The train-chain kernels and K4's h mode against their plain
    versions at the recipe shapes (24x128x128 bf16): outputs by
    max|d|/max|ref| <= KERNEL_TOL, every weight and bias grad by rel-L2 <=
    WGRAD_TOL (f32 partials summed in another order).  Forward checks on
    random data.  Each backward runs on ``_carrier_inputs`` (dx by
    max|d|/max|ref| <= KERNEL_TOL) and on the forward's random inputs
    (biases of std 1), where the masks vary per pixel, so a mask taken
    from the wrong pixel or halo ring fails: there a few near-zero mask
    flips are legitimate, so dx is held by rel-L2 <= DX_L2_TOL.  (Taking
    the mask of each tile's first column from its left neighbour moves
    the plain backward's dx by rel-L2 0.15 and its weight grads by 0.15
    on random inputs, and by 0 on the carrier inputs.)"""
    g = torch.Generator(device=dev).manual_seed(3)

    def act(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    def w(*shape):       # torch conv weight, lecun-normal scale, f32 master
        return torch.randn(shape, generator=g, device=dev) / (
            shape[1] * shape[2] * shape[3]) ** 0.5

    B, H, W = 24, 128, 128
    stem_w = (w(64, 14, 3, 3), w(64, 1, 1, 1).flatten(), w(64, 64, 3, 3),
              w(64, 1, 1, 1).flatten())
    x64, x256 = act(B, H, W, 64), act(B, H, W, 256)
    blk0 = (w(64, 64, 1, 1), w(64, 64, 3, 3), w(256, 64, 1, 1),
            w(256, 64, 1, 1))
    blk1 = (w(64, 256, 1, 1), w(64, 64, 3, 3), w(256, 64, 1, 1), None)
    p1, p2 = act(B, H // 2, W // 2, 128), act(B, H // 4, W // 4, 256)
    w1 = w(896, 448, 1, 1)[:, :, 0, 0].t()
    b1 = w(896, 1, 1, 1).flatten()
    c_stem, c_blk0, c_blk1 = _carrier_inputs(dev, g, B, H, W)
    pairs4 = [(w(64, 64, 3, 3), w(64, 64, 3, 3)) for _ in range(4)]
    c_x, c_pairs = _carrier_chain(dev, g, B, H, W, 4)
    # what the kernel forward keeps for the backward: outputs and h
    saved4 = bb.bb_chain_fwd_saved(x64, pairs4)
    saved1 = bb.bb_chain_fwd_saved(x64, pairs4[:1])
    c_saved = bb.bb_chain_fwd_saved(c_x, c_pairs)
    dy64, dy256 = act(B, H, W, 64, scale=1e-3), act(B, H, W, 256, scale=1e-3)
    # the wider chains at the shapes their routes give them: branch 1 of
    # the recipe (128 ch at 64x64) and branch 2 of a 24x64x128 input (256
    # ch at 16x32, DVIE_BBCHAIN=rest|all)
    wide = {}
    for c, (hh, ww) in ((128, (H // 2, W // 2)), (256, (16, 32))):
        xc, dyc = act(B, hh, ww, c), act(B, hh, ww, c, scale=1e-3)
        pc = [(w(c, c, 3, 3), w(c, c, 3, 3)) for _ in range(4)]
        cx, cp = _carrier_chain(dev, g, B, hh, ww, 4, c)
        wide[c] = (xc, dyc, pc, bb.bb_chain_fwd_saved(xc, pc), cx, cp,
                   bb.bb_chain_fwd_saved(cx, cp))
    # the weight grads of the N = 4 chain: (x or h of each block, a grad)
    wjobs = [(a, dy64) for i in range(4) for a in (
        ([x64] + saved4[0][:-1])[i], saved4[1][i])]
    # name: [(label, kernel fn, plain fn, args, how output 0 is held, the
    # result row it is timed for or None)]; of each output tuple the first
    # item is an activation or dx ("max": max|d|/max|ref| <= KERNEL_TOL,
    # "l2": rel-L2 <= DX_L2_TOL), the rest are grads (rel-L2 <= WGRAD_TOL)
    fwd, bwd = (tc.bottleneck_fwd_kernel, tc.bottleneck_plain), (
        tc.bottleneck_bwd_kernel, tc.bottleneck_bwd_plain)
    bb_fwd = (bb.bb_chain_fwd_kernel, bb.bb_chain_plain)
    bb_bwd = (_bb_bwd_kernel, _bb_bwd_plain)
    x14 = act(B, H, W, 14)
    bn_ops = [act(B, H, W, 64) for _ in range(4)]   # h1, h2, dpre2, dpre1
    # the stem's backward reads what the kernel forward kept (s1, y) and,
    # as in the train step, the zero-padded x; a ragged shape (tiles cut at
    # both edges) on random and fixed-mask inputs
    xr14, dyr = act(2, 36, 120, 14), act(2, 36, 120, 64, scale=1e-3)
    c_stem_r = _carrier_inputs(dev, g, 2, 36, 120)[0]
    stem_bwd_cases = []
    for label, xs, dys, ws, hold, row in (
            ("stem, fixed masks", c_stem[0], dy64, c_stem[1:], "max", None),
            ("stem, random", x14, dy64, stem_w, "l2", "stem_bwd"),
            ("ragged 2x36x120, fixed masks", c_stem_r[0], dyr, c_stem_r[1:],
             "max", None),
            ("ragged 2x36x120, random", xr14, dyr, stem_w, "l2", None)):
        y_k, s1_k = tc.stem_fwd_kernel(xs, *ws, save=True)
        torch.cuda.synchronize()
        # what the backward reads is held as the forward's output is
        for what, o, r in zip(("y", "s1"), (y_k, s1_k),
                              _stem_fwd_saved_plain(xs, *ws)):
            d, rel = rel_err(o, r)
            print(f"  stem_fwd [{label}, save] {what} max|d|={d:.6g} "
                  f"max|d|/max|ref|={rel:.6g}")
            if (o.shape != r.shape or not torch.isfinite(o).all()
                    or rel > KERNEL_TOL):
                raise AssertionError(
                    f"stem_fwd [{label}, save]: {what} shape "
                    f"{tuple(o.shape)} vs {tuple(r.shape)}, max|d|/max|ref| "
                    f"{rel:.4g} (bound {KERNEL_TOL})")
        plain = (_stem_bwd_plain_own if hold == "max"
                 else tc.stem_bwd_saved_plain)
        stem_bwd_cases.append((label, tc.stem_bwd_kernel, plain,
                               (tc._pad16(xs), dys, s1_k, y_k, *ws), hold,
                               row))
    cases = {
        "stem_fwd": [("stem", tc.stem_fwd_kernel, tc.stem_plain,
                      (x14, *stem_w), "max", "stem_fwd"),
                     ("ragged 2x36x120", tc.stem_fwd_kernel, tc.stem_plain,
                      (xr14, *stem_w), "max", None),
                     # the train step's forward: s1 stored for the backward
                     ("stem, s1 stored", _stem_fwd_saved,
                      _stem_fwd_saved_plain, (x14, *stem_w), "max",
                      "stem_fwd_saved")],
        "stem_bwd": stem_bwd_cases,
        "bottleneck_fwd": [("block 0", *fwd, (x64, *blk0), "max",
                            "bottleneck_fwd_b0"),
                           ("block 1", *fwd, (x256, *blk1), "max",
                            "bottleneck_fwd")],
        "bottleneck_bwd": [
            ("block 0, fixed masks", *bwd, (c_blk0[0], dy256, *c_blk0[1:]),
             "max", None),
            ("block 1, fixed masks", *bwd, (c_blk1[0], dy256, *c_blk1[1:]),
             "max", None),
            ("block 0, random", *bwd, (x64, dy256, *blk0), "l2",
             "bottleneck_bwd_b0"),
            ("block 1, random", *bwd, (x256, dy256, *blk1), "l2",
             "bottleneck_bwd")],
        # N = 1 is pallas_resblock.fused_basicblock and
        # pallas_bb.fused_basicblock_hwnc; N = 4 is the train step's chain
        "bb_chain_fwd": [("N=1", *bb_fwd, (x64, pairs4[:1]), "max",
                          "bb_chain_fwd_n1"),
                         ("N=4", *bb_fwd, (x64, pairs4), "max",
                          "bb_chain_fwd")],
        "bb_chain_bwd": [
            ("N=4, fixed masks, own forwards", _bb_bwd_kernel,
             _bb_bwd_plain_own, (c_x, dy64, c_pairs, c_saved), "max", None),
            ("N=1, random", *bb_bwd, (x64, dy64, pairs4[:1], saved1), "l2",
             None),
            ("N=4, random", *bb_bwd, (x64, dy64, pairs4, saved4), "l2",
             "bb_chain_bwd")],
        **{f"bb_chain_fwd_c{c}": [
            (f"C={c}, N=4", *bb_fwd, wide[c][:1] + wide[c][2:3], "max",
             f"bb_chain_fwd_c{c}")] for c in wide},
        **{f"bb_chain_bwd_c{c}": [
            (f"C={c}, N=4, fixed masks, own forwards", _bb_bwd_kernel,
             _bb_bwd_plain_own, (wide[c][4], wide[c][1], wide[c][5],
                                 wide[c][6]), "max", None),
            (f"C={c}, N=4, random", *bb_bwd, wide[c][:4], "l2",
             f"bb_chain_bwd_c{c}")] for c in wide},
        # the Bottleneck's weight-grad launch on its operands (x, h1, h2,
        # dpre2, dpre1, dpre_y), as the backward stores them
        "bottleneck_wgrad": [
            ("block 0", tc.bottleneck_wgrad_kernel, tc.bottleneck_wgrad_plain,
             (x64, *bn_ops, act(B, H, W, 256)), "l2", None),
            ("block 1", tc.bottleneck_wgrad_kernel, tc.bottleneck_wgrad_plain,
             (x256, *bn_ops, act(B, H, W, 256)), "l2", "bottleneck_wgrad")],
        "bb_chain_wgrad": [("C=64, 8 weights of N=4", _wgrad_kernel,
                            _wgrad_plain, (wjobs,), "l2", "bb_chain_wgrad")],
        "ups_head_1x1": [("heads", k4.ups_head_1x1, k4.ups_head_1x1_plain,
                          (x64, p1, p2, w1, b1), "max", "ups_head_1x1")],
    }
    results = {}
    for name, variants in cases.items():
        worst_abs, worst_rel, worst_dx_l2, worst_l2 = 0.0, 0.0, 0.0, 0.0
        for label, kern, plain, args, hold, _ in variants:
            out, ref = kern(*args), plain(*args)
            torch.cuda.synchronize()
            outs = out if isinstance(out, tuple) else (out,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            for i, (o, r) in enumerate(zip(outs, refs)):
                if (o is None) != (r is None):
                    raise AssertionError(f"{name} [{label}]: output {i} "
                                         "missing on one side")
                if o is None:
                    continue
                if o.shape != r.shape or not torch.isfinite(o).all():
                    raise AssertionError(
                        f"{name} [{label}] output {i}: shape "
                        f"{tuple(o.shape)} vs {tuple(r.shape)} or non-finite")
                l2 = rel_l2(o, r)
                if i == 0:
                    d, rel = rel_err(o, r)
                    print(f"  {name} [{label}] out max|d|={d:.6g} "
                          f"max|d|/max|ref|={rel:.6g} rel-L2={l2:.6g}")
                    worst_abs = max(worst_abs, d)
                    if hold == "max":
                        worst_rel = max(worst_rel, rel)
                    else:
                        worst_dx_l2 = max(worst_dx_l2, l2)
                else:
                    print(f"  {name} [{label}] grad {i} rel-L2={l2:.6g}")
                    worst_l2 = max(worst_l2, l2)
        if (worst_rel > KERNEL_TOL or worst_dx_l2 > DX_L2_TOL
                or worst_l2 > WGRAD_TOL):
            raise AssertionError(
                f"{name}: max|d|/max|ref| {worst_rel:.4g} (bound "
                f"{KERNEL_TOL}), dx rel-L2 on random inputs "
                f"{worst_dx_l2:.4g} (bound {DX_L2_TOL}), weight-grad rel-L2 "
                f"{worst_l2:.4g} (bound {WGRAD_TOL})")
        for label, kern, plain, args, _, row in variants:
            if row is not None:
                fs = {"": lambda: kern(*args), "plain_": lambda: plain(*args)}
                device = ({f"{k}device_ms": median_ms(f, iters=5, reps=3,
                                                      spin=True)
                           for k, f in fs.items()}
                          if name in DEVICE_TIMED else None)
                results[row] = timed(
                    name, label, args, kern(*args), worst_abs,
                    median_ms(fs[""], iters=5, reps=3),
                    median_ms(fs["plain_"], iters=5, reps=3), None, device)
    return results


CFG = Config(model="InterNet", coarse_model="HRNet", syn_type="inter",
             compute_dtype="bfloat16")


def _inputs(dev, b, h, w, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    imgs = [torch.rand((b, h, w, 3), generator=g, device=dev) for _ in range(2)]
    ids = [torch.randint(0, 20, (b, h, w), generator=g, device=dev,
                         dtype=torch.uint8) for _ in range(2)]
    return imgs, ids


def slice_phase(dev, cfg=CFG, label="slice"):
    """Kernel model against the plain model on the final frame and seg
    (``serve.final_output``); for InterStage3Net also the flow maps."""
    b, h, w = 2, 128, 256
    fast = registry.build_model(cfg, device=dev, seed=0)
    plain = registry.build_model(cfg, device=dev, seed=0, use_kernels=False)
    imgs, ids = _inputs(dev, b, h, w, 1)
    rgb = torch.cat(imgs, -1) * 2 - 1
    seg = torch.cat([serve.seg_oh(i) for i in ids], -1)
    with torch.inference_mode():
        o_k, o_p = fast(rgb, seg), plain(rgb, seg)
    torch.cuda.synchronize()
    (r_k, s_k), (r_p, s_p) = serve.final_output(o_k), serve.final_output(o_p)
    if len(o_k) == 5:
        agree = flow_agreement(o_k[4][0], o_p[4][0])
        print(f"{label} 2x128x256 bf16: flow map agreement {agree:.6f} "
              f"(bound {SLICE_FLOW_AGREE})")
        if agree < SLICE_FLOW_AGREE:
            raise AssertionError(f"{label}: flow agreement {agree:.4f}")
    d = (r_k.float() - r_p.float()).abs().max().item()
    limit = SLICE_RGB_TOL * max(1.0, r_p.float().abs().max().item())
    agree = (s_k.argmax(-1) == s_p.argmax(-1)).float().mean().item()
    print(f"{label} 2x128x256 bf16: rgb max|d|={d:.6g} (bound {limit:.4g}), "
          f"seg argmax agreement {agree:.6f} (bound {SLICE_SEG_AGREE})")
    if not (torch.isfinite(r_k).all() and torch.isfinite(s_k).all()):
        raise AssertionError(f"{label}: non-finite output")
    if d > limit:
        raise AssertionError(f"{label}: rgb max|d| {d:.4g} > {limit:.4g}")
    if agree < SLICE_SEG_AGREE:
        raise AssertionError(f"{label}: seg agreement {agree:.4f} < "
                             f"{SLICE_SEG_AGREE}")


def serve_phase(dev, card, cfg=CFG, per_forward=PER_FORWARD,
                label="serve rollout"):
    b, h, w, steps = 2, 512, 1024, 3
    model = registry.build_model(cfg, device=dev, seed=0)
    imgs, ids = _inputs(dev, b, h, w, 2)
    serve.rollout(model, imgs, ids, 1)               # warm-up
    torch.cuda.synchronize()
    hw.reset_counters()
    t0 = time.perf_counter()
    preds, pred_ids = serve.rollout(model, imgs, ids, steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(hw.launches)
    for name in hw.KERNELS:
        per = per_forward.get(name, 0)
        if counts[name] != per * steps:
            raise AssertionError(f"{label}: {name} launched {counts[name]} "
                                 f"times, expected {per} x {steps}")
    for p, i in zip(preds, pred_ids):
        if p.shape != (b, h, w, 3) or not torch.isfinite(p.float()).all():
            raise AssertionError(f"{label}: bad predicted frame")
        if i.shape != (b, h, w) or int(i.max()) >= 20:
            raise AssertionError(f"{label}: bad seg ids")
    fps = b * steps / dt
    print(f"{label} {steps} steps at {b}x{h}x{w} bf16: {dt:.4f} s, "
          f"{fps:.4f} frames/s on {card}")
    return counts


def train_batch(dev, b, h, w, seed):
    """A seeded INTER batch: frames in [-1, 1], uint8 seg ids."""
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = {f"frame{i}": torch.rand((b, h, w, 3), generator=g, device=dev)
             * 2 - 1 for i in (1, 2, 3)}
    batch.update({f"seg{i}": torch.randint(0, 20, (b, h, w), generator=g,
                                           device=dev, dtype=torch.uint8)
                  for i in (1, 2, 3)})
    return batch


def train_setup(dev, use_kernels, dtype="bfloat16", train=True):
    """InterNet/HRNet from seed 0, frozen VGG19 from seed 1, Adamax."""
    cfg = dataclasses.replace(CFG, compute_dtype=dtype, train_coarse=train)
    model = registry.build_model(cfg, device=dev, seed=0,
                                 use_kernels=use_kernels)
    state = state_lib.create_train_state(
        cfg, model, init_vgg_frozen(cfg, seed=1, device=dev))
    return inter.make_train_step(cfg, model), state


def step_grads(dev, use_kernels, dtype, batch):
    """The loss dict and the f32 gradient of every leaf of one step (no
    update)."""
    step, state = train_setup(dev, use_kernels, dtype, train=False)
    _, losses = step(state, batch)
    grads = {n: p.grad.float() for n, p in state.model.named_parameters()}
    return {k: float(v) for k, v in losses.items()}, grads


def _flat(grads):
    return torch.cat([g.flatten() for g in grads.values()])


def _train_chain_leaf(name: str, branches=(0,)) -> bool:
    """The leaves the train kernels compute the grads of: the stem (conv1,
    conv2), layer1, and the BasicBlocks of ``branches`` in stages 2 and 3
    (branch 0 on the chain or on K1; branches 1 and 2 on the chain under
    DVIE_BBCHAIN=rest|all)."""
    return name.startswith(("coarse_model.conv1.", "coarse_model.conv2.",
                            "coarse_model.layer1.") + tuple(
        f"coarse_model.stage{s}.0.branches.{i}." for s in (2, 3)
        for i in branches))


# train-kernel leaves per set of branches: conv1/conv2 w+b, 4 x 3 convs, 1
# downsample (15); 2 stages x 4 x 2 convs per branch 0 or 1 (16); branch 2
# in stage 3 only (8)
N_LEAVES = {(0,): 33, (0, 1): 49, (0, 1, 2): 57}


def _check_grad(label, g_k, g_p, g_ref):
    """Prints the gradients' rel-L2 errors; returns the failure, if the
    kernel one's from the f32 one is over GRAD_RATIO x the plain bf16
    one's + GRAD_FLOOR, or None."""
    err_k, err_p = rel_l2(g_k, g_ref), rel_l2(g_p, g_ref)
    bound = GRAD_RATIO * err_p + GRAD_FLOOR
    print(f"  {label}: grad rel-L2 vs f32: kernel {err_k:.6g}, plain bf16 "
          f"{err_p:.6g} (bound {bound:.6g}); kernel vs plain "
          f"{rel_l2(g_k, g_p):.6g}")
    if torch.isfinite(g_k).all() and err_k <= bound:
        return None
    return f"{label}: kernel grad error {err_k:.4g} > {bound:.4g} or non-finite"


def grad_check(dev, b, h, w, branches=(0,), g_ref=None, label="train"):
    """Phase 5a: one step's gradients and losses, kernel vs plain.  The
    whole gradient is held, then each train-kernel leaf on its own (those
    of ``branches``): they are a small part of the whole norm, so an error
    there would hide in it.  ``g_ref``: the f32 plain gradient of this
    batch, if already computed (the f32 model is the same function on
    every route).  Returns it."""
    batch = train_batch(dev, b, h, w, seed=4)
    if g_ref is None:
        tf32 = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            _, g_ref = step_grads(dev, False, "float32", batch)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = tf32
    l_k, g_k = step_grads(dev, True, "bfloat16", batch)
    l_p, g_p = step_grads(dev, False, "bfloat16", batch)
    print(f"{label} step {b}x{h}x{w}:")
    leaves = [n for n in g_ref if _train_chain_leaf(n, branches)]
    if len(leaves) != N_LEAVES[tuple(branches)]:
        raise AssertionError(f"{label}: {len(leaves)} train-kernel leaves, "
                             f"expected {N_LEAVES[tuple(branches)]}")
    fails = [_check_grad("whole gradient", _flat(g_k), _flat(g_p),
                         _flat(g_ref))]
    fails += [_check_grad(n, g_k[n], g_p[n], g_ref[n]) for n in leaves]
    fails = [f for f in fails if f]
    if fails:
        raise AssertionError(f"{label}: " + "; ".join(fails))
    for k in l_p:
        rel = abs(l_k[k] - l_p[k]) / max(abs(l_p[k]), 1e-30)
        print(f"  {k}: kernel {l_k[k]:.6g} plain {l_p[k]:.6g} rel {rel:.3g}")
        if rel > LOSS_TOL:
            raise AssertionError(f"{label}: {k} differs by {rel:.4g} > "
                                 f"{LOSS_TOL}")
    return g_ref


def trajectory(dev, use_kernels, b, h, w, steps=20, warmup=2, count_at=2):
    """Phase 5b: ``steps`` Adamax steps on one fixed batch.  Returns the
    loss_all trajectory, the step times after the warm-ups (host clock,
    synchronized around each step) and the launches of step ``count_at``."""
    step, state = train_setup(dev, use_kernels)
    batch = train_batch(dev, b, h, w, seed=5)
    losses, times, counts = [], [], None
    for i in range(steps):
        torch.cuda.synchronize()
        if i == count_at:
            hw.reset_counters()
        t0 = time.perf_counter()
        state, ld = step(state, batch)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - t0)
        if i == count_at:
            counts = dict(hw.launches)
        losses.append(float(ld["loss_all"]))
    return losses, times, counts


def train_phase(dev, card):
    """Phase 5 under the default DVIE_BBCHAIN=b0.  Returns the counted
    step's launches and the f32 reference gradient of the grad check."""
    b, h, w = 24, 128, 128
    g_ref = grad_check(dev, b, h, w)
    runs = {}
    for name, use_kernels in (("kernel", True), ("plain", False)):
        losses, times, counts = trajectory(dev, use_kernels, b, h, w)
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"train {name}: non-finite loss {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"train {name}: loss_all did not fall: "
                                 f"{losses[0]:.6g} -> {losses[-1]:.6g}")
        rate = b / statistics.median(times)
        print(f"train {name} model: loss_all {losses[0]:.6g} -> "
              f"{losses[-1]:.6g} over {len(losses)} steps; "
              f"{rate:.4f} samples/s (median of {len(times)} steps) on {card}")
        print(f"  loss_all: {' '.join(f'{v:.5g}' for v in losses)}")
        runs[name] = (losses, rate, counts)
    final_k, final_p = runs["kernel"][0][-1], runs["plain"][0][-1]
    gap = abs(final_k - final_p) / abs(final_p)
    print(f"train: final loss_all kernel {final_k:.6g} plain {final_p:.6g} "
          f"(rel {gap:.4g}, bound {TRAJ_TOL})")
    if gap > TRAJ_TOL:
        raise AssertionError(f"train: final loss differs by {gap:.4g}")
    counts = runs["kernel"][2]
    print(f"train step launches: {json.dumps(counts)}")
    _check_step_counts("train", counts, PER_TRAIN_STEP)
    return counts, g_ref


def _check_step_counts(label, counts, per_step):
    """Every kernel's launches in one counted step: ``per_step``'s, 0 for
    the kernels it does not name."""
    for name in hw.KERNELS:
        if counts[name] != per_step.get(name, 0):
            raise AssertionError(f"{label}: {name} launched {counts[name]} "
                                 f"times in one step, expected "
                                 f"{per_step.get(name, 0)}")


def _mode_steps(dev, card, mode, b, h, w, per_step, steps=12):
    """``steps`` kernel-model Adamax steps under DVIE_BBCHAIN=mode: finite
    losses, the launches of step 2 against ``per_step``, samples/s (median
    of the steps after 2 warm-ups).  Returns the counted launches."""
    losses, times, counts = trajectory(dev, True, b, h, w, steps=steps)
    label = f"train DVIE_BBCHAIN={mode} {b}x{h}x{w}"
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{label}: non-finite loss {losses}")
    print(f"{label}: kernel model {b / statistics.median(times):.4f} "
          f"samples/s (median of {len(times)} steps) on {card}; launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})}")
    _check_step_counts(label, counts, per_step)
    return counts


def bbchain_modes_phase(dev, card, g_ref):
    """Phase 5c: the train step under DVIE_BBCHAIN=0, rest and all at
    24x128x128 (``g_ref``: the f32 gradient of phase 5a's batch), and
    under all at 24x64x128, where branch 2 (256 ch at 16x32) takes the
    chain too: per mode one gradient check (the whole gradient and every
    leaf of the branches the mode runs on the train kernels, against the
    f32 plain model, as in phase 5a) and a counted, timed run.  Returns
    the counted launches of each run."""
    old = os.environ.get("DVIE_BBCHAIN")
    runs = []
    try:
        for mode, branches in (("0", (0,)), ("rest", (0, 1)),
                               ("all", (0, 1))):
            os.environ["DVIE_BBCHAIN"] = mode
            grad_check(dev, 24, 128, 128, branches, g_ref,
                       f"train DVIE_BBCHAIN={mode}")
            runs.append(_mode_steps(dev, card, mode, 24, 128, 128,
                                    PER_TRAIN_STEP_MODE[mode]))
        os.environ["DVIE_BBCHAIN"] = "all"
        grad_check(dev, *SMALL_ALL, (0, 1, 2), None, "train DVIE_BBCHAIN=all")
        runs.append(_mode_steps(dev, card, "all", *SMALL_ALL,
                                PER_TRAIN_STEP_SMALL_ALL, steps=6))
    finally:
        if old is None:
            os.environ.pop("DVIE_BBCHAIN", None)
        else:
            os.environ["DVIE_BBCHAIN"] = old
    return runs


CFG_HL = dataclasses.replace(CFG, highres_large=True)


def highres_phase(dev, card):
    """Phase 6: the --highres_large model.  Kernel vs plain model at
    2x128x256 (as the slice phase), then the 3-step rollout at 2x512x1024
    with the launches per forward asserted."""
    slice_phase(dev, CFG_HL, "highres_large slice")
    return serve_phase(dev, card, CFG_HL, PER_FORWARD_HL,
                       "highres_large rollout")


CFG_S3 = dataclasses.replace(CFG, model="InterStage3Net",
                             refine_model="SRNRefine")


def stage3_phase(dev, card):
    """Phase 7: InterStage3Net.  Kernel vs plain model at 2x128x256 (as the
    slice phase, with the flow maps), then the 3-step rollout at
    2x512x1024 with the launches per forward asserted."""
    slice_phase(dev, CFG_S3, "stage3 slice")
    return serve_phase(dev, card, CFG_S3, PER_FORWARD_S3, "stage3 rollout")


CFG_VAE = Config(model="VAE", vid_length=VAE_T, input_h=128, input_w=128,
                 compute_dtype="bfloat16")


def _vae_inputs(dev, b, seed):
    """A seeded VAE batch in bf16: T+1 frames in [0, 1], one-hot segs,
    complementary fg/bg masks, background noise."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h, w, t1 = CFG_VAE.input_h, CFG_VAE.input_w, VAE_T + 1
    rgb = torch.rand((b, t1, h, w, 3), generator=g, device=dev)
    seg = torch.nn.functional.one_hot(torch.randint(
        0, 20, (b, t1, h, w), generator=g, device=dev), 20)
    fg = (torch.rand((b, t1, h, w, 1), generator=g, device=dev) > 0.5)
    noise = torch.rand((b, h, w, 3), generator=g, device=dev)
    return [a.to(torch.bfloat16) for a in (rgb, seg, ~fg, fg, noise)]


def vae_phase(dev, card):
    """Phase 8: the video VAE.  Kernel model against the plain model at
    2x128x128 on the same weights and z_m, then the timed eval forwards at
    8x128x128 with the launches per forward asserted."""
    fast = registry.build_model(CFG_VAE, device=dev, seed=0)
    plain = registry.build_model(CFG_VAE, device=dev, seed=0,
                                 use_kernels=False)
    inputs = _vae_inputs(dev, 2, 11)
    z = torch.randn((2, 1024), generator=torch.Generator(
        device=dev).manual_seed(12), device=dev).to(torch.bfloat16)
    o_k = serve.predict_video(fast, *inputs, z_m=z)
    o_p = serve.predict_video(plain, *inputs, z_m=z)
    torch.cuda.synchronize()
    names = ("output", "y_pred", "flow", "flowback", "mask_fw", "mask_bw")
    tols = (KERNEL_TOL, None, VAE_FLOW_TOL, VAE_FLOW_TOL, VAE_FLOW_TOL,
            VAE_FLOW_TOL)
    for name, tol, k, p in zip(names, tols, o_k, o_p):
        if tol is None:        # the refined frame: the slice phase's bound
            d = (k.float() - p.float()).abs().max().item()
            limit = SLICE_RGB_TOL * max(1.0, p.float().abs().max().item())
            print(f"vae slice 2x128x128 bf16: y_pred max|d|={d:.6g} (bound "
                  f"{limit:.4g})")
            if d > limit or not torch.isfinite(k.float()).all():
                raise AssertionError(f"vae: y_pred max|d| {d:.4g}")
        else:
            _held("vae slice", name, k, p, tol)

    b, steps = 8, 3
    inputs = _vae_inputs(dev, b, 13)
    gen = torch.Generator(device=dev).manual_seed(14)
    serve.predict_video(fast, *inputs, generator=gen)          # warm-up
    torch.cuda.synchronize()
    hw.reset_counters()
    t0 = time.perf_counter()
    outs = [serve.predict_video(fast, *inputs, generator=gen)
            for _ in range(steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(hw.launches)
    for name in hw.KERNELS:
        per = PER_FORWARD_VAE.get(name, 0)
        if counts[name] != per * steps:
            raise AssertionError(f"vae: {name} launched {counts[name]} times, "
                                 f"expected {per} x {steps}")
    h, w = CFG_VAE.input_h, CFG_VAE.input_w
    for out in outs:
        for o, shape in zip(out, [(b, VAE_T, h, w, 3)] * 2
                            + [(b, VAE_T, h, w, 2)] * 2
                            + [(b, VAE_T, h, w, 1)] * 2):
            if o.shape != shape or not torch.isfinite(o.float()).all():
                raise AssertionError(f"vae: output {tuple(o.shape)} vs "
                                     f"{shape} or non-finite")
    fps = b * VAE_T * steps / dt
    print(f"vae eval {steps} forwards at {b}x{h}x{w} bf16, T={VAE_T}: "
          f"{dt:.4f} s, {fps:.4f} predicted frames/s on {card}")
    return counts


# the runner phase: the recipe's epochs through the launcher at
# 24x128x128 (8 synthetic batches an epoch), its val forwards at the same
# size (4 batches: stem and Bottlenecks on the train chain's forward, as W
# < 256), its cycgen at 2x512x1024 (4 forwards, the serving route) and a
# Cityscapes-layout epoch of 2 steps
RUNNER_EPOCH_STEPS, RUNNER_VAL_BATCHES, RUNNER_CYCGEN_FORWARDS = 8, 4, 4
PER_VAL_FORWARD = {"stem_fwd": 1, "bottleneck_fwd": 4, "bb_chain_fwd": 8,
                   "fuse_out0": 2, "ups_head_taps": 1, "shifted_add_bias": 1}
RESUME_LOSS_TOL = 2e-2     # resumed epoch-2 loss_all vs uninterrupted, rel
RELOAD_VAL_TOL = 1e-3      # val metrics of a reloaded checkpoint, relative
RECIPE = ("--dataset synthetic --split train --syn_type inter --input_h 128 "
          "--input_w 128 --bs 24 --disp_interval 1")
LOSS_LINE = re.compile(r"\[epoch +(\d+)\]\[iter +(\d+)\] loss: ([-0-9.naif]+)")
EPOCH_LINE = re.compile(r"\[epoch +(\d+)\] (\d+) samples in ([0-9.]+)s: "
                        r"([0-9.]+) samples/s, load: ([0-9.]+)s, comp: "
                        r"([0-9.]+)s")


def _log_of(exp_dir, split="train"):
    with open(os.path.join(exp_dir, f"experiment_{split}.log")) as f:
        return f.read()


def _counted(label, per, n, fn):
    """``fn()`` with the launch counters at 0 before it; every kernel's
    count must be ``per`` x ``n`` (0 for those ``per`` does not name).
    Returns (fn's result, the counts)."""
    torch.cuda.synchronize()
    hw.reset_counters()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(hw.launches)
    print(f"{label} launches: "
          f"{json.dumps({k: v for k, v in counts.items() if v})}")
    for name in hw.KERNELS:
        if counts[name] != per.get(name, 0) * n:
            raise AssertionError(f"{label}: {name} launched {counts[name]} "
                                 f"times, expected {per.get(name, 0)} x {n}")
    return out, counts


def _quiet(fn):
    """``fn()`` with the launcher's stdout log kept off this output (the
    experiment log file keeps it)."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


def _write_city_tree(root, n_clips, src=150):
    """A Cityscapes-layout tree of ``n_clips`` 3-frame train clips (src x
    src rgb and 20-class id maps, written by ``native/png.py``) and its
    clip pkl; returns (img_dir, seg_dir)."""
    g = torch.Generator().manual_seed(21)
    clips = []
    for c in range(n_clips):
        clip = [f"train/scene/clip{c}_{i:06d}" for i in range(3)]
        for rel in clip:
            for d, ext, arr in (
                    ("imgs", "_leftImg8bit.png", torch.randint(
                        0, 256, (src, src, 3), generator=g, dtype=torch.uint8)),
                    ("segs", "_gtFine_myseg_id.png", torch.randint(
                        0, 20, (src, src), generator=g, dtype=torch.uint8))):
                path = os.path.join(root, d, rel + ext)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                png.save_png(path, arr.numpy())
        clips.append(clip)
    os.makedirs(os.path.join(root, "load_files"))
    with open(os.path.join(
            root, "load_files",
            "int_1_len_3_max_4bb_area_3000_extra_panet_lsclip.pkl"), "wb") as f:
        pickle.dump({"train": clips, "val": clips}, f)
    return os.path.join(root, "imgs"), os.path.join(root, "segs")


def runner_phase(dev, card):
    """Phase 9: the port's runner layer through its launcher
    (``cli/main.run``, ``train/runner.Runner``) on the card.  Returns the
    counted launches of each run."""
    tmp = tempfile.mkdtemp(prefix="dvie_runner_")
    old_root = os.environ.get("DVIE_DATA_ROOT")
    runs = []
    try:
        # 9a: the recipe's epochs: 2 x 8 steps, a checkpoint each epoch;
        # the writer runner is built as run() builds it, so that its own
        # val metrics can be read after training
        exp_a = os.path.join(tmp, "a")
        os.makedirs(exp_a)
        cfg = parse_args(f"{RECIPE} --epochs 2 INTER --model InterNet "
                         "--train_coarse".split())
        get_logger(exp_a, "train")
        writer = _quiet(lambda: Runner(cfg, exp_a))
        _, counts = _counted("runner train", PER_TRAIN_STEP,
                             2 * RUNNER_EPOCH_STEPS,
                             lambda: _quiet(writer.train_epochs))
        runs.append(counts)
        log_a = _log_of(exp_a)
        losses_a = {(int(e), int(i)): float(v)
                    for e, i, v in LOSS_LINE.findall(log_a)}
        if len(losses_a) != 2 * RUNNER_EPOCH_STEPS or not all(
                map(math.isfinite, losses_a.values())):
            raise AssertionError(f"runner train: losses {losses_a}")
        epochs = EPOCH_LINE.findall(log_a)
        saves = re.findall(r"saved checkpoint \S+ in ([0-9.]+)s", log_a)
        for e, n, wall, rate, load, comp in epochs:
            print(f"runner epoch {e}: {n} samples in {wall} s, {rate} "
                  f"samples/s, load {load} s, comp {comp} s on {card}")
        print(f"runner checkpoint saves: {', '.join(saves)} s")
        if sorted(os.listdir(os.path.join(exp_a, "checkpoint"))) != [
                "InterNet_xs2xs_inter_0_1_0", "InterNet_xs2xs_inter_0_2_0"]:
            raise AssertionError("runner train: checkpoints missing")
        # the bare step's rate in this process, for the runner's beside it
        _, times, _ = trajectory(dev, True, 24, 128, 128)
        bare = 24 / statistics.median(times)
        print(f"runner: epoch-2 rate {float(epochs[1][3]):.4f} samples/s "
              f"against the bare step's {bare:.4f} (median of {len(times)} "
              f"steps) on {card}")

        # 9b: the writer's val metrics; then the sweep over both
        # checkpoints, whose epoch-2 load follows an epoch-1 forward: stale
        # kernel weight units would repeat epoch 1's metrics
        m_writer, counts = _counted(
            "runner val", PER_VAL_FORWARD, RUNNER_VAL_BATCHES,
            lambda: _quiet(writer.validate))
        runs.append(counts)
        sweep = parse_args(
            f"{RECIPE.replace('--split train', '--split val')} --load_dir "
            f"{exp_a} --checksession 0 --checkepoch_range --checkepoch_low 1 "
            "--checkepoch_up 2 INTER --model InterNet".split())
        swept = _quiet(lambda: run(sweep, os.path.join(tmp, "sweep")))
        for k, v in m_writer.items():
            got = swept[2][k]
            print(f"runner val {k}: writer {v:.6g}, reloaded {got:.6g}, "
                  f"epoch 1 {swept[1][k]:.6g}")
            if abs(got - v) > RELOAD_VAL_TOL * abs(v):
                raise AssertionError(f"runner val: reloaded {k} {got} vs "
                                     f"the writer's {v}")
        if swept[1] == swept[2]:
            raise AssertionError("runner val: epochs 1 and 2 alike")

        # 9c: resume from the epoch-1 checkpoint
        exp_b = os.path.join(tmp, "b")
        resume = parse_args(
            f"{RECIPE} --epochs 2 --r --checkepoch 1 --checksession 0 "
            f"--load_dir {exp_a} INTER --model InterNet --train_coarse".split())
        _quiet(lambda: run(resume, exp_b))
        losses_b = {(int(e), int(i)): float(v)
                    for e, i, v in LOSS_LINE.findall(_log_of(exp_b))}
        if sorted(losses_b) != [(2, i) for i in range(RUNNER_EPOCH_STEPS)]:
            raise AssertionError(f"runner resume: logged {sorted(losses_b)}")
        gap = max(abs(v - losses_a[k]) / abs(losses_a[k])
                  for k, v in losses_b.items())
        print(f"runner resume: epoch-2 loss_all within {gap:.4g} of the "
              f"uninterrupted run's (bound {RESUME_LOSS_TOL})")
        if gap > RESUME_LOSS_TOL:
            raise AssertionError(f"runner resume: loss_all off by {gap:.4g}")

        # 9d: cycgen at 2x512x1024 from the epoch-2 checkpoint
        cyc = parse_args(
            "--dataset synthetic --split cycgen --syn_type inter --input_h 512 "
            f"--input_w 1024 --bs 2 --load_dir {exp_a} --checksession 0 "
            "--checkepoch 2 INTER --model InterNet --load_coarse".split())
        t0 = time.perf_counter()
        out_root, counts = _counted(
            "runner cycgen", PER_FORWARD, RUNNER_CYCGEN_FORWARDS,
            lambda: _quiet(lambda: run(cyc, os.path.join(tmp, "cyc"))))
        dt = time.perf_counter() - t0
        runs.append(counts)
        files = sorted(os.path.join(b, f) for b, _, fs in os.walk(out_root)
                       for f in fs)
        n_clips = 2 * RUNNER_CYCGEN_FORWARDS
        if len(files) != n_clips * 3 * 3:
            raise AssertionError(f"runner cycgen: {len(files)} files")
        for path in files:    # by the zlib + numpy decoder, not Pillow
            kind = os.path.basename(os.path.dirname(path))
            with open(path, "rb") as f:
                arr = png.decode_png(f.read(), 1 if kind == "seg" else 3)
            if arr.shape[:2] != (512, 1024) or (kind == "seg"
                                                and int(arr.max()) >= 20):
                raise AssertionError(f"runner cycgen: {path} {arr.shape}")
        print(f"runner cycgen 2x512x1024: {n_clips} clips, {len(files)} PNGs "
              f"written and decoded back, {dt:.3f} s with the build")

        # 9e: one epoch on a Cityscapes-layout tree, loader workers on
        root = os.path.join(tmp, "city")
        img_dir, seg_dir = _write_city_tree(root, 48)
        os.environ["DVIE_DATA_ROOT"] = root
        city = parse_args(
            f"{RECIPE.replace('synthetic', 'cityscape')} --epochs 1 --nw 4 "
            f"--img_dir {img_dir} --seg_dir {seg_dir} INTER --model InterNet "
            "--train_coarse".split())
        exp_c = os.path.join(tmp, "city_exp")
        torch.cuda.synchronize()
        hw.reset_counters()
        _quiet(lambda: run(city, exp_c))
        torch.cuda.synchronize()
        counts = dict(hw.launches)
        runs.append(counts)
        # with a TensorBoard writer, step 0 also logs the image grid: one
        # eval forward
        grids = int(os.path.isdir(os.path.join(
            exp_c, "train_int_1_len_1_cityscape_logs")))
        print(f"runner cityscape launches ({grids} image grid forward): "
              f"{json.dumps({k: v for k, v in counts.items() if v})}")
        for name in hw.KERNELS:
            want = 2 * PER_TRAIN_STEP.get(name, 0) + grids * PER_VAL_FORWARD.get(
                name, 0)
            if counts[name] != want:
                raise AssertionError(f"runner cityscape: {name} launched "
                                     f"{counts[name]} times, expected {want}")
        log_c = _log_of(exp_c)
        losses_c = [float(v) for _, _, v in LOSS_LINE.findall(log_c)]
        if len(losses_c) != 2 or not all(map(math.isfinite, losses_c)):
            raise AssertionError(f"runner cityscape: losses {losses_c}")
        e, n, wall, rate, load, comp = EPOCH_LINE.findall(log_c)[0]
        print(f"runner cityscape epoch: {n} samples in {wall} s, {rate} "
              f"samples/s, load {load} s, comp {comp} s (PNG decoder: "
              f"{'Pillow' if png.pil_available() else 'zlib + numpy'}) "
              f"on {card}")
    finally:
        if old_root is None:
            os.environ.pop("DVIE_DATA_ROOT", None)
        else:
            os.environ["DVIE_DATA_ROOT"] = old_root
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


def main():
    dev = require_card()
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    _build.library()
    print(f"nvcc build {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path().name})")
    kernels = kernel_phase(dev)
    slice_phase(dev)
    counts = serve_phase(dev, card)
    kernels.update(train_kernel_phase(dev))
    k1_backward_check(dev)
    k4_backward_check(dev)
    train_counts, g_ref = train_phase(dev, card)
    runs = [counts, train_counts, *bbchain_modes_phase(dev, card, g_ref),
            highres_phase(dev, card), stage3_phase(dev, card),
            vae_phase(dev, card), *runner_phase(dev, card)]
    print(json.dumps({"kernels": [
        dict(name=n, route=META[n][0], source=META[n][1], replaces=META[n][2],
             launches=sum(c[COUNTER.get(n, n)] for c in runs),
             **kernels[n]) for n in META]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
