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
   weight-grad kernel on the C = 64 chain's 8 weights; the stem at 48
   input channels, VAEHRNet's 46 zero-padded, at recipe 4's 18x128x128
   and a ragged 2x36x120, forward, stored s1 and y, and backward on
   fixed-mask and random inputs, rows ``stem48_fwd``,
   ``stem48_fwd_saved`` and ``stem48_bwd``; likewise at 64, VAEHRNet's 53
   in extrapolation with three frames, at 24x128x128, rows ``stem64_*``)
   and K4's h mode
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
   their max: no kernel runs before the warp); then 50 timed eval
   forwards (``serve.predict_video``) at 8x128x128 after a warm-up, in 5
   windows of 10, the code drawn from a seeded generator: launches per
   forward grid_sample 1 (the flow entry, all T steps in one launch,
   unbounded), every other kernel 0 (the bounded mode has a counter of its
   own, grid_sample_bounded); outputs finite; frames/s of each window,
   their median and spread;
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
   temporary directory;
10. batch 27: the forward kernels of a refine recipe's frozen coarse at
    27x128x128 bf16 (stem, the four Bottlenecks, the BasicBlock chain,
    K3, K4 taps, the shift add) against their plain versions;
11-12. recipes 2 and 3 (``docs/RECIPES.md:17-40``): InterRefineNet
    (SRNRefine ``--n_sc 3`` trained, HRNet frozen) and InterStage3Net
    (MSResAttnRefineV2 ``--stage3_prop`` trained, HRNet and SRNRefine
    frozen, refine weights 20) at 27x128x128 bf16: the trained stage's
    one-step gradient against the f32 plain model's (1.5 x the plain bf16
    model's error + 1e-3), each loss term within 2e-2, 20 Adamax steps of
    both models whose trained-stage terms fall and end within 10%, the
    launches of one step (the frozen coarse's forward kernels once each,
    every backward kernel 0), samples/s (median of 18 steps);
13. the recipe-3 model served: kernel against plain model at 2x128x256,
    its three flow maps >= 90% on a moving scene and, on random frames,
    each as close to the f32 model's as the plain bf16 model's less 0.05;
    the 3-step rollout at 2x512x1024 with the serving launches, ms a
    forward, peak memory and frames/s;
14. (inside phase 9) recipes 2 and 3 through the launcher at batch 27
    from phase 9's InterNet experiment (``--load_coarse``, then
    ``--load_coarse --load_refine``): launches, the loaded stages
    unchanged, the epochs' samples/s; recipe 3's writer's val metrics
    (``refine_*``, ``stage3_*``) against a ``--split val`` reload within
    1e-3; ``--split cycgen`` of the recipe-3 model at 2x512x1024;
15. recipe 4's generator served: VAEHRNet (``train/inter_gan.GanEvalAdapter``,
    z from a seeded generator) kernels against the plain model at
    2x128x256 with one fixed z, as phase 2; then the 3-step rollout at
    2x512x1024 bf16 (the spatial latent): InterNet's launches per
    forward, frames/s;
16. recipe 4's step (``docs/RECIPES.md:42-62``: InterGANNet, VAEHRNet,
    FrameSN, VideoSN, FrameSNDet and VideoLSSNDet discriminators with the
    recipe's weights and learning rates, ``--kld_w 20``, ``--n_track
    10``) at 18x128x128 bf16 with f32 masters: each submodel's one-step
    gradient and the stem's four leaves against the f32 plain model (1.5
    x the plain bf16 model's error + 1e-3), each loss term within 2e-2 of
    the plain bf16 model's, 20 steps per model on one fixed batch with
    every term finite and the reconstruction terms (l1, gdl, vgg, ssim,
    ce) falling and ending within 10% of the plain model's, the launches
    of one counted step (the INTER step's with the stem at 48 channels:
    ``stem48_fwd`` / ``stem48_bwd`` 1 / 1, the 16-channel stem 0),
    samples/s (median of 18 steps after 2 warm-ups);
17-18. recipe 4 through the launcher on synthetic data: two epochs of 8
    steps with a checkpoint each (every discriminator and its Adam state
    in it), the writer's val metrics (4 val forwards: the stem at 48
    channels 1 each) against recipe 5's ``--checkepoch_range`` sweep
    within 1e-3, ``--r --checkepoch 1`` (epoch-2 losses within 2e-2),
    ``--split cycgen`` of the VAEHRNet generator at 2x512x1024 from the
    epoch-2 checkpoint (the serving launches, 72 PNGs decoded back); the
    epochs' samples/s;
19-20. extrapolation served: ExtraNet (HRNet in extrapolation mode) and
    ExtraInpaintNet with ``--inpaint --inpaint_mask`` (heads 24 wide: K4's
    216 instance and the shift add's co-24 one, InpaintUnet on cuDNN),
    kernels against the plain model at 2x128x256 as in phase 2 (the
    inpainted frame for ExtraInpaintNet), then the 3-step rollout at
    2x512x1024 bf16: ExtraNet InterNet's launches per forward,
    ExtraInpaintNet the same with ``upshead_taps_n216`` and
    ``shiftadd_co24`` 1 in place of K4's and the shift add's 208 / 23
    instances; frames/s, peak memory;
21-22. recipe 6's step (``docs/RECIPES.md:76-83``: ExtraNet, HRNet,
    ``--num_pred_step 3``, back-propagation through the three forwards) at
    24x128x128 bf16 with f32 masters: the gradient of an extrapolation
    forward with respect to its input rgb (through the stem kernel's dx),
    one step's gradient (whole and the 33 train-chain leaves) and a
    one-forward step's, kernel and plain bf16 models against the f32
    plain model (1.5 x the plain bf16 model's error + 1e-3), each loss
    term within 2e-2, 20 steps per model whose loss_all falls and ends
    within 10% of the plain model's, the launches of one counted step
    (three times the b0 step's), samples/s and peak memory; then the
    ``--num_pred_once 2`` step (one forward, the heads on K4's h mode with
    its gradient: no taps, no shifted add) and the ``--fix_init_frames``
    step (the stem at 48 channels, 3 / 3): gradient, launches, samples/s;
23-24. recipe 6 through the launcher on synthetic data: two epochs of 8
    steps, the writer's val metrics (each val batch a 3-step rollout)
    against a ``--checkepoch_range`` sweep within 1e-3, ``--r
    --checkepoch 1`` (epoch-2 losses within 2e-2), ``--split cycgen`` at
    2x512x1024 from the epoch-2 checkpoint (2 input and 3 extrapolated
    frames a clip, 120 PNGs decoded back);
25. ExtraInpaintNet ``--inpaint_mask --highres_large`` served: kernel
    against plain model at 2x128x256, the 3-step rollout at 2x512x1024
    with the 4-part head's 216 instance and the co-24 shift add 1 a
    forward; frames/s, peak memory;
26. ``--highres_large`` training: recipes 1 and 6 at 24x128x128, the
    gradient of a forward's loss terms on f32 outputs (whole, the 41
    train-chain leaves of stages 2-4, the heads' 8) of the kernel and the
    plain bf16 model against the plain f32 model, each loss term of one
    step within 2e-2, 8 steps per model (finite; samples/s, peak
    memory), the launches of one counted step (the chain 12 / 12 / 3, the
    4-part head's taps and h mode 1 each); recipe 4 three steps, the third
    counted;
27. ``--remat``: recipes 1 (``--highres_large``), 4 and 6: the step's
    gradient, loss terms and buffers (BatchNorm statistics, spectral-norm
    vectors) against the same step without ``--remat``, 6 steps each way
    (samples/s, peak memory: lower under ``--remat`` on recipe 6 or the
    phase fails), the launches of one counted step (the regions' forward
    kernels twice);
28. recipe 4's track-object variant (``--track_obj_loss --track_obj_w 8
    --n_track 4``, the frozen ResNet101 from a seed) at 18x128x128: each
    submodel's one-step gradient and the stem's leaves, kernel model and
    plain bf16 model against the plain f32 model, each loss term within
    2e-2 of the plain model's; 20 steps of the kernel model
    (reconstruction terms falling, samples/s, peak memory, recipe 4's
    launches);
29. ``--track_gen`` with TrackGen and TrackGenV2: one step each under the
    same gate, ``coarse_loc_diff_loss`` finite;
30. each of the seven newer box discriminators as the video det family:
    one family pass (fake, sync_neg, real, G) at 18x128x128, 10 tracks,
    logits and grads finite;
31-32. InterNet on a VAEHRNet (the plain VAE) served at 2x128x256 and
    2x512x1024 with the served VAEHRNet's launches, trained at 24x128x128
    under the gate, 8 steps; ExtraNet on a VAEHRNet, recipe 6's step
    (three forwards) under the gate, 8 steps (samples/s, peak memory,
    three times recipe 4's launches), and under ``--fix_init_frames``
    (the 64-channel stem kernels, rows ``stem64_*`` of the train-kernel
    phase) the gate and 6 finite steps;
33. the track-object variant through the launcher: an epoch with its
    checkpoint, then ``--r`` to a second epoch;
34. the vimeo and ucf101 triplet sets (``--mode xx2x``, no segmentation):
    the kernels they run against their plain versions at B=1 and 8
    256x448 and 8x256x256 (K1 at its three sites, K2 in its three block
    forms, K3, K4's taps and h modes, the shift add bit for bit); trees
    written by the port's PNG encoder (80 vimeo triplets of 448x256, 8
    ucf101 clips of 320x240 with the clip pickle of
    ``tools/build_clips``); one 448x256 frame's host decode time by the
    fused path, the numpy decoder and Pillow; two vimeo epochs of 8 steps
    at batch 8 through the launcher with ``DVIE_PROFILE_DIR`` set (the
    first epoch traced): the launches of each step
    (at 256x448 the serving kernels, K1 18, K2 4, K3 2, K4 taps 1 and h
    1, the shift add 1; no train-chain kernel, as branch 0 fails
    ``bb_fits``), every frame decoded by the fused PNG path, finite
    losses, one trace naming the port's kernels (its device time a step),
    each epoch's samples/s, load and comp seconds, peak memory; then
    ``--split val`` on vimeo from the epoch-2 checkpoint and a ucf101
    ``--checkepoch_range``
    sweep over it (256x256): the serving launches, PSNR and SSIM, no
    ``coarse_iou``;
35. export: ``tools/export.py`` on ``torch.export``, every served kernel a
    ``dvie::`` op (``ops/library.py``): InterNet's 3-step rollout at
    2x512x1024 bf16 exported, saved, loaded (``load_exported``) and run:
    the launches per forward (K1 18, K2 4, K3 2, K4 1, the shift add 1),
    equal to the live kernel rollout (or by how much not, printed), each
    step against the plain model on the window the artifact carried (rgb
    by the served gate at every step, seg argmax agreement >= 98% at step
    1 and printed after it), ms a forward exported and eager; then
    ``--highres_large``, ExtraInpaintNet ``--inpaint_mask``,
    InterStage3Net V1 ``--n_sc 1`` and ExtraNet ``--num_pred_once 2`` at
    2x128x256, one export each (launches, equal to the live kernel model
    or within the served gates of it; phases 6, 7 and 19-20 hold the live
    models to the plain ones): every dvie:: op runs from an artifact;
36. data parallelism (``parallel/dist.py``): recipe 1 at 24x128x128 on
    two ranks of 12 that share the card, started through the launcher's
    ``DVIE_MULTIHOST`` contract (NCCL takes one rank a device, so the
    group runs on gloo): each rank's launches are the one-process step's,
    the ranks' averaged gradients equal, the loss terms within 2e-2 and
    the gradient within the train gates of the one-process step, each
    rank's step ms; then one launcher epoch with ``--num_data_shards 1``
    under ``DVIE_MULTIHOST=1``, a group of one on NCCL: its launches, its
    losses, its checkpoint, its samples/s;
37. the rest of the model zoo (``legacy_zoo_phase``): each public model
    of ``models/srn_legacy.py`` (the SRN4 family at ``n_scales`` 1 and 2,
    HResUnet on an SRN4Sharp ``high_res`` feature of the half-resolution
    frames, AttnRefine, AttnBaseRefine, MSBaseRefine),
    ``models/attn_legacy.py`` (V2, V2O, V2Base, V3, V3Base, V4, V4Base)
    and OpticalUnet / OpticalRefineNet at 2x512x1024 bf16 eval on a noisy
    moving scene: ms a forward (median of 5 after a warm-up), peak memory,
    and the same weights in f32 (TF32 off) as the reference: the rgb by
    the slice bound (V3's and V4's by rel-L2 <= 2e-2), the flow maps by
    agreement >= 90%, the voxel-flow nets' flows and masks by the slice
    bound; no kernel launched;
38. spatial sharding (``parallel/spatial.py``, ``spatial_phase``): two
    ranks of one spatial group (S = 2) share the card on gloo, started
    through the launcher's ``DVIE_MULTIHOST`` contract; one process of the
    plain route (the route a spatial step takes) is the reference.  (a)
    Recipe 1 at 24x128x128 bf16 on bands of 24x64x128: one counted step
    (every kernel counter 0; the halo exchanges; the loss terms within
    2e-2 and the gradient within the train gates of the one-process plain
    step, against its f32 twin; the ranks' parameters after it equal), the
    median ms of 3 more, a launcher epoch of 20 steps whose loss falls
    (the mean of its last 5 steps below that of its first 5) and ends
    within 10% of the one-process plain epoch's on the same synthetic
    data, and ``--split val`` on its checkpoint; (b) one step at
    1x512x1024: each rank's peak memory beside the one-process peak (each
    below it) and the loss terms within 2e-2.

The kernel phase also holds the 4-part head at 24x128x128
(``ups_head_taps4_train``), its 216 instance (``upshead4_taps_n216``,
``_train``) and its h mode (``ups_head_1x1_4``, ``_b1``), each at B=1
512x1024 and 24x128x128 and a ragged 1x37x130, every kernel output
allocated from NaN-filled memory (``poisoned``); the build prints
upshead4.cu's ``ptxas`` registers and spills; ``taps4_backward_check``
holds the 4-part backward against its f32-operand form.  It also holds
K4's 216-wide taps instance (rows
``upshead_taps_n216`` at B=1 512x1024 and ``upshead_taps_n216_train`` at
24x128x128, timed on the card alone too, a ragged 2x37x70 checked) and
K4's h mode with its gradient (``ups_head_1x1``'s backward at 24x128x128,
by the gradient rule above); the shift-add kernel (the heads' tail in
every HRNet forward and train step: one launch each, counted in phases 3
and 5-7), bit for bit against its plain version at B=1 and B=2 512x1024,
at the train shape 24x128x128 and at a ragged 1x37x70, each timed on a row
of its own, host issue included and on the card alone, and its co-24
instance likewise (rows ``shiftadd_co24``, ``shiftadd_co24_train``); the grid sample's
grid entry bounded (R = 8: flows up to 6 px, a band beyond the window that
must give 0, a known integer shift) and unbounded (flows up to 40 px) at
8x512x1024x3 bf16, and unbounded at the VideoVAE's 8x128x128x3 (row
``grid_sample_vae``), and its flow entry (``warp.warp_steps``: bf16 flows,
no grid) at the same shapes, bounded and unbounded at 8x512x1024x3 (rows
``warp_steps_bounded``, ``warp_steps``) and with T = 2 and the mask at the
VAE's shape on random and smooth flows (``warp_steps_vae``,
``warp_steps_vae_smooth``), each held against its plain version and timed
host issue included and on the card alone beside ``F.grid_sample``; zero
and integer flows reproduce the frame; ragged strided shapes (a frame
sliced from a sequence, a strided mask, f32, C = 1, windows of R = 2 and
100) are checked; and the dual head
(``fused_dual_head``) on the InterNet serving forward's own 1x512x1024x448
concat map and head weights, against its plain version and against the
model's K4-route heads.

K3's rows are timed on the card alone too, as K1's and K2's are.

The legacy trainers (``train/legacy.py``): the grid sample's backward
(row 18c, ``grid_sample_bwd_check``: rows ``grid_sample_bwd`` and
``grid_sample_bwd_b16``) against autograd of its plain version at the VAE
step's two warps; the VideoVAE train step at 8x128x128 against f32 and its
plain model, 20 steps, its launches (``vae_train_phase``); the simple,
GAN, Refiner and RefinerGAN steps at 24x128x128 (``legacy_steps_phase``).

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
import copy
import dataclasses
import functools
import io
import json
import math
import os
import pickle
import re
import shutil
import socket
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
from deep_video_interpolation_extrapolation_tpu_torch.data import datasets
from deep_video_interpolation_extrapolation_tpu_torch.data.synthetic import (
    synthetic_batch,
)
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.models.hrnet import (
    _concat_pyramid,
    _encode_inputs,
)
from deep_video_interpolation_extrapolation_tpu_torch.native import host, png
from deep_video_interpolation_extrapolation_tpu_torch.parallel import (
    dist,
    spatial,
)
from deep_video_interpolation_extrapolation_tpu_torch.train import (
    checkpoint as ckpt_lib,
    extra,
    inter,
    inter_gan,
    legacy,
    state as state_lib,
)
from deep_video_interpolation_extrapolation_tpu_torch.train.runner import (
    Runner,
)
from deep_video_interpolation_extrapolation_tpu_torch.tools import (
    build_clips,
    export as export_lib,
)
from deep_video_interpolation_extrapolation_tpu_torch.train.common import (
    init_resnet_frozen,
    init_vgg_frozen,
    rgb_bundle,
)
from deep_video_interpolation_extrapolation_tpu_torch.losses.image import (
    cross_entropy_loss,
)
from deep_video_interpolation_extrapolation_tpu_torch.losses.perceptual import (
    make_vgg_l1_loss,
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
    "upshead_taps_n216": ("cuda", f"{PKG}/csrc/upshead.cu",
                          "deep_video_interpolation_extrapolation_tpu/ops/pallas_upshead.py:342"),
    "upshead_taps_n216_train": ("cuda", f"{PKG}/csrc/upshead.cu",
                                "deep_video_interpolation_extrapolation_tpu/ops/pallas_upshead.py:342"),
    "stem_fwd": ("cuda", f"{PKG}/csrc/trainchain_stem.cu",
                 "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:530"),
    "stem_fwd_saved": ("cuda", f"{PKG}/csrc/trainchain_stem.cu",
                       "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:530"),
    "stem_bwd": ("cuda", f"{PKG}/csrc/trainchain_stem.cu",
                 "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:565"),
    "stem48_fwd": ("cuda", f"{PKG}/csrc/trainchain_stem.cu",
                   "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:530"),
    "stem48_fwd_saved": ("cuda", f"{PKG}/csrc/trainchain_stem.cu",
                         "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:530"),
    "stem48_bwd": ("cuda", f"{PKG}/csrc/trainchain_stem.cu",
                   "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:565"),
    "stem64_fwd": ("cuda", f"{PKG}/csrc/trainchain_stem.cu",
                   "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:530"),
    "stem64_fwd_saved": ("cuda", f"{PKG}/csrc/trainchain_stem.cu",
                         "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:530"),
    "stem64_bwd": ("cuda", f"{PKG}/csrc/trainchain_stem.cu",
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
    "ups_head_taps4_train": ("cuda", f"{PKG}/csrc/upshead4.cu",
                             "deep_video_interpolation_extrapolation_tpu/ops/pallas_upshead.py:1096"),
    "upshead4_taps_n216": ("cuda", f"{PKG}/csrc/upshead4.cu",
                           "deep_video_interpolation_extrapolation_tpu/ops/pallas_upshead.py:1096"),
    "upshead4_taps_n216_train": ("cuda", f"{PKG}/csrc/upshead4.cu",
                                 "deep_video_interpolation_extrapolation_tpu/ops/pallas_upshead.py:1096"),
    "ups_head_1x1_4": ("cuda", f"{PKG}/csrc/upshead4.cu",
                       "deep_video_interpolation_extrapolation_tpu/ops/pallas_upshead.py:1096"),
    "ups_head_1x1_4_b1": ("cuda", f"{PKG}/csrc/upshead4.cu",
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
    "shiftadd_co24": ("cuda", f"{PKG}/csrc/shiftadd.cu",
                      "deep_video_interpolation_extrapolation_tpu/ops/pallas_shiftadd.py:111"),
    "shiftadd_co24_train": ("cuda", f"{PKG}/csrc/shiftadd.cu",
                            "deep_video_interpolation_extrapolation_tpu/ops/pallas_shiftadd.py:111"),
    "grid_sample": ("cuda", f"{PKG}/csrc/grid_sample.cu",
                    "deep_video_interpolation_extrapolation_tpu/ops/pallas_warp.py:134"),
    "grid_sample_vae": ("cuda", f"{PKG}/csrc/grid_sample.cu",
                        "deep_video_interpolation_extrapolation_tpu/ops/pallas_warp.py:134"),
    "grid_sample_bounded": ("cuda", f"{PKG}/csrc/grid_sample.cu",
                            "deep_video_interpolation_extrapolation_tpu/ops/pallas_warp.py:134"),
    "warp_steps": ("cuda", f"{PKG}/csrc/grid_sample.cu",
                   "deep_video_interpolation_extrapolation_tpu/ops/pallas_warp.py:134"),
    "warp_steps_bounded": ("cuda", f"{PKG}/csrc/grid_sample.cu",
                           "deep_video_interpolation_extrapolation_tpu/ops/pallas_warp.py:134"),
    "warp_steps_vae": ("cuda", f"{PKG}/csrc/grid_sample.cu",
                       "deep_video_interpolation_extrapolation_tpu/ops/pallas_warp.py:134"),
    "warp_steps_vae_smooth": ("cuda", f"{PKG}/csrc/grid_sample.cu",
                              "deep_video_interpolation_extrapolation_tpu/ops/pallas_warp.py:134"),
    "grid_sample_bwd": ("cuda", f"{PKG}/csrc/grid_sample.cu",
                        "deep_video_interpolation_extrapolation_tpu/ops/pallas_warp.py:134"),
    "grid_sample_bwd_b16": ("cuda", f"{PKG}/csrc/grid_sample.cu",
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
# at other shapes (each row computes the one function of its kernel), the
# grid sample's flow entry among them
COUNTER = {"bb_chain_fwd_n1": "bb_chain_fwd",
           "stem_fwd_saved": "stem_fwd",
           "stem48_fwd_saved": "stem48_fwd",
           "stem64_fwd_saved": "stem64_fwd",
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
           "grid_sample_vae": "grid_sample",
           "warp_steps": "grid_sample",
           "warp_steps_bounded": "grid_sample_bounded",
           "warp_steps_vae": "grid_sample",
           "warp_steps_vae_smooth": "grid_sample",
           "upshead_taps_n216_train": "upshead_taps_n216",
           "shiftadd_co24_train": "shiftadd_co24",
           "ups_head_taps4_train": "ups_head_taps4",
           "upshead4_taps_n216_train": "upshead4_taps_n216",
           "ups_head_1x1_4_b1": "ups_head_1x1_4",
           "grid_sample_bwd_b16": "grid_sample_bwd"}
# the video VAE serving forward: one grid sample (the flow entry) for all
# its steps
VAE_T = 2
PER_FORWARD_VAE = {"grid_sample": 1}
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
# the co-24 instance (ExtraInpaintNet's --inpaint_mask head: rgb 3 + mask 1
# + seg 20): the serving and train shapes timed, a ragged shape checked
SHIFTADD24_CASES = (("shiftadd_co24", "co 24, B=1 512x1024", (1, 512, 1024)),
                    ("shiftadd_co24_train", "co 24, 24x128x128",
                     (24, 128, 128)),
                    (None, "co 24, ragged 1x37x70", (1, 37, 70)))
# InterStage3Net: the coarse HRNet as InterNet, one window attention
PER_FORWARD_S3 = {**PER_FORWARD, "window_attention": 1}
SLICE_FLOW_AGREE = 0.90    # stage-3 flow maps, kernel vs plain model
# the rows of the kernel-phase loop timed on the card alone too
# (``median_ms(spin=True)``); the window attention's and the shifted add's
# rows are, in their own checks
DEVICE_TIMED = ("conv3x3_bias_res_lrelu", "bottleneck_tail", "fuse_out0",
                "ups_head_taps", "upshead_taps_n216", "ups_head_taps4",
                "upshead4_taps_n216", "ups_head_1x1_4",
                "stem_fwd", "stem_bwd", "stem48_fwd", "stem48_bwd",
                "stem64_fwd", "stem64_bwd")
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
    "upshead_taps_n216": slice(3, None),
    "upshead4_taps_n216": slice(4, None), "ups_head_1x1_4": slice(4, None),
    "ups_head_1x1": slice(3, None), "dual_head": slice(1, None),
    "stem_fwd": slice(1, None), "stem48_fwd": slice(1, None),
    "stem_bwd": slice(4, None), "stem48_bwd": slice(4, None),
    "stem64_fwd": slice(1, None), "stem64_bwd": slice(4, None),
    "bottleneck_fwd": slice(1, None),
    "bottleneck_bwd": slice(2, None), "bb_chain_fwd": slice(1, None),
    "bb_chain_bwd": slice(2, 3), "bb_chain_fwd_c128": slice(1, None),
    "bb_chain_bwd_c128": slice(2, 3), "bb_chain_fwd_c256": slice(1, None),
    "bb_chain_bwd_c256": slice(2, 3)}
# a backward without saved activations recomputes its forward (3 passes);
# the chain's and the stem's backwards read the kept ones (2: the input
# grads, the weight grads)
PASSES = {"stem_bwd": 2, "stem48_bwd": 2, "stem64_bwd": 2, "bottleneck_bwd": 3,
          "bb_chain_bwd": 2,
          "bb_chain_bwd_c128": 2, "bb_chain_bwd_c256": 2}


def operations(name, args):
    """(operations, the card's peak rate for them) of one call of kernel
    ``name`` on ``args``: 2 per multiply-add of what it computes, on bf16
    operands (the tensor-core peak); K3, the shifted add and the grid
    sample are elementwise in f32 (K3: the 4 taps of each bilinear part,
    the adds and the lrelu; the shifted add: 8 adds and the bias per
    output; the grid sample: 9 per channel of the 4-corner blend and ~10
    per pixel for the coordinates and weights, its flow entry ~4 more per
    output pixel for the mask product and the base)."""
    if name == "fuse_out0":
        ups = sum(t is not None for t in args[1:])
        return args[0].numel() * (2 + 8 * ups), F32_PEAK
    if name == "shifted_add_bias":
        return 9 * _px(args[0]) * args[1].numel(), F32_PEAK
    if name == "grid_sample_bwd":  # (x, flow, mask, dout): per output
        # pixel ~22 for the coordinates, weights and the chain through
        # flow * mask, per channel ~14 for the two corner differences
        return _px(args[3]) * (14 * args[3].shape[-1] + 22), F32_PEAK
    if name.startswith("grid_sample"):
        return _px(args[0]) * (9 * args[0].shape[-1] + 10), F32_PEAK
    if name == "warp_steps":       # (x, flow, mask, max_disp)
        return _px(args[1]) * (9 * args[0].shape[-1] + 14), F32_PEAK
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
    # its 216-wide instance: ExtraInpaintNet's --inpaint_mask heads (rgb 3
    # + mask 1, seg 20), served (B=1 512x1024) and trained (24x128x128);
    # and a ragged shape (tiles and the x2/x4 parts cut at the edge)
    w2t216 = k4.build_dual_tap_kernel(w(4, 448, 3, 3), w(20, 448, 3, 3),
                                      torch.bfloat16)
    t0, t1_, t2_ = (rnd(24, 128 // s, 128 // s, c)
                    for s, c in ((1, 64), (2, 128), (4, 256)))
    cases["upshead_taps_n216"] = [
        ("upshead_taps_n216", "heads 216, B=1 512x1024",
         (x64, p1, p2, w1, b1, w2t216)),
        ("upshead_taps_n216_train", "heads 216, 24x128x128",
         (t0, t1_, t2_, w1, b1, w2t216)),
        (None, "heads 216, ragged 2x37x70",
         (rnd(2, 37, 70, 64), rnd(2, 19, 35, 128), rnd(2, 10, 18, 256), w1,
          b1, w2t216))]
    # the 4-part head of --highres_large
    p3 = rnd(B, H // 8, W // 8, 512)
    w1_4 = w(1920, 960, 1, 1)[:, :, 0, 0].t()
    b1_4 = w(1920, 1, 1, 1).flatten()
    w2t_4 = k4.build_dual_tap_kernel(w(3, 960, 3, 3), w(20, 960, 3, 3),
                                     torch.bfloat16)
    # the 4-part pyramid of the train recipe (24x128x128) and a ragged one
    # (not fits4: tiles and the x2/x4/x8 parts cut at the edge)
    t4 = tuple(rnd(24, 128 // s, 128 // s, c)
               for s, c in ((1, 64), (2, 128), (4, 256), (8, 512)))
    r4 = (rnd(1, 37, 130, 64), rnd(1, 19, 65, 128), rnd(1, 10, 33, 256),
          rnd(1, 5, 17, 512))
    cases["ups_head_taps4"] = [
        ("ups_head_taps4", "heads", (x64, p1, p2, p3, w1_4, b1_4, w2t_4)),
        ("ups_head_taps4_train", "heads, 24x128x128",
         (*t4, w1_4, b1_4, w2t_4)),
        (None, "ragged 1x37x130", (*r4, w1_4, b1_4, w2t_4))]
    # its 216-wide instance: ExtraInpaintNet --inpaint_mask under
    # --highres_large (rgb 3 + mask 1, seg 20)
    w2t4_216 = k4.build_dual_tap_kernel(w(4, 960, 3, 3), w(20, 960, 3, 3),
                                        torch.bfloat16)
    cases["upshead4_taps_n216"] = [
        ("upshead4_taps_n216", "heads 216, B=1 512x1024",
         (x64, p1, p2, p3, w1_4, b1_4, w2t4_216)),
        ("upshead4_taps_n216_train", "heads 216, 24x128x128",
         (*t4, w1_4, b1_4, w2t4_216)),
        (None, "heads 216, ragged 1x37x130", (*r4, w1_4, b1_4, w2t4_216))]
    # its h mode: the h the explicit backward recomputes (24x128x128, the
    # train step's), and served size
    cases["ups_head_1x1_4"] = [
        ("ups_head_1x1_4", "h, 24x128x128", (*t4, w1_4, b1_4)),
        ("ups_head_1x1_4_b1", "h, B=1 512x1024", (x64, p1, p2, p3, w1_4,
                                                   b1_4)),
        (None, "h, ragged 1x37x130", (*r4, w1_4, b1_4))]

    fns = {"conv3x3_bias_res_lrelu": (k1.conv3x3_bias_res_lrelu,
                                      k1.conv3x3_bias_res_lrelu_plain),
           "bottleneck_tail": (k2.bottleneck_tail, k2.bottleneck_tail_plain),
           "fuse_out0": (k3.fuse_out0, k3.fuse_out0_plain),
           "ups_head_taps": (k4.ups_head_taps, k4.ups_head_taps_plain),
           "upshead_taps_n216": (k4.ups_head_taps, k4.ups_head_taps_plain),
           "ups_head_taps4": (k4.ups_head_taps4, k4.ups_head_taps4_plain),
           "upshead4_taps_n216": (k4.ups_head_taps4, k4.ups_head_taps4_plain),
           "ups_head_1x1_4": (k4.ups_head_1x1_4, k4.ups_head_1x1_4_plain)}
    results = {}
    for name, variants in cases.items():
        kern, plain = fns[name]
        worst_rel, err = 0.0, {}
        for _, label, args in variants:
            out, ref = poisoned(kern, args), plain(*args)
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
    results.update(shifted_add_check(dev, 24, SHIFTADD24_CASES))
    results.update(grid_sample_check(dev))
    results["dual_head"] = dual_head_check(dev)
    return results


def poisoned(fn, args):
    """``fn(*args)`` into memory that held NaN: a first call gives the
    outputs' shapes, NaN-filled tensors of those shapes are made and
    freed, and the second call's outputs, allocated from the blocks they
    freed, are returned, so that an element the kernel does not store
    shows as non-finite instead of as what an earlier computation left
    there."""
    out = fn(*args)
    outs = out if isinstance(out, tuple) else (out,)
    shapes = [(o.shape, o.dtype) for o in outs if o is not None]
    del out, outs
    nan = [torch.full(sh, float("nan"), dtype=dt, device="cuda")
           for sh, dt in shapes]
    torch.cuda.synchronize()
    del nan
    return fn(*args)


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


def shifted_add_check(dev, co=23, cases=SHIFTADD_CASES):
    """The heads' shifted add + bias (co = 23; with ``cases``
    SHIFTADD24_CASES the co-24 instance) against its plain version, bit for
    bit and within KERNEL_TOL: at the serving shapes (B=1 and B=2
    512x1024: yt (B,512,1024,9*co) bf16), the train shape 24x128x128 and a
    ragged 1x37x70 (strips and row blocks cut at the edges).  Each case
    with a row is timed on it, host issue included and on the card alone;
    its library time is one ``F.conv2d`` of yt with the fixed one-hot (co,
    9*co, 3, 3) kernel and b2, the same function."""
    g = torch.Generator(device=dev).manual_seed(8)
    b2 = torch.randn((co,), generator=g, device=dev)
    onehot = torch.zeros((co, 9 * co, 3, 3), device=dev, dtype=torch.bfloat16)
    for t in range(9):
        onehot[torch.arange(co), t * co + torch.arange(co), t // 3, t % 3] = 1
    bias = b2.to(torch.bfloat16)
    rows = {}
    for row, label, shape in cases:
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
        if row is None:
            continue
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


def _both_ways(fs):
    """Each of ``fs`` ({key prefix: fn}) timed host issue included and on
    the card alone: (the host-inclusive ms in order, the device dict)."""
    return ([median_ms(f) for f in fs.values()],
            {f"{k}device_ms": median_ms(f, spin=True) for k, f in fs.items()})


def _f32_library(x, grid):
    """``F.grid_sample`` (align_corners, zeros) of NHWC ``x`` in f32 at
    the f32 ``grid``: the library call of the same function, timed beside
    the kernel (a bf16 grid would move samples by up to ~2 px at 1024
    wide, so both are f32)."""
    x32 = nchw(x.float()).contiguous()
    return lambda: torch.nn.functional.grid_sample(
        x32, grid, mode="bilinear", padding_mode="zeros", align_corners=True)


def grid_sample_check(dev):
    """The grid sample at 8x512x1024x3 bf16 (the shape warp.py:130 names)
    and at the VideoVAE's 8x128x128x3, through both entries.  The grid
    entry: bounded (R = 8): flows up to 6 px, except a band of 64 rows per
    image displaced 12 px in x, beyond the window, which must give exactly
    0; and a uniform (3, -2) px shift, which must reproduce the image on
    the interior; unbounded: flows up to 40 px; at the VAE's shape flows up
    to 10 px.  The flow entry (``warp_steps``) on the same flows in bf16
    (T = 1), and at the VAE's shape with T = 2 and the mask on random and
    on smooth flows, the frame sliced from a sequence and the mask a
    strided view, as the model passes them; zero and integer flows
    (``_identity_checks``); ragged strided shapes (``_ragged_checks``).
    Every result within KERNEL_TOL of its plain version (bit-equality
    printed); each row timed host issue included and on the card alone,
    beside ``F.grid_sample`` in f32 where it computes the same function."""
    g = torch.Generator(device=dev).manual_seed(9)
    b, h, w, c, r = 8, 512, 1024, 3, 8
    x = torch.randn((b, h, w, c), generator=g, device=dev).to(torch.bfloat16)
    base = warp.make_base_grid(h, w, device=dev)[None]
    px = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1)], device=dev)

    def grid_of(flow_px):
        return (base + flow_px * px).expand(b, h, w, 2).contiguous()

    def flow_of(flow_px):        # the flow entry's (B, 1, H, W, 2) bf16
        return (-(flow_px * px)).expand(b, h, w, 2)[:, None].to(
            torch.bfloat16).contiguous()

    small = (torch.rand((b, h, w, 2), generator=g, device=dev) * 2 - 1) * 6
    small[:, :64, :, 0] = 12.0                     # beyond the window
    grid_b = grid_of(small)
    out, ref = warp.grid_sample(x, grid_b, r), warp.grid_sample_plain(
        x, grid_b, r)
    torch.cuda.synchronize()
    d_b = _held("grid_sample", "bounded, R=8", out, ref)
    _band_is_zero("grid_sample", out)
    shifted = warp.grid_sample(
        x, grid_of(torch.tensor([3.0, -2.0], device=dev)), r)
    torch.cuda.synchronize()
    _held("grid_sample", "bounded, known (3, -2) px shift",
          shifted[:, 2:, :-3], x[:, :-2, 3:])
    args_b = (x, grid_b, r)
    ms, device = _both_ways({"": lambda: warp.grid_sample(*args_b)})
    rows = {"grid_sample_bounded": timed(
        "grid_sample_bounded", "R=8", args_b, out, d_b, ms[0],
        median_ms(lambda: warp.grid_sample_plain(*args_b), iters=3, reps=3),
        None, device)}
    flow_b = flow_of(small)
    args_fb = (x, flow_b, None, r)
    out, ref = warp.warp_steps(*args_fb), warp.warp_steps_plain(*args_fb)
    torch.cuda.synchronize()
    d_fb = _held("warp_steps", "flow entry, bounded, R=8", out, ref)
    _band_is_zero("warp_steps", out[:, 0])
    lib_b = _f32_library(x, base - flow_b[:, 0].float())
    ms, device = _both_ways({"": lambda: warp.warp_steps(*args_fb),
                             "library_": lib_b})
    print(f"  warp_steps [flow entry, bounded] F.grid_sample (unbounded, the "
          f"same grid) {ms[1]:.4f} ms, card {device['library_device_ms']:.4f}"
          " ms")
    rows["warp_steps_bounded"] = timed(
        "warp_steps", "flow entry, bounded, R=8", args_fb, out, d_fb, ms[0],
        median_ms(lambda: warp.warp_steps_plain(*args_fb), iters=3, reps=3),
        None, {"device_ms": device["device_ms"]})

    far = (torch.rand((b, h, w, 2), generator=g, device=dev) * 2 - 1) * 40
    grid_u = grid_of(far)
    out, ref = warp.grid_sample(x, grid_u), warp.grid_sample_plain(x, grid_u)
    torch.cuda.synchronize()
    d_u = _held("grid_sample", "unbounded, 40 px", out, ref)
    library = _f32_library(x, grid_u)
    _held("grid_sample", "library F.grid_sample (f32) vs plain",
          nhwc(library()), ref.float())
    args_u = (x, grid_u)
    ms, device = _both_ways({"": lambda: warp.grid_sample(*args_u),
                             "library_": library})
    rows["grid_sample"] = timed(
        "grid_sample", "unbounded", args_u, out, d_u, ms[0],
        median_ms(lambda: warp.grid_sample_plain(*args_u), iters=3, reps=3),
        ms[1], device)
    flow_u = flow_of(far)
    args_fu = (x, flow_u, None, None)
    out, ref = warp.warp_steps(*args_fu), warp.warp_steps_plain(*args_fu)
    torch.cuda.synchronize()
    d_fu = _held("warp_steps", "flow entry, unbounded, 40 px", out, ref)
    ms, device = _both_ways({"": lambda: warp.warp_steps(*args_fu),
                             "library_": _f32_library(
                                 x, base - flow_u[:, 0].float())})
    rows["warp_steps"] = timed(
        "warp_steps", "flow entry, unbounded", args_fu, out, d_fu, ms[0],
        median_ms(lambda: warp.warp_steps_plain(*args_fu), iters=3, reps=3),
        ms[1], device)
    _identity_checks(dev, x)
    del x, base, small, grid_b, far, grid_u, flow_b, flow_u, out, ref
    torch.cuda.empty_cache()

    # the shape the VideoVAE forward runs (models/vae_video.py: one warp of
    # its 8x128x128x3 frame per step), flows up to 10 px, unbounded
    hv = wv = 128
    xv = torch.randn((b, hv, wv, c), generator=g, device=dev).to(
        torch.bfloat16)
    pxv = torch.tensor([2.0 / (wv - 1), 2.0 / (hv - 1)], device=dev)
    basev = warp.make_base_grid(hv, wv, device=dev)[None]
    flow_v = (torch.rand((b, hv, wv, 2), generator=g, device=dev) * 2 - 1) * 10
    grid_v = (basev + flow_v * pxv).contiguous()
    out, ref = warp.grid_sample(xv, grid_v), warp.grid_sample_plain(xv, grid_v)
    torch.cuda.synchronize()
    d_v = _held("grid_sample", "unbounded, VAE 8x128x128", out, ref)
    args_v = (xv, grid_v)
    fs = {"": lambda: warp.grid_sample(*args_v),
          "plain_": lambda: warp.grid_sample_plain(*args_v),
          "library_": _f32_library(xv, grid_v)}
    ms, device = _both_ways(fs)
    rows["grid_sample_vae"] = timed(
        "grid_sample", "unbounded, VAE 8x128x128", args_v, out, d_v, *ms,
        device)

    # the flow entry as the VAE calls it: frame1 sliced from the sequence,
    # T = 2 steps of bf16 flow, the mask a strided view of the mask pair
    seq = torch.randn((b, VAE_T + 1, hv, wv, c), generator=g, device=dev).to(
        torch.bfloat16)
    frame1 = seq[:, 0]
    masks = torch.rand((b, VAE_T, hv, wv, 2), generator=g, device=dev).to(
        torch.bfloat16)
    mask = masks[..., 0:1]
    coarse = torch.rand((b * VAE_T, 2, 8, 8), generator=g, device=dev)
    smooth = nhwc(torch.nn.functional.interpolate(
        coarse, size=(hv, wv), mode="bilinear", align_corners=True))
    for row, label, flow_px in (
            ("warp_steps_vae", "random 10 px",
             (torch.rand((b, VAE_T, hv, wv, 2), generator=g, device=dev)
              * 2 - 1) * 10),
            ("warp_steps_vae_smooth", "smooth 10 px",
             (smooth.reshape(b, VAE_T, hv, wv, 2) * 2 - 1) * 10)):
        flow = (flow_px * pxv).to(torch.bfloat16)
        args = (frame1, flow, mask, None)
        out, ref = warp.warp_steps(*args), warp.warp_steps_plain(*args)
        torch.cuda.synchronize()
        per_step = torch.stack([warp.grid_sample_plain(
            frame1, basev - (flow[:, i] * mask[:, i]).float())
            for i in range(VAE_T)], 1)
        if not torch.equal(ref, per_step):
            raise AssertionError(f"warp_steps_plain [{label}]: not the "
                                 "model's per-step composition bit for bit")
        d = _held("warp_steps", f"flow entry, VAE T={VAE_T}, mask, {label}",
                  out, ref)
        grid_bt = (basev - (flow * mask).float()).reshape(b * VAE_T, hv, wv, 2)
        x_bt = frame1[:, None].expand(b, VAE_T, hv, wv, c).reshape(
            b * VAE_T, hv, wv, c)
        fs = {"": lambda: warp.warp_steps(*args),
              "plain_": lambda: warp.warp_steps_plain(*args),
              "library_": _f32_library(x_bt, grid_bt.contiguous())}
        ms, device = _both_ways(fs)
        rows[row] = timed("warp_steps", f"flow entry, VAE T={VAE_T}, mask, "
                          f"{label}", args, out, d, *ms, device)
    _ragged_checks(dev, g)
    return rows


def _band_is_zero(name, out):
    """The bounded mode's 64-row band displaced beyond the window is 0."""
    band = out[:, :64].float().abs().max().item()
    print(f"  {name} [bounded, band beyond R] max|out|={band:.6g}")
    if band != 0.0:
        raise AssertionError(f"{name} bounded: {band} beyond the window")


def _held_plain(name, label, out, ref):
    """``_held`` of a kernel against its plain version, printing whether
    the two are bit-equal (the kernel forms coordinates, weights and sums
    in the plain version's order)."""
    d = _held(name, label, out, ref)
    print(f"  {name} [{label}] bit-equal to plain: {torch.equal(out, ref)}")
    return d


def _identity_checks(dev, x):
    """Zero and integer flows through the flow entry, bounded (R = 8) and
    unbounded, at 8x512x1024 and the VAE's 8x128x128: each sample sits on
    a pixel, where an ulp of the base grid would flip its floor, so each
    must reproduce the frame (shifted by the integer flow, on the
    interior) within KERNEL_TOL and agree with the plain version."""
    for xs in (x, x[:, :128, :128].contiguous()):
        b, h, w, _ = xs.shape
        px = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1)], device=dev)
        for (fx, fy), sl_o, sl_x in (
                ((0.0, 0.0), (slice(None), slice(None)),
                 (slice(None), slice(None))),
                ((3.0, -2.0), (slice(2, None), slice(None, -3)),
                 (slice(None, -2), slice(3, None)))):
            # flow = -(shift) in normalized units: out(i, j) = x(i + fy, j + fx)
            flow = (-torch.tensor([fx, fy], device=dev) * px).expand(
                b, 1, h, w, 2).to(torch.bfloat16).contiguous()
            for r in (None, 8):
                label = (f"flow ({fx:g}, {fy:g}) px, {h}x{w}, "
                         f"{'unbounded' if r is None else f'R={r}'}")
                out = warp.warp_steps(xs, flow, None, r)
                _held_plain("warp_steps", label, out,
                            warp.warp_steps_plain(xs, flow, None, r))
                _held("warp_steps", label + " vs the frame",
                      out[:, 0][(slice(None),) + sl_o], xs[(slice(None),) + sl_x])


def _ragged_checks(dev, g):
    """Shapes whose rows are not 16-byte aligned and tiles cut at the
    edges (1x37x70 and 2x37x70, a frame sliced from a sequence, the mask a
    strided view): bf16 C = 3 (pair loads) through both entries, bounded
    at R = 2 and R = 100 and unbounded; f32 C = 3 with an f32 flow and
    bf16 C = 1 (channel by channel)."""
    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    for dtype, c in ((torch.bfloat16, 3), (torch.float32, 3),
                     (torch.bfloat16, 1)):
        for b in (1, 2):
            h, w, t = 37, 70, 2
            xs = rnd(b, t + 1, h, w, c, dtype=dtype)[:, 1]
            px = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1)], device=dev)
            flow = (rnd(b, t, h, w, 2, dtype=torch.float32) * 4 * px).to(dtype)
            mask = torch.rand((b, t, h, w, 2), generator=g, device=dev).to(
                dtype)[..., 1:2]
            grid = (warp.make_base_grid(h, w, device=dev)[None]
                    - flow[:, 0].float()).contiguous()
            for r in (None, 2, 100):
                tag = (f"ragged {b}x{h}x{w}x{c} {str(dtype)[6:]}, "
                       f"{'unbounded' if r is None else f'R={r}'}")
                _held_plain("warp_steps", tag + ", T=2, mask",
                            warp.warp_steps(xs, flow, mask, r),
                            warp.warp_steps_plain(xs, flow, mask, r))
                _held_plain("grid_sample", tag,
                            warp.grid_sample(xs, grid, r),
                            warp.grid_sample_plain(xs, grid, r))


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


def _carrier_inputs(dev, g, B, H, W, ci=14):
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
    pixel: the random-input cases of ``train_kernel_phase`` do.  ``ci``:
    the stem's input channels (HRNet's 14, VAEHRNet's 46)."""
    def u(*shape):
        return torch.rand(shape, generator=g, device=dev) * 2 - 1

    def n(*shape, std):
        return torch.randn(shape, generator=g, device=dev) * std

    def sign(c):
        return torch.where(torch.rand(c, generator=g, device=dev) < 0.5,
                           -1.0, 1.0)

    stem = (u(B, H, W, ci).to(torch.bfloat16),
            n(64, ci, 3, 3, std=0.12 / (3 * ci) ** 0.5), sign(64),
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


def _stem_cases(dev, g, act, w, name, ci, b):
    """The stem kernels' cases of ``train_kernel_phase`` at ``ci`` input
    channels (14: HRNet's, the 16-channel kernels, rows ``stem_*``; 46:
    VAEHRNet's, the 48-channel ones, rows ``stem48_*``; 53: VAEHRNet's in
    extrapolation with three frames, the 64-channel ones, rows
    ``stem64_*``) at b x 128 x 128
    and a ragged 2x36x120 (tiles cut at both edges): the forward, and the
    s1 and y it stores for the backward held as its output is; the
    backward on what the kernel forward kept and the zero-padded x, as in
    the train step, on fixed-mask inputs (against the recomputing
    ``stem_bwd_plain``) and random ones (``stem_bwd_saved_plain``)."""
    H, W = 128, 128
    ws = (w(64, ci, 3, 3), w(64, 1, 1, 1).flatten(), w(64, 64, 3, 3),
          w(64, 1, 1, 1).flatten())
    x, dy = act(b, H, W, ci), act(b, H, W, 64, scale=1e-3)
    xr, dyr = act(2, 36, 120, ci), act(2, 36, 120, 64, scale=1e-3)
    c_stem = _carrier_inputs(dev, g, b, H, W, ci)[0]
    c_stem_r = _carrier_inputs(dev, g, 2, 36, 120, ci)[0]
    bwd = []
    for label, xs, dys, wts, hold, row in (
            (f"{name}, fixed masks", c_stem[0], dy, c_stem[1:], "max", None),
            (f"{name}, random", x, dy, ws, "l2", f"{name}_bwd"),
            ("ragged 2x36x120, fixed masks", c_stem_r[0], dyr, c_stem_r[1:],
             "max", None),
            ("ragged 2x36x120, random", xr, dyr, ws, "l2", None)):
        y_k, s1_k = tc.stem_fwd_kernel(xs, *wts, save=True)
        torch.cuda.synchronize()
        for what, o, r in zip(("y", "s1"), (y_k, s1_k),
                              _stem_fwd_saved_plain(xs, *wts)):
            d, rel = rel_err(o, r)
            print(f"  {name}_fwd [{label}, save] {what} max|d|={d:.6g} "
                  f"max|d|/max|ref|={rel:.6g}")
            if (o.shape != r.shape or not torch.isfinite(o).all()
                    or rel > KERNEL_TOL):
                raise AssertionError(
                    f"{name}_fwd [{label}, save]: {what} shape "
                    f"{tuple(o.shape)} vs {tuple(r.shape)}, max|d|/max|ref| "
                    f"{rel:.4g} (bound {KERNEL_TOL})")
        plain = (_stem_bwd_plain_own if hold == "max"
                 else tc.stem_bwd_saved_plain)
        bwd.append((label, tc.stem_bwd_kernel, plain,
                    (tc._pad_to(xs, tc.stem_cin_pad(ci)), dys, s1_k, y_k,
                     *wts), hold, row))
    return {
        f"{name}_fwd": [(name, tc.stem_fwd_kernel, tc.stem_plain,
                         (x, *ws), "max", f"{name}_fwd"),
                        ("ragged 2x36x120", tc.stem_fwd_kernel, tc.stem_plain,
                         (xr, *ws), "max", None),
                        # the train step's forward: s1 stored for the backward
                        (f"{name}, s1 stored", _stem_fwd_saved,
                         _stem_fwd_saved_plain, (x, *ws), "max",
                         f"{name}_fwd_saved")],
        f"{name}_bwd": bwd}


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
    x64, x256 = act(B, H, W, 64), act(B, H, W, 256)
    blk0 = (w(64, 64, 1, 1), w(64, 64, 3, 3), w(256, 64, 1, 1),
            w(256, 64, 1, 1))
    blk1 = (w(64, 256, 1, 1), w(64, 64, 3, 3), w(256, 64, 1, 1), None)
    p1, p2 = act(B, H // 2, W // 2, 128), act(B, H // 4, W // 4, 256)
    w1 = w(896, 448, 1, 1)[:, :, 0, 0].t()
    b1 = w(896, 1, 1, 1).flatten()
    _, c_blk0, c_blk1 = _carrier_inputs(dev, g, B, H, W)
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
    bn_ops = [act(B, H, W, 64) for _ in range(4)]   # h1, h2, dpre2, dpre1
    cases = {
        **_stem_cases(dev, g, act, w, "stem", 14, B),
        **_stem_cases(dev, g, act, w, "stem48", 46, B18[0]),
        **_stem_cases(dev, g, act, w, "stem64", 53, B),
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


def slice_phase(dev, cfg=CFG, label="slice", inputs=None, models=None,
                flows=True):
    """Kernel model against the plain model on the final frame and seg
    (``serve.final_output``); for InterStage3Net also the flow maps (unless
    ``flows`` is False).  ``inputs``: (rgb, seg), else the seeded random
    frames; ``models``: (kernel, plain), else built from seed 0.  Returns
    both outputs."""
    b, h, w = 2, 128, 256
    fast, plain = models or (
        registry.build_model(cfg, device=dev, seed=0),
        registry.build_model(cfg, device=dev, seed=0, use_kernels=False))
    if inputs is None:
        imgs, ids = _inputs(dev, b, h, w, 1)
        inputs = (torch.cat(imgs, -1) * 2 - 1,
                  torch.cat([serve.seg_oh(i) for i in ids], -1))
    rgb, seg = inputs
    with torch.inference_mode():
        o_k, o_p = fast(rgb, seg), plain(rgb, seg)
    torch.cuda.synchronize()
    (r_k, s_k), (r_p, s_p) = serve.final_output(o_k), serve.final_output(o_p)
    if len(o_k) == 5 and flows:     # each scale's or level's flow map
        if len(o_k[4]) != len(o_p[4]):
            raise AssertionError(f"{label}: {len(o_k[4])} flow maps")
        for lv, (f_k, f_p) in enumerate(zip(o_k[4], o_p[4])):
            agree = flow_agreement(f_k, f_p)
            print(f"{label} 2x128x256 bf16: flow map {lv} "
                  f"{tuple(f_k.shape)} agreement {agree:.6f} (bound "
                  f"{SLICE_FLOW_AGREE})")
            if agree < SLICE_FLOW_AGREE:
                raise AssertionError(f"{label}: flow {lv} agreement "
                                     f"{agree:.4f}")
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
    return o_k, o_p


def serve_phase(dev, card, cfg=CFG, per_forward=PER_FORWARD,
                label="serve rollout", model=None):
    """``model`` (else ``cfg``'s from seed 0) rolled out for 3 steps at
    2x512x1024 after a warm-up: launches per forward, frames/s."""
    b, h, w, steps = 2, 512, 1024, 3
    model = model or registry.build_model(cfg, device=dev, seed=0)
    imgs, ids = _inputs(dev, b, h, w, 2)
    serve.rollout(model, imgs, ids, 1)               # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hw.reset_counters()
    t0 = time.perf_counter()
    preds, pred_ids = serve.rollout(model, imgs, ids, steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
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
          f"{fps:.4f} frames/s, {1e3 * dt / steps:.4f} ms a forward, peak "
          f"memory {peak:.3f} GiB on {card}")
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


def train_setup(dev, use_kernels, dtype="bfloat16", train=True, cfg=CFG):
    """``cfg``'s model (InterNet/HRNet by default) from seed 0, frozen
    VGG19 from seed 1, Adamax; ``train``: --train_coarse."""
    cfg = dataclasses.replace(cfg, compute_dtype=dtype, train_coarse=train)
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


def _train_chain_leaf(name: str, branches=(0,), stages=(2, 3)) -> bool:
    """The leaves the train kernels compute the grads of: the stem (conv1,
    conv2), layer1, and the BasicBlocks of ``branches`` in ``stages``
    (branch 0 on the chain or on K1; branches 1 and 2 on the chain under
    DVIE_BBCHAIN=rest|all; stage 4's branch 0 under --highres_large)."""
    return name.startswith(("coarse_model.conv1.", "coarse_model.conv2.",
                            "coarse_model.layer1.") + tuple(
        f"coarse_model.stage{s}.0.branches.{i}." for s in stages
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


def trajectory(dev, use_kernels, b, h, w, steps=20, warmup=2, count_at=2,
               cfg=CFG, train=True, prefix=""):
    """Phase 5b: ``steps`` Adamax steps on one fixed batch.  Returns the
    trajectory of loss_all (with ``prefix``: of the sum of the loss terms
    whose keys start with it), the step times after the warm-ups (host
    clock, synchronized around each step) and the launches of step
    ``count_at``."""
    step, state = train_setup(dev, use_kernels, train=train, cfg=cfg)
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
        losses.append(float(ld["loss_all"]) if not prefix else sum(
            float(v) for k, v in ld.items() if k.startswith(prefix)))
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

    b, windows, per_window = 8, 5, 10
    inputs = _vae_inputs(dev, b, 13)
    gen = torch.Generator(device=dev).manual_seed(14)
    serve.predict_video(fast, *inputs, generator=gen)          # warm-up
    torch.cuda.synchronize()
    hw.reset_counters()
    fps = []
    for _ in range(windows):
        t0 = time.perf_counter()
        outs = [serve.predict_video(fast, *inputs, generator=gen)
                for _ in range(per_window)]
        torch.cuda.synchronize()
        fps.append(b * VAE_T * per_window / (time.perf_counter() - t0))
        h, w = CFG_VAE.input_h, CFG_VAE.input_w
        for out in outs:
            for o, shape in zip(out, [(b, VAE_T, h, w, 3)] * 2
                                + [(b, VAE_T, h, w, 2)] * 2
                                + [(b, VAE_T, h, w, 1)] * 2):
                if o.shape != shape or not torch.isfinite(o.float()).all():
                    raise AssertionError(f"vae: output {tuple(o.shape)} vs "
                                         f"{shape} or non-finite")
    counts = dict(hw.launches)
    steps = windows * per_window
    for name in hw.KERNELS:
        per = PER_FORWARD_VAE.get(name, 0)
        if counts[name] != per * steps:
            raise AssertionError(f"vae: {name} launched {counts[name]} times, "
                                 f"expected {per} x {steps}")
    print(f"vae eval {steps} forwards at {b}x{h}x{w} bf16, T={VAE_T}, in "
          f"{windows} windows of {per_window}: predicted frames/s "
          f"{', '.join(f'{f:.4f}' for f in fps)}; median "
          f"{statistics.median(fps):.4f}, spread {min(fps):.4f}-"
          f"{max(fps):.4f} on {card}")
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


def _cycgen_tree(label, out_root, took, frames=3, n_clips=None):
    """The 2x512x1024 cycgen tree of RUNNER_CYCGEN_FORWARDS batches (or
    ``n_clips``): ``frames`` frames of rgb, seg ids and seg vis per clip,
    each decoded back by ``native/png.py`` (not Pillow) at 512x1024, ids
    below 20."""
    files = sorted(os.path.join(b, f) for b, _, fs in os.walk(out_root)
                   for f in fs)
    n_clips = n_clips or 2 * RUNNER_CYCGEN_FORWARDS
    if len(files) != n_clips * frames * 3:
        raise AssertionError(f"{label}: {len(files)} files")
    for path in files:
        kind = os.path.basename(os.path.dirname(path))
        with open(path, "rb") as f:
            arr = png.decode_png(f.read(), 1 if kind == "seg" else 3)
        if arr.shape[:2] != (512, 1024) or (kind == "seg"
                                            and int(arr.max()) >= 20):
            raise AssertionError(f"{label}: {path} {arr.shape}")
    print(f"{label} 2x512x1024: {n_clips} clips, {len(files)} PNGs written "
          f"and decoded back, {took}")


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
        _cycgen_tree("runner cycgen", out_root, f"{dt:.3f} s with the build")

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

        # 9f: recipes 2 and 3 from 9a's experiment (phase 14)
        runs += recipe_runner_phase(dev, card, tmp, exp_a)
    finally:
        if old_root is None:
            os.environ.pop("DVIE_DATA_ROOT", None)
        else:
            os.environ["DVIE_DATA_ROOT"] = old_root
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


# ---- the refine stages: the author's recipes 2 and 3 ----------------------

B27 = (27, 128, 128)           # the recipes' batch and crop (RECIPES.md:21,32)
CFG_R2 = dataclasses.replace(CFG, model="InterRefineNet", refine=True,
                             refine_model="SRNRefine", n_scales=3,
                             train_refine=True)
CFG_R3 = dataclasses.replace(
    CFG_R2, model="InterStage3Net", train_refine=False, stage3=True,
    stage3_model="MSResAttnRefineV2", stage3_prop=True, train_stage3=True,
    refine_l1_weight=20.0, refine_gdl_weight=20.0, refine_vgg_weight=20.0,
    refine_ssim_weight=20.0)


def batch27_kernel_phase(dev):
    """Phase 10: the forward kernels a recipe step launches in its frozen
    coarse, at 27x128x128 bf16 (every train-kernel figure before ran at
    24): the stem, the four Bottlenecks (block 0 with its projection, 1-3
    at Ci = 256), the branch-0 BasicBlock chain (N = 4), K3 (stage 2 and
    3), K4's taps mode and the shifted add, each against its plain version
    by max|d|/max|ref| <= KERNEL_TOL."""
    g = torch.Generator(device=dev).manual_seed(12)

    def act(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def w(*shape):
        return torch.randn(shape, generator=g, device=dev) / (
            shape[1] * shape[2] * shape[3]) ** 0.5

    B, H, W = B27
    x64, x256 = act(B, H, W, 64), act(B, H, W, 256)
    blocks = [(w(64, 64, 1, 1), w(64, 64, 3, 3), w(256, 64, 1, 1),
               w(256, 64, 1, 1))] + [
        (w(64, 256, 1, 1), w(64, 64, 3, 3), w(256, 64, 1, 1), None)
        for _ in range(3)]
    t1, t2 = act(B, H // 2, W // 2, 64), act(B, H // 4, W // 4, 64)
    p1, p2 = act(B, H // 2, W // 2, 128), act(B, H // 4, W // 4, 256)
    w1, b1 = w(896, 448, 1, 1)[:, :, 0, 0].t(), w(896, 1, 1, 1).flatten()
    w2t = k4.build_dual_tap_kernel(w(3, 448, 3, 3), w(20, 448, 3, 3),
                                   torch.bfloat16)
    head = (x64, p1, p2, w1, b1, w2t)
    cases = [("stem_fwd", "stem", tc.stem_fwd_kernel, tc.stem_plain,
              (act(B, H, W, 14), w(64, 14, 3, 3), w(64, 1, 1, 1).flatten(),
               w(64, 64, 3, 3), w(64, 1, 1, 1).flatten()))]
    cases += [("bottleneck_fwd", f"block {i}", tc.bottleneck_fwd_kernel,
               tc.bottleneck_plain, (x64 if i == 0 else x256, *blk))
              for i, blk in enumerate(blocks)]
    cases += [("bb_chain_fwd", "N=4", bb.bb_chain_fwd_kernel,
               bb.bb_chain_plain,
               (x64, [(w(64, 64, 3, 3), w(64, 64, 3, 3)) for _ in range(4)])),
              ("fuse_out0", "stage2", k3.fuse_out0, k3.fuse_out0_plain,
               (x64, t1, None)),
              ("fuse_out0", "stage3", k3.fuse_out0, k3.fuse_out0_plain,
               (x64, t1, t2)),
              ("ups_head_taps", "heads", k4.ups_head_taps,
               k4.ups_head_taps_plain, head)]
    yt = k4.ups_head_taps_plain(*head)
    cases.append(("shifted_add_bias", "taps", sa.shifted_add_bias,
                  sa.shifted_add_bias_plain,
                  (yt, torch.randn((23,), generator=g, device=dev))))
    print(f"batch-27 kernels at {B}x{H}x{W} bf16:")
    for name, label, kern, plain, args in cases:
        out, ref = kern(*args), plain(*args)
        torch.cuda.synchronize()
        _held(name, f"{B}x{H}x{W} {label}", out, ref)


def _recipe_step_grads(dev, cfg, trained, use_kernels, dtype, batch):
    """One step of a recipe: its loss dict and the gradient of the trained
    submodel (``trained``), flat in f32."""
    step, state = train_setup(dev, use_kernels, dtype, train=False, cfg=cfg)
    _, losses = step(state, batch)
    sub = getattr(state.model, trained)
    grads = torch.cat([p.grad.float().flatten() for p in sub.parameters()
                       if p.grad is not None])
    if any(p.grad is not None for n, p in state.model.named_parameters()
           if not n.startswith(trained)):
        raise AssertionError(f"{trained}: a frozen submodel got a gradient")
    return {k: float(v) for k, v in losses.items()}, grads


def recipe_step_phase(dev, card, cfg, trained, label):
    """Phases 11 and 12: a recipe's train step at 27x128x128 bf16 with f32
    masters, its coarse (and, for recipe 3, its refiner) frozen: the
    trained submodel's one-step gradient, kernel model and plain bf16
    model against the plain f32 model (TF32 off), by GRAD_RATIO and
    GRAD_FLOOR; each loss term within LOSS_TOL of the plain bf16 model's;
    20 Adamax steps per model whose trained stage's loss terms (``refine_*``
    or ``stage3_*``: the frozen stages' are constants) fall and end within
    TRAJ_TOL of the plain model's; the launches of one counted step (the frozen
    coarse's forward kernels once each, every backward kernel 0) and
    samples/s (median of 18 steps after 2 warm-ups).  Returns the counted
    launches."""
    b, h, w = B27
    batch = train_batch(dev, b, h, w, seed=4)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _, g_ref = _recipe_step_grads(dev, cfg, trained, False, "float32",
                                      batch)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    l_k, g_k = _recipe_step_grads(dev, cfg, trained, True, "bfloat16", batch)
    l_p, g_p = _recipe_step_grads(dev, cfg, trained, False, "bfloat16", batch)
    print(f"{label} step {b}x{h}x{w}:")
    fail = _check_grad(f"{trained} gradient ({g_ref.numel()} values)", g_k,
                       g_p, g_ref)
    if fail:
        raise AssertionError(f"{label}: {fail}")
    for k in l_p:
        rel = abs(l_k[k] - l_p[k]) / max(abs(l_p[k]), 1e-30)
        print(f"  {k}: kernel {l_k[k]:.6g} plain {l_p[k]:.6g} rel {rel:.3g}")
        if not math.isfinite(l_k[k]) or rel > LOSS_TOL:
            raise AssertionError(f"{label}: {k} differs by {rel:.4g} > "
                                 f"{LOSS_TOL}")
    del g_ref, g_k, g_p
    # the frozen stages' terms are constants: the trajectory is held on
    # the trained stage's terms
    prefix = trained.replace("_model", "_")
    runs = {}
    for name, use_kernels in (("kernel", True), ("plain", False)):
        losses, times, counts = trajectory(dev, use_kernels, b, h, w,
                                           cfg=cfg, train=False,
                                           prefix=prefix)
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"{label} {name}: the {prefix}* losses did "
                                 f"not fall: {losses}")
        rate = b / statistics.median(times)
        print(f"{label} {name} model: {prefix}* losses {losses[0]:.6g} -> "
              f"{losses[-1]:.6g} over {len(losses)} steps; {rate:.4f} "
              f"samples/s (median of {len(times)} steps) on {card}")
        print(f"  {prefix}*: {' '.join(f'{v:.5g}' for v in losses)}")
        runs[name] = (losses[-1], counts)
    gap = abs(runs["kernel"][0] - runs["plain"][0]) / abs(runs["plain"][0])
    print(f"{label}: final {prefix}* losses kernel {runs['kernel'][0]:.6g} "
          f"plain {runs['plain'][0]:.6g} (rel {gap:.4g}, bound {TRAJ_TOL})")
    if gap > TRAJ_TOL:
        raise AssertionError(f"{label}: final loss differs by {gap:.4g}")
    counts = runs["kernel"][1]
    print(f"{label} step launches: "
          f"{json.dumps({k: v for k, v in counts.items() if v})}; the "
          f"launches beyond the frozen coarse's forward: "
          f"{sum(v for k, v in counts.items() if k not in PER_VAL_FORWARD)}")
    _check_step_counts(label, counts, PER_VAL_FORWARD)
    return counts


FLOW_MARGIN = 0.05   # random frames: kernel model's flow agreement with
                     # the f32 model >= the plain bf16 model's - this


def shifted_scene(dev, b, h, w, seed, shift=(4, 8)):
    """Two frames of a moving scene: a smooth random field in [-1, 1] and
    its copy shifted by ``shift`` (dy, dx) pixels, with blocky seg ids
    moved alike (one-hots): (rgb (b,h,w,6), seg (b,h,w,40))."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dy, dx = shift
    hh, ww = h + dy + 8, w + dx + 8
    z = torch.randn((b, 3, hh // 8 + 2, ww // 8 + 2), generator=g, device=dev)
    field = torch.tanh(torch.nn.functional.interpolate(
        z, size=(hh, ww), mode="bicubic", align_corners=False))
    ids = torch.nn.functional.interpolate(torch.randint(
        0, 20, (b, 1, hh // 16 + 1, ww // 16 + 1), generator=g,
        device=dev).float(), size=(hh, ww), mode="nearest")[:, 0]
    frames = [field[:, :, 4 + y:4 + y + h, 4 + x:4 + x + w].permute(0, 2, 3, 1)
              for y, x in ((0, 0), (dy, dx))]
    segs = [serve.seg_oh(ids[:, 4 + y:4 + y + h, 4 + x:4 + x + w].to(
        torch.uint8)) for y, x in ((0, 0), (dy, dx))]
    return torch.cat(frames, -1), torch.cat(segs, -1)


def recipe3_serve_phase(dev, card):
    """Phase 13: the recipe-3 model served (InterStage3Net: HRNet,
    SRNRefine --n_sc 3, MSResAttnRefineV2 --stage3_prop), kernel against
    plain model at 2x128x256, rgb and seg as the slice phase:
    - on two frames of a moving scene (``shifted_scene``), the flow maps
      of V2's three levels each on >= SLICE_FLOW_AGREE of the pixels;
    - on the slice phase's random frames, whose window logits are near
      ties that bf16 rounding reorders (the plain bf16 model's flows
      agree with the f32 model's on only 81-90% of the pixels there, PR
      12 call 2), each level's agreement with the plain f32 model (TF32
      off) no lower than the plain bf16 model's - FLOW_MARGIN;
    then the 3-step rollout at 2x512x1024 with the serving forward's
    launches (V2 runs no kernel), its time, peak memory and frames/s."""
    models = (registry.build_model(CFG_R3, device=dev, seed=0),
              registry.build_model(CFG_R3, device=dev, seed=0,
                                   use_kernels=False))
    slice_phase(dev, CFG_R3, "recipe-3 slice, a moving scene",
                shifted_scene(dev, 2, 128, 256, 9), models)
    o_k, o_p = slice_phase(dev, CFG_R3, "recipe-3 slice, random frames",
                           None, models, flows=False)
    f32 = registry.build_model(dataclasses.replace(CFG_R3,
                                                   compute_dtype="float32"),
                               device=dev, seed=0, use_kernels=False)
    imgs, ids = _inputs(dev, 2, 128, 256, 1)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            o_f = f32(torch.cat(imgs, -1) * 2 - 1,
                      torch.cat([serve.seg_oh(i) for i in ids], -1))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    for lv, (f_k, f_p, f_f) in enumerate(zip(o_k[4], o_p[4], o_f[4])):
        a_k, a_p = flow_agreement(f_k, f_f), flow_agreement(f_p, f_f)
        print(f"recipe-3 slice, random frames: flow map {lv} agreement with "
              f"the f32 model: kernel {a_k:.6f}, plain bf16 {a_p:.6f} "
              f"(bound {a_p - FLOW_MARGIN:.6f}); kernel vs plain "
              f"{flow_agreement(f_k, f_p):.6f}")
        if a_k < a_p - FLOW_MARGIN:
            raise AssertionError(f"recipe-3 slice: flow {lv} agreement with "
                                 f"f32 {a_k:.4f} < {a_p - FLOW_MARGIN:.4f}")
    del models, f32
    return serve_phase(dev, card, CFG_R3, PER_FORWARD, "recipe-3 rollout")


def recipe_runner_phase(dev, card, tmp, exp_a):
    """Phase 14: recipes 2 and 3 through the launcher, from the runner
    phase's InterNet experiment ``exp_a`` (epoch 2): recipe 2 one epoch at
    batch 27 (``--load_dir <it> --load_coarse --load_model InterNet``),
    recipe 3 one epoch loading that (``--load_coarse --load_refine
    --load_model InterRefineNet``), each step's launches those of the
    frozen coarse's forward, the loaded stages unchanged; recipe 3's
    writer's val metrics (``refine_*``, ``stage3_*``) against a ``--split
    val`` run on its checkpoint within RELOAD_VAL_TOL; ``--split cycgen``
    of the recipe-3 model at 2x512x1024.  Returns the counted launches."""
    runs = []
    recipe = RECIPE.replace("--bs 24", "--bs 27")
    load = "--checksession 0 --checkpoint 0"
    r2 = (f"INTER --model InterRefineNet --load_model InterNet --coarse_model "
          "HRNet --load_coarse --refine --refine_model SRNRefine --n_sc 3 "
          "--train_refine")
    r3 = ("INTER --model InterStage3Net --load_model InterRefineNet "
          "--coarse_model HRNet --load_coarse --load_refine --refine "
          "--refine_model SRNRefine --n_sc 3 --stage3 --stage3_model "
          "MSResAttnRefineV2 --train_stage3 --stage3_prop --refine_l1_w 20 "
          "--refine_gdl_w 20 --refine_vgg_w 20 --refine_ssim_w 20")
    exps = {k: os.path.join(tmp, k) for k in ("r2", "r3", "r3val", "r3cyc")}

    def ckpt(exp, model):
        return torch.load(os.path.join(exp, "checkpoint",
                                       f"{model}_xs2xs_inter_0_1_0"),
                          map_location="cpu", weights_only=True)

    cfg2 = parse_args(f"{recipe} --epochs 1 --load_dir {exp_a} --checkepoch 2 "
                      f"{load} {r2}".split())
    _, counts = _counted("runner recipe 2", PER_VAL_FORWARD,
                         RUNNER_EPOCH_STEPS,
                         lambda: _quiet(lambda: run(cfg2, exps["r2"])))
    runs.append(counts)
    cfg3 = parse_args(f"{recipe} --epochs 1 --load_dir {exps['r2']} "
                      f"--checkepoch 1 {load} {r3}".split())
    os.makedirs(exps["r3"])
    get_logger(exps["r3"], "train")
    writer = _quiet(lambda: Runner(cfg3, exps["r3"]))
    _, counts = _counted("runner recipe 3", PER_VAL_FORWARD,
                         RUNNER_EPOCH_STEPS, lambda: _quiet(writer.train_epochs))
    runs.append(counts)
    a = torch.load(os.path.join(exp_a, "checkpoint",
                                "InterNet_xs2xs_inter_0_2_0"),
                   map_location="cpu", weights_only=True)
    c2, c3 = ckpt(exps["r2"], "InterRefineNet"), ckpt(exps["r3"],
                                                      "InterStage3Net")
    for what, got, want in (("recipe 2 coarse", c2["coarse_model"],
                             a["coarse_model"]),
                            ("recipe 3 coarse", c3["coarse_model"],
                             a["coarse_model"]),
                            ("recipe 3 refiner", c3["refine_model"],
                             c2["refine_model"])):
        if sorted(got) != sorted(want) or not all(
                torch.equal(got[k], want[k]) for k in want):
            raise AssertionError(f"runner: {what} is not the loaded one")
    for exp, name in ((exps["r2"], "recipe 2"), (exps["r3"], "recipe 3")):
        log = _log_of(exp)
        losses = [float(v) for _, _, v in LOSS_LINE.findall(log)]
        if len(losses) != RUNNER_EPOCH_STEPS or not all(
                map(math.isfinite, losses)):
            raise AssertionError(f"runner {name}: losses {losses}")
        e, n, wall, rate, ld, comp = EPOCH_LINE.findall(log)[0]
        print(f"runner {name} epoch: {n} samples in {wall} s, {rate} "
              f"samples/s, load {ld} s, comp {comp} s; loss_all "
              f"{losses[0]:.6g} -> {losses[-1]:.6g} on {card}")
    m_writer, counts = _counted("runner recipe 3 val", PER_VAL_FORWARD,
                                RUNNER_VAL_BATCHES,
                                lambda: _quiet(writer.validate))
    runs.append(counts)
    r3_loaded = r3.replace("--load_model InterRefineNet",
                           "--load_model InterStage3Net") + " --load_stage3"
    val = parse_args(f"{recipe.replace('--split train', '--split val')} "
                     f"--load_dir {exps['r3']} --checkepoch 1 {load} "
                     f"{r3_loaded}".split())
    m_val = _quiet(lambda: run(val, exps["r3val"]))
    if [k.split("_")[0] for k in m_val] != ["coarse"] * 5 + ["refine"] * 4 \
            + ["stage3"] * 4 or sorted(m_val) != sorted(m_writer):
        raise AssertionError(f"runner recipe 3 val: keys {list(m_val)}")
    for k, v in m_writer.items():
        print(f"runner recipe 3 val {k}: writer {v:.6g}, reloaded "
              f"{m_val[k]:.6g}")
        if not math.isfinite(v) or abs(m_val[k] - v) > RELOAD_VAL_TOL * abs(v):
            raise AssertionError(f"runner recipe 3 val: reloaded {k} "
                                 f"{m_val[k]} vs the writer's {v}")
    cyc = parse_args(
        "--dataset synthetic --split cycgen --syn_type inter --input_h 512 "
        f"--input_w 1024 --bs 2 --load_dir {exps['r3']} --checkepoch 1 "
        f"{load} {r3_loaded}".split())
    t0 = time.perf_counter()
    out_root, counts = _counted(
        "runner recipe 3 cycgen", PER_FORWARD, RUNNER_CYCGEN_FORWARDS,
        lambda: _quiet(lambda: run(cyc, exps["r3cyc"])))
    runs.append(counts)
    files = [os.path.join(d, f) for d, _, fs in os.walk(out_root) for f in fs]
    if len(files) != 2 * RUNNER_CYCGEN_FORWARDS * 3 * 3:
        raise AssertionError(f"runner recipe 3 cycgen: {len(files)} files")
    with open(sorted(f for f in files if "/rgb/" in f)[1], "rb") as f:
        if png.decode_png(f.read(), 3).shape != (512, 1024, 3):
            raise AssertionError("runner recipe 3 cycgen: frame shape")
    print(f"runner recipe 3 cycgen 2x512x1024: {len(files)} PNGs, "
          f"{time.perf_counter() - t0:.3f} s with the build")
    return runs


# ---- recipe 4, the VAE-GAN (phases 15-18) ---------------------------------

B18 = (18, 128, 128)           # recipe 4's batch and crop (RECIPES.md:45-47)
GAN_GLOBAL = ("--dataset synthetic --syn_type inter --mode xs2xs "
              "--interval 9 --one_hot_seg --input_h 128 --input_w 128 "
              "--bs 18 --kld_w 20 --n_track 10 --s 24 --disp_interval 1")
GAN_LOAD = ("INTER --model InterGANNet --load_model InterGANNet "
            "--coarse_model VAEHRNet --vae --gan")
GAN_FAMILIES = (
    "--frame_disc --frame_disc_model FrameSNDiscriminator --train_frame_disc "
    "--frame_disc_g_w 0.4 --frame_disc_d_w 0.001 --frame_disc_lr 0.0001 "
    "--video_disc --video_disc_model VideoSNDiscriminator --train_video_disc "
    "--video_disc_g_w 0.4 --video_disc_d_w 0.001 --video_disc_lr 0.0001 "
    "--frame_det_disc --frame_det_disc_model FrameSNDetDiscriminator "
    "--train_frame_det_disc --frame_det_disc_g_w 0.4 "
    "--frame_det_disc_d_w 0.001 --frame_det_disc_lr 0.0001 "
    "--video_det_disc --video_det_disc_model VideoLSSNDetDiscriminator "
    "--train_video_det_disc --video_det_disc_g_w 0.4 "
    "--video_det_disc_d_w 0.01 --video_det_disc_lr 0.0001")
GAN_TRAIN = f"{GAN_LOAD} --train_coarse {GAN_FAMILIES}"
CFG_GAN = parse_args(f"{GAN_GLOBAL} --split train {GAN_TRAIN}".split())
# one recipe-4 step: the HRNet step's launches with the stem at 48 input
# channels (bb_fits holds for branch 0 at batch 18 with a batch tile of 1);
# the VAE, the discriminators and the losses are plain PyTorch
PER_GAN_STEP = {**PER_TRAIN_STEP, "stem_fwd": 0, "stem_bwd": 0,
                "stem48_fwd": 1, "stem48_bwd": 1}
PER_GAN_VAL = {**PER_VAL_FORWARD, "stem_fwd": 0, "stem48_fwd": 1}
# the generator's reconstruction terms (the adversarial ones need not fall)
GAN_RECON = ("coarse_l1_loss", "coarse_gdl_loss", "coarse_vgg_loss",
             "coarse_ssim_loss", "coarse_ce_loss")
GAN_SUBMODELS = ("coarse_model", "frame_disc_model", "frame_det_disc_model",
                 "video_disc_model", "video_det_disc_model")


def gan_batch(dev, seed, n_track=10):
    """A seeded synthetic batch of recipe 4: 18x128x128, 10 tracks."""
    b, h, w = B18
    return {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(
        b, h, w, n_track=n_track, seed=seed).items()}


def gan_setup(dev, use_kernels, dtype="bfloat16"):
    """Recipe 4's InterGANNet from seed 0, frozen VGG19 from seed 1,
    Adamax and the four Adams, and its step with a generator of seed 11
    (the VAE's eps, the sync_neg offsets)."""
    cfg = dataclasses.replace(CFG_GAN, compute_dtype=dtype)
    model = registry.build_model(cfg, device=dev, seed=0,
                                 use_kernels=use_kernels)
    state = state_lib.create_train_state(
        cfg, model, init_vgg_frozen(cfg, seed=1, device=dev))
    gen = torch.Generator(dev).manual_seed(11)
    return inter_gan.make_train_step(cfg, model, gen), state


def _gan_step_grads(dev, use_kernels, dtype, batch):
    step, state = gan_setup(dev, use_kernels, dtype)
    _, losses = step(state, batch)
    grads = {n: p.grad.float() for n, p in state.model.named_parameters()}
    return {k: float(v) for k, v in losses.items()}, grads


def _gan_trajectory(dev, use_kernels, steps=20, warmup=2, count_at=2):
    """``steps`` recipe-4 steps on one fixed batch: every loss dict, the
    step times after the warm-ups and the launches of step ``count_at``."""
    step, state = gan_setup(dev, use_kernels)
    batch = gan_batch(dev, 5)
    dicts, times, counts = [], [], None
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
        dicts.append({k: float(v) for k, v in ld.items()})
    return dicts, times, counts


def gan_serve_phase(dev, card):
    """Phase 15: the VAEHRNet generator served (``_GanEvalAdapter``: eval
    mode, z from a seeded generator): kernel against plain model at
    2x128x256 with one fixed z (both generators seeded alike), as phase 2;
    then the 3-step rollout at 2x512x1024 bf16 (the spatial latent): the
    serving launches per forward, frames/s.  Returns the counted
    launches."""
    def adapter(use_kernels):
        model = registry.build_model(CFG_GAN, device=dev, seed=0,
                                     use_kernels=use_kernels)
        return inter_gan.GanEvalAdapter(
            model.coarse_model, torch.Generator(dev).manual_seed(5))
    slice_phase(dev, CFG_GAN, "vaehrnet slice",
                models=(adapter(True), adapter(False)))
    return serve_phase(dev, card, CFG_GAN, label="vaehrnet serve rollout",
                       model=adapter(True))


def gan_step_phase(dev, card):
    """Phase 16: recipe 4's step at 18x128x128 bf16 with f32 masters, the
    recipe's flags and ``--n_track 10``: each submodel's one-step gradient
    and the stem's four leaves (conv1, conv2: the 48-channel stem kernels)
    on their own, kernel model and plain bf16 model against the plain f32
    model (TF32 off), by GRAD_RATIO and GRAD_FLOOR; each loss term within
    LOSS_TOL of the plain bf16 model's; 20 steps per model on one fixed
    batch: every term finite, the generator's reconstruction terms falling
    and ending within TRAJ_TOL of the plain model's; the launches of one
    counted step; samples/s (median of 18 steps after 2 warm-ups).
    Returns the counted launches."""
    b, h, w = B18
    batch = gan_batch(dev, 4)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _, g_ref = _gan_step_grads(dev, False, "float32", batch)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    l_k, g_k = _gan_step_grads(dev, True, "bfloat16", batch)
    l_p, g_p = _gan_step_grads(dev, False, "bfloat16", batch)
    print(f"recipe 4 step {b}x{h}x{w}:")
    fails = []
    for sub in GAN_SUBMODELS:
        names = [n for n in g_ref if n.startswith(sub + ".")]
        cat = [torch.cat([g[n].flatten() for n in names])
               for g in (g_k, g_p, g_ref)]
        fails.append(_check_grad(f"{sub} gradient ({cat[2].numel()} "
                                 "values)", *cat))
    for n in ("conv1.weight", "conv1.bias", "conv2.weight", "conv2.bias"):
        n = f"coarse_model.{n}"
        fails.append(_check_grad(n, g_k[n], g_p[n], g_ref[n]))
    fails = [f for f in fails if f]
    if fails:
        raise AssertionError("recipe 4: " + "; ".join(fails))
    for k in l_p:
        rel = abs(l_k[k] - l_p[k]) / max(abs(l_p[k]), 1e-30)
        print(f"  {k}: kernel {l_k[k]:.6g} plain {l_p[k]:.6g} rel {rel:.3g}")
        if not math.isfinite(l_k[k]) or rel > LOSS_TOL:
            raise AssertionError(f"recipe 4: {k} differs by {rel:.4g} > "
                                 f"{LOSS_TOL}")
    del g_ref, g_k, g_p
    runs = {}
    for name, use_kernels in (("kernel", True), ("plain", False)):
        dicts, times, counts = _gan_trajectory(dev, use_kernels)
        if not all(math.isfinite(v) for d in dicts for v in d.values()):
            raise AssertionError(f"recipe 4 {name}: a non-finite loss term")
        recon = [sum(d[k] for k in GAN_RECON) for d in dicts]
        if not recon[-1] < recon[0]:
            raise AssertionError(f"recipe 4 {name}: the reconstruction "
                                 f"terms did not fall: {recon}")
        rate = b / statistics.median(times)
        print(f"recipe 4 {name} model: reconstruction terms {recon[0]:.6g} "
              f"-> {recon[-1]:.6g}, loss_all {dicts[0]['loss_all']:.6g} -> "
              f"{dicts[-1]['loss_all']:.6g} over {len(dicts)} steps; "
              f"{rate:.4f} samples/s (median of {len(times)} steps) on {card}")
        print(f"  reconstruction: {' '.join(f'{v:.5g}' for v in recon)}")
        print("  last step: " + ", ".join(f"{k} {v:.5g}"
                                          for k, v in dicts[-1].items()))
        runs[name] = (recon[-1], counts)
    gap = abs(runs["kernel"][0] - runs["plain"][0]) / abs(runs["plain"][0])
    print(f"recipe 4: final reconstruction terms kernel {runs['kernel'][0]:.6g}"
          f" plain {runs['plain'][0]:.6g} (rel {gap:.4g}, bound {TRAJ_TOL})")
    if gap > TRAJ_TOL:
        raise AssertionError(f"recipe 4: final terms differ by {gap:.4g}")
    counts = runs["kernel"][1]
    print(f"recipe 4 step launches: "
          f"{json.dumps({k: v for k, v in counts.items() if v})}")
    _check_step_counts("recipe 4", counts, PER_GAN_STEP)
    return counts


def gan_runner_phase(dev, card):
    """Phases 17-18: recipe 4 through the launcher on synthetic data: two
    epochs of 8 steps with a checkpoint each (every discriminator and its
    Adam state in it), the writer's val metrics against recipe 5's
    ``--checkepoch_range`` sweep reloading both checkpoints (within
    RELOAD_VAL_TOL), ``--r --checkepoch 1`` (epoch-2 losses within
    RESUME_LOSS_TOL), and ``--split cycgen`` of the VAEHRNet generator at
    2x512x1024 from the epoch-2 checkpoint.  Returns the counted launches
    of each run."""
    tmp = tempfile.mkdtemp(prefix="dvie_gan_runner_")
    runs = []
    try:
        exp_a = os.path.join(tmp, "a")
        os.makedirs(exp_a)
        cfg = parse_args(f"{GAN_GLOBAL} --split train --epochs 2 "
                         f"{GAN_TRAIN}".split())
        get_logger(exp_a, "train")
        writer = _quiet(lambda: Runner(cfg, exp_a))
        _, counts = _counted("recipe 4 runner train", PER_GAN_STEP,
                             2 * RUNNER_EPOCH_STEPS,
                             lambda: _quiet(writer.train_epochs))
        runs.append(counts)
        log_a = _log_of(exp_a)
        losses_a = {(int(e), int(i)): float(v)
                    for e, i, v in LOSS_LINE.findall(log_a)}
        if len(losses_a) != 2 * RUNNER_EPOCH_STEPS or not all(
                map(math.isfinite, losses_a.values())):
            raise AssertionError(f"recipe 4 runner: losses {losses_a}")
        for e, n, wall, rate, load, comp in EPOCH_LINE.findall(log_a):
            print(f"recipe 4 runner epoch {e}: {n} samples in {wall} s, "
                  f"{rate} samples/s, load {load} s, comp {comp} s on {card}")
        names = sorted(os.listdir(os.path.join(exp_a, "checkpoint")))
        if names != ["InterGANNet_xs2xs_inter_24_1_0",
                     "InterGANNet_xs2xs_inter_24_2_0"]:
            raise AssertionError(f"recipe 4 runner: checkpoints {names}")
        ckpt = ckpt_lib.load_checkpoint(
            os.path.join(exp_a, "checkpoint", names[1]))
        missing = [k for sub in GAN_SUBMODELS
                   for k in (sub, ckpt_lib.optimizer_key(sub))
                   if k not in ckpt]
        if missing:
            raise AssertionError(f"recipe 4 runner: checkpoint lacks "
                                 f"{missing}")

        m_writer, counts = _counted(
            "recipe 4 runner val", PER_GAN_VAL, RUNNER_VAL_BATCHES,
            lambda: _quiet(writer.validate))
        runs.append(counts)
        sweep = parse_args(
            f"{GAN_GLOBAL} --split val --load_dir {exp_a} --checksession 24 "
            "--checkepoch_range --checkepoch_low 1 --checkepoch_up 2 "
            f"{GAN_LOAD} --load_coarse".split())
        swept = _quiet(lambda: run(sweep, os.path.join(tmp, "sweep")))
        for k, v in m_writer.items():
            got = swept[2][k]
            print(f"recipe 4 val {k}: writer {v:.6g}, reloaded {got:.6g}, "
                  f"epoch 1 {swept[1][k]:.6g}")
            if abs(got - v) > RELOAD_VAL_TOL * abs(v):
                raise AssertionError(f"recipe 4 val: reloaded {k} {got} vs "
                                     f"the writer's {v}")
        if swept[1] == swept[2]:
            raise AssertionError("recipe 4 val: epochs 1 and 2 alike")

        exp_b = os.path.join(tmp, "b")
        resume = parse_args(
            f"{GAN_GLOBAL} --split train --epochs 2 --r --checkepoch 1 "
            f"--checksession 24 --load_dir {exp_a} {GAN_TRAIN}".split())
        _quiet(lambda: run(resume, exp_b))
        losses_b = {(int(e), int(i)): float(v)
                    for e, i, v in LOSS_LINE.findall(_log_of(exp_b))}
        if sorted(losses_b) != [(2, i) for i in range(RUNNER_EPOCH_STEPS)]:
            raise AssertionError(f"recipe 4 resume: logged {sorted(losses_b)}")
        gap = max(abs(v - losses_a[k]) / abs(losses_a[k])
                  for k, v in losses_b.items())
        print(f"recipe 4 resume: epoch-2 loss_all within {gap:.4g} of the "
              f"uninterrupted run's (bound {RESUME_LOSS_TOL})")
        if gap > RESUME_LOSS_TOL:
            raise AssertionError(f"recipe 4 resume: loss_all off by {gap:.4g}")

        cyc = parse_args(
            "--dataset synthetic --split cycgen --syn_type inter --input_h 512 "
            f"--input_w 1024 --bs 2 --load_dir {exp_a} --checksession 24 "
            f"--checkepoch 2 {GAN_LOAD} --load_coarse".split())
        t0 = time.perf_counter()
        out_root, counts = _counted(
            "recipe 4 runner cycgen", PER_FORWARD, RUNNER_CYCGEN_FORWARDS,
            lambda: _quiet(lambda: run(cyc, os.path.join(tmp, "cyc"))))
        dt = time.perf_counter() - t0
        runs.append(counts)
        _cycgen_tree("recipe 4 cycgen", out_root, f"{dt:.3f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


# ---- recipe 6, extrapolation (phases 19-24) --------------------------------

B24 = (24, 128, 128)           # recipe 6's batch and crop (RECIPES.md:76-83)
R6_GLOBAL = ("--dataset synthetic --syn_type extra --interval 9 "
             "--one_hot_seg --input_h 128 --input_w 128 --bs 24 "
             "--vid_len 3 --disp_interval 1")
R6_MODEL = "EXTRA --model ExtraNet --coarse_model HRNet --load_model ExtraNet"
R6_TRAIN = f"{R6_MODEL} --train_coarse --num_pred_step 3"
CFG_R6 = parse_args(f"{R6_GLOBAL} --split train {R6_TRAIN}".split())
CFG_X = Config(model="ExtraNet", coarse_model="HRNet", syn_type="extra",
               runner="EXTRA", compute_dtype="bfloat16")
CFG_XI = dataclasses.replace(CFG_X, model="ExtraInpaintNet", inpaint=True,
                             inpaint_mask=True)
# a served ExtraNet forward launches what an InterNet forward does;
# ExtraInpaintNet's --inpaint_mask heads (24 wide) take the 216 and 24
# instances in place of the 208 and 23 ones
PER_FORWARD_XI = {**PER_FORWARD, "ups_head_taps": 0, "upshead_taps_n216": 1,
                  "shifted_add_bias": 0, "shiftadd_co24": 1}
# one recipe-6 step: three forwards and their backward, each the b0
# step's launches
PER_R6_STEP = {k: 3 * v for k, v in PER_TRAIN_STEP.items()}
# --num_pred_once 2 (one forward): the heads through K4's h mode (its
# backward autograd of the plain version), no taps, no shifted add
PER_PRED2_STEP = {**PER_TRAIN_STEP, "ups_head_taps": 0, "ups_head_1x1": 1,
                  "shifted_add_bias": 0}
# --fix_init_frames: the stem takes 21 channels, padded to 48
PER_FIX_STEP = {**PER_R6_STEP, "stem_fwd": 0, "stem_bwd": 0,
                "stem48_fwd": 3, "stem48_bwd": 3}
# the writer's val: the full 3-step rollout at 24x128x128 (the forward
# kernels of the train chain, W < 256) per batch
PER_R6_VAL = {k: 3 * v for k, v in PER_VAL_FORWARD.items()}
R6_VARIANTS = (("--num_pred_once 2", "--num_pred_once 2 --num_pred_step 1",
                PER_PRED2_STEP),
               ("--fix_init_frames", "--fix_init_frames --num_pred_step 3",
                PER_FIX_STEP))


def r6_batch(dev, seed, n_frames=5, b=B24[0]):
    """A seeded synthetic batch of ``n_frames`` frames at 128x128."""
    return {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(
        b, B24[1], B24[2], vid_len=n_frames, seed=seed).items()}


def r6_setup(dev, cfg, use_kernels, dtype="bfloat16", train=True):
    """``cfg``'s extrapolation model from seed 0, frozen VGG19 from seed 1,
    Adamax, and its step (``train/extra.make_train_step``)."""
    cfg = dataclasses.replace(cfg, compute_dtype=dtype, train_coarse=train)
    model = registry.build_model(cfg, device=dev, seed=0,
                                 use_kernels=use_kernels)
    state = state_lib.create_train_state(
        cfg, model, init_vgg_frozen(cfg, seed=1, device=dev))
    return extra.make_train_step(cfg, model), state


def _r6_grads(dev, cfg, use_kernels, dtype, batch):
    step, state = r6_setup(dev, cfg, use_kernels, dtype, train=False)
    _, losses = step(state, batch)
    grads = {n: p.grad.float() for n, p in state.model.named_parameters()}
    return {k: float(v) for k, v in losses.items()}, grads


def _f32(fn):
    """``fn()`` with TF32 off."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return fn()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def r6_grad_check(dev, cfg, label, batch, leaves=True):
    """One step's gradient, kernel model and plain bf16 model against the
    plain f32 model (TF32 off), by GRAD_RATIO and GRAD_FLOOR: the whole
    gradient and (``leaves``) each of the 33 train-chain leaves; each loss
    term within LOSS_TOL of the plain bf16 model's."""
    _, g_ref = _f32(lambda: _r6_grads(dev, cfg, False, "float32", batch))
    l_k, g_k = _r6_grads(dev, cfg, True, "bfloat16", batch)
    l_p, g_p = _r6_grads(dev, cfg, False, "bfloat16", batch)
    print(f"{label} step {tuple(batch['frame1'].shape[:3])}:")
    names = [n for n in g_ref if _train_chain_leaf(n)]
    if leaves and len(names) != N_LEAVES[(0,)]:
        raise AssertionError(f"{label}: {len(names)} train-kernel leaves")
    fails = [_check_grad("whole gradient", _flat(g_k), _flat(g_p),
                         _flat(g_ref))]
    if leaves:
        fails += [_check_grad(n, g_k[n], g_p[n], g_ref[n]) for n in names]
    fails = [f for f in fails if f]
    if fails:
        raise AssertionError(f"{label}: " + "; ".join(fails))
    for k in l_p:
        rel = abs(l_k[k] - l_p[k]) / max(abs(l_p[k]), 1e-30)
        print(f"  {k}: kernel {l_k[k]:.6g} plain {l_p[k]:.6g} rel {rel:.3g}")
        if not math.isfinite(l_k[k]) or rel > LOSS_TOL:
            raise AssertionError(f"{label}: {k} differs by {rel:.4g} > "
                                 f"{LOSS_TOL}")


def r6_rgb_dx_check(dev):
    """The gradient of an extrapolation forward with respect to its input
    rgb (the BPTT path: a step's predicted rgb is the next step's input, so
    its gradient goes through the stem kernel's dx, whose 6 rgb channels
    this reads), kernel model and plain bf16 model against the plain f32
    model, by GRAD_RATIO and GRAD_FLOOR, at 24x128x128: loss = sum(rgb_out
    * c1) + sum(seg_out * c2) for fixed random c1, c2."""
    g = torch.Generator(device=dev).manual_seed(12)
    b, h, w = B24
    rgb = torch.rand((b, h, w, 6), generator=g, device=dev) * 2 - 1
    seg = serve.seg_oh(torch.randint(0, 20, (b, h, w, 2), generator=g,
                                     device=dev)).reshape(b, h, w, 40)
    c1 = torch.randn((b, h, w, 3), generator=g, device=dev)
    c2 = torch.randn((b, h, w, 20), generator=g, device=dev)

    def dx(use_kernels, dtype):
        cfg = dataclasses.replace(CFG_X, compute_dtype=dtype)
        model = registry.build_model(cfg, device=dev, seed=0,
                                     use_kernels=use_kernels).coarse_model
        x = rgb.clone().requires_grad_()
        r, s = model(x, seg)
        ((r.float() * c1).sum() + (s.float() * c2).sum()).backward()
        return x.grad.float()

    ref = _f32(lambda: dx(False, "float32"))
    fail = _check_grad("extrapolation forward: d/d input rgb (the stem "
                       "kernel's dx on 6 rgb channels)",
                       dx(True, "bfloat16"), dx(False, "bfloat16"), ref)
    if fail:
        raise AssertionError(fail)


def extra_serve_phase(dev, card):
    """Phases 19-20: ExtraNet and ExtraInpaintNet (``--inpaint
    --inpaint_mask``: the 216 and 24 instances) served: kernel against
    plain model at 2x128x256 (final frame: the coarse one, the inpainted
    one), then the 3-step rollout at 2x512x1024 bf16 with the launches per
    forward, frames/s and peak memory.  Returns the counted launches."""
    slice_phase(dev, CFG_X, "extranet slice")
    counts = [serve_phase(dev, card, CFG_X, PER_FORWARD,
                          "extranet serve rollout")]
    slice_phase(dev, CFG_XI, "extrainpaintnet --inpaint_mask slice")
    counts.append(serve_phase(dev, card, CFG_XI, PER_FORWARD_XI,
                              "extrainpaintnet --inpaint_mask serve rollout"))
    return counts


def h_mode_backward_check(dev):
    """K4's h mode as a head route with a gradient (``ups_head_1x1``, the
    heads at ``--num_pred_once 2``) at 24x128x128: h and the grads of its
    five inputs against plain autograd, on pre-activations kept from 0
    (b1 of +-6: masks fixed) and on random ones: h by max|d|/max|ref| <=
    KERNEL_TOL, dp0 too on fixed masks; every grad, kernel route and plain
    bf16 autograd, against plain autograd on f32 copies of the
    activations (TF32 off), by GRAD_RATIO and GRAD_FLOOR.  (dp1 and dp2 go
    through the bilinear upsampling's backward, which adds in bf16 by
    atomics in no fixed order: two runs of the same plain bf16 backward
    differ there by up to 2.4% of max and 1.1e-2 rel-L2 on an H100.)
    Forward plus backward timed against the plain version's."""
    g = torch.Generator(device=dev).manual_seed(13)
    b, h, w = B24

    def act(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    parts = (act(b, h, w, 64), act(b, h // 2, w // 2, 128),
             act(b, h // 4, w // 4, 256))
    w1 = torch.randn((448, 896), generator=g, device=dev) / 448 ** 0.5
    dh = act(b, h, w, 896) * 1e-2
    fixed = torch.sign(torch.randn((896,), generator=g, device=dev)) * 6
    rand = torch.randn((896,), generator=g, device=dev) * 0.1

    def run_(fn, b1, dtype=torch.bfloat16):
        leaves = [t.to(dtype).clone().requires_grad_() for t in parts]
        leaves += [t.clone().requires_grad_() for t in (w1, b1)]
        out = fn(*leaves)
        out.backward(dh.to(dtype))
        return [out] + [t.grad.float() for t in leaves]

    for label, b1 in (("fixed masks", fixed), ("random", rand)):
        got = run_(k4.ups_head_1x1, b1)
        ref = run_(k4.ups_head_1x1_plain, b1)
        ref32 = _f32(lambda: run_(k4.ups_head_1x1_plain, b1, torch.float32))
        torch.cuda.synchronize()
        _held("ups_head_1x1", f"{label}, h", got[0], ref[0])
        if label == "fixed masks":
            _held("ups_head_1x1 backward", f"{label}, dp0", got[1], ref[1])
        fails = [_check_grad(f"ups_head_1x1 backward [{label}, {name}]", o,
                             r, r32)
                 for name, o, r, r32 in zip(("dp0", "dp1", "dp2", "dw1",
                                             "db1"), got[1:], ref[1:],
                                            ref32[1:])]
        fails = [f for f in fails if f]
        if fails:
            raise AssertionError("; ".join(fails))
    ms = median_ms(lambda: run_(k4.ups_head_1x1, rand), iters=3, reps=3)
    plain = median_ms(lambda: run_(k4.ups_head_1x1_plain, rand), iters=3,
                      reps=3)
    print(f"  ups_head_1x1 forward + backward [24x128x128] kernel route "
          f"{ms:.4f} ms, plain {plain:.4f} ms")


def r6_step_phase(dev, card):
    """Phases 21-22: recipe 6's step (``train/extra.make_train_step``,
    ``docs/RECIPES.md:76-83``: ExtraNet, HRNet, three forwards with BPTT)
    at 24x128x128 bf16 with f32 masters: the gradient with respect to an
    extrapolation forward's input rgb; one step's gradient (whole and the
    33 train-chain leaves) and loss terms, and a one-forward step's
    (``--num_pred_step 1``) gradient, against the f32 plain model; 20
    steps per model whose loss_all falls and ends within TRAJ_TOL of the
    plain model's; the launches of one counted step (three times the b0
    step's); samples/s (median of 18 steps after 2 warm-ups); peak memory.
    Then the ``--num_pred_once 2`` (one forward, K4's h mode with its
    gradient) and ``--fix_init_frames`` (three input frames: the stem at 48
    channels) steps: gradient, launches, samples/s of 8 steps.  Returns
    the counted launches."""
    b, h, w = B24
    r6_rgb_dx_check(dev)
    r6_grad_check(dev, CFG_R6, "recipe 6", r6_batch(dev, 4))
    r6_grad_check(dev, dataclasses.replace(CFG_R6, num_pred_step=1),
                  "recipe 6 --num_pred_step 1", r6_batch(dev, 4, 3),
                  leaves=False)
    batch = r6_batch(dev, 5)
    runs = {}
    for name, use_kernels in (("kernel", True), ("plain", False)):
        losses, times, counts, peak = _run(dev, CFG_R6, batch, 20,
                                           use_kernels)
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"recipe 6 {name}: loss_all did not fall: "
                                 f"{losses}")
        rate = b / statistics.median(times)
        print(f"recipe 6 {name} model: loss_all {losses[0]:.6g} -> "
              f"{losses[-1]:.6g} over {len(losses)} steps; {rate:.4f} "
              f"samples/s (median of {len(times)} steps), peak memory "
              f"{peak:.3f} GiB on {card}")
        print(f"  loss_all: {' '.join(f'{v:.5g}' for v in losses)}")
        runs[name] = (losses[-1], counts)
    gap = abs(runs["kernel"][0] - runs["plain"][0]) / abs(runs["plain"][0])
    print(f"recipe 6: final loss_all kernel {runs['kernel'][0]:.6g} plain "
          f"{runs['plain'][0]:.6g} (rel {gap:.4g}, bound {TRAJ_TOL})")
    if gap > TRAJ_TOL:
        raise AssertionError(f"recipe 6: final loss differs by {gap:.4g}")
    out = [runs["kernel"][1]]
    print(f"recipe 6 step launches: "
          f"{json.dumps({k: v for k, v in out[0].items() if v})}")
    _check_step_counts("recipe 6", out[0], PER_R6_STEP)
    for label, flags, per in R6_VARIANTS:
        cfg = parse_args(f"{R6_GLOBAL} --split train {R6_TRAIN} "
                         f"{flags}".split())
        n_frames = 2 + cfg.num_pred_once * cfg.num_pred_step
        r6_grad_check(dev, cfg, f"recipe 6 {label}",
                      r6_batch(dev, 4, n_frames), leaves=False)
        losses, times, counts, peak = _run(dev, cfg,
                                           r6_batch(dev, 5, n_frames), 8)
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"recipe 6 {label}: losses {losses}")
        print(f"recipe 6 {label} kernel model: {b / statistics.median(times):.4f}"
              f" samples/s (median of {len(times)} steps), peak memory "
              f"{peak:.3f} GiB on {card}; launches "
              f"{json.dumps({k: v for k, v in counts.items() if v})}")
        _check_step_counts(f"recipe 6 {label}", counts, per)
        out.append(counts)
    return out


def r6_runner_phase(dev, card):
    """Phases 23-24: recipe 6 through the launcher on synthetic data: two
    epochs of 8 steps with a checkpoint each, the writer's val metrics
    (4 val batches, each a 3-step rollout) against a ``--checkepoch_range``
    sweep reloading both checkpoints (within RELOAD_VAL_TOL), ``--r
    --checkepoch 1`` (epoch-2 losses within RESUME_LOSS_TOL), ``--split
    cycgen`` at 2x512x1024 from the epoch-2 checkpoint (2 input frames and
    3 extrapolated ones a clip; the serving launches, 3 forwards a
    batch).  Returns the counted launches of each run."""
    tmp = tempfile.mkdtemp(prefix="dvie_r6_runner_")
    runs = []
    try:
        exp_a = os.path.join(tmp, "a")
        os.makedirs(exp_a)
        cfg = parse_args(f"{R6_GLOBAL} --split train --epochs 2 "
                         f"{R6_TRAIN}".split())
        _quiet(lambda: get_logger(exp_a, "train"))
        writer = _quiet(lambda: Runner(cfg, exp_a))
        _, counts = _counted("recipe 6 runner train", PER_R6_STEP,
                             2 * RUNNER_EPOCH_STEPS,
                             lambda: _quiet(writer.train_epochs))
        runs.append(counts)
        log_a = _log_of(exp_a)
        losses_a = {(int(e), int(i)): float(v)
                    for e, i, v in LOSS_LINE.findall(log_a)}
        if len(losses_a) != 2 * RUNNER_EPOCH_STEPS or not all(
                map(math.isfinite, losses_a.values())):
            raise AssertionError(f"recipe 6 runner: losses {losses_a}")
        for e, n, wall, rate, load, comp in EPOCH_LINE.findall(log_a):
            print(f"recipe 6 runner epoch {e}: {n} samples in {wall} s, "
                  f"{rate} samples/s, load {load} s, comp {comp} s on {card}")
        names = sorted(os.listdir(os.path.join(exp_a, "checkpoint")))
        if names != ["ExtraNet_xs2xs_extra_0_1_0",
                     "ExtraNet_xs2xs_extra_0_2_0"]:
            raise AssertionError(f"recipe 6 runner: checkpoints {names}")

        m_writer, counts = _counted(
            "recipe 6 runner val", PER_R6_VAL, RUNNER_VAL_BATCHES,
            lambda: _quiet(writer.validate))
        runs.append(counts)
        sweep = parse_args(
            f"{R6_GLOBAL} --split val --load_dir {exp_a} --checksession 0 "
            "--checkepoch_range --checkepoch_low 1 --checkepoch_up 2 "
            f"{R6_TRAIN} --load_coarse".split())
        swept = _quiet(lambda: run(sweep, os.path.join(tmp, "sweep")))
        for k, v in m_writer.items():
            got = swept[2][k]
            print(f"recipe 6 val {k}: writer {v:.6g}, reloaded {got:.6g}, "
                  f"epoch 1 {swept[1][k]:.6g}")
            if abs(got - v) > RELOAD_VAL_TOL * abs(v):
                raise AssertionError(f"recipe 6 val: reloaded {k} {got} vs "
                                     f"the writer's {v}")
        if swept[1] == swept[2]:
            raise AssertionError("recipe 6 val: epochs 1 and 2 alike")

        exp_b = os.path.join(tmp, "b")
        resume = parse_args(
            f"{R6_GLOBAL} --split train --epochs 2 --r --checkepoch 1 "
            f"--checksession 0 --load_dir {exp_a} {R6_TRAIN}".split())
        _quiet(lambda: run(resume, exp_b))
        losses_b = {(int(e), int(i)): float(v)
                    for e, i, v in LOSS_LINE.findall(_log_of(exp_b))}
        if sorted(losses_b) != [(2, i) for i in range(RUNNER_EPOCH_STEPS)]:
            raise AssertionError(f"recipe 6 resume: logged {sorted(losses_b)}")
        gap = max(abs(v - losses_a[k]) / abs(losses_a[k])
                  for k, v in losses_b.items())
        print(f"recipe 6 resume: epoch-2 loss_all within {gap:.4g} of the "
              f"uninterrupted run's (bound {RESUME_LOSS_TOL})")
        if gap > RESUME_LOSS_TOL:
            raise AssertionError(f"recipe 6 resume: loss_all off by {gap:.4g}")

        cyc = parse_args(
            "--dataset synthetic --split cycgen --syn_type extra --input_h 512 "
            f"--input_w 1024 --bs 2 --load_dir {exp_a} --checksession 0 "
            f"--checkepoch 2 {R6_TRAIN} --load_coarse".split())
        t0 = time.perf_counter()
        out_root, counts = _counted(
            "recipe 6 runner cycgen", PER_FORWARD, 3 * RUNNER_CYCGEN_FORWARDS,
            lambda: _quiet(lambda: run(cyc, os.path.join(tmp, "cyc"))))
        dt = time.perf_counter() - t0
        runs.append(counts)
        _cycgen_tree("recipe 6 cycgen", out_root, f"{dt:.3f} s", frames=5)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


# ---- --highres_large training, the 4-part head's backward, --remat -------

def ptxas_report(source="upshead4.cu"):
    """The ``-Xptxas -v`` lines of ``source`` from the build's log:
    each kernel instance's registers, stack and spills."""
    log = _build.library_path().with_suffix(".log")
    if not log.exists():
        raise AssertionError(f"no build log {log.name}")
    text = log.read_text()
    part = text.split(f"== {source}\n", 1)[1].split("\n== ", 1)[0]
    lines = [ln.strip() for ln in part.splitlines()
             if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    if not lines:
        raise AssertionError(f"no ptxas lines for {source}")
    for ln in lines:
        print(f"  ptxas {source}: {ln}")


def taps4_backward_check(dev):
    """The 4-part head's backward (``upshead.ups_head_taps4_bwd``: h by the
    kernel's h mode, then the products on bf16 operands, dh and dcat
    rounded once to bf16, dw1 and dw2t f32 results) at the recipe shape,
    24x128x128 (a head of 23: N2 = 207), against its f32-operand form: the
    same function on f32 copies of the operands and of the same h, TF32
    off.  dp0..dp3 by max|d|/max|ref| <= KERNEL_TOL (bf16 results), dw1,
    db1, dw2t by rel-L2 <= WGRAD_TOL.  Prints the median CUDA-event ms of
    both forms."""
    g = torch.Generator(device=dev).manual_seed(14)

    def act(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    def w(*shape):
        return torch.randn(shape, generator=g, device=dev) / (
            shape[1] * shape[2] * shape[3]) ** 0.5

    b, h, w_ = B24
    args = (*(act(b, h // s, w_ // s, c)
              for s, c in ((1, 64), (2, 128), (4, 256), (8, 512))),
            w(1920, 960, 1, 1)[:, :, 0, 0].t(), w(1920, 1, 1, 1).flatten(),
            k4.build_dual_tap_kernel(w(3, 960, 3, 3), w(20, 960, 3, 3),
                                     torch.float32),
            act(b, h, w_, 207, scale=1e-2))
    h32 = k4.ups_head_1x1_4(*args[:6]).float()

    def f32_form():
        return k4.ups_head_taps4_bwd(*(t.float() for t in args), h=h32)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got, ref = k4.ups_head_taps4_bwd(*args), f32_form()
        torch.cuda.synchronize()
        for name, o, r in zip(("dp0", "dp1", "dp2", "dp3"), got[:4],
                              ref[:4]):
            if o.dtype != torch.bfloat16:
                raise AssertionError(f"4-part backward {name}: dtype "
                                     f"{o.dtype}")
            _held("ups_head_taps4_bwd", name, o, r)
        for name, o, r in zip(("dw1", "db1", "dw2t"), got[4:], ref[4:]):
            l2 = rel_l2(o, r)
            print(f"  ups_head_taps4_bwd [{name}] rel-L2={l2:.6g}")
            if (o.dtype != torch.float32 or not torch.isfinite(o).all()
                    or l2 > WGRAD_TOL):
                raise AssertionError(f"4-part backward {name}: rel-L2 "
                                     f"{l2:.4g} or dtype {o.dtype}")
        del got, ref
        ms = median_ms(lambda: k4.ups_head_taps4_bwd(*args), iters=3,
                       reps=3)
        f32_ms = median_ms(f32_form, iters=3, reps=3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    # its least time: the h recompute and the four products (dh, dW2t,
    # dW1, dcat) at the bf16 peak, against the bytes of its operands and
    # grads; the elementwise passes and the upsampling's vjp add none
    m, ct = b * h * w_, args[4].shape[0]
    n1, n2 = args[6].shape
    ops = 2 * m * (3 * ct * n1 + 2 * n1 * n2)
    grads = sum(a.nbytes for a in args[:4]) + 4 * sum(
        a.numel() for a in args[4:7])      # dp0..dp3 bf16, f32 weight grads
    t_ops, t_bytes = ops / BF16_PEAK, (moved_bytes(args) + grads) / HBM_RATE
    print(f"  ups_head_taps4_bwd [24x128x128] bf16 {ms:.4f} ms (h mode "
          f"included), f32-operand form {f32_ms:.4f} ms, bound "
          f"{1e3 * max(t_ops, t_bytes):.4f} ms "
          f"({'operations' if t_ops >= t_bytes else 'bytes'}: "
          f"{ops / 1e12:.3f} TFLOP)")
    return ms


CFG_XI_HL = dataclasses.replace(CFG_XI, highres_large=True)
# ExtraInpaintNet --inpaint_mask --highres_large served: the --highres_large
# forward with the 4-part head's 216 instance and the co-24 shift add
PER_FORWARD_XI_HL = {**PER_FORWARD_HL, "ups_head_taps4": 0,
                     "upshead4_taps_n216": 1, "shifted_add_bias": 0,
                     "shiftadd_co24": 1}


def highres_extra_serve_phase(dev, card):
    """ExtraInpaintNet ``--inpaint --inpaint_mask --highres_large`` served:
    kernel against plain model at 2x128x256 (the inpainted frame), then
    the 3-step rollout at 2x512x1024 bf16 with the launches per forward
    (the 216 instance and the co-24 shift add 1 each), frames/s and peak
    memory.  Returns the counted launches."""
    slice_phase(dev, CFG_XI_HL,
                "extrainpaintnet --inpaint_mask --highres_large slice")
    return serve_phase(dev, card, CFG_XI_HL, PER_FORWARD_XI_HL,
                       "extrainpaintnet --inpaint_mask --highres_large "
                       "serve rollout")


CFG_HL_TRAIN = dataclasses.replace(CFG_HL, train_coarse=True)
CFG_R6_HL = dataclasses.replace(CFG_R6, highres_large=True)
CFG_GAN_HL = dataclasses.replace(CFG_GAN, highres_large=True)
# one --highres_large train step at 24x128x128 (b0): stage 4's branch 0 is
# a third C = 64 chain call (4 blocks, one weight-grad launch), branches
# 1-3 block by block; the 4-part head (208) in place of K4's taps and its
# backward's h by the 4-part h mode in place of K4's; stage 4's out-0 fuse
# is plain, so K3 stays 2
PER_TRAIN_STEP_HL = {**PER_TRAIN_STEP, "bb_chain_fwd": 12,
                     "bb_chain_bwd": 12, "bb_chain_wgrad": 3,
                     "ups_head_taps": 0, "ups_head_1x1": 0,
                     "ups_head_taps4": 1, "ups_head_1x1_4": 1}
PER_R6_STEP_HL = {k: 3 * v for k, v in PER_TRAIN_STEP_HL.items()}
PER_GAN_STEP_HL = {**PER_TRAIN_STEP_HL, "stem_fwd": 0, "stem_bwd": 0,
                   "stem48_fwd": 1, "stem48_bwd": 1}
# the forward kernels inside --remat's checkpoint regions (the stem and
# layer1, the transitions, the stage modules): each launches again in the
# region's recompute; the heads' kernels sit outside every region
REMAT_RECOMPUTED = ("stem_fwd", "stem48_fwd", "stem64_fwd", "bottleneck_fwd",
                    "bb_chain_fwd", "bb_chain_fwd_c128", "bb_chain_fwd_c256",
                    "fuse_out0", "conv3x3_bias_res_lrelu")


def remat_counts(per_step):
    """The launches of a --remat step: ``per_step``'s, the recomputed
    regions' forward kernels twice."""
    return {k: (2 * v if k in REMAT_RECOMPUTED else v)
            for k, v in per_step.items()}


def _setup(dev, cfg, use_kernels, dtype="bfloat16"):
    """``cfg``'s model from seed 0, frozen VGG19 from seed 1 (and under
    ``--track_obj_loss`` the frozen ResNet101 from seed 2), its
    optimizers, and its train step: recipe 4's, EXTRA's or INTER's, with a
    generator of seed 11 for the VAE's eps and the sync_neg offsets."""
    cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    model = registry.build_model(cfg, device=dev, seed=0,
                                 use_kernels=use_kernels)
    resnet = (init_resnet_frozen(cfg, seed=2, device=dev)
              if cfg.track_obj_loss else None)
    state = state_lib.create_train_state(
        cfg, model, init_vgg_frozen(cfg, seed=1, device=dev), resnet)
    lib = (inter_gan if cfg.model == "InterGANNet" else
           extra if cfg.syn_type == "extra" else inter)
    step = lib.make_train_step(cfg, model,
                               torch.Generator(dev).manual_seed(11))
    return step, state


def _grads(dev, cfg, use_kernels, dtype, batch):
    """One step's loss terms, the f32 gradient of every leaf and every
    buffer after it (BatchNorm statistics, spectral-norm vectors)."""
    step, state = _setup(dev, cfg, use_kernels, dtype)
    _, losses = step(state, batch)
    model = state.model
    out = ({k: float(v) for k, v in losses.items()},
           {n: p.grad.float() for n, p in model.named_parameters()},
           {n: b.clone() for n, b in model.named_buffers()})
    del step, state, model
    torch.cuda.empty_cache()
    return out


def _run(dev, cfg, batch, steps, use_kernels=True, warmup=2, count_at=2,
         terms=("loss_all",)):
    """``steps`` steps of ``cfg``'s model (the kernel one unless
    ``use_kernels`` is False) on one fixed batch: the sum of ``terms``
    (loss_all) of each, the step times after the warm-ups (host clock
    around each synchronized step), the launches of step ``count_at`` and
    the peak memory (GiB) of the run."""
    step, state = _setup(dev, cfg, use_kernels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
        losses.append(sum(float(ld[k]) for k in terms))
    peak = torch.cuda.max_memory_allocated() / 2**30
    del step, state
    torch.cuda.empty_cache()
    return losses, times, counts, peak


def _losses_held(label, l_k, l_p):
    for k in l_p:
        rel = abs(l_k[k] - l_p[k]) / max(abs(l_p[k]), 1e-30)
        print(f"  {k}: {l_k[k]:.6g} against {l_p[k]:.6g} rel {rel:.3g}")
        if not math.isfinite(l_k[k]) or rel > LOSS_TOL:
            raise AssertionError(f"{label}: {k} differs by {rel:.4g} > "
                                 f"{LOSS_TOL}")


def hl_grad_check(dev, cfg, label, batch):
    """The gradient of a --highres_large forward, kernel model and plain
    bf16 model, against the plain f32 model (TF32 off) by GRAD_RATIO and
    GRAD_FLOOR: the whole gradient, each train-chain leaf (stages 2-4,
    branch 0: 41) and each of the heads' 8 leaves (their grads from the
    4-part head's explicit backward and the shift add's adjoint), of the
    recipe's loss terms on the first predicted frame and its seg (L1, GDL,
    VGG, SSIM, CE) computed on the outputs cast to f32.  The step's own
    loss is no yardstick here: its SSIM runs in the prediction's dtype (the
    blur and the variances, as the JAX package computes them), which in
    bf16 is ill-conditioned where the init predicts far outside [-1, 1]
    (|rgb| up to 4.7 at 24x128x128): forwards that differ by rounding give
    rgb gradients 1.09 apart by rel-L2 there, 0.006 with the SSIM in f32.
    Then one step of each model: every loss term of the kernel model within
    LOSS_TOL of the plain bf16 model's."""
    if cfg.syn_type == "extra":    # frames 1 and 2 in, frame 3 predicted
        x = torch.cat([batch["frame1"], batch["frame2"]], -1)
        seg = torch.cat([serve.seg_oh(batch["seg1"]),
                         serve.seg_oh(batch["seg2"])], -1)
        gt, ids = batch["frame3"], batch["seg3"]
    else:
        x, seg, gt, _ = inter.get_inter_inputs(batch)
        ids = batch["seg2"]

    def grads(use_kernels, dtype):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        model = registry.build_model(c, device=dev, seed=0,
                                     use_kernels=use_kernels).coarse_model
        vgg = init_vgg_frozen(c, seed=1, device=dev)
        r, s = model(x, seg)[:2]
        terms = rgb_bundle(c, r[..., :3].float(), gt, make_vgg_l1_loss(vgg),
                           "coarse")
        terms["ce"] = cross_entropy_loss(s[..., :20].float(), ids.long())
        sum(v.mean() for v in terms.values()).backward()
        out = {f"coarse_model.{n}": p.grad.float()
               for n, p in model.named_parameters()}
        del model, vgg
        torch.cuda.empty_cache()
        return out

    g_ref = _f32(lambda: grads(False, "float32"))
    g_k, g_p = grads(True, "bfloat16"), grads(False, "bfloat16")
    print(f"{label} forward {tuple(x.shape[:3])}, gradient of its loss terms "
          "on f32 outputs:")
    chain = [n for n in g_ref if _train_chain_leaf(n, stages=(2, 3, 4))]
    heads = [n for n in g_ref if n.startswith(("coarse_model.rgb_layer.",
                                               "coarse_model.seg_layer."))]
    if len(chain) != 41 or len(heads) != 8:
        raise AssertionError(f"{label}: {len(chain)} train-chain leaves, "
                             f"{len(heads)} head leaves")
    fails = [_check_grad("whole gradient", _flat(g_k), _flat(g_p),
                         _flat(g_ref))]
    fails += [_check_grad(n, g_k[n], g_p[n], g_ref[n]) for n in chain + heads]
    fails = [f for f in fails if f]
    if fails:
        raise AssertionError(f"{label}: " + "; ".join(fails))
    del g_ref, g_k, g_p
    l_k, _, _ = _grads(dev, cfg, True, "bfloat16", batch)
    l_p, _, _ = _grads(dev, cfg, False, "bfloat16", batch)
    print(f"{label} step {tuple(batch['frame1'].shape[:3])}, loss terms "
          "against the plain bf16 model's:")
    _losses_held(label, l_k, l_p)


def _hl_trajectories(dev, card, cfg, label, batch, per_step):
    """HL_STEPS steps of the kernel and the plain model of ``cfg`` on one
    fixed batch: every loss finite; samples/s (median after 2 warm-ups),
    peak memory; the kernel model's launches of one counted
    step against ``per_step``.  The loss is not required to fall, nor the
    two models to end together: at the recipe's lr 1e-3 the seeded
    --highres_large models' loss jumps by 1e2 to 1e8 after the first
    Adamax step and stays chaotic (as the JAX package's does on the CPU,
    tests/test_torch_port_highres_train.py), so two correct models part
    after a few steps.  Returns the counted launches."""
    b = batch["frame1"].shape[0]
    for name, use_kernels in (("kernel", True), ("plain", False)):
        losses, times, c, peak = _run(dev, cfg, batch, HL_STEPS,
                                      use_kernels)
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"{label} {name}: a non-finite loss_all: "
                                 f"{losses}")
        print(f"{label} {name} model: loss_all {losses[0]:.6g} -> "
              f"{losses[-1]:.6g} over {len(losses)} steps; "
              f"{b / statistics.median(times):.4f} samples/s (median of "
              f"{len(times)} steps), peak memory {peak:.3f} GiB on {card}")
        print(f"  loss_all: {' '.join(f'{v:.5g}' for v in losses)}")
        if use_kernels:
            counts = c
    print(f"{label} step launches: "
          f"{json.dumps({k: v for k, v in counts.items() if v})}")
    _check_step_counts(label, counts, per_step)
    return counts


def highres_train_phase(dev, card):
    """--highres_large training: recipe 1 (InterNet, b0) and recipe 6
    (ExtraNet, three forwards) at 24x128x128 bf16 with f32 masters: the
    gradient of a forward's loss terms on f32 outputs (whole, the 41
    train-chain leaves, the heads' 8) of the kernel and the plain bf16
    model against the plain f32 model, and one step's loss terms
    (``hl_grad_check``); HL_STEPS steps per model:
    finite losses, samples/s, peak memory, the launches of one counted
    step.  Then recipe 4 (18x128x128) runs 3 steps, the third counted.
    Returns the counted launches."""
    out = []
    batch = train_batch(dev, *B24, seed=4)
    hl_grad_check(dev, CFG_HL_TRAIN, "recipe 1 --highres_large", batch)
    out.append(_hl_trajectories(dev, card, CFG_HL_TRAIN,
                                "recipe 1 --highres_large",
                                train_batch(dev, *B24, seed=5),
                                PER_TRAIN_STEP_HL))
    hl_grad_check(dev, CFG_R6_HL, "recipe 6 --highres_large",
                  r6_batch(dev, 4))
    out.append(_hl_trajectories(dev, card, CFG_R6_HL,
                                "recipe 6 --highres_large", r6_batch(dev, 5),
                                PER_R6_STEP_HL))
    losses, times, counts, peak = _run(dev, CFG_GAN_HL, gan_batch(dev, 5), 3)
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"recipe 4 --highres_large: losses {losses}")
    print(f"recipe 4 --highres_large kernel model: loss_all "
          f"{' '.join(f'{v:.5g}' for v in losses)}; {B18[0] / times[0]:.4f} "
          f"samples/s (step 3), peak memory {peak:.3f} GiB on {card}; "
          f"launches {json.dumps({k: v for k, v in counts.items() if v})}")
    _check_step_counts("recipe 4 --highres_large", counts, PER_GAN_STEP_HL)
    out.append(counts)
    return out


# steps of the --highres_large trajectories and of each --remat run, short
# enough to leave the whole script's time for phases 28-33
HL_STEPS, REMAT_STEPS = 8, 6
REMAT_CASES = (("recipe 1 --highres_large", CFG_HL_TRAIN,
                PER_TRAIN_STEP_HL),
               ("recipe 4", CFG_GAN, PER_GAN_STEP),
               ("recipe 6", CFG_R6, PER_R6_STEP))


def remat_phase(dev, card):
    """--remat: recipe 1 (InterNet --highres_large, 24x128x128), recipe 4
    (18x128x128) and recipe 6 (24x128x128, three forwards), bf16: one
    step's gradient under --remat and without it, each against the plain
    f32 model without it (TF32 off), the --remat one within GRAD_RATIO x
    the other's error + GRAD_FLOOR (the bf16 upsampling's backward adds by
    atomics, so two runs of one step differ); its loss terms within
    LOSS_TOL of the step's without it; every buffer after the step (the
    BatchNorm statistics and spectral-norm vectors of recipe 4) within
    1e-4 of max(1, max|ref|) of the step's without it (moved once, not
    twice); then 6 steps with and without --remat: samples/s, peak memory
    (lower under --remat on recipe 6, or the phase fails), the launches of
    one counted step (the recomputed regions' forward kernels twice).
    Returns the counted launches."""
    out = []
    for label, cfg, per_step in REMAT_CASES:
        batch = (gan_batch(dev, 4) if cfg.model == "InterGANNet" else
                 r6_batch(dev, 4) if cfg.syn_type == "extra" else
                 train_batch(dev, *B24, seed=4))
        remat = dataclasses.replace(cfg, remat=True)
        _, g_ref, _ = _f32(lambda: _grads(dev, cfg, False, "float32", batch))
        l_n, g_n, b_n = _grads(dev, cfg, True, "bfloat16", batch)
        l_r, g_r, b_r = _grads(dev, remat, True, "bfloat16", batch)
        print(f"{label} --remat step {tuple(batch['frame1'].shape[:3])}:")
        fail = _check_grad("whole gradient (\"kernel\": --remat, "
                           "\"plain bf16\": without)",
                           _flat(g_r), _flat(g_n), _flat(g_ref))
        if fail:
            raise AssertionError(f"{label} --remat: {fail}")
        _losses_held(f"{label} --remat", l_r, l_n)
        worst = 0.0
        for n, ref in b_n.items():
            d = (b_r[n].float() - ref.float()).abs().max().item()
            worst = max(worst, d / max(1.0, ref.float().abs().max().item()))
        print(f"  {len(b_n)} buffers: worst max|d| {worst:.3g} of max(1, "
              f"max|ref|) (bound 1e-4)")
        if worst > 1e-4:
            raise AssertionError(f"{label} --remat: a buffer moved "
                                 f"otherwise ({worst:.4g})")
        del g_ref, g_n, g_r
        torch.cuda.empty_cache()
        runs = {}
        for name, c, per in (("without --remat", cfg, per_step),
                             ("--remat", remat, remat_counts(per_step))):
            losses, times, counts, peak = _run(dev, c, batch, REMAT_STEPS)
            if not all(map(math.isfinite, losses)):
                raise AssertionError(f"{label} {name}: losses {losses}")
            rate = batch["frame1"].shape[0] / statistics.median(times)
            print(f"{label} {name}: {rate:.4f} samples/s (median "
                  f"of {len(times)} steps), peak memory {peak:.3f} GiB on "
                  f"{card}; launches "
                  f"{json.dumps({k: v for k, v in counts.items() if v})}")
            _check_step_counts(f"{label} {name}", counts, per)
            runs[name] = peak
            out.append(counts)
        print(f"{label}: peak memory {runs['without --remat']:.3f} GiB "
              f"without --remat, {runs['--remat']:.3f} with it")
        if label == "recipe 6" and not (runs["--remat"]
                                        < runs["without --remat"]):
            raise AssertionError("recipe 6: the --remat peak is not below "
                                 "the peak without it")
    return out


# ---- the rest of recipe 4 and the plain VAE (phases 28-33) -----------------

# the track-object variant of recipe 4 (RECIPES.md:60-61)
CFG_TOBJ = parse_args(f"{GAN_GLOBAL} --track_obj_loss --track_obj_w 8 "
                      f"--n_track 4 --split train {GAN_TRAIN}".split())
DET_REST = ("VideoVecSNDetDiscriminator", "VideoPoolSNDetDiscriminator",
            "VideoGlobalZeroSNDetDiscriminator",
            "VideoGlobalMaskSNDetDiscriminator",
            "VideoGlobalCoordSNDetDiscriminator",
            "VideoGlobalResSNDetDiscriminator",
            "VideoLocalPatchSNDetDiscriminator")
# the plain VAE: a VAEHRNet under InterNet (recipe 1's batch) and under
# ExtraNet (recipe 6's three forwards)
CFG_PV = dataclasses.replace(CFG, coarse_model="VAEHRNet", train_coarse=True,
                             input_h=128, input_w=128)
CFG_R6_PV = dataclasses.replace(CFG_R6, coarse_model="VAEHRNet")
PER_R6_PV_STEP = {k: 3 * v for k, v in PER_GAN_STEP.items()}
# under --fix_init_frames the VAEHRNet's stem takes 53 channels, padded to 64
PER_R6_PV_FIX_STEP = {**PER_R6_PV_STEP, "stem48_fwd": 0, "stem48_bwd": 0,
                      "stem64_fwd": 3, "stem64_bwd": 3}


def _gate(label, cfg, batch):
    """One step of ``cfg``'s kernel model and plain bf16 model against the
    plain f32 model (TF32 off): each submodel's gradient by GRAD_RATIO and
    GRAD_FLOOR, and the stem's four leaves (its 48-channel kernels); each
    loss term of the kernel model within LOSS_TOL of the plain bf16
    model's.  Returns the kernel model's loss terms."""
    _, g_ref, _ = _f32(lambda: _grads(dev_of(batch), cfg, False, "float32",
                                      batch))
    l_k, g_k, _ = _grads(dev_of(batch), cfg, True, "bfloat16", batch)
    l_p, g_p, _ = _grads(dev_of(batch), cfg, False, "bfloat16", batch)
    print(f"{label} step {tuple(batch['frame1'].shape[:3])}:")
    fails = []
    for sub in sorted({n.split(".")[0] for n in g_ref}):
        names = [n for n in g_ref if n.startswith(sub + ".")]
        cat = [torch.cat([g[n].flatten() for n in names])
               for g in (g_k, g_p, g_ref)]
        fails.append(_check_grad(f"{sub} gradient ({cat[2].numel()} "
                                 "values)", *cat))
    for n in ("conv1.weight", "conv1.bias", "conv2.weight", "conv2.bias"):
        n = f"coarse_model.{n}"
        fails.append(_check_grad(n, g_k[n], g_p[n], g_ref[n]))
    fails = [f for f in fails if f]
    if fails:
        raise AssertionError(f"{label}: " + "; ".join(fails))
    _losses_held(label, l_k, l_p)
    del g_ref, g_k, g_p
    torch.cuda.empty_cache()
    return l_k


def dev_of(batch):
    return batch["frame1"].device


def _timed_steps(label, card, cfg, batch, steps, per_step, terms=GAN_RECON,
                 falling=True):
    """``steps`` steps of the kernel model: the sum of ``terms`` finite and
    (``falling``) falling, samples/s (median after 2 warm-ups), peak
    memory, and the launches of one counted step against ``per_step``."""
    losses, times, counts, peak = _run(dev_of(batch), cfg, batch, steps,
                                       terms=terms)
    if not all(map(math.isfinite, losses)) or (
            falling and not losses[-1] < losses[0]):
        raise AssertionError(f"{label}: {'+'.join(terms)} {losses}")
    rate = batch["frame1"].shape[0] / statistics.median(times)
    print(f"{label} kernel model: {' + '.join(terms)} {losses[0]:.6g} -> "
          f"{losses[-1]:.6g} over {steps} steps; {rate:.4f} samples/s "
          f"(median of {len(times)} steps), peak memory {peak:.3f} GiB on "
          f"{card}; launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})}")
    _check_step_counts(label, counts, per_step)
    return counts


def track_obj_phase(dev, card):
    """Phase 28: recipe 4 with ``--track_obj_loss --track_obj_w 8 --n_track
    4`` at 18x128x128 bf16 (the frozen ResNet101 on 216 64x128 patches a
    step): the step's gradient gate and loss terms (``_gate``), then 20
    steps of the kernel model (the reconstruction terms falling, samples/s,
    peak memory, recipe 4's launches).  Returns the counted launches."""
    batch = gan_batch(dev, 4, n_track=4)
    l_k = _gate("recipe 4 --track_obj_loss", CFG_TOBJ, batch)
    if not l_k["coarse_track_obj_loss"] > 0:
        raise AssertionError(f"--track_obj_loss: {l_k}")
    return _timed_steps("recipe 4 --track_obj_loss", card, CFG_TOBJ,
                        gan_batch(dev, 5, n_track=4), 20, PER_GAN_STEP)


def track_gen_phase(dev, card):
    """Phase 29: recipe 4 with ``--track_gen`` and ``--track_gen_model``
    TrackGen and TrackGenV2 at 18x128x128 bf16, one step each under the
    gradient gate, ``coarse_loc_diff_loss`` finite (0 for TrackGen)."""
    batch = gan_batch(dev, 4)
    for name in ("TrackGen", "TrackGenV2"):
        cfg = dataclasses.replace(CFG_GAN, track_gen=True,
                                  track_gen_model=name)
        l_k = _gate(f"recipe 4 --track_gen {name}", cfg, batch)
        loc = l_k["coarse_loc_diff_loss"]
        if not math.isfinite(loc) or (name == "TrackGen") != (loc == 0):
            raise AssertionError(f"{name}: coarse_loc_diff_loss {loc}")


def det_disc_phase(dev, card):
    """Phase 30: each of the seven newer box discriminators as recipe 4's
    video det family at 18x128x128 bf16, 10 tracks: one family pass (the
    detached fake, the sync_neg pass, the real, the G pass on frozen
    weights, train mode), every logit finite, and the hinge losses'
    gradients finite in every weight and in the fake; the passes' time."""
    cfg = dataclasses.replace(CFG_GAN, compute_dtype="bfloat16")
    batch = gan_batch(dev, 4)
    x, seg, gt_x, gt_seg = inter.get_inter_inputs(batch)
    g = torch.Generator(dev).manual_seed(13)
    fake = (gt_x + 0.2 * torch.randn(gt_x.shape, generator=g, device=dev)
            ).clamp(-1, 1).to(torch.bfloat16).requires_grad_()
    soft = torch.softmax(torch.randn(gt_seg.shape, generator=g, device=dev),
                         -1)
    from deep_video_interpolation_extrapolation_tpu_torch.losses.gan import (
        gan_scalar_loss,
    )
    for name in DET_REST:
        disc = registry.init_weights(registry.build_disc(cfg, name), 0).to(dev)
        kw = {"gt_x": gt_x} if disc.wants_gt else {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d_fake = disc(fake.detach(), soft, x, seg, bboxes=batch["bboxes"],
                      train=True, **kw)
        d_sync = disc(gt_x, gt_seg, x, seg, bboxes=batch["bboxes"],
                      sync_neg=True, train=True, generator=g, **kw)
        d_real = disc(gt_x, gt_seg, x, seg, bboxes=batch["bboxes"],
                      train=True, **kw)
        g_fake = inter_gan.frozen_call(disc, fake, soft, x, seg,
                                       bboxes=batch["bboxes"], train=True,
                                       **kw)
        loss = (gan_scalar_loss(g_fake, True, 0.4)
                + gan_scalar_loss((d_fake + d_sync) / 2, False, 0.01)
                + gan_scalar_loss(d_real, True, 0.01))
        loss.backward()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        logits = torch.stack([d_fake, d_sync, d_real, g_fake]).float()
        grads = [p.grad for p in disc.parameters()]
        ok = (torch.isfinite(logits).all() and torch.isfinite(fake.grad).all()
              and all(gr is not None and torch.isfinite(gr).all()
                      for gr in grads))
        print(f"{name}: family pass {B18[0]}x{B18[1]}x{B18[2]}, 10 tracks: "
              f"logits {tuple(logits.shape)} in [{logits.min():.4g}, "
              f"{logits.max():.4g}], |d fake| {fake.grad.abs().max():.4g}, "
              f"{len(grads)} weight grads finite: {bool(ok)}; "
              f"{1e3 * dt:.2f} ms on {card}")
        if not ok:
            raise AssertionError(f"{name}: non-finite logits or grads")
        fake.grad = None
        del disc
    torch.cuda.empty_cache()


def plain_vae_phase(dev, card):
    """Phases 31-32: the plain VAE.  InterNet on a VAEHRNet served through
    the eval adapter (z from a seeded generator) as phase 15: kernel
    against plain model at 2x128x256, the 3-step 2x512x1024 rollout with
    the served VAEHRNet's launches; trained at 24x128x128 under the
    gradient gate, 8 steps (the reconstruction terms falling, samples/s,
    recipe 4's launches).  ExtraNet on a VAEHRNet: recipe 6's step at
    24x128x128 (three forwards, a KL term each) under the gradient gate, 8
    steps (samples/s, peak memory, three times recipe 4's launches); then
    under ``--fix_init_frames`` (the stem at 53 channels: the 64-channel
    stem kernels, held to their plain version in the train-kernel phase)
    the gate and 6 steps, finite.  Returns the counted launches."""
    def adapter(use_kernels):
        model = registry.build_model(CFG_PV, device=dev, seed=0,
                                     use_kernels=use_kernels)
        return inter_gan.GanEvalAdapter(
            model.coarse_model, torch.Generator(dev).manual_seed(5))
    slice_phase(dev, CFG_PV, "plain VAE InterNet slice",
                models=(adapter(True), adapter(False)))
    out = [serve_phase(dev, card, CFG_PV,
                       label="plain VAE InterNet serve rollout",
                       model=adapter(True))]
    recon = ("coarse_l1_loss", "coarse_gdl_loss", "coarse_ssim_loss")
    batch = train_batch(dev, *B24, seed=4)
    l_k = _gate("plain VAE InterNet", CFG_PV, batch)
    if "coarse_kld_loss" not in l_k:
        raise AssertionError(f"plain VAE InterNet: {list(l_k)}")
    out.append(_timed_steps("plain VAE InterNet", card, CFG_PV,
                            train_batch(dev, *B24, seed=5), 8, PER_GAN_STEP,
                            recon))
    l_k = _gate("plain VAE ExtraNet", CFG_R6_PV, r6_batch(dev, 4))
    if not all(f"step_{i}_coarse_kld_loss" in l_k for i in (1, 2, 3)):
        raise AssertionError(f"plain VAE ExtraNet: {list(l_k)}")
    l1 = tuple(f"step_{i}_frame_1_coarse_l1_loss" for i in (1, 2, 3))
    out.append(_timed_steps("plain VAE ExtraNet", card, CFG_R6_PV,
                            r6_batch(dev, 5), 8, PER_R6_PV_STEP, l1))
    # its seeded model's loss jumps by up to 1e3 after the first Adamax step
    # and wanders (251 -> 159260 -> 131 -> 266 over 6 steps on the card),
    # as the recipe-6 and --highres_large ones do: the gate holds it, the
    # steps are held finite only
    fix = dataclasses.replace(CFG_R6_PV, fix_init_frames=True)
    _gate("plain VAE ExtraNet --fix_init_frames", fix, r6_batch(dev, 4))
    out.append(_timed_steps("plain VAE ExtraNet --fix_init_frames", card, fix,
                            r6_batch(dev, 5), 6, PER_R6_PV_FIX_STEP, l1,
                            falling=False))
    return out


def track_obj_runner_phase(dev, card):
    """Phase 33: the track-object variant through the launcher on synthetic
    data: one epoch of 8 steps and its checkpoint, then ``--r --checkepoch
    1`` to a second epoch from it (losses finite, recipe 4's launches each
    step).  Returns the counted launches of each run."""
    tmp = tempfile.mkdtemp(prefix="dvie_tobj_runner_")
    runs = []
    args = (f"{GAN_GLOBAL} --track_obj_loss --track_obj_w 8 --n_track 4 "
            "--split train")
    try:
        exp_a = os.path.join(tmp, "a")
        os.makedirs(exp_a)
        get_logger(exp_a, "train")
        cfg = parse_args(f"{args} --epochs 1 {GAN_TRAIN}".split())
        _, counts = _counted("--track_obj_loss runner epoch 1", PER_GAN_STEP,
                             RUNNER_EPOCH_STEPS,
                             lambda: _quiet(lambda: run(cfg, exp_a)))
        runs.append(counts)
        names = sorted(os.listdir(os.path.join(exp_a, "checkpoint")))
        if names != ["InterGANNet_xs2xs_inter_24_1_0"]:
            raise AssertionError(f"--track_obj_loss runner: {names}")
        exp_b = os.path.join(tmp, "b")
        resume = parse_args(f"{args} --epochs 2 --r --checkepoch 1 "
                            f"--checksession 24 --load_dir {exp_a} "
                            f"{GAN_TRAIN}".split())
        _, counts = _counted("--track_obj_loss runner resumed epoch 2",
                             PER_GAN_STEP, RUNNER_EPOCH_STEPS,
                             lambda: _quiet(lambda: run(resume, exp_b)))
        runs.append(counts)
        for exp in (exp_a, exp_b):
            log = _log_of(exp)
            losses = [float(v) for _, _, v in LOSS_LINE.findall(log)]
            epochs = sorted({int(e) for e, _, _ in LOSS_LINE.findall(log)})
            if len(losses) != RUNNER_EPOCH_STEPS or not all(
                    map(math.isfinite, losses)):
                raise AssertionError(f"--track_obj_loss runner: {losses}")
            for e, n, wall, rate, load, comp in EPOCH_LINE.findall(log):
                print(f"--track_obj_loss runner epoch {e}: {n} samples in "
                      f"{wall} s, {rate} samples/s, load {load} s, comp "
                      f"{comp} s on {card}")
            print(f"--track_obj_loss runner epochs {epochs}: loss_all "
                  f"{losses[0]:.6g} -> {losses[-1]:.6g}")
        if epochs != [2]:
            raise AssertionError(f"--track_obj_loss resume ran {epochs}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


# ---- the vimeo and ucf101 triplet sets (phase 34) --------------------------

VIMEO_HW, UCF_HW = (256, 448), (240, 320)
TRIPLET_BS, TRIPLET_STEPS, VIMEO_VAL_BATCHES, UCF_CLIPS = 8, 8, 2, 8
# at 256x448 (W >= 256: the packed stem/layer1 route) branch 0 is 64 ch at
# 256x448, past bb_fits's 40 MiB budget (~200 MB at a batch tile of 1), so
# the xx2x train step runs the serving route's forward kernels (K1 18:
# stem conv2, trans_0 and the 16 branch-0 convs; K2 4; K3 2), K4's taps
# and, in its backward, K4's h mode, and the shift add; no train-chain
# kernel
PER_TRIPLET_STEP = {"conv3x3_bias_res_lrelu": 18, "bottleneck_tail": 4,
                    "fuse_out0": 2, "ups_head_taps": 1, "ups_head_1x1": 1,
                    "shifted_add_bias": 1}
# the names of those kernels' functions, which the DVIE_PROFILE_DIR trace
# must hold (K1, K2, the Triton K3, K4 in both modes, the shift add)
TRACE_KERNELS = ("conv3x3_kernel", "tail_kernel", "_fuse_out0",
                 "ups_head_kernel", "shifted_add_bias_kernel")
TRIPLET_SHAPES = ((1, 256, 448), (8, 256, 448), (8, 256, 256))


def triplet_kernel_check(dev):
    """The kernels of the triplet paths against their plain versions at
    the shapes those paths give them, B=1 and 8 at 256x448 (vimeo: the 1/2
    and 1/4 maps 128x224 and 64x112, K1's 16-wide tiles across 28 of them)
    and 8x256x256 (ucf101), by max|d|/max|ref| <= KERNEL_TOL, each output
    from NaN-filled memory: K1 at its three sites, K2 in its three block
    forms, K3 for stages 2 and 3, K4's taps and h modes; the shift add bit
    for bit."""
    g = torch.Generator(device=dev).manual_seed(34)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def w(*shape):
        fan_in = shape[1] * shape[2] * shape[3]
        return torch.randn(shape, generator=g, device=dev) / fan_in ** 0.5

    lrelu = torch.nn.functional.leaky_relu
    w64, w256, bias = w(64, 64, 3, 3), w(64, 256, 3, 3), w(64, 1, 1, 1).flatten()
    w2, w3 = w(64, 64, 3, 3), w(256, 64, 1, 1)
    wres, w1n = w(256, 64, 1, 1), w(64, 256, 1, 1)
    w1 = w(896, 448, 1, 1)[:, :, 0, 0].t()
    b1 = w(896, 1, 1, 1).flatten()
    w2t = k4.build_dual_tap_kernel(w(3, 448, 3, 3), w(20, 448, 3, 3),
                                   torch.bfloat16)
    for b, h, wd in TRIPLET_SHAPES:
        x64, x256, res = rnd(b, h, wd, 64), rnd(b, h, wd, 256), \
            rnd(b, h, wd, 64)
        h1 = lrelu(rnd(b, h, wd, 64), 0.2)
        t1, t2 = rnd(b, h // 2, wd // 2, 64), rnd(b, h // 4, wd // 4, 64)
        p1, p2 = rnd(b, h // 2, wd // 2, 128), rnd(b, h // 4, wd // 4, 256)
        cases = (
            ("conv3x3_bias_res_lrelu", k1.conv3x3_bias_res_lrelu,
             k1.conv3x3_bias_res_lrelu_plain,
             {"stem conv2": (x64, w64, bias, None, True),
              "trans_0": (x256, w256, None, None, True),
              "basicblock conv2": (x64, w64, None, res, True)}),
            ("bottleneck_tail", k2.bottleneck_tail, k2.bottleneck_tail_plain,
             {"block 0": (h1, x64, w2, w3, wres, w1n),
              "block 1": (h1, x256, w2, w3, None, w1n),
              "block 3": (h1, x256, w2, w3, None, None)}),
            ("fuse_out0", k3.fuse_out0, k3.fuse_out0_plain,
             {"stage2": (x64, t1, None), "stage3": (x64, t1, t2)}),
            ("ups_head_taps", k4.ups_head_taps, k4.ups_head_taps_plain,
             {"heads": (x64, p1, p2, w1, b1, w2t)}),
            ("ups_head_1x1", k4.ups_head_1x1, k4.ups_head_1x1_plain,
             {"h": (x64, p1, p2, w1, b1)}))
        for name, kern, plain, variants in cases:
            for label, args in variants.items():
                out, ref = poisoned(kern, args), plain(*args)
                torch.cuda.synchronize()
                outs = out if isinstance(out, tuple) else (out,)
                refs = ref if isinstance(ref, tuple) else (ref,)
                for o, r in zip(outs, refs):
                    if (o is None) != (r is None):
                        raise AssertionError(f"{name} [{label}]: outputs")
                    if o is not None:
                        _held(name, f"{label}, {b}x{h}x{wd}", o, r)
                del out, ref, outs, refs
        del x64, x256, res, h1, t1, t2, p1, p2
        torch.cuda.empty_cache()
    shifted_add_check(dev, 23, [(None, f"{b}x{h}x{wd}", (b, h, wd))
                                for b, h, wd in TRIPLET_SHAPES])


def _moving_frames(g, dev, n, h, w, shift=3):
    """``n`` uint8 (h, w, 3) frames of one smooth seeded scene moving
    ``shift`` px to the left a frame."""
    base = torch.rand((1, 3, h // 16 + 1, (w + n * shift) // 16 + 1),
                      generator=g, device=dev)
    big = torch.nn.functional.interpolate(base, size=(h, w + n * shift),
                                          mode="bilinear", align_corners=True)
    big = (big * 255).round().to(torch.uint8)[0].permute(1, 2, 0).cpu()
    return [big[:, i * shift:i * shift + w].numpy() for i in range(n)]


def _write_triplet_trees(root, dev):
    """A vimeo tree (``TRIPLET_BS * TRIPLET_STEPS`` train and
    ``TRIPLET_BS * VIMEO_VAL_BATCHES`` test triplets of 448x256 frames,
    ``sequences/<dir>/im1..3.png`` and the two lists) and a ucf101 tree
    (``UCF_CLIPS`` clips of 320x240 frames) whose clip pickle
    ``tools/build_clips.create_root_clip`` writes (3-frame clips of
    ``<scene>_<video>_<frame>_frame.png``; each row then names its files),
    all PNGs by the port's encoder.  Returns (vimeo root, ucf101 img_dir)."""
    g = torch.Generator(device=dev).manual_seed(34)
    vimeo = os.path.join(root, "vimeo_triplet")
    lists = {"tri_trainlist.txt": TRIPLET_BS * TRIPLET_STEPS,
             "tri_testlist.txt": TRIPLET_BS * VIMEO_VAL_BATCHES}
    k = 0
    for name, n in lists.items():
        rows = []
        for _ in range(n):
            row = f"{k // 7 + 1:05d}/{k % 7 + 1:04d}"
            d = os.path.join(vimeo, "sequences", row)
            os.makedirs(d)
            for i, f in enumerate(_moving_frames(g, dev, 3, *VIMEO_HW)):
                png.save_png(os.path.join(d, f"im{i + 1}.png"), f)
            rows.append(row)
            k += 1
        with open(os.path.join(vimeo, name), "w") as f:
            f.write("\n".join(rows) + "\n")
    ucf = os.path.join(root, "ucf101", "ucf101_interp_ours")
    scene = os.path.join(ucf, "test", "ucf")
    os.makedirs(scene)
    for c in range(UCF_CLIPS):
        for i, f in enumerate(_moving_frames(g, dev, 3, *UCF_HW)):
            png.save_png(os.path.join(scene, f"ucf_{c:06d}_{i:06d}_frame.png"),
                         f)
    pkl = os.path.join(root, "ucf101", "UCF101_test_root_clip.pkl")
    clips = build_clips.create_root_clip(ucf, pkl, tail="frame", clip_len=3,
                                         scene_dict={"test": ["ucf"]})
    rows = [[p + "_frame.png" for p in clip] for clip in clips["test"]]
    if len(rows) != UCF_CLIPS:
        raise AssertionError(f"ucf101 tree: {len(rows)} clips")
    with open(pkl, "wb") as f:
        pickle.dump({"test": rows}, f)
    return vimeo, ucf


def _decode_times(frame):
    """Host ms to decode one whole frame (a 448x256 RGB array) written by
    Pillow (its adaptive row filters, as real trees have), by the fused
    path, the zlib + numpy decoder (``DVIE_NATIVE_LOADER=0``) and Pillow:
    the median of 5 decodes each, after one."""
    import io

    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="PNG")
    data = buf.getvalue()
    h, w = frame.shape[:2]
    old = os.environ.get("DVIE_NATIVE_LOADER")

    def fused():
        return host.decode_rgb_norm(data, 0, 0, h, w, False)

    def numpy_path():
        os.environ["DVIE_NATIVE_LOADER"] = "0"
        try:
            return host.decode_rgb_norm(data, 0, 0, h, w, False)
        finally:
            if old is None:
                os.environ.pop("DVIE_NATIVE_LOADER")
            else:
                os.environ["DVIE_NATIVE_LOADER"] = old

    def pillow():
        return host.NORM[png.decode_u8(data, 3, use_pil=True)]
    ms = {}
    for name, fn in (("fused", fused), ("numpy", numpy_path),
                     ("Pillow", pillow)):
        out = fn()
        if not torch.equal(torch.from_numpy(out), torch.from_numpy(fused())):
            raise AssertionError(f"decode {name}: differs from the fused path")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        ms[name] = statistics.median(times)
    return ms


def _trace_kernels(trace_dir):
    """The one Chrome trace under ``trace_dir``: (its device events' names,
    their summed device time in ms)."""
    names = os.listdir(trace_dir)
    if len(names) != 1 or not names[0].endswith(".json"):
        raise AssertionError(f"DVIE_PROFILE_DIR: {names}")
    with open(os.path.join(trace_dir, names[0])) as f:
        events = json.load(f)["traceEvents"]
    dev_events = [e for e in events if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]
    return ({e["name"] for e in dev_events if e["cat"] == "kernel"},
            sum(float(e.get("dur", 0)) for e in dev_events) / 1e3)


def triplet_phase(dev, card):
    """Phase 34: the vimeo and ucf101 triplet sets (``--mode xx2x``) through
    the launcher at 256x448 and 256x256, InterNet/HRNet at its published
    widths, bf16; first the triplet paths' kernels against their plain
    versions (``triplet_kernel_check``) and one frame's host decode time
    by the three PNG decoders.  Trains two vimeo epochs of 8 steps at
    batch 8 with ``DVIE_PROFILE_DIR`` set (the counted launches, each
    epoch's image-grid forward where a writer exists; every frame decoded
    by the fused PNG path; finite losses; one trace, of the first epoch's
    steps 2-6, holding the port's kernels, its device time a step),
    prints each epoch's samples/s, load and comp seconds and the peak
    memory; then validates vimeo from the epoch-2 checkpoint and sweeps
    ucf101 over it (``--checkepoch_range``): the serving launches, PSNR
    and SSIM.  Returns the counted launches of each run."""
    triplet_kernel_check(dev)
    tmp = tempfile.mkdtemp(prefix="dvie_triplet_")
    old_trace = os.environ.get("DVIE_PROFILE_DIR")
    runs = []
    try:
        t0 = time.perf_counter()
        vimeo, ucf = _write_triplet_trees(tmp, dev)
        print(f"triplet trees: {TRIPLET_BS * (TRIPLET_STEPS + VIMEO_VAL_BATCHES)}"
              f" vimeo triplets, {UCF_CLIPS} ucf101 clips written in "
              f"{time.perf_counter() - t0:.3f} s")
        ms = _decode_times(_moving_frames(
            torch.Generator(device=dev).manual_seed(35), dev, 1,
            *VIMEO_HW)[0])
        print("triplet decode of one 448x256 frame (Pillow-written), host "
              "ms on the card's machine: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in ms.items()))
        trace_dir = os.path.join(tmp, "trace")
        os.environ["DVIE_PROFILE_DIR"] = trace_dir
        common = (f"--mode xx2x --syn_type inter --bs {TRIPLET_BS} "
                  "--disp_interval 1 --nw 4")
        train = parse_args(
            f"--dataset vimeo --img_dir {vimeo} {common} --split train "
            f"--input_h {VIMEO_HW[0]} --input_w {VIMEO_HW[1]} --epochs 2 "
            "INTER --model InterNet --train_coarse".split())
        exp = os.path.join(tmp, "exp")
        host.reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        hw.reset_counters()
        _quiet(lambda: run(train, exp))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        os.environ.pop("DVIE_PROFILE_DIR")
        counts = dict(hw.launches)
        runs.append(counts)
        # with a TensorBoard writer, each epoch's step 0 also logs the image
        # grid: one eval forward an epoch
        grids = 2 * int(os.path.isdir(os.path.join(
            exp, "train_int_1_len_1_vimeo_logs")))
        print(f"triplet vimeo train launches (2 epochs, {grids} image grid "
              f"forwards): {json.dumps({k: v for k, v in counts.items() if v})}")
        for name in hw.KERNELS:
            want = (2 * TRIPLET_STEPS * PER_TRIPLET_STEP.get(name, 0)
                    + grids * PER_FORWARD.get(name, 0))
            if counts[name] != want:
                raise AssertionError(f"triplet vimeo train: {name} launched "
                                     f"{counts[name]} times, expected {want}")
        frames = 2 * TRIPLET_STEPS * TRIPLET_BS * 3
        if host.counts != {"fused": frames, "numpy": 0, "other": 0}:
            raise AssertionError(f"triplet vimeo train: decoded {host.counts}"
                                 f", expected {frames} fused")
        log = _log_of(exp)
        losses = [float(v) for _, _, v in LOSS_LINE.findall(log)]
        if len(losses) != 2 * TRIPLET_STEPS or not all(map(math.isfinite,
                                                           losses)):
            raise AssertionError(f"triplet vimeo train: losses {losses}")
        names, device_ms = _trace_kernels(trace_dir)
        missing = [k for k in TRACE_KERNELS
                   if not any(k in n for n in names)]
        if missing or "trace of steps 2-6 written" not in log:
            raise AssertionError(f"triplet trace: {missing} not among "
                                 f"{sorted(names)}")
        print(f"triplet trace: {len(names)} kernel names, the port's "
              f"{', '.join(TRACE_KERNELS)} among them; device time "
              f"{device_ms / 5:.3f} ms a step (steps 2-6, under the "
              f"profiler) on {card}")
        for e, n, wall, rate, load, comp in EPOCH_LINE.findall(log):
            print(f"triplet vimeo train 8x256x448 epoch {e}"
                  f"{' (traced, warm-up)' if e == '1' else ''}: {n} samples"
                  f" in {wall} s, {rate} samples/s, load {load} s, comp "
                  f"{comp} s on {card}")
        print(f"triplet vimeo train: peak {peak:.3f} GiB, {frames} frames on"
              f" the fused PNG path, loss_all {losses[0]:.6g} -> "
              f"{losses[-1]:.6g}")

        load = f"--load_dir {exp} --checksession 0"
        vval = parse_args(
            f"--dataset vimeo --img_dir {vimeo} {common} --split val "
            f"--checkepoch 2 {load} INTER --model InterNet "
            "--load_coarse".split())
        metrics, counts = _counted(
            "triplet vimeo val", PER_FORWARD, VIMEO_VAL_BATCHES,
            lambda: _quiet(lambda: run(vval, os.path.join(tmp, "vval"))))
        runs.append(counts)
        uval = parse_args(
            f"--dataset ucf101 --img_dir {ucf} {common} --split val "
            f"{load} --checkepoch_range --checkepoch_low 2 --checkepoch_up 2 "
            "INTER --model InterNet".split())
        swept, counts = _counted(
            "triplet ucf101 val sweep", PER_FORWARD, 1,
            lambda: _quiet(lambda: run(uval, os.path.join(tmp, "uval"))))
        runs.append(counts)
        for label, m in (("vimeo 8x256x448", metrics),
                         ("ucf101 8x256x256", swept[2])):
            if "coarse_iou" in m or not all(map(math.isfinite, m.values())):
                raise AssertionError(f"triplet val {label}: {m}")
            print(f"triplet val {label}: PSNR {m['coarse_psnr']:.4f}, SSIM "
                  f"{m['coarse_ssim']:.4f}, L1 {m['coarse_l1']:.5f}")
    finally:
        if old_trace is None:
            os.environ.pop("DVIE_PROFILE_DIR", None)
        else:
            os.environ["DVIE_PROFILE_DIR"] = old_trace
        shutil.rmtree(tmp, ignore_errors=True)
    return runs

# ---- the legacy trainers (train/legacy.py) ----------------------------------

# row 18c: the flow entry's backward at the VAE step's two warps: its
# forward warp of frame1 (8 frames, T = 2) and the consistency warps of the
# ground truth (B * T = 16 frames at T = 1), both with a mask
BWD_CASES = (("grid_sample_bwd", "VAE warp, 8x128x128 T=2, mask", (8, 2)),
             ("grid_sample_bwd_b16", "consistency warps, 16x128x128 T=1, "
              "mask", (16, 1)))
BWD_L2_TOL = 1e-2          # dflow and dmask rel-L2, kernel vs plain
# one VAE train step: the model's warp and the consistency warps, each
# forward and backward once
PER_VAE_STEP = {"grid_sample": 2, "grid_sample_bwd": 2}
VAE_TRAIN_B, VAE_TRAIN_STEPS = 8, 20
VAE_RECON = ("recon_warp_loss", "recon_refine_loss")
# the legacy steps at the INTER recipe's shape (docs/RECIPES.md:11-14)
LEGACY_SHAPE, LEGACY_STEPS = (24, 128, 128), 6
CFG_LEGACY = Config(syn_type="inter", mode="xs2xs", coarse_model="HRNet",
                    refine_model="refineUnet", n_scales=1, input_h=128,
                    input_w=128, compute_dtype="bfloat16")


def _bwd_case(dev, g, b, t, h=128, w=128, c=3, flow_dtype=torch.float32):
    """x (B,H,W,C) and dout (B,T,H,W,C) f32; a mask in [0.5, 1] and a flow
    whose masked displacement is an integer of up to 10 px plus a fraction
    in [0.15, 0.85] (the bilinear derivative jumps where a coordinate is an
    integer), both in ``flow_dtype``."""
    x = torch.randn((b, h, w, c), generator=g, device=dev)
    px = (torch.randint(-10, 11, (b, t, h, w, 2), generator=g, device=dev)
          + 0.15 + 0.7 * torch.rand((b, t, h, w, 2), generator=g,
                                    device=dev))
    mask = 0.5 + 0.5 * torch.rand((b, t, h, w, 1), generator=g, device=dev)
    flow = px * torch.tensor([2.0 / (w - 1), 2.0 / (h - 1)], device=dev) / mask
    dout = torch.randn((b, t, h, w, c), generator=g, device=dev)
    return x, flow.to(flow_dtype), mask.to(flow_dtype), dout


def _plain_bwd(x, flow, mask, dout):
    """The plain version's backward alone: autograd of
    ``warp_steps_plain``, its graph built once."""
    fl, mk = flow.detach().requires_grad_(), mask.detach().requires_grad_()
    out = warp.warp_steps_plain(x, fl, mk)
    return lambda: torch.autograd.grad(out, (fl, mk), dout,
                                       retain_graph=True)


def grid_sample_bwd_check(dev):
    """Row 18c, the grid sample's flow-entry backward (``dvie_warp_steps_bwd``)
    against autograd of ``warp_steps_plain`` at the VAE step's two warps,
    on flows away from integer coordinates: in f32, and in the step's own
    types (x and dout f32, flow and mask bf16), dflow and dmask each within
    BWD_L2_TOL rel-L2; then through ``warp_steps`` with a gradient (the
    autograd wiring).  Each row timed at the step's types: the kernel host
    issue included and on the card alone, the plain backward, and
    ``aten.grid_sampler_2d_backward`` (the grid's gradient, f32, NCHW, on
    the same grid)."""
    g = torch.Generator(device=dev).manual_seed(19)
    rows = {}
    for row, label, (b, t) in BWD_CASES:
        h = w = 128
        for ftype in (torch.float32, torch.bfloat16):
            args = _bwd_case(dev, g, b, t, flow_dtype=ftype)
            kernel = lambda: warp._steps_bwd_kernel(*args)
            out, ref = kernel(), _plain_bwd(*args)()
            torch.cuda.synchronize()
            errs = [rel_l2(o, r) for o, r in zip(out, ref)]
            d = max((o.float() - r.float()).abs().max().item()
                    for o, r in zip(out, ref))
            print(f"  grid_sample_bwd [{label}, flow {ftype}]: dflow rel-L2 "
                  f"{errs[0]:.3g}, dmask rel-L2 {errs[1]:.3g} (bound "
                  f"{BWD_L2_TOL}), max|d| {d:.4g}")
            if not all(torch.isfinite(o.float()).all() for o in out) or \
                    max(errs) > BWD_L2_TOL:
                raise AssertionError(f"grid_sample_bwd [{label}, {ftype}]: "
                                     f"rel-L2 {errs}")
        x, flow, mask, dout = args
        fl, mk = flow.clone().requires_grad_(), mask.clone().requires_grad_()
        torch.autograd.backward(warp.warp_steps(x, fl, mk), dout)
        torch.cuda.synchronize()
        if not (torch.equal(fl.grad, out[0]) and torch.equal(mk.grad, out[1])):
            raise AssertionError(f"grid_sample_bwd [{label}]: warp_steps' "
                                 "gradient is not the kernel's")
        bt = b * t
        base = warp.make_base_grid(h, w, device=dev)[None, None]
        grid = (base - (flow * mask).float()).reshape(bt, h, w, 2)
        x_bt = nchw(x[:, None].expand(b, t, h, w, 3).reshape(bt, h, w, 3))
        d_bt = nchw(dout.reshape(bt, h, w, 3))
        x_bt, d_bt = x_bt.contiguous(), d_bt.contiguous()
        lib = lambda: torch.ops.aten.grid_sampler_2d_backward(
            d_bt, x_bt, grid, 0, 0, True, [False, True])
        ms, device = _both_ways({"": kernel, "plain_": _plain_bwd(*args),
                                 "library_": lib})
        rows[row] = timed("grid_sample_bwd", label + ", x f32, flow bf16",
                          args, out, d, *ms, device)
    return rows


def vae_train_batch(dev, b, seed):
    """A seeded VAE batch: T+1 smooth frames in [0, 1] (bilinear
    upsamplings of 8x8 fields: random pixels leave the warp nothing to
    learn), uint8 seg ids, complementary fg / bg masks."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h, w, t1 = CFG_VAE.input_h, CFG_VAE.input_w, VAE_T + 1
    coarse = torch.rand((b * t1, 3, 8, 8), generator=g, device=dev)
    frames = nhwc(torch.nn.functional.interpolate(
        coarse, size=(h, w), mode="bilinear", align_corners=False))
    fg = (torch.rand((b, t1, h, w, 1), generator=g, device=dev) > 0.5).float()
    return {"frames": frames.reshape(b, t1, h, w, 3),
            "segs": torch.randint(0, 20, (b, t1, h, w), generator=g,
                                  device=dev, dtype=torch.uint8),
            "fg_masks": fg, "bg_masks": 1.0 - fg}


def _vae_setup(dev, use_kernels, dtype="bfloat16"):
    cfg = dataclasses.replace(CFG_VAE, compute_dtype=dtype)
    model = registry.build_model(cfg, device=dev, seed=0,
                                 use_kernels=use_kernels)
    state = state_lib.create_train_state(
        cfg, model, init_vgg_frozen(cfg, seed=1, device=dev))
    return legacy.make_vae_train_step(cfg, model), state


def _vae_grads(dev, use_kernels, dtype, batch, eps):
    step, state = _vae_setup(dev, use_kernels, dtype)
    _, ld = step(state, batch, eps=eps)
    out = ({k: float(v) for k, v in ld.items()},
           torch.cat([p.grad.float().flatten()
                      for p in state.model.parameters()]))
    del step, state
    torch.cuda.empty_cache()
    return out


def _vae_run(dev, use_kernels, batch, eps):
    """VAE_TRAIN_STEPS steps on one batch and eps: the reconstruction terms
    of each, the step times after 2 warm-ups, the launches of step 2, the
    peak memory (GiB)."""
    step, state = _vae_setup(dev, use_kernels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, counts = [], [], None
    for i in range(VAE_TRAIN_STEPS):
        torch.cuda.synchronize()
        if i == 2:
            hw.reset_counters()
        t0 = time.perf_counter()
        state, ld = step(state, batch, eps=eps)
        torch.cuda.synchronize()
        if i >= 2:
            times.append(time.perf_counter() - t0)
        if i == 2:
            counts = dict(hw.launches)
        losses.append(sum(float(ld[k]) for k in VAE_RECON))
    peak = torch.cuda.max_memory_allocated() / 2**30
    del step, state
    torch.cuda.empty_cache()
    return losses, times, counts, peak


def vae_train_phase(dev, card):
    """The VideoVAE train step (``--model VAE``, 76.4 M parameters, T = 2)
    at 8x128x128, bf16 with f32 masters, the frozen VGG19 from seed 1, one
    eps for every model and step: the one-step gradient of the kernel model
    and of the plain bf16 model against the plain f32 model (TF32 off), by
    GRAD_RATIO and GRAD_FLOOR; each loss term within LOSS_TOL of the plain
    bf16 model's; 20 steps per model whose reconstruction terms fall and
    end within TRAJ_TOL of the plain model's; the launches of one counted
    step (grid sample 2, its backward 2, every other kernel 0), samples/s
    (median of the synchronized steps after 2 warm-ups) and peak memory.
    Returns the counted launches."""
    b = VAE_TRAIN_B
    h, w = CFG_VAE.input_h, CFG_VAE.input_w
    batch = vae_train_batch(dev, b, 21)
    eps = torch.randn((b, 1024), generator=torch.Generator(
        device=dev).manual_seed(22), device=dev)
    _, g_ref = _f32(lambda: _vae_grads(dev, False, "float32", batch, eps))
    l_k, g_k = _vae_grads(dev, True, "bfloat16", batch, eps)
    l_p, g_p = _vae_grads(dev, False, "bfloat16", batch, eps)
    label = f"vae train {b}x{h}x{w} T={VAE_T}"
    print(f"{label} step:")
    fail = _check_grad(f"VideoVAE gradient ({g_ref.numel()} values)", g_k,
                       g_p, g_ref)
    if fail:
        raise AssertionError(f"{label}: {fail}")
    _losses_held(label, l_k, l_p)
    del g_ref, g_k, g_p
    runs = {}
    for name, use_kernels in (("kernel", True), ("plain", False)):
        losses, times, counts, peak = _vae_run(dev, use_kernels, batch, eps)
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"{label} {name}: the reconstruction terms "
                                 f"did not fall: {losses}")
        rate = b / statistics.median(times)
        print(f"{label} {name} model: recon terms {losses[0]:.6g} -> "
              f"{losses[-1]:.6g} over {len(losses)} steps; {rate:.4f} "
              f"samples/s (median of {len(times)} steps), peak memory "
              f"{peak:.3f} GiB on {card}")
        runs[name] = (losses[-1], counts)
    gap = abs(runs["kernel"][0] - runs["plain"][0]) / abs(runs["plain"][0])
    print(f"{label}: final recon terms kernel {runs['kernel'][0]:.6g} plain "
          f"{runs['plain'][0]:.6g} (rel {gap:.4g}, bound {TRAJ_TOL})")
    if gap > TRAJ_TOL:
        raise AssertionError(f"{label}: final recon terms differ by {gap:.4g}")
    counts = runs["kernel"][1]
    print(f"{label} step launches: "
          f"{json.dumps({k: v for k, v in counts.items() if v})}")
    _check_step_counts(label, counts, PER_VAE_STEP)
    _check_step_counts(f"{label} plain", runs["plain"][1], {})
    return counts


# (label, config, step factory, launches a step, trained submodels)
LEGACY_CASES = (
    ("simple MyFRRN", dataclasses.replace(CFG_LEGACY, model="MyFRRN"),
     legacy.make_simple_train_step, {}, ()),
    ("GAN multi_scale_img_seg num_d=2",
     dataclasses.replace(CFG_LEGACY, model="GAN"),
     legacy.make_gan_train_step, {}, ()),
    ("Refiner, frozen coarse",
     dataclasses.replace(CFG_LEGACY, model="RefineNet", train_refine=True),
     legacy.make_refiner_train_step, PER_VAL_FORWARD, ("refine_model",)),
    ("Refiner --train_coarse",
     dataclasses.replace(CFG_LEGACY, model="RefineNet", train_refine=True,
                         train_coarse=True),
     legacy.make_refiner_train_step, PER_TRAIN_STEP,
     ("coarse_model", "refine_model")),
    ("RefinerGAN, frozen coarse",
     dataclasses.replace(CFG_LEGACY, model="RefineGAN"),
     legacy.make_refiner_gan_train_step, PER_VAL_FORWARD,
     ("refine_model", "discriminator")),
    ("RefinerGAN --train_coarse",
     dataclasses.replace(CFG_LEGACY, model="RefineGAN", train_coarse=True),
     legacy.make_refiner_gan_train_step, PER_TRAIN_STEP,
     ("coarse_model", "refine_model", "discriminator")),
)


def _legacy_setup(dev, cfg, make, use_kernels, dtype="bfloat16"):
    cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    model = registry.build_model(cfg, device=dev, seed=0,
                                 use_kernels=use_kernels)
    if cfg.model == "GAN":
        legacy.init_gan_variables(model, seed=3)
    state = state_lib.create_train_state(
        cfg, model, init_vgg_frozen(cfg, seed=1, device=dev))
    return make(cfg, model), state


def _legacy_grads(dev, cfg, make, use_kernels, dtype, batch, subs):
    step, state = _legacy_setup(dev, cfg, make, use_kernels, dtype)
    step(state, batch)
    grads = {sub: torch.cat([p.grad.float().flatten() for p in
                             getattr(state.model, sub).parameters()])
             for sub in subs}
    del step, state
    torch.cuda.empty_cache()
    return grads


def legacy_steps_phase(dev, card):
    """The legacy steps at 24x128x128 bf16 (f32 masters, the frozen VGG19):
    ``make_simple_train_step`` on MyFRRN, ``make_gan_train_step`` on
    ``GAN(net_d="multi_scale_img_seg", num_d=2)`` (its DCGAN init), and
    ``make_refiner_train_step`` / ``make_refiner_gan_train_step`` on HRNet
    + refineUnet with the coarse frozen and with ``--train_coarse``.  Where
    a step runs kernels (the HRNet coarse), each trained submodel's
    one-step gradient, kernel model and plain bf16 model against the plain
    f32 model (TF32 off), by GRAD_RATIO and GRAD_FLOOR.  Then LEGACY_STEPS
    steps of the kernel model: finite losses (the simple step's falling),
    the launches of one counted step (the frozen coarse's forward kernels,
    as recipes 2-3; under --train_coarse recipe 1's train step; none for
    MyFRRN and GAN), samples/s (median after 2 warm-ups) and peak memory.
    Returns the counted launches of each."""
    b, h, w = LEGACY_SHAPE
    batch = train_batch(dev, b, h, w, seed=23)
    runs = []
    for label, cfg, make, per_step, subs in LEGACY_CASES:
        label = f"legacy {label} {b}x{h}x{w}"
        if subs:
            g_ref = _f32(lambda: _legacy_grads(dev, cfg, make, False,
                                               "float32", batch, subs))
            g_k = _legacy_grads(dev, cfg, make, True, "bfloat16", batch, subs)
            g_p = _legacy_grads(dev, cfg, make, False, "bfloat16", batch,
                                subs)
            print(f"{label} step:")
            fails = [_check_grad(f"{sub} gradient ({g_ref[sub].numel()} "
                                 "values)", g_k[sub], g_p[sub], g_ref[sub])
                     for sub in subs]
            fails = [f for f in fails if f]
            if fails:
                raise AssertionError(f"{label}: " + "; ".join(fails))
            del g_ref, g_k, g_p
        step, state = _legacy_setup(dev, cfg, make, True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times, counts = [], [], None
        for i in range(LEGACY_STEPS):
            torch.cuda.synchronize()
            if i == 2:
                hw.reset_counters()
            t0 = time.perf_counter()
            state, ld = step(state, batch)
            torch.cuda.synchronize()
            if i >= 2:
                times.append(time.perf_counter() - t0)
            if i == 2:
                counts = dict(hw.launches)
            if not all(math.isfinite(float(v)) for v in ld.values()):
                raise AssertionError(f"{label}: non-finite losses {dict(ld)}")
            losses.append(float(ld["loss_all"]))
        peak = torch.cuda.max_memory_allocated() / 2**30
        del step, state
        torch.cuda.empty_cache()
        if cfg.model == "MyFRRN" and not losses[-1] < losses[0]:
            raise AssertionError(f"{label}: loss_all did not fall: {losses}")
        print(f"{label}: loss_all {' '.join(f'{v:.5g}' for v in losses)}; "
              f"{b / statistics.median(times):.4f} samples/s (median of "
              f"{len(times)} steps), peak memory {peak:.3f} GiB on {card}; "
              f"launches {json.dumps({k: v for k, v in counts.items() if v})}")
        _check_step_counts(label, counts, per_step)
        runs.append(counts)
    return runs


# ---- export and data parallelism (phases 35-36) -----------------------------

# the dvie:: op of each served kernel (ops/library.py), as a graph names it
DVIE_OPS = {f"dvie.{op}.default" for op in (
    "conv3x3", "bottleneck_tail", "fuse_out0", "ups_head_taps",
    "ups_head_1x1", "ups_head_taps4", "shifted_add_bias", "window_attention")}
# ExtraNet --num_pred_once 2 served: its heads (40 wide) through K4's h mode,
# the two 3x3s as F.conv2d, no taps and no shifted add
CFG_X2 = dataclasses.replace(CFG_X, num_pred_once=2)
PER_FORWARD_X2 = {**PER_FORWARD, "ups_head_taps": 0, "ups_head_1x1": 1,
                  "shifted_add_bias": 0}
EXPORT_SLICES = (("--highres_large", CFG_HL, PER_FORWARD_HL),
                 ("ExtraInpaintNet --inpaint_mask", CFG_XI, PER_FORWARD_XI),
                 ("InterStage3Net V1 --n_sc 1", CFG_S3, PER_FORWARD_S3),
                 ("ExtraNet --num_pred_once 2", CFG_X2, PER_FORWARD_X2))


def _graph_ops(served) -> set:
    """The dvie:: ops a loaded program's graphs call."""
    return {str(n.target) for m in served.modules()
            if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes
            if str(n.target).startswith("dvie.")}


def host_issue_ms(fn, reps=5):
    """The host's time to issue ``fn``'s work, ms (median of ``reps``):
    each call made behind a ~200 ms spin of the card, so that none of its
    launches waits on the card and the clock reads the host alone."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SPIN_CYCLES * 20)
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    return statistics.median(times)


def _same_or_why(label, out, ref) -> None:
    """Prints whether an artifact's output equals the live model's bit for
    bit, or by how much it differs."""
    pairs = list(zip(out, ref))
    if all(torch.equal(o, r) for o, r in pairs):
        print(f"{label}: equal to the live kernel model, bit for bit")
        return
    print(f"{label}: differs from the live kernel model: " + ", ".join(
        f"max|d| {(o.float() - r.float()).abs().max().item():.6g}"
        for o, r in pairs))


def _served_gate(label, rgb, seg_ids, ref_rgb, ref_seg, seg=True):
    """The served gates: rgb max|d| <= 5e-2 * max(1, max|ref|), seg argmax
    agreement >= 98% (printed only, without ``seg``)."""
    d = (rgb.float() - ref_rgb.float()).abs().max().item()
    limit = SLICE_RGB_TOL * max(1.0, ref_rgb.float().abs().max().item())
    agree = (seg_ids.long() == ref_seg.argmax(-1)).float().mean().item()
    print(f"{label}: rgb max|d|={d:.6g} (bound {limit:.4g}), seg argmax "
          f"agreement {agree:.6f} "
          f"({f'bound {SLICE_SEG_AGREE}' if seg else 'not gated'})")
    if not torch.isfinite(rgb.float()).all() or d > limit \
            or (seg and agree < SLICE_SEG_AGREE):
        raise AssertionError(f"{label}: outside the served gates")


def export_phase(dev, card, size=(2, 512, 1024), small=(2, 128, 256)):
    """Phase 35: serving export (``tools/export.py``).  InterNet's 3-step
    rollout at 2x512x1024 bf16 exported with the kernels as dvie:: ops,
    saved, loaded (``load_exported``) and run: the launches per forward,
    against the live kernel rollout on the same inputs (equal, or by how
    much not), each step against the plain model on the window the
    artifact carried (the served rgb gate at every step, the seg gate at
    the first), ms a forward exported against eager.  Then ``--highres_large``, ExtraInpaintNet ``--inpaint_mask``,
    InterStage3Net V1 ``--n_sc 1`` and ExtraNet ``--num_pred_once 2`` at
    2x128x256, exported once each: launches, against the live kernel model
    (equal, or within the served gates), so that every dvie:: op runs from
    an artifact.  Returns the counted launches."""
    tmp = tempfile.mkdtemp(prefix="dvie_export_")
    runs, seen = [], set()
    try:
        (b, h, w), steps = size, 3
        cfg = dataclasses.replace(CFG, input_h=h, input_w=w, batch_size=b)
        model = registry.build_model(cfg, device=dev, seed=0)
        t0 = time.perf_counter()
        path = export_lib.export_rollout(
            cfg, model, os.path.join(tmp, "rollout.pt2"), steps)
        t1 = time.perf_counter()
        served = export_lib.load_exported(path)
        t2 = time.perf_counter()
        seen |= _graph_ops(served)
        print(f"export rollout {steps} steps {b}x{h}x{w} bf16: exported in "
              f"{t1 - t0:.2f} s, {os.path.getsize(path) / 2**20:.1f} MiB, "
              f"loaded in {t2 - t1:.2f} s; ops {sorted(seen)}")
        imgs, ids = _inputs(dev, b, h, w, 2)
        imgs = [i.to(torch.bfloat16) for i in imgs]
        with torch.inference_mode():
            served(*imgs, *ids)                    # warm-up
            (frames, out_ids), counts = _counted(
                "export rollout", PER_FORWARD, steps,
                lambda: served(*imgs, *ids))
        runs.append(counts)
        live_f, live_i = serve.rollout(model, imgs, ids, steps)
        _same_or_why("export rollout", (frames, out_ids),
                     (torch.stack(live_f), torch.stack(live_i)))
        # each step against the plain model on the window the artifact
        # carried: the rgb by the served gate at every step, the seg at
        # step 1 (a forward on the input frames, the slice phase's case);
        # from step 2 the window holds frames the seeded model predicted,
        # whose seg logits sit near ties, so the agreement is printed
        plain = registry.build_model(cfg, device=dev, seed=0,
                                     use_kernels=False)
        win, win_ids = list(imgs), list(ids)
        for t in range(steps):
            x = torch.cat([f * 2 - 1 for f in win], -1)
            seg = torch.cat([serve.seg_oh(i) for i in win_ids], -1)
            r_p, s_p = serve.forward(plain, x, seg)
            _served_gate(f"export rollout step {t + 1} vs plain",
                         frames[t] * 2 - 1, out_ids[t],
                         torch.clamp(r_p, -1, 1), s_p, seg=t == 0)
            win, win_ids = [win[1], frames[t]], [win_ids[1], out_ids[t]]
        del plain
        with torch.inference_mode():
            ms_x = median_ms(lambda: served(*imgs, *ids), iters=1, reps=5)
            ms_e = median_ms(lambda: serve.rollout(model, imgs, ids, steps),
                             iters=1, reps=5)
            host_x = host_issue_ms(lambda: served(*imgs, *ids))
            host_e = host_issue_ms(
                lambda: serve.rollout(model, imgs, ids, steps))
        print(f"export rollout {b}x{h}x{w} bf16: {ms_x / steps:.4f} ms a "
              f"forward exported, {ms_e / steps:.4f} eager (median of 5 "
              f"{steps}-step rollouts, CUDA events); the host's issue "
              f"{host_x / steps:.4f} ms a forward exported, "
              f"{host_e / steps:.4f} eager, on {card}")
        del model, served
        # what the op costs a served call: K1 at its BasicBlock site
        # through dvie::conv3x3 and by its launch alone, host included
        g = torch.Generator(device=dev).manual_seed(3)
        xk, rk = (torch.randn((1, h, w, 64), generator=g, device=dev).to(
            torch.bfloat16) for _ in range(2))
        wk = torch.randn((64, 64, 3, 3), generator=g, device=dev) / 24.0
        with torch.inference_mode():
            ms_op = median_ms(lambda: k1.conv3x3_bias_res_lrelu(
                xk, wk, None, rk, True))
            ms_launch = median_ms(lambda: k1._kernel(xk, wk, None, rk, True))
        print(f"K1 basicblock conv2 1x{h}x{w}, host issue included: "
              f"{ms_op:.4f} ms through dvie::conv3x3, {ms_launch:.4f} by its "
              f"launch alone (median_ms) on {card}")
        for label, cfg_i, per in EXPORT_SLICES:
            cfg_i = dataclasses.replace(cfg_i, input_h=small[1],
                                        input_w=small[2], batch_size=small[0])
            m = registry.build_model(cfg_i, device=dev, seed=0)
            served = export_lib.load_exported(export_lib.export_forward(
                cfg_i, m, os.path.join(tmp, "forward.pt2")))
            seen |= _graph_ops(served)
            ims, sids = _inputs(dev, *small, 1)
            rgb = (torch.cat(ims, -1) * 2 - 1).to(torch.bfloat16)
            seg = torch.cat([serve.seg_oh(i) for i in sids], -1).to(
                torch.bfloat16)
            with torch.inference_mode():
                out, counts = _counted(f"export {label}", per, 1,
                                       lambda: served(rgb, seg))
            runs.append(counts)
            live = serve.forward(m, rgb, seg)
            _same_or_why(f"export {label}", out, live)
            _served_gate(f"export {label} vs the live model", out[0],
                         out[1].argmax(-1), live[0], live[1])
            del m, served
        if seen != DVIE_OPS:
            raise AssertionError(f"export: ops run from an artifact "
                                 f"{sorted(seen)}, expected "
                                 f"{sorted(DVIE_OPS)}")
        print(f"export: every dvie:: op ran from an artifact "
              f"({len(seen)} ops)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


# recipe 1 at 24x128x128 bf16 on two ranks of 12 (seeds 0 and 1 for the
# model and the VGG19, as train_setup's); and one launcher epoch in a group
# of one
DDP_RECIPE = (f"{RECIPE} --seed 0 --num_data_shards 2 INTER --model InterNet "
              "--train_coarse")
DDP_EPOCH = (f"{RECIPE} --epochs 1 --num_data_shards 1 INTER --model "
             "InterNet --train_coarse")
DDP_BATCH_SEED = 31
DDP_TIMEOUT = 600


def _ranks(fn, spec, n):
    """Start ``n`` processes, rank 0..n-1 of one group through the
    launcher's contract (``DVIE_MULTIHOST``, ``DVIE_COORDINATOR`` on a free
    port), each running ``chip_smoke.<fn>(spec)``; wait for each on its own
    clock.  Returns their stdout."""
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    code = (f"import json, sys; import chip_smoke as c; "
            f"c.{fn}(json.loads(sys.argv[1]))")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, json.dumps(spec)], cwd=root,
        env=dict(os.environ, DVIE_MULTIHOST="1", PYTHONPATH=root,
                 DVIE_COORDINATOR=f"127.0.0.1:{port}",
                 DVIE_NUM_PROCS=str(n), DVIE_PROC_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out = p.communicate(timeout=DDP_TIMEOUT)[0]
            if p.returncode != 0:
                raise AssertionError(f"{fn} rank {r} exited "
                                     f"{p.returncode}:\n{out[-4000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def ddp_rank(spec):
    """One rank of phase 36a: the runner on ``cuda:<rank mod cards>`` in the
    group the launcher's contract starts, its producer's shard of one
    global batch and one counted train step; writes the reduced losses,
    the averaged gradient (f32, the parameters' order), the launches, the
    group's backend and the median time of three more steps."""
    device = dist.init_from_env(spec.get("device", "cuda"))
    cfg = parse_args(spec["argv"])
    r = _quiet(lambda: Runner(cfg, spec["exp"], device=device))
    r._build_steps(train=True)
    batch = synthetic_batch(cfg.batch_size, cfg.input_h, cfg.input_w,
                            seed=DDP_BATCH_SEED)
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    for n, b in r._device_prefetch([batch]):
        sync()
        hw.reset_counters()
        with dist.sharded(dist.shard_of(n)):
            r.state, losses = r.train_step(r.state, b)
        sync()
        counts = dict(hw.launches)
        rows = b["frame1"].shape[0]
        losses = r._read_back([losses])[0]
        grads = torch.cat([p.grad.float().flatten()
                           for _, p in r.model.named_parameters()]).cpu()
        times = []                  # three more steps on the same shard
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            with dist.sharded(dist.shard_of(n)):
                r.train_step(r.state, b)
            sync()
            times.append(1e3 * (time.perf_counter() - t0))
    torch.save({"losses": losses, "grads": grads, "counts": counts,
                "rows": rows, "device": str(device),
                "step_ms": statistics.median(times),
                "backend": torch.distributed.get_backend()},
               spec["out"] % dist.rank())
    torch.distributed.destroy_process_group()


def ddp_epoch(spec):
    """Phase 36b in its own process: one launcher epoch (``cli/main.run``)
    under ``DVIE_MULTIHOST=1`` in a group of one, with
    ``--num_data_shards 1``; writes the launches and the backend ``run``'s
    group started on."""
    backends = []
    init = torch.distributed.init_process_group

    def recording(backend, **kw):
        backends.append(backend)
        return init(backend, **kw)
    torch.distributed.init_process_group = recording
    device = spec.get("device", "cuda")
    if device == "cuda":
        _build.library()
    hw.reset_counters()
    _quiet(lambda: run(parse_args(spec["argv"]), exp_dir=spec["exp"],
                       device=device))
    if device == "cuda":
        torch.cuda.synchronize()
    torch.save({"counts": dict(hw.launches), "backends": backends,
                "group_left": torch.distributed.is_initialized()},
               spec["out"])


def ddp_phase(dev, card):
    """Phase 36: data parallelism (``parallel/dist.py``).  (a) Recipe 1 at
    24x128x128 on two ranks of 12 that share the one card (NCCL takes one
    rank a device, so ``init_from_env`` starts such a group on gloo, which
    all-reduces CUDA tensors): each rank's launches are the one-process
    ``b0`` step's, the two ranks' averaged gradients are equal, the
    reduced losses within 2e-2 of the one-process kernel step's, the
    gradient no further from the f32 plain step's than 1.5x the
    one-process kernel step's + 1e-3 (the train gates).  (b) One launcher
    epoch with ``--num_data_shards 1`` under ``DVIE_MULTIHOST=1``: a group
    of one on NCCL, the epoch's launches, its checkpoint.  Returns the
    counted launches."""
    tmp = tempfile.mkdtemp(prefix="dvie_ddp_")
    runs = []
    try:
        t0 = time.perf_counter()
        spec = {"argv": DDP_RECIPE.split(), "exp": tmp, "device": dev.type,
                "out": os.path.join(tmp, "rank%d.pt")}
        _ranks("ddp_rank", spec, 2)
        ranks = [torch.load(spec["out"] % r) for r in range(2)]
        took = time.perf_counter() - t0
        for r, got in enumerate(ranks):
            print(f"ddp rank {r}: {got['device']}, backend "
                  f"{got['backend']}, {got['rows']} rows, a step "
                  f"{got['step_ms']:.4f} ms (median of 3 after the counted "
                  f"one), launches "
                  f"{json.dumps({k: v for k, v in got['counts'].items() if v})}")
            _check_step_counts(f"ddp rank {r}", got["counts"],
                               PER_TRAIN_STEP)
        if not torch.equal(ranks[0]["grads"], ranks[1]["grads"]):
            raise AssertionError("ddp: the ranks' averaged gradients differ")
        cfg = parse_args(DDP_RECIPE.split())
        batch = {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(
            cfg.batch_size, cfg.input_h, cfg.input_w,
            seed=DDP_BATCH_SEED).items() if k != "bboxes"}
        l_one, g_one = step_grads(dev, True, "bfloat16", batch)
        tf32 = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            _, g_ref = step_grads(dev, False, "float32", batch)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = tf32
        print(f"ddp recipe 1 on two ranks of 12 sharing {card}: "
              f"{took:.2f} s of processes; against one process:")
        fail = _check_grad("whole gradient", ranks[0]["grads"].to(dev),
                           _flat(g_one), _flat(g_ref))
        if fail:
            raise AssertionError(f"ddp: {fail}")
        for k, v in l_one.items():
            got = ranks[0]["losses"][k]
            rel = abs(got - v) / max(abs(v), 1e-30)
            print(f"  {k}: two ranks {got:.6g} one process {v:.6g} "
                  f"rel {rel:.3g}")
            if rel > LOSS_TOL:
                raise AssertionError(f"ddp: {k} differs by {rel:.4g}")
        runs += [r["counts"] for r in ranks]

        t0 = time.perf_counter()
        exp = os.path.join(tmp, "epoch")
        spec = {"argv": DDP_EPOCH.split(), "exp": exp, "device": dev.type,
                "out": os.path.join(tmp, "epoch.pt")}
        _ranks("ddp_epoch", spec, 1)
        got = torch.load(spec["out"])
        epoch = EPOCH_LINE.findall(_log_of(exp))
        print(f"ddp launcher epoch, --num_data_shards 1 under "
              f"DVIE_MULTIHOST=1: group backend {got['backends']}, "
              f"{epoch[0][3] if epoch else '?'} samples/s, "
              f"{time.perf_counter() - t0:.2f} s of process on {card}")
        if got["backends"] != ["nccl"] or got["group_left"]:
            raise AssertionError(f"ddp epoch: backends {got['backends']}, "
                                 f"group left {got['group_left']}")
        losses = [float(v) for *_, v in LOSS_LINE.findall(_log_of(exp))]
        if len(losses) != RUNNER_EPOCH_STEPS or not all(
                map(math.isfinite, losses)):
            raise AssertionError(f"ddp epoch: losses {losses}")
        if not os.listdir(os.path.join(exp, "checkpoint")):
            raise AssertionError("ddp epoch: no checkpoint")
        for name in hw.KERNELS:
            want = PER_TRAIN_STEP.get(name, 0) * RUNNER_EPOCH_STEPS
            if got["counts"][name] != want:
                raise AssertionError(f"ddp epoch: {name} launched "
                                     f"{got['counts'][name]}, expected "
                                     f"{want}")
        runs.append(got["counts"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


# ---- spatial sharding (phase 38) ------------------------------------------

# recipe 1 on a spatial group of two ranks sharing the card and in one
# process of the plain route: (a) at its published shape, (b) at 1x512x1024
SPATIAL_SHAPES = {"a": (24, 128, 128), "b": (1, 512, 1024)}
SPATIAL_EPOCH_STEPS = 20
SPATIAL_BATCH_SEED = 37


def _spatial_argv(key, s, extra=""):
    b, h, w = SPATIAL_SHAPES[key]
    return (f"--dataset synthetic --split train --syn_type inter --input_h "
            f"{h} --input_w {w} --bs {b} --disp_interval 1 --seed 0 "
            f"--num_spatial_shards {s} {extra} INTER --model InterNet "
            "--train_coarse").split()


def _spatial_step(key, spec, device, extra="", timed=False):
    """One counted step of recipe 1 at ``SPATIAL_SHAPES[key]`` through the
    runner's producer on this rank's band: its launches, halo exchanges,
    peak memory, reduced losses, the gradient the optimizer stepped on and
    the parameters after it; with ``timed`` the median ms of 3 more."""
    cfg = parse_args(_spatial_argv(key, spec["s"], extra))
    r = _quiet(lambda: Runner(cfg, spec["exp"], device=device))
    r._build_steps(train=True)
    b, h, w = SPATIAL_SHAPES[key]
    batch = synthetic_batch(b, h, w, seed=SPATIAL_BATCH_SEED)
    for n, bt in r._device_prefetch([batch]):
        torch.cuda.synchronize()
        hw.reset_counters()
        spatial.exchanges.update(fwd=0, bwd=0)
        torch.cuda.reset_peak_memory_stats()
        with r._on_shard(n):
            r.state, losses = r.train_step(r.state, bt)
        torch.cuda.synchronize()
        res = {"counts": dict(hw.launches),
               "exchanges": dict(spatial.exchanges),
               "peak": torch.cuda.max_memory_allocated() / 2**30,
               "losses": r._read_back([losses])[0],
               "grads": torch.cat([p.grad.float().flatten()
                                   for p in r.model.parameters()]).cpu(),
               "params": torch.cat([p.detach().float().flatten()
                                    for p in r.model.parameters()]).cpu()}
        times = []
        for _ in range(3 if timed else 0):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with r._on_shard(n):
                r.train_step(r.state, bt)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        res["step_ms"] = statistics.median(times) if times else None
    del r
    torch.cuda.empty_cache()
    return res


def _spatial_epoch(spec, device):
    """The launcher (``cli.main.run``): one epoch of recipe 1 at
    24x128x128 (its synthetic train set lengthened to
    ``SPATIAL_EPOCH_STEPS`` batches), then ``--split val`` on its
    checkpoint; returns the epoch's logged losses (rank 0), the
    checkpoints and the val metrics."""
    exp = os.path.join(spec["exp"], f"epoch_s{spec['s']}")
    get = datasets.get_dataset

    def longer(cfg, vid_len=3):
        train, val = get(cfg, vid_len)
        if train is not None:
            train.num_batches = SPATIAL_EPOCH_STEPS
        return train, val
    datasets.get_dataset = longer
    try:
        _quiet(lambda: run(parse_args(_spatial_argv("a", spec["s"],
                                                    "--epochs 1")),
                           exp_dir=exp, device=device))
        argv = _spatial_argv("a", spec["s"], f"--load_dir {exp} "
                             "--checksession 0 --checkepoch 1")
        argv[argv.index("train")] = "val"
        val = _quiet(lambda: run(parse_args(argv + ["--load_coarse"]),
                                 exp_dir=exp, device=device))
    finally:
        datasets.get_dataset = get
    losses = ([float(v) for *_, v in LOSS_LINE.findall(_log_of(exp))]
              if dist.is_main() else None)
    return {"losses": losses, "val": val,
            "ckpts": sorted(os.listdir(os.path.join(exp, "checkpoint")))}


def spatial_rank(spec):
    """One process of phase 38: rank r of a spatial group of ``spec["s"]``
    ranks on ``cuda:<rank mod cards>``, or (s = 1) the one-process
    reference on the plain route, which also takes (a)'s step in f32 with
    TF32 off.  Writes (a)'s and (b)'s steps, the epoch and the backend."""
    device = dist.init_from_env("cuda")
    if spec["s"] == 1:    # the route of a spatial step
        registry.build_model = functools.partial(registry.build_model,
                                                 use_kernels=False)
    out = {"device": str(device), "backend": torch.distributed.get_backend(),
           "a": _spatial_step("a", spec, device, timed=True),
           "b": _spatial_step("b", spec, device)}
    if spec["s"] == 1:
        tf32 = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            out["a_f32"] = _spatial_step("a", spec, device,
                                         "--compute_dtype float32")
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = tf32
    out["epoch"] = _spatial_epoch(spec, device)
    torch.save(out, spec["out"] % dist.rank())
    torch.distributed.destroy_process_group()


def spatial_phase(dev, card):
    """Phase 38: spatial sharding on two ranks sharing the card (module
    docstring).  Returns the ranks' counted launches (all 0)."""
    tmp = tempfile.mkdtemp(prefix="dvie_spatial_")
    try:
        got = {}
        for s in (1, 2):
            t0 = time.perf_counter()
            spec = {"s": s, "exp": tmp,
                    "out": os.path.join(tmp, f"s{s}_rank%d.pt")}
            _ranks("spatial_rank", spec, s)
            got[s] = [torch.load(spec["out"] % r) for r in range(s)]
            print(f"spatial S = {s}: {time.perf_counter() - t0:.2f} s of "
                  f"processes on {card}")
        (one,), ranks = got[1], got[2]
        b, h, w = SPATIAL_SHAPES["a"]
        for r, g in enumerate(ranks):
            a = g["a"]
            print(f"spatial rank {r}: {g['device']}, backend {g['backend']}, "
                  f"band {b}x{h // 2}x{w} of {b}x{h}x{w}, a step "
                  f"{a['step_ms']:.4f} ms (median of 3 after the counted "
                  f"one; one process of the plain route "
                  f"{one['a']['step_ms']:.4f} ms), halo exchanges "
                  f"{a['exchanges']['fwd']} forward + "
                  f"{a['exchanges']['bwd']} backward a step, peak "
                  f"{a['peak']:.3f} GiB on {card}")
            for key in ("a", "b"):
                if any(g[key]["counts"].values()):
                    raise AssertionError(
                        f"spatial rank {r} ({key}): kernels launched "
                        f"{ {k: v for k, v in g[key]['counts'].items() if v} }")
        for part in ("grads", "params"):
            if not torch.equal(ranks[0]["a"][part], ranks[1]["a"][part]):
                raise AssertionError(f"spatial: the ranks' {part} differ")
        print(f"spatial (a) recipe 1 at {b}x{h}x{w} bf16, S = 2, against "
              f"one process of the plain route:")
        fail = _check_grad("whole gradient", ranks[0]["a"]["grads"].to(dev),
                           one["a"]["grads"].to(dev),
                           one["a_f32"]["grads"].to(dev))
        if fail:
            raise AssertionError(f"spatial: {fail}")
        for key in ("a", "b"):
            for k, v in one[key]["losses"].items():
                got_k = ranks[0][key]["losses"][k]
                rel = abs(got_k - v) / max(abs(v), 1e-30)
                print(f"  ({key}) {k}: two bands {got_k:.6g} one process "
                      f"{v:.6g} rel {rel:.3g}")
                if rel > LOSS_TOL:
                    raise AssertionError(f"spatial ({key}): {k} differs by "
                                         f"{rel:.4g}")
        bb, hb, wb = SPATIAL_SHAPES["b"]
        peaks = [g["b"]["peak"] for g in ranks]
        print(f"spatial (b) one step at {bb}x{hb}x{wb} bf16: peak memory "
              f"rank 0 {peaks[0]:.3f} GiB, rank 1 {peaks[1]:.3f} GiB, one "
              f"process {one['b']['peak']:.3f} GiB "
              f"({peaks[0] / one['b']['peak']:.4f} of it); halo exchanges "
              f"{ranks[0]['b']['exchanges']} a step, on {card}")
        if max(peaks) >= one["b"]["peak"]:
            raise AssertionError(f"spatial (b): a rank's peak {max(peaks)} "
                                 f"GiB is not below {one['b']['peak']}")
        l2, l1 = ranks[0]["epoch"]["losses"], one["epoch"]["losses"]
        print(f"spatial launcher epoch of {len(l2)} steps: loss_all "
              f"{' '.join(f'{v:.5g}' for v in l2)}; one process "
              f"{' '.join(f'{v:.5g}' for v in l1)}")
        if (len(l2) != SPATIAL_EPOCH_STEPS or len(l1) != SPATIAL_EPOCH_STEPS
                or not all(map(math.isfinite, l2 + l1))):
            raise AssertionError(f"spatial epoch: losses {l2} / {l1}")
        # the first Adamax step overshoots (PERF.md section 7), so the
        # epoch falls from its first steps to its last ones
        head, tail = (statistics.mean(l2[:5]), statistics.mean(l2[-5:]))
        if not tail < head:
            raise AssertionError(f"spatial epoch: loss_all did not fall: "
                                 f"mean of the first 5 steps {head:.6g}, of "
                                 f"the last 5 {tail:.6g}")
        gap = abs(l2[-1] - l1[-1]) / abs(l1[-1])
        print(f"spatial epoch: final loss_all two bands {l2[-1]:.6g}, one "
              f"process {l1[-1]:.6g} (rel {gap:.4g}, bound {TRAJ_TOL})")
        if gap > TRAJ_TOL:
            raise AssertionError(f"spatial epoch: final loss differs by "
                                 f"{gap:.4g}")
        val = ranks[0]["epoch"]["val"]
        print(f"spatial --split val on the epoch's checkpoint "
              f"{ranks[0]['epoch']['ckpts']}: "
              f"{json.dumps(val)}; one process {json.dumps(one['epoch']['val'])}")
        if (not ranks[0]["epoch"]["ckpts"] or val != ranks[1]["epoch"]["val"]
                or not all(map(math.isfinite, val.values()))):
            raise AssertionError(f"spatial val: {val}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return [g[key]["counts"] for g in ranks for key in ("a", "b")]


# ---- the rest of the model zoo (phase 37) ---------------------------------

ZOO_SIZE = (2, 512, 1024)
ZOO_SHIFT = (8, 16)        # px between the moving scene's frames
ZOO_FLOW_AGREE = 0.90      # flow maps, bf16 model vs f32 model
ZOO_REPS = 5               # timed forwards a model, after one warm-up
ZOO_NOISE = 0.1            # std of each frame's own noise
# the L2 attention: also run, not gated, on the scene without noise
ZOO_EXACT = ("AttnRefineV2", "AttnRefineV2O")
# the cosine attention with the -100 pad on the normalized neighbour: its
# rgb is held by rel-L2, its max|d| printed beside the bound, not gated
ZOO_PAD_SENSITIVE = ("AttnRefineV3", "AttnRefineV4")
ZOO_REL_L2 = 2e-2
# the voxel-flow nets' warped frames (f32 samples at the bf16 model's
# flows): printed, not gated; the flows and masks are
ZOO_WARPED = {"OpticalUnet": (0, 3), "OpticalRefineNet": (1, 4)}


def moving_frames(dev, b, h, w, seed, shift=ZOO_SHIFT, noise=ZOO_NOISE):
    """A moving scene: a smooth random field in [-1, 1] seen at ``-shift``
    (neighbour 1), 0 (x) and ``+shift`` (neighbour 2) pixels, each frame
    plus its own N(0, ``noise``) noise, and blocky seg one-hots at 0: (x
    (b,h,w,3), neighbours (b,h,w,6), seg (b,h,w,20)).  The shifts are
    multiples of 8 px, so the encoders' 1/4 and 1/8 maps see the same
    content moved by whole cells and the window correlations have a clear
    best offset (random frames leave near ties that bf16 rounding
    reorders, phase 13).  The noise keeps that offset from an exact match,
    as in real frames: there the L2 attention's ``1 / (dist + 1e-6)``
    would divide by dist's rounding error."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dy, dx = shift
    hh, ww = h + 2 * dy, w + 2 * dx
    z = torch.randn((b, 3, hh // 8 + 2, ww // 8 + 2), generator=g, device=dev)
    field = torch.tanh(torch.nn.functional.interpolate(
        z, size=(hh, ww), mode="bicubic", align_corners=False))
    frames = [field[:, :, dy + k * dy:dy + k * dy + h,
                    dx + k * dx:dx + k * dx + w].permute(0, 2, 3, 1)
              for k in (-1, 0, 1)]
    frames = [f + noise * torch.randn(f.shape, generator=g, device=dev)
              for f in frames]
    ids = torch.nn.functional.interpolate(torch.randint(
        0, 20, (b, 1, h // 16, w // 16), generator=g, device=dev).float(),
        size=(h, w), mode="nearest")[:, 0]
    return (frames[1].contiguous(), torch.cat([frames[0], frames[2]], -1),
            serve.seg_oh(ids.to(torch.uint8)))


def zoo_cases(x, nb, seg):
    """(name, model factory on a dtype, the forward's inputs, flow output
    index or None) of each public model of models/srn_legacy,
    models/attn_legacy and OpticalUnet / OpticalRefineNet."""
    from deep_video_interpolation_extrapolation_tpu_torch.models import (
        attn_legacy as al,
        optical,
        srn_legacy as srn,
    )
    cases = []
    for n in (1, 2):
        cases += [
            (f"SRN4 n_scales {n}", lambda d, n=n: srn.SRN4(n, dtype=d), (x,)),
            (f"SRN4Seg n_scales {n}",
             lambda d, n=n: srn.SRN4Seg(n, dtype=d), (x, seg)),
            (f"SRN4Sharp n_scales {n}",
             lambda d, n=n: srn.SRN4Sharp(n, dtype=d), (x, None, nb))]
    cases += [
        ("AttnRefine", lambda d: srn.AttnRefine(dtype=d), (x, None, nb)),
        ("AttnBaseRefine", lambda d: srn.AttnBaseRefine(dtype=d),
         (x, None, nb)),
        ("MSBaseRefine", lambda d: srn.MSBaseRefine(cin=9, dtype=d),
         (x, None, nb))]
    for v in ("V2", "V2O", "V2Base", "V3", "V3Base", "V4", "V4Base"):
        cases.append((f"AttnRefine{v}",
                      lambda d, v=v: getattr(al, f"AttnRefine{v}")(dtype=d),
                      (x, nb)))
    cases += [("OpticalUnet", lambda d: optical.OpticalUnet(dtype=d), (nb,)),
              ("OpticalRefineNet", lambda d: optical.OpticalRefineNet(dtype=d),
               (nb,))]
    return cases


def _as_dtype(model, dt):
    """A copy of ``model`` whose modules compute in ``dt``."""
    model = copy.deepcopy(model)
    for m in model.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = dt
    return model


def _f32_ref(fn):
    """``fn()`` with TF32 off (the f32 reference's convolutions)."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return fn()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def _zoo_timed(model, args):
    """(the outputs, the median ms of ``ZOO_REPS`` synchronized forwards
    after a warm-up, peak GiB from before the warm-up)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = model(*args)
    times = []
    for _ in range(ZOO_REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = model(*args)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return (out, statistics.median(times),
            torch.cuda.max_memory_allocated() / 2**30)


def _zoo_gate(name, out, ref, gate=True):
    """Each output of the bf16 model against the f32 model's: a flow map
    (the (B, 2, h, w, 2) argmax offsets of V2..V4) by its agreement >=
    ZOO_FLOW_AGREE, every other output by max|d| <= SLICE_RGB_TOL *
    max(1, max|ref|) (raising where ``gate``).  V3's and V4's rgb is held
    by rel-L2 <= ZOO_REL_L2 instead: at the cells where the normalized
    query sums near 0, each padded offset's logit ``-100 * sum`` moves by
    ~2 under bf16 rounding of the features, and the softmax with it (V4's
    largest errors sit at such a cell).  The voxel-flow nets' warped
    frames are not gated: a flow near +-1 in normalized coordinates has a
    bf16 step of 2^-8, ~2 px at 1024 wide, so they differ by the frame's
    change over that (up to 0.44 on a noisy frame); their flows and masks
    are gated, and OpticalRefineNet's fused frame is held against the f32
    RefineUnet on the bf16 model's own warps and masks (the caller's
    ``ref``).  Returns the printable results."""
    got, want = list(_tensors(out)), list(_tensors(ref))
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} outputs, f32 {len(want)}")
    parts = []
    for k, (o, r) in enumerate(zip(got, want)):
        if o.shape != r.shape or not torch.isfinite(o.float()).all():
            raise AssertionError(f"{name}: output {k} {tuple(o.shape)} "
                                 f"against {tuple(r.shape)}, or not finite")
        if name.startswith("AttnRefineV") and k == 1:
            agree = flow_agreement(o, r)
            parts.append(f"flow agreement {agree:.6f}")
            if gate and agree < ZOO_FLOW_AGREE:
                raise AssertionError(f"{name}: flow agreement {agree:.4f}")
            continue
        d = (o.float() - r.float()).abs().max().item()
        bound = SLICE_RGB_TOL * max(1.0, r.float().abs().max().item())
        rel = ((o.float() - r.float()).norm() / r.float().norm()).item()
        parts.append(f"out {k} {tuple(o.shape)} max|d| {d:.6g} (bound "
                     f"{bound:.6g}), rel-L2 {rel:.6g}")
        if k in ZOO_WARPED.get(name, ()):
            parts[-1] += " (not gated)"
        elif name in ZOO_PAD_SENSITIVE:
            parts[-1] += f" (bound {ZOO_REL_L2}; max|d| not gated)"
            if gate and not rel <= ZOO_REL_L2:
                raise AssertionError(f"{name}: output {k} rel-L2 {rel:.4g}")
        elif gate and not d <= bound:
            raise AssertionError(f"{name}: output {k} max|d| {d:.4g} > "
                                 f"{bound:.4g}")
    return "; ".join(parts)


def legacy_zoo_phase(dev, card):
    """Phase 37: each public model of models/srn_legacy (the SRN4 family at
    ``n_scales`` 1 and 2, HResUnet on the 32-channel feature of an
    SRN4Sharp ``high_res`` run on the half-resolution frames, AttnRefine,
    AttnBaseRefine, MSBaseRefine), models/attn_legacy (V2, V2O, V2Base,
    V3, V3Base, V4, V4Base) and OpticalUnet / OpticalRefineNet, at full
    width at 2x512x1024 bf16 in eval (``inference_mode``) on a seeded
    noisy moving scene (``moving_frames``), seeded weights
    (``init_weights``): the median ms of 5 forwards after a warm-up and
    the peak memory, then the same weights in f32 (TF32 off) as the
    reference: every output by the slice phase's rgb bound (V3's and V4's
    rgb by rel-L2, the voxel-flow nets' warps not gated: ``_zoo_gate``),
    the flow maps by their agreement.  V2
    and V2O are also compared, not gated, on the scene without noise (an
    exact match at the best offset).  They
    launch no kernel of the port (JAX's counterparts reach no Pallas
    kernel): every launch counter stays at 0."""
    from deep_video_interpolation_extrapolation_tpu_torch.models import (
        srn_legacy as srn,
    )
    from deep_video_interpolation_extrapolation_tpu_torch.ops.resize import (
        interpolate_bilinear,
    )
    b, h, w = ZOO_SIZE
    x, nb, seg = moving_frames(dev, b, h, w, 37)
    exact = moving_frames(dev, b, h, w, 37, noise=0.0)[:2]
    half = [interpolate_bilinear(t, scale_factor=0.5, align_corners=True)
            for t in (x, nb)]
    # HResUnet runs on the feature of its own dtype's SRN4Sharp
    sharp = registry.init_weights(srn.SRN4Sharp(high_res=True,
                                                dtype=torch.float32), 36)
    lows = {}
    for dt in (torch.bfloat16, torch.float32):
        model = _as_dtype(sharp, dt).to(dev).eval()
        with torch.inference_mode():
            lows[dt] = _f32_ref(lambda: model(half[0], None, half[1])[1])
    cases = zoo_cases(x, nb, seg) + [
        ("HResUnet", lambda d: srn.HResUnet(dtype=d), (None, lows, x))]
    t0 = time.perf_counter()
    hw.reset_counters()
    for i, (name, make, args) in enumerate(cases):
        master = registry.init_weights(make(torch.float32), 40 + i)
        run_args = {dt: tuple(a[dt] if isinstance(a, dict) else a
                              for a in args)
                    for dt in (torch.bfloat16, torch.float32)}
        model = _as_dtype(master, torch.bfloat16).to(dev).eval()
        n_par = sum(p.numel() for p in master.parameters())
        with torch.inference_mode():
            out, ms, peak = _zoo_timed(model, run_args[torch.bfloat16])
            master.to(dev).eval()
            ref = _f32_ref(lambda: master(*run_args[torch.float32]))
            if name == "OpticalRefineNet":      # its refiner, on out's warps
                ref = (_f32_ref(lambda: master.refine_model(
                    out[1], out[3], out[4], out[6])), *ref[1:])
            line = _zoo_gate(name, out, ref)
            if name in ZOO_EXACT:
                line += "; noise-free scene (not gated): " + _zoo_gate(
                    name, model(*exact), _f32_ref(lambda: master(*exact)),
                    gate=False)
        print(f"zoo {name}: {n_par} parameters, {b}x{h}x{w} bf16 eval: "
              f"{ms:.4f} ms a forward (median of {ZOO_REPS} after a "
              f"warm-up), peak memory {peak:.3f} GiB on {card}; {line}")
        del master, model, out
        torch.cuda.empty_cache()
    launched = {k: v for k, v in hw.launches.items() if v}
    if launched:
        raise AssertionError(f"zoo: kernel launches {launched}")
    print(f"zoo phase: {len(cases)} models in "
          f"{time.perf_counter() - t0:.2f} s, no kernel launched")


def main():
    dev = require_card()
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    _build.library()
    print(f"nvcc build {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path().name})")
    ptxas_report()
    kernels = kernel_phase(dev)
    slice_phase(dev)
    counts = serve_phase(dev, card)
    kernels.update(train_kernel_phase(dev))
    batch27_kernel_phase(dev)
    k1_backward_check(dev)
    k4_backward_check(dev)
    taps4_backward_check(dev)
    h_mode_backward_check(dev)
    kernels.update(grid_sample_bwd_check(dev))
    train_counts, g_ref = train_phase(dev, card)
    runs = [counts, train_counts, *bbchain_modes_phase(dev, card, g_ref),
            recipe_step_phase(dev, card, CFG_R2, "refine_model", "recipe 2"),
            recipe_step_phase(dev, card, CFG_R3, "stage3_model", "recipe 3"),
            highres_phase(dev, card), stage3_phase(dev, card),
            recipe3_serve_phase(dev, card), vae_phase(dev, card),
            gan_serve_phase(dev, card), gan_step_phase(dev, card),
            *gan_runner_phase(dev, card), *extra_serve_phase(dev, card),
            *r6_step_phase(dev, card), *r6_runner_phase(dev, card),
            highres_extra_serve_phase(dev, card),
            *highres_train_phase(dev, card), *remat_phase(dev, card),
            track_obj_phase(dev, card), *track_obj_runner_phase(dev, card),
            *plain_vae_phase(dev, card), vae_train_phase(dev, card),
            *legacy_steps_phase(dev, card), *runner_phase(dev, card)]
    runs += triplet_phase(dev, card)
    runs += export_phase(dev, card)
    runs += ddp_phase(dev, card)
    track_gen_phase(dev, card)
    det_disc_phase(dev, card)
    legacy_zoo_phase(dev, card)
    runs += spatial_phase(dev, card)
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
