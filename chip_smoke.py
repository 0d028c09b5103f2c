"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the four Hopper kernels from ``deep_video_interpolation_extrapolation_tpu_torch/csrc``
(and the Triton one), then, in order:

1. kernels: each kernel against its plain PyTorch version on the card, in
   bf16 at the main-path shapes (B=1, 512x1024), max|d|/max|ref| <= 2e-2,
   with median CUDA-event times of both;
2. slice: InterNet/HRNet at full width, 128x256, B=2, bf16, kernels against
   the plain model with the same seed weights: rgb max|d| <= 5e-2 *
   max(1, max|ref|), seg argmax agreement >= 98%;
3. serving: ``registry.build_model`` + ``serve.rollout`` for 3 steps at
   512x1024, B=2, bf16 after one warm-up rollout; every kernel's launch
   counter must move by its count per forward (K1 18, K2 4, K3 2, K4 1);
   outputs finite, seg ids in [0, 20); frames/s;
4. train kernels: the stem and Bottleneck kernels (forward and backward)
   and K4's h mode against their plain versions at the recipe shapes
   (24x128x128 bf16): outputs by max|d|/max|ref| <= 2e-2, weight and bias
   grads by rel-L2 <= 1e-2; each backward twice, on inputs whose lrelu
   masks are fixed per channel (dx by max|d|/max|ref| <= 2e-2) and on
   random inputs, whose masks vary per pixel (dx by rel-L2 <= 1e-2);
5. training: the INTER train step (``train/inter.make_train_step``) of
   InterNet/HRNet at full width on seeded 24x128x128 batches, bf16 with f32
   masters, frozen seeded VGG19, default loss weights:
   - one step's gradient, kernel model and plain bf16 model, each against
     the plain model in f32 (TF32 off): the kernel model's rel-L2 error
     <= 1.5 x the plain bf16 model's + 1e-3, for the whole gradient and
     for each stem and layer1 leaf on its own, and every loss term within
     2e-2 relative of the plain bf16 model's;
   - 20 Adamax steps on one fixed batch per model: loss_all falls for
     both, and the kernel model ends within 10% of the plain model;
   - the launches of one counted step (stem fwd/bwd 1/1, Bottleneck
     fwd/bwd 4/4, K1 16, K2 0, K3 2, K4 taps 1 and h mode 1);
   - samples/s of both models: median of the 18 steps after 2 warm-ups.

Prints the card's name and power limit, one JSON line of per-kernel results
(``launches``: the serve rollout's count plus the counted train step's),
and last ``{"ok": true, "device": {...}}``.  Any failed phase raises: the
exit code is then non-zero and no result line is printed.  Needs a CUDA
card of compute capability (9, 0); there is no CPU fallback.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import torch

from deep_video_interpolation_extrapolation_tpu_torch import serve
from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.train import (
    inter,
    state as state_lib,
)
from deep_video_interpolation_extrapolation_tpu_torch.train.common import (
    init_vgg_frozen,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops import (
    _build,
    bottleneck_tail as k2,
    conv3x3 as k1,
    fuse0 as k3,
    trainchain as tc,
    upshead as k4,
)

KERNEL_TOL = 2e-2          # max|d| / max|ref|, bf16 kernel vs plain
WGRAD_TOL = 1e-2           # rel-L2 of a weight grad, kernel vs plain
DX_L2_TOL = 1e-2           # rel-L2 of dx on random inputs, kernel vs plain
SLICE_RGB_TOL = 5e-2       # rgb max|d| / max(1, max|ref|)
SLICE_SEG_AGREE = 0.98     # seg argmax agreement
PER_FORWARD = {"conv3x3_bias_res_lrelu": 18, "bottleneck_tail": 4,
               "fuse_out0": 2, "ups_head_taps": 1}
# one train step at 24x128x128: the train chain for stem + layer1, K1 for
# the 16 branch-0 BasicBlock convs of stages 2 and 3, no K2
PER_TRAIN_STEP = {"stem_fwd": 1, "stem_bwd": 1, "bottleneck_fwd": 4,
                  "bottleneck_bwd": 4, "conv3x3_bias_res_lrelu": 16,
                  "bottleneck_tail": 0, "fuse_out0": 2, "ups_head_taps": 1,
                  "ups_head_1x1": 1}
GRAD_RATIO, GRAD_FLOOR = 1.5, 1e-3   # kernel grad error <= 1.5 x plain's + 1e-3
LOSS_TOL = 2e-2            # each loss term, kernel vs plain bf16, relative
TRAJ_TOL = 0.10            # final loss_all, kernel vs plain, relative
PKG = "deep_video_interpolation_extrapolation_tpu_torch"
META = {
    "conv3x3_bias_res_lrelu": ("cuda", f"{PKG}/csrc/conv3x3.cu",
                               "deep_video_interpolation_extrapolation_tpu/ops/pallas_ae_conv.py:400"),
    "bottleneck_tail": ("cuda", f"{PKG}/csrc/bottleneck_tail.cu",
                        "deep_video_interpolation_extrapolation_tpu/ops/pallas_chain.py:495"),
    "fuse_out0": ("triton", f"{PKG}/ops/fuse0.py",
                  "deep_video_interpolation_extrapolation_tpu/ops/pallas_fuse0.py:419"),
    "ups_head_taps": ("cuda", f"{PKG}/csrc/upshead.cu",
                      "deep_video_interpolation_extrapolation_tpu/ops/pallas_upshead.py:342"),
    "ups_head_1x1": ("cuda", f"{PKG}/csrc/upshead.cu",
                     "deep_video_interpolation_extrapolation_tpu/ops/pallas_upshead.py:362"),
    "stem_fwd": ("cuda", f"{PKG}/csrc/trainchain_stem.cu",
                 "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:530"),
    "stem_bwd": ("cuda", f"{PKG}/csrc/trainchain_stem.cu",
                 "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:565"),
    "bottleneck_fwd": ("cuda", f"{PKG}/csrc/trainchain_bottleneck.cu",
                       "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:400"),
    "bottleneck_bwd": ("cuda", f"{PKG}/csrc/trainchain_bottleneck.cu",
                       "deep_video_interpolation_extrapolation_tpu/ops/pallas_trainchain.py:445"),
}


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


def median_ms(fn, iters=10, reps=5):
    """Median over ``reps`` of the mean CUDA-event time of ``iters``
    back-to-back calls (after two warm-up calls)."""
    fn()
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
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
    cases = {name: [] for name in PER_FORWARD}
    # K1: stem conv2 (bias), transition1 trans_0 (Cin 256), BasicBlock
    # conv2 (residual) — the timed one, 16 of the 18 launches per forward
    x64, x256, res = rnd(B, H, W, 64), rnd(B, H, W, 256), rnd(B, H, W, 64)
    w64, w256, bias = w(64, 64, 3, 3), w(64, 256, 3, 3), w(64, 1, 1, 1).flatten()
    cases["conv3x3_bias_res_lrelu"] = [
        ("stem conv2", (x64, w64, bias, None, True)),
        ("trans_0", (x256, w256, None, None, True)),
        ("basicblock conv2", (x64, w64, None, res, True)),
    ]
    # K2: block 0 (projection residual), blocks 1-2, block 3 (no next h1)
    h1 = torch.nn.functional.leaky_relu(rnd(B, H, W, 64), 0.2)
    w2, w3 = w(64, 64, 3, 3), w(256, 64, 1, 1)
    wres, w1n = w(256, 64, 1, 1), w(64, 256, 1, 1)
    cases["bottleneck_tail"] = [
        ("block 0", (h1, x64, w2, w3, wres, w1n)),
        ("block 3", (h1, x256, w2, w3, None, None)),
        ("block 1", (h1, x256, w2, w3, None, w1n)),
    ]
    # K3: stage2 (no t2), stage3 (with t2)
    t1, t2 = rnd(B, H // 2, W // 2, 64), rnd(B, H // 4, W // 4, 64)
    cases["fuse_out0"] = [("stage2", (x64, t1, None)),
                          ("stage3", (x64, t1, t2))]
    # K4: the head at its one site
    p1, p2 = rnd(B, H // 2, W // 2, 128), rnd(B, H // 4, W // 4, 256)
    w1 = w(896, 448, 1, 1)[:, :, 0, 0].t()
    b1 = w(896, 1, 1, 1).flatten()
    w2t = k4.build_dual_tap_kernel(w(3, 448, 3, 3), w(20, 448, 3, 3),
                                   torch.bfloat16)
    cases["ups_head_taps"] = [("heads", (x64, p1, p2, w1, b1, w2t))]

    fns = {"conv3x3_bias_res_lrelu": (k1.conv3x3_bias_res_lrelu,
                                      k1.conv3x3_bias_res_lrelu_plain),
           "bottleneck_tail": (k2.bottleneck_tail, k2.bottleneck_tail_plain),
           "fuse_out0": (k3.fuse_out0, k3.fuse_out0_plain),
           "ups_head_taps": (k4.ups_head_taps, k4.ups_head_taps_plain)}
    results = {}
    for name, variants in cases.items():
        kern, plain = fns[name]
        worst_abs, worst_rel = 0.0, 0.0
        for label, args in variants:
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
                worst_abs, worst_rel = max(worst_abs, d), max(worst_rel, rel)
        if worst_rel > KERNEL_TOL:
            raise AssertionError(f"{name}: max|d|/max|ref| {worst_rel:.4g} > "
                                 f"{KERNEL_TOL}")
        label, args = variants[-1]
        ms = median_ms(lambda: kern(*args))
        plain_ms = median_ms(lambda: plain(*args))
        print(f"  {name} [{label}] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        results[name] = dict(max_abs_err=worst_abs, ms=ms, plain_ms=plain_ms)
    return results


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
    dy64, dy256 = act(B, H, W, 64, scale=1e-3), act(B, H, W, 256, scale=1e-3)
    # name: [(label, kernel fn, plain fn, args, how output 0 is held)]; of
    # each output tuple the first item is an activation or dx ("max":
    # max|d|/max|ref| <= KERNEL_TOL, "l2": rel-L2 <= DX_L2_TOL), the rest
    # are grads (rel-L2 <= WGRAD_TOL)
    fwd, bwd = (tc.bottleneck_fwd_kernel, tc.bottleneck_plain), (
        tc.bottleneck_bwd_kernel, tc.bottleneck_bwd_plain)
    x14 = act(B, H, W, 14)
    cases = {
        "stem_fwd": [("stem", tc.stem_fwd_kernel, tc.stem_plain,
                      (x14, *stem_w), "max")],
        "stem_bwd": [
            ("stem, fixed masks", tc.stem_bwd_kernel, tc.stem_bwd_plain,
             (c_stem[0], dy64, *c_stem[1:]), "max"),
            ("stem, random", tc.stem_bwd_kernel, tc.stem_bwd_plain,
             (x14, dy64, *stem_w), "l2")],
        "bottleneck_fwd": [("block 0", *fwd, (x64, *blk0), "max"),
                           ("block 1", *fwd, (x256, *blk1), "max")],
        "bottleneck_bwd": [
            ("block 0, fixed masks", *bwd, (c_blk0[0], dy256, *c_blk0[1:]),
             "max"),
            ("block 1, fixed masks", *bwd, (c_blk1[0], dy256, *c_blk1[1:]),
             "max"),
            ("block 0, random", *bwd, (x64, dy256, *blk0), "l2"),
            ("block 1, random", *bwd, (x256, dy256, *blk1), "l2")],
        "ups_head_1x1": [("heads", k4.ups_head_1x1, k4.ups_head_1x1_plain,
                          (x64, p1, p2, w1, b1), "max")],
    }
    results = {}
    for name, variants in cases.items():
        worst_abs, worst_rel, worst_dx_l2, worst_l2 = 0.0, 0.0, 0.0, 0.0
        for label, kern, plain, args, hold in variants:
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
        label, kern, plain, args, _ = variants[-1]
        ms = median_ms(lambda: kern(*args), iters=5, reps=3)
        plain_ms = median_ms(lambda: plain(*args), iters=5, reps=3)
        print(f"  {name} [{label}] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        results[name] = dict(max_abs_err=worst_abs, ms=ms, plain_ms=plain_ms)
    return results


CFG = Config(model="InterNet", coarse_model="HRNet", syn_type="inter",
             compute_dtype="bfloat16")


def _inputs(dev, b, h, w, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    imgs = [torch.rand((b, h, w, 3), generator=g, device=dev) for _ in range(2)]
    ids = [torch.randint(0, 20, (b, h, w), generator=g, device=dev,
                         dtype=torch.uint8) for _ in range(2)]
    return imgs, ids


def slice_phase(dev):
    b, h, w = 2, 128, 256
    fast = registry.build_model(CFG, device=dev, seed=0)
    plain = registry.build_model(CFG, device=dev, seed=0, use_kernels=False)
    imgs, ids = _inputs(dev, b, h, w, 1)
    rgb = torch.cat(imgs, -1) * 2 - 1
    seg = torch.cat([serve.seg_oh(i) for i in ids], -1)
    r_k, s_k = serve.forward(fast, rgb, seg)
    r_p, s_p = serve.forward(plain, rgb, seg)
    torch.cuda.synchronize()
    d = (r_k.float() - r_p.float()).abs().max().item()
    bound = SLICE_RGB_TOL * max(1.0, r_p.float().abs().max().item())
    agree = (s_k.argmax(-1) == s_p.argmax(-1)).float().mean().item()
    print(f"slice 2x128x256 bf16: rgb max|d|={d:.6g} (bound {bound:.4g}), "
          f"seg argmax agreement {agree:.6f} (bound {SLICE_SEG_AGREE})")
    if not (torch.isfinite(r_k).all() and torch.isfinite(s_k).all()):
        raise AssertionError("slice: non-finite output")
    if d > bound:
        raise AssertionError(f"slice: rgb max|d| {d:.4g} > {bound:.4g}")
    if agree < SLICE_SEG_AGREE:
        raise AssertionError(f"slice: seg agreement {agree:.4f} < "
                             f"{SLICE_SEG_AGREE}")


def serve_phase(dev, card):
    b, h, w, steps = 2, 512, 1024, 3
    model = registry.build_model(CFG, device=dev, seed=0)
    imgs, ids = _inputs(dev, b, h, w, 2)
    serve.rollout(model, imgs, ids, 1)               # warm-up
    torch.cuda.synchronize()
    hw.reset_counters()
    t0 = time.perf_counter()
    preds, pred_ids = serve.rollout(model, imgs, ids, steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(hw.launches)
    for name, per in PER_FORWARD.items():
        if counts[name] != per * steps:
            raise AssertionError(f"serve: {name} launched {counts[name]} "
                                 f"times, expected {per} x {steps}")
    for p, i in zip(preds, pred_ids):
        if p.shape != (b, h, w, 3) or not torch.isfinite(p.float()).all():
            raise AssertionError("serve: bad predicted frame")
        if i.shape != (b, h, w) or int(i.max()) >= 20:
            raise AssertionError("serve: bad seg ids")
    fps = b * steps / dt
    print(f"serve rollout {steps} steps at {b}x{h}x{w} bf16: {dt:.4f} s, "
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


def _train_chain_leaf(name: str) -> bool:
    """The stem (conv1, conv2) and layer1 leaves: the train chain's."""
    return name.startswith(("coarse_model.conv1.", "coarse_model.conv2.",
                            "coarse_model.layer1."))


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


def grad_check(dev, b, h, w):
    """Phase 5a: one step's gradients and losses, kernel vs plain.  The
    whole gradient is held, then each stem and layer1 leaf on its own:
    the train chain's leaves are a small part of the whole norm, so an
    error there would hide in it."""
    batch = train_batch(dev, b, h, w, seed=4)
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
    print(f"train step {b}x{h}x{w}:")
    leaves = [n for n in g_ref if _train_chain_leaf(n)]
    if len(leaves) != 17:          # conv1/conv2 w+b, 4 x 3 convs, 1 downsample
        raise AssertionError(f"train: {len(leaves)} stem/layer1 leaves, "
                             "expected 17")
    fails = [_check_grad("whole gradient", _flat(g_k), _flat(g_p),
                         _flat(g_ref))]
    fails += [_check_grad(n, g_k[n], g_p[n], g_ref[n]) for n in leaves]
    fails = [f for f in fails if f]
    if fails:
        raise AssertionError("train: " + "; ".join(fails))
    for k in l_p:
        rel = abs(l_k[k] - l_p[k]) / max(abs(l_p[k]), 1e-30)
        print(f"  {k}: kernel {l_k[k]:.6g} plain {l_p[k]:.6g} rel {rel:.3g}")
        if rel > LOSS_TOL:
            raise AssertionError(f"train: {k} differs by {rel:.4g} > "
                                 f"{LOSS_TOL}")


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
    b, h, w = 24, 128, 128
    grad_check(dev, b, h, w)
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
    for name, per in PER_TRAIN_STEP.items():
        if counts[name] != per:
            raise AssertionError(f"train: {name} launched {counts[name]} "
                                 f"times in one step, expected {per}")
    return counts


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
    train_counts = train_phase(dev, card)
    print(json.dumps({"kernels": [
        dict(name=n, route=META[n][0], source=META[n][1],
             replaces=META[n][2], launches=counts[n] + train_counts[n],
             max_abs_err=kernels[n]["max_abs_err"], ms=kernels[n]["ms"],
             plain_ms=kernels[n]["plain_ms"]) for n in META]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
