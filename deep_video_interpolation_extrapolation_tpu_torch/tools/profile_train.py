"""Profile of one INTER train step on a CUDA card, kernel model and plain.

    python3 -m deep_video_interpolation_extrapolation_tpu_torch.tools.profile_train \
        [--recipe 1|2|3|4|6|vae] [--out DIR]

``--recipe 1`` (the default): InterNet/HRNet at full width on one seeded
24x128x128 batch (the INTER recipe, docs/RECIPES.md:11-14); ``2``:
InterRefineNet, the HRNet frozen, SRNRefine ``--n_sc 3`` trained, at
27x128x128 (:17-26); ``3``: InterStage3Net, the HRNet and SRNRefine
frozen, MSResAttnRefineV2 ``--stage3_prop`` trained, refine weights 20,
at 27x128x128 (:28-40); ``4``: InterGANNet (VAEHRNet and the four
discriminator families of the VAE-GAN recipe, its weights and learning
rates, ``--n_track 10``) at 18x128x128 (:42-62), a synthetic batch with
its boxes, the step's generator seeded; ``6``: ExtraNet/HRNet in
extrapolation, ``--num_pred_step 3`` (three forwards, back-propagation
through them; ``train/extra.make_train_step``) at 24x128x128 on a seeded
synthetic batch of 5 frames (:76-83); ``vae``: the VideoVAE (``--model
VAE``, ``--vid_len 2``) through ``train/legacy.make_vae_train_step`` at
8x128x128 on seeded smooth frames, eps from a seeded generator.  bf16
compute with f32 masters, frozen VGG19
from a seed, Adamax; the same setups as ``chip_smoke.py``'s train and
recipe phases.  For each model
(``use_kernels`` True, then False): 3 warm-up steps, the mean wall time of
3 steps (host clock, synchronized), the peak device memory of those steps,
then one step under ``torch.profiler``: the time of every device event
(kernels, copies, fills; the rows do not overlap) summed, as the profiler's
own table totals it.  Prints one summary line per model, the per-step
device time of each kernel group in ``GROUPS`` (the BasicBlock chain, the
layer1 Bottleneck train chain, the stem, K4, the grid sample and its
backward), and its top ``ROWS`` device
events by time, also written to ``<out>/<model>.txt``.
The idle share is 1 - (device time / the mean wall time of the unprofiled
steps): the profiler's own host work slows the profiled step.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from deep_video_interpolation_extrapolation_tpu_torch.cli.options import (
    parse_args,
)
from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.data.synthetic import (
    synthetic_batch,
)
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.train import (
    extra,
    inter,
    inter_gan,
    legacy,
    state as state_lib,
)
from deep_video_interpolation_extrapolation_tpu_torch.train.common import (
    init_vgg_frozen,
)

B, H, W = 24, 128, 128
ROWS = 30
# device events of kernel groups, by a part of their names: the BasicBlock
# chain (csrc/trainchain_basicblock.cu: bb_kernel, and its weight-grad
# kernel, told from the others by its jobs struct GJobs), the layer1
# Bottleneck (csrc/trainchain_bottleneck.cu: front_kernel, back_kernel and
# its weight-grad kernel, the one whose first argument is a bf16 pointer),
# the stem (csrc/trainchain_stem.cu: its forward, backward and weight-grad
# kernels, all named stem_*), K4's taps and h modes (csrc/upshead.cu)
GROUPS = {"BasicBlock chain": ("bb_kernel", "GJobs"),
          "Bottleneck": ("::front_kernel", "::back_kernel",
                         "::wgrad_kernel(__nv_bfloat16"),
          "stem": ("::stem_",),
          "K4": ("ups_head_kernel",),
          "grid sample": ("::warp_kernel",),
          "grid sample backward": ("::warp_bwd_kernel",)}
CFG = Config(model="InterNet", coarse_model="HRNet", syn_type="inter",
             compute_dtype="bfloat16", train_coarse=True)
_R2 = dict(model="InterRefineNet", train_coarse=False, refine=True,
           refine_model="SRNRefine", n_scales=3, train_refine=True)
RECIPES = {"1": (CFG, B),
           "2": (dataclasses.replace(CFG, **_R2), 27),
           "vae": (Config(model="VAE", vid_length=2, input_h=H, input_w=W,
                          compute_dtype="bfloat16"), 8),
           "3": (dataclasses.replace(
               CFG, **{**_R2, "model": "InterStage3Net",
                       "train_refine": False, "stage3": True,
                       "stage3_model": "MSResAttnRefineV2",
                       "stage3_prop": True, "train_stage3": True,
                       "refine_l1_weight": 20.0, "refine_gdl_weight": 20.0,
                       "refine_vgg_weight": 20.0,
                       "refine_ssim_weight": 20.0}), 27),
           "4": (parse_args((
               "--syn_type inter --mode xs2xs --input_h 128 --input_w 128 "
               "--bs 18 --kld_w 20 --n_track 10 INTER --model InterGANNet "
               "--coarse_model VAEHRNet --train_coarse --vae --gan "
               "--frame_disc --frame_disc_model FrameSNDiscriminator "
               "--train_frame_disc --frame_disc_g_w 0.4 --frame_disc_d_w "
               "0.001 --frame_disc_lr 0.0001 --video_disc --video_disc_model "
               "VideoSNDiscriminator --train_video_disc --video_disc_g_w 0.4 "
               "--video_disc_d_w 0.001 --video_disc_lr 0.0001 "
               "--frame_det_disc --frame_det_disc_model "
               "FrameSNDetDiscriminator --train_frame_det_disc "
               "--frame_det_disc_g_w 0.4 --frame_det_disc_d_w 0.001 "
               "--frame_det_disc_lr 0.0001 --video_det_disc "
               "--video_det_disc_model VideoLSSNDetDiscriminator "
               "--train_video_det_disc --video_det_disc_g_w 0.4 "
               "--video_det_disc_d_w 0.01 --video_det_disc_lr 0.0001")
               .split()), 18),
           "6": (parse_args((
               "--syn_type extra --mode xs2xs --input_h 128 --input_w 128 "
               "--bs 24 EXTRA --model ExtraNet --coarse_model HRNet "
               "--train_coarse --num_pred_step 3").split()), B)}


def _vae_batch(dev, b, t):
    """T+1 smooth frames in [0, 1] (bilinear upsamplings of 8x8 fields),
    uint8 seg ids, complementary masks (chip_smoke's VAE train batch)."""
    g = torch.Generator(device=dev).manual_seed(5)
    coarse = torch.rand((b * (t + 1), 3, 8, 8), generator=g, device=dev)
    frames = torch.nn.functional.interpolate(
        coarse, size=(H, W), mode="bilinear", align_corners=False)
    fg = (torch.rand((b, t + 1, H, W, 1), generator=g, device=dev)
          > 0.5).float()
    return {"frames": frames.permute(0, 2, 3, 1).reshape(b, t + 1, H, W, 3),
            "segs": torch.randint(0, 20, (b, t + 1, H, W), generator=g,
                                  device=dev, dtype=torch.uint8),
            "fg_masks": fg, "bg_masks": 1.0 - fg}


def _batch(dev, b=B, n_track=0, vid_len=3):
    """A seeded batch; with ``n_track`` or more than 3 frames, the
    synthetic one (with its boxes: the GAN's detection discriminators read
    them)."""
    if n_track or vid_len > 3:
        return {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(
            b, H, W, vid_len=vid_len, n_track=n_track or 4, seed=5).items()}
    g = torch.Generator(device=dev).manual_seed(5)
    batch = {f"frame{i}": torch.rand((b, H, W, 3), generator=g, device=dev)
             * 2 - 1 for i in (1, 2, 3)}
    batch.update({f"seg{i}": torch.randint(0, 20, (b, H, W), generator=g,
                                           device=dev, dtype=torch.uint8)
                  for i in (1, 2, 3)})
    return batch


def _self_device_us(evt) -> float:
    """Self device time of one key_averages row, in microseconds (the
    attribute was renamed from ``self_cuda_time_total`` in torch 2.4)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _on_device(evt) -> bool:
    return (evt.device_type != DeviceType.CPU
            and not getattr(evt, "is_user_annotation", False))


def profile_model(dev, use_kernels: bool, cfg: Config = CFG, b: int = B):
    model = registry.build_model(cfg, device=dev, seed=0,
                                 use_kernels=use_kernels)
    state = state_lib.create_train_state(
        cfg, model, init_vgg_frozen(cfg, seed=1, device=dev))
    gan = cfg.model == "InterGANNet"
    steps = extra if cfg.syn_type == "extra" else inter
    gen = torch.Generator(dev).manual_seed(11)
    if cfg.model == "VAE":
        step = legacy.make_vae_train_step(cfg, model, gen)
        batch = _vae_batch(dev, b, cfg.vid_length)
    else:
        step = (inter_gan.make_train_step(cfg, model, gen) if gan
                else steps.make_train_step(cfg, model))
        vid_len = (2 + cfg.num_pred_once * cfg.num_pred_step
                   if cfg.syn_type == "extra" else 3)
        batch = _batch(dev, b, cfg.num_track_per_img if gan else 0, vid_len)
    for _ in range(3):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(3):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    avgs = sorted((e for e in prof.key_averages() if _on_device(e)),
                  key=_self_device_us, reverse=True)
    device_ms = sum(_self_device_us(e) for e in avgs) / 1e3
    groups = {g: sum(_self_device_us(e) for e in avgs
                     if any(k in e.key for k in keys)) / 1e3
              for g, keys in GROUPS.items()}
    lines = [f"{'device ms':>10}  {'share':>7}  {'calls':>5}  event"]
    for e in avgs[:ROWS]:
        ms = _self_device_us(e) / 1e3
        lines.append(f"{ms:10.3f}  {ms / device_ms:7.2%}  {e.count:5d}  "
                     f"{e.key[:110]}")
    return dict(wall_ms=wall_ms, peak_gib=peak_gib, prof_ms=prof_ms,
                device_ms=device_ms, groups=groups,
                idle=1 - device_ms / wall_ms,
                table="\n".join(lines))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--recipe", choices=sorted(RECIPES), default="1")
    ap.add_argument("--out", default="chiprun_out/profile_train")
    args = ap.parse_args(argv)
    cfg, b = RECIPES[args.recipe]
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    dev = torch.device("cuda:0")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for name, use_kernels in (("kernel", True), ("plain", False)):
        r = profile_model(dev, use_kernels, cfg, b)
        (out / f"{name}.txt").write_text(r["table"] + "\n")
        print(f"{name} model, recipe {args.recipe}, {b}x{H}x{W}: wall {r['wall_ms']:.3f} ms/step "
              f"(mean of 3), peak {r['peak_gib']:.3f} GiB; profiled step "
              f"{r['prof_ms']:.3f} ms, self device {r['device_ms']:.3f} ms, "
              f"idle {r['idle']:.2%}; per step: " + ", ".join(
                  f"{g} {ms:.3f} ms" for g, ms in r["groups"].items()))
        print(r["table"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
