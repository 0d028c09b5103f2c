"""Profile of one serving forward on a CUDA card, kernel model and plain.

    python3 -m deep_video_interpolation_extrapolation_tpu_torch.tools.profile_serve \
        [--model InterNet|InterStage3Net|recipe3|VAE|highres_large|ExtraNet|ExtraInpaintNet]
        [--out DIR]

``InterStage3Net`` (the default): SRNRefine, then MSResAttnRefine at
``--n_sc 1``, over HRNet at full width on a seeded 2x512x1024 input, the
shape of ``chip_smoke.py``'s rollouts; ``recipe3``: the model recipe 3
trains (docs/RECIPES.md:28-40: SRNRefine ``--n_sc 3``, then
MSResAttnRefineV2 ``--stage3_prop``), the same input; ``InterNet``: that HRNet alone, the
same input; ``highres_large``: InterNet with the 4-branch HRNet
(``--highres_large``, the 4-part head), the same input; ``ExtraNet``:
HRNet in extrapolation (recipe 6's served model, the same input: frames 1
and 2); ``ExtraInpaintNet``: ExtraNet's coarse model with ``--inpaint
--inpaint_mask`` (its heads 24 wide: K4's 216 and the shift add's 24
instances) and InpaintUnet, the same input.  ``VAE``: the video VAE at
``--vid_len 2`` on a seeded 8x128x128 batch (``serve.predict_video``, the
code drawn from a seeded generator), the shape of ``chip_smoke.py``'s vae
phase.  Random seeded weights, bf16 compute with f32 masters.  For each
model (``use_kernels`` True, then False): 3 warm-up forwards, the mean
wall time of 5 (host clock, synchronized), for the InterStage3Nets the mean
CUDA-event time of each stage over 5 calls (the coarse HRNet; coarse +
refine, whose difference is the refine stage; the whole forward, whose
difference from that is stage 3), then one forward under
``torch.profiler``: its device events summed as in ``profile_train``.
Prints one summary line per model and its top ``ROWS`` device events by
time; every device event, by time, goes to
``<out>/<--model>_<kernel|plain>.txt``.  The idle
share is 1 - (device time / the mean wall time of the unprofiled
forwards).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from deep_video_interpolation_extrapolation_tpu_torch import serve
from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.core.seg import seg_oh
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.tools.profile_train import (
    ROWS,
    _on_device,
    _self_device_us,
)

B, H, W = 2, 512, 1024
CONFIGS = {
    "InterNet": Config(model="InterNet", coarse_model="HRNet",
                       syn_type="inter", compute_dtype="bfloat16"),
    "InterStage3Net": Config(model="InterStage3Net", coarse_model="HRNet",
                             syn_type="inter", refine_model="SRNRefine",
                             compute_dtype="bfloat16"),
    "recipe3": Config(model="InterStage3Net", coarse_model="HRNet",
                      syn_type="inter", refine_model="SRNRefine", n_scales=3,
                      stage3_model="MSResAttnRefineV2", stage3_prop=True,
                      compute_dtype="bfloat16"),
    "VAE": Config(model="VAE", vid_length=2, input_h=128, input_w=128,
                  compute_dtype="bfloat16"),
    "highres_large": Config(model="InterNet", coarse_model="HRNet",
                            syn_type="inter", compute_dtype="bfloat16",
                            highres_large=True),
    "ExtraNet": Config(model="ExtraNet", coarse_model="HRNet",
                       syn_type="extra", runner="EXTRA",
                       compute_dtype="bfloat16"),
    "ExtraInpaintNet": Config(model="ExtraInpaintNet", coarse_model="HRNet",
                              syn_type="extra", runner="EXTRA",
                              compute_dtype="bfloat16", inpaint=True,
                              inpaint_mask=True),
}
VAE_B = 8


def _inputs(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    rgb = torch.rand((B, H, W, 6), generator=g, device=dev) * 2 - 1
    ids = torch.randint(0, 20, (B, H, W, 2), generator=g, device=dev,
                        dtype=torch.uint8)
    return rgb, torch.cat([seg_oh(ids[..., 0]), seg_oh(ids[..., 1])], -1)


def _event_ms(fn, n=5) -> float:
    """Mean CUDA-event time of ``n`` calls of ``fn`` (after one more)."""
    with torch.inference_mode():
        fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def stage_ms(model, rgb, seg):
    """(coarse, refine, stage3) ms of one forward: each stage's share from
    the differences of nested calls."""
    coarse = _event_ms(lambda: model.coarse_model(rgb, seg))
    upto_refine = _event_ms(lambda: model._refine(rgb, seg))
    whole = _event_ms(lambda: model(rgb, seg))
    return coarse, upto_refine - coarse, whole - upto_refine


def _vae_inputs(dev, cfg: Config):
    g = torch.Generator(device=dev).manual_seed(2)
    shape = (VAE_B, cfg.vid_length + 1, cfg.input_h, cfg.input_w)
    rgb = torch.rand(shape + (3,), generator=g, device=dev)
    seg = torch.nn.functional.one_hot(
        torch.randint(0, 20, shape, generator=g, device=dev), 20)
    fg = torch.rand(shape + (1,), generator=g, device=dev) > 0.5
    return [a.to(torch.bfloat16) for a in (rgb, seg, ~fg, fg)]


def profile_model(dev, cfg: Config, use_kernels: bool):
    model = registry.build_model(cfg, device=dev, seed=0,
                                 use_kernels=use_kernels)
    if cfg.model == "VAE":
        inputs = _vae_inputs(dev, cfg)
        gen = torch.Generator(device=dev).manual_seed(3)

        def run():
            serve.predict_video(model, *inputs, generator=gen)
    else:
        rgb, seg = _inputs(dev)

        def run():
            serve.forward(model, rgb, seg)
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 5 * 1e3
    stages = None
    if cfg.model == "InterStage3Net":
        stages = stage_ms(model, rgb, seg)
    elif cfg.model == "ExtraInpaintNet":    # (coarse, inpaint)
        coarse = _event_ms(lambda: model.coarse_model(rgb, seg))
        stages = (coarse, _event_ms(lambda: model(rgb, seg)) - coarse)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    avgs = sorted((e for e in prof.key_averages() if _on_device(e)),
                  key=_self_device_us, reverse=True)
    device_ms = sum(_self_device_us(e) for e in avgs) / 1e3
    lines = [f"{'device ms':>10}  {'share':>7}  {'calls':>5}  event"]
    for e in avgs:
        ms = _self_device_us(e) / 1e3
        lines.append(f"{ms:10.3f}  {ms / device_ms:7.2%}  {e.count:5d}  "
                     f"{e.key[:110]}")
    return dict(wall_ms=wall_ms, stages=stages, device_ms=device_ms,
                idle=1 - device_ms / wall_ms, lines=lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=sorted(CONFIGS),
                    default="InterStage3Net")
    ap.add_argument("--out", default="chiprun_out/profile_serve")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: no CUDA device")
    dev = torch.device("cuda:0")
    cfg = CONFIGS[args.model]
    shape = (f"{VAE_B}x{cfg.input_h}x{cfg.input_w} T={cfg.vid_length}"
             if cfg.model == "VAE" else f"{B}x{H}x{W}")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for name, use_kernels in (("kernel", True), ("plain", False)):
        r = profile_model(dev, cfg, use_kernels)
        (out / f"{args.model}_{name}.txt").write_text(
            "\n".join(r["lines"]) + "\n")
        stages = ""
        if r["stages"] is not None:
            names = (("coarse", "refine", "stage3") if len(r["stages"]) == 3
                     else ("coarse", "inpaint"))
            stages = " stages by CUDA events: " + ", ".join(
                f"{n} {ms:.3f}" for n, ms in zip(names, r["stages"])) + " ms;"
        print(f"{args.model} {name} model {shape} bf16: wall "
              f"{r['wall_ms']:.3f} ms/forward (mean of 5);{stages} profiled "
              f"self device {r['device_ms']:.3f} ms, idle {r['idle']:.2%}")
        print("\n".join(r["lines"][:ROWS + 1]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
