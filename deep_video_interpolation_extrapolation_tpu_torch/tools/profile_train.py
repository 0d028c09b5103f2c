"""Profile of one INTER train step on a CUDA card, kernel model and plain.

    python3 -m deep_video_interpolation_extrapolation_tpu_torch.tools.profile_train \
        [--out chiprun_out/profile_train]

InterNet/HRNet at full width on one seeded 24x128x128 batch (the INTER
recipe), bf16 compute with f32 masters, frozen VGG19 from a seed, Adamax;
the same setup as ``chip_smoke.py``'s train phase.  For each model
(``use_kernels`` True, then False): 3 warm-up steps, the mean wall time of
3 steps (host clock, synchronized), the peak device memory of those steps,
then one step under ``torch.profiler``: the time of every device event
(kernels, copies, fills; the rows do not overlap) summed, as the profiler's
own table totals it.  Prints one summary line per model, the per-step
device time of each kernel group in ``GROUPS`` (the BasicBlock chain, the
layer1 Bottleneck train chain, the stem, K4), and its top ``ROWS`` device
events by time, also written to ``<out>/<model>.txt``.
The idle share is 1 - (device time / the mean wall time of the unprofiled
steps): the profiler's own host work slows the profiled step.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.train import (
    inter,
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
          "K4": ("ups_head_kernel",)}
CFG = Config(model="InterNet", coarse_model="HRNet", syn_type="inter",
             compute_dtype="bfloat16", train_coarse=True)


def _batch(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    batch = {f"frame{i}": torch.rand((B, H, W, 3), generator=g, device=dev)
             * 2 - 1 for i in (1, 2, 3)}
    batch.update({f"seg{i}": torch.randint(0, 20, (B, H, W), generator=g,
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


def profile_model(dev, use_kernels: bool):
    model = registry.build_model(CFG, device=dev, seed=0,
                                 use_kernels=use_kernels)
    state = state_lib.create_train_state(
        CFG, model, init_vgg_frozen(CFG, seed=1, device=dev))
    step = inter.make_train_step(CFG, model)
    batch = _batch(dev)
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
    ap.add_argument("--out", default="chiprun_out/profile_train")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    dev = torch.device("cuda:0")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for name, use_kernels in (("kernel", True), ("plain", False)):
        r = profile_model(dev, use_kernels)
        (out / f"{name}.txt").write_text(r["table"] + "\n")
        print(f"{name} model {B}x{H}x{W}: wall {r['wall_ms']:.3f} ms/step "
              f"(mean of 3), peak {r['peak_gib']:.3f} GiB; profiled step "
              f"{r['prof_ms']:.3f} ms, self device {r['device_ms']:.3f} ms, "
              f"idle {r['idle']:.2%}; per step: " + ", ".join(
                  f"{g} {ms:.3f} ms" for g, ms in r["groups"].items()))
        print(r["table"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
