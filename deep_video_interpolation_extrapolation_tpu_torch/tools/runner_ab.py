"""The runner's epoch rate with and without its producer thread, on a CUDA
card:

    python3 -m deep_video_interpolation_extrapolation_tpu_torch.tools.runner_ab

The INTER recipe through ``train/runner.Runner`` (InterNet/HRNet at full
width, synthetic data, 24x128x128 bf16, ``b0``, ``--disp_interval 1``, 3
epochs of 8 steps) with the batches built by ``Runner._host_batches``'s
producer thread ("thread", the runner as it is) and built inline on the
thread that issues the steps ("inline"), in the order thread, inline,
inline, thread, twice; each round ends with the bare step's rate
(``train/inter.make_train_step`` on one fixed batch, batch size over the
median of 18 steps after 2 warm-ups, as ``chip_smoke.py``'s train phase
times it).  Prints, per run, each later epoch's samples/s and its log's
load and comp seconds (epoch 1 carries the build), and the card's name and
power limit.
"""

from __future__ import annotations

import contextlib
import io
import os
import re
import statistics
import subprocess
import tempfile
import time

import torch

from deep_video_interpolation_extrapolation_tpu_torch.cli.main import get_logger
from deep_video_interpolation_extrapolation_tpu_torch.cli.options import (
    parse_args,
)
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.train import (
    inter,
    runner as runner_lib,
    state as state_lib,
)
from deep_video_interpolation_extrapolation_tpu_torch.train.common import (
    init_vgg_frozen,
)

RECIPE = ("--dataset synthetic --split train --syn_type inter --input_h 128 "
          "--input_w 128 --bs 24 --disp_interval 1 --epochs 3 INTER --model "
          "InterNet --train_coarse")
EPOCH = re.compile(r"\[epoch +(\d+)\] \d+ samples in [0-9.]+s: ([0-9.]+) "
                   r"samples/s, load: ([0-9.]+)s, comp: ([0-9.]+)s")


def _inline(self, loader, depth):
    """The batches built on the caller's thread, as before the producer."""
    for batch in loader:
        yield {k: torch.from_numpy(v).pin_memory() for k, v in batch.items()}


def epochs(label, build):
    runner_lib.Runner._host_batches = build
    exp = tempfile.mkdtemp(prefix="runner_ab_")
    get_logger(exp, "train")
    cfg = parse_args(RECIPE.split())
    with contextlib.redirect_stdout(io.StringIO()):
        runner_lib.Runner(cfg, exp).train_epochs()
    with open(os.path.join(exp, "experiment_train.log")) as f:
        rows = EPOCH.findall(f.read())
    print(f"{label}: " + "; ".join(
        f"epoch {e} {rate} samples/s, load {load} s, comp {comp} s"
        for e, rate, load, comp in rows[1:]), flush=True)


def bare_rate(steps=20, warmup=2):
    cfg = parse_args(RECIPE.split())
    model = registry.build_model(cfg, seed=0)
    state = state_lib.create_train_state(cfg, model,
                                         init_vgg_frozen(cfg, seed=1))
    step = inter.make_train_step(cfg, model)
    g = torch.Generator(device="cuda").manual_seed(5)
    batch = {f"frame{i}": torch.rand((24, 128, 128, 3), generator=g,
                                     device="cuda") * 2 - 1 for i in (1, 2, 3)}
    batch.update({f"seg{i}": torch.randint(0, 20, (24, 128, 128), generator=g,
                                           device="cuda", dtype=torch.uint8)
                  for i in (1, 2, 3)})
    times = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    return 24 / statistics.median(times)


def main():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    threaded = runner_lib.Runner._host_batches
    try:
        for rnd in range(2):
            for label, build in (("thread", threaded), ("inline", _inline),
                                 ("inline", _inline), ("thread", threaded)):
                epochs(f"round {rnd} {label}", build)
            print(f"round {rnd} bare step {bare_rate():.4f} samples/s",
                  flush=True)
    finally:
        runner_lib.Runner._host_batches = threaded
    print(card)


if __name__ == "__main__":
    main()
