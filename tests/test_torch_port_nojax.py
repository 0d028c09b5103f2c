"""The port imports no jax, flax or optax, nor any module of the JAX package,
directly or through another module: a fresh interpreter with those modules
blocked imports every module of the port (the train modules included) and
runs the CPU forward, a rollout and two INTER train steps at 32x64."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = "deep_video_interpolation_extrapolation_tpu_torch"

SCRIPT = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax",
             "deep_video_interpolation_extrapolation_tpu"):
    sys.modules[name] = None          # any import of them now fails
import torch
import {pkg}
names = sorted(m.name for m in pkgutil.walk_packages({pkg}.__path__, "{pkg}."))
for name in names:
    importlib.import_module(name)
from {pkg} import serve
from {pkg}.core.config import Config
from {pkg}.models import registry
cfg = Config(model="InterNet", coarse_model="HRNet", syn_type="inter",
             compute_dtype="float32")
model = registry.build_model(cfg, seed=3)
g = torch.Generator().manual_seed(0)
imgs = [torch.rand(1, 32, 64, 3, generator=g) for _ in range(2)]
ids = [torch.randint(0, 20, (1, 32, 64), generator=g, dtype=torch.uint8)
       for _ in range(2)]
preds, pred_ids = serve.rollout(model, imgs, ids, 2)
assert all(torch.isfinite(p).all() for p in preds)
assert all(int(i.max()) < 20 for i in pred_ids)
import dataclasses
from {pkg}.train import inter, state as state_lib
from {pkg}.train.common import init_vgg_frozen
cfg = dataclasses.replace(cfg, train_coarse=True)
state = state_lib.create_train_state(cfg, model, init_vgg_frozen(cfg, 1))
step = inter.make_train_step(cfg, model)
batch = dict(frame1=imgs[0] * 2 - 1, frame2=imgs[1] * 2 - 1,
             frame3=imgs[0] - imgs[1], seg1=ids[0], seg2=ids[1], seg3=ids[0])
for _ in range(2):
    state, losses = step(state, batch)
assert state.step == 2 and torch.isfinite(losses["loss_all"])
assert "coarse_ce_loss" in losses
assert not any(sys.modules.get(n) for n in ("jax", "flax", "optax"))
print("modules", len(names))
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(pkg=PKG)], cwd=str(ROOT),
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    n = int(proc.stdout.split("modules")[-1])
    assert n >= 26, proc.stdout
