"""The port imports no jax, flax or optax, nor any module of the JAX package,
directly or through another module: a fresh interpreter with those modules
blocked imports every module of the port (the train modules included) and
runs the CPU forward, a rollout and two INTER train steps at 32x64, a
``--highres_large`` rollout step, an InterStage3Net rollout step, the
BasicBlock chain forward and backward, a VideoVAE eval forward (``--model
VAE``, two warped steps at 32x32) and the shifted add; then the launcher
(``cli.main.run(cfg, device="cpu")``) at 32x64: one epoch of 2 steps on a
Cityscapes-layout PNG tree it writes (``--nw 2``), ``--split val`` on that
epoch's checkpoint, and ``--split cycgen`` on synthetic data.  Pillow and
TensorBoard are blocked too, as the card's machine has neither: the PNGs go
through ``native/png.py`` and the runner logs without a writer."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = "deep_video_interpolation_extrapolation_tpu_torch"

SCRIPT = r"""
import importlib, pkgutil, sys
# the JAX side, and what the card's machine lacks: Pillow, TensorBoard
BLOCKED = ("jax", "jaxlib", "flax", "optax",
           "deep_video_interpolation_extrapolation_tpu", "PIL", "tensorboardX",
           "tensorboard")
for name in BLOCKED:
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
model = registry.build_model(cfg, device="cpu", seed=3)
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
vgg = init_vgg_frozen(cfg, 1, device="cpu")
state = state_lib.create_train_state(cfg, model, vgg)
step = inter.make_train_step(cfg, model)
batch = dict(frame1=imgs[0] * 2 - 1, frame2=imgs[1] * 2 - 1,
             frame3=imgs[0] - imgs[1], seg1=ids[0], seg2=ids[1], seg3=ids[0])
for _ in range(2):
    state, losses = step(state, batch)
assert state.step == 2 and torch.isfinite(losses["loss_all"])
assert "coarse_ce_loss" in losses
high = registry.build_model(dataclasses.replace(cfg, highres_large=True),
                            device="cpu", seed=3)
preds, pred_ids = serve.rollout(high, imgs, ids, 1)
assert torch.isfinite(preds[0]).all() and int(pred_ids[0].max()) < 20
stage3 = registry.build_model(
    dataclasses.replace(cfg, model="InterStage3Net", refine_model="SRNRefine"),
    device="cpu", seed=3)
preds, pred_ids = serve.rollout(stage3, imgs, ids, 1)
assert torch.isfinite(preds[0]).all() and int(pred_ids[0].max()) < 20
from {pkg}.ops import bbchain
x = torch.rand(1, 8, 16, 64, generator=g, requires_grad=True)
pairs = [tuple((torch.randn(64, 64, 3, 3, generator=g) / 24).requires_grad_()
               for _ in range(2)) for _ in range(2)]
bbchain.bb_chain(x, pairs).square().sum().backward()
assert torch.isfinite(x.grad).all()
assert all(torch.isfinite(k.grad).all() for p in pairs for k in p)
vae = registry.build_model(Config(model="VAE", vid_length=2, input_h=32,
                                  input_w=32, compute_dtype="float32"),
                           device="cpu", seed=3)
rgb_seq = torch.rand(1, 3, 32, 32, 3, generator=g)
seg_seq = torch.nn.functional.one_hot(
    torch.randint(0, 20, (1, 3, 32, 32), generator=g), 20).float()
fg = (torch.rand(1, 3, 32, 32, 1, generator=g) > 0.5).float()
with torch.no_grad():
    out = vae(rgb_seq, seg_seq, 1 - fg, fg,
              generator=torch.Generator().manual_seed(1))
assert len(out) == 6 and out[0].shape == (1, 2, 32, 32, 3)
assert all(torch.isfinite(o).all() for o in out)
from {pkg}.ops import dual_head, shiftadd, warp
assert torch.isfinite(shiftadd.shifted_add_bias(
    torch.rand(1, 4, 4, 207, generator=g), torch.zeros(23))).all()
import os, pickle, tempfile
import numpy as np
from {pkg}.cli.main import run
from {pkg}.cli.options import parse_args
from {pkg}.native import png
tmp = tempfile.mkdtemp()
rs = np.random.RandomState(0)
clips = {{"train": [], "val": []}}
for split, n in (("train", 4), ("val", 2)):
    for c in range(n):
        clip = [f"{{split}}/s/c{{c}}_{{i:06d}}" for i in range(3)]
        for rel in clip:
            for d, ext, arr in (
                    ("imgs", "_leftImg8bit.png",
                     rs.randint(0, 256, (40, 72, 3)).astype(np.uint8)),
                    ("segs", "_gtFine_myseg_id.png",
                     rs.randint(0, 20, (40, 72)).astype(np.uint8))):
                path = os.path.join(tmp, d, rel + ext)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                png.save_png(path, arr)
        clips[split].append(clip)
os.makedirs(os.path.join(tmp, "load_files"))
with open(os.path.join(tmp, "load_files",
                       "int_1_len_3_max_4bb_area_3000_extra_panet_lsclip.pkl"),
          "wb") as f:
    pickle.dump(clips, f)
os.environ["DVIE_DATA_ROOT"] = tmp
g = ("--input_h 32 --input_w 64 --bs 2 --epochs 1 --nw 2 --disp_interval 1 "
     "--compute_dtype float32 --syn_type inter")
city = f"--dataset cityscape --img_dir {{tmp}}/imgs --seg_dir {{tmp}}/segs"
exp = os.path.join(tmp, "exp")
run(parse_args(f"{{g}} {{city}} --split train INTER --model InterNet "
               "--train_coarse".split()), exp_dir=exp, device="cpu")
assert os.listdir(os.path.join(exp, "checkpoint")) == [
    "InterNet_xs2xs_inter_0_1_0"]
log = open(os.path.join(exp, "experiment_train.log")).read()
assert "[iter    1]" in log and "[iter    2]" not in log, log[-2000:]
metrics = run(parse_args(f"{{g}} {{city}} --split val --load_dir {{exp}} "
                         "--checksession 0 --checkepoch 1 INTER --model "
                         "InterNet --load_coarse".split()),
              exp_dir=os.path.join(tmp, "val"), device="cpu")
assert np.isfinite(metrics["coarse_psnr"]) and 0 <= metrics["coarse_iou"] <= 1
out = run(parse_args(f"{{g}} --dataset synthetic --split cycgen INTER "
                     "--model InterNet".split()),
          exp_dir=os.path.join(tmp, "cyc"), device="cpu")
assert len(os.listdir(out)) == 8
assert png.read_png(os.path.join(out, "clip_00000", "rgb", "001.png"),
                    3).shape == (32, 64, 3)
assert not any(sys.modules.get(n) for n in BLOCKED)
print("modules", len(names))
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(pkg=PKG)], cwd=str(ROOT),
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    n = int(proc.stdout.split("modules")[-1])
    assert n >= 30, proc.stdout
