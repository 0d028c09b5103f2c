"""The port imports no jax, flax or optax, nor any module of the JAX package,
directly or through another module: a fresh interpreter with those modules
blocked imports every module of the port (the train modules included) and
runs the CPU forward, a rollout and two INTER train steps at 32x64, a
``--highres_large`` rollout step, an InterStage3Net rollout step, a train
and an eval step of the refine stages (RefineUnet under InterRefineNet;
SRNRefine at ``--n_sc 3`` with V2 ``--stage3_prop``, and at ``--n_sc 2``
with V1 ``--stage3_prop``, under InterStage3Net), the
BasicBlock chain forward and backward, a VideoVAE eval forward (``--model
VAE``, two warped steps at 32x32) and its legacy train step
(``train/legacy.make_vae_train_step``), the legacy simple step on MyFRRN
and the shifted add; then the launcher
(``cli.main.run(cfg, device="cpu")``) at 32x64: one epoch of 2 steps on a
Cityscapes-layout PNG tree it writes (``--nw 2``), ``--split val`` on that
epoch's checkpoint, and ``--split cycgen`` on synthetic data; and recipe
4 through the launcher on synthetic data (InterGANNet, VAEHRNet and the
recipe's four discriminator families at ``--n_track 2``): one epoch of 8
steps, ``--split val`` on its checkpoint and ``--split cycgen``; and recipe
6 through the launcher (ExtraNet, ``--num_pred_step 3``): one epoch of 8
steps, ``--split val`` on its checkpoint and ``--split cycgen``; and the
rest of recipe 4: the track-object variant (``--track_obj_loss
--track_obj_w 8 --track_gen --track_gen_model TrackGenV2``, GlobalMask as
its det family) through the launcher, one epoch and val, each of the
seven newer det discriminators and TrackGen in one train step, and the
plain VAE (ExtraNet on a VAEHRNet) through the launcher, one epoch and
val; and one forward at 1x32x64 of SRN4, SRN4Sharp, HResUnet, AttnRefine,
MSBaseRefine (``models/srn_legacy``), OpticalRefineNet and AttnRefineV2O,
V3 and V4 (``models/attn_legacy``).  Pillow and
TensorBoard are blocked too, as the card's machine has neither: the PNGs go
through ``native/png.py`` and the runner logs without a writer.  A second
interpreter, blocked alike, runs the vimeo triplet set through the
launcher (train under ``--coarse_o sgd``, val, cycgen) on the fused PNG
path, and the host tools ``tools/build_clips`` and ``utils/flow_vis``."""

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
torch.set_num_threads(2)     # a fair share beside the other test workers
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
for kw in (dict(model="InterRefineNet", refine_model="refineUnet",
                train_refine=True),
           dict(model="InterStage3Net", refine_model="SRNRefine", n_scales=3,
                stage3_model="MSResAttnRefineV2", stage3_prop=True,
                train_stage3=True),
           dict(model="InterStage3Net", refine_model="SRNRefine", n_scales=2,
                stage3_model="MSResAttnRefine", stage3_prop=True,
                train_stage3=True)):
    rcfg = dataclasses.replace(cfg, train_coarse=False, **kw)
    rmodel = registry.build_model(rcfg, device="cpu", seed=3)
    rstate = state_lib.create_train_state(rcfg, rmodel)
    rstate, rl = inter.make_train_step(rcfg, rmodel)(rstate, batch)
    assert rstate.step == 1 and torch.isfinite(rl["loss_all"]), kw
    rm = inter.make_eval_step(rcfg, rmodel)(rstate, batch)
    assert list(rm)[-3:] == [f"{{list(rm)[-1].split('_')[0]}}_{{k}}"
                             for k in ("l1", "psnr", "ssim")]
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
from {pkg}.train import legacy
vcfg = Config(model="VAE", vid_length=2, input_h=32, input_w=32,
              compute_dtype="float32")
vstate = state_lib.create_train_state(vcfg, vae, vgg)
vbatch = dict(frames=rgb_seq, segs=torch.randint(
    0, 20, (1, 3, 32, 32), generator=g, dtype=torch.uint8),
    fg_masks=fg, bg_masks=1 - fg)
vstep = legacy.make_vae_train_step(vcfg, vae, torch.Generator().manual_seed(2))
vstate, vl = vstep(vstate, vbatch)
assert vstate.step == 1 and torch.isfinite(vl["loss_all"])
assert list(vl) == ["recon_warp_loss", "recon_refine_loss", "kld_loss",
                    "vgg_loss", "flow_consist_loss", "loss_all"]
lcfg = dataclasses.replace(cfg, model="MyFRRN")
frrn = registry.build_model(lcfg, device="cpu", seed=3)
lstate = state_lib.create_train_state(lcfg, frrn, vgg)
lstate, ll = legacy.make_simple_train_step(lcfg, frrn)(lstate, batch)
assert lstate.step == 1 and torch.isfinite(ll["loss_all"])
assert "gen_ce_loss" in ll
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
gan = ("INTER --model InterGANNet --load_model InterGANNet --coarse_model "
       "VAEHRNet --train_coarse --vae --gan --frame_disc --frame_disc_model "
       "FrameSNDiscriminator --train_frame_disc --video_disc "
       "--video_disc_model VideoSNDiscriminator --train_video_disc "
       "--frame_det_disc --frame_det_disc_model FrameSNDetDiscriminator "
       "--train_frame_det_disc --video_det_disc --video_det_disc_model "
       "VideoLSSNDetDiscriminator --train_video_det_disc")
syn = f"{{g}} --dataset synthetic --n_track 2 --vgg_w 0 --s 4"
gexp = os.path.join(tmp, "gan")
run(parse_args(f"{{syn}} --split train {{gan}}".split()), exp_dir=gexp,
    device="cpu")
assert os.listdir(os.path.join(gexp, "checkpoint")) == [
    "InterGANNet_xs2xs_inter_4_1_0"]
log = open(os.path.join(gexp, "experiment_train.log")).read()
assert "[iter    7]" in log and "nan" not in log.split("[iter    7]")[1][:40]
metrics = run(parse_args(f"{{syn}} --split val --load_dir {{gexp}} "
                         f"--checksession 4 --checkepoch 1 {{gan}} "
                         "--load_coarse".split()),
              exp_dir=os.path.join(tmp, "gval"), device="cpu")
assert np.isfinite(metrics["coarse_psnr"])
out = run(parse_args(f"{{syn}} --split cycgen {{gan}}".split()),
          exp_dir=os.path.join(tmp, "gcyc"), device="cpu")
assert png.read_png(os.path.join(out, "clip_00000", "rgb", "001.png"),
                    3).shape == (32, 64, 3)
ex = f"{{syn}} --syn_type extra".replace("--syn_type inter ", "")
r6 = "EXTRA --model ExtraNet --train_coarse --num_pred_step 3"
eexp = os.path.join(tmp, "extra")
run(parse_args(f"{{ex}} --split train {{r6}}".split()), exp_dir=eexp,
    device="cpu")
assert os.listdir(os.path.join(eexp, "checkpoint")) == [
    "ExtraNet_xs2xs_extra_4_1_0"]
log = open(os.path.join(eexp, "experiment_train.log")).read()
assert "[iter    7]" in log and "nan" not in log.split("[iter    7]")[1][:40]
metrics = run(parse_args(f"{{ex}} --split val --load_dir {{eexp}} "
                         f"--checksession 4 --checkepoch 1 {{r6}} "
                         "--load_coarse".split()),
              exp_dir=os.path.join(tmp, "eval"), device="cpu")
assert np.isfinite(metrics["step_2_frame_0_coarse_psnr"])
out = run(parse_args(f"{{ex}} --split cycgen {{r6}}".split()),
          exp_dir=os.path.join(tmp, "ecyc"), device="cpu")
assert png.read_png(os.path.join(out, "clip_00000", "rgb", "004.png"),
                    3).shape == (32, 64, 3)
# the rest of recipe 4: the track-object variant with TrackGenV2 and the
# GlobalMask det family through the launcher (an epoch, its checkpoint
# holding the track generator and its Adamax, val), each of the seven
# newer det discriminators and TrackGen in one step; the plain VAE
# (ExtraNet on a VAEHRNet) through the launcher
tobj = ("INTER --model InterGANNet --load_model InterGANNet --coarse_model "
        "VAEHRNet --train_coarse --vae --gan "
        "--track_gen --track_gen_model TrackGenV2 --video_det_disc "
        "--video_det_disc_model VideoGlobalMaskSNDetDiscriminator "
        "--train_video_det_disc")
tsyn = f"{{syn}} --track_obj_loss --track_obj_w 8"
texp = os.path.join(tmp, "tobj")
run(parse_args(f"{{tsyn}} --split train {{tobj}}".split()), exp_dir=texp,
    device="cpu")
ck = torch.load(os.path.join(texp, "checkpoint", "InterGANNet_xs2xs_inter_4_1_0"),
                weights_only=True)
assert "track_gen_model" in ck and "track_gen_optimizer" in ck
log = open(os.path.join(texp, "experiment_train.log")).read()
assert "[iter    7]" in log and "nan" not in log.split("[iter    7]")[1][:40]
metrics = run(parse_args(f"{{tsyn}} --split val --load_dir {{texp}} "
                         f"--checksession 4 --checkepoch 1 {{tobj}} "
                         "--load_coarse".split()),
              exp_dir=os.path.join(tmp, "tval"), device="cpu")
assert np.isfinite(metrics["coarse_psnr"])
from {pkg}.data.synthetic import synthetic_batch
from {pkg}.models import detdisc
from {pkg}.train import inter_gan
sb = {{k: torch.from_numpy(v) for k, v in synthetic_batch(
    2, 32, 64, n_track=2, seed=1).items()}}
for kw in ([dict(video_det_disc_model=n) for n in sorted(detdisc.CLASSES)
            if n.startswith("Video") and n not in (
                "VideoDetDiscriminator", "VideoSNDetDiscriminator",
                "VideoLSSNDetDiscriminator")]
           + [dict(track_gen=True, track_gen_model="TrackGen")]):
    gcfg = parse_args(f"{{syn}} --split train {{gan}}".split()).replace(
        frame_disc=False, frame_det_disc=False, video_disc=False, **kw)
    gm = registry.build_model(gcfg, device="cpu", seed=3)
    gs = state_lib.create_train_state(gcfg, gm)
    gs, gl = inter_gan.make_train_step(gcfg, gm, torch.Generator())(gs, sb)
    assert torch.isfinite(gl["loss_all"]), kw
# the EXTRA parser offers --coarse_model HRNet only, as the JAX one: the
# plain VAE goes through run() with the Config's coarse_model replaced
vexp = os.path.join(tmp, "pvae")
pv = "EXTRA --model ExtraNet --train_coarse --num_pred_step 2"
run(parse_args(f"{{ex}} --split train {{pv}}".split()).replace(
    coarse_model="VAEHRNet"), exp_dir=vexp, device="cpu")
log = open(os.path.join(vexp, "experiment_train.log")).read()
assert "[iter    7]" in log and "nan" not in log.split("[iter    7]")[1][:40]
metrics = run(parse_args(f"{{ex}} --split val --load_dir {{vexp}} "
                         f"--checksession 4 --checkepoch 1 {{pv}} "
                         "--load_coarse".split()).replace(
                             coarse_model="VAEHRNet"),
              exp_dir=os.path.join(tmp, "pval"), device="cpu")
assert np.isfinite(metrics["step_1_frame_0_coarse_psnr"])
# the SRN-era refiners, the legacy attention refiners (the L2 and the
# padded cosine windows) and the voxel-flow nets: one f32 forward each at
# 1x32x64 on seeded weights
from {pkg}.models import attn_legacy, optical, srn_legacy
f32 = torch.float32
zg = torch.Generator().manual_seed(11)
x3 = torch.rand(1, 32, 64, 3, generator=zg) * 2 - 1
nb6 = torch.rand(1, 32, 64, 6, generator=zg) * 2 - 1
zoo = [(srn_legacy.SRN4(n_scales=2, dtype=f32), (x3,)),
       (srn_legacy.SRN4Sharp(high_res=True, dtype=f32), (x3, None, nb6)),
       (srn_legacy.HResUnet(dtype=f32),
        (None, torch.zeros(1, 16, 32, 32), x3)),
       (srn_legacy.AttnRefine(dtype=f32), (x3, None, nb6)),
       (srn_legacy.MSBaseRefine(cin=9, dtype=f32), (x3, None, nb6)),
       (optical.OpticalRefineNet(dtype=f32), (nb6,)),
       (attn_legacy.AttnRefineV2O(dtype=f32), (x3, nb6)),
       (attn_legacy.AttnRefineV3(dtype=f32), (x3, nb6)),
       (attn_legacy.AttnRefineV4(dtype=f32), (x3, nb6))]
for m, args in zoo:
    with torch.no_grad():
        out = registry.init_weights(m, 5)(*args)
    leaves = [t for t in torch.utils._pytree.tree_leaves(out)
              if isinstance(t, torch.Tensor)]
    assert leaves and all(torch.isfinite(t).all() for t in leaves), m
assert not any(sys.modules.get(n) for n in BLOCKED)
print("modules", len(names))
"""


TRIPLET_SCRIPT = r"""
import os, pickle, sys, tempfile
BLOCKED = ("jax", "jaxlib", "flax", "optax",
           "deep_video_interpolation_extrapolation_tpu", "PIL", "tensorboardX",
           "tensorboard")
for name in BLOCKED:
    sys.modules[name] = None
import numpy as np
import torch
torch.set_num_threads(2)
from {pkg}.cli.main import run
from {pkg}.cli.options import parse_args
from {pkg}.native import host, png
from {pkg}.tools import build_clips
from {pkg}.utils import flow_vis
tmp = tempfile.mkdtemp()
rs = np.random.RandomState(0)
rows = [f"0000{{i}}/0001" for i in range(4)]
for row in rows:
    os.makedirs(os.path.join(tmp, "sequences", row))
    for i in range(3):
        png.save_png(os.path.join(tmp, "sequences", row, f"im{{i + 1}}.png"),
                     rs.randint(0, 256, (32, 64, 3)).astype(np.uint8))
for name in ("tri_trainlist.txt", "tri_testlist.txt"):
    with open(os.path.join(tmp, name), "w") as f:
        f.write("\n".join(rows) + "\n")
g = (f"--dataset vimeo --img_dir {{tmp}} --mode xx2x --syn_type inter "
     "--input_h 32 --input_w 64 --bs 2 --epochs 1 --nw 2 --disp_interval 1 "
     "--compute_dtype float32 --vgg_w 0")
exp = os.path.join(tmp, "exp")
host.reset_counts()
run(parse_args(f"{{g}} --split train INTER --model InterNet --train_coarse "
               "--coarse_o sgd".split()), exp_dir=exp, device="cpu")
log = open(os.path.join(exp, "experiment_train.log")).read()
assert "[iter    1]" in log and "nan" not in log.split("[iter    1]")[1][:40]
assert host.counts == {{"fused": 12, "numpy": 0, "other": 0}}, host.counts
metrics = run(parse_args(f"{{g}} --split val --load_dir {{exp}} --checksession "
                         "0 --checkepoch 1 INTER --model InterNet "
                         "--load_coarse".split()),
              exp_dir=os.path.join(tmp, "val"), device="cpu")
assert np.isfinite(metrics["coarse_psnr"]) and "coarse_iou" not in metrics
out = run(parse_args(f"{{g}} --split cycgen INTER --model InterNet".split()),
          exp_dir=os.path.join(tmp, "cyc"), device="cpu")
assert png.read_png(os.path.join(out, "clip_00000", "seg", "000.png"),
                    1).max() == 0
clips = {{"test": [["t/s/s_000000_{{:06d}}".format(i) for i in range(3)]]}}
with open(os.path.join(tmp, "root.pkl"), "wb") as f:
    pickle.dump(clips, f)
build_clips.main(["interp", os.path.join(tmp, "root.pkl"),
                  os.path.join(tmp, "interp.pkl"), "--interval", "1"])
assert len(pickle.load(open(os.path.join(tmp, "interp.pkl"), "rb"))["test"]) == 1
assert flow_vis.flow_to_image(rs.normal(size=(4, 4, 2))).shape == (4, 4, 3)
assert not any(sys.modules.get(n) for n in BLOCKED)
print("ok")
"""


def test_triplet_path_runs_without_jax():
    """The vimeo set through the launcher (an epoch of 2 steps under
    ``--coarse_o sgd``, every frame on the fused PNG path, ``--split val``
    without ``coarse_iou``, ``--split cycgen`` writing class 0 for the
    frames with no segmentation), ``tools/build_clips`` and
    ``utils/flow_vis``, with jax, the JAX package, Pillow and TensorBoard
    blocked."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", TRIPLET_SCRIPT.format(pkg=PKG)],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.split()[-1] == "ok", proc.stdout[-2000:]


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(pkg=PKG)], cwd=str(ROOT),
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    n = int(proc.stdout.split("modules")[-1])
    assert n >= 30, proc.stdout
