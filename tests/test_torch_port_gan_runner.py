"""Recipe 4 (``docs/RECIPES.md:42-62``) through the port's launcher on the
CPU at a small size (B=2 32x64 f32, ``--n_track 2``, ``--vgg_w 0``: the
VGG19 cannot take 32x64's 1/4 scale), and recipe 5's validation sweep:

- two epochs with a checkpoint each, under the JAX package's names
  (``train/checkpoint.checkpoint_name``), each holding the coarse model,
  every discriminator (its spectral-norm ``u`` and ``sigma`` among its
  buffers) and every optimizer (Adamax, Adam) under the reference's
  submodel names;
- ``--r`` from the epoch-1 checkpoint: the resumed epoch's losses equal
  the uninterrupted run's (1e-5 relative; the generator's draws of an
  epoch follow from ``--seed`` and the epoch);
- the ``--checkepoch_range`` sweep reloads each checkpoint, and its
  epoch-2 metrics equal a fresh ``--split val`` run's on that checkpoint;
- ``--split cycgen`` writes the rgb / seg / seg_vis tree of the VAEHRNet
  generator.
"""

import glob
import os
import re

import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.core.config import (
    Config as JConfig,
)
from deep_video_interpolation_extrapolation_tpu.train import (
    checkpoint as jckpt,
)
from deep_video_interpolation_extrapolation_tpu_torch.cli.main import run
from deep_video_interpolation_extrapolation_tpu_torch.cli.options import (
    parse_args,
)
from deep_video_interpolation_extrapolation_tpu_torch.native import png

torch.set_num_threads(2)

GLOBAL = ("--dataset synthetic --input_h 32 --input_w 64 --bs 2 "
          "--disp_interval 1 --compute_dtype float32 --syn_type inter "
          "--mode xs2xs --kld_w 20 --n_track 2 --vgg_w 0 --s 24")
GAN = ("INTER --model InterGANNet --coarse_model VAEHRNet --train_coarse "
       "--vae --gan "
       "--frame_disc --frame_disc_model FrameSNDiscriminator "
       "--train_frame_disc --frame_disc_g_w 0.4 --frame_disc_d_w 0.001 "
       "--frame_disc_lr 0.0001 "
       "--video_disc --video_disc_model VideoSNDiscriminator "
       "--train_video_disc --video_disc_g_w 0.4 --video_disc_d_w 0.001 "
       "--video_disc_lr 0.0001 "
       "--frame_det_disc --frame_det_disc_model FrameSNDetDiscriminator "
       "--train_frame_det_disc --frame_det_disc_g_w 0.4 "
       "--frame_det_disc_d_w 0.001 --frame_det_disc_lr 0.0001 "
       "--video_det_disc --video_det_disc_model VideoLSSNDetDiscriminator "
       "--train_video_det_disc --video_det_disc_g_w 0.4 "
       "--video_det_disc_d_w 0.01 --video_det_disc_lr 0.0001")
LOSS = re.compile(r"\[epoch +(\d+)\]\[iter +(\d+)\] loss: ([-0-9.naif]+)")
SUBMODELS = ["coarse_model", "frame_disc_model", "frame_det_disc_model",
             "video_disc_model", "video_det_disc_model"]


def _losses(exp):
    text = open(os.path.join(exp, "experiment_train.log")).read()
    return {(int(e), int(i)): float(v) for e, i, v in LOSS.findall(text)}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gan")
    full = str(tmp / "full")
    run(parse_args(f"{GLOBAL} --epochs 2 --split train {GAN}".split()),
        exp_dir=full, device="cpu")
    resumed = str(tmp / "resumed")
    run(parse_args((f"{GLOBAL} --epochs 2 --split train --r --checkepoch 1 "
                    f"--checksession 24 --load_dir {full} {GAN} "
                    "--load_model InterGANNet").split()),
        exp_dir=resumed, device="cpu")
    return tmp, full, resumed


def test_epochs_write_the_reference_checkpoints(trained):
    _, full, _ = trained
    cfg = parse_args(f"{GLOBAL} --split train {GAN}".split())
    jcfg = JConfig(model=cfg.model, mode=cfg.mode, syn_type=cfg.syn_type,
                   session=cfg.session)
    names = sorted(os.listdir(os.path.join(full, "checkpoint")))
    assert names == [jckpt.checkpoint_name(jcfg, e, 0) for e in (1, 2)]
    assert names[0] == "InterGANNet_xs2xs_inter_24_1_0"
    ckpt = torch.load(os.path.join(full, "checkpoint", names[1]),
                      weights_only=True)
    assert ckpt["epoch"] == 3
    for name in SUBMODELS:
        assert name in ckpt, name
        opt = ckpt[name[:-len("_model")] + "_optimizer"]
        assert opt["param_groups"][0]["lr"] == (
            1e-3 if name == "coarse_model" else 1e-4)
    sn = [k for k in ckpt["video_det_disc_model"] if k.endswith(".u")]
    assert len(sn) == 15 and any(k.endswith("sigma")
                                 for k in ckpt["frame_disc_model"])
    losses = _losses(full)
    assert sorted(losses) == [(e, i) for e in (1, 2) for i in range(8)]
    assert all(np.isfinite(v) for v in losses.values())


def test_resume_continues_the_run(trained):
    _, full, resumed = trained
    ref, ours = _losses(full), _losses(resumed)
    assert sorted(ours) == [(2, i) for i in range(8)]
    for key, v in ours.items():
        assert abs(v - ref[key]) <= 1e-5 * abs(ref[key]), (key, v, ref[key])


def test_validation_sweep_reloads_each_checkpoint(trained):
    """Recipe 5: ``--split val --checkepoch_range`` over the run, then one
    ``--load_coarse`` validation of the epoch-2 checkpoint."""
    tmp, full, _ = trained
    sweep = parse_args((f"{GLOBAL} --split val --load_dir {full} "
                        "--checksession 24 --checkepoch_range "
                        "--checkepoch_low 1 --checkepoch_up 2 INTER --model "
                        "InterGANNet --load_model InterGANNet --coarse_model "
                        "VAEHRNet --load_coarse --vae --gan").split())
    results = run(sweep, exp_dir=str(tmp / "sweep"), device="cpu")
    assert sorted(results) == [1, 2] and results[1] != results[2]
    assert {"coarse_l1", "coarse_psnr", "coarse_ssim", "coarse_iou"} <= set(
        results[2])
    one = parse_args((f"{GLOBAL} --split val --load_dir {full} "
                      "--checksession 24 --checkepoch 2 INTER --model "
                      "InterGANNet --load_model InterGANNet --coarse_model "
                      "VAEHRNet --load_coarse --vae --gan").split())
    assert run(one, exp_dir=str(tmp / "one"), device="cpu") == results[2]


def test_cycgen_writes_the_tree(trained):
    tmp, full, _ = trained
    cfg = parse_args((f"{GLOBAL} --split cycgen --load_dir {full} "
                      "--checksession 24 --checkepoch 2 INTER --model "
                      "InterGANNet --load_model InterGANNet --coarse_model "
                      "VAEHRNet --load_coarse --vae --gan").split())
    root = run(cfg, exp_dir=str(tmp / "cyc"), device="cpu")
    files = sorted(glob.glob(os.path.join(root, "clip_*", "*", "*.png")))
    clips = sorted(glob.glob(os.path.join(root, "clip_*")))
    assert clips and len(files) == 9 * len(clips)
    rgb = png.read_png(os.path.join(clips[0], "rgb", "001.png"), 3)
    assert rgb.shape == (32, 64, 3)
    ids = png.read_png(os.path.join(clips[0], "seg", "001.png"), 1)
    assert ids.max() < 20
