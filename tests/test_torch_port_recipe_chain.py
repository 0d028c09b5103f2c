"""The author's stages 1-3 chained through the port's launcher
(``cli/main.run``, on the CPU): an InterNet epoch, recipe 2 loading its
coarse (``--load_dir <it> --load_coarse --load_model InterNet``), recipe
3 loading both (``--load_coarse --load_refine --load_model
InterRefineNet``), a ``--split val`` of the recipe-3 checkpoint with its
``refine_*`` and ``stage3_*`` metrics, a ``--split cycgen`` of it, and
the CLI's defaults (``--model InterRefineNet --refine``: RefineUnet).
Synthetic data, 32x64, batch 2, f32, one epoch each; the refine stages
with the VGG terms off (at 32x64 their 1/4 scales are below the VGG19's
16 pixels, tests/test_torch_port_recipe2.py).  What moves and what stays
is checked exactly; every loss and metric finite.
"""

import os
import re

import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu_torch.cli.main import run
from deep_video_interpolation_extrapolation_tpu_torch.cli.options import (
    parse_args,
)
from deep_video_interpolation_extrapolation_tpu_torch.native import png
from deep_video_interpolation_extrapolation_tpu_torch.train import (
    checkpoint as ckpt_lib,
)

torch.set_num_threads(2)

GLOBAL = ("--dataset synthetic --input_h 32 --input_w 64 --bs 2 --epochs 1 "
          "--disp_interval 1 --compute_dtype float32 --syn_type inter")
LOAD = "--checksession 0 --checkepoch 1 --checkpoint 0"
NO_VGG = "--refine_vgg_w 0"
RECIPE2 = ("INTER --model InterRefineNet --load_model InterNet --coarse_model "
           "HRNet --load_coarse --refine --refine_model SRNRefine --n_sc 3 "
           f"--train_refine {NO_VGG}")
RECIPE3 = ("INTER --model InterStage3Net --load_model InterRefineNet "
           "--coarse_model HRNet --load_coarse --load_refine --refine "
           "--refine_model SRNRefine --n_sc 3 --stage3 --stage3_model "
           "MSResAttnRefineV2 --train_stage3 --stage3_prop --refine_l1_w 20 "
           "--refine_gdl_w 20 --refine_vgg_w 0 --refine_ssim_w 20")
LOSS = re.compile(r"\[epoch +1\]\[iter +(\d+)\] loss: ([-0-9.naif]+)")


def _ckpt(exp, name):
    return ckpt_lib.load_checkpoint(os.path.join(
        ckpt_lib.checkpoint_dir(exp), f"{name}_xs2xs_inter_0_1_0"))


def _losses(exp):
    with open(os.path.join(exp, "experiment_train.log")) as f:
        return [float(v) for _, v in LOSS.findall(f.read())]


def _equal(a, b):
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chain")
    exps = {k: str(tmp / k) for k in ("a", "b", "c", "val", "cyc", "dflt")}
    run(parse_args(f"{GLOBAL} --split train INTER --model InterNet "
                   "--train_coarse".split()), exps["a"], device="cpu")
    run(parse_args(f"{GLOBAL} --vgg_w 0 --split train --load_dir {exps['a']} "
                   f"{LOAD} {RECIPE2}".split()), exps["b"], device="cpu")
    run(parse_args(f"{GLOBAL} --vgg_w 0 --split train --load_dir {exps['b']} "
                   f"{LOAD} {RECIPE3}".split()), exps["c"], device="cpu")
    val = run(parse_args(
        f"{GLOBAL} --split val --load_dir {exps['c']} {LOAD} "
        f"{RECIPE3.replace('--load_model InterRefineNet', '--load_model InterStage3Net')} "
        "--load_stage3".split()), exps["val"], device="cpu")
    cyc = run(parse_args(
        f"{GLOBAL} --split cycgen --load_dir {exps['c']} {LOAD} "
        f"{RECIPE3.replace('--load_model InterRefineNet', '--load_model InterStage3Net')} "
        "--load_stage3".split()), exps["cyc"], device="cpu")
    run(parse_args(f"{GLOBAL} --split train INTER --model InterRefineNet "
                   "--refine --train_refine".split()), exps["dflt"],
        device="cpu")
    return exps, val, cyc


def test_recipe2_trains_the_refiner_on_the_loaded_coarse(chain):
    exps, _, _ = chain
    a, b = _ckpt(exps["a"], "InterNet"), _ckpt(exps["b"], "InterRefineNet")
    assert _equal(b["coarse_model"], a["coarse_model"])
    assert b["refine_optimizer"]["state"]
    losses = _losses(exps["b"])
    assert len(losses) == 8 and all(map(np.isfinite, losses))


def test_recipe3_trains_stage3_on_the_loaded_stages(chain):
    exps, _, _ = chain
    b, c = (_ckpt(exps["b"], "InterRefineNet"),
            _ckpt(exps["c"], "InterStage3Net"))
    assert _equal(c["coarse_model"], b["coarse_model"])
    assert _equal(c["refine_model"], b["refine_model"])
    assert c["stage3_optimizer"]["state"]
    # the frozen refiner's optimizer is recipe 2's, loaded and not stepped
    assert {int(v["step"]) for v in c["refine_optimizer"]["state"].values()
            } == {8}
    losses = _losses(exps["c"])
    assert len(losses) == 8 and all(map(np.isfinite, losses))


def test_val_reports_every_stage(chain):
    _, val, _ = chain
    prefixes = [k.split("_")[0] for k in val]
    assert prefixes == ["coarse"] * 5 + ["refine"] * 4 + ["stage3"] * 4
    assert list(val)[5:9] == ["refine_l1", "refine_psnr", "refine_ssim",
                              "refine_vgg"]
    assert all(np.isfinite(v) for v in val.values())


def test_cycgen_writes_the_stage3_frames(chain):
    _, _, out_root = chain
    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(out_root)
                   for f in fs)
    assert files and all(f.endswith(".png") for f in files)
    rgb = [f for f in files if os.path.basename(os.path.dirname(f)) == "rgb"]
    assert png.read_png(rgb[1], 3).shape == (32, 64, 3)


def test_cli_defaults_train_refine_unet(chain):
    exps, _, _ = chain
    ckpt = _ckpt(exps["dflt"], "InterRefineNet")
    assert any(k.startswith("unet.encoder_1_0") for k in ckpt["refine_model"])
    losses = _losses(exps["dflt"])
    assert len(losses) == 8 and all(map(np.isfinite, losses))
