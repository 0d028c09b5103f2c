"""The port's launcher (``cli/main.run``) and its resume and val sweep, on
the CPU: InterNet/HRNet at full width, synthetic data, 32x64, batch 2,
f32.

- ``run`` writes the JAX launcher's experiment directory, its
  ``experiment_{split}.log`` with the sorted config dump, and one
  checkpoint per epoch; ``--epochs 1`` trains exactly one epoch, named
  ``..._1_0``;
- a run resumed with ``--r --checkepoch 1`` logs the uninterrupted run's
  epoch-2 losses within 1e-5 relative (the same arithmetic on the CPU);
- ``validate_range`` sweeps the written checkpoints and skips a missing
  one, and its epoch-2 metrics equal a fresh load of that checkpoint's;
- without a card, ``run`` and ``Runner`` raise for the default device;
- one epoch on a Cityscapes-layout PNG tree with loader workers, and the
  TensorBoard scalars and image grid where a writer is installed.
"""

import glob
import os
import pickle
import re

import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu_torch.cli.main import run
from deep_video_interpolation_extrapolation_tpu_torch.cli.options import (
    parse_args,
)
from deep_video_interpolation_extrapolation_tpu_torch.native import png
from deep_video_interpolation_extrapolation_tpu_torch.train.runner import (
    Runner,
)

torch.set_num_threads(2)

GLOBAL = ("--dataset synthetic --input_h 32 --input_w 64 --bs 2 "
          "--disp_interval 1 --compute_dtype float32 --syn_type inter")
TRAIN = "INTER --model InterNet --train_coarse"
LOSS = re.compile(r"\[epoch +(\d+)\]\[iter +(\d+)\] loss: ([-0-9.]+)")


def _losses(exp_dir):
    text = open(os.path.join(exp_dir, "experiment_train.log")).read()
    return {(int(e), int(i)): float(v) for e, i, v in LOSS.findall(text)}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resume")
    full = str(tmp / "full")
    run(parse_args(f"{GLOBAL} --epochs 2 --split train {TRAIN}".split()),
        exp_dir=full, device="cpu")
    resumed = str(tmp / "resumed")
    run(parse_args((f"{GLOBAL} --epochs 2 --split train --r --checkepoch 1 "
                    f"--checksession 0 --load_dir {full} {TRAIN}").split()),
        exp_dir=resumed, device="cpu")
    return tmp, full, resumed


def test_experiment_dir_log_and_checkpoints(trained):
    _, full, _ = trained
    assert sorted(os.listdir(os.path.join(full, "checkpoint"))) == [
        "InterNet_xs2xs_inter_0_1_0", "InterNet_xs2xs_inter_0_2_0"]
    lines = open(os.path.join(full, "experiment_train.log")).read().splitlines()
    dump = [line.split("] ", 1)[1].split(":")[0] for line in lines[:20]]
    assert dump == sorted(dump) and "batch_size" in dump


def test_resume_continues_the_run(trained):
    _, full, resumed = trained
    ref, ours = _losses(full), _losses(resumed)
    assert sorted(ours) == [(2, i) for i in range(8)]
    for key, v in ours.items():
        assert abs(v - ref[key]) <= 1e-5 * abs(ref[key]), (key, v, ref[key])
    assert sorted(os.listdir(os.path.join(resumed, "checkpoint"))) == [
        "InterNet_xs2xs_inter_0_2_0"]


def test_resume_checks_the_epoch(trained):
    _, full, _ = trained
    cfg = parse_args((f"{GLOBAL} --epochs 2 --split train --r --checkepoch 1 "
                      f"--checksession 0 --load_dir {full} {TRAIN}").split())
    # the epoch-2 checkpoint renamed as epoch 1: its stored epoch is 3
    src = os.path.join(full, "checkpoint", "InterNet_xs2xs_inter_0_2_0")
    ckpt = torch.load(src, weights_only=True)
    other = os.path.join(os.path.dirname(full), "bad")
    os.makedirs(os.path.join(other, "checkpoint"))
    torch.save(ckpt, os.path.join(other, "checkpoint",
                                  "InterNet_xs2xs_inter_0_1_0"))
    with pytest.raises(ValueError, match="holds epoch 2, not --checkepoch 1"):
        Runner(cfg.replace(load_dir=other), other, device="cpu")


def test_one_epoch_run(tmp_path):
    cfg = parse_args((f"{GLOBAL} --epochs 1 --save_dir {tmp_path} "
                      f"--split train {TRAIN}").split())
    run(cfg, device="cpu")
    exp = glob.glob(str(tmp_path / "InterNet_xs2xs_inter_0_*"))
    assert len(exp) == 1
    assert os.listdir(os.path.join(exp[0], "checkpoint")) == [
        "InterNet_xs2xs_inter_0_1_0"]


def test_validate_range_sweeps_and_skips(trained, caplog):
    tmp, full, _ = trained
    sweep = parse_args((f"{GLOBAL} --split val --load_dir {full} "
                        "--checksession 0 --checkepoch_range --checkepoch_low 1 "
                        "--checkepoch_up 3 INTER --model InterNet").split())
    with caplog.at_level("WARNING", logger="dvie"):
        results = run(sweep, exp_dir=str(tmp / "sweep"), device="cpu")
    assert sorted(results) == [1, 2]
    assert any("InterNet_xs2xs_inter_0_3_0" in r.getMessage()
               for r in caplog.records)
    assert results[1] != results[2]
    one = parse_args((f"{GLOBAL} --split val --load_dir {full} "
                      "--checksession 0 --checkepoch 2 INTER --model InterNet "
                      "--load_coarse").split())
    fresh = run(one, exp_dir=str(tmp / "one"), device="cpu")
    assert fresh == results[2]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_default_device_needs_a_card(tmp_path):
    cfg = parse_args(f"{GLOBAL} --split val INTER --model InterNet".split())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(cfg, exp_dir=str(tmp_path / "exp"))
    assert not os.path.exists(tmp_path / "exp")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Runner(cfg, str(tmp_path / "exp"))


def test_cityscape_epoch_with_writer(tmp_path, monkeypatch):
    """One epoch on a Cityscapes-layout tree (workers on); where a
    TensorBoard writer exists, its scalars and image grid are written."""
    rs = np.random.RandomState(0)
    clips = []
    for c in range(4):
        clip = [f"train/s/c{c}_{i:06d}" for i in range(3)]
        for rel in clip:
            for d, ext, arr in (
                    ("imgs", "_leftImg8bit.png",
                     rs.randint(0, 256, (40, 72, 3)).astype(np.uint8)),
                    ("segs", "_gtFine_myseg_id.png",
                     rs.randint(0, 20, (40, 72)).astype(np.uint8))):
                path = tmp_path / d / (rel + ext)
                path.parent.mkdir(parents=True, exist_ok=True)
                png.save_png(str(path), arr)
        clips.append(clip)
    (tmp_path / "load_files").mkdir()
    with open(tmp_path / "load_files" /
              "int_1_len_3_max_4bb_area_3000_extra_panet_lsclip.pkl",
              "wb") as f:
        pickle.dump({"train": clips, "val": clips}, f)
    monkeypatch.setenv("DVIE_DATA_ROOT", str(tmp_path))
    cfg = parse_args((f"{GLOBAL.replace('synthetic', 'cityscape')} --epochs 1 "
                      f"--nw 2 --img_dir {tmp_path / 'imgs'} --seg_dir "
                      f"{tmp_path / 'segs'} --split train {TRAIN}").split())
    runner = Runner(cfg, str(tmp_path / "exp"), device="cpu")
    runner.train_epochs()
    assert os.listdir(tmp_path / "exp" / "checkpoint") == [
        "InterNet_xs2xs_inter_0_1_0"]
    if runner.writer is not None:      # tensorboardX or tensorboard present
        runner.writer.flush()
        logs = tmp_path / "exp" / "train_int_1_len_1_cityscape_logs"
        assert logs.is_dir() and any(logs.iterdir())
