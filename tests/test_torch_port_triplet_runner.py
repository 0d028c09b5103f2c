"""The port's runner on the triplet sets, through its launcher's entry points
on the CPU:

- the ucf101 val runner (a val split only: no train set) on a tiny tree
  (two clips of 20x30 frames, resized to 256x256, ``--bs 2``), InterNet at
  full width in f32, against the JAX package's ``Runner.validate`` from the
  same command line, the port's model and VGG19 given the JAX runner's
  weights: every metric within 1e-4 * max(1, |JAX value|) (the f32 forward
  summed in another order), and no ``coarse_iou`` in xx2x;
- its ``--checkepoch_range`` sweep over two checkpoints: epoch 1 (those
  weights) gives ``validate``'s metrics again, epoch 2 (other weights)
  other metrics; ``train`` raises, ucf101 having no train split;
- ``DVIE_PROFILE_DIR`` through ``cli.main.run`` on a vimeo tree: one Chrome
  trace a run, of steps 2-6 of an 8-step epoch, or of steps 2-3 of 4-step
  epochs (stopped at the first epoch's end, none in the second).
"""

import json
import os
import pickle
import re

import jax
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.cli.options import (
    parse_args as jparse,
)
from deep_video_interpolation_extrapolation_tpu.train.runner import (
    Runner as JRunner,
)
from deep_video_interpolation_extrapolation_tpu_torch.cli.main import run
from deep_video_interpolation_extrapolation_tpu_torch.cli.options import (
    parse_args,
)
from deep_video_interpolation_extrapolation_tpu_torch.native import png
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    from_jax_vgg,
    load_jax_params,
)
from deep_video_interpolation_extrapolation_tpu_torch.train import (
    checkpoint as ckpt_lib,
)
from deep_video_interpolation_extrapolation_tpu_torch.train.runner import (
    Runner,
)

torch.set_num_threads(2)

# input_h / input_w size only the JAX runner's init batch: the triplet
# frames come whole (ucf101's resized to 256x256)
UCF = ("--dataset ucf101 --mode xx2x --syn_type inter --input_h 32 "
       "--input_w 64 --bs 2 --compute_dtype float32")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _frame(rng, h, w):
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([yy * 9 + xx * 4, xx * 6 + 30, yy * 11], -1)
    return ((base + rng.randint(0, 30, (h, w, 3))) % 256).astype(np.uint8)


@pytest.fixture(scope="module")
def ucf(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ucf")
    rng = np.random.RandomState(3)
    root = tmp / "ucf101_interp_ours"
    rows = []
    for c in range(2):
        (root / f"v{c}").mkdir(parents=True)
        rows.append([f"v{c}/{i}.png" for i in range(3)])
        for rel in rows[-1]:
            png.save_png(str(root / rel), _frame(rng, 20, 30))
    with open(tmp / "UCF101_test_root_clip.pkl", "wb") as f:
        pickle.dump({"test": rows}, f)
    return tmp, str(root)


def test_ucf101_val_runner_matches_jax(ucf):
    tmp, root = ucf
    argv = f"{UCF} --img_dir {root} --split val INTER --model InterNet"
    jr = JRunner(jparse(argv.split()), str(tmp / "jax"))
    ref = jr.validate()
    pr = Runner(parse_args(argv.split()), str(tmp / "port"), device="cpu")
    load_jax_params(pr.model, _np(jr.state.params))
    vgg = from_jax_vgg(_np(jr.state.frozen["vgg"]))
    pr.state.frozen_vgg.load_state_dict(vgg)
    got = pr.validate()
    assert list(got) == list(ref) and "coarse_iou" not in got
    for k, v in ref.items():
        assert abs(got[k] - v) <= 1e-4 * max(1.0, abs(v)), (k, got, ref)
    with pytest.raises(ValueError, match="no train split"):
        pr.train()

    # the sweep: epoch 1 holds these weights, epoch 2 others
    ckpt_lib.save_checkpoint(pr.cfg, str(tmp / "exp"), pr.state, 1, 0)
    with torch.no_grad():
        for p in pr.model.parameters():
            p.mul_(0.9)
    ckpt_lib.save_checkpoint(pr.cfg, str(tmp / "exp"), pr.state, 2, 0)
    sweep = (f"{UCF} --img_dir {root} --split val --load_dir {tmp / 'exp'} "
             "--checksession 0 --checkepoch_range --checkepoch_low 1 "
             "--checkepoch_up 2 INTER --model InterNet")
    sr = Runner(parse_args(sweep.split()), str(tmp / "sweep"), device="cpu")
    sr.state.frozen_vgg.load_state_dict(vgg)
    swept = sr.validate_range()
    assert sorted(swept) == [1, 2]
    for k, v in got.items():
        assert abs(swept[1][k] - v) <= 1e-6 * max(1.0, abs(v)), k
    assert swept[2]["coarse_psnr"] != swept[1]["coarse_psnr"]


def _vimeo(tmp, n):
    rng = np.random.RandomState(n)
    root = tmp / f"vimeo{n}"
    rows = [f"{i // 4:05d}/{i % 4:04d}" for i in range(n)]
    for row in rows:
        (root / "sequences" / row).mkdir(parents=True)
        for i in range(3):
            png.save_png(str(root / "sequences" / row / f"im{i + 1}.png"),
                         _frame(rng, 32, 64))
    (root / "tri_trainlist.txt").write_text("\n".join(rows) + "\n")
    return root


@pytest.mark.parametrize("n,epochs,last", [(8, 2, 3), (16, 1, 6)])
def test_profile_dir_writes_one_trace(tmp_path, monkeypatch, n, epochs,
                                      last):
    root = _vimeo(tmp_path, n)
    monkeypatch.setenv("DVIE_PROFILE_DIR", str(tmp_path / "trace"))
    cfg = parse_args(
        f"--dataset vimeo --img_dir {root} --mode xx2x --syn_type inter "
        f"--split train --bs 2 --epochs {epochs} --nw 0 --disp_interval 1 "
        "--compute_dtype float32 --vgg_w 0 --input_h 32 --input_w 64 "
        "INTER --model InterNet --train_coarse".split())
    exp = tmp_path / "exp"
    run(cfg, exp_dir=str(exp), device="cpu")
    traces = os.listdir(tmp_path / "trace")
    assert traces == [f"dvie_trace_{os.getpid()}.json"]
    with open(tmp_path / "trace" / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(name.startswith("aten::conv") for name in names)
    log = (exp / "experiment_train.log").read_text()
    assert re.findall(r"trace of steps 2-(\d+) written", log) == [str(last)]
    assert len(re.findall(r"\[iter +\d+\] loss", log)) == n // 2 * epochs
