"""Recipe 6 through the port's launcher (``cli.main.run``) on the CPU against
the JAX package's runner, from the same command line: ExtraNet/HRNet at
full width in extrapolation mode, ``--num_pred_step 3`` (5-frame clips),
synthetic data, 32x64, batch 2, f32, two epochs with ``--disp_interval
1``.  The port's model and frozen VGG19 take the JAX runner's initial
weights (``tools/jax_weights``), as in tests/test_torch_port_runner.py,
whose bounds these are:

- every logged ``loss_all`` within 1e-3 relative over the first 3 steps
  and within 1e-2 over all 16;
- the checkpoints under the JAX names (``ExtraNet_xs2xs_extra_0_1_0``,
  ...), holding the coarse model and its optimizer;
- the writer's val metrics (the full rollout's 0-indexed
  ``step_{i}_frame_0_coarse_*``) against the JAX runner's, each within
  1e-2 * max(1, |JAX value|); the ``--checkepoch_range`` sweep of both
  checkpoints through ``run``, its epoch 2 equal to the writer's;
- ``--r --checkepoch 1``: the resumed epoch 2 logs what the uninterrupted
  one logged, within 1e-4;
- ``--split cycgen`` on the JAX runner's trained weights: the synthetic
  tree (``clip_NNNNN/{rgb,seg,seg_vis}/TTT.png``, 2 input frames and 3
  extrapolated ones, the layout of tests/test_runner_extra.py:38-62)
  against the JAX runner's, by the bounds of
  tests/test_torch_port_cycgen.py (rgb within 1 level on >= 99.9% of
  pixels, seg ids on >= 99%); with ``--fix_init_frames`` and at
  ``--num_pred_once 2`` (on fresh weights) the same.
"""

import os

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
from deep_video_interpolation_extrapolation_tpu_torch.train import (
    checkpoint as ckpt_lib,
)
from deep_video_interpolation_extrapolation_tpu_torch.train.runner import (
    Runner,
)
from tests.test_torch_port_cycgen import _compare_trees, _tree
from tests.test_torch_port_runner import LOSS, _logged, _np, port_like
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    from_jax_vgg,
)

torch.set_num_threads(2)

GLOBAL = ("--dataset synthetic --input_h 32 --input_w 64 --bs 2 --epochs 2 "
          "--disp_interval 1 --compute_dtype float32 --syn_type extra")
RECIPE6 = "EXTRA --model ExtraNet --train_coarse --num_pred_step 3"
CKPTS = ["ExtraNet_xs2xs_extra_0_1_0", "ExtraNet_xs2xs_extra_0_2_0"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both runners trained for two epochs; the port's through ``run``'s
    runner (``Runner`` built as ``run`` builds it)."""
    tmp = tmp_path_factory.mktemp("extra_runner")
    argv = f"{GLOBAL} --split train {RECIPE6}"
    jr = JRunner(jparse(argv.split()), str(tmp / "jax"))
    pr = Runner(parse_args(argv.split()), str(tmp / "port"), device="cpu")
    assert jr.vid_len == pr.vid_len == 5
    port_like(pr, jr)
    jlog = _logged(jr.train_epochs)
    plog = _logged(pr.train_epochs)
    return tmp, jr, pr, jlog, plog


def test_recipe6_losses_match_jax(runs):
    _, _, _, jlog, plog = runs
    ours, ref = plog.losses(), jlog.losses()
    assert len(ref) == 16 and [r[:2] for r in ours] == [r[:2] for r in ref]
    for k, ((_, _, a), (_, _, b)) in enumerate(zip(ours, ref)):
        tol = 1e-3 if k < 3 else 1e-2
        assert abs(a - b) <= tol * abs(b), (k, a, b)


def test_recipe6_checkpoints_named_as_jax(runs):
    tmp, _, pr, _, _ = runs
    ours = sorted(os.listdir(ckpt_lib.checkpoint_dir(str(tmp / "port"))))
    ref = sorted(os.listdir(ckpt_lib.checkpoint_dir(str(tmp / "jax"))))
    assert ours == ref == CKPTS
    ckpt = ckpt_lib.load_checkpoint(os.path.join(
        ckpt_lib.checkpoint_dir(str(tmp / "port")), CKPTS[1]))
    assert sorted(ckpt) == ["coarse_model", "coarse_optimizer", "epoch",
                            "session", "step"]
    assert (ckpt["epoch"], ckpt["step"]) == (3, 16)
    for k, v in pr.model.coarse_model.state_dict().items():
        assert torch.equal(ckpt["coarse_model"][k], v), k


def _val_argv(tmp, side, extra=""):
    return (f"{GLOBAL} --split val --load_dir {tmp / side} --checksession 0 "
            f"{extra} {RECIPE6} --load_model ExtraNet --load_coarse")


def test_recipe6_val_matches_jax_and_the_sweep(runs):
    tmp, jr, pr, _, _ = runs
    ref = JRunner(jparse(_val_argv(tmp, "jax", "--checkepoch 2").split()),
                  str(tmp / "jval")).validate()
    writer = pr.validate()
    assert sorted(writer) == sorted(ref)
    assert [k for k in writer if k.endswith("_psnr")] == [
        f"step_{i}_frame_0_coarse_psnr" for i in range(3)]
    for k, v in ref.items():
        assert abs(writer[k] - v) <= 1e-2 * max(1.0, abs(v)), (k, writer)
    sweep = parse_args(_val_argv(
        tmp, "port", "--checkepoch_range --checkepoch_low 1 "
        "--checkepoch_up 2").split())
    # run() builds its own runner: hand it the JAX VGG19 (the frozen
    # VGG19 is not in the checkpoint)
    got = _with_vgg(from_jax_vgg(_np(jr.state.frozen["vgg"])),
                    lambda: run(sweep, str(tmp / "sweep"), device="cpu"))
    assert sorted(got) == [1, 2] and got[1] != got[2]
    for k, val in writer.items():
        assert abs(got[2][k] - val) <= 1e-4 * max(1.0, abs(val)), k


def _with_vgg(state_dict, fn):
    """``fn()`` with every port Runner built meanwhile given these frozen
    VGG19 weights."""
    orig = Runner._build_model_and_state

    def build(self):
        orig(self)
        if self.state.frozen_vgg is not None:
            self.state.frozen_vgg.load_state_dict(state_dict)
    Runner._build_model_and_state = build
    try:
        return fn()
    finally:
        Runner._build_model_and_state = orig


def test_recipe6_resume_logs_the_same_epoch(runs):
    tmp, jr, _, _, plog = runs
    argv = (f"{GLOBAL} --split train --r --checkepoch 1 --checksession 0 "
            f"--load_dir {tmp / 'port'} {RECIPE6}")
    vgg = from_jax_vgg(_np(jr.state.frozen["vgg"]))
    _with_vgg(vgg, lambda: run(parse_args(argv.split()), str(tmp / "resumed"),
                               device="cpu"))
    with open(tmp / "resumed" / "experiment_train.log") as f:
        resumed = [(int(e), int(i), float(v))
                   for e, i, v in LOSS.findall(f.read())]
    first = [r for r in plog.losses() if r[0] == 2]
    assert [r[:2] for r in resumed] == [r[:2] for r in first] and resumed
    for (_, _, a), (_, _, b) in zip(resumed, first):
        assert abs(a - b) <= 1e-4 * abs(b)


@pytest.mark.parametrize("flags,n_frames", [("", 5),
                                            ("--fix_init_frames", 5),
                                            ("--num_pred_once 2", 4)])
def test_recipe6_cycgen_tree_matches_jax(runs, flags, n_frames):
    """The extrapolated PNG trees on the epoch-2 weights (the trained
    ExtraNet: the JAX runner's, carried across), for recipe 6 and its
    two other windows (a fresh model each for those)."""
    tmp, jr, _, _, _ = runs
    tag = flags.replace("--", "").replace(" ", "_") or "recipe6"
    steps = "--num_pred_step 1" if "pred_once" in flags else ""
    argv = (f"{GLOBAL} --split cycgen EXTRA --model ExtraNet "
            f"--num_pred_step 3 {flags} {steps}")
    jc = JRunner(jparse(argv.split()), str(tmp / f"jcyc_{tag}"))
    if not flags:
        jc.state = jc.state.replace(params=jr.state.params)
    pc = Runner(parse_args(argv.split()), str(tmp / f"pcyc_{tag}"),
                device="cpu")
    port_like(pc, jc)
    ref, ours = jc.cycgen(), pc.cycgen()
    assert os.path.relpath(ours, pc.exp_dir) == os.path.relpath(
        ref, jc.exp_dir) == os.path.join("cycgen", "synthetic", "32x64",
                                         "cycgen")
    clips = sorted(os.listdir(ours))
    assert len(clips) == 8
    names = sorted(os.listdir(os.path.join(ours, clips[0], "rgb")))
    assert names == [f"{t:03d}.png" for t in range(n_frames)]
    assert _tree(ours)
    _compare_trees(ours, ref, "rgb", "seg")
