"""The port's ``train/runner.Runner`` against the JAX package's, built from
the same command line: InterNet/HRNet at full width, synthetic data,
32x64, batch 2, f32, two epochs with ``--disp_interval 1``.  The port's
model and frozen VGG19 take the JAX runner's initial weights
(``tools/jax_weights.load_jax_params`` and ``from_jax_vgg``).

- every logged ``loss_all`` within 1e-3 relative over the first 3 steps
  and within 1e-2 over all 16 (Adamax moves a weight whose gradient sits
  within rounding noise of 0 by up to 2 * lr on either side, and over 16
  steps those moves add up; ``tests/test_torch_port_train.py``);
- the checkpoints: the same names (``InterNet_xs2xs_inter_0_1_0``, ...,
  as ``tests/test_cli.py:63`` expects) and the port's file contents;
- ``validate`` on each side's epoch-2 checkpoint: every metric within
  1e-2 * max(1, |JAX value|): relative for the PSNR, absolute for the
  metrics in [0, 1] (the IoU of random-init seg logits is ~0.05, and a
  few argmax flips of near-tied logits move it by ~1e-3).
"""

import logging
import os
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
from deep_video_interpolation_extrapolation_tpu_torch.cli.options import (
    parse_args,
)
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

GLOBAL = ("--dataset synthetic --input_h 32 --input_w 64 --bs 2 --epochs 2 "
          "--disp_interval 1 --compute_dtype float32 --syn_type inter")
LOSS = re.compile(r"\[epoch +(\d+)\]\[iter +(\d+)\] loss: ([-0-9.]+)")


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def losses(self):
        return [(int(e), int(i), float(v)) for line in self.lines
                for e, i, v in LOSS.findall(line)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _logged(fn):
    cap = _Capture()
    log = logging.getLogger("dvie")
    log.setLevel(logging.INFO)
    log.addHandler(cap)
    try:
        fn()
    finally:
        log.removeHandler(cap)
    return cap


def port_like(port_runner, jax_runner):
    """Give the port runner the JAX runner's weights and frozen VGG19."""
    load_jax_params(port_runner.model, _np(jax_runner.state.params))
    port_runner.state.frozen_vgg.load_state_dict(
        from_jax_vgg(_np(jax_runner.state.frozen["vgg"])))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("runner")
    argv = f"{GLOBAL} --split train INTER --model InterNet --train_coarse"
    jr = JRunner(jparse(argv.split()), str(tmp / "jax"))
    pr = Runner(parse_args(argv.split()), str(tmp / "port"), device="cpu")
    port_like(pr, jr)
    jlog = _logged(jr.train_epochs)
    plog = _logged(pr.train_epochs)
    return tmp, jr, pr, jlog, plog


def test_logged_losses_match_jax(runs):
    _, _, _, jlog, plog = runs
    ours, ref = plog.losses(), jlog.losses()
    assert len(ref) == 16 and [r[:2] for r in ours] == [r[:2] for r in ref]
    for k, ((_, _, a), (_, _, b)) in enumerate(zip(ours, ref)):
        tol = 1e-3 if k < 3 else 1e-2
        assert abs(a - b) <= tol * abs(b), (k, a, b)


def test_epoch_summary_logged(runs):
    _, _, _, _, plog = runs
    summary = [line for line in plog.lines if "samples/s" in line]
    assert len(summary) == 2 and "16 samples" in summary[0]
    assert any(line.startswith("saved checkpoint") for line in plog.lines)


def test_checkpoints_named_as_jax(runs):
    tmp, _, _, _, _ = runs
    ours = sorted(os.listdir(ckpt_lib.checkpoint_dir(str(tmp / "port"))))
    ref = sorted(os.listdir(ckpt_lib.checkpoint_dir(str(tmp / "jax"))))
    assert ours == ref == ["InterNet_xs2xs_inter_0_1_0",
                           "InterNet_xs2xs_inter_0_2_0"]


def test_checkpoint_contents(runs):
    tmp, _, pr, _, _ = runs
    ckpt = ckpt_lib.load_checkpoint(os.path.join(
        ckpt_lib.checkpoint_dir(str(tmp / "port")),
        "InterNet_xs2xs_inter_0_2_0"))
    assert sorted(ckpt) == ["coarse_model", "coarse_optimizer", "epoch",
                            "session", "step"]
    assert (ckpt["session"], ckpt["epoch"], ckpt["step"]) == (0, 3, 16)
    for k, v in pr.model.coarse_model.state_dict().items():
        assert torch.equal(ckpt["coarse_model"][k], v), k
    assert ckpt["coarse_optimizer"]["state"]


def test_validate_matches_jax(runs):
    tmp, jr, _, _, _ = runs
    out = {}
    for side in ("jax", "port"):
        argv = (f"{GLOBAL} --split val --load_dir {tmp / side} --checkepoch 2 "
                "--checksession 0 INTER --model InterNet --load_coarse")
        if side == "jax":
            out[side] = JRunner(jparse(argv.split()),
                                str(tmp / "jval")).validate()
        else:
            v = Runner(parse_args(argv.split()), str(tmp / "pval"),
                       device="cpu")
            v.state.frozen_vgg.load_state_dict(
                from_jax_vgg(_np(jr.state.frozen["vgg"])))
            out[side] = v.validate()
    assert sorted(out["port"]) == sorted(out["jax"])
    for k, ref in out["jax"].items():
        assert abs(out["port"][k] - ref) <= 1e-2 * max(1.0, abs(ref)), (
            k, out)
