"""Recipe 2 through the port's ``train/runner.Runner`` against the JAX
package's, from the same command lines: an InterNet experiment's
checkpoint (the JAX runner's initial weights, saved by each package), then
``--model InterRefineNet --load_model InterNet --load_coarse --refine
--refine_model SRNRefine --n_sc 3 --train_refine`` loading it, one epoch
of 8 steps, synthetic data, 32x64, batch 2, f32, ``--disp_interval 1``.
The port's refiner takes the JAX recipe runner's initial refiner; its
coarse comes from the port's own checkpoint.

At 32x64 the 1/4 scale is below the frozen VGG19's 16 pixels (see
tests/test_torch_port_recipe2.py), so the recipe runs with ``--vgg_w 0
--refine_vgg_w 0``: neither runner builds the VGG then.

Tolerances, tests/test_torch_port_runner.py's: every logged ``loss_all``
within 1e-3 relative over the first 3 steps and within 1e-2 over all 8.
"""

import os

import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.cli.options import (
    parse_args as jparse,
)
from deep_video_interpolation_extrapolation_tpu.train import (
    checkpoint as jckpt,
)
from deep_video_interpolation_extrapolation_tpu.train.runner import (
    Runner as JRunner,
)
from deep_video_interpolation_extrapolation_tpu_torch.cli.options import (
    parse_args,
)
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    from_jax_params,
    from_jax_refine,
)
from deep_video_interpolation_extrapolation_tpu_torch.train import (
    checkpoint as ckpt_lib,
)
from deep_video_interpolation_extrapolation_tpu_torch.train.runner import (
    Runner,
)
from tests.test_torch_port_runner import _logged, _np, port_like

torch.set_num_threads(2)

GLOBAL = ("--dataset synthetic --input_h 32 --input_w 64 --bs 2 --epochs 1 "
          "--disp_interval 1 --compute_dtype float32 --syn_type inter")
RECIPE2 = ("--vgg_w 0 --split train --checksession 0 --checkepoch 1 "
           "--checkpoint 0 INTER --model InterRefineNet --load_model InterNet "
           "--coarse_model HRNet --load_coarse --refine --refine_model "
           "SRNRefine --n_sc 3 --train_refine --refine_vgg_w 0")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("recipe")
    argv = f"{GLOBAL} --split train INTER --model InterNet --train_coarse"
    j0 = JRunner(jparse(argv.split()), str(tmp / "jax_a"))
    p0 = Runner(parse_args(argv.split()), str(tmp / "port_a"), device="cpu")
    port_like(p0, j0)
    # the InterNet experiments: epoch 1's checkpoint, each package's own
    jckpt.save_checkpoint(j0.cfg, str(tmp / "jax_a"), j0.state, 1, 0)
    ckpt_lib.save_checkpoint(p0.cfg, str(tmp / "port_a"), p0.state, 1, 0)
    coarse = from_jax_params(_np(j0.state.params["coarse_model"]))

    jr = JRunner(jparse(f"{GLOBAL} --load_dir {tmp / 'jax_a'} {RECIPE2}"
                        .split()), str(tmp / "jax_b"))
    pr = Runner(parse_args(f"{GLOBAL} --load_dir {tmp / 'port_a'} {RECIPE2}"
                           .split()), str(tmp / "port_b"), device="cpu")
    loaded = {k: v.clone() for k, v in
              pr.model.coarse_model.state_dict().items()}
    pr.model.refine_model.load_state_dict(
        from_jax_refine(_np(jr.state.params["refine_model"])))
    jlog = _logged(jr.train_epochs)
    plog = _logged(pr.train_epochs)
    return tmp, pr, coarse, loaded, jlog, plog


def test_load_coarse_takes_the_internet_experiment(runs):
    _, pr, coarse, loaded, _, _ = runs
    assert pr.state.frozen_vgg is None
    for k, v in coarse.items():
        assert torch.equal(loaded[k], v), k
    # frozen: the epoch left it as loaded
    for k, v in pr.model.coarse_model.state_dict().items():
        assert torch.equal(v, loaded[k]), k


def test_recipe2_logged_losses_match_jax(runs):
    _, _, _, _, jlog, plog = runs
    ours, ref = plog.losses(), jlog.losses()
    assert len(ref) == 8 and [r[:2] for r in ours] == [r[:2] for r in ref]
    for k, ((_, _, a), (_, _, b)) in enumerate(zip(ours, ref)):
        tol = 1e-3 if k < 3 else 1e-2
        assert np.isfinite(a) and abs(a - b) <= tol * abs(b), (k, a, b)


def test_recipe2_checkpoint(runs):
    tmp, pr, _, _, _, _ = runs
    names = sorted(os.listdir(ckpt_lib.checkpoint_dir(str(tmp / "port_b"))))
    assert names == ["InterRefineNet_xs2xs_inter_0_1_0"]
    ckpt = ckpt_lib.load_checkpoint(os.path.join(
        ckpt_lib.checkpoint_dir(str(tmp / "port_b")), names[0]))
    assert sorted(ckpt) == ["coarse_model", "coarse_optimizer", "epoch",
                            "refine_model", "refine_optimizer", "session",
                            "step"]
    assert ckpt["refine_optimizer"]["state"]
    assert not ckpt["coarse_optimizer"]["state"]      # never stepped
    for k, v in pr.model.refine_model.state_dict().items():
        assert torch.equal(ckpt["refine_model"][k], v), k
