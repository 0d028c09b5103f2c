"""``--torch_ckpt``: a port model's ``state_dict`` saved in the reference's
checkpoint format (``{"session", "epoch", "coarse_model"}``,
runners/InterTrainer.py:867-886) loads into both runners, the JAX one
through ``tools/torch_port`` and the port's by name, and their val metrics
agree (InterNet/HRNet at full width, synthetic data, 32x64, batch 2, f32;
the port's frozen VGG19 loaded from the JAX runner's).  Bound: 1e-3 *
max(1, |JAX value|) per metric, the f32 eval of the same weights summed in
another order.  A ``module.``-prefixed state_dict (a DDP model's) loads the
same."""

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
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    from_jax_vgg,
)
from deep_video_interpolation_extrapolation_tpu_torch.train.runner import (
    Runner,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_ckpt")
    argv = ("--dataset synthetic --input_h 32 --input_w 64 --bs 2 "
            "--compute_dtype float32 --syn_type inter INTER --model InterNet")
    model = registry.build_model(parse_args(argv.split()), device="cpu",
                                 seed=7)
    sd = model.coarse_model.state_dict()
    path = str(tmp / "ref.pth")
    torch.save({"session": 1, "epoch": 2, "coarse_model": sd}, path)
    ddp = str(tmp / "ddp.pth")
    torch.save({"session": 1, "epoch": 2,
                "coarse_model": {f"module.{k}": v for k, v in sd.items()}}, ddp)
    return tmp, sd, path, ddp


def _argv(path):
    return (f"--dataset synthetic --input_h 32 --input_w 64 --bs 2 "
            f"--compute_dtype float32 --split val --syn_type inter "
            f"--torch_ckpt {path} INTER --model InterNet").split()


def test_both_runners_load_it_alike(ckpt):
    tmp, sd, path, _ = ckpt
    jr = JRunner(jparse(_argv(path)), str(tmp / "jax"))
    pr = Runner(parse_args(_argv(path)), str(tmp / "port"), device="cpu")
    for k, v in pr.model.coarse_model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    pr.state.frozen_vgg.load_state_dict(from_jax_vgg(
        jax.tree_util.tree_map(np.asarray, jr.state.frozen["vgg"])))
    ref, ours = jr.validate(), pr.validate()
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert abs(ours[k] - v) <= 1e-3 * max(1.0, abs(v)), (k, ours, ref)


def test_module_prefix_is_stripped(ckpt):
    tmp, sd, _, ddp = ckpt
    pr = Runner(parse_args(_argv(ddp)), str(tmp / "ddp"), device="cpu")
    for k, v in pr.model.coarse_model.state_dict().items():
        assert torch.equal(v, sd[k]), k
