"""``serve.rollout`` against the JAX runner's cycgen sliding window
(``Runner._mini_test``, runner.py:806-853) for 3 steps, on the runner's own
weights mapped into the port, in f32 on the CPU.

The port receives the seg maps as uint8 ids (expanded on its device), the
runner as f32 one-hots.  Tolerance: predicted frames max|d| <= 1e-4 (values
in [0, 1]; the same f32 graph summed in another order, fed back three
times); seg ids agree on >= 99.9% of the pixels of every step.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.core.config import Config
from deep_video_interpolation_extrapolation_tpu.train.runner import Runner
from deep_video_interpolation_extrapolation_tpu_torch import serve
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    from_jax_params,
)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

H, W, STEPS = 32, 64, 3


@pytest.fixture(scope="module")
def runner(tmp_path_factory):
    cfg = Config(runner="INTER", model="InterNet", syn_type="inter",
                 mode="xs2xs", split="cycgen", train_coarse=True,
                 coarse_model="HRNet", compute_dtype="float32", input_h=H,
                 input_w=W, batch_size=1, dataset="synthetic",
                 num_pred_step=STEPS, num_pred_once=1)
    exp_dir = str(tmp_path_factory.mktemp("exp"))
    os.makedirs(exp_dir, exist_ok=True)
    return Runner(cfg, exp_dir)


def _inputs():
    rng = np.random.RandomState(7)
    imgs = [rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32)
            for _ in range(2)]
    ids = [rng.randint(0, 20, (1, H, W)).astype(np.uint8) for _ in range(2)]
    return imgs, ids


def test_rollout_matches_mini_test(runner):
    import jax
    import jax.numpy as jnp

    imgs, ids = _inputs()
    runner.rng = jax.random.PRNGKey(0)
    ref_imgs, ref_ids = runner._mini_test(
        [jnp.asarray(i) for i in imgs],
        [jnp.asarray(np.eye(20, dtype=np.float32)[i]) for i in ids])

    params = jax.tree_util.tree_map(
        np.asarray, runner.state.params["coarse_model"])
    model = registry.build_model(runner.cfg)
    model.coarse_model.load_state_dict(from_jax_params(params))
    out_imgs, out_ids = serve.rollout(
        model, [torch.from_numpy(i) for i in imgs],
        [torch.from_numpy(i) for i in ids], STEPS)

    assert len(out_imgs) == len(ref_imgs) == STEPS
    for k in range(STEPS):
        assert out_ids[k].dtype == torch.uint8
        assert out_imgs[k].shape == (1, H, W, 3)
        np.testing.assert_allclose(out_imgs[k].numpy(),
                                   np.asarray(ref_imgs[k]), atol=1e-4, rtol=0)
        agree = (out_ids[k].numpy() == np.asarray(ref_ids[k])).mean()
        assert agree >= 0.999, (k, agree)


def test_rollout_window_slides_by_one():
    """num_pred_once == 1: step k sees (frame k, frame k+1) of the growing
    sequence, with the seg ids fed back as one-hots (not [pred, pred])."""
    seen = []

    class Echo(torch.nn.Module):
        def forward(self, rgb, seg):
            seen.append((rgb.clone(), seg.clone()))
            step = len(seen)
            return (torch.full(rgb.shape[:3] + (3,), -1.0 + 0.25 * step),
                    torch.nn.functional.one_hot(
                        torch.full(rgb.shape[:3], step, dtype=torch.long),
                        20).float())

    imgs, ids = _inputs()
    preds, pids = serve.rollout(Echo(), [torch.from_numpy(i) for i in imgs],
                                [torch.from_numpy(i) for i in ids], 3)
    assert [int(p.max()) for p in pids] == [1, 2, 3]
    torch.testing.assert_close(seen[1][0][..., :3],
                               torch.from_numpy(imgs[1]) * 2 - 1)
    torch.testing.assert_close(seen[1][0][..., 3:], preds[0] * 2 - 1)
    torch.testing.assert_close(seen[2][0][..., :3], preds[0] * 2 - 1)
    assert int(seen[2][1][..., :20].argmax(-1).max()) == 1
    assert int(seen[2][1][..., 20:].argmax(-1).max()) == 2


def test_seg_oh_expands_ids():
    ids = torch.tensor([[[0, 19]]], dtype=torch.uint8)
    oh = serve.seg_oh(ids)
    assert oh.dtype == torch.float32 and oh.shape == (1, 1, 2, 20)
    assert oh[0, 0, 1, 19] == 1 and oh.sum() == 2


def test_serving_does_not_import_training():
    """serve.py takes its seg contract from core/, not from train/ (which
    pulls in the losses and VGG19)."""
    code = ("import sys; import deep_video_interpolation_extrapolation_tpu_torch"
            ".serve; sys.exit(any('_torch.train' in m or '_torch.losses' in m"
            " for m in sys.modules))")
    root = Path(__file__).resolve().parents[1]
    assert subprocess.run([sys.executable, "-c", code], cwd=root).returncode == 0
