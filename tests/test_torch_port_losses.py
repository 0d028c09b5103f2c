"""The port's losses and metrics (losses/image.py, bundles.py,
perceptual.py) against the JAX package's, on the same numpy inputs.

f32: the functions are the same arithmetic on both sides; only reduction
order differs, so values agree to 1e-5 relative (1e-4 through the 16-conv
VGG19 tower, whose weights map over with ``from_jax_vgg``).
bf16 predictions (the train step's compute dtype): the result dtypes must
match JAX's (e.g. ``log_softmax`` and the gaussian blur run in the input's
dtype), and values agree to 2e-2 relative: both sides round to bf16 (2^-8)
but XLA may keep fused elementwise chains in f32 where PyTorch rounds each
op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.core.config import Config
from deep_video_interpolation_extrapolation_tpu.losses import (
    bundles as jbundles,
    image as jimage,
    perceptual as jperceptual,
)
from deep_video_interpolation_extrapolation_tpu.train import common as jcommon
from deep_video_interpolation_extrapolation_tpu_torch.losses import (
    bundles,
    image,
    perceptual,
)
from deep_video_interpolation_extrapolation_tpu_torch.models.features import (
    VGG19Features,
)
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    from_jax_vgg,
)

torch.set_num_threads(1)

B, H, W = 2, 32, 32


def _pair(seed, lo=-1.0):
    rng = np.random.RandomState(seed)
    pred = rng.uniform(lo, 1, (B, H, W, 3)).astype(np.float32)
    gt = np.clip(pred + rng.normal(0, 0.2, pred.shape), lo, 1).astype(
        np.float32)
    return pred, gt


def _close(out, ref, tol):
    out, ref = float(out), float(np.asarray(ref, np.float32))
    assert abs(out - ref) <= tol * max(abs(ref), 1e-6), (out, ref)


IMAGE_LOSSES = ["ssim", "ssim_loss", "psnr", "gdl_loss", "l1_loss"]


@pytest.mark.parametrize("name", IMAGE_LOSSES)
def test_image_loss_matches_jax(name):
    pred, gt = _pair(0, lo=0.0)
    ref = getattr(jimage, name)(jnp.asarray(pred), jnp.asarray(gt))
    out = getattr(image, name)(torch.from_numpy(pred), torch.from_numpy(gt))
    _close(out, ref, 1e-5)


@pytest.mark.parametrize("name", IMAGE_LOSSES)
def test_image_loss_bf16_prediction_matches_jax(name):
    """A bf16 prediction against an f32 target, as in the train step."""
    pred, gt = _pair(1, lo=0.0)
    ref = getattr(jimage, name)(jnp.asarray(pred, jnp.bfloat16),
                                jnp.asarray(gt))
    out = getattr(image, name)(torch.from_numpy(pred).bfloat16(),
                               torch.from_numpy(gt))
    assert str(out.dtype).split(".")[-1] == str(ref.dtype)
    _close(out.float(), np.asarray(ref, np.float32), 2e-2)


def test_ssim_per_sample():
    pred, gt = _pair(2, lo=0.0)
    ref = jimage.ssim(jnp.asarray(pred), jnp.asarray(gt), size_average=False)
    out = image.ssim(torch.from_numpy(pred), torch.from_numpy(gt),
                     size_average=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_cross_entropy_and_iou_match_jax(dtype, tol):
    rng = np.random.RandomState(3)
    logits = rng.normal(0, 3, (B, H, W, 20)).astype(np.float32)
    ids = rng.randint(0, 20, (B, H, W)).astype(np.uint8)
    jl = jnp.asarray(logits, jnp.dtype(dtype))
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    ref = jimage.cross_entropy_loss(jl, jnp.asarray(ids))
    out = image.cross_entropy_loss(tl, torch.from_numpy(ids))
    assert str(out.dtype).split(".")[-1] == str(ref.dtype)
    _close(out.float(), np.asarray(ref, np.float32), tol)
    pred_ids = np.argmax(logits, -1)
    _close(image.iou_accuracy(torch.from_numpy(pred_ids),
                              torch.from_numpy(ids)),
           jimage.iou_accuracy(jnp.asarray(pred_ids), jnp.asarray(ids)), 1e-6)


@pytest.fixture(scope="module")
def vgg_pair():
    """The JAX package's random frozen VGG19 (f32) and the port's with the
    same weights."""
    cfg = Config(compute_dtype="float32")
    params = jcommon.init_vgg_frozen(cfg, jax.random.PRNGKey(0))
    vgg = VGG19Features(dtype=torch.float32)
    vgg.load_state_dict(from_jax_vgg(jax.tree_util.tree_map(np.asarray,
                                                            params)))
    return jcommon.make_vgg_module(cfg), {"params": params}, vgg


def test_vgg_l1_matches_jax(vgg_pair):
    jvgg, jvars, vgg = vgg_pair
    pred, gt = _pair(4)
    ref = jperceptual.make_vgg_l1_loss(jvgg, jvars)(jnp.asarray(pred),
                                                    jnp.asarray(gt))
    out = perceptual.make_vgg_l1_loss(vgg)(torch.from_numpy(pred),
                                           torch.from_numpy(gt))
    _close(out, ref, 1e-4)


def test_vgg_cosine_matches_jax(vgg_pair):
    jvgg, jvars, vgg = vgg_pair
    pred, gt = _pair(5, lo=0.0)
    ref = jperceptual.make_vgg_cosine_score(jvgg, jvars)(jnp.asarray(pred),
                                                         jnp.asarray(gt))
    out = perceptual.make_vgg_cosine_score(vgg)(torch.from_numpy(pred),
                                                torch.from_numpy(gt))
    _close(out, ref, 1e-4)


def test_vgg_l1_stops_the_gradient_at_gt(vgg_pair):
    _, _, vgg = vgg_pair
    pred, gt = (torch.from_numpy(a).requires_grad_() for a in _pair(6))
    perceptual.make_vgg_l1_loss(vgg)(pred, gt).backward()
    assert pred.grad.abs().sum() > 0 and gt.grad is None


@pytest.mark.parametrize("with_vgg", [False, True])
def test_rgb_bundle_matches_jax(vgg_pair, with_vgg):
    jvgg, jvars, vgg = vgg_pair
    pred, gt = _pair(7)
    w = (80.0, 80.0, 20.0, 20.0)
    ref = jbundles.rgb_loss_bundle(
        jnp.asarray(pred), jnp.asarray(gt), *w,
        vgg_fn=jperceptual.make_vgg_l1_loss(jvgg, jvars) if with_vgg else None,
        prefix="coarse")
    out = bundles.rgb_loss_bundle(
        torch.from_numpy(pred), torch.from_numpy(gt), *w,
        vgg_fn=perceptual.make_vgg_l1_loss(vgg) if with_vgg else None,
        prefix="coarse")
    assert list(out) == list(ref)
    for k in ref:
        _close(out[k], ref[k], 1e-4)
