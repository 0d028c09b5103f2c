"""The ops the refine family adds to the port, against the JAX package's on
numpy-seeded inputs, on the CPU: ``interpolate_bilinear`` with
``align_corners=True`` (down and up, by a factor and to a size),
``avg_pool`` with ``count_include_pad`` False and True, and
``window_aggregate_per_neighbor``.

Tolerances: f32 atol 1e-5 relative to the inputs' max (the same lerps and
sums; the pool and the aggregation sum in another order).  bf16
``align_corners=True``: the port rounds after every operation of the
separable lerp; XLA on the CPU may keep the chain in f32 and round once,
so the two differ by up to two bf16 rounding steps of the output,
bound 2 * 2**-8 of the max.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.ops import (
    corr as jcorr,
    resize as jresize,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops import corr, resize

torch.set_num_threads(1)


def _rand(shape, seed):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("shape,kw", [
    ((2, 32, 64, 5), dict(scale_factor=0.25)),
    ((2, 32, 64, 5), dict(scale_factor=0.5)),
    ((2, 8, 16, 50), dict(scale_factor=4.0)),
    ((2, 16, 32, 3), dict(scale_factor=2.0)),
    ((1, 7, 13, 4), dict(size=(12, 5))),
    ((1, 9, 11, 2), dict(size=(1, 1)))])
def test_align_corners_matches_jax(shape, kw):
    x = _rand(shape, 0)
    want = np.asarray(jresize.interpolate_bilinear(
        jnp.asarray(x), align_corners=True, **kw))
    got = resize.interpolate_bilinear(torch.from_numpy(x),
                                      align_corners=True, **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_align_corners_bfloat16():
    x = _rand((2, 8, 16, 50), 1)
    want = np.asarray(jresize.interpolate_bilinear(
        jnp.asarray(x, jnp.bfloat16), scale_factor=4.0, align_corners=True),
        np.float32)
    got = resize.interpolate_bilinear(
        torch.from_numpy(x).bfloat16(), scale_factor=4.0,
        align_corners=True)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 2 * 2.0**-8


def test_align_corners_is_differentiable():
    x = torch.from_numpy(_rand((1, 4, 6, 2), 2)).requires_grad_(True)
    resize.interpolate_bilinear(x, scale_factor=2.0,
                                align_corners=True).sum().backward()
    # the weights of every output pixel sum to one
    assert float(x.grad.sum()) == pytest.approx(8 * 12 * 2, rel=1e-5)


@pytest.mark.parametrize("window,include", [((3, 3), False), ((3, 5), False),
                                            ((3, 5), True)])
def test_avg_pool_matches_jax(window, include):
    x = _rand((2, 8, 16, 50), 3)
    pad = ((window[0] // 2,) * 2, (window[1] // 2,) * 2)
    want = np.asarray(jresize.avg_pool(jnp.asarray(x), window, stride=(1, 1),
                                       padding=pad,
                                       count_include_pad=include))
    got = resize.avg_pool(torch.from_numpy(x), window, pad,
                          count_include_pad=include).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("win", [(5, 5), (5, 9)])
def test_window_aggregate_per_neighbor_matches_jax(win):
    k = win[0] * win[1]
    feats = [_rand((2, 8, 16, 32), 4 + i) for i in range(2)]
    logits = 4 * _rand((2, 8, 16, 2 * k), 6)
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    want = jcorr.window_aggregate_per_neighbor(
        [jnp.asarray(f) for f in feats], jnp.asarray(prob), *win)
    got = corr.window_aggregate_per_neighbor(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(prob), *win)
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def test_window_aggregate_per_neighbor_renormalises():
    """A constant neighbour comes back unchanged wherever its window holds
    any probability mass; where it holds none, eps keeps it finite."""
    k = 25
    prob = torch.zeros(1, 4, 4, 2 * k)
    prob[..., 12] = 0.3             # neighbour 0: the centre offset only
    prob[..., k:] = 0.7 / k         # neighbour 1: spread
    f = torch.full((1, 4, 4, 3), 2.0)
    a, b = corr.window_aggregate_per_neighbor([f, f], prob, 5, 5)
    torch.testing.assert_close(a, f)
    assert torch.allclose(b[:, 2:-2, 2:-2], f[:, 2:-2, 2:-2])
    zero = corr.window_aggregate_per_neighbor([f, f], torch.zeros_like(prob),
                                              5, 5)
    assert all(torch.isfinite(z).all() and (z == 0).all() for z in zero)
