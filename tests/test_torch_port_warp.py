"""The backward warp (``ops/warp.py``, plain versions on the CPU) against the
JAX package: ``grid_sample``, ``grid_sample_border`` and ``backward_warp``
against its XLA functions, the bounded mode against
``pallas_warp.grid_sample_pallas(interpret=True)`` (the TPU kernel run as
its own tests run it off-TPU) with the cases of ``tests/test_pallas_warp``,
and torch's ``F.grid_sample`` as a third witness.

Inputs from ``numpy.random.RandomState``.  Tolerances: f32 max|d| <= 1e-5
(the same four-corner bilinear sums; the Pallas kernel forms the corner
weights as hat functions, which round in the last bit); bf16 max|d| <=
2e-2 * max|ref| (the port sums in f32 and rounds once, the XLA function
computes in bf16).  The CUDA kernel runs only on the card, where
chip_smoke.py holds it to these plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deep_video_interpolation_extrapolation_tpu.ops import warp as jwarp
from deep_video_interpolation_extrapolation_tpu.ops.pallas_warp import (
    grid_sample_pallas,
)
from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.ops import warp

torch.set_num_threads(1)


def _px(h, w):
    """Pixel displacement -> normalized grid units (x, y)."""
    return np.array([2.0 / (w - 1), 2.0 / (h - 1)], np.float32)


def _case(seed, b, h, w, c, disp):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (b, h, w, c)).astype(np.float32)
    flow = rng.uniform(-disp, disp, (b, h, w, 2)).astype(np.float32)
    base = np.asarray(jwarp.make_base_grid(h, w))[None]
    return x, (base + flow * _px(h, w)).astype(np.float32)


def _torch_ref(x, grid, mode="zeros"):
    return F.grid_sample(torch.from_numpy(x).permute(0, 3, 1, 2),
                         torch.from_numpy(grid), mode="bilinear",
                         padding_mode=mode, align_corners=True
                         ).permute(0, 2, 3, 1).numpy()


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def test_base_grid_matches_jax():
    """Within 2 f32 ulps of 1: the two linspaces round their points in
    another order."""
    for h, w in ((1, 5), (7, 1), (6, 11)):
        np.testing.assert_allclose(warp.make_base_grid(h, w).numpy(),
                                   np.asarray(jwarp.make_base_grid(h, w)),
                                   atol=2.5e-7, rtol=0)


@pytest.mark.parametrize("disp", [3.0, 40.0])
def test_grid_sample_matches_jax_and_torch(disp):
    """Unbounded, flows within the image and far outside it."""
    x, grid = _case(0, 2, 16, 32, 3, disp)
    hw.reset_counters()
    out = warp.grid_sample(_t(x), _t(grid)).numpy()
    assert hw.launches["grid_sample"] == 0          # CPU: plain version
    ref = np.asarray(jwarp.grid_sample(jnp.asarray(x), jnp.asarray(grid)))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(out, _torch_ref(x, grid), atol=1e-5, rtol=0)


def test_grid_sample_border_matches_jax_and_torch():
    x, grid = _case(1, 2, 16, 32, 3, 20.0)
    out = warp.grid_sample_border(_t(x), _t(grid)).numpy()
    ref = np.asarray(jwarp.grid_sample_border(jnp.asarray(x),
                                              jnp.asarray(grid)))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(out, _torch_ref(x, grid, "border"),
                               atol=1e-5, rtol=0)


def test_backward_warp_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.uniform(-1, 1, (2, 16, 32, 3)).astype(np.float32)
    flow = rng.uniform(-0.4, 0.4, (2, 16, 32, 2)).astype(np.float32)
    ref = np.asarray(jwarp.backward_warp(jnp.asarray(x), jnp.asarray(flow)))
    np.testing.assert_allclose(warp.backward_warp(_t(x), _t(flow)).numpy(),
                               ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(warp.flow_warp(_t(x), _t(flow)).numpy(),
                               ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        warp.backward_warp(_t(x), _t(flow), use_kernels=False).numpy(), ref,
        atol=1e-5, rtol=0)


@pytest.mark.parametrize("r", [2, 4])
def test_bounded_matches_pallas_warp(r):
    """Displacements up to r + 3 px: inside the window the exact sample,
    beyond it only the corners that lie inside, as the TPU kernel."""
    x, grid = _case(3, 2, 16, 32, 3, r + 3.0)
    ref = np.asarray(grid_sample_pallas(jnp.asarray(x), jnp.asarray(grid),
                                        max_disp=r, interpret=True))
    out = warp.grid_sample(_t(x), _t(grid), max_disp=r).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dx", [2.5, 3.5, -2.5, -3.5])
def test_bounded_window_edge_keeps_the_corners_inside(dx):
    """A sample half a pixel beyond the window's edge keeps its one corner
    inside it: at R = 2 a +3.5 px sample keeps the +3 corner (weight 0.5)
    and drops +4; a -2.5 px sample keeps -2 and drops -3."""
    h, w, r = 8, 16, 2
    x = np.random.RandomState(4).uniform(-1, 1, (1, h, w, 2)).astype(
        np.float32)
    base = np.asarray(jwarp.make_base_grid(h, w))[None]
    grid = (base + np.array([dx, 0.0], np.float32) * _px(h, w)).astype(
        np.float32)
    ref = np.asarray(grid_sample_pallas(jnp.asarray(x), jnp.asarray(grid),
                                        max_disp=r, interpret=True))
    out = warp.grid_sample(_t(x), _t(grid), max_disp=r).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    j = 6                                    # an interior column
    lo, hi = int(np.floor(dx)), int(np.floor(dx)) + 1
    want = sum(0.5 * x[0, :, j + d] for d in (lo, hi) if -r <= d <= r + 1)
    np.testing.assert_allclose(out[0, :, j], want, atol=1e-5)


def test_identity_grid():
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (1, 8, 16, 3)).astype(np.float32)
    base = np.asarray(jwarp.make_base_grid(8, 16))[None]
    ref = np.asarray(grid_sample_pallas(jnp.asarray(x), jnp.asarray(base),
                                        max_disp=2, interpret=True))
    for r in (2, None):
        out = warp.grid_sample(_t(x), _t(base), max_disp=r).numpy()
        np.testing.assert_allclose(out, x, atol=1e-5)
        np.testing.assert_allclose(out, ref, atol=1e-5)


def test_out_of_window_is_zero():
    """+10 px at R = 2: the true sample exists but lies beyond the window;
    unbounded, it is the image's."""
    h, w = 8, 16
    x = np.ones((1, h, w, 1), np.float32)
    base = np.asarray(jwarp.make_base_grid(h, w))[None]
    grid = (base + np.array([10.0, 0.0], np.float32) * _px(h, w)).astype(
        np.float32)
    out = warp.grid_sample(_t(x), _t(grid), max_disp=2).numpy()
    ref = np.asarray(grid_sample_pallas(jnp.asarray(x), jnp.asarray(grid),
                                        max_disp=2, interpret=True))
    assert np.allclose(out[0, :, :4], 0.0)
    np.testing.assert_allclose(out, ref, atol=1e-6)
    assert np.allclose(warp.grid_sample(_t(x), _t(grid)).numpy()[0, :, :4],
                       1.0)


def test_tile_boundary_fractional_max_disp():
    """+8.5 px in y at R = 8 on a 192-row image (the TPU kernel's 64-row
    tiles): every pixel samples between its dy = R and R + 1 taps,
    including the last row of an interior tile."""
    rng = np.random.RandomState(2)
    h, w, r = 192, 128, 8
    x = rng.uniform(-1, 1, (1, h, w, 1)).astype(np.float32)
    base = np.asarray(jwarp.make_base_grid(h, w))[None]
    grid = (base + np.array([0.0, 8.5], np.float32) * _px(h, w)).astype(
        np.float32)
    out = warp.grid_sample(_t(x), _t(grid), max_disp=r).numpy()
    ref = np.asarray(grid_sample_pallas(jnp.asarray(x), jnp.asarray(grid),
                                        max_disp=r, interpret=True))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(out, _torch_ref(x, grid), atol=1e-5, rtol=0)


def test_bfloat16_inputs():
    x, grid = _case(3, 1, 16, 32, 3, 3.0)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = _t(x).bfloat16()
    for r, ref in (
            (4, grid_sample_pallas(xb, jnp.asarray(grid), max_disp=4,
                                   interpret=True)),
            (None, jwarp.grid_sample(xb, jnp.asarray(grid)))):
        out = warp.grid_sample(xt, _t(grid), max_disp=r)
        assert out.dtype == torch.bfloat16
        ref = np.asarray(ref, np.float32)
        assert np.abs(out.float().numpy() - ref).max() <= (
            2e-2 * np.abs(ref).max())
    witness = _torch_ref(np.asarray(xb, np.float32), grid)
    out = warp.grid_sample(xt, _t(grid)).float().numpy()
    assert np.abs(out - witness).max() <= 2e-2 * np.abs(witness).max()


def test_plain_version_is_differentiable():
    x, grid = _case(5, 1, 8, 16, 2, 2.0)
    xt, gt = _t(x).requires_grad_(), _t(grid).requires_grad_()
    warp.grid_sample(xt, gt).sum().backward()
    ref_x = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    ref_g = torch.from_numpy(grid).requires_grad_()
    F.grid_sample(ref_x, ref_g, align_corners=True).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(),
                               ref_x.grad.permute(0, 2, 3, 1).numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(gt.grad.numpy(), ref_g.grad.numpy(),
                               atol=1e-4)
