"""The grid sample's flow entry (``ops/warp.warp_steps``: one frame warped
by T steps of flow times an optional mask) on the CPU, where it takes its
plain version, against the JAX package: the T-step entry against the JAX
per-step ``backward_warp(frame1, flow[:, i] * mask_fw[:, i])`` stacked (as
the JAX VideoVAE forms its warped frames), the bounded entry against
``pallas_warp.grid_sample_pallas(interpret=True)`` (the TPU kernel run as
its own tests run it off-TPU), and the kernel's coordinate arithmetic
(``flow_coords``: the base grid's linspaces kept once per shape, the
product rounded to the flow's dtype) against ``make_base_grid - flow``.

Inputs from ``numpy.random.RandomState``.  Tolerances: f32 max|d| <= 1e-5
(the same four-corner sums; the JAX base grid and the Pallas hat weights
round in the last bit); bf16 max|d| <= 2e-2 * max|ref| (the port sums in
f32 and rounds once, the JAX function weights and sums in bf16); the
coordinates and the port's own compositions bit for bit.  The CUDA
kernel runs only on the card, where chip_smoke.py holds it to these plain
versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.ops import warp as jwarp
from deep_video_interpolation_extrapolation_tpu.ops.pallas_warp import (
    grid_sample_pallas,
)
from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.core.config import (
    Config,
)
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.ops import warp

torch.set_num_threads(1)

B, H, W, C = 2, 16, 32, 3
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _px(h, w):
    """Pixel displacement -> normalized units (x, y)."""
    return np.array([2.0 / (w - 1), 2.0 / (h - 1)], np.float32)


def _steps_case(seed, t, disp, h=H, w=W):
    """x (B,H,W,C), flow (B,T,H,W,2) of up to ``disp`` px in normalized
    units, mask (B,T,H,W,1) in [0, 1]."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (B, h, w, C)).astype(np.float32)
    flow = (rng.uniform(-disp, disp, (B, t, h, w, 2)) * _px(h, w)).astype(
        np.float32)
    mask = rng.uniform(0, 1, (B, t, h, w, 1)).astype(np.float32)
    return x, flow, mask


def _jax_steps(x, flow, mask, jdt):
    """The JAX VideoVAE's warp: backward_warp per step, stacked."""
    xj, fj = jnp.asarray(x, jdt), jnp.asarray(flow, jdt)
    mj = None if mask is None else jnp.asarray(mask, jdt)
    return np.asarray(jnp.stack([
        jwarp.backward_warp(xj, fj[:, i] if mj is None else fj[:, i] * mj[:, i])
        for i in range(flow.shape[1])], axis=1), np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("t", [1, 2, 3])
def test_warp_steps_matches_jax_per_step(t, dtype, use_mask):
    tdt, jdt = DTYPES[dtype]
    x, flow, mask = _steps_case(t, t, 5.0)
    mask = mask if use_mask else None
    ref = _jax_steps(x, flow, mask, jdt)
    hw.reset_counters()
    out = warp.warp_steps(_t(x, tdt), _t(flow, tdt),
                          None if mask is None else _t(mask, tdt))
    assert hw.launches["grid_sample"] == 0          # CPU: plain version
    assert out.dtype == tdt and out.shape == (B, t, H, W, C)
    out = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    else:
        assert np.abs(out - ref).max() <= 2e-2 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_warp_steps_is_the_per_step_composition(dtype):
    """The plain flow entry is the model's own per-step composition
    (``backward_warp`` of ``flow[:, i] * mask[:, i]``, stacked) bit for
    bit, and ``backward_warp`` is its T = 1 case."""
    tdt, _ = DTYPES[dtype]
    x, flow, mask = _steps_case(7, 2, 6.0)
    xt, ft, mt = _t(x, tdt), _t(flow, tdt), _t(mask, tdt)
    per_step = torch.stack([warp.backward_warp(xt, ft[:, i] * mt[:, i])
                            for i in range(2)], 1)
    assert torch.equal(warp.warp_steps_plain(xt, ft, mt), per_step)
    for r in (None, 2):
        assert torch.equal(
            warp.warp_steps(xt, ft[:, :1], None, r)[:, 0],
            warp.backward_warp(xt, ft[:, 0], r is not None, r or 8))


@pytest.mark.parametrize("r", [2, 8])
def test_bounded_flow_entry_matches_pallas_warp(r):
    """Displacements up to r + 3 px: inside the window the exact sample,
    beyond it only the corners that lie inside, as the TPU kernel."""
    x, flow, _ = _steps_case(10 + r, 1, r + 3.0)
    base = np.asarray(jwarp.make_base_grid(H, W))[None]
    ref = np.asarray(grid_sample_pallas(jnp.asarray(x),
                                        jnp.asarray(base - flow[:, 0]),
                                        max_disp=r, interpret=True))
    out = warp.warp_steps(_t(x), _t(flow), None, r)[:, 0].numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("r", [2, 8])
@pytest.mark.parametrize("edge", [0.5, 1.5])
def test_bounded_flow_entry_window_edge(r, edge):
    """Shifts of +-(R + 0.5) and +-(R + 1.5) px along x, y and both: the
    last half pixel inside the window's far edge (x - j in {R, R + 1}),
    half a pixel beyond it (the R + 1 corner kept, R + 2 dropped), and
    beyond the near edge (-R kept, -R - 1 dropped; then both dropped), as
    the TPU kernel, the image's bottom and right edges included."""
    h, w = 24, 40
    rng = np.random.RandomState(20 + r)
    x = rng.uniform(-1, 1, (1, h, w, C)).astype(np.float32)
    base = np.asarray(jwarp.make_base_grid(h, w))[None]
    for d in (r + edge, -r - edge):
        for shift in ((d, 0.0), (0.0, d), (d, d)):
            # out(i, j) samples x at (i + dy, j + dx): flow = -shift
            flow = (-np.array(shift, np.float32) * _px(h, w)
                    * np.ones((1, 1, h, w, 2), np.float32))
            ref = np.asarray(grid_sample_pallas(
                jnp.asarray(x), jnp.asarray(base - flow[:, 0]), max_disp=r,
                interpret=True))
            out = warp.warp_steps(_t(x), _t(flow), None, r)[:, 0].numpy()
            np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def _flows(kind, dtype, h, w):
    """(B,T,H,W,2) flows: zero, integer pixel shifts, integer normalized
    shifts (exact in bf16) or random, in ``dtype``."""
    rng = np.random.RandomState(len(kind))
    shape = (B, 2, h, w, 2)
    if kind == "zero":
        f = np.zeros(shape, np.float32)
    elif kind == "integer px":
        f = rng.randint(-4, 5, shape).astype(np.float32) * _px(h, w)
    elif kind == "integer normalized":
        f = rng.randint(-2, 3, shape).astype(np.float32)
    else:
        f = rng.uniform(-6, 6, shape).astype(np.float32) * _px(h, w)
    return _t(f, dtype)


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["zero", "integer px", "integer normalized",
                                  "random"])
def test_flow_coords_mirror_the_model_bit_for_bit(kind, dtype, use_mask):
    """The kernel's coordinates (``flow_coords``: the kept linspaces minus
    flow * mask rounded to the flow's dtype) against the model's
    ``make_base_grid - (flow * mask).float()``, bit for bit: on zero and
    integer flows a sample sits on a pixel, where an ulp of the base grid
    would flip its floor."""
    tdt, _ = DTYPES[dtype]
    h, w = 24, 40
    flow = _flows(kind, tdt, h, w)
    mask = None
    if use_mask:
        mask = _t(np.random.RandomState(3).uniform(0, 1, (B, 2, h, w, 1)),
                  tdt)
        if kind != "random":                       # keep the shifts whole
            mask = (mask > 0.5).to(tdt)
    for i in range(2):
        f = flow[:, i] if mask is None else flow[:, i] * mask[:, i]
        grid = warp.make_base_grid(h, w)[None] - f.float()
        want = warp._pixel_coords(grid, h, w)
        got = warp.flow_coords(flow[:, i], None if mask is None
                               else mask[:, i], h, w)
        for g_, w_ in zip(got, want):
            assert g_.dtype == torch.float32 and torch.equal(g_, w_)
    if kind == "zero":                 # the identity: x back, floor flips
        x = _t(np.random.RandomState(4).uniform(-1, 1, (B, h, w, C)), tdt)
        out = warp.warp_steps(x, flow, mask)
        for i in range(2):
            np.testing.assert_allclose(out[:, i].float().numpy(),
                                       x.float().numpy(),
                                       atol=1e-5 if dtype == "float32"
                                       else 8e-3)


def test_base_vectors_are_kept_once_per_shape():
    """The linspaces of ``make_base_grid``, bit for bit, made once per
    (H, W, device): a later call returns the same tensors."""
    xs, ys = warp.base_vectors(24, 40, torch.device("cpu"))
    grid = warp.make_base_grid(24, 40)
    assert torch.equal(xs, grid[0, :, 0]) and torch.equal(ys, grid[:, 0, 1])
    again = warp.base_vectors(24, 40, torch.device("cpu"))
    assert again[0] is xs and again[1] is ys
    with torch.inference_mode():       # kept tensors are ordinary ones
        warp.base_vectors.cache_clear()
        xs, _ = warp.base_vectors(24, 40, torch.device("cpu"))
    assert not xs.is_inference()


@pytest.mark.parametrize("bad", ["rank", "no steps", "shape", "mask shape",
                                 "mask dtype", "x dtype", "max_disp"])
def test_flow_entry_refuses_what_the_kernel_does_not_take(bad):
    """The wrapper's checks, made before any launch (so they run here)."""
    x = torch.zeros(B, H, W, C, dtype=torch.bfloat16)
    flow = torch.zeros(B, 2, H, W, 2, dtype=torch.bfloat16)
    mask, r = torch.zeros(B, 2, H, W, 1, dtype=torch.bfloat16), None
    if bad == "rank":
        flow = flow[:, 0]
    elif bad == "no steps":
        flow, mask = flow[:, :0], None
    elif bad == "shape":
        flow = flow[:, :, :-1]
    elif bad == "mask shape":
        mask = torch.zeros(B, 2, H, W, 2, dtype=torch.bfloat16)
    elif bad == "mask dtype":
        mask = mask.float()
    elif bad == "x dtype":
        x = x.half()
    else:
        r = -1
    with pytest.raises(ValueError):
        warp._steps_kernel(x, flow, mask, r)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_video_vae_cpu_warp_is_the_flow_entry_plain(dtype):
    """The port's VideoVAE at 2x32x32 on the CPU warps frame1 by the
    per-step composition, which equals the flow entry's plain version on
    its own flow and forward mask bit for bit: the T-step entry the card
    takes computes the model's warped frames."""
    vae = registry.build_model(Config(model="VAE", vid_length=2, input_h=32,
                                      input_w=32, compute_dtype=dtype),
                               device="cpu", seed=5)
    g = torch.Generator().manual_seed(6)
    rgb = torch.rand(2, 3, 32, 32, 3, generator=g)
    seg = torch.nn.functional.one_hot(
        torch.randint(0, 20, (2, 3, 32, 32), generator=g), 20).float()
    fg = (torch.rand(2, 3, 32, 32, 1, generator=g) > 0.5).float()
    tdt = DTYPES[dtype][0]
    rgb, seg, fg = rgb.to(tdt), seg.to(tdt), fg.to(tdt)
    with torch.no_grad():
        output, _, flow, _, mask_fw, _ = vae(
            rgb, seg, 1 - fg, fg, generator=torch.Generator().manual_seed(7))
    assert flow.abs().max() > 0                    # a real warp
    assert torch.equal(output, warp.warp_steps_plain(rgb[:, 0], flow,
                                                     mask_fw))
