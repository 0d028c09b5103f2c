"""The grid sample's flow entry with a gradient (ops/warp.warp_steps, the
VideoVAE's training warp): the plain version's gradient against
``jax.grad`` of the JAX package's ``backward_warp`` (its XLA path, the one
the JAX VAE trains through), the backward kernel's arithmetic emulated in
numpy against the plain gradient, and the wrapper's routing on the card
(emulated here: the kernel calls replaced by their plain versions).

Flows are made in pixels as an integer plus a fraction in [0.2, 0.8] (the
bilinear derivative jumps where a coordinate is an integer, so flows near
one would compare one-sided derivatives); the mask multiplies a flow made
as that displacement over the mask.  f32 on both sides; tolerance 1e-4 of
each gradient's largest magnitude (the same sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.ops import warp as jwarp
from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.ops import warp

TOL = 1e-4


def _case(b, t, h, w, c, seed, masked=True):
    """x (B,H,W,C), flow (B,T,H,W,2), mask (B,T,H,W,1) or None, dout
    (B,T,H,W,C), numpy f32."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    px = (rng.randint(-6, 7, (b, t, h, w, 2))
          + rng.uniform(0.2, 0.8, (b, t, h, w, 2)))
    f = px * np.array([2.0 / (w - 1), 2.0 / (h - 1)])
    mask = None
    if masked:
        mask = rng.uniform(0.5, 1.0, (b, t, h, w, 1))
        f = f / mask
        mask = mask.astype(np.float32)
    dout = rng.randn(b, t, h, w, c).astype(np.float32)
    return x, f.astype(np.float32), mask, dout


def _jax_grads(x, flow, mask, dout):
    """(out, dflow, dmask) of sum(dout * stack_t backward_warp(x, flow_t *
    mask_t)) by jax.grad."""
    def f(fl, mk):
        outs = [jwarp.backward_warp(jnp.asarray(x),
                                    fl[:, i] * (1.0 if mk is None
                                                else mk[:, i]))
                for i in range(fl.shape[1])]
        out = jnp.stack(outs, axis=1)
        return jnp.sum(out * dout), out
    args = (jnp.asarray(flow), None if mask is None else jnp.asarray(mask))
    (_, out), grads = jax.value_and_grad(
        f, argnums=(0,) if mask is None else (0, 1), has_aux=True)(*args)
    return (np.asarray(out), np.asarray(grads[0]),
            None if mask is None else np.asarray(grads[1]))


def _port_grads(x, flow, mask, dout, fn=warp.warp_steps):
    fl = torch.from_numpy(flow).requires_grad_()
    mk = None if mask is None else torch.from_numpy(mask).requires_grad_()
    out = fn(torch.from_numpy(x), fl, mk)
    (out * torch.from_numpy(dout)).sum().backward()
    return (out.detach().numpy(), fl.grad.numpy(),
            None if mk is None else mk.grad.numpy())


def _close(got, want, label):
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err < TOL, (label, err)


@pytest.mark.parametrize("t,masked", [(1, False), (1, True), (2, True)])
def test_plain_gradient_matches_jax(t, masked):
    x, flow, mask, dout = _case(2, t, 16, 24, 3, seed=t + 2 * masked,
                                masked=masked)
    want = _jax_grads(x, flow, mask, dout)
    got = _port_grads(x, flow, mask, dout)
    for g, w, label in zip(got, want, ("out", "dflow", "dmask")):
        if w is not None:
            _close(g, w, label)


def _kernel_bwd_numpy(x, flow, mask, dout):
    """The backward kernel's arithmetic (csrc/grid_sample.cu,
    warp_bwd_kernel) pixel by pixel in numpy f32: the forward's
    coordinates, the four corners, the sums over C, the pixel scale and the
    chain through f = flow * mask."""
    b, t, h, w, c = dout.shape
    xs = np.linspace(-1, 1, w, dtype=np.float32)
    ys = np.linspace(-1, 1, h, dtype=np.float32)
    m = np.ones((b, t, h, w, 1), np.float32) if mask is None else mask
    f = flow * m
    fx = ((xs[None, None, None, :] - f[..., 0]) + 1) * 0.5 * (w - 1)
    fy = ((ys[None, None, :, None] - f[..., 1]) + 1) * 0.5 * (h - 1)
    x0, y0 = np.floor(fx), np.floor(fy)
    tx, ty = (fx - x0)[..., None], (fy - y0)[..., None]

    def corner(yv, xv):
        ok = (yv >= 0) & (yv <= h - 1) & (xv >= 0) & (xv <= w - 1)
        yi = np.where(ok, yv, 0).astype(int)
        xi = np.where(ok, xv, 0).astype(int)
        bi = np.arange(b)[:, None, None, None]
        return x[bi, yi, xi] * ok[..., None]

    v00, v01 = corner(y0, x0), corner(y0, x0 + 1)
    v10, v11 = corner(y0 + 1, x0), corner(y0 + 1, x0 + 1)
    sx = (dout * ((1 - ty) * (v01 - v00) + ty * (v11 - v10))).sum(-1)
    sy = (dout * ((1 - tx) * (v10 - v00) + tx * (v11 - v01))).sum(-1)
    gf = np.stack([-(sx * (w - 1) * 0.5), -(sy * (h - 1) * 0.5)], -1)
    dmask = None if mask is None else (gf * flow).sum(-1, keepdims=True)
    return gf * m, dmask


@pytest.mark.parametrize("t,masked", [(1, False), (2, True)])
def test_kernel_arithmetic_matches_plain_gradient(t, masked):
    """The backward kernel's formula against autograd of the plain version,
    with flows that reach outside the frame (zero corners)."""
    x, flow, mask, dout = _case(2, t, 12, 20, 3, seed=7 + t, masked=masked)
    _, dflow, dmask = _port_grads(x, flow, mask, dout,
                                  fn=warp.warp_steps_plain)
    kflow, kmask = _kernel_bwd_numpy(x, flow, mask, dout)
    _close(kflow, dflow, "dflow")
    if masked:
        _close(kmask, dmask, "dmask")


def _fake_card(monkeypatch):
    """Route CPU tensors as CUDA ones with the kernel calls replaced by
    their plain versions (counting launches as the wrappers do)."""
    monkeypatch.setattr(warp.hw, "use_kernel", lambda t: True)

    def fwd(x, flow, mask, max_disp):
        hw.launches[warp.NAME] += 1
        return warp.warp_steps_plain(x, flow, mask, max_disp)

    def bwd(x, flow, mask, dout):
        hw.launches[warp.NAME_BWD] += 1
        kflow, kmask = _kernel_bwd_numpy(
            x.numpy(), flow.detach().numpy(),
            None if mask is None else mask.detach().numpy(),
            dout.numpy())
        return (torch.from_numpy(kflow),
                None if kmask is None else torch.from_numpy(kmask))

    monkeypatch.setattr(warp, "_steps_kernel", fwd)
    monkeypatch.setattr(warp, "_steps_bwd_kernel", bwd)


def test_wrapper_takes_the_backward_kernel(monkeypatch):
    """On the card, flow and mask requiring grad: one forward launch, one
    backward launch, and the gradients are the backward kernel's."""
    x, flow, mask, dout = _case(1, 2, 12, 20, 3, seed=11)
    want = _port_grads(x, flow, mask, dout, fn=warp.warp_steps_plain)
    _fake_card(monkeypatch)
    hw.reset_counters()
    got = _port_grads(x, flow, mask, dout)
    assert hw.launches[warp.NAME] == 1 and hw.launches[warp.NAME_BWD] == 1
    for g, w, label in zip(got, want, ("out", "dflow", "dmask")):
        _close(g, w, label)
    hw.reset_counters()


@pytest.mark.parametrize("case", ["x_grad", "bounded", "grid_entry"])
def test_wrapper_refuses_what_no_path_trains(monkeypatch, case):
    """x requiring grad, the bounded mode with a gradient and the grid entry
    with a gradient raise before any launch."""
    x, flow, mask, _ = _case(1, 1, 8, 8, 3, seed=3)
    _fake_card(monkeypatch)
    hw.reset_counters()
    xt, fl = torch.from_numpy(x), torch.from_numpy(flow).requires_grad_()
    with pytest.raises(NotImplementedError, match="backward"):
        if case == "x_grad":
            warp.warp_steps(xt.requires_grad_(), fl.detach(), None)
        elif case == "bounded":
            warp.warp_steps(xt, fl, None, max_disp=8)
        else:
            warp.grid_sample(xt, fl[:, 0])
    assert not any(hw.launches.values())
