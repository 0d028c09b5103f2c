"""K4's h mode and its autograd backward (ops/upshead.py) against the JAX
package's ``pallas_upshead``: ``_pallas_impl`` without the taps matrix
(``ups_head_1x1``'s kernel, ``interpret=True``), the hand-scheduled
backward ``_explicit_taps_bwd`` with ``_pallas_impl`` switched to interpret
mode inside the test (as tests/test_pallas_upshead.py:466-490 does), and
``jax.vjp`` of the XLA reference ``_ups_head_taps_ref``.

f32 on both sides; inputs from ``numpy.random.RandomState``.  Tolerance:
max|d| <= 1e-4 * max(1, max|ref|) per output or gradient, the two sides
summing the same f32 products in another order (the 448-deep 1x1 and the
pixel sums of the weight grads); a wrong tap, part or mask moves a value
by O(1e-2) or more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.ops import (
    pallas_upshead,
    tapped_conv,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops import upshead

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _close(out, ref, label="", tol=1e-4):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (label, out.shape, ref.shape)
    err, bound = np.abs(out - ref).max(), tol * max(1.0, np.abs(ref).max())
    assert err <= bound, f"{label} max|d| {err:.3g} > {bound:.3g}"


def _inputs(seed, b=1, h=16, w=32):
    rng = np.random.RandomState(seed)
    p0 = rng.uniform(-1, 1, (b, h, w, 64)).astype(np.float32)
    p1 = rng.uniform(-1, 1, (b, h // 2, w // 2, 128)).astype(np.float32)
    p2 = rng.uniform(-1, 1, (b, h // 4, w // 4, 256)).astype(np.float32)
    w1 = rng.uniform(-0.1, 0.1, (448, 896)).astype(np.float32)
    b1 = rng.uniform(-0.1, 0.1, (896,)).astype(np.float32)
    w2r = rng.uniform(-0.05, 0.05, (3, 3, 448, 3)).astype(np.float32)
    w2s = rng.uniform(-0.05, 0.05, (3, 3, 448, 20)).astype(np.float32)
    w2t = np.asarray(tapped_conv.build_dual_tap_kernel(
        jnp.asarray(w2r), jnp.asarray(w2s), jnp.float32))
    g = rng.normal(0, 1, (b, h, w, w2t.shape[1])).astype(np.float32)
    return (p0, p1, p2, w1, b1, w2t), g


@pytest.mark.parametrize("extreme_border", [False, True])
def test_h_mode_matches_pallas_impl(extreme_border):
    (p0, p1, p2, w1, b1, _), _ = _inputs(40)
    if extreme_border:
        # a clamp/zero-padding mix-up at the edges shows as O(1) errors
        p1[:, :, 0], p1[:, :, -1], p1[:, 0], p1[:, -1] = 7, -7, 5, -5
        p2[:, 0], p2[:, -1], p2[:, :, 0], p2[:, :, -1] = 5, -5, 3, -3
    jargs = [jnp.asarray(a) for a in (p0, p1, p2, w1, b1)]
    out_j = pallas_upshead._pallas_impl(*jargs, interpret=True)
    ref_j = pallas_upshead._ups_head_ref(*jargs)
    out = upshead.ups_head_1x1(*map(_t, (p0, p1, p2, w1, b1)))
    assert out.shape == (1, 16, 32, 896)
    _close(out.numpy(), out_j)
    _close(out.numpy(), ref_j)


def _port_grads(args, g):
    leaves = [_t(a).requires_grad_() for a in args]
    upshead.ups_head_taps(*leaves).backward(_t(g))
    return [t.grad.numpy() for t in leaves]


def test_backward_matches_explicit_taps_bwd(monkeypatch):
    args, g = _inputs(41)
    orig = pallas_upshead._pallas_impl
    monkeypatch.setitem(pallas_upshead.__dict__, "_pallas_impl",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    ref = pallas_upshead._explicit_taps_bwd(
        *[jnp.asarray(a) for a in args], jnp.asarray(g))
    for name, out, r in zip(("dp0", "dp1", "dp2", "dw1", "db1", "dw2t"),
                            _port_grads(args, g), ref):
        _close(out, r, name)


def test_backward_matches_vjp_of_reference():
    args, g = _inputs(42)
    _, vjp = jax.vjp(pallas_upshead._ups_head_taps_ref,
                     *[jnp.asarray(a) for a in args])
    for out, r in zip(_port_grads(args, g), vjp(jnp.asarray(g))):
        _close(out, r)


def test_backward_recomputes_h_through_the_h_mode(monkeypatch):
    """The backward gets h from ``ups_head_1x1`` (on the card: the kernel's
    h mode, counted as its own launch), once per backward."""
    args, g = _inputs(43, h=8, w=16)
    calls = []
    orig = upshead.ups_head_1x1
    monkeypatch.setattr(upshead, "ups_head_1x1",
                        lambda *a: calls.append(1) or orig(*a))
    _port_grads(args, g)
    assert len(calls) == 1
