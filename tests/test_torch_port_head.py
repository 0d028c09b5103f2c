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


def _bf16(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_backward_bf16_matches_explicit_taps_bwd(monkeypatch):
    """bf16 activations and cotangent, f32 weights (the train step's
    dtypes): the port's autograd backward against ``_explicit_taps_bwd``
    in bf16, ``_pallas_impl`` in interpret mode, both on the h of that
    kernel's h mode (f32 sum and bias, one rounding, as the card's h mode
    rounds; the port's CPU h is the XLA reference's, rounded before the
    bias, and flips ~90 of its 458,752 signs here, which moves dp0 by 5%
    of its max through the lrelu mask).  Both take bf16 operands with f32
    accumulation and round dh, dcat and the pyramid grads to bf16; they
    differ by summation order, by the lrelu slope (bf16(0.2) in JAX) and,
    on this CPU, by the weight grads' bf16 output (the card's path returns
    them in f32): dp0..dp2 within max|d| <= 2e-2 * max|ref| (a few bf16
    ulps, 2^-8 each; 5e-3 here), dw1, db1, dw2t within rel-L2 1e-2 (a few
    2^-9 roundings; <= 2.5e-3 here)."""
    (p0, p1, p2, w1, b1, w2t), g = _inputs(44)
    orig = pallas_upshead._pallas_impl
    monkeypatch.setitem(pallas_upshead.__dict__, "_pallas_impl",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (p0, p1, p2)]
    ref = pallas_upshead._explicit_taps_bwd(
        *jb, jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2t),
        jnp.asarray(g, jnp.bfloat16))
    h_j = pallas_upshead.ups_head_1x1(*jb, jnp.asarray(w1), jnp.asarray(b1))
    h_t = _bf16(np.asarray(h_j.astype(jnp.float32)))
    monkeypatch.setattr(upshead, "ups_head_1x1", lambda *a: h_t)
    leaves = [_bf16(a).requires_grad_() for a in (p0, p1, p2)]
    leaves += [_t(a).requires_grad_() for a in (w1, b1, w2t)]
    upshead.ups_head_taps(*leaves).backward(_bf16(g))
    for name, leaf, r in zip(("dp0", "dp1", "dp2", "dw1", "db1", "dw2t"),
                             leaves, ref):
        out = leaf.grad.float().numpy()
        r = np.asarray(r.astype(jnp.float32))
        assert leaf.grad.dtype == leaf.dtype, name
        if name.startswith("dp"):
            err = np.abs(out - r).max() / np.abs(r).max()
            assert err <= 2e-2, f"{name} max|d|/max|ref| {err:.3g}"
        else:
            assert _rel_l2(out, r) <= 1e-2, f"{name} {_rel_l2(out, r):.3g}"


def test_backward_makes_no_f32_copy_of_bf16_operands(monkeypatch):
    """Every product of the backward reads the bf16 operands as they are:
    the dtypes that reach ``torch.matmul`` and ``torch.mm`` are bf16 (the
    weights cast to the compute dtype), none f32.  h comes from the h mode
    (on the card the kernel; here computed before the products are
    watched)."""
    (p0, p1, p2, w1, b1, w2t), g = _inputs(45, h=8, w=16)
    args = [_bf16(a) for a in (p0, p1, p2)] + [_t(a) for a in (w1, b1, w2t)]
    h = upshead.ups_head_1x1(*args[:5])
    monkeypatch.setattr(upshead, "ups_head_1x1", lambda *a: h)
    seen = []
    for name in ("matmul", "mm"):
        orig = getattr(torch, name)

        def spy(a, b, *rest, _orig=orig, _name=name, **kw):
            seen.append((_name, a.dtype, b.dtype))
            return _orig(a, b, *rest, **kw)
        monkeypatch.setattr(torch, name, spy)
    upshead.ups_head_taps_bwd(*args, _bf16(g))
    assert len(seen) == 6, seen   # dw2t, dh, dw1 x 3 parts, dcat
    assert all(a == b == torch.bfloat16 for _, a, b in seen), seen


def test_k4_unit_layouts():
    """``w1_units`` puts W1[k, n] at [n // 64, k // 64, (k % 64) // 8,
    n % 64, k % 8] (hidden chunk by hidden chunk, K-major core matrices);
    ``w2_chunks`` puts W2t[k, n] at [k // 64, (k % 64) // 8, n, k % 8] with
    the columns zero-padded to 208."""
    w1 = torch.arange(448 * 896, dtype=torch.float32).reshape(448, 896) % 251
    u = upshead.w1_units(w1, "cpu")
    assert u.shape == (14, 7, 8, 64, 8) and u.dtype == torch.bfloat16
    rng = np.random.RandomState(8)
    for k, n in rng.randint(0, [448, 896], (80, 2)):
        assert u[n // 64, k // 64, (k % 64) // 8, n % 64, k % 8] == w1[k, n]
    w2t = torch.arange(896 * 207, dtype=torch.float32).reshape(896, 207) % 253
    c = upshead.w2_chunks(w2t, "cpu")
    assert c.shape == (14, 8, upshead.N2_MAX, 8) and c.is_contiguous()
    for k, n in rng.randint(0, [896, 207], (80, 2)):
        assert c[k // 64, (k % 64) // 8, n, k % 8] == w2t[k, n]
    assert not c[:, :, 207:].any()


@pytest.mark.parametrize("c0,c1,c2,n1", [(64, 128, 320, 896),
                                         (64, 124, 260, 896),
                                         (64, 128, 256, 900)])
def test_k4_wrappers_refuse(c0, c1, c2, n1):
    """A concat wider than 448, channel counts off the 8/64 grid, or N1 %
    64: ``ValueError`` before any launch, for the taps and h modes."""
    p0 = torch.zeros((1, 8, 16, c0), dtype=torch.bfloat16)
    p1 = torch.zeros((1, 4, 8, c1), dtype=torch.bfloat16)
    p2 = torch.zeros((1, 2, 4, c2), dtype=torch.bfloat16)
    w1, b1 = torch.zeros((c0 + c1 + c2, n1)), torch.zeros((n1,))
    with pytest.raises(ValueError):
        upshead._taps_kernel(p0, p1, p2, w1, b1, torch.zeros((n1, 207)))
    with pytest.raises(ValueError):
        upshead._check(p0, p1, p2, w1, b1, n1)
