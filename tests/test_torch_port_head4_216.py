"""The 4-part head at N2 = 216, its h mode and its explicit backward
(``ops/upshead.py``: ``ups_head_taps4``, ``ups_head_1x1_4``,
``ups_head_taps4_bwd``) against the JAX package's ``pallas_upshead``: the
XLA references ``_ups_head_taps_ref4`` / ``_ups_head_ref4``, the Pallas
kernel ``_pallas_impl4`` in interpret mode (taps mode, and ``w2t=None``,
its h mode) where ``fits4`` holds, and ``jax.vjp`` of
``_ups_head_taps_ref4``.

f32 on both sides, inputs from ``numpy.random.RandomState``.  Tolerances:
the forwards against the Pallas kernel atol = rtol = 3e-4, those of
tests/test_torch_port_highres.py (its pre-dot multiplies p2 and p3 by their
W1 rows before upsampling, exact in real arithmetic), against the XLA
references max|d| <= 1e-4 * max(1, max|ref|) (the same f32 products summed
in another order); the backward max|d| <= 1e-4 * max(1, max|ref|) per
gradient, as tests/test_torch_port_head.py holds K4's.  The kernels
themselves run only on the card (chip_smoke.py holds them to these plain
versions); what surrounds a launch is held here.
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
from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.ops import (
    _build,
    upshead,
)

torch.set_num_threads(1)


def _close(out, ref, label="", tol=1e-4):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (label, out.shape, ref.shape)
    err, bound = np.abs(out - ref).max(), tol * max(1.0, np.abs(ref).max())
    assert err <= bound, f"{label} max|d| {err:.3g} > {bound:.3g}"


def _inputs(seed, b=1, h=16, w=64, rgb=4):
    """The pyramid, W1, b1 and the taps matrix of a head of ``rgb`` + 20
    channels (4: ExtraInpaintNet's --inpaint_mask, N2 = 216; 3: N2 =
    207), and a cotangent of yt."""
    rng = np.random.RandomState(seed)
    parts = [rng.uniform(-1, 1, (b, h // f, w // f, c)).astype(np.float32)
             for f, c in ((1, 64), (2, 128), (4, 256), (8, 512))]
    w1 = rng.uniform(-0.05, 0.05, (960, 1920)).astype(np.float32)
    b1 = rng.uniform(-0.1, 0.1, (1920,)).astype(np.float32)
    w2r = rng.uniform(-0.05, 0.05, (3, 3, 960, rgb)).astype(np.float32)
    w2s = rng.uniform(-0.05, 0.05, (3, 3, 960, 20)).astype(np.float32)
    w2t = np.asarray(tapped_conv.build_dual_tap_kernel(
        jnp.asarray(w2r), jnp.asarray(w2s), jnp.float32))
    g = rng.normal(0, 1, (b, h, w, w2t.shape[1])).astype(np.float32)
    return parts + [w1, b1, w2t], g


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, order="C"))


@pytest.mark.parametrize("shape", [(1, 16, 64), (2, 16, 128)])
def test_taps4_216_matches_pallas_and_reference(shape):
    args, _ = _inputs(50, *shape)
    assert args[-1].shape[1] == 216
    jargs = [jnp.asarray(a) for a in args]
    assert pallas_upshead.fits4(*jargs[:4])
    out = upshead.ups_head_taps4(*map(_t, args)).numpy()
    np.testing.assert_allclose(
        out, np.asarray(pallas_upshead._pallas_impl4(*jargs, interpret=True)),
        atol=3e-4, rtol=3e-4)
    _close(out, pallas_upshead._ups_head_taps_ref4(*jargs))
    _close(upshead.ups_head_taps4_plain(*map(_t, args)).numpy(),
           pallas_upshead._ups_head_taps_ref4(*jargs))


def test_h_mode_matches_pallas_and_reference():
    """``ups_head_1x1_4`` (on the CPU its plain version) against
    ``_pallas_impl4(..., w2t=None)``, the TPU kernel's h mode, and
    ``_ups_head_ref4``."""
    args, _ = _inputs(51)
    jargs = [jnp.asarray(a) for a in args[:6]]
    out = upshead.ups_head_1x1_4(*map(_t, args[:6])).numpy()
    assert out.shape == (1, 16, 64, 1920)
    np.testing.assert_allclose(
        out, np.asarray(pallas_upshead._pallas_impl4(*jargs, interpret=True)),
        atol=3e-4, rtol=3e-4)
    _close(out, pallas_upshead._ups_head_ref4(*jargs))


def _port_grads(args, g):
    leaves = [_t(a).requires_grad_() for a in args]
    upshead.ups_head_taps4(*leaves).backward(_t(g))
    return [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("rgb", [4, 3], ids=["N2=216", "N2=207"])
def test_backward_matches_vjp_of_reference(rgb):
    """The explicit backward (through autograd of ``ups_head_taps4``) and
    ``ups_head_taps4_bwd`` called directly, against ``jax.vjp`` of
    ``_ups_head_taps_ref4``: the JAX ``_bwd_taps4``."""
    args, g = _inputs(52, 1, 16, 64, rgb)
    _, vjp = jax.vjp(pallas_upshead._ups_head_taps_ref4,
                     *[jnp.asarray(a) for a in args])
    ref = vjp(jnp.asarray(g))
    names = ("dp0", "dp1", "dp2", "dp3", "dw1", "db1", "dw2t")
    for name, out, r in zip(names, _port_grads(args, g), ref):
        _close(out, r, name)
    for name, out, r in zip(names, upshead.ups_head_taps4_bwd(
            *map(_t, args), _t(g)), ref):
        _close(out.numpy(), r, name)


def test_backward_recomputes_h_through_the_h_mode(monkeypatch):
    """The backward gets h from ``ups_head_1x1_4`` (on the card the 4-part
    kernel's h mode, counted as ``ups_head_1x1_4``), once per backward, and
    the forward's autograd graph keeps no h."""
    args, g = _inputs(53, 1, 8, 64)
    calls = []
    orig = upshead.ups_head_1x1_4
    monkeypatch.setattr(upshead, "ups_head_1x1_4",
                        lambda *a: calls.append(1) or orig(*a))
    leaves = [_t(a).requires_grad_() for a in args]
    yt = upshead.ups_head_taps4(*leaves)
    assert calls == []
    assert {id(t) for t in yt.grad_fn.saved_tensors} == {
        id(t) for t in leaves}
    yt.backward(_t(g))
    assert len(calls) == 1


def _bf16(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def test_backward_takes_bf16_operands(monkeypatch):
    """Every product of the 4-part backward reads the bf16 operands as they
    are: seven products (dw2t, dh, dw1 of each of the four parts, dcat),
    each on bf16 operands; the grads come back in the operands' dtypes,
    dw1 and dw2t summed in f32."""
    args, g = _inputs(54, 1, 8, 64)
    targs = [_bf16(a) for a in args[:4]] + [_t(a) for a in args[4:]]
    h = upshead.ups_head_1x1_4(*targs[:6])
    assert h.dtype == torch.bfloat16
    seen = []
    for name in ("matmul", "mm"):
        orig = getattr(torch, name)

        def spy(a, b, *rest, _orig=orig, _name=name, **kw):
            seen.append((_name, a.dtype, b.dtype))
            return _orig(a, b, *rest, **kw)
        monkeypatch.setattr(torch, name, spy)
    grads = upshead.ups_head_taps4_bwd(*targs, _bf16(g), h=h)
    assert len(seen) == 7, seen
    assert all(a == b == torch.bfloat16 for _, a, b in seen), seen
    assert [t.dtype for t in grads[:4]] == [torch.bfloat16] * 4
    assert [tuple(t.shape) for t in grads] == [
        tuple(t.shape) for t in targs]


def test_taps4_weights_at_216():
    """The 216 instance's W2t chunks: the taps matrix zero-padded to 216
    columns, (N1/64, 8, 216, 8) K-major; the h mode's weights have no
    chunks."""
    args, _ = _inputs(55, 1, 8, 64)
    w1, b1, w2t = map(_t, args[4:])
    w1u, b1k, w2u = upshead.taps4_weights(w1, b1, w2t, "cpu")
    assert w2u.shape == (30, 8, 216, 8)
    back = w2u.permute(0, 1, 3, 2).reshape(1920, 216)
    assert torch.equal(back, w2t.to(torch.bfloat16))
    _, _, none = upshead.taps4_weights(w1, b1, None, "cpu")
    assert none is None


@pytest.fixture
def no_launch(monkeypatch):
    def library():
        raise AssertionError("the kernel library was reached")
    monkeypatch.setattr(_build, "library", library)
    hw.reset_counters()
    yield
    assert all(v == 0 for v in hw.launches.values())


@pytest.mark.parametrize("case,match", [
    ("n2", "N2 <= 216"), ("n1", "N1 % 64"), ("cpu", "CUDA")])
def test_wrappers_raise_before_any_launch(no_launch, case, match):
    """The taps mode takes N2 up to 216 and no more; the h mode takes N1 a
    multiple of 64; both want CUDA operands: each refusal is a
    ``ValueError`` before the library is reached."""
    args, _ = _inputs(56, 1, 8, 64)
    t = [_t(a).to(torch.bfloat16) for a in args[:4]] + list(
        map(_t, args[4:]))
    if case == "n2":
        with pytest.raises(ValueError, match=match):
            upshead._taps4_kernel(*t[:6], torch.zeros((1920, 217)))
    elif case == "n1":
        with pytest.raises(ValueError, match=match):
            upshead._taps4_kernel(*t[:4], torch.zeros((960, 1900)),
                                  torch.zeros((1900,)))
    else:
        upshead.check_taps4(*t)            # the shapes are taken
        with pytest.raises(ValueError, match=match):
            upshead._taps4_kernel(*t[:6])
