"""The port's four kernel modules (plain versions, on the CPU) against the
JAX package's Pallas kernels, run as the JAX tests run them off-TPU
(``interpret=True``) and against their XLA references.

Inputs come from ``numpy.random.RandomState`` and go through both sides in
f32.  Tolerance: max|d| <= 1e-4 * max(1, max|ref|) — the two sides sum the
same f32 products in another order (conv/matmul blocking), which moves the
last few bits of an O(1) value; a wrong tap, edge or rounding point moves
it by O(1e-2) or more.  The CUDA/Triton kernels themselves run only on the
card and are held to these plain versions there by chip_smoke.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.ops import (
    pallas_ae_conv,
    pallas_chain,
    pallas_fuse0,
    pallas_upshead,
    tapped_conv,
)
from deep_video_interpolation_extrapolation_tpu.ops.packed_conv import (
    pack_kernel_1x1,
    pack_kernel_3x3,
    pack_w,
    unpack_w,
)
from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.ops import (
    _build,
    bottleneck_tail,
    conv3x3,
    fuse0,
    trainchain,
    upshead,
)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _oihw(k):
    """flax HWIO kernel -> torch OIHW weight."""
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _close(out, ref, tol=1e-4):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    bound = tol * max(1.0, np.abs(ref).max())
    err = np.abs(out - ref).max()
    assert err <= bound, f"max|d| {err:.3g} > {bound:.3g}"


def _hwnc(x):
    """NHWC -> the TPU kernels' width-packed HWNC view."""
    return jnp.transpose(pack_w(jnp.asarray(x), 2), (1, 2, 0, 3))


def _from_hwnc(y):
    return unpack_w(jnp.transpose(y, (2, 0, 1, 3)), 2)


# ---- K1 conv3x3_bias_res_lrelu vs pallas_ae_conv.conv3x3_packed_ae_hwnc

@pytest.mark.parametrize("b", [8, 2])
@pytest.mark.parametrize("cin,with_bias,with_res", [
    (64, True, False),     # stem conv2
    (256, False, False),   # transition1 trans_0
    (64, False, True),     # BasicBlock conv2
    (64, True, True),
])
def test_conv3x3_matches_pallas_ae_conv(b, cin, with_bias, with_res):
    rng = np.random.RandomState(cin + b + 2 * with_bias + with_res)
    x = rng.uniform(-1, 1, (b, 8, 32, cin)).astype(np.float32)
    k = rng.uniform(-0.1, 0.1, (3, 3, cin, 64)).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, (64,)).astype(np.float32) if with_bias else None
    res = rng.uniform(-1, 1, (b, 8, 32, 64)).astype(np.float32) if with_res else None

    out_j = pallas_ae_conv.conv3x3_packed_ae_hwnc(
        _hwnc(x), jnp.asarray(k), None if res is None else _hwnc(res), True,
        2, True, None if bias is None else jnp.asarray(bias))
    ref_j = pallas_ae_conv._ref_hwnc(
        _hwnc(x), jnp.asarray(k), None if res is None else _hwnc(res), True,
        2, bias=None if bias is None else jnp.asarray(bias))
    out = conv3x3.conv3x3_bias_res_lrelu(
        _t(x), _oihw(k), None if bias is None else _t(bias),
        None if res is None else _t(res), True)
    _close(out.numpy(), _from_hwnc(out_j))
    _close(out.numpy(), _from_hwnc(ref_j))


def test_conv3x3_zero_padding_edges():
    """SAME zero padding at the border: a constant input gives a border
    ring that differs from the interior by exactly the missing taps."""
    x = torch.ones(1, 4, 8, 32)
    w = torch.ones(64, 32, 3, 3)
    out = conv3x3.conv3x3_bias_res_lrelu(x, w, relu=False)
    assert float(out[0, 1, 1, 0]) == 9 * 32
    assert float(out[0, 0, 0, 0]) == 4 * 32
    assert float(out[0, 0, 3, 0]) == 6 * 32


# ---- K2 bottleneck_tail vs pallas_chain.fused_block

@pytest.mark.parametrize("has_res,has_next", [
    (True, True), (False, True), (True, False), (False, False)])
def test_bottleneck_tail_matches_pallas_chain(has_res, has_next):
    rng = np.random.RandomState(10 + 2 * has_res + has_next)
    b, h, w = 2, 8, 32
    cx = 64 if has_res else 256
    h1 = rng.uniform(0, 1, (b, h, w, 64)).astype(np.float32)
    x = rng.uniform(-1, 1, (b, h, w, cx)).astype(np.float32)
    k2 = rng.uniform(-0.05, 0.05, (3, 3, 64, 64)).astype(np.float32)
    k3 = rng.uniform(-0.1, 0.1, (1, 1, 64, 256)).astype(np.float32)
    kres = (rng.uniform(-0.1, 0.1, (1, 1, cx, 256)).astype(np.float32)
            if has_res else None)
    k1n = (rng.uniform(-0.1, 0.1, (1, 1, 256, 64)).astype(np.float32)
           if has_next else None)

    args = (_hwnc(h1), _hwnc(x), pack_kernel_3x3(jnp.asarray(k2), 2),
            pack_kernel_1x1(jnp.asarray(k3), 2)[0, 0],
            None if kres is None else pack_kernel_1x1(jnp.asarray(kres), 2)[0, 0],
            None if k1n is None else pack_kernel_1x1(jnp.asarray(k1n), 2)[0, 0])
    y_j, h1n_j = pallas_chain._block_impl(*args, interpret=True, ae=True)
    y_r, h1n_r = pallas_chain._block_ref(*args)
    y, h1n = bottleneck_tail.bottleneck_tail(
        _t(h1), _t(x), _oihw(k2), _oihw(k3),
        None if kres is None else _oihw(kres),
        None if k1n is None else _oihw(k1n))
    _close(y.numpy(), _from_hwnc(y_j))
    _close(y.numpy(), _from_hwnc(y_r))
    if has_next:
        _close(h1n.numpy(), _from_hwnc(h1n_j))
        _close(h1n.numpy(), _from_hwnc(h1n_r))
    else:
        assert h1n is None and h1n_j is None


# ---- K3 fuse_out0 vs pallas_fuse0.fused_out0

@pytest.mark.parametrize("with_t2", [False, True])
@pytest.mark.parametrize("extreme_border", [False, True])
def test_fuse_out0_matches_pallas_fuse0(with_t2, extreme_border):
    rng = np.random.RandomState(20 + with_t2)
    b, h, w, c = 1, 16, 64, 64
    y0 = rng.uniform(-1, 1, (b, h, w, c)).astype(np.float32)
    t1 = rng.uniform(-1, 1, (b, h // 2, w // 2, c)).astype(np.float32)
    t2 = rng.uniform(-1, 1, (b, h // 4, w // 4, c)).astype(np.float32)
    if extreme_border:
        # a clamp/zero-padding mix-up at the edges shows as O(1) errors
        t1[:, :, 0], t1[:, :, -1], t1[:, 0], t1[:, -1] = 7, -7, 5, -5
        t2[:, :, 0], t2[:, :, -1], t2[:, 0], t2[:, -1] = -6, 6, 4, -4
    t2 = t2 if with_t2 else None
    y0p = pack_w(jnp.asarray(y0), 2)
    t2j = None if t2 is None else jnp.asarray(t2)
    out_j = pallas_fuse0._impl(y0p, jnp.asarray(t1), t2j, False, interpret=True)
    ref_j = pallas_fuse0._ref(y0p, jnp.asarray(t1), t2j, False)
    out = fuse0.fuse_out0(_t(y0), _t(t1), None if t2 is None else _t(t2))
    _close(out.numpy(), out_j)
    _close(out.numpy(), ref_j)


# ---- K4 ups_head_taps vs pallas_upshead._pallas_impl(w2t=...)

def _head_inputs(seed, b=1, h=16, w=32):
    rng = np.random.RandomState(seed)
    p0 = rng.uniform(-1, 1, (b, h, w, 64)).astype(np.float32)
    p1 = rng.uniform(-1, 1, (b, h // 2, w // 2, 128)).astype(np.float32)
    p2 = rng.uniform(-1, 1, (b, h // 4, w // 4, 256)).astype(np.float32)
    w1 = rng.uniform(-0.1, 0.1, (448, 896)).astype(np.float32)
    b1 = rng.uniform(-0.1, 0.1, (896,)).astype(np.float32)
    w2r = rng.uniform(-0.05, 0.05, (3, 3, 448, 3)).astype(np.float32)
    w2s = rng.uniform(-0.05, 0.05, (3, 3, 448, 20)).astype(np.float32)
    return p0, p1, p2, w1, b1, w2r, w2s


@pytest.mark.parametrize("extreme_border", [False, True])
def test_ups_head_taps_matches_pallas_upshead(extreme_border):
    p0, p1, p2, w1, b1, w2r, w2s = _head_inputs(30)
    if extreme_border:
        p1[:, :, 0], p1[:, :, -1], p1[:, 0], p1[:, -1] = 7, -7, 5, -5
        p2[:, 0], p2[:, -1], p2[:, :, 0], p2[:, :, -1] = 5, -5, 3, -3
    w2t_j = tapped_conv.build_dual_tap_kernel(
        jnp.asarray(w2r), jnp.asarray(w2s), jnp.float32)
    jargs = [jnp.asarray(a) for a in (p0, p1, p2, w1, b1)]
    out_j = pallas_upshead._pallas_impl(*jargs, w2t=w2t_j, interpret=True)
    ref_j = pallas_upshead._ups_head_taps_ref(*jargs, w2t_j)
    w2t = upshead.build_dual_tap_kernel(_oihw(w2r), _oihw(w2s), torch.float32)
    out = upshead.ups_head_taps(_t(p0), _t(p1), _t(p2), _t(w1), _t(b1), w2t)
    assert out.shape == (1, 16, 32, 207)
    _close(out.numpy(), out_j)
    _close(out.numpy(), ref_j)


def test_build_dual_tap_kernel_matches_tapped_conv():
    """Exact: the same weights rearranged."""
    rng = np.random.RandomState(31)
    w2r = rng.uniform(-1, 1, (3, 3, 16, 3)).astype(np.float32)
    w2s = rng.uniform(-1, 1, (3, 3, 16, 20)).astype(np.float32)
    ref = tapped_conv.build_dual_tap_kernel(
        jnp.asarray(w2r), jnp.asarray(w2s), jnp.float32)
    out = upshead.build_dual_tap_kernel(_oihw(w2r), _oihw(w2s), torch.float32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_taps_shifted_add_matches_tapped_conv():
    rng = np.random.RandomState(32)
    yt = rng.uniform(-1, 1, (2, 6, 10, 9 * 23)).astype(np.float32)
    ref = tapped_conv.taps_shifted_add(jnp.asarray(yt), 23)
    _close(upshead.taps_shifted_add(_t(yt), 23).numpy(), ref)


def test_finish_taps_is_the_dual_3x3_conv():
    """taps product + shifted add + bias == both heads' 3x3 convs run
    directly (tapped_conv.dual_conv3x3_tapped's contract)."""
    rng = np.random.RandomState(33)
    h = rng.uniform(-1, 1, (1, 6, 10, 32)).astype(np.float32)
    w2r = rng.uniform(-0.3, 0.3, (3, 3, 16, 3)).astype(np.float32)
    w2s = rng.uniform(-0.3, 0.3, (3, 3, 16, 20)).astype(np.float32)
    b2 = rng.uniform(-0.1, 0.1, (23,)).astype(np.float32)
    w2t = upshead.build_dual_tap_kernel(_oihw(w2r), _oihw(w2s), torch.float32)
    out = upshead.finish_taps(_t(h) @ w2t, 23, _t(b2))
    r, s = tapped_conv.dual_conv3x3_tapped(
        jnp.asarray(h), jnp.asarray(w2r), jnp.asarray(b2[:3]),
        jnp.asarray(w2s), jnp.asarray(b2[3:]))
    _close(out[..., :3].numpy(), r)
    _close(out[..., 3:].numpy(), s)


# ---- routing, counters, build

def test_cpu_tensors_take_the_plain_versions_without_counting():
    hw.reset_counters()
    x = torch.randn(1, 4, 8, 64)
    conv3x3.conv3x3_bias_res_lrelu(x, torch.randn(64, 64, 3, 3))
    fuse0.fuse_out0(x, torch.randn(1, 2, 4, 64))
    assert hw.use_kernel(x) is False
    assert all(v == 0 for v in hw.launches.values())
    assert set(hw.launches) == set(hw.KERNELS)


def test_unknown_device_raises():
    with pytest.raises(RuntimeError):
        hw.use_kernel(torch.empty(1, device="meta"))


def _grad_cases():
    """(wrapper, plain version, argument shapes, which arguments are
    activations) for every kernel wrapper; None: an absent operand."""
    t3 = (1, 4, 8)
    return {
        "conv3x3": (conv3x3.conv3x3_bias_res_lrelu,
                    conv3x3.conv3x3_bias_res_lrelu_plain,
                    [t3 + (64,), (64, 64, 3, 3), (64,), t3 + (64,)]),
        "bottleneck_tail": (bottleneck_tail.bottleneck_tail,
                            bottleneck_tail.bottleneck_tail_plain,
                            [t3 + (64,), t3 + (64,), (64, 64, 3, 3),
                             (256, 64, 1, 1), (256, 64, 1, 1),
                             (64, 256, 1, 1)]),
        "fuse_out0": (fuse0.fuse_out0, fuse0.fuse_out0_plain,
                      [t3 + (64,), (1, 2, 4, 64), (1, 1, 2, 64)]),
        "ups_head_taps": (upshead.ups_head_taps, upshead.ups_head_taps_plain,
                          [t3 + (64,), (1, 2, 4, 128), (1, 1, 2, 256),
                           (448, 896), (896,), (896, 207)]),
        "stem": (trainchain.stem, trainchain.stem_plain,
                 [t3 + (14,), (64, 14, 3, 3), (64,), (64, 64, 3, 3), (64,)]),
        "bottleneck": (trainchain.bottleneck, trainchain.bottleneck_plain,
                       [t3 + (256,), (64, 256, 1, 1), (64, 64, 3, 3),
                        (256, 64, 1, 1), None]),
        "bottleneck_projection": (
            trainchain.bottleneck, trainchain.bottleneck_plain,
            [t3 + (64,), (64, 64, 1, 1), (64, 64, 3, 3), (256, 64, 1, 1),
             (256, 64, 1, 1)]),
    }


@pytest.mark.parametrize("name", list(_grad_cases()))
def test_no_grad_check_names_the_training_queue(name):
    """Every kernel wrapper is a ``torch.autograd.Function``: CPU tensors
    that require grad flow through it (its plain forward, then its own
    backward: recomputed autograd for K1-K3, the explicit backward for K4,
    the hand-written ones for the train chain) with grads equal to plain
    autograd of the plain version, up to f32 summation order."""
    fn, plain, shapes = _grad_cases()[name]
    rng = np.random.RandomState(len(name))
    args = [None if s is None else torch.from_numpy(
        rng.uniform(-0.5, 0.5, s).astype(np.float32)) for s in shapes]
    grads = []
    for f in (fn, plain):
        leaves = [None if a is None else a.clone().requires_grad_()
                  for a in args]
        out = f(*leaves)
        outs = [o for o in (out if isinstance(out, tuple) else (out,))
                if o is not None]
        assert all(o.requires_grad for o in outs)
        sum((o * torch.linspace(-1, 1, o.numel()).reshape(o.shape)).sum()
            for o in outs).backward()
        grads.append([None if a is None else a.grad for a in leaves])
    for g, ref in zip(*grads):
        if ref is None:
            assert g is None
        else:
            torch.testing.assert_close(g, ref, rtol=1e-4, atol=1e-5)


def test_build_is_keyed_by_sources_and_needs_nvcc(monkeypatch, tmp_path):
    path = _build.library_path()
    assert path.parent == _build.BUILD and path == _build.library_path()
    assert {p.name for p in _build.sources()} == {
        "conv3x3.cu", "bottleneck_tail.cu", "upshead.cu",
        "trainchain_stem.cu", "trainchain_bottleneck.cu"}
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here: the missing-compiler path "
                    "cannot be reached")
    monkeypatch.setattr(_build, "BUILD", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
