"""The train chain's plain versions (ops/trainchain.py) against the JAX
package's Pallas train-chain kernels, run as the JAX tests run them off-TPU
(``interpret=True``), forward and backward.

B=2, 16x32, planes 64, a stem (14 -> 64) and two Bottlenecks: block 0 with
the projection residual (64 -> 256), block 1 with the identity one.  Inputs
come from ``numpy.random.RandomState``; the JAX side differentiates with
``jax.grad`` through the kernels' custom_vjp (their hand-written backward
kernels), the port side with torch autograd through ``stem`` /
``bottleneck``, whose backward is the hand-written ``*_bwd_plain``.

Tolerances, f32 (those of tests/test_trainchain.py:85-115, which holds the
same kernels against XLA): forward max|d| <= 2e-4 (+ 2e-4 relative), the
two sides summing f32 products in another order; every gradient leaf
rel-L2 < 1e-2; the 90th percentile of |d(dx)| / max|dx| < 5e-5.  Stacked
lrelus make gradients discretely sensitive to forward rounding (a mask
flip at a near-zero pre-activation moves a few dx elements by up to
~3e-3), so the bulk must be tight and only the tail may move.

bf16: both sides round every product to bf16 at the same points, but sum
in another order and scale the lrelu slope as bf16(0.2) (JAX) or f32 0.2
(here); a few bf16 ulps (2^-8 relative) per layer over 6 convs: forward
max|d| <= 3e-2 * max(1, max|ref|); gradients as the bf16 test says.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.ops import pallas_trainchain
from deep_video_interpolation_extrapolation_tpu.ops.packed_conv import (
    pack_kernel_1x1,
    pack_kernel_3x3,
    pack_w,
    unpack_w,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops import trainchain

torch.set_num_threads(1)

B, H, W, CI = 2, 16, 32, 14


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32, order="C")).to(dtype)


def _oihw(k):
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _params(seed):
    """Logical HWIO f32 weights: stem (k1, b1, k2, b2) and two blocks
    ((k1, k2, k3, kres or None), ...)."""
    rng = np.random.RandomState(seed)

    def w(*shape):
        fan_in = np.prod(shape[:-1])
        return rng.normal(0, 1 / np.sqrt(fan_in), shape).astype(np.float32)

    stem = (w(3, 3, CI, 64), rng.uniform(-0.2, 0.2, 64).astype(np.float32),
            w(3, 3, 64, 64), rng.uniform(-0.2, 0.2, 64).astype(np.float32))
    blocks = [(w(1, 1, 64, 64), w(3, 3, 64, 64), w(1, 1, 64, 256),
               w(1, 1, 64, 256)),
              (w(1, 1, 256, 64), w(3, 3, 64, 64), w(1, 1, 64, 256), None)]
    return stem, blocks


def _port_params(stem, blocks):
    """The same weights as torch OIHW leaves that require grad."""
    def leaf(a):
        if a is None:
            return None
        t = _oihw(a) if np.ndim(a) == 4 else _t(a)
        return t.requires_grad_()
    return [leaf(a) for a in stem], [[leaf(a) for a in blk] for blk in blocks]


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(((a - b) ** 2).sum() / max((b ** 2).sum(), 1e-30))


def _grad_oihw(g):
    """A JAX grad leaf in the port's layout (HWIO -> OIHW)."""
    g = np.asarray(g, np.float32)
    return np.transpose(g, (3, 2, 0, 1)) if g.ndim == 4 else g


def _check_grads(jax_leaves, port_leaves, tol):
    """Leaf 0 is dx (NHWC on both sides), the rest are weight grads."""
    assert len(jax_leaves) == len(port_leaves)
    for i, (gj, gp) in enumerate(zip(jax_leaves, port_leaves)):
        ref = np.asarray(gj, np.float32) if i == 0 else _grad_oihw(gj)
        assert _rel_l2(gp, ref) < tol, (i, _rel_l2(gp, ref))


def _check_dx(dx, dx_ref):
    dx, dx_ref = np.asarray(dx, np.float64), np.asarray(dx_ref, np.float64)
    rel = np.abs(dx - dx_ref) / (np.abs(dx_ref).max() + 1e-6)
    assert np.quantile(rel, 0.9) < 5e-5, np.quantile(rel, 0.9)


def _chain_inputs():
    stem, blocks = _params(0)
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (B, H, W, CI)).astype(np.float32)
    ct = rng.normal(0, 1, (B, H, W, 256)).astype(np.float32)
    return stem, blocks, x, ct


@functools.lru_cache(maxsize=None)
def _jax_chain(dtype):
    """``stem_layer1_chain(..., interpret=True)``: (y, [dx, stem grads,
    block grads]) as numpy, weight grads in the port's OIHW layout."""
    stem, blocks, x, ct = _chain_inputs()
    jdt = jnp.dtype(dtype)

    def chain(x, stem, blocks):
        return pallas_trainchain.stem_layer1_chain(
            x.astype(jdt), stem, blocks, 2, True)

    jstem = tuple(jnp.asarray(a) for a in stem)
    jblocks = [tuple(None if a is None else jnp.asarray(a) for a in blk)
               for blk in blocks]
    y = np.asarray(chain(jnp.asarray(x), jstem, jblocks), np.float32)
    g = jax.grad(lambda *a: jnp.sum(chain(*a).astype(jnp.float32) * ct),
                 argnums=(0, 1, 2))(jnp.asarray(x), jstem, jblocks)
    leaves = [np.asarray(g[0], np.float32)] + [_grad_oihw(a) for a in (
        list(g[1]) + [a for blk in g[2] for a in blk if a is not None])]
    return y, leaves


def _port_chain(dtype):
    stem, blocks, x, ct = _chain_inputs()
    xt = _t(x).requires_grad_()
    pstem, pblocks = _port_params(stem, blocks)
    y = trainchain.stem_layer1(xt.to(getattr(torch, dtype)), pstem, pblocks)
    (y.float() * _t(ct)).sum().backward()
    leaves = [xt] + pstem + [p for blk in pblocks for p in blk
                             if p is not None]
    return y.detach().float().numpy(), [p.grad.numpy() for p in leaves]


def test_chain_matches_stem_layer1_chain_f32():
    """The whole chain (stem + projection block + identity block), forward
    and every gradient leaf, against ``stem_layer1_chain`` in f32."""
    y_j, g_j = _jax_chain("float32")
    y, g = _port_chain("float32")
    np.testing.assert_allclose(y, y_j, atol=2e-4, rtol=2e-4)
    assert len(g) == len(g_j)
    for i, (a, b) in enumerate(zip(g, g_j)):
        assert _rel_l2(a, b) < 1e-2, (i, _rel_l2(a, b))
    _check_dx(g[0], g_j[0])


def test_chain_matches_stem_layer1_chain_bf16():
    """The same chain in bf16.  Forward: max|d| <= 3e-2 * max(1, max|ref|)
    against the JAX bf16 chain.  Gradients: bf16 rounding alone puts both
    implementations ~8% (rel-L2) from the f32 gradient and 4-7% from each
    other (seeds 0 and 7), so each leaf's distance from the JAX f32
    gradient must be within 1.3x the JAX bf16 chain's own + 5e-3 (measured
    ratio <= 1.13)."""
    y_j, g_j = _jax_chain("bfloat16")
    _, g_ref = _jax_chain("float32")
    y, g = _port_chain("bfloat16")
    assert np.abs(y - y_j).max() <= 3e-2 * max(1.0, np.abs(y_j).max())
    for i, (a, b, r) in enumerate(zip(g, g_j, g_ref)):
        bound = 1.3 * _rel_l2(b, r) + 5e-3
        assert _rel_l2(a, r) <= bound, (i, _rel_l2(a, r), bound)


def _packed_stem(x, k1, b1, k2, b2):
    return unpack_w(pallas_trainchain.packed_stem(
        pack_w(x, 2), pack_kernel_3x3(k1, 2), jnp.tile(b1, 2)[None],
        pack_kernel_3x3(k2, 2), jnp.tile(b2, 2)[None], True), 2)


def _packed_block(x, k1, k2, k3, kres):
    return unpack_w(pallas_trainchain.packed_bottleneck(
        pack_w(x, 2), pack_kernel_1x1(k1, 2)[0, 0], pack_kernel_3x3(k2, 2),
        pack_kernel_1x1(k3, 2)[0, 0],
        None if kres is None else pack_kernel_1x1(kres, 2)[0, 0], True), 2)


@pytest.mark.parametrize("which", ["stem", "projection", "identity"])
def test_kernel_pair_matches_packed_kernel(which):
    """Each plain forward / hand-written backward pair against its Pallas
    kernel pair (``packed_stem`` / ``packed_bottleneck``, interpret mode,
    packed operands built by the JAX packers), f32."""
    stem, blocks = _params(2)
    rng = np.random.RandomState(3)
    if which == "stem":
        params, ci, co = stem, CI, 64
        jfn, fwd, bwd = _packed_stem, trainchain.stem_plain, \
            trainchain.stem_bwd_plain
    else:
        params = blocks[0] if which == "projection" else blocks[1]
        ci, co = params[0].shape[2], 256
        if params[3] is None:
            jfn, params = functools.partial(_packed_block, kres=None), params[:3]
        else:
            jfn = _packed_block
        fwd, bwd = trainchain.bottleneck_plain, trainchain.bottleneck_bwd_plain
    x = rng.uniform(-1, 1, (B, H, W, ci)).astype(np.float32)
    dy = rng.normal(0, 1, (B, H, W, co)).astype(np.float32)
    jparams = [jnp.asarray(a) for a in params]
    y_j, vjp = jax.vjp(jfn, jnp.asarray(x), *jparams)
    g_j = vjp(jnp.asarray(dy))

    tparams = [_oihw(a) if np.ndim(a) == 4 else _t(a) for a in params]
    y = fwd(_t(x), *tparams)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=2e-4,
                               rtol=2e-4)
    grads = [g for g in bwd(_t(x), _t(dy), *tparams) if g is not None]
    assert len(grads) == len(g_j)
    _check_grads(g_j, [g.numpy() for g in grads], 1e-2)
    _check_dx(grads[0].numpy(), g_j[0])
