"""The shifted add + bias (``ops/shiftadd.py``, plain version on the CPU)
against the JAX package's ``pallas_shiftadd`` kernel run as its own tests
run it off-TPU (``_impl(interpret=True)``), and its gradient against
``jax.vjp`` of the kernel's XLA reference ``_ref``.

Inputs from ``numpy.random.RandomState``, at ``tests/test_pallas_shiftadd``'s
shapes.  Tolerances: f32 max|d| <= 1e-5 (the same nine f32 adds in the same
order); bf16 max|d| <= 2e-2 * max|ref| (both round the f32 sum once, so
they differ by at most one bf16 step); grads f32 1e-5.  The CUDA kernel
runs only on the card, where chip_smoke.py holds it to this plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.ops import pallas_shiftadd as S
from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.ops import shiftadd

torch.set_num_threads(1)

SHAPES = [(1, 16, 64, 23), (2, 32, 64, 12)]


def _mk(b, h, w, co, seed=0):
    rng = np.random.RandomState(seed)
    yt = rng.uniform(-1, 1, (b, h, w, 9 * co)).astype(np.float32)
    b2 = rng.uniform(-1, 1, (co,)).astype(np.float32)
    return yt, b2


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_pallas_shiftadd_f32(shape):
    yt, b2 = _mk(*shape)
    ref = np.asarray(S._impl(jnp.asarray(yt), jnp.asarray(b2),
                             interpret=True))
    hw.reset_counters()
    out = shiftadd.shifted_add_bias(torch.from_numpy(yt),
                                    torch.from_numpy(b2))
    assert hw.launches["shifted_add_bias"] == 0        # CPU: plain version
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_pallas_shiftadd_bf16(shape):
    yt, b2 = _mk(*shape, seed=1)
    ref = np.asarray(S._impl(jnp.asarray(yt, jnp.bfloat16),
                             jnp.asarray(b2), interpret=True), np.float32)
    out = shiftadd.shifted_add_bias(torch.from_numpy(yt).bfloat16(),
                                    torch.from_numpy(b2))
    assert out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - ref).max() <= 2e-2 * np.abs(ref).max()


def test_edge_rows_and_columns_see_zero_padding():
    """An all-ones taps tensor: interior pixels sum 9 taps, edges 6, corners
    4 (plus the bias)."""
    yt = torch.ones(1, 5, 7, 9 * 4)
    out = shiftadd.shifted_add_bias_plain(yt, torch.full((4,), 0.5))
    assert float(out[0, 2, 3, 0]) == 9.5
    assert float(out[0, 0, 3, 1]) == 6.5 and float(out[0, 2, 0, 2]) == 6.5
    assert float(out[0, 0, 0, 3]) == 4.5 and float(out[0, 4, 6, 0]) == 4.5


@pytest.mark.parametrize("shape", SHAPES)
def test_grads_match_jax_vjp_of_ref(shape):
    yt, b2 = _mk(*shape, seed=2)
    g = np.random.RandomState(3).uniform(
        -1, 1, shape[:3] + (shape[3],)).astype(np.float32)
    _, vjp = jax.vjp(S._ref, jnp.asarray(yt), jnp.asarray(b2))
    gy_ref, gb_ref = vjp(jnp.asarray(g))
    yt_t = torch.from_numpy(yt).requires_grad_()
    b2_t = torch.from_numpy(b2).requires_grad_()
    shiftadd.shifted_add_bias(yt_t, b2_t).backward(torch.from_numpy(g))
    np.testing.assert_allclose(yt_t.grad.numpy(), np.asarray(gy_ref),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(b2_t.grad.numpy(), np.asarray(gb_ref),
                               atol=1e-5 * g.size ** 0.5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_keeps_no_tensor_and_equals_plain_autograd(dtype):
    """The op is linear: its backward saves nothing for the backward (not
    the taps tensor) and gives the grads of autograd through the plain
    version, the taps grad exactly (one g value each), the bias grad up to
    the order of its f32 sum."""
    yt, b2 = _mk(2, 8, 16, 5, seed=4)
    g = torch.from_numpy(np.random.RandomState(5).uniform(
        -1, 1, (2, 8, 16, 5)).astype(np.float32)).to(dtype)
    grads, saved = [], []
    for fn in (shiftadd.shifted_add_bias, shiftadd.shifted_add_bias_plain):
        yt_t = torch.from_numpy(yt).to(dtype).requires_grad_()
        b2_t = torch.from_numpy(b2).requires_grad_()
        packed = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: packed.append(t) or t, lambda t: t):
            out = fn(yt_t, b2_t)
        out.backward(g)
        grads.append((yt_t.grad, b2_t.grad))
        saved.append(packed)
    assert saved[0] == []
    assert grads[0][0].dtype == dtype and grads[0][1].dtype == torch.float32
    assert torch.equal(grads[0][0], grads[1][0])
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=1e-5,
                               atol=1e-5)


def test_rejects_a_bias_that_does_not_match():
    with pytest.raises(ValueError, match="9\\*co"):
        shiftadd.shifted_add_bias(torch.zeros(1, 2, 2, 27), torch.zeros(4))
