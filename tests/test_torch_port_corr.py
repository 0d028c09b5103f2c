"""The window attention of the stage-3 refiner: the port's ``ops/corr``
functions and ``window_attention_plain`` (the kernel's plain version)
against the JAX package's ``fused_window_attention`` (Pallas, interpret
mode) and its XLA oracle ``fused_window_attention_reference``, on
numpy-seeded inputs, on the CPU.  The CUDA kernel itself is held to the
plain version on the card by chip_smoke.py.

Tolerances: f32 out atol 1e-5 and flow exactly equal (the same math summed
in another order; random similarities have no near-ties at that size).
bf16 out atol 5e-2 and flow differing on < 10% of the pixels, the JAX
package's own bound for its kernel against its oracle
(test_pallas_corr.py:55-77): near-tied similarities flip under bf16
rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.ops import corr as jcorr
from deep_video_interpolation_extrapolation_tpu.ops.pallas_corr import (
    fused_window_attention,
    fused_window_attention_reference,
)
from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.ops import corr
from deep_video_interpolation_extrapolation_tpu_torch.ops.window_attn import (
    window_attention,
    window_attention_plain,
)

torch.set_num_threads(1)

B, H, W, C = 2, 8, 16, 128


def _rand(shape, seed, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _inputs(seed=0, shape=(B, H, W, C)):
    return [_rand(shape, seed + i) for i in range(5)]


def _jax(fn, ins, win, dtype=jnp.float32, **kw):
    out, flow = fn(*(jnp.asarray(a, dtype) for a in ins), win_h=win[0],
                   win_w=win[1], **kw)
    return np.asarray(out, np.float32), np.asarray(flow)


def _port(ins, win, dtype=torch.float32):
    out, flow = window_attention_plain(
        *(torch.from_numpy(a).to(dtype) for a in ins), *win)
    return out.float().numpy(), flow.numpy()


@pytest.mark.parametrize("win", [(3, 3), (5, 9)])
def test_plain_matches_the_pallas_kernel_and_its_oracle(win):
    ins = _inputs()
    out, flow = _port(ins, win)
    assert out.shape == (B, H, W, C) and flow.shape == (B, H, W, 4)
    for ref_out, ref_flow in (
            _jax(fused_window_attention, ins, win, interpret=True),
            _jax(fused_window_attention_reference, ins, win)):
        np.testing.assert_allclose(out, ref_out, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(flow, ref_flow)


@pytest.mark.parametrize("name", ["window_correlation", "window_aggregate",
                                  "argmax_flow"])
def test_corr_functions_match_jax(name):
    x, t1, t2 = _inputs()[:3]
    prob = _rand((B, H, W, 2 * 45), 9, 0.0, 1.0)
    if name == "window_correlation":
        got = corr.window_correlation(torch.from_numpy(x), [
            torch.from_numpy(t1), torch.from_numpy(t2)])
        want = jcorr.window_correlation(jnp.asarray(x), [
            jnp.asarray(t1), jnp.asarray(t2)])
    elif name == "window_aggregate":
        got = corr.window_aggregate(
            [torch.from_numpy(t1), torch.from_numpy(t2)],
            torch.from_numpy(prob))
        want = jcorr.window_aggregate([jnp.asarray(t1), jnp.asarray(t2)],
                                      jnp.asarray(prob))
    else:
        got = corr.argmax_flow(torch.from_numpy(prob), 2)
        want = jcorr.argmax_flow(jnp.asarray(prob), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert got.dtype == torch.float32


def test_flow_decodes_a_known_shift():
    """A neighbour equal to the query shifted by (dy, dx) is found by the
    argmax flow (test_pallas_corr.py:35-49)."""
    q = _rand((1, 8, 8, 6), 5)
    # k1[p] = q[p + (1, 2)], so shifted k1 at offset (-1, -2) equals q
    k1 = np.roll(q, shift=(-1, -2), axis=(1, 2))
    k2, v = _rand((1, 8, 8, 6), 6), _rand((1, 8, 8, 3), 7)
    ins = [q, k1, k2, v, v]
    _, flow = _port(ins, (3, 5))
    inner = flow[0, 2:-2, 3:-3]
    assert np.all(inner[..., 0] == -2) and np.all(inner[..., 1] == -1)
    np.testing.assert_array_equal(
        flow, _jax(fused_window_attention, ins, (3, 5), interpret=True)[1])


def test_all_negative_similarities_pick_a_padded_offset():
    """Where every in-range similarity is negative, a zero-padded offset
    (s = 0) is the argmax: the first one in (wy, wx) order, as in the
    reference's zero-pad unfold."""
    q = _rand((1, 6, 10, 8), 11, 0.5, 1.0)
    k1 = -_rand((1, 6, 10, 8), 12, 0.5, 1.0)
    ins = [q, k1, k1, _rand((1, 6, 10, 4), 13), _rand((1, 6, 10, 4), 14)]
    out, flow = _port(ins, (3, 3))
    # (dx, dy) of the first padded offset: top row -> (-1, -1), bottom row
    # -> (-1, +1), right column -> (+1, -1)
    assert tuple(flow[0, 0, 5, :2]) == (-1, -1)
    assert tuple(flow[0, 5, 5, :2]) == (-1, 1)
    assert tuple(flow[0, 3, 9, 2:]) == (1, -1)
    for ref_out, ref_flow in (
            _jax(fused_window_attention, ins, (3, 3), interpret=True),
            _jax(fused_window_attention_reference, ins, (3, 3))):
        np.testing.assert_allclose(out, ref_out, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(flow, ref_flow)


def test_bfloat16_inputs():
    ins = _inputs(20)
    out, flow = _port(ins, (5, 9), torch.bfloat16)
    for ref_out, ref_flow in (
            _jax(fused_window_attention, ins, (5, 9), jnp.bfloat16,
                 interpret=True),
            _jax(fused_window_attention_reference, ins, (5, 9),
                 jnp.bfloat16)):
        np.testing.assert_allclose(out, ref_out, atol=5e-2, rtol=0)
        assert np.mean(np.any(flow != ref_flow, axis=-1)) < 0.1


def test_cpu_route_is_the_plain_version():
    ins = [torch.from_numpy(a) for a in _inputs(30)]
    before = dict(hw.launches)
    got = window_attention(*ins)
    want = window_attention_plain(*ins)
    assert hw.launches == before
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_raises_for_inputs_that_require_grad():
    """No backward (stage-3 training is not ported): the wrapper refuses
    inputs that need one, and takes them under no_grad."""
    ins = [torch.from_numpy(a) for a in _inputs(40, (1, 4, 8, 16))]
    ins[0].requires_grad_()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        window_attention(*ins)
    with torch.no_grad():
        out, flow = window_attention(*ins)
    assert out.shape == (1, 4, 8, 16) and flow.shape == (1, 4, 8, 4)
