"""The fused dual head (``ops/dual_head.py``, plain version on the CPU)
against the JAX package's ``pallas_head.fused_dual_head`` run in interpret
mode, as its own test runs it, in the JAX argument order and layouts.

Inputs from ``numpy.random.RandomState``.  Tolerances: f32 at
``tests/test_pallas_head``'s shape, max|d| <= 1e-5 (the same f32 products
summed in another order); bf16 at the serving width C = 448 on a 1x8x16
map, max|d| <= 2e-2 * max|ref| (h is rounded to bf16 on both sides; the
sums round once).  The kernel route (K4's taps mode on one part, then the
shift-add kernel) runs only on the card, where chip_smoke.py holds it to
this plain version and to the HRNet's own K4-route heads.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.ops.pallas_head import (
    fused_dual_head,
)
from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.ops import dual_head

torch.set_num_threads(1)


def _args(seed, b, h, w, c):
    rng = np.random.RandomState(seed)
    feat = rng.uniform(-1, 1, (b, h, w, c)).astype(np.float32)

    def mk(*shape, std):
        return rng.normal(0, std, shape).astype(np.float32)
    s1, s2 = 1 / np.sqrt(c), 1 / np.sqrt(9 * c)
    return [feat, mk(c, c, std=s1), mk(c, std=0.1), mk(3, 3, c, 3, std=s2),
            mk(3, std=0.1), mk(c, c, std=s1), mk(c, std=0.1),
            mk(3, 3, c, 20, std=s2), mk(20, std=0.1)]


def test_matches_pallas_head_f32():
    args = _args(0, 1, 16, 32, 16)
    ref = fused_dual_head(*map(jnp.asarray, args), seg_dim=20,
                          interpret=True)
    hw.reset_counters()
    out = dual_head.fused_dual_head(*map(torch.from_numpy, args), seg_dim=20)
    assert hw.launches["dual_head"] == 0               # CPU: plain version
    for o, r in zip(out, ref):
        assert o.shape == r.shape and o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=0)


def test_matches_pallas_head_bf16_at_serving_width():
    args = _args(1, 1, 8, 16, 448)
    ref = fused_dual_head(jnp.asarray(args[0], jnp.bfloat16),
                          *map(jnp.asarray, args[1:]), seg_dim=20,
                          interpret=True)
    out = dual_head.fused_dual_head(torch.from_numpy(args[0]).bfloat16(),
                                    *map(torch.from_numpy, args[1:]))
    for o, r in zip(out, ref):
        r = np.asarray(r, np.float32)
        assert o.dtype == torch.bfloat16 and o.shape == r.shape
        assert np.abs(o.float().numpy() - r).max() <= 2e-2 * np.abs(r).max()


def test_refuses_grad_and_a_wrong_seg_dim():
    args = [torch.from_numpy(a) for a in _args(2, 1, 4, 4, 16)]
    with pytest.raises(ValueError, match="seg_dim"):
        dual_head.fused_dual_head(*args, seg_dim=19)
    args[1].requires_grad_()
    with pytest.raises(NotImplementedError, match="backward"):
        dual_head.fused_dual_head(*args)
