"""MSResAttnRefineV2, V2Base and V3 (``PyramidAttnRefine``, the 3-level
pyramid with a 5x5 window), ported, against the JAX modules on the same
weights (``tools/jax_weights.from_jax_pyramid``) and numpy-seeded inputs,
with and without ``stage3_prop``; the weight map covering each JAX leaf
once.  Sizes and tolerances as test_torch_port_refine_models.py: B=2,
32x64, f32, CPU; outputs max|d| <= 1e-4 * max|ref|, flows equal on >=
99.9% of the pixels.
"""

import jax.numpy as jnp
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.models import (
    attn_refine as jar,
)
from deep_video_interpolation_extrapolation_tpu_torch.models import (
    attn_refine,
)
from deep_video_interpolation_extrapolation_tpu_torch.tools import (
    jax_weights,
)
from tests.test_torch_port_refine_models import (
    B,
    H,
    W,
    _close,
    _covers_every_leaf_once,
    _flows_agree,
    _jax_run,
    _load,
    _stage3_inputs,
)

torch.set_num_threads(1)


PYRAMID = {"v2": jar.MSResAttnRefineV2, "v2base": jar.MSResAttnRefineV2Base,
           "v3": jar.MSResAttnRefineV3}


@pytest.mark.parametrize("variant,prop", [("v2", True), ("v2", False),
                                          ("v2base", False), ("v3", True)])
def test_pyramid_matches_jax(variant, prop):
    ins = _stage3_inputs(4)
    params, (ref, ref_flows) = _jax_run(
        PYRAMID[variant](stage3_prop=prop, dtype=jnp.float32), ins)
    port = attn_refine.PyramidAttnRefine(variant, prop, dtype=torch.float32)
    assert _load(port, params) == []
    _covers_every_leaf_once(jax_weights.pyramid_key_map(params, variant),
                            params, port)
    assert sorted(port.state_dict()) == sorted(
        jax_weights.from_jax_pyramid(params, variant))
    with torch.no_grad():
        out, flows = port(*map(torch.from_numpy, ins))
    assert [tuple(o.shape) for o in out] == [
        (B, H // 4, W // 4, 3), (B, H // 2, W // 2, 3), (B, H, W, 3)]
    for got, want in zip(out, ref):
        _close(got, want)
    if variant == "v2base":
        assert flows is None and ref_flows is None
        return
    assert [tuple(f.shape) for f in flows] == [
        (B, 2, H // 16, W // 16, 2), (B, 2, H // 8, W // 8, 2),
        (B, 2, H // 4, W // 4, 2)]
    for got, want in zip(flows, ref_flows):
        _flows_agree(got, want)
