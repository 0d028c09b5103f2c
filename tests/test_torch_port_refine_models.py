"""The refine family's modules, ported, against the JAX package on the same
weights (each JAX module's init mapped with ``tools/jax_weights``) and the
same numpy-seeded inputs: ``SRNRefine`` at ``n_scales`` 3, ``RefineUnet``,
``MSResAttnRefine`` (V1) at ``n_scales`` 2 with and without
``stage3_prop`` and at one scale with it (V2, V2Base and V3:
test_torch_port_pyramid.py); every weight mapper covering each JAX leaf
once; the registry's names; and V1's attention route under autograd.

Sizes: B=2, 32x64, f32, CPU, the XLA path the JAX package takes there.
Tolerances: every output max|d| <= 1e-4 * max|ref| (the same f32 graph of
up to ~60 convolutions summed in another order); the flow maps, argmaxes
of f32 cosine similarities of random features, equal on >= 99.9% of the
pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.core.config import Config as JConfig
from deep_video_interpolation_extrapolation_tpu.models import (
    attn_refine as jar,
    optical as jopt,
    refine as jref,
    registry as jregistry,
)
from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.models import (
    attn_refine,
    optical,
    refine,
    registry,
)
from deep_video_interpolation_extrapolation_tpu_torch.tools import (
    jax_weights,
)

torch.set_num_threads(1)

B, H, W = 2, 32, 64
TOL = 1e-4
FLOW_AGREE = 0.999


def _rng(seed):
    return np.random.RandomState(seed)


def _soft(rng, c=20):
    z = rng.normal(size=(B, H, W, c)).astype(np.float32)
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _refine_inputs(seed=0):
    rng = _rng(seed)
    rgb = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    feat = rng.uniform(-1, 1, (B, H, W, 14)).astype(np.float32)
    return rgb, _soft(rng), feat


def _stage3_inputs(seed=0):
    rng = _rng(seed)
    img = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    soft = _soft(rng)
    nimg = rng.uniform(-1, 1, (B, H, W, 6)).astype(np.float32)
    nseg = np.eye(20, dtype=np.float32)[
        rng.randint(0, 20, (B, H, W, 2))].reshape(B, H, W, 40)
    return img, soft, nimg, nseg


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else \
        np.asarray(t, np.float32)


def _close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def _flows_agree(got, want):
    agree = np.mean(np.all(_np(got) == _np(want), axis=-1))
    assert agree >= FLOW_AGREE, agree


def _jax_run(module, ins, seed=0):
    args = [jnp.asarray(a) for a in ins]
    variables = module.init(jax.random.PRNGKey(seed), *args, train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return params, module.apply(variables, *args, train=False)


def _load(port, params):
    sd = jax_weights.from_jax_submodel(port, params)
    missing, unexpected = port.load_state_dict(sd, strict=False)
    assert not unexpected
    return missing


def _paths(params):
    return sorted(tuple(k.key for k in path) for path, _ in
                  jax.tree_util.tree_leaves_with_path(params))


def _covers_every_leaf_once(keys, params, port):
    keys = list(keys)
    assert sorted(p for _, p in keys) == _paths(params)
    names = [k for k, _ in keys]
    assert len(set(names)) == len(names)
    assert set(names) <= set(port.state_dict())


def test_srn_refine_three_scales_matches_jax():
    ins = _refine_inputs()
    params, ref = _jax_run(jref.SRNRefine(n_scales=3, dtype=jnp.float32), ins)
    port = refine.SRNRefine(n_scales=3, dtype=torch.float32)
    assert _load(port, params) == []
    # one core serves every scale: the same leaves as at one scale
    _covers_every_leaf_once(jax_weights.refine_key_map(params), params, port)
    assert sorted(jax_weights.from_jax_refine(params)) == sorted(
        port.state_dict())
    with torch.no_grad():
        out = port(*map(torch.from_numpy, ins))
    assert len(out) == len(ref) == 3
    assert [tuple(o.shape) for o in out] == [(B, H // 4, W // 4, 3),
                                              (B, H // 2, W // 2, 3),
                                              (B, H, W, 3)]
    for got, want in zip(out, ref):
        _close(got, want)


def test_srn_refine_hidden_state_carries_the_gradient():
    """Only the predictions are detached between scales (refine.py:109):
    the finest scale's loss reaches the coarsest input through the hidden
    state."""
    port = refine.SRNRefine(n_scales=2, dtype=torch.float32)
    registry.init_weights(port, 0)
    rgb, seg, feat = (torch.from_numpy(a) for a in _refine_inputs(1))
    feat.requires_grad_(True)
    out = port(rgb, seg, feat)
    out[-1].sum().backward()
    assert feat.grad is not None and float(feat.grad.abs().sum()) > 0


def test_refine_unet_matches_jax():
    ins = _refine_inputs(2)
    params, ref = _jax_run(jopt.RefineUnet(dtype=jnp.float32), ins)
    port = optical.RefineUnet(dtype=torch.float32)
    assert _load(port, params) == []
    _covers_every_leaf_once(jax_weights.refine_unet_key_map(params), params,
                            port)
    with torch.no_grad():
        out = port(*map(torch.from_numpy, ins))
    _close(out, ref)


@pytest.mark.parametrize("n_scales,prop", [(2, False), (2, True), (1, True)])
def test_v1_matches_jax(n_scales, prop):
    ins = _stage3_inputs(3)
    params, (ref, ref_flows) = _jax_run(
        jar.MSResAttnRefine(n_scales=n_scales, stage3_prop=prop,
                            dtype=jnp.float32), ins)
    port = attn_refine.MSResAttnRefine(n_scales, prop, dtype=torch.float32)
    missing = _load(port, params)
    # attn_fuse_layer runs (and is in the JAX tree) only at n_scales > 1
    assert missing == ([] if n_scales > 1 else [
        "attn_fuse_layer.0.weight", "attn_fuse_layer.0.bias",
        "attn_fuse_layer.2.weight", "attn_fuse_layer.2.bias"])
    _covers_every_leaf_once(jax_weights.stage3_key_map(params), params, port)
    with torch.no_grad():
        out, flows = port(*map(torch.from_numpy, ins))
    assert len(out) == len(flows) == len(ref) == n_scales
    for got, want in zip(out, ref):
        _close(got, want)
    for got, want in zip(flows, ref_flows):
        assert got.shape == want.shape
        _flows_agree(got, want)


@pytest.mark.parametrize("kw,kind", [
    (dict(refine_model="SRNRefine", n_scales=3), refine.SRNRefine),
    (dict(refine_model="refineUnet"), optical.RefineUnet),
    (dict(stage3_model="MSResAttnRefine", n_scales=2, stage3_prop=True),
     attn_refine.MSResAttnRefine),
    (dict(stage3_model="MSResAttnRefineV2", stage3_prop=True),
     attn_refine.PyramidAttnRefine),
    (dict(stage3_model="MSResAttnRefineV2Base"), attn_refine.PyramidAttnRefine),
    (dict(stage3_model="MSResAttnRefineV3"), attn_refine.PyramidAttnRefine)])
def test_registry_builds_what_the_jax_registry_builds(kw, kind):
    cfg = Config(model="InterStage3Net", compute_dtype="float32", **kw)
    jcfg = JConfig(model="InterStage3Net", compute_dtype="float32", **kw)
    build = registry.build_stage3 if "stage3_model" in kw else \
        registry.build_refine
    jbuild = jregistry.build_stage3 if "stage3_model" in kw else \
        jregistry.build_refine
    port, ref = build(cfg), jbuild(jcfg)
    assert isinstance(port, kind)
    if isinstance(port, attn_refine.PyramidAttnRefine):
        assert port.variant == ref.variant
    if hasattr(ref, "n_scales"):
        assert port.n_scales == ref.n_scales
    if hasattr(ref, "stage3_prop"):
        assert port.stage3_prop == ref.stage3_prop


def test_v1_attention_route_under_autograd(monkeypatch):
    """With grad on and trainable parameters, V1 at one scale runs the
    plain attention (the kernel has no backward); frozen or without grad
    it keeps its wrapper, here the kernel's, which refuses grad inputs."""
    calls = []
    port = attn_refine.MSResAttnRefine(dtype=torch.float32)
    registry.init_weights(port, 0)
    monkeypatch.setattr(port, "attention",
                        lambda *a: calls.append("wrapper") or
                        attn_refine.window_attention(*a))
    ins = [torch.from_numpy(a) for a in _stage3_inputs(5)]
    out, _ = port(*ins)
    assert calls == [] and out[0].requires_grad
    out[0].sum().backward()
    assert all(p.grad is not None for n, p in port.named_parameters()
               if not n.startswith("attn_fuse_layer."))
    with torch.no_grad():
        port(*ins)
    port.requires_grad_(False)
    port(*ins)
    assert calls == ["wrapper", "wrapper"]
