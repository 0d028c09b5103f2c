"""The BasicBlock chain's plain versions (ops/bbchain.py) against the JAX
package's Pallas BasicBlock kernels, run as the JAX tests run them off-TPU
(``interpret=True``), forward and backward; its route against the JAX
predicate; and the HRNet gradient on the chain route against ``jax.grad``
of the JAX HRNet.

Chain: B=2, 16x32, C = 64, N = 2 and 4, against
``pallas_trainchain.bb_chain_nhwc(x, pairs, f=2, interpret=True)``
differentiated by ``jax.grad`` through its custom_vjp (the Pallas backward
kernel); the port side by torch autograd through ``bb_chain``, whose
backward is the hand-written ``bb_chain_bwd_plain``.  Tolerances are those
of tests/test_torch_port_trainchain.py, for the same reasons: f32 forward
max|d| <= 2e-4 (+ 2e-4 relative), every gradient leaf rel-L2 < 1e-2, the
90th percentile of |d(dx)| / max|dx| < 5e-5 (a near-zero pre-activation
may flip a mask and move a few dx elements); bf16 forward max|d| <= 3e-2 *
max(1, max|ref|), and each leaf's rel-L2 from the JAX f32 gradient within
1.3x the JAX bf16 chain's own + 5e-3.

One BasicBlock (N = 1) is also ``pallas_resblock.fused_basicblock`` and
``pallas_bb.fused_basicblock_hwnc``: forward (f32, max|d| <= 2e-4 + 2e-4
relative) and backward (their custom_vjp rules, the vjp of their XLA
references; the tolerances above) against both.

The whole HRNet at B=1, 16x128, f32, where ``bb_chain_route`` holds: the
gradient of every parameter of a fixed random projection of both outputs
against ``jax.grad`` of the JAX HRNet on the same weights (which runs plain
BasicBlocks off-TPU: the same function), rel-L2 < 1e-2 per leaf and < 5e-3
for the whole gradient.  Both sides are f32 and differ only in the
summation order of ~50 convolutions, but stacked lrelus turn that into a
few mask flips at near-zero pre-activations, which add up toward the first
layers (measured: <= 4.4e-3, the seg encoder's biases).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.core.config import Config
from deep_video_interpolation_extrapolation_tpu.models import registry as jregistry
from deep_video_interpolation_extrapolation_tpu.ops import (
    pallas_bb,
    pallas_resblock,
    pallas_trainchain,
)
from deep_video_interpolation_extrapolation_tpu.ops.packed_conv import (
    pack_w,
    unpack_w,
)
from deep_video_interpolation_extrapolation_tpu_torch.models import (
    hrnet,
    registry,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops import bbchain
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    from_jax_params,
    key_map,
)

torch.set_num_threads(1)

B, H, W, C = 2, 16, 32, 64


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32, order="C")).to(dtype)


def _oihw(k):
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(((a - b) ** 2).sum() / max((b ** 2).sum(), 1e-30))


def _check_dx(dx, dx_ref):
    dx, dx_ref = np.asarray(dx, np.float64), np.asarray(dx_ref, np.float64)
    rel = np.abs(dx - dx_ref) / (np.abs(dx_ref).max() + 1e-6)
    assert np.quantile(rel, 0.9) < 5e-5, np.quantile(rel, 0.9)


def _inputs(n, seed=0):
    """x, the cotangent, and n (k1, k2) logical HWIO f32 pairs."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (B, H, W, C)).astype(np.float32)
    ct = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    pairs = [tuple(rng.normal(0, 1 / np.sqrt(9 * C), (3, 3, C, C))
                   .astype(np.float32) for _ in range(2)) for _ in range(n)]
    return x, ct, pairs


@functools.lru_cache(maxsize=None)
def _jax_chain(n, dtype):
    """(y, [dx, dk1_0, dk2_0, ...]) of ``bb_chain_nhwc`` as numpy, weight
    grads in the port's OIHW layout."""
    x, ct, pairs = _inputs(n)
    jdt = jnp.dtype(dtype)

    def chain(x, pairs):
        return pallas_trainchain.bb_chain_nhwc(x.astype(jdt), pairs, 2, True)

    jpairs = [tuple(map(jnp.asarray, p)) for p in pairs]
    y = np.asarray(chain(jnp.asarray(x), jpairs), np.float32)
    gx, gp = jax.grad(lambda *a: jnp.sum(chain(*a).astype(jnp.float32) * ct),
                      argnums=(0, 1))(jnp.asarray(x), jpairs)
    leaves = [np.asarray(gx, np.float32)] + [
        np.transpose(np.asarray(k, np.float32), (3, 2, 0, 1))
        for pair in gp for k in pair]
    return y, leaves


def _port_chain(n, dtype):
    x, ct, pairs = _inputs(n)
    xt = _t(x).requires_grad_()
    tpairs = [tuple(_oihw(k).requires_grad_() for k in p) for p in pairs]
    y = bbchain.bb_chain(xt.to(getattr(torch, dtype)), tpairs)
    (y.float() * _t(ct)).sum().backward()
    leaves = [xt] + [k for p in tpairs for k in p]
    return y.detach().float().numpy(), [p.grad.numpy() for p in leaves]


@pytest.mark.parametrize("n", [2, 4])
def test_chain_matches_basicblock_chain_f32(n):
    y_j, g_j = _jax_chain(n, "float32")
    y, g = _port_chain(n, "float32")
    np.testing.assert_allclose(y, y_j, atol=2e-4, rtol=2e-4)
    assert len(g) == len(g_j) == 1 + 2 * n
    for i, (a, b) in enumerate(zip(g, g_j)):
        assert _rel_l2(a, b) < 1e-2, (i, _rel_l2(a, b))
    _check_dx(g[0], g_j[0])


@pytest.mark.parametrize("n", [2, 4])
def test_chain_matches_basicblock_chain_bf16(n):
    y_j, g_j = _jax_chain(n, "bfloat16")
    _, g_ref = _jax_chain(n, "float32")
    y, g = _port_chain(n, "bfloat16")
    assert np.abs(y - y_j).max() <= 3e-2 * max(1.0, np.abs(y_j).max())
    for i, (a, b, r) in enumerate(zip(g, g_j, g_ref)):
        bound = 1.3 * _rel_l2(b, r) + 5e-3
        assert _rel_l2(a, r) <= bound, (i, _rel_l2(a, r), bound)


def _hwnc(a):
    """(B, H, W, C) -> width-packed HWNC (H, W/2, B, 2C)."""
    return jnp.transpose(pack_w(a, 2), (1, 2, 0, 3))


def _from_hwnc(a):
    return unpack_w(jnp.transpose(a, (2, 0, 1, 3)), 2)


_SINGLE = {
    # name: (the Pallas forward, the function its custom_vjp differentiates)
    "fused_basicblock": (
        lambda x, k1, k2: unpack_w(pallas_resblock._bb_impl(
            pack_w(x, 2), k1, k2, 2, interpret=True), 2),
        lambda x, k1, k2: unpack_w(pallas_resblock._basicblock_ref(
            pack_w(x, 2), k1, k2, 2), 2)),
    "fused_basicblock_hwnc": (
        lambda x, k1, k2: _from_hwnc(pallas_bb.fused_basicblock_hwnc(
            _hwnc(x), k1, k2, 2, True)),
        lambda x, k1, k2: _from_hwnc(pallas_bb.fused_basicblock_hwnc(
            _hwnc(x), k1, k2, 2, True))),
}


@pytest.mark.parametrize("name", sorted(_SINGLE))
def test_one_block_matches_single_basicblock_kernel(name):
    """N = 1: ``basicblock_plain`` and ``bb_chain_bwd_plain`` against the
    one-BasicBlock Pallas kernels (f32)."""
    fwd, diff = _SINGLE[name]
    x, ct, ((k1, k2),) = _inputs(1, seed=5)
    jargs = tuple(map(jnp.asarray, (x, k1, k2)))
    y_j = np.asarray(fwd(*jargs))
    _, vjp = jax.vjp(diff, *jargs)
    g_j = [np.asarray(g) for g in vjp(jnp.asarray(ct))]
    pair = (_oihw(k1), _oihw(k2))
    y = bbchain.basicblock_plain(_t(x), *pair)
    np.testing.assert_allclose(y.numpy(), y_j, atol=2e-4, rtol=2e-4)
    dx, ((dk1, dk2),) = bbchain.bb_chain_bwd_plain(_t(x), _t(ct), [pair])
    assert _rel_l2(dx.numpy(), g_j[0]) < 1e-2
    _check_dx(dx.numpy(), g_j[0])
    for d, g in ((dk1, g_j[1]), (dk2, g_j[2])):
        assert _rel_l2(d.numpy(), np.transpose(g, (3, 2, 0, 1))) < 1e-2


@pytest.mark.parametrize("b,h,w", [(24, 128, 128), (2, 128, 256),
                                   (2, 512, 1024), (1, 16, 128),
                                   (32, 128, 128), (8, 64, 128),
                                   (3, 128, 128), (2, 4, 128),
                                   (2, 16, 136), (2, 16, 120)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_route_matches_jax_bb_fits(b, h, w, dtype):
    """``bb_chain_route`` is ``packable`` and ``bb_fits`` on the packed
    shape; the recipe takes the chain, the serving shapes do not."""
    jdt = jnp.dtype(dtype)
    want = (w % 2 == 0 and w >= 128 and pallas_trainchain.bb_fits(
        jax.ShapeDtypeStruct((b, h, w // 2, 128), jdt), 4, dtype=jdt))
    assert hrnet.bb_chain_route(b, h, w, jdt.itemsize) == want
    if (b, h, w, dtype) == (24, 128, 128, "bfloat16"):
        assert want
    if (h, w) in ((128, 256), (512, 1024)) and dtype == "bfloat16":
        assert not want


def _cfg():
    return Config(runner="INTER", model="InterNet", syn_type="inter",
                  mode="xs2xs", coarse_model="HRNet",
                  compute_dtype="float32", input_h=16, input_w=128,
                  batch_size=1, dataset="synthetic")


def test_hrnet_gradient_on_the_chain_route(monkeypatch):
    """At 1x16x128 f32 both stages' branch 0 take ``bb_chain``; every
    parameter's gradient of sum(rgb * a) + sum(seg * b) matches
    ``jax.grad`` of the JAX HRNet."""
    hh, ww = 16, 128
    assert hrnet.bb_chain_route(1, hh, ww, 4)
    rng = np.random.RandomState(0)
    rgb = rng.uniform(-1, 1, (1, hh, ww, 6)).astype(np.float32)
    seg = np.eye(20, dtype=np.float32)[
        rng.randint(0, 20, (1, hh, ww, 2))].reshape(1, hh, ww, 40)
    ct_rgb = rng.normal(0, 1, (1, hh, ww, 3)).astype(np.float32)
    ct_seg = rng.normal(0, 1, (1, hh, ww, 20)).astype(np.float32)
    jmodel = jregistry.build_model(_cfg())
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(rgb),
                            jnp.asarray(seg), train=False)

    def loss(params):
        r, s = jmodel.apply({**variables, "params": params},
                            jnp.asarray(rgb), jnp.asarray(seg), train=False)
        return jnp.sum(r * ct_rgb) + jnp.sum(s * ct_seg)

    jgrads = jax.grad(loss)(variables["params"])["coarse_model"]
    params = jax.tree_util.tree_map(np.asarray,
                                    variables["params"]["coarse_model"])

    calls = []

    def spy(x, pairs):
        calls.append(tuple(x.shape))
        return bbchain.bb_chain(x, pairs)

    monkeypatch.setattr(hrnet, "bb_chain", spy)
    model = registry.build_model(_cfg(), device="cpu")
    model.coarse_model.load_state_dict(from_jax_params(params))
    r, s = model(torch.from_numpy(rgb), torch.from_numpy(seg))
    ((r.float() * _t(ct_rgb)).sum() + (s.float() * _t(ct_seg)).sum()).backward()
    assert calls == [(1, hh, ww, 64)] * 2
    grads = dict(model.coarse_model.named_parameters())
    ours, theirs = [], []
    for key, path in key_map(params):
        g = jgrads
        for p in path:
            g = g[p]
        g = np.asarray(g, np.float32)
        if g.ndim == 4:
            g = np.transpose(g, (3, 2, 0, 1))
        assert _rel_l2(grads[key].grad.numpy(), g) < 1e-2, key
        ours.append(grads[key].grad.numpy().ravel())
        theirs.append(g.ravel())
    assert len(ours) == len(grads)
    assert _rel_l2(np.concatenate(ours), np.concatenate(theirs)) < 5e-3
