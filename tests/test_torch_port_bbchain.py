"""The BasicBlock chain's plain versions (ops/bbchain.py) against the JAX
package's Pallas BasicBlock kernels, run as the JAX tests run them off-TPU
(``interpret=True``), forward and backward; its route against the JAX
predicate, for every branch and ``DVIE_BBCHAIN`` mode; the wrapper's
refusals; and the HRNet gradient on each mode's chain route against
``jax.grad`` of the JAX HRNet.

Chain: B=2, 16x32, C = 64 (N = 2 and 4, against
``pallas_trainchain.bb_chain_nhwc(x, pairs, f=2, interpret=True)``, the
width-packed branch-0 route) and C = 128 and 256 (N = 2 and 4, against
``bb_chain_nhwc(x, pairs, f=1, interpret=True)``, the unpacked route of
branches 1 and 2), differentiated by ``jax.grad`` through its custom_vjp
(the Pallas backward kernel); where ``bb_fits`` refuses the whole chain
(C = 256, N = 4, f32: its weights alone take 36 of the 40 MiB budget) the
reference chains the kernel one block at a time, the same function.  The
port side is torch autograd through ``bb_chain``, whose backward is the
hand-written ``bb_chain_bwd_plain``.  Tolerances are those of
tests/test_torch_port_trainchain.py, for the same reasons: f32 forward
max|d| <= 2e-4 (+ 2e-4 relative), every gradient leaf rel-L2 < 1e-2, the
90th percentile of |d(dx)| / max|dx| < 5e-5 (a near-zero pre-activation
may flip a mask and move a few dx elements); bf16 forward max|d| <= 3e-2 *
max(1, max|ref|), and each leaf's rel-L2 from the JAX f32 gradient within
1.3x the JAX bf16 chain's own + 5e-3.

One BasicBlock (N = 1) is also ``pallas_resblock.fused_basicblock`` and
``pallas_bb.fused_basicblock_hwnc``: forward (f32, max|d| <= 2e-4 + 2e-4
relative) and backward (their custom_vjp rules, the vjp of their XLA
references; the tolerances above) against both.

The whole HRNet in f32, where ``bb_chain_route`` holds: the gradient of
every parameter of a fixed random projection of both outputs against
``jax.grad`` of the JAX HRNet on the same weights (which runs plain
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


def _inputs(n, seed=0, c=C):
    """x, the cotangent, and n (k1, k2) logical HWIO f32 pairs."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (B, H, W, c)).astype(np.float32)
    ct = rng.normal(0, 1, (B, H, W, c)).astype(np.float32)
    pairs = [tuple(rng.normal(0, 1 / np.sqrt(9 * c), (3, 3, c, c))
                   .astype(np.float32) for _ in range(2)) for _ in range(n)]
    return x, ct, pairs


@functools.lru_cache(maxsize=None)
def _jax_chain(n, dtype, c=C):
    """(y, [dx, dk1_0, dk2_0, ...]) of ``bb_chain_nhwc`` as numpy, weight
    grads in the port's OIHW layout: packed (f=2) at C = 64, unpacked at
    C = 128 and 256; block by block where ``bb_fits`` refuses the chain."""
    x, ct, pairs = _inputs(n, c=c)
    jdt = jnp.dtype(dtype)
    f = 2 if c == C else 1
    whole = pallas_trainchain.bb_fits(
        jax.ShapeDtypeStruct((B, H, W // f, c * f), jdt), n, dtype=jdt)

    def chain(x, pairs):
        x = x.astype(jdt)
        for part in ([pairs] if whole else [[p] for p in pairs]):
            x = pallas_trainchain.bb_chain_nhwc(x, part, f, True)
        return x

    jpairs = [tuple(map(jnp.asarray, p)) for p in pairs]
    y = np.asarray(chain(jnp.asarray(x), jpairs), np.float32)
    gx, gp = jax.grad(lambda *a: jnp.sum(chain(*a).astype(jnp.float32) * ct),
                      argnums=(0, 1))(jnp.asarray(x), jpairs)
    leaves = [np.asarray(gx, np.float32)] + [
        np.transpose(np.asarray(k, np.float32), (3, 2, 0, 1))
        for pair in gp for k in pair]
    return y, leaves


def _port_chain(n, dtype, c=C):
    x, ct, pairs = _inputs(n, c=c)
    xt = _t(x).requires_grad_()
    tpairs = [tuple(_oihw(k).requires_grad_() for k in p) for p in pairs]
    y = bbchain.bb_chain(xt.to(getattr(torch, dtype)), tpairs)
    (y.float() * _t(ct)).sum().backward()
    leaves = [xt] + [k for p in tpairs for k in p]
    return y.detach().float().numpy(), [p.grad.numpy() for p in leaves]


# (N, C); the C = 64 cases keep their ids
_CHAINS = [(2, 64), (4, 64), (2, 128), (4, 128), (2, 256), (4, 256)]
_CHAIN_IDS = ["2", "4", "2-c128", "4-c128", "2-c256", "4-c256"]


@pytest.mark.parametrize("n,c", _CHAINS, ids=_CHAIN_IDS)
def test_chain_matches_basicblock_chain_f32(n, c):
    y_j, g_j = _jax_chain(n, "float32", c)
    y, g = _port_chain(n, "float32", c)
    np.testing.assert_allclose(y, y_j, atol=2e-4, rtol=2e-4)
    assert len(g) == len(g_j) == 1 + 2 * n
    for i, (a, b) in enumerate(zip(g, g_j)):
        assert _rel_l2(a, b) < 1e-2, (i, _rel_l2(a, b))
    _check_dx(g[0], g_j[0])


@pytest.mark.parametrize("n,c", _CHAINS, ids=_CHAIN_IDS)
def test_chain_matches_basicblock_chain_bf16(n, c):
    y_j, g_j = _jax_chain(n, "bfloat16", c)
    _, g_ref = _jax_chain(n, "float32", c)
    y, g = _port_chain(n, "bfloat16", c)
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


def _cfg(hh=16, ww=128):
    return Config(runner="INTER", model="InterNet", syn_type="inter",
                  mode="xs2xs", coarse_model="HRNet",
                  compute_dtype="float32", input_h=hh, input_w=ww,
                  batch_size=1, dataset="synthetic")


def _hrnet_inputs(hh, ww):
    rng = np.random.RandomState(0)
    rgb = rng.uniform(-1, 1, (1, hh, ww, 6)).astype(np.float32)
    seg = np.eye(20, dtype=np.float32)[
        rng.randint(0, 20, (1, hh, ww, 2))].reshape(1, hh, ww, 40)
    ct_rgb = rng.normal(0, 1, (1, hh, ww, 3)).astype(np.float32)
    ct_seg = rng.normal(0, 1, (1, hh, ww, 20)).astype(np.float32)
    return rgb, seg, ct_rgb, ct_seg


@functools.lru_cache(maxsize=None)
def _jax_hrnet(hh, ww):
    """The JAX HRNet's parameters (numpy) and ``jax.grad`` of the
    projection loss at 1 x hh x ww (plain BasicBlocks off-TPU)."""
    rgb, seg, ct_rgb, ct_seg = _hrnet_inputs(hh, ww)
    jmodel = jregistry.build_model(_cfg(hh, ww))
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(rgb),
                            jnp.asarray(seg), train=False)

    def loss(params):
        r, s = jmodel.apply({**variables, "params": params},
                            jnp.asarray(rgb), jnp.asarray(seg), train=False)
        return jnp.sum(r * ct_rgb) + jnp.sum(s * ct_seg)

    jgrads = jax.grad(loss)(variables["params"])["coarse_model"]
    params = jax.tree_util.tree_map(np.asarray,
                                    variables["params"]["coarse_model"])
    return params, jgrads


def _port_hrnet(monkeypatch, mode, hh, ww, backward=True):
    """The port's HRNet on the JAX weights under ``DVIE_BBCHAIN=mode``:
    the input shapes ``bb_chain`` was called on, and the model."""
    monkeypatch.setenv("DVIE_BBCHAIN", mode)
    params, _ = _jax_hrnet(hh, ww)
    rgb, seg, ct_rgb, ct_seg = _hrnet_inputs(hh, ww)
    calls = []

    def spy(x, pairs):
        calls.append(tuple(x.shape))
        return bbchain.bb_chain(x, pairs)

    monkeypatch.setattr(hrnet, "bb_chain", spy)
    model = registry.build_model(_cfg(hh, ww), device="cpu")
    model.coarse_model.load_state_dict(from_jax_params(params))
    with torch.set_grad_enabled(backward):
        r, s = model(torch.from_numpy(rgb), torch.from_numpy(seg))
    if backward:
        ((r.float() * _t(ct_rgb)).sum()
         + (s.float() * _t(ct_seg)).sum()).backward()
    return calls, model


def _check_hrnet_grads(model, hh, ww):
    params, jgrads = _jax_hrnet(hh, ww)
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


def test_hrnet_gradient_on_the_chain_route(monkeypatch):
    """At 1x16x128 f32 both stages' branch 0 take ``bb_chain`` (the
    default ``b0``); every parameter's gradient of sum(rgb * a) + sum(seg
    * b) matches ``jax.grad`` of the JAX HRNet."""
    hh, ww = 16, 128
    assert hrnet.bb_chain_route(1, hh, ww, 4)
    calls, model = _port_hrnet(monkeypatch, "b0", hh, ww)
    assert calls == [(1, hh, ww, 64)] * 2
    _check_hrnet_grads(model, hh, ww)


# the chain's calls of one forward per mode, in branch order (stage2's
# branches, then stage3's): at 1x16x128 branch 0 (64 ch, 16x128) is
# packable and fits, branch 1 (128 ch, 8x64) fits, branch 2 (256 ch,
# 4x32) does not (h < 8); at 1x32x64 branch 0 is not packable (W < 128)
# and, unpacked at 64 ch, fails bb_fits's c % 128, branches 1 (16x32) and 2
# (256 ch, 8x16) fit
_B0, _B1 = (1, 16, 128, 64), (1, 8, 64, 128)
_MODE_CALLS = {
    ("b0", 16, 128): [_B0, _B0],
    ("rest", 16, 128): [_B1, _B1],
    ("all", 16, 128): [_B0, _B1, _B0, _B1],
    ("0", 16, 128): [],
    ("other", 16, 128): [],      # an unknown value routes nothing, as in JAX
    ("b0", 32, 64): [],
    ("rest", 32, 64): [(1, 16, 32, 128), (1, 16, 32, 128), (1, 8, 16, 256)],
    ("all", 32, 64): [(1, 16, 32, 128), (1, 16, 32, 128), (1, 8, 16, 256)],
}


@pytest.mark.parametrize("mode,hh,ww", sorted(_MODE_CALLS))
def test_hrnet_chain_branches_per_mode(monkeypatch, mode, hh, ww):
    """Under each ``DVIE_BBCHAIN`` value the port's HRNet sends exactly the
    branches ``bb_chain_route`` names through ``bb_chain``."""
    calls, _ = _port_hrnet(monkeypatch, mode, hh, ww, backward=False)
    assert calls == _MODE_CALLS[(mode, hh, ww)]


@pytest.mark.parametrize("mode,hh,ww", [("rest", 16, 128), ("all", 16, 128),
                                        ("rest", 32, 64)])
def test_hrnet_gradient_per_mode(monkeypatch, mode, hh, ww):
    """Under ``rest`` and ``all`` (branch 1 at 128 ch, and at 1x32x64
    branch 2 at 256 ch, on the chain) the port's gradient matches
    ``jax.grad`` of the JAX HRNet, as on the default route."""
    calls, model = _port_hrnet(monkeypatch, mode, hh, ww)
    assert calls == _MODE_CALLS[(mode, hh, ww)]
    _check_hrnet_grads(model, hh, ww)


# (b, h, w, c): the three branches at the 24x128x128 recipe, at a 4x64x128
# input (where branch 2 fits), at serving shapes, and odd sizes
_ROUTE_SHAPES = [(24, 128, 128, 64), (24, 64, 64, 128), (24, 32, 32, 256),
                 (4, 64, 128, 64), (4, 32, 64, 128), (4, 16, 32, 256),
                 (2, 128, 256, 64), (2, 64, 128, 128), (2, 32, 64, 256),
                 (2, 512, 1024, 64), (2, 256, 512, 128), (1, 16, 128, 64),
                 (1, 8, 64, 128), (1, 4, 32, 256), (1, 8, 16, 256),
                 (2, 16, 120, 64), (3, 12, 40, 128), (32, 64, 64, 128)]


def _jax_route(b, h, w, c, jdt, mode):
    """The JAX route of one branch (hrnet.py:146-186) without its TPU
    tests: ``packable``, ``_bb_allowed``, the channel test and ``bb_fits``
    on the packed or unpacked shape."""
    packable = c == 64 and w % 2 == 0 and w >= 128
    allowed = (mode == "all" or (mode == "b0" and packable)
               or (mode == "rest" and not packable))
    if not allowed:
        return False
    shape = (b, h, w // 2, 2 * c) if packable else (b, h, w, c)
    return pallas_trainchain.bb_fits(jax.ShapeDtypeStruct(shape, jdt), 4,
                                     dtype=jdt)


@pytest.mark.parametrize("mode", ["all", "b0", "rest", "0", "other"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_route_per_branch_and_mode(mode, dtype):
    """``bb_chain_route`` per branch and mode against the JAX arithmetic;
    at the bf16 recipe ``b0`` takes branch 0, ``rest`` branch 1, ``all``
    both, and branch 2 (256 ch at 32x32) none; at 4x64x128 it does."""
    jdt = jnp.dtype(dtype)
    got = {s: hrnet.bb_chain_route(*s[:3], jdt.itemsize, 4, s[3], mode)
           for s in _ROUTE_SHAPES}
    for s, g in got.items():
        assert g == _jax_route(*s, jdt, mode), (s, g)
    if dtype == "bfloat16":
        recipe = [got[s] for s in _ROUTE_SHAPES[:3]]
        assert recipe == {"b0": [True, False, False],
                          "rest": [False, True, False],
                          "all": [True, True, False]}.get(
                              mode, [False] * 3)
        assert got[(4, 16, 32, 256)] == (mode in ("rest", "all"))


@pytest.mark.parametrize("c,b,h,w", [(96, 2, 16, 32), (512, 2, 16, 32),
                                     (32, 2, 16, 32), (64, 2, 0, 32),
                                     (128, 0, 16, 32),
                                     (64, 1, 2**16, 2**15)])
def test_tile_picker_refuses(c, b, h, w):
    """A width the kernels have no tile for, an empty input, or more
    pixels than 32-bit indices take: ``ValueError`` before any launch."""
    with pytest.raises(ValueError):
        bbchain.pick_tile(c, b, h, w)


@pytest.mark.parametrize("c", [96, 512])
def test_wrappers_refuse_other_widths(c):
    """Each kernel wrapper refuses C = 96 and 512 through the tile picker
    (the check comes before the device check, so it shows on the CPU)."""
    x = torch.zeros((1, 8, 16, c), dtype=torch.bfloat16)
    pairs = [(torch.zeros((c, c, 3, 3)), torch.zeros((c, c, 3, 3)))]
    with pytest.raises(ValueError, match="C in"):
        bbchain.bb_chain_fwd_saved(x, pairs)
    with pytest.raises(ValueError, match="C in"):
        bbchain.bb_chain_bwd_kernel(x, x, pairs, [x], [x])
    with pytest.raises(ValueError, match="C in"):
        bbchain.bb_chain_wgrad_kernel([(x, x)])


@pytest.mark.parametrize("c", [64, 128, 256])
def test_tile_picker_takes_the_route_widths(c):
    th, tw = bbchain.pick_tile(c, 24, 128 * 64 // c, 128 * 64 // c)
    assert tw == 16 and th == (4 if c == 256 else 8)


@pytest.mark.parametrize("c", [64, 256])
def test_weight_units_layout(c):
    """``_units`` puts tap t, input channel k, output n at [t, k // 64,
    (k % 64) // 8, n, k % 8]: the K-major core-matrix order of the
    kernels' weight ring."""
    taps = torch.arange(9 * c * c, dtype=torch.float32).reshape(9, c, c)
    u = bbchain._units(taps)
    assert u.shape == (9, c // 64, 8, c, 8) and u.is_contiguous()
    rng = np.random.RandomState(1)
    for t, k, n in rng.randint(0, [9, c, c], (50, 3)):
        assert u[t, k // 64, (k % 64) // 8, n, k % 8] == taps[t, k, n]
