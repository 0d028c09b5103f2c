"""The SRN-era refiners and the voxel-flow nets ported (models/srn_legacy.py,
models/optical.py's OpticalUnet and OpticalRefineNet) against the JAX
package's modules: each JAX module's variables, in the shapes of its init
(``jax.eval_shape``) filled from a numpy seed (``jax_variables``), carried
across by ``tools/jax_weights.load_jax_legacy`` (strictly); the same numpy
inputs, B=2, 32x64, f32, both sides on the CPU, the JAX side jitted.

Tolerance: every output within 1e-4 of the largest magnitude of its JAX
counterpart (f32 convolutions summed in another order, through up to ~60
layers); the parameter counts equal JAX's (SRN4's and AttnRefine's also
the reference capacities that tests/test_param_parity.py pins).  One
gradient of OpticalRefineNet at 16x32 (every parameter and the input, a
random cotangent on each of the seven outputs) within 1e-4 rel-L2 per
tensor, after checking that both sides sample the same pixel cells (a
coordinate on a cell edge or a clip bound would split its gradient by each
library's tie convention)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.models import (
    optical as jopt,
    srn_legacy as js,
)
from deep_video_interpolation_extrapolation_tpu_torch.models import (
    optical,
    srn_legacy as srn,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.warp import (
    make_base_grid,
)
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    legacy_state_dict,
    load_jax_legacy,
)

torch.set_num_threads(2)
B, H, W = 2, 32, 64
TOL = 1e-4
F32 = torch.float32


def _inputs(h=H, w=W, seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.uniform(-1, 1, (B, h, w, 3)).astype(np.float32),
        seg=np.eye(20, dtype=np.float32)[rng.randint(0, 20, (B, h, w))],
        nb=rng.uniform(-1, 1, (B, h, w, 6)).astype(np.float32),
        low=rng.normal(0, 1, (B, h // 2, w // 2, 32)).astype(np.float32),
        x9=rng.uniform(-1, 1, (B, h, w, 9)).astype(np.float32),
        h64=rng.normal(0, 1, (B, h, w, 64)).astype(np.float32))


# name -> (JAX module, port module, positional inputs)
CASES = {
    "SRN4": (lambda: js.SRN4(n_scales=1, dtype=jnp.float32),
             lambda: srn.SRN4(n_scales=1, dtype=F32), lambda i: (i["x"],)),
    "SRN4_n2": (lambda: js.SRN4(n_scales=2, dtype=jnp.float32),
                lambda: srn.SRN4(n_scales=2, dtype=F32), lambda i: (i["x"],)),
    "SRN4Seg_n2": (lambda: js.SRN4Seg(n_scales=2, dtype=jnp.float32),
                   lambda: srn.SRN4Seg(n_scales=2, dtype=F32),
                   lambda i: (i["x"], i["seg"])),
    "SRN4Sharp_high_res": (
        lambda: js.SRN4Sharp(n_scales=1, high_res=True, dtype=jnp.float32),
        lambda: srn.SRN4Sharp(n_scales=1, high_res=True, dtype=F32),
        lambda i: (i["x"], None, i["nb"])),
    "SRN4Sharp_n2": (lambda: js.SRN4Sharp(n_scales=2, dtype=jnp.float32),
                     lambda: srn.SRN4Sharp(n_scales=2, dtype=F32),
                     lambda i: (i["x"], None, i["nb"])),
    "HResUnet": (lambda: js.HResUnet(dtype=jnp.float32),
                 lambda: srn.HResUnet(dtype=F32),
                 lambda i: (None, i["low"], i["x"])),
    "AttnRefine": (lambda: js.AttnRefine(dtype=jnp.float32),
                   lambda: srn.AttnRefine(dtype=F32),
                   lambda i: (i["x"], None, i["nb"])),
    "AttnBaseRefine": (lambda: js.AttnBaseRefine(dtype=jnp.float32),
                       lambda: srn.AttnBaseRefine(dtype=F32),
                       lambda i: (i["x"], None, i["nb"])),
    "MSConv2d": (lambda: js.MSConv2d(64, dtype=jnp.float32),
                 lambda: srn.MSConv2d(9, 64), lambda i: (i["x9"],)),
    "MSResnetBlock": (lambda: js.MSResnetBlock(64, dtype=jnp.float32),
                      lambda: srn.MSResnetBlock(64), lambda i: (i["h64"],)),
    "MSBaseRefine": (lambda: js.MSBaseRefine(dtype=jnp.float32),
                     lambda: srn.MSBaseRefine(cin=9, dtype=F32),
                     lambda i: (i["x"], None, i["nb"])),
    "OpticalUnet": (lambda: jopt.OpticalUnet(dtype=jnp.float32),
                    lambda: optical.OpticalUnet(dtype=F32),
                    lambda i: (np.concatenate([i["x"], i["nb"][..., :3]],
                                              -1),)),
    "OpticalRefineNet": (lambda: jopt.OpticalRefineNet(dtype=jnp.float32),
                         lambda: optical.OpticalRefineNet(dtype=F32),
                         lambda i: (i["nb"],)),
}
# the reference capacities (tests/test_param_parity.py, the JAX init)
COUNTS = {"SRN4": 7_323_875, "SRN4_n2": 7_766_499, "AttnRefine": 693_923}


def _leaves(out):
    if out is None:
        return []
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _leaves(o)]
    return [np.asarray(out.detach() if isinstance(out, torch.Tensor)
                       else out, dtype=np.float32)]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


# a leaf's values by its flax name: a conv kernel lecun-normal (the flax
# init's scale), the rest near their init (BatchNorm statistics included)
_FILL = {"bias": lambda r, s: r.uniform(-0.1, 0.1, s),
         "scale": lambda r, s: r.uniform(0.5, 1.0, s),
         "mean": lambda r, s: r.uniform(-0.1, 0.1, s),
         "var": lambda r, s: r.uniform(0.8, 2.0, s)}


def jax_variables(module, *inputs, seed=0):
    """``module``'s variables in the shapes of its init, without running
    it (``jax.eval_shape``; the flax init itself takes 10-25 s a model on
    the CPU), filled from ``numpy.random.RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            a = rng.normal(0.0, 1.0 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        else:
            a = _FILL[name](rng, s.shape)
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


def jax_compiled(fn, *args):
    """``fn`` jitted and compiled for ``args``' shapes, without LLVM's
    expensive passes (a third less compile time on these graphs)."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_llvm_disable_expensive_passes": True})


def jax_outputs(module, variables, *inputs):
    return _leaves(jax_compiled(module.apply, variables, *inputs)(
        variables, *inputs))


@functools.lru_cache(maxsize=None)
def _jax_side(name):
    """(variables, outputs)."""
    jmod, _, args = CASES[name]
    m = jmod()
    inputs = [None if a is None else jnp.asarray(a)
              for a in args(_inputs())]
    variables = jax_variables(m, *inputs)
    return variables, jax_outputs(m, variables, *inputs)


def _port(name, variables):
    model = CASES[name][1]()
    load_jax_legacy(model, variables["params"], variables.get("batch_stats"))
    return model


def _close(got, want, tol, label):
    assert len(got) == len(want), (label, len(got), len(want))
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (label, k, g.shape, w.shape)
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-6)
        assert err < tol, (label, k, err)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name):
    """The outputs, in JAX's order and nesting (SRN4's per-scale list and
    feature; OpticalUnet's six, OpticalRefineNet's seven), against the JAX
    module's; the parameter count equals JAX's."""
    variables, want = _jax_side(name)
    model = _port(name, variables)
    n_jax = sum(np.size(a) for a in jax.tree_util.tree_leaves(
        variables["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    if name in COUNTS:
        assert n_jax == COUNTS[name]
    inputs = [None if a is None else torch.from_numpy(a)
              for a in CASES[name][2](_inputs())]
    with torch.no_grad():
        got = model(*inputs)
    _close(_leaves(got), want, TOL, name)


def test_srn4_scales_have_their_own_fuse_convs():
    """At two scales SRN4 holds Conv_0..Conv_3 (flax names each scale's
    two hidden-state convs anew), and the coarser scale's prediction is
    half the size; ``high_res`` returns the last 32-channel feature."""
    variables, want = _jax_side("SRN4_n2")
    assert {k for k in variables["params"] if k.startswith("Conv_")} == {
        "Conv_0", "Conv_1", "Conv_2", "Conv_3"}
    model = _port("SRN4_n2", variables)
    assert [n for n, _ in model.named_children() if n.startswith("Conv_")] \
        == ["Conv_0", "Conv_1", "Conv_2", "Conv_3"]
    assert [w.shape for w in want] == [(B, H // 2, W // 2, 3), (B, H, W, 3)]
    _, feat = _jax_side("SRN4Sharp_high_res")
    assert feat[-1].shape == (B, H, W, 32)


def _cotangents(shapes, seed=5):
    rng = np.random.RandomState(seed)
    return [rng.normal(0, 1, s).astype(np.float32) for s in shapes]


def test_optical_refine_net_gradient_matches_jax():
    """One gradient at 16x32: d(sum of each output times a fixed random
    cotangent) by every parameter and by the frames, rel-L2 <= 1e-4 per
    tensor.  First, both sides' flows put every sample coordinate in the
    same pixel cell and on the same side of the clip bounds."""
    h, w = 16, 32
    rgb = _inputs(h, w, seed=3)["nb"]
    jm = jopt.OpticalRefineNet(dtype=jnp.float32)
    variables = jax_variables(jm, jnp.asarray(rgb), seed=1)
    outs = jax_compiled(jm.apply, variables, rgb)(variables, rgb)
    cts = _cotangents([o.shape for o in outs])

    def loss(params, x):
        return sum(jnp.sum(o * c) for o, c in
                   zip(jm.apply({"params": params}, x), cts))

    args = (variables["params"], rgb)
    g_params, g_x = jax_compiled(jax.grad(loss, argnums=(0, 1)), *args)(*args)
    model = optical.OpticalRefineNet(dtype=F32)
    load_jax_legacy(model, variables["params"])
    x = torch.from_numpy(rgb).requires_grad_()
    got = model(x)
    base = make_base_grid(h, w)[None]

    def cells(for_flow, back_flow):
        out = []
        for grid in (base - for_flow, base + back_flow):
            for g, n in ((grid[..., 0], w), (grid[..., 1], h)):
                f = (g + 1.0) * 0.5 * (n - 1)
                out += [torch.floor(f), f <= 0, f >= n - 1]
        return out

    for a, b in zip(cells(got[2].detach(), got[5].detach()),
                    cells(torch.from_numpy(np.array(outs[2])),
                          torch.from_numpy(np.array(outs[5])))):
        assert torch.equal(a, b)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(got, cts)).backward()
    want = legacy_state_dict(model, _np_tree(g_params))
    grads = dict(model.named_parameters())
    assert set(want) == set(grads)
    for key, ref in [("input", torch.from_numpy(np.array(g_x)))] + sorted(
            want.items()):
        g = x.grad if key == "input" else grads[key].grad
        rel = (g - ref).norm() / ref.norm().clamp_min(1e-30)
        assert rel <= 1e-4, (key, float(rel))
