"""The ``--highres_large`` slice of the port against the JAX package: the
4-part head's plain version (ops/upshead.py) against the Pallas kernel
``_pallas_impl4`` run in interpret mode, forward and backward, the 4-branch
InterNet/HRNet against the JAX model on the same weights, and the weight
mapper against the JAX parameter tree.

Tolerances:
- head forward, f32: atol = rtol = 3e-4, those of
  tests/test_pallas_upshead.py:372-403 (which holds the same kernel
  against its XLA reference): both sides sum f32 products in another
  order, and the Pallas kernel multiplies p2 and p3 by their W1 rows
  before upsampling (its pre-dot), which is exact in real arithmetic;
- head gradients, f32: atol = rtol = 2e-3 (test_pallas_upshead.py:406-425);
- the model at 1x16x64: f32 max|d| <= 1e-3 * max|ref|, seg agreement >=
  99.9%; bf16 max|d| <= 5e-2 * max(1, max|ref|), agreement >= 95%, for
  the reasons tests/test_torch_port_model.py gives, over ~60 layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.core.config import Config
from deep_video_interpolation_extrapolation_tpu.models import registry as jregistry
from deep_video_interpolation_extrapolation_tpu.ops import pallas_upshead
from deep_video_interpolation_extrapolation_tpu_torch import serve
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.ops import upshead
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    from_jax_params,
    key_map,
)
from deep_video_interpolation_extrapolation_tpu_torch.train import (
    inter,
    state as state_lib,
)

torch.set_num_threads(1)

H, W = 16, 64


def _mk4(b, h, w, seed=30):
    """The pyramid and weights of test_pallas_upshead._mk4, as numpy."""
    rng = np.random.RandomState(seed)
    return [rng.uniform(-1, 1, (b, h, w, 64)).astype(np.float32),
            rng.uniform(-1, 1, (b, h // 2, w // 2, 128)).astype(np.float32),
            rng.uniform(-1, 1, (b, h // 4, w // 4, 256)).astype(np.float32),
            rng.uniform(-1, 1, (b, h // 8, w // 8, 512)).astype(np.float32),
            rng.uniform(-0.05, 0.05, (960, 1920)).astype(np.float32),
            rng.uniform(-0.1, 0.1, (1920,)).astype(np.float32),
            rng.uniform(-0.1, 0.1, (1920, 207)).astype(np.float32)]


def _edge(args):
    """Edge rows and columns of p3 far from the rest: the x8 clamp."""
    p3 = args[3].copy()
    p3[:, 0], p3[:, -1] = 6.0, -6.0
    p3[:, :, 0], p3[:, :, -1] = 4.0, -4.0
    return args[:3] + [p3] + args[4:]


@pytest.mark.parametrize("shape,edge", [((1, 16, 64), False),
                                        ((2, 24, 128), False),
                                        ((1, 16, 64), True)])
def test_taps4_plain_matches_pallas_kernel(shape, edge):
    args = _mk4(*shape, seed=31 if edge else 30)
    if edge:
        args = _edge(args)
    assert pallas_upshead.fits4(*map(jnp.asarray, args[:4]))
    ref = np.asarray(pallas_upshead._pallas_impl4(
        *map(jnp.asarray, args), interpret=True))
    out = upshead.ups_head_taps4(*map(torch.from_numpy, args))
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-4, rtol=3e-4)


def test_taps4_gradients_match_jax():
    """Every input's gradient of sum(yt^2) against ``jax.grad`` through the
    JAX custom_vjp (its forward the Pallas kernel in interpret mode)."""
    args = _mk4(1, 8, 64, seed=32)
    gj = jax.grad(lambda *a: jnp.sum(pallas_upshead.ups_head_taps4(
        *a, True) ** 2), argnums=tuple(range(7)))(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    (upshead.ups_head_taps4(*ts) ** 2).sum().backward()
    for t, g in zip(ts, gj):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=2e-3,
                                   rtol=2e-3)


@pytest.mark.parametrize("shape", [(1, 16, 64), (2, 512, 1024),
                                   (1, 12, 64), (1, 16, 96), (1, 8, 64)])
def test_fits4_matches_jax(shape):
    b, h, w = shape
    parts = [np.zeros((b, h // f, w // f, c), np.float32)
             for f, c in ((1, 64), (2, 128), (4, 256), (8, 512))]
    assert upshead.fits4(*map(torch.from_numpy, parts)) == \
        pallas_upshead.fits4(*map(jnp.asarray, parts))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_head_route_ignores_fits4(monkeypatch, use_kernels):
    """At a pyramid the JAX package sends to its unfused tail (1x8x48: W %
    64 != 0 and H/8 < 2), the kernel model still calls ``ups_head_taps4``
    (on a CUDA tensor the kernel, which takes any size, or a raise), and
    the plain model its plain version."""
    from deep_video_interpolation_extrapolation_tpu_torch.models import hrnet
    called = []

    def spy(name, fn):
        def wrapped(*args):
            called.append(name)
            return fn(*args)
        monkeypatch.setattr(hrnet, name, wrapped)

    spy("ups_head_taps4", upshead.ups_head_taps4)
    spy("ups_head_taps4_plain", upshead.ups_head_taps4_plain)
    rng = np.random.RandomState(1)
    rgb = torch.from_numpy(rng.uniform(-1, 1, (1, 8, 48, 6)).astype(np.float32))
    seg = torch.from_numpy(np.eye(20, dtype=np.float32)[
        rng.randint(0, 20, (1, 8, 48, 2))].reshape(1, 8, 48, 40))
    model = registry.build_model(_cfg(), device="cpu",
                                 use_kernels=use_kernels)
    with torch.no_grad():
        parts = model.coarse_model._backbone(
            hrnet._encode_inputs(rgb, seg, model.coarse_model.seg_encoder,
                                 torch.float32))
    assert not upshead.fits4(*parts)
    r, s = serve.forward(model, rgb, seg)
    assert r.shape == (1, 8, 48, 3) and torch.isfinite(r.float()).all()
    assert called == (["ups_head_taps4"] if use_kernels
                      else ["ups_head_taps4_plain"])


def test_taps4_kernel_refuses_channels():
    """The kernel wrapper raises for a concat it cannot take (here 968
    channels, over its 960) before it touches a device."""
    args = [torch.from_numpy(a) for a in _mk4(1, 16, 64)]
    args[0] = torch.zeros((1, 16, 64, 72))
    args[4] = torch.zeros((968, 1920))
    with pytest.raises(ValueError, match="4-part kernel"):
        upshead._taps4_kernel(*args)


def _cfg(dtype="float32", **kw):
    base = dict(runner="INTER", model="InterNet", syn_type="inter",
                mode="xs2xs", coarse_model="HRNet", compute_dtype=dtype,
                input_h=H, input_w=W, batch_size=1, dataset="synthetic",
                highres_large=True)
    return Config(**{**base, **kw})


@pytest.fixture(scope="module")
def jax_model():
    rng = np.random.RandomState(0)
    rgb = rng.uniform(-1, 1, (1, H, W, 6)).astype(np.float32)
    seg = np.eye(20, dtype=np.float32)[
        rng.randint(0, 20, (1, H, W, 2))].reshape(1, H, W, 40)
    variables = jregistry.build_model(_cfg()).init(
        jax.random.PRNGKey(0), jnp.asarray(rgb), jnp.asarray(seg),
        train=False)
    params = jax.tree_util.tree_map(np.asarray,
                                    variables["params"]["coarse_model"])
    return variables, params, rgb, seg


@pytest.mark.parametrize("dtype,tol,agree", [("float32", 1e-3, 0.999),
                                             ("bfloat16", 5e-2, 0.95)])
def test_highres_internet_matches_jax(jax_model, dtype, tol, agree):
    variables, params, rgb, seg = jax_model
    jr, js = jregistry.build_model(_cfg(dtype)).apply(
        variables, jnp.asarray(rgb), jnp.asarray(seg), train=False)
    jr, js = np.asarray(jr, np.float32), np.asarray(js, np.float32)
    model = registry.build_model(_cfg(dtype), device="cpu")
    model.coarse_model.load_state_dict(from_jax_params(params))
    r, s = serve.forward(model, torch.from_numpy(rgb), torch.from_numpy(seg))
    r, s = r.float().numpy(), s.float().numpy()
    assert r.shape == (1, H, W, 3) and s.shape == (1, H, W, 20)
    floor = 1.0 if dtype == "bfloat16" else 0.0
    for out, ref in ((r, jr), (s, js)):
        assert np.abs(out - ref).max() <= tol * max(floor, np.abs(ref).max())
    assert (s.argmax(-1) == js.argmax(-1)).mean() >= agree


def test_highres_internet_matches_jax_at_64x128():
    """The 4-branch InterNet at 1x64x128 (stage 4's branch 3 at 8x16, the
    4-part head's x8 part at 8x16) against the JAX model on the same
    weights, f32, with the 1x16x64 case's tolerances."""
    h, w = 64, 128
    rng = np.random.RandomState(3)
    rgb = rng.uniform(-1, 1, (1, h, w, 6)).astype(np.float32)
    seg = np.eye(20, dtype=np.float32)[
        rng.randint(0, 20, (1, h, w, 2))].reshape(1, h, w, 40)
    cfg = _cfg(input_h=h, input_w=w)
    jm = jregistry.build_model(cfg)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(rgb),
                        jnp.asarray(seg), train=False)
    jr, js = (np.asarray(t, np.float32) for t in jm.apply(
        variables, jnp.asarray(rgb), jnp.asarray(seg), train=False))
    model = registry.build_model(cfg, device="cpu")
    model.coarse_model.load_state_dict(from_jax_params(jax.tree_util.tree_map(
        np.asarray, variables["params"]["coarse_model"])))
    r, s = serve.forward(model, torch.from_numpy(rgb), torch.from_numpy(seg))
    r, s = r.float().numpy(), s.float().numpy()
    assert r.shape == (1, h, w, 3) and s.shape == (1, h, w, 20)
    for out, ref in ((r, jr), (s, js)):
        assert np.abs(out - ref).max() <= 1e-3 * np.abs(ref).max()
    assert (s.argmax(-1) == js.argmax(-1)).mean() >= 0.999


def test_key_map_covers_every_jax_leaf_once(jax_model):
    """The JAX tools' port_hrnet stops at stage3, so the highres_large keys
    are held against the JAX parameter tree itself: every leaf is mapped
    exactly once, and the mapped state_dict is the port model's."""
    _, params, _, _ = jax_model
    paths = [path for _, path in key_map(params)]
    leaves = [tuple(k.key for k in path) for path, _ in
              jax.tree_util.tree_leaves_with_path(params)]
    assert len(paths) == len(set(paths))
    assert sorted(paths) == sorted(leaves)
    sd = from_jax_params(params)
    port = registry.build_model(_cfg(), device="cpu")
    assert "transition3.3.0.0.weight" in sd
    assert "stage4.0.fuse_layers.3.0.2.0.weight" in sd
    missing, unexpected = port.coarse_model.load_state_dict(sd, strict=True)
    assert not missing and not unexpected


def test_highres_training_is_refused():
    """No longer refused: the --highres_large INTER step builds and runs
    one step to finite losses (tests/test_torch_port_highres_train.py holds
    it to JAX)."""
    cfg = dataclasses.replace(_cfg(), train_coarse=True, vgg_weight=0.0)
    model = registry.build_model(cfg, device="cpu")
    state = state_lib.create_train_state(cfg, model, None)
    rng = np.random.RandomState(7)
    batch = {f"frame{i}": torch.from_numpy(rng.uniform(
        -1, 1, (1, H, W, 3)).astype(np.float32)) for i in (1, 2, 3)}
    batch.update({f"seg{i}": torch.from_numpy(rng.randint(
        0, 20, (1, H, W)).astype(np.uint8)) for i in (1, 2, 3)})
    state, losses = inter.make_train_step(cfg, model)(state, batch)
    assert state.step == 1 and np.isfinite(float(losses["loss_all"]))
