"""Serving export of the port (``tools/export.py`` on ``torch.export``, the
served kernels as ``dvie::`` ops of ``ops/library.py``) against the live
port and the JAX package's forward.

InterNet, VAEHRNet (the plain VAE under InterNet, its prior draw z an
input: here the draw the JAX forward makes, captured at its decoder as
``tests/test_torch_port_gan_modules.py`` does) and ExtraNet at B=2 32x64
f32, the port's models from a seed and the JAX models on their weights
(the JAX package's ``tools/torch_port.port_hrnet`` and the inverse of the
port's ``tools/jax_weights.vae_key_map`` on the tree of
``jax.eval_shape``: no JAX init runs): exported, saved, loaded (by
``load_exported``: no model code) and run.
Held: the artifact equals the live port forward to 1e-6; the JAX
``model.apply`` at the same weights within the port's forward tolerance
(``tests/test_torch_port_model.py``: max|d| <= 1e-3 * max|ref|, the same
f32 graph summed in another order).  The 3-step rollout artifact
(``export_rollout``, ``Runner._mini_test``'s [prev, pred] window) equals
``serve.rollout``, and each of its steps the JAX forward on the window the
artifact carried (the ROADMAP's near-tie rule: each JAX step takes the
one-hots the rollout fed back, so an argmax flip at a near-tie does not
carry; the ids agree wherever JAX's top two logits are 1e-3 apart).  The
graphs name the ``dvie::`` ops; at W = 256 the packed route adds K1 and
K2; every op's fake implementation is checked against its CPU one by
``torch.library.opcheck``.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deep_video_interpolation_extrapolation_tpu.core.config import (
    Config as JConfig,
)
from deep_video_interpolation_extrapolation_tpu.models import hrnet as jhrnet
from deep_video_interpolation_extrapolation_tpu.models import (
    registry as jregistry,
)
from deep_video_interpolation_extrapolation_tpu.tools.torch_port import (
    port_hrnet,
)
from deep_video_interpolation_extrapolation_tpu_torch import serve
from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.ops import library
from deep_video_interpolation_extrapolation_tpu_torch.tools import (
    export as export_lib,
)
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    vae_key_map,
)

torch.set_num_threads(2)

B, H, W = 2, 32, 64
TOL = 1e-3
HEAD_OPS = {"dvie.fuse_out0.default", "dvie.ups_head_taps.default",
            "dvie.shifted_add_bias.default"}
CASES = {
    "InterNet": dict(model="InterNet"),
    "VAEHRNet": dict(model="InterNet", coarse_model="VAEHRNet", vae=True),
    "ExtraNet": dict(runner="EXTRA", model="ExtraNet", syn_type="extra"),
}


def _kw(name, **kw):
    base = dict(runner="INTER", syn_type="inter", mode="xs2xs",
                coarse_model="HRNet", compute_dtype="float32", input_h=H,
                input_w=W, batch_size=B, dataset="synthetic")
    return {**base, **CASES[name], **kw}


def _inputs(seed, b=B, h=H, w=W):
    rng = np.random.RandomState(seed)
    rgb = rng.uniform(-1, 1, (b, h, w, 6)).astype(np.float32)
    seg = np.eye(20, dtype=np.float32)[rng.randint(0, 20, (b, h, w, 2))]
    return rgb, seg.reshape(b, h, w, 40)


def _decoder_input(store):
    """An interceptor recording the latent z the JAX VAEHRNet drew."""
    def f(next_fun, args, kwargs, context):
        if (isinstance(context.module, jhrnet._VAEDecoder)
                and context.method_name == "__call__"):
            store.append(args[0])
        return next_fun(*args, **kwargs)
    return f


_TO_JAX = {   # torch weight -> flax kernel, the inverse of KERNEL_TRANSFORM
    "conv": lambda a: np.transpose(a, (2, 3, 1, 0)),
    "dense": lambda a: np.transpose(a, (1, 0)),
    "convT": lambda a: np.transpose(a, (2, 3, 0, 1))[::-1, ::-1],
}


def _jax_variables(port, tmpl):
    """The port's coarse model's weights on the JAX tree ``tmpl`` (from
    ``jax.eval_shape`` of the JAX init: no JAX init runs): HRNet by the JAX
    package's own ``port_hrnet``, a VAEHRNet's decoder and its BatchNorm
    statistics by the inverse of ``tools/jax_weights.vae_key_map``."""
    sd = {k: v.detach().numpy() for k, v in
          port.coarse_model.state_dict().items()}
    params = port_hrnet(sd, tmpl["params"]["coarse_model"])
    stats = jax.tree_util.tree_map(lambda x: x, tmpl.get(
        "batch_stats", {}).get("coarse_model", {}))
    if "vae_decoder" in params:
        trees = {"params": params, "batch_stats": stats}
        for key, (coll, *path), kind in vae_key_map(params, stats,
                                                    "VAEHRNet"):
            node = trees[coll]
            for name in path[:-1]:
                node = node[name]
            a = sd[key]
            node[path[-1]] = jnp.asarray(
                _TO_JAX[kind](a).copy() if path[-1] == "kernel" else a)
    v = {"params": {"coarse_model": params}}
    if stats:
        v["batch_stats"] = {"coarse_model": stats}
    assert not any(isinstance(x, jax.ShapeDtypeStruct)
                   for x in jax.tree_util.tree_leaves(v))
    return v


@pytest.fixture(scope="module")
def models():
    """name -> (port config, jitted JAX eval forward, port model): the port
    model from a seed, the JAX model on its weights."""
    out = {}
    rgb, seg = map(jnp.asarray, _inputs(0))
    keys = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    for name in CASES:
        cfg = Config(**_kw(name))
        port = registry.build_model(cfg, device="cpu", seed=0)
        jm = jregistry.build_model(JConfig(**_kw(name)))
        v = _jax_variables(port, jax.eval_shape(
            lambda jm=jm: jm.init(keys, rgb, seg, train=False)))

        @jax.jit
        def fwd(rgb, seg, key, jm=jm, v=v):
            """The JAX eval forward and the latent its VAE drew."""
            store = []
            with fnn.intercept_methods(_decoder_input(store)):
                o = jm.apply(v, rgb, seg, train=False, rngs={"noise": key})
            return o[:2], (store[0] if store else None)
        out[name] = (cfg, fwd, port)
    return out


def _ops(served):
    """The ``dvie::`` ops a loaded program's graphs call."""
    return {str(n.target) for m in served.modules()
            if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes
            if str(n.target).startswith("dvie.")}


def _near(out, ref, tol=TOL):
    out = np.asarray(out.detach().float().numpy())
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    assert np.abs(out - ref).max() <= tol * np.abs(ref).max(), (
        np.abs(out - ref).max(), np.abs(ref).max())


def _same(out, ref):
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["InterNet", "ExtraNet"])
def test_forward_artifact_matches_live_and_jax(models, tmp_path, name):
    cfg, jax_fwd, port = models[name]
    served = export_lib.load_exported(
        export_lib.export_forward(cfg, port, str(tmp_path / "f.pt2")))
    assert HEAD_OPS <= _ops(served)
    rgb, seg = _inputs(1)
    out = served(torch.from_numpy(rgb), torch.from_numpy(seg))
    live = serve.forward(port, torch.from_numpy(rgb), torch.from_numpy(seg))
    ref, _ = jax_fwd(rgb, seg, jax.random.PRNGKey(9))
    for o, l, r in zip(out, live, ref):
        _same(o, l)
        _near(o, r)


def test_vae_artifact_takes_the_jax_draw(models, tmp_path):
    """The VAE generator's artifact takes z first: given the z the JAX
    forward drew, it equals the JAX forward; the port's live coarse model
    given the same z equals the artifact."""
    cfg, jax_fwd, port = models["VAEHRNet"]
    served = export_lib.load_exported(
        export_lib.export_forward(cfg, port, str(tmp_path / "vae.pt2")))
    assert HEAD_OPS <= _ops(served)
    rgb, seg = _inputs(2)
    ref, z = jax_fwd(rgb, seg, jax.random.PRNGKey(9))
    z = torch.from_numpy(np.array(z).reshape(export_lib.noise_shape(cfg, B)))
    out = served(z, torch.from_numpy(rgb), torch.from_numpy(seg))
    with torch.no_grad():
        live = port.coarse_model(torch.from_numpy(rgb),
                                 torch.from_numpy(seg), noise=z)
    for o, l, r in zip(out, live[:2], ref):
        _same(o, l)
        _near(o, r)
    other = served(torch.zeros_like(z), torch.from_numpy(rgb),
                   torch.from_numpy(seg))
    assert not torch.allclose(other[0], out[0])


def test_rollout_artifact_matches_serve_and_jax(models, tmp_path):
    cfg, jax_fwd, port = models["InterNet"]
    steps = 3
    served = export_lib.load_exported(export_lib.export_rollout(
        cfg, port, str(tmp_path / "roll.pt2"), steps=steps))
    assert HEAD_OPS <= _ops(served)
    rng = np.random.RandomState(3)
    imgs = [torch.from_numpy(rng.uniform(0, 1, (B, H, W, 3)).astype(
        np.float32)) for _ in range(2)]
    ids = [torch.from_numpy(rng.randint(0, 20, (B, H, W)).astype(np.uint8))
           for _ in range(2)]
    frames, out_ids = served(*imgs, *ids)
    assert frames.shape == (steps, B, H, W, 3)
    assert out_ids.shape == (steps, B, H, W) and out_ids.dtype == torch.uint8
    live_f, live_i = serve.rollout(port, imgs, ids, steps)
    for t in range(steps):
        _same(frames[t], live_f[t])
        assert torch.equal(out_ids[t], live_i[t])
    # each step against JAX on the window the artifact carried
    win = [imgs[0], imgs[1]]
    win_ids = ids
    for t in range(steps):
        x = np.concatenate([w.numpy() * 2 - 1 for w in win], axis=-1)
        seg = np.concatenate([F.one_hot(i.long(), 20).float().numpy()
                              for i in win_ids], axis=-1)
        (rgb_j, seg_j), _ = jax_fwd(x, seg, jax.random.PRNGKey(9))
        _near(frames[t] * 2 - 1, np.clip(np.asarray(rgb_j), -1, 1))
        top2 = np.sort(np.asarray(seg_j), axis=-1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > 1e-3
        agree = out_ids[t].numpy() == np.argmax(np.asarray(seg_j), -1)
        assert agree[clear].all()
        win, win_ids = [win[1], frames[t]], [win_ids[1], out_ids[t]]


def test_packed_route_artifact(tmp_path):
    """At W >= 256 the stem and layer1 take K1 and K2: their ops enter the
    graph, and the artifact equals the live forward."""
    cfg = Config(**_kw("InterNet", input_h=16, input_w=256, batch_size=1))
    port = registry.build_model(cfg, device="cpu", seed=0)
    served = export_lib.load_exported(
        export_lib.export_forward(cfg, port, str(tmp_path / "p.pt2")))
    assert HEAD_OPS | {"dvie.conv3x3.default",
                       "dvie.bottleneck_tail.default"} <= _ops(served)
    rgb, seg = map(torch.from_numpy, _inputs(4, 1, 16, 256))
    for o, l in zip(served(rgb, seg), serve.forward(port, rgb, seg)):
        _same(o, l)


def test_refusals():
    """The JAX refusals: the video VAEs do not export, nor does a VAE
    head's rollout (it needs a draw per window)."""
    with pytest.raises(ValueError, match="5-D video"):
        export_lib.export_forward(Config(model="VAE"), None, "unused")
    with pytest.raises(ValueError, match="VAE heads"):
        export_lib.export_rollout(Config(**_kw("VAEHRNet")), None, "unused",
                                  steps=2)


def _op_args(seed):
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g)
    h1, x64 = r(1, 4, 8, 64), r(1, 4, 8, 64)
    p0, p1, p2, p3 = r(1, 8, 16, 64), r(1, 4, 8, 128), r(1, 2, 4, 256), \
        r(1, 1, 2, 512)
    q = r(1, 4, 8, 128)
    return {
        "conv3x3": (r(1, 4, 8, 64), r(64, 64, 3, 3), r(64), r(1, 4, 8, 64),
                    True),
        "bottleneck_tail": (h1, x64, r(64, 64, 3, 3), r(256, 64, 1, 1),
                            r(256, 64, 1, 1), r(64, 256, 1, 1)),
        "bottleneck_tail_last": (r(1, 4, 8, 64), r(1, 4, 8, 256),
                                 r(64, 64, 3, 3), r(256, 64, 1, 1), None,
                                 None),
        "fuse_out0": (r(1, 8, 16, 64), r(1, 4, 8, 64), r(1, 2, 4, 64)),
        "ups_head_taps": (p0, p1, p2, r(448, 448), r(448), r(448, 207)),
        "ups_head_1x1": (p0, p1, p2, r(448, 448), r(448)),
        "ups_head_taps4": (p0, p1, p2, p3, r(960, 960), r(960),
                           r(960, 216)),
        "shifted_add_bias": (r(1, 8, 16, 9 * 24), r(24)),
        "window_attention": (q, r(1, 4, 8, 128), r(1, 4, 8, 128),
                             r(1, 4, 8, 128), r(1, 4, 8, 128), 5, 9),
    }


@pytest.mark.parametrize("name", sorted(_op_args(0)))
def test_op_fake_matches_cpu(name):
    """Each ``dvie::`` op: its schema, and its fake implementation's
    shapes and dtypes against its CPU implementation
    (``torch.library.opcheck``)."""
    op = getattr(library, name.replace("_last", ""))
    torch.library.opcheck(op, _op_args(0)[name],
                          test_utils=("test_schema", "test_faketensor"))
