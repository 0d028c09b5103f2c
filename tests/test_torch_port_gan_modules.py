"""The ported VAEHRNet (``models/hrnet.VAEHRNet``: its VAE encoder and
decoder, the latent heads, the whole forward) and the stem at its 46
input channels, against the JAX package, and the stem kernels' 48-channel
weight layout.

The JAX VAEHRNet is initialised in train mode at B=2 32x64 (latent 16 x
2 x 4 = 128: the Dense heads) and every leaf replaced from
``numpy.random.RandomState`` (kernels lecun-normal, BN scales near 1 and
running statistics away from their init), then carried across by
``tools/jax_weights.from_jax_vaehrnet``.  The JAX draws (train: eps, eval:
z) are recovered from the decoder's input, captured with
``flax.linen.intercept_methods``: eps = (z - mu) / exp(logvar / 2), handed
to the port as ``noise``.

Tolerances, f32: eval max|d| <= 1e-4 * max(1, max|ref|) (the same f32
graph, summed in another order); train mode max|d| <= 1e-3 * max(1,
max|ref|): the encoder's deepest BatchNorms take statistics over 2 x 4
positions, where E[x^2] - E[x]^2 amplifies summation-order differences
(as tests/test_torch_port_vae.py).  The stem: as
tests/test_torch_port_trainchain.py (forward 2e-4, gradients rel-L2 <
1e-2).
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.models import hrnet as jhrnet
from deep_video_interpolation_extrapolation_tpu.models.blocks import (
    Conv as JConv,
)
from deep_video_interpolation_extrapolation_tpu.ops import pallas_trainchain
from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.models import (
    hrnet,
    registry,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops import trainchain
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    from_jax_vae,
    from_jax_vaehrnet,
)

torch.set_num_threads(2)

B, H, W = 2, 32, 64


def _randomized(variables, seed):
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        name = getattr(path[-1], "key", "")
        shape = np.shape(a)
        if name == "kernel":
            v = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name == "scale":
            v = rng.uniform(0.8, 1.2, shape)
        elif name == "mean":
            v = rng.uniform(-0.2, 0.2, shape)
        elif name == "var":
            v = rng.uniform(0.5, 2.0, shape)
        else:
            v = rng.uniform(-0.1, 0.1, shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _inputs(seed, h=H, w=W):
    rng = np.random.RandomState(seed)
    rgb = rng.uniform(-1, 1, (B, h, w, 6)).astype(np.float32)
    seg = np.eye(20, dtype=np.float32)[rng.randint(0, 20, (B, h, w, 2))]
    seg = seg.reshape(B, h, w, 40)
    gt = rng.uniform(-1, 1, (B, h, w, 3)).astype(np.float32)
    gt_seg = np.eye(20, dtype=np.float32)[rng.randint(0, 20, (B, h, w))]
    return rgb, seg, gt, gt_seg


@functools.lru_cache(maxsize=None)
def _jax_vars():
    rgb, seg, gt, gt_seg = _inputs(0)
    m = jhrnet.VAEHRNet(syn_type="inter")
    v = m.init({"params": jax.random.PRNGKey(0),
                "noise": jax.random.PRNGKey(1)},
               *map(jnp.asarray, (rgb, seg, gt, gt_seg)), train=True)
    return _randomized({k: v[k] for k in ("params", "batch_stats")}, 3)


def _port():
    v = _jax_vars()
    cfg = Config(model="InterGANNet", coarse_model="VAEHRNet",
                 syn_type="inter", compute_dtype="float32", input_h=H,
                 input_w=W)
    model = registry.build_coarse(cfg)
    model.load_state_dict(from_jax_vaehrnet(v["params"], v["batch_stats"]),
                          strict=True)
    return model


def _close(out, ref, tol):
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy()
    assert out.shape == ref.shape, (out.shape, ref.shape)
    bound = tol * max(1.0, np.abs(ref).max())
    assert np.abs(out - ref).max() <= bound, (np.abs(out - ref).max(), bound)


def _decoder_input_capture(store):
    """An interceptor recording the argument of ``_VAEDecoder.__call__``
    (the latent z the JAX module drew or sampled)."""
    def f(next_fun, args, kwargs, context):
        if (isinstance(context.module, jhrnet._VAEDecoder)
                and context.method_name == "__call__"):
            store.append(args[0])
        return next_fun(*args, **kwargs)
    return f


@functools.lru_cache(maxsize=None)
def _jax_forward(train: bool, seed: int):
    v = _jax_vars()
    args = tuple(map(jnp.asarray, _inputs(seed)))
    m = jhrnet.VAEHRNet(syn_type="inter")

    @jax.jit
    def run(v, *args):
        store = []
        with fnn.intercept_methods(_decoder_input_capture(store)):
            if train:
                out, upd = m.apply(v, *args, train=True,
                                   rngs={"noise": jax.random.PRNGKey(9)},
                                   mutable=["batch_stats"])
            else:
                out = m.apply(v, *args[:2], train=False,
                              rngs={"noise": jax.random.PRNGKey(9)})
                upd = {}
        return out, store[0], upd
    return run(v, *args)


@pytest.mark.parametrize("train", [False, True])
def test_vae_encoder_matches_jax(train):
    """``_VAEEncoder`` on (inputs, ground truth): the 8 x 8 ... 2 x 4 x 16
    map, and in train mode the moved running statistics."""
    v = _jax_vars()
    sub = {k: v[k]["vae_encoder"] for k in ("params", "batch_stats")}
    x = np.random.RandomState(4).uniform(-1, 1, (B, H, W, hrnet.VAE_IN))
    x = x.astype(np.float32)
    enc = jhrnet._VAEEncoder()
    if train:
        ref, upd = enc.apply(sub, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    else:
        ref = enc.apply(sub, jnp.asarray(x), train=False)
    port = _port().vae_encoder
    with torch.no_grad():
        out = port(torch.from_numpy(x), train, torch.float32)
    _close(out, ref, 1e-3 if train else 1e-4)
    if train:
        bs = from_jax_vae({"vae_encoder": sub["params"]},
                          {"vae_encoder": upd["batch_stats"]}, "VAEHRNet")
        for k, t in port.state_dict().items():
            if "running" in k:
                _close(t, bs[f"vae_encoder.{k}"].numpy(), 1e-4)


@pytest.mark.parametrize("train", [False, True])
def test_vae_decoder_matches_jax(train):
    """``_VAEDecoder``: z (B, 2, 4, 16) -> the 32-channel full-size
    feature."""
    v = _jax_vars()
    sub = {k: v[k]["vae_decoder"] for k in ("params", "batch_stats")}
    z = np.random.RandomState(5).normal(0, 1, (B, 2, 4, 16)).astype(
        np.float32)
    dec = jhrnet._VAEDecoder()
    if train:
        ref, _ = dec.apply(sub, jnp.asarray(z), train=True,
                           mutable=["batch_stats"])
    else:
        ref = dec.apply(sub, jnp.asarray(z), train=False)
    with torch.no_grad():
        out = _port().vae_decoder(torch.from_numpy(z), train, torch.float32)
    assert out.shape == (B, H, W, hrnet.VAE_FEAT)
    _close(out, ref, 1e-3 if train else 1e-4)


def test_vaehrnet_train_forward_matches_jax():
    """The whole train forward with the JAX eps handed in: rgb, seg, mu,
    logvar, and every BatchNorm's moved statistics."""
    (rgb_j, seg_j, mu_j, lv_j), z_j, upd = _jax_forward(True, 1)
    eps = (np.asarray(z_j).reshape(B, -1) - np.asarray(mu_j)) / np.exp(
        0.5 * np.asarray(lv_j))
    port = _port()
    with torch.no_grad():
        out = port(*map(torch.from_numpy, _inputs(1)), train=True,
                   noise=torch.from_numpy(eps.astype(np.float32)))
    for o, r in zip(out, (rgb_j, seg_j, mu_j, lv_j)):
        _close(o, r, 1e-3)
    want = from_jax_vaehrnet(_jax_vars()["params"], upd["batch_stats"])
    for k, t in port.state_dict().items():
        if "running" in k:
            _close(t, want[k].numpy(), 1e-4)


def test_vaehrnet_eval_forward_matches_jax():
    """The eval forward with the JAX prior draw z handed in; mu and logvar
    are None on both sides, and the generator path draws z of the Dense
    latent's shape (B, 128)."""
    (rgb_j, seg_j, mu_j, lv_j), z_j, _ = _jax_forward(False, 2)
    assert mu_j is None and lv_j is None
    port = _port()
    rgb, seg = map(torch.from_numpy, _inputs(2)[:2])
    with torch.no_grad():
        out = port(rgb, seg, noise=torch.from_numpy(np.asarray(z_j)))
        assert out[2] is None and out[3] is None
        _close(out[0], rgb_j, 1e-4)
        _close(out[1], seg_j, 1e-4)
        g = torch.Generator().manual_seed(0)
        drawn = port(rgb, seg, generator=g)
        z = torch.randn((B, 128), generator=torch.Generator().manual_seed(0))
        again = port(rgb, seg, noise=z)
    torch.testing.assert_close(drawn[0], again[0], rtol=0, atol=0)


def test_conv_latent_heads_match_jax():
    """Above a latent of 4096 (here 16 x 17 x 16 = 4352, an encoder map of
    a 272x256 input) the moments are 1x1 conv heads, ``mu_conv`` and
    ``logvar_conv``, on the encoder map; at eval z is (B, H/16, W/16,
    16)."""
    assert hrnet.dense_latent(256, 256) and not hrnet.dense_latent(272, 256)
    e = np.random.RandomState(6).normal(0, 1, (B, 17, 16, 16)).astype(
        np.float32)
    head = JConv(16, 1, padding=0)
    params = {}
    refs = []
    for i, name in enumerate(("mu_conv", "logvar_conv")):
        p = _randomized(head.init(jax.random.PRNGKey(i), jnp.asarray(e)),
                        10 + i)
        params[name] = p["params"]
        refs.append(head.apply(p, jnp.asarray(e)))
    port = hrnet.VAEHRNet(dtype=torch.float32, size=(272, 256))
    assert hasattr(port, "mu_conv") and not hasattr(port, "mu_fc")
    sd = from_jax_vae(params, {}, "VAEHRNet")
    assert sorted(sd) == ["logvar_conv.bias", "logvar_conv.weight",
                          "mu_conv.bias", "mu_conv.weight"]
    port.load_state_dict(sd, strict=False)
    with torch.no_grad():
        et = torch.from_numpy(e)
        _close(port.mu_conv(et), refs[0], 1e-5)
        _close(port.logvar_conv(et), refs[1], 1e-5)


def test_latent_heads_follow_the_loaded_state():
    """A model built for 512x1024 (conv heads) that loads the state of one
    trained at 32x64 (Dense heads) takes them, as the JAX tree is replaced
    whole on load, and serves at 512x1024's latent shape on its eval path
    (which uses no head)."""
    trained = _port()
    big = hrnet.VAEHRNet(dtype=torch.float32, size=(512, 1024))
    assert hasattr(big, "mu_conv")
    big.load_state_dict(trained.state_dict(), strict=True)
    assert hasattr(big, "mu_fc") and not hasattr(big, "mu_conv")
    assert big.mu_fc.weight.shape == (128, 128)
    trained.load_state_dict(big.state_dict(), strict=True)


# ---- the stem at 46 input channels -------------------------------------------

SB, SH, SW, SCI = 2, 16, 32, 46


@functools.lru_cache(maxsize=None)
def _stem_case():
    rng = np.random.RandomState(11)

    def w(*shape):
        return rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape).astype(
            np.float32)
    stem = (w(3, 3, SCI, 64), rng.uniform(-0.2, 0.2, 64).astype(np.float32),
            w(3, 3, 64, 64), rng.uniform(-0.2, 0.2, 64).astype(np.float32))
    x = rng.uniform(-1, 1, (SB, SH, SW, SCI)).astype(np.float32)
    ct = rng.normal(0, 1, (SB, SH, SW, 64)).astype(np.float32)

    def chain(x, stem):
        return pallas_trainchain.stem_layer1_chain(x, stem, [], 2, True)
    jstem = tuple(map(jnp.asarray, stem))
    y = np.asarray(chain(jnp.asarray(x), jstem))
    g = jax.grad(lambda *a: jnp.sum(chain(*a) * ct), argnums=(0, 1))(
        jnp.asarray(x), jstem)
    return stem, x, ct, y, g


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(((a - b) ** 2).sum() / max((b ** 2).sum(), 1e-30))


def test_stem_at_46_channels_matches_stem_layer1_chain():
    """The plain stem (``trainchain.stem``, the CPU route of the stem
    kernels) at VAEHRNet's 46 input channels against the JAX route that
    takes any 128x128 input, ``stem_layer1_chain(..., interpret=True)``
    (``packed_stem``, pallas_call at :530 and :565), 2x16x32 f32: forward
    and every gradient (dx, dk1, db1, dk2, db2)."""
    stem, x, ct, y_j, (gx, gs) = _stem_case()
    leaves = [torch.from_numpy(np.ascontiguousarray(
        np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a))
        .requires_grad_() for a in stem]
    xt = torch.from_numpy(x).requires_grad_()
    y = trainchain.stem(xt, *leaves)
    np.testing.assert_allclose(y.detach().numpy(), y_j, atol=2e-4, rtol=2e-4)
    (y * torch.from_numpy(ct)).sum().backward()
    assert _rel_l2(xt.grad.numpy(), gx) < 1e-2
    for t, gj in zip(leaves, gs):
        gj = np.asarray(gj)
        ref = np.transpose(gj, (3, 2, 0, 1)) if gj.ndim == 4 else gj
        assert _rel_l2(t.grad.numpy(), ref) < 1e-2


def test_stem_units_at_48_decode_to_the_weights():
    """``stem_units`` for k1 of 46 inputs: w1u (9, 6, 64, 8) with inputs
    46, 47 zero, and wxf (9, 8, 48, 8), the flipped transposed k1, with
    outputs 46, 47 zero; k2's units as at 16."""
    rng = np.random.RandomState(12)
    k1 = torch.from_numpy(rng.normal(0, 0.1, (64, SCI, 3, 3)).astype(
        np.float32))
    k2 = torch.from_numpy(rng.normal(0, 0.05, (64, 64, 3, 3)).astype(
        np.float32))
    b = torch.zeros(64)
    u = trainchain.stem_units(k1, b, k2, b, "cpu")
    assert u["w1u"].shape == (9, 6, 64, 8) and u["wxf"].shape == (9, 8, 48, 8)
    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731
    for t in range(9):
        ky, kx = divmod(t, 3)
        m1 = u["w1u"][t].permute(0, 2, 1).reshape(48, 64)
        assert torch.equal(m1[:SCI], bf(k1[:, :, ky, kx].t()))
        assert not m1[SCI:].any()
        mx = u["wxf"][t].permute(0, 2, 1).reshape(64, 48)
        assert torch.equal(mx[:, :SCI], bf(k1[:, :, 2 - ky, 2 - kx]))
        assert not mx[:, SCI:].any()


def test_stem_48_splits_and_partials():
    """The weight-grad ranges at 48 (dk1 a tile a step, as dk2: 66 and
    66) and the (s1, 9, 48, 64) partials decoded to dk1 (64, 46, 3, 3)."""
    assert trainchain.stem_cin_pad(14) == 16
    assert trainchain.stem_cin_pad(46) == 48
    assert trainchain.stem_cin_pad(49) == trainchain.stem_cin_pad(53) == 64
    with pytest.raises(ValueError, match="64"):
        trainchain.stem_cin_pad(65)
    assert trainchain.stem_wgrad_splits(24, 128, 128, 64) == (66, 66)
    assert trainchain.stem_wgrad_splits(18, 128, 128, 48) == (66, 66)
    assert trainchain.stem_wgrad_splits(2, 16, 32, 48) == (8, 8)
    rng = np.random.RandomState(13)
    dk2p = torch.from_numpy(rng.normal(0, 1, (3, 9, 64, 64)).astype(
        np.float32))
    dk1p = torch.from_numpy(rng.normal(0, 1, (2, 9, 48, 64)).astype(
        np.float32))
    dbp = torch.from_numpy(rng.normal(0, 1, (5, 64)).astype(np.float32))
    dk1, db1, dk2, db2 = trainchain.stem_wgrads(dk2p, dk1p, dbp, 3, SCI)
    assert dk1.shape == (64, SCI, 3, 3)
    s1 = dk1p.sum(0)
    for t in range(9):
        ky, kx = divmod(t, 3)
        assert torch.equal(dk1[:, :, ky, kx], s1[t, :SCI].t())
    assert torch.equal(db1, dbp[3:].sum(0))


def test_stem_routes_46_channels_to_the_48_kernels(monkeypatch):
    """On the kernel route a 46-channel stem pads x to 48 and calls
    ``dvie_stem48_fwd`` / ``dvie_stem48_bwd`` (counted as ``stem48_fwd``
    and ``stem48_bwd``), with dk1's partials (s1, 9, 48, 64); a 53-channel
    one (VAEHRNet in extrapolation with three input frames) the 64-channel
    kernels; a 14-channel one the 16-channel kernels."""
    calls = []

    def fake_call(name, *args):
        calls.append((name, [tuple(a.shape) for a in args
                             if torch.is_tensor(a)]))
        if name.endswith("fwd"):
            args[5].zero_()
            if args[6] is not None:
                args[6].zero_()
        else:
            for t in args[8:12]:
                t.zero_()
    monkeypatch.setattr(trainchain, "_call", fake_call)
    monkeypatch.setattr(hw, "use_kernel", lambda t: True)
    monkeypatch.setattr(hw, "check_bf16", lambda *a, **k: None)
    rng = np.random.RandomState(14)
    for ci, fwd, bwd, xin in ((SCI, "stem48_fwd", "stem48_bwd", 48),
                              (53, "stem64_fwd", "stem64_bwd", 64),
                              (14, "stem_fwd", "stem_bwd", 16)):
        calls.clear()
        ws = [torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32))
              .requires_grad_() for s in ((64, ci, 3, 3), (64,),
                                          (64, 64, 3, 3), (64,))]
        x = torch.zeros((1, 8, 16, ci), dtype=torch.bfloat16,
                        requires_grad=True)
        trainchain.stem(x, *ws).float().sum().backward()
        assert [c[0] for c in calls] == [fwd, bwd]
        assert calls[0][1][0] == (1, 8, 16, xin)
        assert calls[1][1][3] == (1, 8, 16, xin)
        dk1p = calls[1][1][10]
        assert dk1p[2] == xin and dk1p[1] == 9
        assert x.grad.shape == x.shape
