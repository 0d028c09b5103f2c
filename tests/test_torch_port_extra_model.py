"""Extrapolation (recipe 6) models, head routes and data of the port against
the JAX package, on the CPU:

- ExtraNet and ExtraInpaintNet on HRNet in extrapolation mode at full
  width, 2x32x64: ``--num_pred_once`` 1 and 2, with and without
  ``--inpaint`` and ``--inpaint_mask``, ``--fix_init_frames``; every output
  (coarse rgb and seg, the mask, the inpainted frames) in f32 within 1e-4
  of max|ref| on the same weights (the JAX init carried across by
  ``tools/jax_weights.load_jax_params``), and in bf16 by the bound of
  tests/test_torch_port_model.py (5e-2 of max(1, max|ref|), seg argmax
  agreement >= 95%); InpaintUnet alone likewise;
- the plain versions of the new kernel instances: K4's taps mode at N2 =
  216 against ``pallas_upshead._ups_head_taps_ref`` and its backward
  (``ups_head_taps_bwd``) against ``jax.vjp`` of it; the shifted add at co
  = 24 against ``tapped_conv.taps_shifted_add`` + bias and the shift-add
  kernel's arithmetic emulated tile by tile at co = 24; K4's h mode
  ``ups_head_1x1`` differentiable, its gradient against ``jax.vjp`` of
  ``_ups_head_ref`` (the JAX ``custom_vjp``'s backward);
- the registry's refusals, ``serve.final_output`` of the 4-tuple and
  ``serve.rollout``'s windows against the JAX ``Runner._mini_test``;
- the 5-frame clip: ``clip_file_path``'s extrapolation name, the synthetic
  clips and a Cityscapes-layout tree of 5-frame clips (the crop drift
  beyond frame 3) batch for batch against the JAX loaders.
"""

import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from deep_video_interpolation_extrapolation_tpu.core.config import (
    Config as JConfig,
)
from deep_video_interpolation_extrapolation_tpu.data import (
    datasets as jdatasets,
)
from deep_video_interpolation_extrapolation_tpu.models import (
    registry as jregistry,
)
from deep_video_interpolation_extrapolation_tpu.models.hrnet import (
    InpaintUnet as JInpaintUnet,
)
from deep_video_interpolation_extrapolation_tpu.ops import (
    pallas_upshead as jups,
)
from deep_video_interpolation_extrapolation_tpu.ops.tapped_conv import (
    taps_shifted_add,
)
from deep_video_interpolation_extrapolation_tpu.train.runner import (
    Runner as JRunner,
)
from deep_video_interpolation_extrapolation_tpu_torch import serve
from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.data import (
    datasets,
    synthetic,
)
from deep_video_interpolation_extrapolation_tpu_torch.data.cityscapes import (
    IMG_EXT,
    SEG_EXT,
)
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.models.hrnet import (
    InpaintUnet,
    head_widths,
    taps_fit,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops import (
    shiftadd as sa,
    upshead as k4,
)
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    from_jax_submodel,
    load_jax_params,
)
from test_torch_port_wattn_shiftadd import emulate_shifted_add

torch.set_num_threads(1)

B, H, W = 2, 32, 64
EXTRA = dict(runner="EXTRA", syn_type="extra", mode="xs2xs",
             coarse_model="HRNet", input_h=H, input_w=W, batch_size=B,
             dataset="synthetic")
MODELS = {
    "extranet": dict(model="ExtraNet"),
    "pred_once_2": dict(model="ExtraNet", num_pred_once=2),
    "fix_init_frames": dict(model="ExtraNet", fix_init_frames=True),
    "inpaint": dict(model="ExtraInpaintNet", inpaint=True),
    "inpaint_mask": dict(model="ExtraInpaintNet", inpaint=True,
                         inpaint_mask=True),
    "inpaint_mask_pred_once_2": dict(model="ExtraInpaintNet", inpaint=True,
                                     inpaint_mask=True, num_pred_once=2),
}


def _inputs(kw, seed=0):
    n = 3 if kw.get("fix_init_frames") else 2
    rng = np.random.RandomState(seed)
    rgb = rng.uniform(-1, 1, (B, H, W, 3 * n)).astype(np.float32)
    seg = np.eye(20, dtype=np.float32)[rng.randint(0, 20, (B, H, W, n))]
    return rgb, seg.reshape(B, H, W, 20 * n)


def _models(kw, dtype):
    """(JAX model, its variables, the port model on them)."""
    cfg = dict(EXTRA, compute_dtype=dtype, **kw)
    jm = jregistry.build_model(JConfig(**cfg))
    rgb, seg = _inputs(kw)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(rgb),
                        jnp.asarray(seg), train=False)
    pm = registry.build_model(Config(**cfg), device="cpu")
    load_jax_params(pm, jax.tree_util.tree_map(np.asarray,
                                               variables["params"]))
    return jm, variables, pm


@pytest.mark.parametrize("case", sorted(MODELS))
def test_extra_models_match_jax_f32(case):
    kw = MODELS[case]
    jm, variables, pm = _models(kw, "float32")
    rgb, seg = _inputs(kw, seed=1)
    ref = jm.apply(variables, jnp.asarray(rgb), jnp.asarray(seg),
                   train=False)
    with torch.no_grad():
        out = pm(torch.from_numpy(rgb), torch.from_numpy(seg))
    p = kw.get("num_pred_once", 1)
    shapes = [(B, H, W, 3 * p), (B, H, W, 20 * p)]
    if kw.get("inpaint"):
        shapes += [(B, H, W, p), (B, H, W, 3 * p)]
    assert [tuple(o.shape) for o in out] == shapes
    assert len(ref) == len(out)
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert np.abs(o.numpy() - r).max() <= 1e-4 * np.abs(r).max()
    if kw.get("inpaint") and not kw.get("inpaint_mask"):
        assert set(np.unique(out[2].numpy())) <= {0.0, 1.0}


@pytest.mark.parametrize("case", ["inpaint_mask", "pred_once_2"])
def test_extra_models_match_jax_bf16(case):
    kw = MODELS[case]
    jm, variables, pm = _models(kw, "bfloat16")
    rgb, seg = _inputs(kw, seed=2)
    ref = jm.apply(variables, jnp.asarray(rgb), jnp.asarray(seg),
                   train=False)
    out = serve.forward(pm, torch.from_numpy(rgb), torch.from_numpy(seg))
    ref = serve.final_output(tuple(ref))
    for o, r in zip(out, ref):
        o, r = o.float().numpy(), np.asarray(r, np.float32)
        assert np.abs(o - r).max() <= 5e-2 * max(1.0, np.abs(r).max())
    agree = (out[1].float().numpy().argmax(-1)
             == np.asarray(ref[1], np.float32).argmax(-1)).mean()
    assert agree >= 0.95


def test_inpaint_unet_matches_jax():
    rng = np.random.RandomState(3)
    p = 2
    rgb = rng.uniform(-1, 1, (B, H, W, 3 * p)).astype(np.float32)
    mask = rng.uniform(0, 1, (B, H, W, p)).astype(np.float32)
    seg = rng.normal(size=(B, H, W, 20 * p)).astype(np.float32)
    jm = JInpaintUnet(num_pred_once=p, dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(4), rgb, mask, seg)
    ref = np.asarray(jm.apply(v, rgb, mask, seg))
    pm = InpaintUnet(p, torch.float32)
    pm.load_state_dict(from_jax_submodel(
        pm, jax.tree_util.tree_map(np.asarray, v["params"])))
    with torch.no_grad():
        out = pm(*(torch.from_numpy(a) for a in (rgb, mask, seg))).numpy()
    assert out.shape == (B, H, W, 3 * p)
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()
    assert len(list(pm.parameters())) == len(jax.tree_util.tree_leaves(v))


# ---- the new kernel instances' plain versions --------------------------------

def _pyramid(rng, b=2, h=16, w=32):
    return (rng.normal(size=(b, h, w, 64)), rng.normal(size=(b, h // 2, w // 2,
                                                             128)),
            rng.normal(size=(b, h // 4, w // 4, 256)))


def _head(rng, co_r, co_s, cin=448, margin=0.0):
    """w1, b1, w2t of both heads; ``margin``: b1 of +-margin, which keeps
    h (std ~1 before the bias) away from 0, so every lrelu mask is fixed
    (a mask flipped by rounding near 0 moves a backward's max error)."""
    w1 = rng.normal(size=(cin, 2 * cin)) / np.sqrt(cin)
    b1 = (np.sign(rng.normal(size=(2 * cin,))) * margin if margin
          else rng.normal(size=(2 * cin,)) * 0.1)
    wr = torch.from_numpy(rng.normal(size=(co_r, cin, 3, 3)) / np.sqrt(9 * cin))
    ws = torch.from_numpy(rng.normal(size=(co_s, cin, 3, 3)) / np.sqrt(9 * cin))
    w2t = k4.build_dual_tap_kernel(wr, ws, torch.float32).numpy()
    return w1, b1, w2t


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (jnp.bfloat16, 1e-2)])
def test_taps_216_plain_matches_ref(dtype, tol):
    """The taps product of ExtraInpaintNet's 24-wide head (rgb 4 + seg 20:
    N2 = 216, the 216 instance)."""
    rng = np.random.RandomState(0)
    parts = [np.asarray(p, np.float32) for p in _pyramid(rng)]
    w1, b1, w2t = (np.asarray(a, np.float32) for a in _head(rng, 4, 20))
    assert w2t.shape == (896, 216) and k4.taps_width(216) == 216
    assert k4.taps_width(207) == 208
    ref = np.asarray(jups._ups_head_taps_ref(
        *(jnp.asarray(p, dtype) for p in parts), jnp.asarray(w1),
        jnp.asarray(b1), jnp.asarray(w2t)), np.float32)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    out = k4.ups_head_taps(*(torch.from_numpy(p).to(tdt) for p in parts),
                           torch.from_numpy(w1), torch.from_numpy(b1),
                           torch.from_numpy(w2t))
    assert out.shape == (2, 16, 32, 216) and out.dtype == tdt
    assert np.abs(out.float().numpy() - ref).max() <= tol * np.abs(ref).max()
    with pytest.raises(ValueError, match="N2 <= 216"):
        k4.taps_width(217)


def test_taps_216_backward_matches_jax_vjp():
    """``ups_head_taps_bwd`` at N2 = 216 (f32) against ``jax.vjp`` of
    ``_ups_head_taps_ref``, on pre-activations kept from 0."""
    rng = np.random.RandomState(1)
    args = [np.asarray(a, np.float32) for a in
            (*_pyramid(rng), *_head(rng, 4, 20, margin=6.0))]
    g = rng.normal(size=(2, 16, 32, 216)).astype(np.float32)
    _, vjp = jax.vjp(jups._ups_head_taps_ref, *map(jnp.asarray, args))
    refs = vjp(jnp.asarray(g))
    got = k4.ups_head_taps_bwd(*map(torch.from_numpy, args),
                               torch.from_numpy(g))
    for name, o, r in zip(("dp0", "dp1", "dp2", "dw1", "db1", "dw2t"), got,
                          refs):
        r = np.asarray(r)
        assert o.shape == r.shape, name
        assert np.abs(o.numpy() - r).max() <= 1e-4 * np.abs(r).max(), name


def test_ups_head_1x1_gradient_matches_jax_vjp():
    """K4's h mode as a head route: differentiable, by autograd of its
    plain version (the JAX ``_bwd``: ``jax.vjp`` of ``_ups_head_ref``), on
    pre-activations kept from 0."""
    rng = np.random.RandomState(2)
    parts = [np.asarray(p, np.float32) for p in _pyramid(rng)]
    w1, b1, _ = (np.asarray(a, np.float32) for a in _head(rng, 6, 40,
                                                           margin=6.0))
    g = rng.normal(size=(2, 16, 32, 896)).astype(np.float32)
    args = (*parts, w1, b1)
    h_ref, vjp = jax.vjp(jups._ups_head_ref, *map(jnp.asarray, args))
    refs = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    h = k4.ups_head_1x1(*ts)
    assert h.grad_fn is not None
    assert h.detach().abs().min() > 1e-3       # no mask near a flip
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(h_ref),
                               rtol=0, atol=1e-5 * np.abs(h_ref).max())
    h.backward(torch.from_numpy(g))
    for t, r in zip(ts, refs):
        r = np.asarray(r)
        assert np.abs(t.grad.numpy() - r).max() <= 1e-4 * np.abs(r).max()


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_shiftadd_co24_plain_matches_ref(dtype):
    rng = np.random.RandomState(4)
    yt = rng.normal(size=(2, 13, 37, 216)).astype(np.float32)
    b2 = rng.normal(size=(24,)).astype(np.float32)
    ref = np.asarray(taps_shifted_add(jnp.asarray(yt, dtype), 24)
                     + jnp.asarray(b2).astype(dtype), np.float32)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    out = sa.shifted_add_bias(torch.from_numpy(yt).to(tdt),
                              torch.from_numpy(b2))
    assert out.shape == (2, 13, 37, 24) and out.dtype == tdt
    tol = 1e-6 if dtype == np.float32 else 2e-2
    assert np.abs(out.float().numpy() - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("shape", [(2, 7, 13), (1, 37, 70), (1, 5, 1)])
def test_shiftadd_co24_emulation_equals_plain(shape):
    """The kernel's arithmetic at co = 24 (216-wide rows: 16-byte aligned
    runs), tile by tile, equals the plain version bit for bit, and its
    grid covers the image; the adjoint's db2 and dyt at co 24."""
    rng = np.random.RandomState(sum(shape))
    yt = torch.from_numpy(rng.standard_normal(shape + (216,)).astype(
        np.float32)).bfloat16()
    b2 = torch.from_numpy(rng.standard_normal((24,)).astype(np.float32))
    plain = sa.shifted_add_bias_plain(yt, b2)
    assert torch.equal(emulate_shifted_add(yt, b2), plain)
    assert sa.plan(*shape, 24) == sa.plan(*shape, 23)
    g = torch.from_numpy(rng.standard_normal(shape + (24,)).astype(
        np.float32))
    y = yt.float().requires_grad_()
    bb = b2.clone().requires_grad_()
    sa.shifted_add_bias_plain(y, bb).backward(g)
    dyt, db2 = sa.shifted_add_bias_bwd(g, torch.float32, torch.float32)
    torch.testing.assert_close(dyt, y.grad, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(db2, bb.grad, rtol=1e-5, atol=1e-4)


def test_w2_chunks_at_216():
    """The 216 instance's W2t chunks: W2t[nc*64 + 8*kg + k, n] at [nc, kg,
    n, k], zero past N2."""
    w2t = torch.arange(128 * 213, dtype=torch.float32).reshape(128, 213)
    ch = k4.w2_chunks(w2t, "cpu", 216)
    assert ch.shape == (2, 8, 216, 8)
    nc, kg, n, k = 1, 3, 200, 5
    assert ch[nc, kg, n, k] == w2t[nc * 64 + 8 * kg + k, n].bfloat16()
    assert (ch[:, :, 213:] == 0).all()


def test_head_routes_follow_the_jax_predicates():
    """(rgb, seg) widths and their route: taps (K4 + shifted add) where
    ``rgb * 9 <= 128 and seg * 9 <= 256``, K4's h mode else."""
    assert head_widths() == (3, 20)
    assert head_widths("extra", 1, True) == (4, 20)
    assert head_widths("extra", 2, False) == (6, 40)
    assert taps_fit(3, 20) and taps_fit(4, 20)
    assert not taps_fit(6, 40) and not taps_fit(8, 40)


# ---- registry, serving --------------------------------------------------------

@pytest.mark.parametrize("kw,exc", [
    (dict(model="ExtraNet", coarse_model="VAEHRNet"), "vae"),
    (dict(model="ExtraNet", highres_large=True, inpaint=True,
          inpaint_mask=True), None),
    (dict(model="ExtraInpaintNet"), ValueError)])
def test_unported_extra_models_raise(kw, exc):
    """VAEHRNet under ExtraNet (the plain VAE) is taken: its eval forward
    gives (rgb, seg) of one frame, z from the prior
    (tests/test_torch_port_plain_vae.py holds its step to JAX); the 4-part
    head at N2 = 216 (``--highres_large`` with a 24-wide head) is taken:
    the model builds, its coarse model's forward gives a finite frame and a
    mask in [0, 1] (ExtraNet returns the frame and the seg);
    ExtraInpaintNet whose coarse model returns no mask raises the JAX
    ValueError on its forward."""
    cfg = Config(**{**EXTRA, "compute_dtype": "float32", **kw})
    if exc == "vae":
        model = registry.build_model(cfg, device="cpu")
        rgb, seg = _inputs(kw)
        with torch.no_grad():
            out = model(torch.from_numpy(rgb), torch.from_numpy(seg))
        assert len(out) == 2 and out[0].shape == (B, H, W, 3)
        assert out[1].shape == (B, H, W, 20) and torch.isfinite(out[0]).all()
        return
    if exc is None:
        model = registry.build_model(cfg, device="cpu")
        rgb, seg = _inputs(kw)
        with torch.no_grad():
            out = model.coarse_model(torch.from_numpy(rgb),
                                     torch.from_numpy(seg))
        assert out[0].shape == (B, H, W, 3) and torch.isfinite(out[0]).all()
        mask = out[2]
        assert mask.shape == (B, H, W, 1)
        assert bool((mask >= 0).all() and (mask <= 1).all())
        return
    model = registry.build_model(cfg, device="cpu")
    rgb, seg = _inputs(kw)
    with pytest.raises(ValueError, match="mask-producing"):
        model(torch.from_numpy(rgb), torch.from_numpy(seg))


def test_final_output_of_extrainpaintnet_is_the_inpainted_frame():
    a, b, c, d = (torch.full((1,), float(i)) for i in range(4))
    assert serve.final_output((a, b, c, d)) == (d, b)


class _Toy(torch.nn.Module):
    """A stand-in model of ``num_pred_once`` frames whose outputs depend on
    every input channel: rgb = tanh of a fixed mix of the window, seg
    logits = a fixed mix of the seg channels."""

    def __init__(self, n_frames, p):
        super().__init__()
        g = np.random.RandomState(n_frames * 10 + p)
        self.a = g.normal(size=(3 * n_frames, 3 * p)).astype(np.float32)
        self.s = g.normal(size=(20 * n_frames, 20 * p)).astype(np.float32)

    def forward(self, rgb, seg):
        return (torch.tanh(rgb @ torch.from_numpy(self.a)),
                seg @ torch.from_numpy(self.s))

    def jax(self, x, seg):
        return jnp.tanh(x @ self.a), seg @ self.s


@pytest.mark.parametrize("p,steps,fix", [(1, 3, False), (2, 2, False),
                                         (1, 2, True)])
def test_rollout_windows_match_jax_mini_test(p, steps, fix):
    """``serve.rollout`` against the JAX ``Runner._mini_test`` on the same
    toy model: the slide at ``num_pred_once`` 1, the jump to the two
    newest predictions at 2, the second input frame before every window
    under ``--fix_init_frames``."""
    toy = _Toy(3 if fix else 2, p)
    rng = np.random.RandomState(7)
    imgs = [rng.uniform(0, 1, (1, 8, 12, 3)).astype(np.float32)
            for _ in range(2)]
    ids = [rng.randint(0, 20, (1, 8, 12)).astype(np.uint8) for _ in range(2)]
    cfg = types.SimpleNamespace(num_pred_step=steps, num_pred_once=p,
                                syn_type="extra", fix_init_frames=fix)
    stub = types.SimpleNamespace(
        cfg=cfg, rng=jax.random.PRNGKey(0), _ensure_minitest_fwd=lambda: None,
        _minitest_fwd=lambda params, bs, x, seg, key: toy.jax(x, seg),
        state=types.SimpleNamespace(params=None, batch_stats=None))
    ref_imgs, ref_ids = JRunner._mini_test(
        stub, [jnp.asarray(i) for i in imgs],
        [jax.nn.one_hot(i, 20) for i in ids])
    out_imgs, out_ids = serve.rollout(
        toy, [torch.from_numpy(i) for i in imgs],
        [torch.from_numpy(i) for i in ids], steps, p, fix)
    assert len(out_imgs) == len(ref_imgs) == steps * p
    for o, r, oi, ri in zip(out_imgs, ref_imgs, out_ids, ref_ids):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5)
        assert np.array_equal(oi.numpy(), np.asarray(ri))


# ---- the 5-frame clip -----------------------------------------------------------

def test_clip_file_path_of_extrapolation():
    for kw in (dict(syn_type="extra", vid_length=3),
               dict(syn_type="extra", vid_length=1),
               dict(syn_type="inter")):
        cfg = JConfig(**{**dict(runner="EXTRA"), **kw})
        assert datasets.clip_file_path(cfg) == jdatasets.clip_file_path(cfg)
    assert datasets.clip_file_path(JConfig(
        syn_type="extra", vid_length=3, interval=9)).endswith(
            "int_9_len_5_extra_lsclip.pkl")


def test_synthetic_five_frame_clips_match_jax():
    cfg = Config(**{**EXTRA, "split": "train", "num_pred_step": 3})
    ours, _ = datasets.get_dataset(cfg, vid_len=5)
    ref, _ = jdatasets.get_dataset(cfg, vid_len=5)
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        assert "frame5" in a and "seg5" in a and "frame6" not in a
        for k in b:
            if k.startswith("seg"):
                assert np.array_equal(a[k], b[k].argmax(-1)), k
            else:
                assert np.array_equal(a[k], b[k]), k
    a = synthetic.synthetic_batch(2, 8, 12, vid_len=5, seed=3)
    assert sorted(k for k in a if k.startswith("frame")) == [
        f"frame{i}" for i in range(1, 6)]


@pytest.fixture(scope="module")
def tree5(tmp_path_factory):
    """A Cityscapes-layout tree of 5-frame clips (150 px train, 128 px val
    sources) and its extrapolation clip pkl."""
    tmp = tmp_path_factory.mktemp("city5")
    rng = np.random.RandomState(0)
    clips = {"train": [], "val": []}
    for split, src in (("train", 150), ("val", 128)):
        for c in range(5):
            clip = [f"{split}/scene/clip{c}_{i:06d}" for i in range(5)]
            for rel in clip:
                for d, ext, arr in (
                        ("imgs", IMG_EXT, rng.randint(0, 255, (src, src, 3),
                                                      dtype=np.uint8)),
                        ("segs", SEG_EXT, rng.randint(
                            0, 20, (src, src)).astype(np.uint8))):
                    p = tmp / d / (rel + ext)
                    p.parent.mkdir(parents=True, exist_ok=True)
                    Image.fromarray(arr).save(p)
            clips[split].append(clip)
    (tmp / "load_files").mkdir()
    cfg = _city_cfg(tmp)
    with open(jdatasets.clip_file_path(cfg).replace(
            jdatasets.data_root(), str(tmp)), "wb") as f:
        pickle.dump(clips, f)
    return tmp


def _city_cfg(tmp, **kw):
    return Config(**{**EXTRA, "dataset": "cityscape", "interval": 1,
                     "img_dir": str(tmp / "imgs"),
                     "seg_dir": str(tmp / "segs"), "seed": 5,
                     "num_pred_step": 3, **kw})


@pytest.mark.parametrize("split", ["train", "val"])
def test_cityscape_five_frame_clips_match_jax(tree5, monkeypatch, split):
    """Train crops drift on past frame 3 (each step's shift repeated,
    clamped), val takes the whole frame: the same 5-frame batches as the
    JAX loader, over two epochs."""
    monkeypatch.setenv("DVIE_DATA_ROOT", str(tree5))
    monkeypatch.setenv("DVIE_SEG_IDS", "1")
    cfg = _city_cfg(tree5, split=split)
    pick = 0 if split == "train" else 1
    ours = datasets.make_loader(cfg, datasets.get_dataset(cfg, 5)[pick])
    ref = jdatasets.make_loader(cfg, jdatasets.get_dataset(cfg, 5)[pick])
    assert ours.ds.vid_len == ref.ds.vid_len == 5
    for epoch in (1, 2):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        n = 0
        for a, b in zip(ours, ref):
            assert sorted(a) == sorted(b) and "frame5" in a
            for k in a:
                assert np.array_equal(a[k], b[k]), (epoch, k)
            n += 1
        assert n == len(ref) > 0
