"""The legacy models ported (models/unet.py, legacy_gen.py, gridnet.py,
legacy_disc.py, legacy_heads.py) against the JAX package's modules: each of
the 14 models and heads on the JAX init carried across by
``tools/jax_weights.load_jax_legacy``, one train-mode forward (batch
statistics; the BatchNorm running statistics after it) and one eval-mode
forward on the same numpy inputs, B=2, 32x64, f32, both sides on the CPU.

Tolerance: every output within 1e-4 of the largest magnitude of its JAX
counterpart (f32 convolutions summed in another order, through up to ~40
layers), the running statistics within 1e-5 of theirs.  The registry builds
every name of the JAX registry (and refuses an unknown one with KeyError)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.core.config import Config as JConfig
from deep_video_interpolation_extrapolation_tpu.models import (
    gridnet as jgrid,
    legacy_disc as jdisc,
    legacy_gen as jgen,
    legacy_heads as jheads,
    registry as jregistry,
    unet as junet,
)
from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.models import (
    gridnet,
    legacy_disc,
    legacy_gen,
    legacy_heads,
    registry,
    unet,
)
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    flax_key_map,
    load_jax_legacy,
)

torch.set_num_threads(2)
B, H, W = 2, 32, 64
TOL, STATS_TOL = 1e-4, 1e-5
HEAD_CFG = dict(model="RefineNet", coarse_model="HRNet",
                refine_model="refineUnet", n_scales=1, syn_type="inter",
                mode="xs2xs", compute_dtype="float32", input_h=H, input_w=W)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 20, (B, H, W, 3))
    oh = np.eye(20, dtype=np.float32)
    return dict(
        rgb=rng.uniform(-1, 1, (B, H, W, 6)).astype(np.float32),
        seg=np.concatenate([oh[ids[..., 0]], oh[ids[..., 1]]], -1),
        gt_rgb=rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32),
        gt_seg=oh[ids[..., 2]],
        fg=rng.randint(0, 2, (B, H, W, 2)).astype(np.float32))


def _x(n):
    return lambda i: (np.concatenate([i["rgb"], i["seg"]], -1)[..., :n],)


# name -> (JAX module, port module, positional inputs)
CASES = {
    "UNet": (lambda: junet.UNet(), lambda: unet.UNet(),
             lambda i: (i["rgb"], i["seg"])),
    "SepUNet": (lambda: junet.SepUNet(), lambda: unet.SepUNet(),
                lambda i: (i["rgb"], i["seg"], i["fg"])),
    "MyFRRN": (lambda: jgen.MyFRRN(), lambda: legacy_gen.MyFRRN(),
               lambda i: (i["rgb"], i["seg"])),
    "MyFRRN_xx2x": (lambda: jgen.MyFRRN(mode="xx2x"),
                    lambda: legacy_gen.MyFRRN(mode="xx2x"),
                    lambda i: (i["rgb"],)),
    "PSPNet": (lambda: jgen.PSPNet(), lambda: legacy_gen.PSPNet(),
               lambda i: (i["rgb"], i["seg"])),
    "PSPNetV2": (lambda: jgen.PSPNetV2(), lambda: legacy_gen.PSPNetV2(),
                 lambda i: (i["rgb"], i["seg"])),
    "B2SNet": (lambda: jgen.B2SNet(), lambda: legacy_gen.B2SNet(),
               lambda i: (i["rgb"],)),
    "GridNet": (lambda: jgrid.GridNet(), lambda: gridnet.GridNet(), _x(46)),
    "NLayerDiscriminator": (
        lambda: jdisc.NLayerDiscriminator(get_interm_feat=True),
        lambda: legacy_disc.NLayerDiscriminator(23, get_interm_feat=True),
        _x(23)),
    "MultiscaleDiscriminator": (
        lambda: jdisc.MultiscaleDiscriminator(num_d=2, use_sigmoid=True),
        lambda: legacy_disc.MultiscaleDiscriminator(23, num_d=2,
                                                    use_sigmoid=True),
        _x(23)),
    "MotionDiscriminator": (lambda: jdisc.MotionDiscriminator(),
                            lambda: legacy_disc.MotionDiscriminator(9),
                            _x(9)),
    "GAN": (lambda: jheads.GAN(), lambda: legacy_heads.GAN(),
            lambda i: (i["rgb"], i["seg"], i["gt_rgb"], i["gt_seg"])),
    "RefineNet": (
        lambda: jheads.RefineNet(cfg=JConfig(**HEAD_CFG), dtype=jnp.float32),
        lambda: legacy_heads.RefineNet(Config(**HEAD_CFG)),
        lambda i: (i["rgb"], i["seg"], i["gt_rgb"], i["gt_seg"])),
    "RefineGAN": (
        lambda: jheads.RefineGAN(cfg=JConfig(**{**HEAD_CFG,
                                                 "model": "RefineGAN"}),
                                 dtype=jnp.float32),
        lambda: legacy_heads.RefineGAN(Config(**{**HEAD_CFG,
                                                  "model": "RefineGAN"})),
        lambda i: (i["rgb"], i["seg"], i["gt_rgb"], i["gt_seg"])),
}


def _leaves(out):
    if out is None:
        return []
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _leaves(o)]
    return [np.asarray(out.detach() if isinstance(out, torch.Tensor)
                       else out, dtype=np.float32)]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@functools.lru_cache(maxsize=None)
def _jax_side(name):
    """(variables at init, train-mode outputs, batch_stats after them,
    eval-mode outputs with the initial statistics)."""
    jmod, _, args = CASES[name]
    m = jmod()
    inputs = [jnp.asarray(a) for a in args(_inputs())]
    variables = m.init(jax.random.PRNGKey(0), *inputs, train=True)
    out, new = m.apply(variables, *inputs, train=True,
                       mutable=["batch_stats"])
    ev = m.apply(variables, *inputs, train=False)
    return (_np_tree(dict(variables)), _leaves(jax.device_get(out)),
            _np_tree(dict(new).get("batch_stats", {})),
            _leaves(jax.device_get(ev)))


def _close(got, want, tol, label):
    assert len(got) == len(want), (label, len(got), len(want))
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (label, k, g.shape, w.shape)
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-6)
        assert err < tol, (label, k, err)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name):
    """Train-mode outputs and BatchNorm statistics, then eval-mode outputs
    on the initial statistics, against the JAX module."""
    variables, out, stats, ev = _jax_side(name)
    _, pmod, args = CASES[name]
    model = pmod()
    load_jax_legacy(model, variables["params"], variables.get("batch_stats"))
    inputs = [torch.from_numpy(a) for a in args(_inputs())]
    keep = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        _close(_leaves(model(*inputs, train=True)), out, TOL, f"{name} train")
    if stats:
        params = variables["params"]
        moved = dict(model.state_dict())
        for key, (coll, *path), _ in flax_key_map(params, stats):
            if coll != "batch_stats":
                continue
            want = functools.reduce(lambda t, p: t[p], path, stats)
            np.testing.assert_allclose(moved[key].numpy(), want,
                                       atol=STATS_TOL, err_msg=key)
        model.load_state_dict(keep)
    with torch.no_grad():
        _close(_leaves(model(*inputs, train=False)), ev, TOL, f"{name} eval")


JAX_NAMES = ("UNet", "SepUNet", "MyFRRN", "PSPNet", "PSPNetV2", "B2SNet",
             "GridNet", "GAN", "RefineNet", "RefineGAN", "VAE", "VAE_S",
             "VAE_SD")


@pytest.mark.parametrize("name", JAX_NAMES)
def test_registry_builds_every_jax_name(name):
    """``build_model`` builds each legacy name the JAX registry builds
    (registry.py:166-181 there), with the same parameter count; the
    legacy generators also as ``--coarse_model``; an unknown name raises
    KeyError on both sides."""
    kw = dict(HEAD_CFG, model=name)
    cfg, jcfg = Config(**kw), JConfig(**kw)
    model = registry.build_model(cfg, device="cpu")
    assert not model.training
    jm = jregistry.build_model(jcfg)
    if name not in ("VAE", "VAE_S", "VAE_SD") and name in CASES:
        variables = _jax_side(name)[0]
        n_jax = sum(np.size(a) for a in jax.tree_util.tree_leaves(
            variables["params"]))
        assert sum(p.numel() for p in model.parameters()) == n_jax
    assert type(jm).__name__ == type(model).__name__
    if name in registry.legacy_generators(cfg):
        coarse = registry.build_coarse(Config(**dict(kw, coarse_model=name)))
        assert type(coarse).__name__ == type(model).__name__


def test_unknown_names_raise_keyerror():
    for build, kw in ((registry.build_model, dict(model="NoSuchNet")),
                      (registry.build_coarse,
                       dict(coarse_model="NoSuchNet"))):
        with pytest.raises(KeyError):
            build(Config(**kw), **({"device": "cpu"}
                                   if build is registry.build_model else {}))
    with pytest.raises(KeyError):
        jregistry.build_model(JConfig(model="NoSuchNet"))


def test_entry_points_default_to_the_card():
    """``build_model`` and ``build_coarse`` of a legacy name (and so every
    legacy step, which trains the model it is given) default to the card:
    without one ``build_model`` raises rather than building on the CPU."""
    cfg = Config(model="GAN", coarse_model="MyFRRN")
    if torch.cuda.is_available():
        model = registry.build_model(cfg)
        assert next(model.parameters()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.build_model(cfg)
