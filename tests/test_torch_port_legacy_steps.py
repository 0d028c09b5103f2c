"""The legacy train steps ported (train/legacy.py) against the JAX
package's ``train/legacy.py``: each of the five step factories takes one
step on both sides from the same JAX init (the port's weights carried
across by ``tools/jax_weights``) on one numpy batch, f32, on the CPU; the
loss dict (keys in the JAX order, values), every trained submodel's
gradient (captured on the JAX side at its optimizer update), its
parameters after the update and the BatchNorm statistics.  Then the two
stop-gradient properties of the JAX package's tests/test_legacy_train.py
on the port: the GAN steps' discriminator update does not move when the
adversarial weight is scaled (the G pass runs against the frozen
discriminator), and a frozen coarse model stays put under RefineGAN; and
``gan_weights_init``'s statistics.

Tolerances, the rules of tests/test_torch_port_recipe2.py: loss terms 1e-4
relative; each trained submodel's gradient rel-L2 < 1e-3 (1e-2 for
RefineGAN's refiner and discriminator, whose gradients pass through the
two-scale PatchGAN's train-mode BatchNorms, over 16 values a channel at
its last layers at 32x64: on the port a 1e-6 relative change of the
discriminator's input moves its input gradient by 7.6e-4 rel-L2, so f32
summation order alone moves these by ~1e-3); after one Adamax
step its parameters within 2 * lr of JAX's everywhere and within 1e-3 * lr
for >= 99% of the entries whose JAX gradient exceeds 1e-5 (the first
Adamax step is lr * g / (|g| + 1e-8): near-zero gradients may flip sign
with the f32 summation order); after one SGD-with-momentum step (the
discriminators') the parameter change within the gradient's bound; BatchNorm
statistics within 1e-5.  The VAE's eps is JAX's own draw, recovered from
the posterior's code as (z - mu) / exp(logvar / 2).  The VAE steps without
its refine net, as the JAX package's own test_legacy_vae_step does: the
JAX refine net's max pool (a reduce_window with an array init) has no
reverse-mode rule, so the JAX step cannot differentiate it."""

import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.core.config import Config as JConfig
from deep_video_interpolation_extrapolation_tpu.models import (
    legacy_gen as jgen,
    legacy_heads as jheads,
    vae_video as jvae,
)
from deep_video_interpolation_extrapolation_tpu.train import (
    common as jcommon,
    legacy as JL,
    state as jstate,
)
from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.models import (
    legacy_heads,
    registry,
    subnets,
    vae_video,
)
from deep_video_interpolation_extrapolation_tpu_torch.models.features import (
    VGG19Features,
)
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    from_jax_vae,
    from_jax_vgg,
    legacy_state_dict,
)
from deep_video_interpolation_extrapolation_tpu_torch.train import (
    legacy,
    state as state_lib,
)

torch.set_num_threads(2)
B, H, W = 2, 32, 64
T, HV = 2, 32                     # the VAE's steps and frame size
LR = 1e-3
BASE = dict(runner="INTER", syn_type="inter", mode="xs2xs",
            compute_dtype="float32", input_h=H, input_w=W, batch_size=B,
            coarse_model="HRNet", refine_model="refineUnet", n_scales=1)
CFGS = {
    "simple": dict(BASE, model="MyFRRN"),
    "vae": dict(BASE, model="VAE", vid_length=T, input_h=HV, input_w=HV),
    "gan": dict(BASE, model="GAN"),
    "refiner": dict(BASE, model="RefineNet", train_coarse=True,
                    train_refine=True),
    "refiner_gan": dict(BASE, model="RefineGAN", train_coarse=False),
}
# each step's trained submodels, in the order the JAX step updates them,
# with their optimizer kind
TRAINED = {"simple": [("", "adamax")], "vae": [("", "adamax")],
           "gan": [("netG", "adamax"), ("netD", "sgd")],
           "refiner": [("coarse_model", "adamax"), ("refine_model", "adamax")],
           "refiner_gan": [("coarse_model", "adamax"),
                           ("refine_model", "adamax"),
                           ("discriminator", "sgd")]}
GRAD_TOL = 1e-3
GRAD_TOL_PATCHGAN = 1e-2       # through the PatchGAN's BatchNorms (above)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def inter_batch(seed):
    rng = np.random.RandomState(seed)
    batch = {f"frame{i}": rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
             for i in (1, 2, 3)}
    batch.update({f"seg{i}": rng.randint(0, 20, (B, H, W)).astype(np.uint8)
                  for i in (1, 2, 3)})
    return batch


def vae_batch(seed):
    """Smooth frames in [0, 1] (bilinear upsamplings of 4x4 fields, as
    tests/test_torch_port_vae.py makes them), seg ids, complementary
    masks."""
    rng = np.random.RandomState(seed)
    coarse = torch.from_numpy(rng.uniform(0, 1, (B * (T + 1), 3, 4, 4))
                              .astype(np.float32))
    frames = torch.nn.functional.interpolate(
        coarse, size=(HV, HV), mode="bilinear", align_corners=False)
    frames = frames.permute(0, 2, 3, 1).reshape(B, T + 1, HV, HV, 3)
    fg = (rng.uniform(0, 1, (B, T + 1, HV, HV, 1)) > 0.5).astype(np.float32)
    return {"frames": frames.numpy(),
            "segs": rng.randint(0, 20, (B, T + 1, HV, HV)).astype(np.uint8),
            "fg_masks": fg, "bg_masks": 1.0 - fg}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(((a - b) ** 2).sum() / max((b ** 2).sum(), 1e-30))


def _jax_model(kind, cfg):
    if kind == "simple":
        return jgen.MyFRRN(mode="xs2xs", dtype=jnp.float32)
    if kind == "vae":
        return jvae.VideoVAE(vid_length=T, variant="vae", refine=False,
                             dtype=jnp.float32)
    if kind == "gan":
        return jheads.GAN(net_d="multi_scale_img_seg", num_d=2,
                          dtype=jnp.float32)
    cls = jheads.RefineNet if kind == "refiner" else jheads.RefineGAN
    return cls(cfg=cfg, dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def jax_step(kind):
    """The JAX step ``kind`` on batch 1 from its init: (initial variables,
    frozen VGG params or None, new params, new batch_stats, losses, the
    gradients each optimizer update saw in order, the VAE's eps)."""
    cfg = JConfig(**CFGS[kind])
    model = _jax_model(kind, cfg)
    key = jax.random.PRNGKey(0)
    vgg = None
    if kind == "vae":
        b0 = _jb(vae_batch(0))
        segs = jcommon.seg_oh(b0["segs"])
        variables = model.init({"params": key, "noise": key}, b0["frames"],
                               segs, b0["bg_masks"], b0["fg_masks"],
                               train=True)
        vgg = jcommon.init_vgg_frozen(cfg, jax.random.PRNGKey(1))
        opts = jstate.make_tx(cfg.coarse_optimizer,
                              cfg.coarse_learning_rate).init(
                                  variables["params"])
        step = JL.make_vae_train_step(cfg, model, {"vgg": vgg})
        batch = _jb(vae_batch(1))
    else:
        b0 = _jb(inter_batch(0))
        x, seg, gt, gt_seg = jcommon.get_inter_inputs(b0)
        if kind == "gan":
            variables = JL.init_gan_variables(cfg, model, key, b0)
            opts = JL.init_gan_opt_states(cfg, variables["params"])
            step = JL.make_gan_train_step(cfg, model)
        elif kind == "simple":
            variables = model.init(key, x, seg, train=True)
            vgg = jcommon.init_vgg_frozen(cfg, jax.random.PRNGKey(1))
            opts = jstate.make_tx(cfg.coarse_optimizer,
                                  cfg.coarse_learning_rate).init(
                                      variables["params"])
            step = JL.make_simple_train_step(cfg, model, {"vgg": vgg})
        else:
            variables = jax.jit(lambda *a: model.init(key, *a, train=True))(
                x, seg, gt, gt_seg)
            init = (JL.init_refiner_opt_states if kind == "refiner"
                    else JL.init_refiner_gan_opt_states)
            opts = init(cfg, variables["params"])
            step = (JL.make_refiner_train_step(cfg, model)
                    if kind == "refiner"
                    else JL.make_refiner_gan_train_step(cfg, model))
        batch = _jb(inter_batch(1))
    seen = {"grads": []}
    orig = JL._single_tx_update

    def rec(params, grads, opt_state, tx):
        jax.debug.callback(lambda g: seen["grads"].append(_np(g)), grads,
                           ordered=True)
        return orig(params, grads, opt_state, tx)

    def keep(name, value):
        jax.debug.callback(lambda v: seen.__setitem__(name, np.asarray(v)),
                           value)

    def capture(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__":
            if isinstance(context.module, fnn.Dense) and \
                    context.module.name == "fc":
                keep("z", args[0])
            elif isinstance(context.module, jvae.VideoVAE):
                keep("mu", out[2])
                keep("logvar", out[3])
        return out

    def run(params, opts, bs, batch):
        with fnn.intercept_methods(capture):
            return step(params, opts, bs, batch, jax.random.PRNGKey(5))

    JL._single_tx_update = rec
    try:
        new_params, _, new_bs, ld = jax.block_until_ready(jax.jit(run)(
            variables["params"], opts, variables.get("batch_stats", {}),
            batch))
        jax.effects_barrier()
    finally:
        JL._single_tx_update = orig
    eps = None
    if kind == "vae":
        eps = ((seen["z"] - seen["mu"]) / np.exp(0.5 * seen["logvar"])
               ).astype(np.float32)
    return (_np(dict(variables)), None if vgg is None else _np(vgg),
            _np(new_params), _np(new_bs), {k: float(v) for k, v in ld.items()},
            seen["grads"], eps)


def port_setup(kind, cfg_kw=None):
    """The port's model for ``kind`` on the JAX init, its train state (with
    the JAX frozen VGG where the JAX step has one) and its step."""
    variables, vgg_params, *_ = jax_step(kind)
    cfg = Config(**(cfg_kw or CFGS[kind]))
    if kind == "vae":
        model = vae_video.VideoVAE(vid_length=T, variant="vae", refine=False,
                                   dtype=torch.float32, size=(HV, HV))
    else:
        model = registry.build_model(cfg, device="cpu")
    if kind == "vae":
        model.load_state_dict(from_jax_vae(variables["params"],
                                           variables.get("batch_stats", {})))
    else:
        model.load_state_dict(legacy_state_dict(
            model, variables["params"], variables.get("batch_stats")))
    vgg = None
    if vgg_params is not None:
        vgg = VGG19Features(dtype=torch.float32)
        vgg.load_state_dict(from_jax_vgg(vgg_params))
    state = state_lib.create_train_state(cfg, model, vgg)
    make = {"simple": legacy.make_simple_train_step,
            "vae": legacy.make_vae_train_step,
            "gan": legacy.make_gan_train_step,
            "refiner": legacy.make_refiner_train_step,
            "refiner_gan": legacy.make_refiner_gan_train_step}[kind]
    return cfg, model, state, make(cfg, model)


def _port_layout(kind, model, tree, batch_stats=None):
    """A JAX params-shaped tree (and batch_stats) in the port model's
    keys."""
    if kind == "vae":
        bs = batch_stats or jax_step(kind)[0]["batch_stats"]
        return from_jax_vae(tree, bs)
    return legacy_state_dict(model, tree, batch_stats)


def _sub_keys(model, name):
    return [k for k, _ in model.named_parameters()
            if not name or k.startswith(name + ".")]


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_one_step_matches_jax(kind):
    variables, _, new_params, new_bs, ld_j, grads_j, eps = jax_step(kind)
    cfg, model, state, step = port_setup(kind)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _tb(vae_batch(1) if kind == "vae" else inter_batch(1))
    kw = {"eps": torch.from_numpy(eps)} if kind == "vae" else {}
    _, ld = step(state, batch, **kw)

    assert list(ld) == list(ld_j), (list(ld), list(ld_j))
    for k in ld_j:
        assert rel(ld[k], ld_j[k]) < 1e-4, (k, float(ld[k]), ld_j[k])

    params = dict(model.named_parameters())
    after_j = _port_layout(kind, model, new_params)
    for (name, opt), g_tree in zip(TRAINED[kind], grads_j):
        full = {name: g_tree} if name else g_tree
        g_ref_map = _port_layout(kind, model, full)
        keys = _sub_keys(model, name)
        if kind == "refiner_gan" and name == "coarse_model":
            # --train_coarse off: frozen, no gradient, unmoved (the JAX
            # gradient is zero: the refiner sees the detached coarse)
            assert all(not params[k].requires_grad and params[k].grad is None
                       for k in keys)
            assert all(np.abs(g_ref_map[k].numpy()).max() == 0 for k in keys)
            assert all(torch.equal(params[k], before[k]) for k in keys)
            continue
        g = np.concatenate([params[k].grad.numpy().ravel() for k in keys])
        g_ref = np.concatenate([g_ref_map[k].numpy().ravel() for k in keys])
        tol = GRAD_TOL_PATCHGAN if kind == "refiner_gan" else GRAD_TOL
        assert rel_l2(g, g_ref) < tol, (name, rel_l2(g, g_ref))
        p = np.concatenate([params[k].detach().numpy().ravel() for k in keys])
        p_ref = np.concatenate([after_j[k].numpy().ravel() for k in keys])
        if opt == "sgd":
            p0 = np.concatenate([before[k].numpy().ravel() for k in keys])
            assert rel_l2(p - p0, p_ref - p0) < tol, name
            continue
        d = np.abs(p - p_ref)
        big = np.abs(g_ref) > 1e-5
        sure = big & (10 * np.abs(g - g_ref) < np.abs(g_ref))
        assert sure.sum() >= 0.99 * big.sum(), name
        assert d[sure].max() <= 1e-3 * LR, name
        assert d.max() <= 2 * LR, name

    if new_bs:
        stats = {k: v for k, v in _port_layout(kind, model, new_params,
                                                new_bs).items()
                 if ".running_" in k}
        moved = model.state_dict()
        assert stats
        for k, v in stats.items():
            np.testing.assert_allclose(moved[k].numpy(), v.numpy(),
                                       atol=1e-5, err_msg=k)


def _disc_unmoved_by_adv_weight(kind, monkeypatch, scale):
    """Two port steps from the same init, the adversarial weight scaled
    1000x in the second: the discriminator's parameters after each."""
    d_name = "netD" if kind == "gan" else "discriminator"
    g_name = "netG" if kind == "gan" else "refine_model"
    out = []
    for w in (1.0, 1000.0):
        kw = dict(CFGS[kind])
        if kind == "gan":
            monkeypatch.setattr(legacy, "_GANER_ADV_WEIGHT", w)
        else:
            kw["frame_disc_gen_weight"] = w * Config().frame_disc_gen_weight
        _, model, state, step = port_setup(kind, kw)
        step(state, _tb(inter_batch(1)))
        out.append({k: v.detach().clone()
                    for k, v in model.named_parameters()})
    for k in out[0]:
        if k.startswith(d_name + "."):
            assert torch.equal(out[0][k], out[1][k]), k
    assert any(not torch.equal(out[0][k], out[1][k])
               for k in out[0] if k.startswith(g_name + "."))


@pytest.mark.parametrize("kind", ["gan", "refiner_gan"])
def test_adv_term_never_reaches_the_discriminator(kind, monkeypatch):
    """Scaling the adversarial term leaves the discriminator's update
    bit-identical while the generator's changes (the JAX package's
    tests/test_legacy_train.py:61-87)."""
    _disc_unmoved_by_adv_weight(kind, monkeypatch, 1000.0)


def test_refiner_gan_moves_refine_and_disc_not_frozen_coarse():
    """train_coarse off: the refiner and the discriminator move, the
    coarse model does not (the JAX package's test_legacy_train.py:163-194),
    and the three GAN terms are zero before the warm-up ends."""
    cfg, model, state, step = port_setup("refiner_gan")
    before = {k: v.clone() for k, v in model.named_parameters()}
    _, ld = step(state, _tb(inter_batch(1)))
    for k in ("refine_0_l1_loss", "adv_loss", "d_real_loss", "d_fake_loss"):
        assert np.isfinite(float(ld[k])), k
    for name in ("refine_model", "discriminator"):
        assert any(not torch.equal(p, before[k])
                   for k, p in model.named_parameters()
                   if k.startswith(name + "."))
    assert all(torch.equal(p, before[k]) for k, p in model.named_parameters()
               if k.startswith("coarse_model."))
    step = legacy.make_refiner_gan_train_step(cfg, model,
                                              adv_warmup_steps=10)
    _, ld = step(state, _tb(inter_batch(2)), global_step=3)
    assert all(float(ld[k]) == 0.0
               for k in ("adv_loss", "d_real_loss", "d_fake_loss"))


def test_gan_weights_init_stats():
    """``gan_weights_init`` (utils/net_utils.py:31-37): conv kernels
    ~N(0, 0.02), BatchNorm scale ~N(1, 0.02) and bias 0, conv biases
    untouched (the JAX package's test_gan_weights_init_stats)."""
    model = legacy_heads.GAN(dtype=torch.float32)
    registry.init_weights(model, 0)
    legacy.init_gan_variables(model, seed=3)
    n_conv = n_bn = 0
    bn_ids = {id(m.weight): "scale" for m in model.modules()
              if isinstance(m, subnets.BatchNorm)}
    bn_ids.update({id(m.bias): "bias" for m in model.modules()
                   if isinstance(m, subnets.BatchNorm)})
    for name, p in model.named_parameters():
        a = p.detach().numpy()
        if id(p) in bn_ids:
            n_bn += 1
            if bn_ids[id(p)] == "scale":
                assert abs(a.mean() - 1.0) < 2e-2, name
            else:
                assert np.all(a == 0), name
        elif a.ndim == 4:
            n_conv += 1
            if a.size >= 1000:
                assert abs(a.mean()) < 5e-3, name
                assert abs(a.std() - 0.02) < 5e-3, name
        else:
            assert np.all(a == 0), name            # conv biases: zero init
    assert n_conv > 10 and n_bn > 0
