"""One recipe-4 train step of the port (``train/inter_gan.make_train_step``:
InterGANNet, VAEHRNet coarse, the four discriminator families of the
recipe: FrameSN, VideoSN, FrameSNDet and VideoLSSNDet) against the JAX
package's single-backward step, at B=2 32x64 f32, ``--n_track 2``, the
recipe's weights and learning rates (``--vgg_w 0``: the VGG19 cannot take
32x64's 1/4 scale, as tests/test_torch_port_recipe2.py).

Both sides start from the JAX init (``gan_lib.init_variables``), carried
across by ``tools/jax_weights.load_jax_params`` with the batch statistics
and spectral-norm vectors.  The JAX step's random draws are recovered
inside its trace (sent to the host by ``jax.debug.callback``): the VAE's
eps from the decoder's input z and the captured mu and logvar (eps = (z -
mu) / exp(logvar / 2)); the sync_neg boxes from a wrapper of
``detdisc._sync_neg_boxes``; both are handed to the port's step.  The
JAX gradients are read from the step's ``apply_updates`` call (a wrapper
records them).

Held: every loss term (1e-4 relative), each submodel's gradient (rel-L2
< 1e-3), the Adamax and Adam updates of the step, and every BatchNorm
statistic and spectral-norm ``u`` and ``sigma`` after it (1e-4 * max(1,
max|ref|)).  A first Adam/Adamax step moves a weight by about lr * sign(g):
where |g| sits within rounding noise of 0 the two sides may move it in
opposite directions, so the step's update may differ by more than lr / 100
at under 1 weight in 1000 and by at most 2 lr; given the JAX gradients,
the port's optimizers make optax's update to within lr / 1000.  Then the
gradient isolation: with every discriminator weight 0, every
discriminator gradient is exactly zero.
"""

import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.core.config import (
    Config as JConfig,
)
from deep_video_interpolation_extrapolation_tpu.models import (
    composite as jcomposite,
)
from deep_video_interpolation_extrapolation_tpu.models import detdisc as jdet
from deep_video_interpolation_extrapolation_tpu.models import hrnet as jhrnet
from deep_video_interpolation_extrapolation_tpu.train import (
    inter_gan as jgan,
    state as jstate,
)
from deep_video_interpolation_extrapolation_tpu.train.common import (
    get_inter_inputs as jinputs,
)
from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.data.synthetic import (
    synthetic_batch,
)
from deep_video_interpolation_extrapolation_tpu_torch.models import (
    detdisc,
    registry,
)
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    from_jax_submodel,
    load_jax_params,
)
from deep_video_interpolation_extrapolation_tpu_torch.train import (
    inter_gan,
    state as state_lib,
)
from deep_video_interpolation_extrapolation_tpu_torch.train.common import (
    get_inter_inputs,
)

torch.set_num_threads(2)

B, H, W, NT = 2, 32, 64, 2
RECIPE4 = dict(
    model="InterGANNet", coarse_model="VAEHRNet", syn_type="inter",
    mode="xs2xs", compute_dtype="float32", input_h=H, input_w=W,
    batch_size=B, num_track_per_img=NT, train_coarse=True, vae=True,
    gan=True, kld_weight=20.0, vgg_weight=0.0,
    frame_disc=True, frame_disc_model="FrameSNDiscriminator",
    train_frame_disc=True, frame_disc_gen_weight=0.4,
    frame_disc_disc_weight=0.001, frame_disc_learning_rate=1e-4,
    video_disc=True, video_disc_model="VideoSNDiscriminator",
    train_video_disc=True, video_disc_gen_weight=0.4,
    video_disc_disc_weight=0.001, video_disc_learning_rate=1e-4,
    frame_det_disc=True, frame_det_disc_model="FrameSNDetDiscriminator",
    train_frame_det_disc=True, frame_det_disc_gen_weight=0.4,
    frame_det_disc_disc_weight=0.001, frame_det_disc_learning_rate=1e-4,
    video_det_disc=True, video_det_disc_model="VideoLSSNDetDiscriminator",
    train_video_det_disc=True, video_det_disc_gen_weight=0.4,
    video_det_disc_disc_weight=0.01, video_det_disc_learning_rate=1e-4)


def _batch(seed):
    return synthetic_batch(B, H, W, vid_len=3, n_track=NT, seed=seed)


@functools.lru_cache(maxsize=None)
def _jax_init():
    cfg = JConfig(**RECIPE4)
    batch = {k: jnp.asarray(v) for k, v in _batch(0).items()}
    return jgan.init_variables(cfg, jax.random.PRNGKey(0), batch)


@functools.lru_cache(maxsize=None)
def _jax_step():
    """The JAX step on batch 1: (new state, losses, grads, eps, swapped
    mid boxes of the sync_neg pass)."""
    cfg = JConfig(**RECIPE4)
    variables = _jax_init()
    state = jstate.create_train_state(cfg, variables)
    seen = {}
    orig_apply, orig_sync = jstate.apply_updates, jdet._sync_neg_boxes

    def rec_apply(cfg, state, grads, new_bs=None):
        seen["grads"] = grads
        return orig_apply(cfg, state, grads, new_bs)

    def keep(name, value):
        jax.debug.callback(
            lambda v: seen.__setitem__(name, np.asarray(v)), value)

    def rec_sync(module, mid):
        swapped = orig_sync(module, mid)
        keep("swapped", swapped)
        return swapped

    def capture(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__":
            if isinstance(context.module, jhrnet._VAEDecoder):
                keep("z", args[0])
            elif isinstance(context.module, jhrnet.VAEHRNet):
                keep("mu", out[2])
                keep("logvar", out[3])
        return out

    step = jgan.make_train_step(cfg)

    def run(state, batch, rng):
        with fnn.intercept_methods(capture):
            new_state, ld = step(state, batch, rng)
        return new_state, ld, seen["grads"]

    jgan.state_lib.apply_updates = rec_apply
    jdet._sync_neg_boxes = rec_sync
    try:
        batch = {k: jnp.asarray(v) for k, v in _batch(1).items()}
        new_state, ld, grads = jax.block_until_ready(
            jax.jit(run)(state, batch, jax.random.PRNGKey(5)))
        jax.effects_barrier()
    finally:
        jgan.state_lib.apply_updates = orig_apply
        jdet._sync_neg_boxes = orig_sync
    z, mu, logvar, swapped = (seen[k] for k in ("z", "mu", "logvar",
                                                "swapped"))
    eps = (np.asarray(z).reshape(B, -1) - np.asarray(mu)) / np.exp(
        0.5 * np.asarray(logvar))
    return new_state, ld, grads, eps.astype(np.float32), np.asarray(swapped)


def _port(kw=RECIPE4):
    cfg = Config(**kw)
    variables = _jax_init()
    model = registry.build_model(cfg, device="cpu")
    load_jax_params(model, variables["params"], variables["batch_stats"])
    return cfg, model, state_lib.create_train_state(cfg, model)


def _port_step(monkeypatch, kw=RECIPE4):
    _, _, _, eps, swapped = _jax_step()
    cfg, model, state = _port(kw)
    coarse = model.coarse_model
    monkeypatch.setattr(coarse, "forward", functools.partial(
        type(coarse).forward, coarse, noise=torch.from_numpy(eps)))
    monkeypatch.setattr(detdisc, "_sync_neg_boxes",
                        lambda mid, gen=None: torch.from_numpy(swapped))
    before = {n: {k: p.detach().clone() for k, p in sub.named_parameters()}
              for n, sub in model.named_children()}
    step = inter_gan.make_train_step(cfg, model, torch.Generator())
    batch = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    state, ld = step(state, batch)
    return model, ld, before


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(((a - b) ** 2).sum() / max((b ** 2).sum(), 1e-30))


@pytest.fixture(scope="module")
def stepped():
    mp = pytest.MonkeyPatch()
    try:
        yield _port_step(mp)
    finally:
        mp.undo()


def test_loss_terms_match_jax(stepped):
    """Every term of the loss dict, in the reference's order."""
    _, ld, _ = stepped
    _, ref, _, _, _ = _jax_step()
    assert list(ld) == list(ref)
    assert list(ld)[:6] == ["coarse_l1_loss", "coarse_gdl_loss",
                            "coarse_vgg_loss", "coarse_ssim_loss",
                            "coarse_ce_loss", "coarse_kld_loss"]
    for k, v in ld.items():
        r = float(ref[k])
        assert abs(float(v) - r) <= 1e-4 * abs(r) + 1e-7, (k, float(v), r)


def test_gradients_match_jax(stepped):
    """Each submodel's gradient over all of its parameters."""
    model, _, _ = stepped
    _, _, grads, _, _ = _jax_step()
    bs = _jax_init()["batch_stats"]
    for name, sub in model.named_children():
        want = from_jax_submodel(sub, grads[name], bs.get(name))
        got, ref = [], []
        for k, p in sub.named_parameters():
            got.append(p.grad.flatten().numpy())
            ref.append(want[k].flatten().numpy())
        err = _rel_l2(np.concatenate(got), np.concatenate(ref))
        assert err < 1e-3, (name, err)


def _lrs(model):
    return {name: (RECIPE4.get("coarse_learning_rate", 1e-3)
                   if name == "coarse_model" else 1e-4)
            for name, _ in model.named_children()}


def test_optimizer_updates_and_state_match_jax(stepped):
    """The step's Adamax (coarse) and Adam (discriminators) updates, and
    the moved BatchNorm statistics and spectral-norm vectors.  An update
    is lr * sign(g) for all but the weights whose gradient sits within
    rounding noise of 0: under 1 in 1000 may differ by more than lr / 100,
    none by more than 2 lr."""
    model, _, before = stepped
    new_state, _, _, _, _ = _jax_step()
    lrs = _lrs(model)
    for name, sub in model.named_children():
        want = from_jax_submodel(sub, new_state.params[name],
                                 new_state.batch_stats.get(name))
        du, dj = [], []
        for k, p in sub.named_parameters():
            du.append((p.detach() - before[name][k]).flatten().numpy())
            dj.append((want[k] - before[name][k]).flatten().numpy())
        d = np.abs(np.concatenate(du) - np.concatenate(dj))
        frac = (d > lrs[name] / 100).mean()
        assert frac < 1e-3, (name, frac)
        assert d.max() <= 2 * lrs[name] + 1e-7, name
        params = {k for k, _ in sub.named_parameters()}
        n = 0
        for k, t in sub.state_dict().items():
            if k in params:
                continue
            r = want[k].numpy()
            assert np.abs(t.numpy() - r).max() <= 1e-4 * max(
                1.0, np.abs(r).max()), (name, k)
            n += 1
        assert n > 0, name


def test_optimizers_step_as_optax():
    """Given the JAX step's gradients, the port's optimizers
    (``state.create_train_state``: Adamax for the coarse model, Adam at
    each discriminator's learning rate) make optax's update: every weight
    within lr / 1000 of the JAX step's."""
    new_state, _, grads, _, _ = _jax_step()
    cfg, model, state = _port()
    bs = _jax_init()["batch_stats"]
    assert {n: type(o).__name__ for n, o in state.optimizers.items()} == {
        "coarse_model": "Adamax", "frame_disc_model": "Adam",
        "frame_det_disc_model": "Adam", "video_disc_model": "Adam",
        "video_det_disc_model": "Adam"}
    for name, sub in model.named_children():
        g = from_jax_submodel(sub, grads[name], bs.get(name))
        for k, p in sub.named_parameters():
            p.grad = g[k].clone()
    state_lib.apply_updates(cfg, state)
    lrs = _lrs(model)
    for name, sub in model.named_children():
        want = from_jax_submodel(sub, new_state.params[name],
                                 new_state.batch_stats.get(name))
        for k, p in sub.named_parameters():
            d = (p.detach() - want[k]).abs().max().item()
            assert d <= lrs[name] / 1000, (name, k, d)


def test_discriminators_get_no_generator_gradient(monkeypatch):
    """With every discriminator's D weight 0 only G terms reach them: the
    G pass runs each discriminator on detached parameters, so every
    discriminator gradient is exactly zero, while the coarse model's is
    not."""
    kw = dict(RECIPE4)
    for fam in ("frame_disc", "video_disc", "frame_det_disc",
                "video_det_disc"):
        kw[f"{fam}_disc_weight"] = 0.0
    model, ld, _ = _port_step(monkeypatch, kw)
    for name, sub in model.named_children():
        grads = [p.grad for p in sub.parameters()]
        assert all(g is not None for g in grads), name
        nonzero = any(bool(g.abs().max() > 0) for g in grads)
        assert nonzero == (name == "coarse_model"), name
    assert float(ld["coarse_frame_loss"]) > 0


def test_intergannet_forward_matches_jax(monkeypatch):
    """``InterGANNet.forward`` in train mode against the JAX composite's
    ``__call__`` on the same weights and eps (recovered as in the step):
    the reference's 19-tuple, entry by entry (the discriminator passes in
    the composite's order, fake, real, G per family, then the sync_neg
    pass rolled by one as without its rng) within 1e-3 * max(1,
    max|ref|) (train-mode BatchNorms, as the modules' test), and in eval
    mode the coarse pair with every discriminator entry None."""
    cfg = JConfig(**RECIPE4)
    variables = _jax_init()
    jm = jcomposite.InterGANNet(cfg=cfg)
    batch = _batch(2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    seen = {}

    def capture(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if (context.method_name == "__call__"
                and isinstance(context.module, jhrnet._VAEDecoder)):
            jax.debug.callback(lambda v: seen.__setitem__("z", np.asarray(v)),
                               args[0])
        return out

    @jax.jit
    def run(v, jb):
        with fnn.intercept_methods(capture):
            return jm.apply(v, *jinputs(jb), bboxes=jb["bboxes"], train=True,
                            rngs={"noise": jax.random.PRNGKey(3)},
                            mutable=["batch_stats"])[0]
    ref = jax.block_until_ready(run(variables, jb))
    jax.effects_barrier()
    mu, lv = np.asarray(ref[2]), np.asarray(ref[3])
    eps = (seen["z"].reshape(B, -1) - mu) / np.exp(0.5 * lv)
    _, model, _ = _port()
    coarse = model.coarse_model
    monkeypatch.setattr(coarse, "forward", functools.partial(
        type(coarse).forward, coarse,
        noise=torch.from_numpy(eps.astype(np.float32))))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        out = model(*get_inter_inputs(tb), bboxes=tb["bboxes"], train=True)
    assert len(out) == len(ref) == 19
    for i, (o, r) in enumerate(zip(out, ref)):
        assert (o is None) == (r is None), i
        if o is not None:
            r = np.asarray(r, np.float32)
            bound = 1e-3 * max(1.0, np.abs(r).max())
            assert np.abs(o.numpy() - r).max() <= bound, (i, o, r)
    monkeypatch.undo()
    with torch.no_grad():
        ev = model(*get_inter_inputs(tb)[:2])
    assert ev[0].shape == (B, H, W, 3) and ev[1].shape == (B, H, W, 20)
    assert all(e is None for e in ev[2:18]) and float(ev[18]) == 0.0


def test_refusals():
    """--track_gen builds the track generator beside the coarse model and
    --track_obj_loss without its frozen network raises the JAX ValueError
    (tests/test_torch_port_track_obj.py holds both to JAX); --remat is
    taken: the step builds and runs one step to finite losses
    (tests/test_torch_port_gan_remat.py holds it to JAX); a video_det
    family without sync_neg support raises as the JAX step does."""
    base = Config(**RECIPE4)
    model = registry.build_model(dataclasses.replace(base, track_gen=True),
                                 device="cpu")
    assert type(model.track_gen_model).__name__ == "TrackGen"
    cfg, model, state = _port()
    with pytest.raises(ValueError, match="ResNet101"):
        inter_gan.make_train_step(
            dataclasses.replace(base, track_obj_loss=True), model,
            torch.Generator())(state, {k: torch.from_numpy(v)
                                       for k, v in _batch(1).items()})
    cfg, model, state = _port({**RECIPE4, "remat": True})
    state, ld = inter_gan.make_train_step(cfg, model, torch.Generator())(
        state, {k: torch.from_numpy(v) for k, v in _batch(1).items()})
    assert state.step == 1 and np.isfinite(float(ld["loss_all"]))
    bad = dataclasses.replace(base,
                              video_det_disc_model="VideoSNDiscriminator")
    with pytest.raises(ValueError, match="sync_neg"):
        inter_gan.make_train_step(bad, registry.build_model(bad,
                                                            device="cpu"))
