"""The track-object loss (``losses/perceptual.make_track_obj_loss``) and one
recipe-4 step with ``--track_obj_loss`` and ``--track_gen`` against the
JAX package, f32, at B=2 32x64 with 2 tracks.

- The loss on the frozen ResNet101 (its BatchNorms randomized, carried by
  ``from_jax_resnet101``; tests/test_torch_port_resnet101.py) and its
  gradient with respect to the predicted frame: value within 1e-6 (the
  seeded network's cosines are near 1, so the loss, 1 - cosine, carries
  the f32 rounding of 1), gradient within 1e-4 rel-L2.
- One step of InterGANNet (VAEHRNet, TrackGenV2 with ``gt_bbox_for_loss``,
  ``--track_obj_loss --track_obj_w 8``, no discriminator family: the
  generator's terms are the new ones) from the JAX init carried across by
  ``load_jax_params``, the VAE's eps recovered from the JAX step's trace as
  tests/test_torch_port_gan_step.py does: every loss term and ``loss_all``
  (1e-4 relative) and each submodel's gradient (rel-L2 < 1e-3; the
  coarse model's is the sum of ~45 convolutions' chains through the track
  generator and the ResNet101, in f32).  The refusals of the JAX step: the
  loss without the network or without boxes raises its ``ValueError``.
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
from deep_video_interpolation_extrapolation_tpu.losses import (
    perceptual as jperc,
)
from deep_video_interpolation_extrapolation_tpu.models import hrnet as jhrnet
from deep_video_interpolation_extrapolation_tpu.train import (
    inter_gan as jgan,
    state as jstate,
)
from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.data.synthetic import (
    synthetic_batch,
)
from deep_video_interpolation_extrapolation_tpu_torch.losses.perceptual import (
    make_track_obj_loss,
)
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    from_jax_submodel,
    load_jax_params,
)
from deep_video_interpolation_extrapolation_tpu_torch.train import (
    inter_gan,
    state as state_lib,
)
from test_torch_port_resnet101 import jax_resnet, port_resnet

torch.set_num_threads(2)

B, H, W, NT = 2, 32, 64, 2
STEP = dict(
    model="InterGANNet", coarse_model="VAEHRNet", syn_type="inter",
    mode="xs2xs", compute_dtype="float32", input_h=H, input_w=W,
    batch_size=B, num_track_per_img=NT, train_coarse=True, vae=True,
    gan=True, kld_weight=20.0, vgg_weight=0.0, track_obj_loss=True,
    track_obj_weight=8.0, track_gen=True, track_gen_model="TrackGenV2")


def _batch(seed):
    return synthetic_batch(B, H, W, vid_len=3, n_track=NT, seed=seed)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(((a - b) ** 2).sum() / max((b ** 2).sum(), 1e-30))


def test_track_obj_loss_matches_jax():
    m, v = jax_resnet()
    rng = np.random.RandomState(4)
    pred, fwd, back = (rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
                       for _ in range(3))
    bb = _batch(0)["bboxes"]
    jloss = jperc.make_track_obj_loss(m, v)
    ref, g_ref = jax.value_and_grad(
        lambda p: jloss(p, jnp.asarray(fwd), jnp.asarray(back),
                        jnp.asarray(bb)))(jnp.asarray(pred))
    loss = make_track_obj_loss(port_resnet())
    pt = torch.from_numpy(pred).requires_grad_()
    out = loss(pt, torch.from_numpy(fwd), torch.from_numpy(back),
               torch.from_numpy(bb))
    assert abs(float(out) - float(ref)) <= 1e-6
    out.backward()
    assert _rel_l2(pt.grad.numpy(), g_ref) <= 1e-4


@pytest.fixture(scope="module")
def jax_step():
    """The JAX init, and its step on batch 1: (init variables, new-state
    losses, grads, eps)."""
    cfg = JConfig(**STEP)
    batch = {k: jnp.asarray(v) for k, v in _batch(0).items()}
    variables = jax.jit(functools.partial(jgan.init_variables, cfg))(
        jax.random.PRNGKey(0), batch)
    state = jstate.create_train_state(cfg, variables)
    _, rn = jax_resnet()
    seen = {}
    orig_apply = jstate.apply_updates

    def rec_apply(cfg, state, grads, new_bs=None):
        seen["grads"] = grads
        return orig_apply(cfg, state, grads, new_bs)

    def keep(name, value):
        jax.debug.callback(
            lambda v: seen.__setitem__(name, np.asarray(v)), value)

    def capture(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__":
            if isinstance(context.module, jhrnet._VAEDecoder):
                keep("z", args[0])
            elif isinstance(context.module, jhrnet.VAEHRNet):
                keep("mu", out[2])
                keep("logvar", out[3])
        return out

    step = jgan.make_train_step(cfg, track_obj_frozen=rn)

    def run(state, batch, rng):
        with fnn.intercept_methods(capture):
            _, ld = step(state, batch, rng)
        return ld, seen["grads"]

    jgan.state_lib.apply_updates = rec_apply
    try:
        batch = {k: jnp.asarray(v) for k, v in _batch(1).items()}
        ld, grads = jax.block_until_ready(
            jax.jit(run)(state, batch, jax.random.PRNGKey(5)))
        jax.effects_barrier()
    finally:
        jgan.state_lib.apply_updates = orig_apply
    eps = (np.asarray(seen["z"]).reshape(B, -1) - seen["mu"]) / np.exp(
        0.5 * seen["logvar"])
    return variables, ld, grads, eps.astype(np.float32)


def _port(variables, kw=STEP):
    cfg = Config(**kw)
    model = registry.build_model(cfg, device="cpu")
    load_jax_params(model, variables["params"], variables["batch_stats"])
    return cfg, model, state_lib.create_train_state(cfg, model, None,
                                                    port_resnet())


def test_step_matches_jax(jax_step, monkeypatch):
    variables, ref, grads, eps = jax_step
    cfg, model, state = _port(variables)
    coarse = model.coarse_model
    monkeypatch.setattr(coarse, "forward", functools.partial(
        type(coarse).forward, coarse, noise=torch.from_numpy(eps)))
    step = inter_gan.make_train_step(cfg, model, torch.Generator())
    _, ld = step(state, {k: torch.from_numpy(v)
                         for k, v in _batch(1).items()})
    assert list(ld) == list(ref)
    assert "coarse_track_obj_loss" in ld and "coarse_loc_diff_loss" in ld
    for k, v in ld.items():
        r = float(ref[k])
        assert abs(float(v) - r) <= 1e-4 * abs(r) + 1e-7, (k, float(v), r)
    bs = variables["batch_stats"]
    assert sorted(n for n, _ in model.named_children()) == [
        "coarse_model", "track_gen_model"]
    for name, sub in model.named_children():
        want = from_jax_submodel(sub, grads[name], bs.get(name))
        got = np.concatenate([p.grad.flatten().numpy()
                              for _, p in sub.named_parameters()])
        exp = np.concatenate([want[k].flatten().numpy()
                              for k, _ in sub.named_parameters()])
        assert _rel_l2(got, exp) < 1e-3, name
    assert set(state.optimizers) == {"coarse_model", "track_gen_model"}
    assert type(state.optimizers["track_gen_model"]).__name__ == "Adamax"


def test_step_refusals(jax_step):
    """Without the frozen network, or without boxes, the track-object loss
    raises the JAX step's ValueError."""
    variables = jax_step[0]
    cfg, model, state = _port(variables)
    batch = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    step = inter_gan.make_train_step(cfg, model, torch.Generator())
    with pytest.raises(ValueError, match="ResNet101"):
        step(dataclasses.replace(state, frozen_resnet=None), batch)
    del batch["bboxes"]
    with pytest.raises(ValueError, match="bbox"):
        step(state, batch)
