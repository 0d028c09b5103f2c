"""The plain VAE: InterNet and ExtraNet on a VAEHRNet coarse (JAX
``train/inter.py:53-65, :107-125`` and ``train/extra.py:120-145``) against
the JAX package's steps, f32, B=2 32x64.

Both sides start from the JAX init (carried across by
``tools/jax_weights.load_jax_params``); the eps of each forward is
recovered from the JAX step's trace (the decoder's input z and the
captured mu and logvar: eps = (z - mu) / exp(logvar / 2), one per rollout
step in EXTRA, where each step draws its own) and handed to the port's
VAEHRNet.  Held: every loss term and ``loss_all`` (1e-4 relative: ~60
convolutions and a 1024-wide Dense latent in f32, summed in another
order) and the coarse model's gradient (rel-L2 < 1e-3).  ExtraNet rolls
out 2 steps at ``--num_pred_once 1`` (the predicted frame fed back), and
its eval forward draws z from the prior; at eval both composites return
(rgb, seg).  ExtraInpaintNet on a VAEHRNet raises the JAX ValueError (no
mask), and a refine composite's step refuses it, as the JAX one does.
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
from deep_video_interpolation_extrapolation_tpu.models import hrnet as jhrnet
from deep_video_interpolation_extrapolation_tpu.models import (
    registry as jregistry,
)
from deep_video_interpolation_extrapolation_tpu.train import (
    common as jcommon,
    extra as jextra,
    inter as jinter,
    state as jstate,
)
from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.data.synthetic import (
    synthetic_batch,
)
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    from_jax_submodel,
    load_jax_params,
)
from deep_video_interpolation_extrapolation_tpu_torch.train import (
    extra,
    inter,
    state as state_lib,
)

torch.set_num_threads(2)

B, H, W = 2, 32, 64
BASE = dict(coarse_model="VAEHRNet", mode="xs2xs", compute_dtype="float32",
            input_h=H, input_w=W, batch_size=B, train_coarse=True,
            kld_weight=20.0, vgg_weight=0.0)
KW = {"InterNet": dict(BASE, model="InterNet", syn_type="inter",
                       runner="INTER"),
      "ExtraNet": dict(BASE, model="ExtraNet", syn_type="extra",
                       runner="EXTRA", num_pred_step=2)}


def _batch(name, seed):
    return synthetic_batch(B, H, W, vid_len=4 if name == "ExtraNet" else 3,
                           seed=seed)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(((a - b) ** 2).sum() / max((b ** 2).sum(), 1e-30))


@functools.lru_cache(maxsize=None)
def jax_step(name):
    """The JAX init and its step on batch 1: (variables, losses, grads,
    [eps of each forward])."""
    cfg = JConfig(**KW[name])
    model = jregistry.build_model(cfg)
    b = jcommon.expand_segs({k: jnp.asarray(v)
                             for k, v in _batch(name, 0).items()})
    x = jnp.concatenate([b["frame1"], b["frame2"]], -1)
    seg = jnp.concatenate([b["seg1"], b["seg2"]], -1)
    variables = model.init({"params": jax.random.PRNGKey(0),
                            "noise": jax.random.PRNGKey(1)}, x, seg,
                           gt_rgb=b["frame3"], gt_seg=b["seg3"], train=True)
    state = jstate.create_train_state(cfg, variables)
    seen = {"z": [], "mu": [], "logvar": []}
    orig_apply = jstate.apply_updates

    def rec_apply(cfg, state, grads, new_bs=None):
        seen["grads"] = grads
        return orig_apply(cfg, state, grads, new_bs)

    def keep(key, value):
        jax.debug.callback(lambda v: seen[key].append(np.asarray(v)), value)

    def capture(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__":
            if isinstance(context.module, jhrnet._VAEDecoder):
                keep("z", args[0])
            elif isinstance(context.module, jhrnet.VAEHRNet):
                keep("mu", out[2])
                keep("logvar", out[3])
        return out

    lib = jextra if name == "ExtraNet" else jinter
    step = lib.make_train_step(cfg, model)

    def run(state, batch, rng):
        with fnn.intercept_methods(capture):
            _, ld = step(state, batch, rng)
        return ld, seen["grads"]

    lib.state_lib.apply_updates = rec_apply
    try:
        batch = {k: jnp.asarray(v) for k, v in _batch(name, 1).items()}
        ld, grads = jax.block_until_ready(
            jax.jit(run)(state, batch, jax.random.PRNGKey(5)))
        jax.effects_barrier()
    finally:
        lib.state_lib.apply_updates = orig_apply
    eps = [((z.reshape(B, -1) - mu) / np.exp(0.5 * lv)).astype(np.float32)
           for z, mu, lv in zip(seen["z"], seen["mu"], seen["logvar"])]
    return variables, ld, grads, eps


def _port(name, variables):
    cfg = Config(**KW[name])
    model = registry.build_model(cfg, device="cpu")
    load_jax_params(model, variables["params"], variables["batch_stats"])
    return cfg, model, state_lib.create_train_state(cfg, model, None)


@pytest.mark.parametrize("name", ["InterNet", "ExtraNet"])
def test_plain_vae_step_matches_jax(name, monkeypatch):
    variables, ref, grads, eps = jax_step(name)
    assert len(eps) == (2 if name == "ExtraNet" else 1)
    cfg, model, state = _port(name, variables)
    coarse = model.coarse_model
    draws = iter(eps)
    fwd = type(coarse).forward
    monkeypatch.setattr(coarse, "forward", lambda *a, **k: fwd(
        coarse, *a, noise=torch.from_numpy(next(draws)), **k))
    lib = extra if name == "ExtraNet" else inter
    step = lib.make_train_step(cfg, model, torch.Generator())
    _, ld = step(state, {k: torch.from_numpy(v)
                         for k, v in _batch(name, 1).items()})
    assert list(ld) == list(ref)
    kld = [k for k in ld if "kld" in k]
    assert kld == (["step_1_coarse_kld_loss", "step_2_coarse_kld_loss"]
                   if name == "ExtraNet" else ["coarse_kld_loss"])
    for k, v in ld.items():
        r = float(ref[k])
        assert abs(float(v) - r) <= 1e-4 * abs(r) + 1e-7, (k, float(v), r)
    want = from_jax_submodel(coarse, grads["coarse_model"],
                             variables["batch_stats"]["coarse_model"])
    got = np.concatenate([p.grad.flatten().numpy()
                          for _, p in coarse.named_parameters()])
    exp = np.concatenate([want[k].flatten().numpy()
                          for k, _ in coarse.named_parameters()])
    assert _rel_l2(got, exp) < 1e-3


@pytest.mark.parametrize("name", ["InterNet", "ExtraNet"])
def test_plain_vae_eval_and_refusals(name):
    """Eval forwards (z from the prior) return (rgb, seg) of the JAX
    shapes; ExtraInpaintNet on a VAEHRNet raises the JAX ValueError; a
    VAEHRNet under InterRefineNet builds and its step raises."""
    cfg = Config(**KW[name])
    model = registry.build_model(cfg, device="cpu")
    assert model.coarse_model.vae
    b = {k: torch.from_numpy(v) for k, v in _batch(name, 2).items()}
    x = torch.cat([b["frame1"], b["frame2"]], -1)
    seg = torch.nn.functional.one_hot(
        torch.cat([b["seg1"], b["seg2"]], -1).long(), 20).reshape(
            B, H, W, 40).float()
    with torch.no_grad():
        out = model(x, seg)
    assert len(out) == 2 and out[0].shape == (B, H, W, 3)
    assert out[1].shape == (B, H, W, 20) and torch.isfinite(out[0]).all()
    if name == "ExtraNet":
        bad = dataclasses.replace(cfg, model="ExtraInpaintNet", inpaint=True,
                                  inpaint_mask=True)
        with torch.no_grad(), pytest.raises(ValueError, match="mask"):
            registry.build_model(bad, device="cpu")(x, seg)
    else:
        ref = dataclasses.replace(cfg, model="InterRefineNet")
        registry.build_model(ref, device="cpu")
        with pytest.raises(ValueError, match="VAEHRNet"):
            inter.make_train_step(ref, None)
