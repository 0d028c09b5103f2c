"""Recipe 6's train and eval steps of the port (``train/extra.py``: ExtraNet
on HRNet in extrapolation mode, back-propagation through a rollout of
``--num_pred_step`` forwards) against the JAX package's
``train/extra.make_train_step`` / ``make_eval_step``, at full width, B=2
32x64 f32, frozen VGG19, on the XLA path the JAX package takes on the CPU.

Both sides start from the JAX init carried across by
``tools/jax_weights.load_jax_params`` (the VGG19 by ``from_jax_vgg``) and
take the same numpy batch of 2 + num_pred_step frames.  The JAX gradients
are read from the step's ``apply_updates`` call (a wrapper records them).

The seg fed back to the next step is the one-hot of the argmax of the seg
logits, a discrete choice with no gradient.  Where two logits of a pixel
are within rounding of each other, two correct f32 implementations can
pick different classes (one pixel of batch 1 at two steps: logits 1.2e-7
apart), and the next step then sees another input there.  So the JAX
step's one-hots are recorded (``jax.debug.callback``) and the port's step
is fed them, after a check that its own argmax picks the same class at
every pixel but near-ties (within 1e-5 of the pixel's largest logit): the
test holds the differentiable computation on the same discrete choices,
and the choices to rounding.

Held, with the tolerances of tests/test_torch_port_train.py: every loss
term within 1e-4 relative; the whole gradient by rel-L2 < 1e-3 and each
tensor's < 1e-2; the eval metrics within 1e-4 relative.  The Adamax update:
a first step moves a weight by lr * g / (|g| + eps), about lr * sign(g), so
where |g| sits within the gradients' rounding noise of 0 the two sides may
move it in opposite directions (by up to 2 * lr).  That noise reaches 5e-4
of a tensor's largest |g| in the stem after three steps' BPTT, and flips
the sign of 0.14% of InpaintUnet's weights.  So every weight moves within
2 * lr of the JAX step's, and every weight whose gradient the two sides
resolve alike (|g| over 1e3 * eps and within 10% of each other: 90% of
them or more) within 1e-3 * lr: the port's Adamax makes optax's update.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.core.config import (
    Config as JConfig,
)
from deep_video_interpolation_extrapolation_tpu.models import (
    registry as jregistry,
)
from deep_video_interpolation_extrapolation_tpu.train import (
    common as jcommon,
    extra as jextra,
    state as jstate,
)
from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.models.features import (
    VGG19Features,
)
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    from_jax_submodel,
    from_jax_vgg,
    load_jax_params,
)
from deep_video_interpolation_extrapolation_tpu_torch.train import (
    extra,
    state as state_lib,
)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

B, H, W = 2, 32, 64
LR = 1e-3
# recipe 6 (docs/RECIPES.md:76-83) at 32x64
RECIPE6 = dict(runner="EXTRA", model="ExtraNet", syn_type="extra",
               mode="xs2xs", coarse_model="HRNet", compute_dtype="float32",
               input_h=H, input_w=W, batch_size=B, dataset="synthetic",
               train_coarse=True, coarse_learning_rate=LR, num_pred_step=3)


def _batch(seed, n_frames):
    rng = np.random.RandomState(seed)
    batch = {f"frame{i}": rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
             for i in range(1, n_frames + 1)}
    batch.update({f"seg{i}": rng.randint(0, 20, (B, H, W)).astype(np.uint8)
                  for i in range(1, n_frames + 1)})
    return batch


def _n_frames(kw):
    return 2 + kw.get("num_pred_once", 1) * kw["num_pred_step"]


TIE = 1e-5      # a near-tie of two seg logits, relative to the largest


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _recording_one_hots(seen):
    """A stand-in for ``jextra._one_hot_from_logits`` that records each
    call's one-hot, in trace order, into ``seen["oh"]``."""
    orig = jextra._one_hot_from_logits
    seen["oh"] = {}

    def rec(seg_logits, n=20):
        oh = orig(seg_logits, n)
        i = len(seen["oh"])
        seen["oh"][i] = None
        jax.debug.callback(
            lambda v: seen["oh"].__setitem__(i, np.asarray(v)), oh)
        return oh
    return rec


class FedOneHots:
    """``extra.one_hot_from_logits`` fed the JAX step's one-hots, in order,
    each checked against the port's own argmax: equal at every pixel whose
    logits are not within TIE of a tie."""

    def __init__(self, one_hots):
        self.one_hots, self.i, self.flips = one_hots, 0, 0

    def __call__(self, seg_logits):
        ref = torch.tensor(self.one_hots[self.i], dtype=seg_logits.dtype)
        self.i += 1
        own = seg_logits.argmax(-1)
        flip = own != ref.argmax(-1)
        if flip.any():
            top = seg_logits.max(-1).values
            picked = (seg_logits * ref).sum(-1)
            gap = (top - picked)[flip]
            assert (gap <= TIE * top.abs()[flip].clamp(min=1)).all(), gap
            self.flips += int(flip.sum())
        return ref


@functools.lru_cache(maxsize=None)
def _jax_init(items):
    """The JAX model, its init variables and the frozen VGG19 of a
    configuration (``items``: sorted (key, value) pairs)."""
    kw = dict(items)
    cfg = JConfig(**kw)
    model = jregistry.build_model(cfg)
    b = jcommon.expand_segs({k: jnp.asarray(v) for k, v in
                             _batch(0, _n_frames(kw)).items()})
    x = jnp.concatenate([b["frame1"], b["frame2"]], -1)
    seg = jnp.concatenate([b["seg1"], b["seg2"]], -1)
    if cfg.fix_init_frames:
        x = jnp.concatenate([b["frame2"], x], -1)
        seg = jnp.concatenate([b["seg2"], seg], -1)
    variables = model.init(jax.random.PRNGKey(0), x, seg, train=False)
    vgg = jcommon.init_vgg_frozen(cfg, jax.random.PRNGKey(1))
    return cfg, model, variables, vgg


@functools.lru_cache(maxsize=None)
def jax_step(items):
    """The JAX step on batch 1: (state before, state after, losses,
    grads)."""
    cfg, model, variables, vgg = _jax_init(items)
    state = jstate.create_train_state(cfg, variables, frozen={"vgg": vgg})
    seen = {}
    orig = jstate.apply_updates
    orig_oh = jextra._one_hot_from_logits

    def rec_apply(cfg, state, grads, new_bs=None):
        seen["grads"] = grads
        return orig(cfg, state, grads, new_bs)

    step = jextra.make_train_step(cfg, model)

    def run(state, batch, rng):
        new_state, ld = step(state, batch, rng)
        return new_state, ld, seen["grads"]

    jextra.state_lib.apply_updates = rec_apply
    jextra._one_hot_from_logits = _recording_one_hots(seen)
    try:
        batch = {k: jnp.asarray(v)
                 for k, v in _batch(1, _n_frames(dict(items))).items()}
        new, ld, grads = jax.block_until_ready(
            jax.jit(run)(state, batch, jax.random.PRNGKey(2)))
        jax.effects_barrier()
    finally:
        jextra.state_lib.apply_updates = orig
        jextra._one_hot_from_logits = orig_oh
    one_hots = [seen["oh"][i] for i in range(len(seen["oh"]))]
    return state, new, _np(ld), _np(grads), one_hots


def _port(kw, params):
    """The port's model on ``params`` (the JAX tree), its train state and
    frozen VGG19."""
    cfg = Config(**kw)
    _, _, _, vgg_j = _jax_init(tuple(sorted(kw.items())))
    model = registry.build_model(cfg, device="cpu")
    load_jax_params(model, _np(params))
    vgg = VGG19Features(dtype=torch.float32)
    vgg.load_state_dict(from_jax_vgg(_np(vgg_j)))
    return cfg, model, state_lib.create_train_state(cfg, model, vgg)


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(((a - b) ** 2).sum() / max((b ** 2).sum(), 1e-30))


def port_grads(kw, s0, one_hots, monkeypatch):
    """The port's loss dict and gradients of one step on batch 1 from the
    JAX initial state, fed the JAX step's seg one-hots, every train flag
    off (so every gradient is made and kept, nothing steps); then the step
    itself.  Returns (losses, grads by submodel, the model after the
    step)."""
    off = {k: False for k in kw if k.startswith("train_")}
    cfg, model, state = _port({**kw, **off}, s0.params)
    batch = _tb(_batch(1, _n_frames(kw)))
    fed = FedOneHots(one_hots)
    monkeypatch.setattr(extra, "one_hot_from_logits", fed)
    _, losses = extra.make_train_step(cfg, model)(state, batch)
    # a feedback after each step of a rollout, the last one's unused (as
    # in JAX); none in a one-step rollout
    steps = kw["num_pred_step"]
    assert fed.i == len(one_hots) == (steps if steps > 1 else 0)
    grads = {name: {k: p.grad.numpy().copy() for k, p in
                    sub.named_parameters() if p.grad is not None}
             for name, sub in model.named_children()}
    cfg, model, state = _port(kw, s0.params)
    monkeypatch.setattr(extra, "one_hot_from_logits", FedOneHots(one_hots))
    _, losses2 = extra.make_train_step(cfg, model)(state, batch)
    for k in losses:
        assert float(losses2[k]) == float(losses[k]), k
    return losses, grads, model


def check_losses(losses, ref):
    assert list(losses) == list(ref)
    for k in ref:
        assert _rel(losses[k], ref[k]) < 1e-4, k


def check_grads(grads, ref, sub, whole=1e-3):
    """Every gradient of submodel ``sub`` (``ref``: its JAX tree) by the
    whole gradient's rel-L2 (< ``whole``) and each tensor's (< 1e-2)."""
    ours = grads[sub]
    assert sorted(ours) == sorted(ref)
    flat = np.concatenate([ours[k].ravel() for k in ref])
    flat_ref = np.concatenate([ref[k].numpy().ravel() for k in ref])
    assert _rel_l2(flat, flat_ref) < whole
    for k in ref:
        assert _rel_l2(ours[k], ref[k].numpy()) < 1e-2, k


def check_update(model, sub, after_ref, grads_ref, grads, lr=LR,
                 eps=1e-8):
    """The parameters of ``sub`` after the step against the JAX step's
    (``grads_ref``: the JAX gradients, ``grads``: the port's, by the port's
    names)."""
    n_held = n = 0
    for k, p in getattr(model, sub).named_parameters():
        d = np.abs(p.detach().numpy() - after_ref[k].numpy())
        g_ref, g = grads_ref[k].numpy(), grads[k]
        assert d.max() <= 2 * lr, k
        held = (np.abs(g_ref) > 1e3 * eps) & (
            np.abs(g - g_ref) <= 0.1 * np.abs(g_ref))
        assert d[held].max(initial=0) <= 1e-3 * lr, k
        n_held, n = n_held + held.sum(), n + held.size
    assert n_held >= 0.9 * n


@pytest.mark.parametrize("steps", [3, 2])
def test_recipe6_step_matches_jax(steps, monkeypatch):
    """Loss terms, gradients and the Adamax update of one step of the
    rollout over ``steps`` forwards."""
    kw = {**RECIPE6, "num_pred_step": steps}
    s0, s1, ld, grads_j, one_hots = jax_step(tuple(sorted(kw.items())))
    losses, grads, model = port_grads(kw, s0, one_hots, monkeypatch)
    check_losses(losses, ld)
    assert [k for k in losses if k.endswith("_ce_loss")] == [
        f"step_{i + 1}_frame_1_coarse_ce_loss" for i in range(steps)]
    sub = model.coarse_model
    g_ref = from_jax_submodel(sub, grads_j["coarse_model"])
    check_grads(grads, g_ref, "coarse_model")
    check_update(model, "coarse_model", from_jax_submodel(
        sub, _np(s1.params["coarse_model"])), g_ref, grads["coarse_model"])


def test_eval_step_matches_jax():
    """The full rollout's metrics, keys (0-indexed) and values."""
    items = tuple(sorted(RECIPE6.items()))
    cfg_j, model_j, variables, vgg = _jax_init(items)
    state_j = jstate.create_train_state(cfg_j, variables,
                                        frozen={"vgg": vgg})
    batch = _batch(5, _n_frames(RECIPE6))
    ref = _np(jax.jit(jextra.make_eval_step(cfg_j, model_j))(
        state_j, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0)))
    cfg, model, state = _port(RECIPE6, variables["params"])
    out = extra.make_eval_step(cfg, model)(state, _tb(batch))
    assert list(out) == list(ref)
    assert list(out)[:5] == [f"step_0_frame_0_coarse_{m}" for m in
                             ("l1", "psnr", "ssim", "vgg", "iou")]
    assert len(out) == 15
    for k in ref:
        assert _rel(out[k], ref[k]) < 1e-4, k


@pytest.mark.parametrize("kw,exc,match", [
    (dict(mode="xx2x"), ValueError, "xs2xs only"),
    (dict(num_pred_once=2), AssertionError, "num_pred_once=1"),
    (dict(highres_large=True), None, None),
    (dict(remat=True), None, None)])
def test_unsupported_extra_steps_raise(kw, exc, match):
    """EXTRA takes --mode xs2xs only and a multi-step rollout
    --num_pred_once 1, as the JAX steps; --highres_large training and
    --remat are taken: the step builds and runs one step to finite losses
    (tests/test_torch_port_extra_traj.py and test_torch_port_extra_highres.py
    hold them to JAX)."""
    cfg = dataclasses.replace(Config(**RECIPE6), **kw)
    if exc is None:
        cfg = dataclasses.replace(cfg, vgg_weight=0.0)
        model = registry.build_model(cfg, device="cpu")
        state = state_lib.create_train_state(cfg, model, None)
        state, losses = extra.make_train_step(cfg, model)(
            state, _tb(_batch(6, _n_frames(RECIPE6))))
        assert state.step == 1 and np.isfinite(float(losses["loss_all"]))
        return
    model = registry.build_model(dataclasses.replace(cfg, mode="xs2xs",
                                                     highres_large=False),
                                 device="cpu")
    with pytest.raises(exc, match=match):
        extra.make_train_step(cfg, model)
    if kw.get("mode"):
        with pytest.raises(ValueError, match="xs2xs only"):
            jextra.make_train_step(JConfig(**{**RECIPE6, **kw}), None)
        with pytest.raises(exc, match=match):
            extra.make_eval_step(cfg, model)
