"""Recipe 6's step (``train/extra.py``: ExtraNet, back-propagation through
a rollout of three forwards) over three train steps against the JAX
package's, and under ``--remat``; at B=2 32x64 f32, with the method,
helpers and tolerances of tests/test_torch_port_extra_step.py: the port is
fed the JAX step's seg one-hots of each step (after checking its own
argmax agrees but at near-ties), loss terms within 1e-4 relative, the
gradient by rel-L2 < 1e-3 whole and < 1e-2 per tensor, the Adamax update
as there, and loss_all over 3 steps within 5e-3 relative.

The loss of these seeded inits jumps after the first step (to ~1.5e3 times
its first value at 32x64): a first Adamax step moves every weight by about
lr * sign(g), and where |g| lies within the gradients' rounding noise of
0 (5e-4 of a tensor's largest |g| in the stem after three forwards' BPTT,
tests/test_torch_port_extra_step.py) the two sides move it by lr in
opposite directions.  INTER's 3-step test holds 1e-3; here those weights
move the second step's loss by 1.02e-3 of its value (1020981.9 against
JAX's 1019942.7), so the trajectory is held at 5e-3, and the first step,
where no update has acted yet, at 1e-4 per term.  The test holds the port
to JAX's jump, step by step.

From the second step on, the two sides' weights differ by that noise, and
their seg logits by up to ~1e-3 (35 pixels of the 2x32x64 batch took
another argmax under --remat, top two logits 3e-5 to 1.3e-3 apart): the
port is fed the JAX step's one-hots there without the near-tie check,
so both sides take the same discrete choices.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_extra_step import (
    RECIPE6,
    FedOneHots,
    _batch,
    _jax_init,
    _n_frames,
    _np,
    _port,
    _recording_one_hots,
    _rel,
    _tb,
    check_grads,
    check_losses,
    check_update,
    port_grads,
)
from deep_video_interpolation_extrapolation_tpu.train import (
    extra as jextra,
    state as jstate,
)
from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    from_jax_submodel,
)
from deep_video_interpolation_extrapolation_tpu_torch.train import (
    extra,
    state as state_lib,
)

STEPS = 3
TRAJ_TOL = 5e-3


@functools.lru_cache(maxsize=None)
def jax_steps(items):
    """Three JAX steps on batch 1 from one jit: (state before, state after
    step 1, each step's losses, step 1's gradients, each step's seg
    one-hots)."""
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
        run = jax.jit(run)
        batch = {k: jnp.asarray(v)
                 for k, v in _batch(1, _n_frames(dict(items))).items()}
        s0, losses, one_hots = state, [], []
        for i in range(STEPS):
            state, ld, grads = jax.block_until_ready(
                run(state, batch, jax.random.PRNGKey(2 + i)))
            jax.effects_barrier()
            losses.append(_np(ld))
            one_hots.append([seen["oh"][k] for k in range(len(seen["oh"]))])
            if i == 0:
                s1, g1 = state, _np(grads)
    finally:
        jextra.state_lib.apply_updates = orig
        jextra._one_hot_from_logits = orig_oh
    return s0, s1, losses, g1, one_hots


class Fed:
    """``extra.one_hot_from_logits`` fed the JAX step's one-hots, in
    order, unchecked (the steps after the first)."""

    def __init__(self, one_hots):
        self.one_hots, self.i = one_hots, 0

    def __call__(self, seg_logits):
        self.i += 1
        return torch.tensor(self.one_hots[self.i - 1], dtype=seg_logits.dtype)


def held_over_steps(kw, monkeypatch, whole=None):
    """One port step against the JAX one (loss terms; each trained
    submodel's gradient, by rel-L2 < ``whole[sub]`` whole, default 1e-3,
    and its update), then three port steps' loss_all against JAX's, each
    fed that step's JAX one-hots.  Returns the JAX loss_all of each
    step."""
    whole = whole or {}
    s0, s1, lds, grads_j, one_hots = jax_steps(tuple(sorted(kw.items())))
    losses, grads, model = port_grads(kw, s0, one_hots[0], monkeypatch)
    check_losses(losses, lds[0])
    for sub, _ in model.named_children():
        if not kw.get("train_" + sub[:-len("_model")]):
            continue
        child = getattr(model, sub)
        g_ref = from_jax_submodel(child, grads_j[sub])
        check_grads(grads, g_ref, sub, whole.get(sub, 1e-3))
        check_update(model, sub, from_jax_submodel(
            child, _np(s1.params[sub])), g_ref, grads[sub],
            lr=kw.get(f"{sub[:-len('_model')]}_learning_rate", 1e-3))
    cfg, model, state = _port(kw, s0.params)
    step = extra.make_train_step(cfg, model)
    batch = _tb(_batch(1, _n_frames(kw)))
    for i in range(STEPS):
        monkeypatch.setattr(extra, "one_hot_from_logits",
                            (FedOneHots if i == 0 else Fed)(one_hots[i]))
        state, lp = step(state, batch)
        assert _rel(lp["loss_all"], lds[i]["loss_all"]) < TRAJ_TOL, i
        print(f"step {i + 1}: loss_all JAX {float(lds[i]['loss_all'])}, "
              f"port {float(lp['loss_all'])}")
    return [float(ld["loss_all"]) for ld in lds]


def test_recipe6_three_steps_match_jax(monkeypatch):
    """Recipe 6 over three train steps: the first step whole, then loss_all
    of each; and JAX's loss jumps after the first step as the port's
    does."""
    traj = held_over_steps(RECIPE6, monkeypatch)
    assert traj[1] > 10 * traj[0], traj


def test_recipe6_remat_step_matches_jax(monkeypatch):
    """The --remat step (ExtraNet's HRNet checkpointing its stages, each
    loss bundle a checkpoint region) against the JAX --remat step."""
    held_over_steps({**RECIPE6, "remat": True}, monkeypatch)


INPAINT_MASK = dict(model="ExtraInpaintNet", inpaint=True, inpaint_mask=True,
                    train_inpaint=True, inpaint_learning_rate=1e-3)


@pytest.mark.parametrize("kw", [{}, INPAINT_MASK],
                         ids=["ExtraNet", "ExtraInpaintNet"])
def test_remat_step_equals_the_step_without_it(kw):
    """Two port steps of recipe 6 under --remat against two without it
    from the same seeded weights: ExtraNet through its HRNet's stage
    checkpoints, ExtraInpaintNet through one whole-forward checkpoint a
    rollout forward (``remat_internal`` is false with inpainting); losses
    and parameters within 1e-6 relative, every buffer equal."""
    batch = _tb(_batch(1, _n_frames(RECIPE6)))
    runs = []
    for remat in (False, True):
        cfg = Config(**{**RECIPE6, **kw, "remat": remat, "vgg_weight": 0.0})
        model = registry.build_model(cfg, device="cpu", seed=0)
        state = state_lib.create_train_state(cfg, model, None)
        step = extra.make_train_step(cfg, model)
        runs.append(([step(state, batch)[1] for _ in range(2)], model))
    (la, ma), (lb, mb) = runs
    for a, b in zip(la, lb):
        assert list(a) == list(b)
        for k in a:
            assert _rel(b[k], a[k]) <= 1e-6, k
    for (k, pa), (_, pb) in zip(ma.named_parameters(), mb.named_parameters()):
        d = (pb - pa).abs().max().item()
        assert d <= 1e-6 * max(1.0, pa.abs().max().item()), k
    for (k, ba), (_, bb) in zip(ma.named_buffers(), mb.named_buffers()):
        assert torch.equal(ba, bb), k

