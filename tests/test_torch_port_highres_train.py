"""Recipe 1 (the INTER step of ``train/inter.py``) with ``--highres_large``
and with ``--remat`` on the port against the JAX package, InterNet/HRNet at
full width, B=2 32x64 f32, frozen VGG19, on the XLA path the JAX package
takes on the CPU (its 4-part head there is the unfused one on the concat,
the same function in f32).

Both sides start from the JAX init (``from_jax_params``) and take the same
numpy batch; the JAX step runs three times from one jit.  Tolerances, those
of tests/test_torch_port_train.py for the same arithmetic: loss terms 1e-4
relative; the whole gradient by rel-L2 < 1e-3, each tensor's < 1e-2; the
parameters after one Adamax step 99.9% within 1e-3 * lr, all within 2 *
lr; loss_all over 3 steps 1e-3 relative.  The port's step under
``--remat`` against its own step without it: the stage checkpoints
recompute the same f32 arithmetic in the same order, so the losses and
parameters after each of 3 steps agree to 1e-6 relative and every buffer
is equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.core.config import Config
from deep_video_interpolation_extrapolation_tpu.models import registry as jregistry
from deep_video_interpolation_extrapolation_tpu.train import (
    common as jcommon,
    inter as jinter,
    state as jstate,
)
from deep_video_interpolation_extrapolation_tpu_torch.models import (
    hrnet,
    registry,
)
from deep_video_interpolation_extrapolation_tpu_torch.models.features import (
    VGG19Features,
)
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    from_jax_params,
    from_jax_vgg,
)
from deep_video_interpolation_extrapolation_tpu_torch.train import (
    inter,
    state as state_lib,
)

torch.set_num_threads(2)

B, H, W = 2, 32, 64
LR = 1e-3
STEPS = 3


def _cfg(**kw):
    base = dict(runner="INTER", model="InterNet", syn_type="inter",
                mode="xs2xs", coarse_model="HRNet", compute_dtype="float32",
                input_h=H, input_w=W, batch_size=B, dataset="synthetic",
                train_coarse=True, coarse_learning_rate=LR)
    return Config(**{**base, **kw})


def _batch(seed):
    rng = np.random.RandomState(seed)
    batch = {f"frame{i}": rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
             for i in (1, 2, 3)}
    batch.update({f"seg{i}": rng.randint(0, 20, (B, H, W)).astype(np.uint8)
                  for i in (1, 2, 3)})
    return batch


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def jax_run(items):
    """The JAX model's init state and three steps on batch 1 from one jit:
    (state before, state after step 1, losses of each step, step 1's
    gradient)."""
    cfg = _cfg(**dict(items))
    model = jregistry.build_model(cfg)
    x, seg, _, _ = jcommon.get_inter_inputs(
        {k: jnp.asarray(v) for k, v in _batch(0).items()})
    variables = model.init(jax.random.PRNGKey(0), x, seg, train=False)
    vgg = jcommon.init_vgg_frozen(cfg, jax.random.PRNGKey(1))
    s0 = jstate.create_train_state(cfg, variables, frozen={"vgg": vgg})
    step = jax.jit(jinter.make_train_step(cfg, model, with_grads=True))
    batch = {k: jnp.asarray(v) for k, v in _batch(1).items()}
    state, losses, s1, g1 = s0, [], None, None
    for i in range(STEPS):
        state, ld, grads = step(state, batch, jax.random.PRNGKey(2 + i))
        losses.append(_np(ld))
        if i == 0:
            s1, g1 = state, _np(grads["coarse_model"])
    return s0, s1, losses, g1


def _port(s0, cfg):
    model = registry.build_model(cfg, device="cpu")
    model.coarse_model.load_state_dict(
        from_jax_params(_np(s0.params["coarse_model"])))
    vgg = VGG19Features(dtype=torch.float32)
    vgg.load_state_dict(from_jax_vgg(_np(s0.frozen["vgg"])))
    return model, state_lib.create_train_state(cfg, model, vgg)


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(((a - b) ** 2).sum() / max((b ** 2).sum(), 1e-30))


def _held_to_jax(kw):
    """One port step against the JAX step (losses, gradient, Adamax
    update), then three steps' loss_all."""
    items = tuple(sorted(kw.items()))
    s0, s1, losses_j, grads_j = jax_run(items)
    cfg = _cfg(**kw)
    model, state = _port(s0, cfg)
    off = dataclasses.replace(cfg, train_coarse=False)
    batch = _tb(_batch(1))
    _, losses = inter.make_train_step(off, model)(state, batch)
    grads = {k: p.grad.numpy().copy()
             for k, p in model.coarse_model.named_parameters()}
    assert list(losses) == list(losses_j[0])
    for k in losses_j[0]:
        assert _rel(losses[k], losses_j[0][k]) < 1e-4, k
    ref = from_jax_params(grads_j)
    assert sorted(grads) == sorted(ref)
    flat = np.concatenate([grads[k].ravel() for k in ref])
    flat_ref = np.concatenate([ref[k].numpy().ravel() for k in ref])
    assert _rel_l2(flat, flat_ref) < 1e-3
    for k in ref:
        assert _rel_l2(grads[k], ref[k].numpy()) < 1e-2, k

    step = inter.make_train_step(cfg, model)
    for i in range(STEPS):
        state, lp = step(state, batch)
        assert _rel(lp["loss_all"], losses_j[i]["loss_all"]) < 1e-3, i
        if i == 0:
            after = from_jax_params(_np(s1.params["coarse_model"]))
            d = np.concatenate([
                np.abs(p.detach().numpy() - after[k].numpy()).ravel()
                for k, p in model.coarse_model.named_parameters()])
            assert np.quantile(d, 0.999) <= 1e-3 * LR
            assert d.max() <= 2 * LR
    assert state.step == 1 + STEPS     # the gradient-only step, then 3
    return [float(v["loss_all"]) for v in losses_j]


def test_highres_step_matches_jax():
    """The --highres_large INTER step (stage 4 on the train chain's route
    for each branch, the 4-part head with its explicit backward): one step
    and its update, then 3 steps' loss_all."""
    _held_to_jax(dict(highres_large=True))


def test_remat_step_matches_jax():
    """The --remat INTER step (the HRNet's stage checkpoints and the
    checkpointed loss bundle) against the JAX --remat step."""
    _held_to_jax(dict(remat=True))


@pytest.mark.parametrize("kw", [dict(), dict(highres_large=True)],
                         ids=["highres_large=0", "highres_large=1"])
def test_remat_step_equals_the_step_without_it(kw):
    """Three port steps under --remat against three without it from the
    same seeded weights: losses and parameters within 1e-6 relative, every
    buffer equal."""
    batch = _tb(_batch(1))
    runs = []
    for remat in (False, True):
        cfg = _cfg(**kw, remat=remat, vgg_weight=0.0)
        model = registry.build_model(cfg, device="cpu", seed=0)
        assert model.coarse_model.remat == remat
        state = state_lib.create_train_state(cfg, model, None)
        step = inter.make_train_step(cfg, model)
        losses = [step(state, batch)[1] for _ in range(STEPS)]
        runs.append((losses, model))
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


def test_remat_checkpoints_the_jax_regions(monkeypatch):
    """Under --remat the HRNet's forward with grad runs stem + layer1, each
    transition and each stage module as checkpoint regions (JAX
    ``_HRBackbone.remat``: 1 + 3 + 3 with stage 4), and none without grad;
    the InterNet step adds no whole-forward region (``remat_internal``),
    and the loss bundle is one."""
    from deep_video_interpolation_extrapolation_tpu_torch.core import remat
    seen = []
    orig = remat._checkpoint

    def spy(fn, *args, **kw):
        seen.append(fn)
        return orig(fn, *args, **kw)
    monkeypatch.setattr(remat, "_checkpoint", spy)
    cfg = _cfg(highres_large=True, remat=True, vgg_weight=0.0)
    assert registry.remat_internal(cfg)
    model = registry.build_model(cfg, device="cpu")
    batch = _tb(_batch(1))
    with torch.no_grad():
        model(*inter.get_inter_inputs(batch)[:2])
    assert seen == []
    state = state_lib.create_train_state(cfg, model, None)
    inter.make_train_step(cfg, model)(state, batch)
    assert len(seen) == 1 + 3 + 3 + 1


@pytest.mark.parametrize("cfg,expected", [
    (dict(model="InterNet"), True),
    (dict(model="ExtraNet", syn_type="extra"), True),
    (dict(model="ExtraInpaintNet", syn_type="extra", inpaint=True), False),
    (dict(model="InterRefineNet"), False),
    (dict(model="InterGANNet", coarse_model="VAEHRNet"), False),
    (dict(model="InterNet", remat=False), False)])
def test_remat_internal_matches_jax(cfg, expected):
    """``registry.remat_internal`` field for field with the JAX one."""
    c = Config(**{"remat": True, **cfg})
    assert registry.remat_internal(c) == jregistry.remat_internal(c) \
        == expected


@pytest.mark.parametrize("mode,routes", [
    ("b0", (True, False, False, False)), ("all", (True, True, False, False)),
    ("rest", (False, True, False, False)), ("0", (False,) * 4)])
def test_stage4_chain_routes_at_the_recipe_shape(mode, routes):
    """Stage 4's branches at the 24x128x128 recipe (128, 64, 32 and 16
    px square at 64, 128, 256 and 512 channels) under each DVIE_BBCHAIN
    mode: ``b0`` adds one C = 64 chain call (branch 0); branch 2 never fits
    the 40 MiB budget and branch 3 (C = 512: 151 MB of chain weights)
    never does, so both run block by block; no new chain width."""
    got = tuple(hrnet.bb_chain_route(24, 128 >> i, 128 >> i, 2, 4, c, mode)
                for i, c in enumerate((64, 128, 256, 512)))
    assert got == routes
