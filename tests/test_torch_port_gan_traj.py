"""Recipe 4's step (``train/inter_gan.py``: InterGANNet on VAEHRNet, the
FrameSN, VideoSN, FrameSNDet and VideoLSSNDet families) over three train
steps against the JAX package's, and the port's ``--remat`` step against
its own step without it; at B=2 32x64 f32, ``--n_track 2``, with the
configuration, method and tolerances of tests/test_torch_port_gan_step.py:
both sides start from the JAX init with its batch statistics and
spectral-norm vectors, the JAX step's random draws (the VAE's eps, the
sync_neg boxes) are recovered inside its trace for each step and handed to
the port.

Held on the first step: every loss term (1e-4 relative), each submodel's
gradient (rel-L2 < 1e-3), the Adamax and Adam updates (a first step moves
a weight by lr * g / (|g| + eps), eps = 1e-8: every weight within 2 lr;
the coarse model's, as tests/test_torch_port_gan_step.py holds them,
under 1 in 1000 more than lr / 100 from JAX's, where |g| is rounding noise
and the two sides move a weight in opposite directions; the
discriminators' under 1 in 100: their gradients sit at Adam's eps (median
|g| 1e-8 to 7e-7 at 32x64, disc weights 0.001 and 0.01), where the update
itself follows g / eps, and under --highres_large 0.32% of the video_det
family's weights move more than lr / 100 apart) and every BatchNorm
statistic and
spectral-norm u and sigma after it (1e-4 * max(1, max|ref|)): the SN
discriminators are
compared after a step that has updated their statistics, as the JAX
port_frame_sn_disc's sigma of 1.0 asks.  Then loss_all of steps 2 and 3
within 1e-2 relative: from the second step the two sides' weights differ
by those first-step flips (the largest gap measured, step 3 under
--highres_large: 666.08 against JAX's 668.69, 3.9e-3).
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_gan_step import B, RECIPE4, _batch, _lrs, _rel_l2
from deep_video_interpolation_extrapolation_tpu.core.config import (
    Config as JConfig,
)
from deep_video_interpolation_extrapolation_tpu.models import detdisc as jdet
from deep_video_interpolation_extrapolation_tpu.models import hrnet as jhrnet
from deep_video_interpolation_extrapolation_tpu.train import (
    inter_gan as jgan,
    state as jstate,
)
from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
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

torch.set_num_threads(2)

STEPS = 3
TRAJ_TOL = 1e-2


@functools.lru_cache(maxsize=None)
def jax_steps(items):
    """The JAX init and three JAX steps on batch 1 from one jit: (init
    variables, state after step 1, each step's losses, step 1's gradients,
    each step's eps, each step's swapped sync_neg boxes)."""
    cfg = JConfig(**dict(items))
    variables = jgan.init_variables(
        cfg, jax.random.PRNGKey(0),
        {k: jnp.asarray(v) for k, v in _batch(0).items()})
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
        run = jax.jit(run)
        batch = {k: jnp.asarray(v) for k, v in _batch(1).items()}
        losses, eps, swapped = [], [], []
        for i in range(STEPS):
            state, ld, grads = jax.block_until_ready(
                run(state, batch, jax.random.PRNGKey(5 + i)))
            jax.effects_barrier()
            losses.append(jax.tree_util.tree_map(np.asarray, ld))
            e = (seen["z"].reshape(B, -1) - seen["mu"]) / np.exp(
                0.5 * seen["logvar"])
            eps.append(e.astype(np.float32))
            swapped.append(np.asarray(seen["swapped"]))
            if i == 0:
                s1, g1 = state, grads
    finally:
        jgan.state_lib.apply_updates = orig_apply
        jdet._sync_neg_boxes = orig_sync
    return variables, s1, losses, g1, eps, swapped


def port_steps(kw, variables, monkeypatch, draws=None, n=STEPS,
               generator=None):
    """``n`` port steps on batch 1 from ``variables``; with ``draws`` (each
    step's eps and swapped boxes) the port takes those, else it draws from
    ``generator``.  Returns (model, weights before, each step's losses)."""
    cfg = Config(**kw)
    model = registry.build_model(cfg, device="cpu")
    load_jax_params(model, variables["params"], variables["batch_stats"])
    state = state_lib.create_train_state(cfg, model)
    at = {"i": 0}
    if draws is not None:
        eps, swapped = draws
        coarse = model.coarse_model
        fwd = type(coarse).forward
        monkeypatch.setattr(coarse, "forward", lambda *a, **k: fwd(
            coarse, *a, **{**k, "noise": torch.from_numpy(eps[at["i"]])}))
        monkeypatch.setattr(detdisc, "_sync_neg_boxes", lambda mid, gen=None:
                            torch.from_numpy(swapped[at["i"]]))
    before = {name: {k: p.detach().clone() for k, p in sub.named_parameters()}
              for name, sub in model.named_children()}
    step = inter_gan.make_train_step(cfg, model,
                                     generator or torch.Generator())
    batch = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    losses = []
    for i in range(n):
        at["i"] = i
        state, ld = step(state, batch)
        losses.append(ld)
        if i == 0:
            grads = {name: {k: p.grad.clone()
                            for k, p in sub.named_parameters()}
                     for name, sub in model.named_children()}
            after = {name: {k: t.clone() for k, t in sub.state_dict().items()}
                     for name, sub in model.named_children()}
    return model, before, grads, after, losses


def check_first_step(model, before, grads, after, ld, s1, ref_ld, g_ref,
                     bs0):
    """The first port step against the JAX one (see the module
    docstring)."""
    assert list(ld) == list(ref_ld)
    for k, v in ld.items():
        r = float(ref_ld[k])
        assert abs(float(v) - r) <= 1e-4 * abs(r) + 1e-7, (k, float(v), r)
    lrs = _lrs(model)
    for name, sub in model.named_children():
        want_g = from_jax_submodel(sub, g_ref[name], bs0.get(name))
        params = [k for k, _ in sub.named_parameters()]
        got = np.concatenate([grads[name][k].flatten().numpy()
                              for k in params])
        ref = np.concatenate([want_g[k].flatten().numpy() for k in params])
        assert _rel_l2(got, ref) < 1e-3, name
        want = from_jax_submodel(sub, s1.params[name],
                                 s1.batch_stats.get(name))
        lr = lrs[name]
        d = np.concatenate([np.abs(after[name][k].numpy()
                                   - want[k].numpy()).ravel()
                            for k in params])
        assert d.max() <= 2 * lr + 1e-7, name
        assert (d > lr / 100).mean() < (1e-3 if name == "coarse_model"
                                        else 1e-2), name
        n = 0
        for k, t in after[name].items():
            if k in params:
                continue
            r = want[k].numpy()
            assert np.abs(t.numpy() - r).max() <= 1e-4 * max(
                1.0, np.abs(r).max()), (name, k)
            n += 1
        assert n > 0, name


def held_over_steps(kw, monkeypatch):
    """The first port step held to the JAX one, then loss_all of each of
    three steps.  Returns the JAX loss_all of each step."""
    variables, s1, lds, g1, eps, swapped = jax_steps(
        tuple(sorted(kw.items())))
    model, before, grads, after, losses = port_steps(
        kw, variables, monkeypatch, (eps, swapped))
    check_first_step(model, before, grads, after, losses[0], s1, lds[0], g1,
                     variables["batch_stats"])
    for i, (lp, lj) in enumerate(zip(losses, lds)):
        rel = abs(float(lp["loss_all"]) - float(lj["loss_all"])) / abs(
            float(lj["loss_all"]))
        assert rel < TRAJ_TOL, (i, float(lp["loss_all"]),
                                float(lj["loss_all"]))
    traj = [float(lj["loss_all"]) for lj in lds]
    print(f"loss_all over {STEPS} steps: JAX {traj}, port "
          f"{[float(lp['loss_all']) for lp in losses]}")
    return traj


def test_recipe4_three_steps_match_jax(monkeypatch):
    """Recipe 4 over three train steps: the first step whole, then loss_all
    of each; JAX's loss jumps after the first step as the port's does."""
    traj = held_over_steps(RECIPE4, monkeypatch)
    assert traj[1] > 2 * traj[0], traj


def _state_of(model):
    return {k: t.clone() for k, t in model.state_dict().items()}


def test_remat_step_equals_the_step_without_it(monkeypatch):
    """Two port steps under --remat against two without it from the same
    JAX init, each drawing eps and the sync_neg offsets from a generator
    seeded alike: the families' recompute restores the generator, so the
    sync_neg pass draws the same offsets, and restores the spectral-norm
    vectors and BatchNorm statistics, so they move once a step; losses and
    parameters within 1e-6 relative, every buffer (BN statistics, SN u and
    sigma) equal."""
    variables = jax_steps(tuple(sorted(RECIPE4.items())))[0]
    drawn = []
    orig = detdisc._sync_neg_boxes

    def spy(mid, gen=None):
        out = orig(mid, gen)
        drawn.append(out.clone())
        return out
    monkeypatch.setattr(detdisc, "_sync_neg_boxes", spy)
    runs = []
    for remat in (False, True):
        drawn.clear()
        model, _, _, _, losses = port_steps(
            {**RECIPE4, "remat": remat}, variables, monkeypatch, n=2,
            generator=torch.Generator().manual_seed(7))
        runs.append((losses, _state_of(model), list(drawn)))
    (la, sa, da), (lb, sb, db) = runs
    # the sync_neg pass draws once a step, and again in each recompute
    assert len(da) == 2 and len(db) == 4
    assert all(torch.equal(a, b) for a, b in zip(da, db[::2]))
    assert all(torch.equal(a, b) for a, b in zip(db[::2], db[1::2]))
    for a, b in zip(la, lb):
        assert list(a) == list(b)
        for k in a:
            assert abs(float(b[k]) - float(a[k])) <= 1e-6 * max(
                abs(float(a[k])), 1e-12), k
    params = {k for k, _ in registry.build_model(
        Config(**RECIPE4), device="cpu").named_parameters()}
    assert sa.keys() == sb.keys()
    for k in sa:
        if k in params:
            d = (sb[k] - sa[k]).abs().max().item()
            assert d <= 1e-6 * max(1.0, sa[k].abs().max().item()), k
        else:
            assert torch.equal(sb[k], sa[k]), k


@pytest.mark.parametrize("remat", [False, True])
def test_sn_vectors_move_once_a_step(monkeypatch, remat):
    """Each spectral-norm u moves by exactly the step's passes: with and
    without --remat, one step leaves every SN vector and BN statistic as
    the passes of the step move them once (the --remat step's recompute
    starts from the vectors the first pass saw and puts back what it
    left), so the two steps' buffers are equal, and each u of more than
    one output channel differs from its init (a 1-channel u stays +-1)."""
    variables = jax_steps(tuple(sorted(RECIPE4.items())))[0]
    model, _, _, _, _ = port_steps(
        {**RECIPE4, "remat": remat}, variables, monkeypatch, n=1,
        generator=torch.Generator().manual_seed(7))
    ref, _, _, _, _ = port_steps(
        RECIPE4, variables, monkeypatch, n=1,
        generator=torch.Generator().manual_seed(7))
    us = [(k, t) for k, t in model.state_dict().items()
          if k.endswith(".u") and t.numel() > 1]
    assert us
    init = registry.build_model(Config(**RECIPE4), device="cpu")
    load_jax_params(init, variables["params"], variables["batch_stats"])
    init_sd, ref_sd = init.state_dict(), ref.state_dict()
    for k, u in us:
        assert torch.equal(u, ref_sd[k]), k
        assert not torch.equal(u, init_sd[k]), k
