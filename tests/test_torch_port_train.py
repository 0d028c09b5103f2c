"""The port's INTER train and eval steps (train/inter.py) against the JAX
package's ``make_train_step`` / ``make_eval_step``: InterNet/HRNet at full
width, 32x64, B=2, f32, on the XLA path the JAX package takes on the CPU.
Both sides start from the same weights (the JAX init mapped with
``from_jax_params``, the frozen VGG19 with ``from_jax_vgg``) and take the
same numpy batch (frames in [-1, 1], uint8 seg ids).

Tolerances, each from the f32 arithmetic of ~45 convolutions plus the
16-conv VGG tower summed in another order:
- loss terms: 1e-4 relative;
- gradients: whole-gradient rel-L2 < 1e-3 and each tensor's < 1e-2 (small
  tensors of near-cancelling sums carry the largest relative error);
- parameters after one Adamax step: Adamax moves each weight by
  lr * m_hat / u, about lr * sign(g) on the first step, so a gradient that
  differs in the last bits moves it by the same amount to ~1e-6 relative;
  where |g| is within rounding noise of 0 the two steps can differ by up
  to 2 * lr.  Bound: 99.9% of the weights within 1e-3 * lr, all within
  2 * lr;
- loss_all over 3 steps: 1e-3 relative (the 2 * lr tail moves the loss by
  less than that at lr 1e-3);
- eval metrics: 1e-4 relative.
"""

import dataclasses

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
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
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

torch.set_num_threads(1)

B, H, W = 2, 32, 64
LR = 1e-3


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


@pytest.fixture(scope="module")
def jax_side():
    """The JAX model, its initial train state and the jitted steps."""
    cfg = _cfg()
    model = jregistry.build_model(cfg)
    b = _batch(0)
    x, seg, _, _ = jcommon.get_inter_inputs(
        {k: jnp.asarray(v) for k, v in b.items()})
    variables = model.init(jax.random.PRNGKey(0), x, seg, train=False)
    vgg = jcommon.init_vgg_frozen(cfg, jax.random.PRNGKey(1))
    state = jstate.create_train_state(cfg, variables, frozen={"vgg": vgg})
    step = jax.jit(jinter.make_train_step(cfg, model, with_grads=True))
    evals = jax.jit(jinter.make_eval_step(cfg, model))
    return cfg, state, step, evals


def _port_state(jstate_, cfg):
    model = registry.build_model(cfg)
    model.coarse_model.load_state_dict(
        from_jax_params(_np(jstate_.params["coarse_model"])))
    vgg = VGG19Features(dtype=torch.float32)
    vgg.load_state_dict(from_jax_vgg(_np(jstate_.frozen["vgg"])))
    return model, state_lib.create_train_state(cfg, model, vgg)


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(((a - b) ** 2).sum() / max((b ** 2).sum(), 1e-30))


def test_one_step_matches_jax(jax_side):
    """Loss dict, gradients and parameters after one Adamax step."""
    cfg, s0, step, _ = jax_side
    batch = _batch(1)
    s1, losses_j, grads_j = step(s0, _jb(batch), jax.random.PRNGKey(2))
    model, state = _port_state(s0, cfg)
    port_step = inter.make_train_step(cfg, model)
    # grads are read before the update: step with the optimizer off first
    # (train_coarse=False leaves .grad in place and the params unchanged)
    off = dataclasses.replace(cfg, train_coarse=False)
    _, losses = inter.make_train_step(off, model)(state, _tb(batch))
    grads = {k: p.grad.numpy().copy()
             for k, p in model.coarse_model.named_parameters()}
    _, losses2 = port_step(state, _tb(batch))

    assert list(losses) == list(losses_j)
    for k in losses_j:
        assert _rel(losses[k], losses_j[k]) < 1e-4, k
        assert float(losses2[k]) == float(losses[k]), k

    grads_ref = from_jax_params(_np(grads_j["coarse_model"]))
    assert sorted(grads) == sorted(grads_ref)
    flat = np.concatenate([grads[k].ravel() for k in grads_ref])
    flat_ref = np.concatenate([grads_ref[k].numpy().ravel()
                               for k in grads_ref])
    assert _rel_l2(flat, flat_ref) < 1e-3
    for k in grads_ref:
        assert _rel_l2(grads[k], grads_ref[k].numpy()) < 1e-2, k

    after_ref = from_jax_params(_np(s1.params["coarse_model"]))
    d = np.concatenate([
        np.abs(p.detach().numpy() - after_ref[k].numpy()).ravel()
        for k, p in model.coarse_model.named_parameters()])
    assert np.quantile(d, 0.999) <= 1e-3 * LR
    assert d.max() <= 2 * LR


def test_three_step_trajectory_matches_jax(jax_side):
    cfg, state_j, step, _ = jax_side
    _, state = _port_state(state_j, cfg)
    port_step = inter.make_train_step(cfg, state.model)
    batch = _batch(3)
    for i in range(3):
        state_j, lj, _ = step(state_j, _jb(batch), jax.random.PRNGKey(i))
        state, lp = port_step(state, _tb(batch))
        assert _rel(lp["loss_all"], lj["loss_all"]) < 1e-3, i
    assert state.step == 3 and int(state_j.step) == 3


def test_frozen_coarse_model_does_not_move(jax_side):
    cfg, s0, _, _ = jax_side
    model, state = _port_state(s0, dataclasses.replace(cfg,
                                                       train_coarse=False))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = inter.make_train_step(dataclasses.replace(cfg, train_coarse=False),
                                 model)
    _, losses = step(state, _tb(_batch(4)))
    assert np.isfinite(float(losses["loss_all"]))
    assert all(p.grad is not None for p in model.parameters())
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


def test_eval_metrics_match_jax(jax_side):
    cfg, s0, _, evals = jax_side
    batch = _batch(5)
    ref = evals(s0, _jb(batch), jax.random.PRNGKey(0))
    model, state = _port_state(s0, cfg)
    out = inter.make_eval_step(cfg, model)(state, _tb(batch))
    assert list(out) == list(ref)
    for k in ref:
        assert _rel(out[k], ref[k]) < 1e-4, k


@pytest.mark.parametrize("kw", [dict(model="InterRefineNet"),
                                dict(remat=True)])
def test_unported_train_options_raise(kw):
    model = registry.build_model(_cfg())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        inter.make_train_step(_cfg(**kw), model)


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_unported_optimizers_raise(name):
    model = registry.build_model(_cfg())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        state_lib.create_train_state(_cfg(coarse_optimizer=name), model)
