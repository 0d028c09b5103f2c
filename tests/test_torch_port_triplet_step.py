"""One INTER train step and one eval step on a vimeo batch (``--mode
xx2x``), the port's against the JAX package's: InterNet/HRNet at full
width, f32, 2x32x288 (288 = 9 x 32 is no power of two times 32 and takes,
like vimeo's 448, the route of a width >= 256: K1's and K2's plain
versions in the stem and layer1), under ``--coarse_o adamax`` (the
default) and ``--coarse_o sgd``.  The JAX batch carries the JAX
``TripletDataset``'s all-zero one-hots, the port's the ``NO_SEG`` ids its
``TripletDataset`` ships.  Both sides start from the same weights (the JAX
init mapped with ``from_jax_params``, the VGG19 with ``from_jax_vgg``).

Tolerances (those of ``tests/test_torch_port_train.py``, the same f32
arithmetic summed in another order):
- loss terms 1e-4 relative; no ``coarse_ce_loss`` in xx2x;
- gradients: whole-gradient rel-L2 < 1e-3, each tensor's < 1e-2;
- parameters after one step: Adamax 99.9% within 1e-3 * lr and all within
  2 * lr (a gradient within rounding noise of 0 moves a weight by up to
  lr either way); SGD moves a weight by lr * g, so the two steps differ by
  lr times the gradients' difference: all within 1e-2 * lr * max|g| plus
  the f32 rounding of the weight (1e-7);
- eval metrics 1e-4 relative, and no ``coarse_iou``.
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
from deep_video_interpolation_extrapolation_tpu_torch.data.cityscapes import (
    NO_SEG,
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

torch.set_num_threads(2)

B, H, W = 2, 32, 288
LR = 1e-3


def _cfg(**kw):
    base = dict(runner="INTER", model="InterNet", syn_type="inter",
                mode="xx2x", coarse_model="HRNet", compute_dtype="float32",
                input_h=H, input_w=W, batch_size=B, dataset="vimeo",
                train_coarse=True, coarse_learning_rate=LR)
    return Config(**{**base, **kw})


def _batches(seed):
    """(port batch, JAX batch): the same frames; NO_SEG ids and zeros."""
    rng = np.random.RandomState(seed)
    frames = {f"frame{i}": rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
              for i in (1, 2, 3)}
    port = {k: torch.from_numpy(v) for k, v in frames.items()}
    port.update({f"seg{i}": torch.full((B, H, W), NO_SEG, dtype=torch.uint8)
                 for i in (1, 2, 3)})
    jx = {k: jnp.asarray(v) for k, v in frames.items()}
    jx.update({f"seg{i}": jnp.zeros((B, H, W, 20), jnp.float32)
               for i in (1, 2, 3)})
    return port, jx


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_init():
    cfg = _cfg()
    model = jregistry.build_model(cfg)
    _, b = _batches(0)
    x, seg, _, _ = jcommon.get_inter_inputs(b)
    variables = model.init(jax.random.PRNGKey(0), x, seg, train=False)
    vgg = jcommon.init_vgg_frozen(cfg, jax.random.PRNGKey(1))
    return model, variables, vgg


def _jax_side(jax_init, cfg):
    model, variables, vgg = jax_init
    state = jstate.create_train_state(cfg, variables, frozen={"vgg": vgg})
    return state, jax.jit(jinter.make_train_step(cfg, model, with_grads=True))


def _port_state(jstate_, cfg):
    model = registry.build_model(cfg, device="cpu")
    model.coarse_model.load_state_dict(
        from_jax_params(_np(jstate_.params["coarse_model"])))
    vgg = VGG19Features(dtype=torch.float32)
    vgg.load_state_dict(from_jax_vgg(_np(jstate_.frozen["vgg"])))
    return model, state_lib.create_train_state(cfg, model, vgg)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(((a - b) ** 2).sum() / max((b ** 2).sum(), 1e-30))


@pytest.mark.parametrize("opt", ["adamax", "sgd"])
def test_vimeo_step_matches_jax(jax_init, opt):
    cfg = _cfg(coarse_optimizer=opt)
    s0, step = _jax_side(jax_init, cfg)
    port_batch, jbatch = _batches(1)
    s1, losses_j, grads_j = step(s0, jbatch, jax.random.PRNGKey(2))
    model, state = _port_state(s0, cfg)
    # grads are read before the update: the step with the optimizer off
    # leaves .grad in place and the params unchanged
    off = dataclasses.replace(cfg, train_coarse=False)
    _, losses = inter.make_train_step(off, model)(state, port_batch)
    grads = {k: p.grad.numpy().copy()
             for k, p in model.coarse_model.named_parameters()}
    _, losses2 = inter.make_train_step(cfg, model)(state, port_batch)
    assert type(state.optimizers["coarse_model"]).__name__.lower() == opt

    assert list(losses) == list(losses_j)
    assert "coarse_ce_loss" not in losses
    for k in losses_j:
        assert _rel(losses[k], losses_j[k]) < 1e-4, k
        assert float(losses2[k]) == float(losses[k]), k

    grads_ref = {k: v.numpy() for k, v in from_jax_params(
        _np(grads_j["coarse_model"])).items()}
    assert sorted(grads) == sorted(grads_ref)
    flat = np.concatenate([grads[k].ravel() for k in grads_ref])
    flat_ref = np.concatenate([grads_ref[k].ravel() for k in grads_ref])
    assert _rel_l2(flat, flat_ref) < 1e-3
    for k in grads_ref:
        assert _rel_l2(grads[k], grads_ref[k]) < 1e-2, k

    after_ref = from_jax_params(_np(s1.params["coarse_model"]))
    d = np.concatenate([
        np.abs(p.detach().numpy() - after_ref[k].numpy()).ravel()
        for k, p in model.coarse_model.named_parameters()])
    if opt == "adamax":
        assert np.quantile(d, 0.999) <= 1e-3 * LR
        assert d.max() <= 2 * LR
    else:
        tol = 1e-2 * LR * np.abs(flat_ref).max() + 1e-7
        assert d.max() <= tol
        before = from_jax_params(_np(s0.params["coarse_model"]))
        for k, p in model.coarse_model.named_parameters():
            np.testing.assert_allclose(
                p.detach().numpy() - before[k].numpy(), -LR * grads_ref[k],
                rtol=0, atol=tol, err_msg=k)


def test_vimeo_eval_matches_jax(jax_init):
    cfg = _cfg()
    s0, _ = _jax_side(jax_init, cfg)
    model_j = jax_init[0]
    port_batch, jbatch = _batches(5)
    ref = jax.jit(jinter.make_eval_step(cfg, model_j))(
        s0, jbatch, jax.random.PRNGKey(0))
    model, state = _port_state(s0, cfg)
    out = inter.make_eval_step(cfg, model)(state, port_batch)
    assert list(out) == list(ref)
    assert "coarse_iou" not in out
    for k in ref:
        assert _rel(out[k], ref[k]) < 1e-4, k
