"""Recipe 2 (docs/RECIPES.md:17-26), ported: InterRefineNet, the HRNet
coarse frozen, ``SRNRefine --n_sc 3 --train_refine``.  The port's train
and eval steps (train/inter.py) against the JAX package's
``make_train_step`` / ``make_eval_step``, at full width, 32x64, B=2, f32,
on the XLA path the JAX package takes on the CPU; both start from the JAX
init (``load_jax_params``, the frozen VGG19 by ``from_jax_vgg``) and take
the same numpy batch.  Also ``--with_gt_seg``, the step with every
submodel frozen, and the VAE coarse the refine composites refuse (the
CLI's default refiner: test_torch_port_refineunet_train.py).

At 32x64 the 1/4 scale is 8x16, below the frozen VGG19's 16 pixels (its
fourth 2x2 pool leaves none): the JAX step's VGG term is NaN there too.
So the steps at ``--n_sc 3`` run without the frozen VGG (the term is zero
on both sides); the one-scale steps (test_torch_port_refineunet_train.py)
and the eval steps, all at full size, run with it.

Tolerances, the rules of tests/test_torch_port_train.py: loss terms 1e-4
relative; the trained submodel's whole gradient rel-L2 < 1e-3; its
parameters after one Adamax step all within 2 * lr of JAX's, and within
1e-3 * lr wherever the JAX gradient g exceeds 1e-5 and the port's is
within |g| / 10 of it (the first step is lr * g / (|g| + 1e-8), whose
slope 1e-8 / g**2 times that difference is at most 1e-4 there), which must
hold for >= 99% of the entries whose JAX gradient exceeds 1e-5.  The
others of those are near-zero gradients whose sign the f32 summation
order can flip: about 0.5% of a refiner's (more than of HRNet's, whose
test bounds the 99.9% quantile).
Eval metrics 1e-4 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.core.config import Config as JConfig
from deep_video_interpolation_extrapolation_tpu.models import registry as jregistry
from deep_video_interpolation_extrapolation_tpu.train import (
    common as jcommon,
    inter as jinter,
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
    inter,
    state as state_lib,
)

torch.set_num_threads(2)

B, H, W = 2, 32, 64
LR = 1e-3
RECIPE2 = dict(runner="INTER", model="InterRefineNet", syn_type="inter",
               mode="xs2xs", coarse_model="HRNet", refine=True,
               refine_model="SRNRefine", n_scales=3, train_refine=True,
               compute_dtype="float32", input_h=H, input_w=W, batch_size=B,
               dataset="synthetic", refine_learning_rate=LR)


def batch_of(seed):
    rng = np.random.RandomState(seed)
    batch = {f"frame{i}": rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
             for i in (1, 2, 3)}
    batch.update({f"seg{i}": rng.randint(0, 20, (B, H, W)).astype(np.uint8)
                  for i in (1, 2, 3)})
    return batch


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(((a - b) ** 2).sum() / max((b ** 2).sum(), 1e-30))


def jax_side(kw):
    """The JAX model's initial train states, without and with the frozen
    VGG19, and its jitted steps."""
    cfg = JConfig(**kw)
    model = jregistry.build_model(cfg)
    x, seg, _, _ = jcommon.get_inter_inputs(jb(batch_of(0)))
    variables = jax.jit(lambda x, seg: model.init(
        jax.random.PRNGKey(0), x, seg, train=False))(x, seg)
    vgg = jcommon.init_vgg_frozen(cfg, jax.random.PRNGKey(1))
    states = [jstate.create_train_state(cfg, variables, frozen=frozen)
              for frozen in ({}, {"vgg": vgg})]
    step = jax.jit(jinter.make_train_step(cfg, model, with_grads=True))
    evals = jax.jit(jinter.make_eval_step(cfg, model))
    return states, step, evals


def port_side(kw, jstate_):
    cfg = Config(**kw)
    model = registry.build_model(cfg, device="cpu")
    # V1 at one scale has attn_fuse_layer, which the JAX tree does not
    assert all(k.startswith("stage3_model.attn_fuse_layer.")
               for k in load_jax_params(model, _np(jstate_.params)))
    vgg = None
    if jstate_.frozen:
        vgg = VGG19Features(dtype=torch.float32)
        vgg.load_state_dict(from_jax_vgg(_np(jstate_.frozen["vgg"])))
    return cfg, model, state_lib.create_train_state(cfg, model, vgg)


def check_one_step(kw, jax_state, step, trained, seed=1):
    """One step of both sides on one batch: the loss dict (keys in the JAX
    order), the ``trained`` submodel's gradient and its parameters after
    the update; every other submodel frozen, without gradients, unmoved."""
    batch = batch_of(seed)
    s1, losses_j, grads_j = step(jax_state, jb(batch), jax.random.PRNGKey(2))
    cfg, model, state = port_side(kw, jax_state)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, losses = inter.make_train_step(cfg, model)(state, tb(batch))

    assert list(losses) == list(losses_j)
    for k in losses_j:
        assert rel(losses[k], losses_j[k]) < 1e-4, k

    sub = getattr(model, trained)
    # every parameter the forward uses has a gradient (V1's attn_fuse_layer
    # is unused at one scale, and absent from the JAX tree)
    params = {k: p for k, p in sub.named_parameters() if p.grad is not None}
    ref = from_jax_submodel(sub, _np(grads_j[trained]))
    assert sorted(params) == sorted(ref)
    g = np.concatenate([params[k].grad.numpy().ravel() for k in ref])
    g_ref = np.concatenate([v.numpy().ravel() for v in ref.values()])
    assert rel_l2(g, g_ref) < 1e-3

    after_ref = from_jax_submodel(sub, _np(s1.params[trained]))
    d = np.concatenate([np.abs(params[k].detach().numpy()
                               - after_ref[k].numpy()).ravel() for k in ref])
    big = np.abs(g_ref) > 1e-5
    sure = big & (10 * np.abs(g - g_ref) < np.abs(g_ref))
    assert sure.sum() >= 0.99 * big.sum()
    assert d[sure].max() <= 1e-3 * LR
    assert d.max() <= 2 * LR
    for name, other in model.named_children():
        if name == trained:
            continue
        assert all(not p.requires_grad and p.grad is None
                   for p in other.parameters()), name
        for k, v in other.state_dict().items():
            assert torch.equal(v, before[f"{name}.{k}"]), k
    return losses


@pytest.fixture(scope="module")
def recipe2():
    return jax_side(RECIPE2)


def test_recipe2_one_step_matches_jax(recipe2):
    (jax_state, _), step, _ = recipe2
    losses = check_one_step(RECIPE2, jax_state, step, "refine_model")
    # the coarse terms, then three scales of refine terms, coarsest first
    assert list(losses)[:5] == ["coarse_l1_loss", "coarse_gdl_loss",
                                "coarse_vgg_loss", "coarse_ssim_loss",
                                "coarse_ce_loss"]
    assert [k for k in losses if k.endswith("_l1_loss")][1:] == [
        "refine_0.25_l1_loss", "refine_0.5_l1_loss", "refine_1.0_l1_loss"]


def test_recipe2_eval_metrics_match_jax(recipe2):
    (_, jax_state), _, evals = recipe2
    batch = batch_of(5)
    ref = evals(jax_state, jb(batch), jax.random.PRNGKey(0))
    cfg, model, state = port_side(RECIPE2, jax_state)
    out = inter.make_eval_step(cfg, model)(state, tb(batch))
    assert list(out) == list(ref)
    assert list(out)[-4:] == ["refine_l1", "refine_psnr", "refine_ssim",
                              "refine_vgg"]
    for k in ref:
        assert rel(out[k], ref[k]) < 1e-4, k


def test_with_gt_seg_refines_on_the_ground_truth(recipe2):
    """--with_gt_seg: an eval forward given gt_seg refines on it in place
    of the coarse soft seg (composite.py:67); the train step passes none."""
    (jax_state, _), _, _ = recipe2
    kw = dict(RECIPE2, with_gt_seg=True)
    jcfg = JConfig(**kw)
    batch = batch_of(6)
    x, seg, _, gt_seg = jcommon.get_inter_inputs(jb(batch))
    ref = jregistry.build_model(jcfg).apply(
        {"params": jax_state.params}, x, seg, gt_seg=gt_seg, train=False)
    _, model, _ = port_side(kw, jax_state)
    tx, tseg, tgt = (torch.from_numpy(np.array(a)) for a in (x, seg, gt_seg))
    with torch.no_grad():
        out = model(tx, tseg, gt_seg=tgt)
        plain = model(tx, tseg)
    want = np.asarray(ref[2][-1])
    assert np.abs(out[2][-1].numpy() - want).max() <= 1e-4 * np.abs(want).max()
    assert not torch.equal(out[2][-1], plain[2][-1])


def test_all_frozen_computes_every_gradient(recipe2):
    """With no train flag set nothing is frozen and nothing steps, as the
    JAX step computes every gradient and applies none."""
    (jax_state, _), _, _ = recipe2
    kw = dict(RECIPE2, train_refine=False)
    cfg, model, state = port_side(kw, jax_state)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    inter.make_train_step(cfg, model)(state, tb(batch_of(7)))
    assert all(p.grad is not None for p in model.parameters())
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_vae_coarse_under_refine_raises_as_jax():
    kw = dict(RECIPE2, coarse_model="VAEHRNet")
    with pytest.raises(ValueError, match="VAEHRNet"):
        jinter.make_train_step(JConfig(**kw), None)
    with pytest.raises(ValueError, match="VAEHRNet"):
        inter.make_train_step(Config(**kw), None)
    # under InterNet it is the plain VAE, which the port takes
    # (tests/test_torch_port_plain_vae.py)
    cfg = dataclasses.replace(Config(**kw), model="InterNet")
    assert registry.build_model(cfg, device="cpu").coarse_model.vae
