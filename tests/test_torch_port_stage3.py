"""InterStage3Net (HRNet -> SRNRefine -> MSResAttnRefine V1, ``n_scales=1``)
and InterRefineNet, ported, against the JAX package on the same weights
(the JAX init mapped with ``tools/jax_weights.load_jax_params``), the
weight mappers against ``tools/torch_port``, the serving rollout against
``Runner._mini_test``, and the refusals of what is not ported (the refine
family's other routes: test_torch_port_refine_models.py).

Sizes: 32x64, B=1, CPU.  Tolerances are the InterNet test's
(test_torch_port_model.py), on every output (coarse rgb and seg, the
refined and the stage-3 frame):
- f32: max|d| <= 1e-3 * max|ref|, coarse seg argmax agreement >= 99.9%,
  flow maps equal on >= 99.9% of the pixels.  The same f32 graph on both
  sides, summed in another order.
- bf16: max|d| <= 5e-2 * max(1, max|ref|), seg argmax agreement >= 95%.
  The flow maps are the argmax of cosine similarities of random-init
  features, whose near-ties flip under bf16 rounding: they must agree on
  >= 90% of the pixels, the kernel test's bound (test_torch_port_corr.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.core.config import Config
from deep_video_interpolation_extrapolation_tpu.models import registry as jregistry
from deep_video_interpolation_extrapolation_tpu.tools.torch_port import (
    port_ms_res_attn_refine,
    port_srn_refine,
)
from deep_video_interpolation_extrapolation_tpu.train.runner import Runner
from deep_video_interpolation_extrapolation_tpu_torch import serve
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    from_jax_refine,
    from_jax_stage3,
    load_jax_params,
    refine_key_map,
    stage3_key_map,
)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

H, W = 32, 64


def _cfg(dtype="float32", **kw):
    base = dict(runner="INTER", model="InterStage3Net", syn_type="inter",
                mode="xs2xs", coarse_model="HRNet", refine_model="SRNRefine",
                compute_dtype=dtype, input_h=H, input_w=W, batch_size=1,
                dataset="synthetic")
    return Config(**{**base, **kw})


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    rgb = rng.uniform(-1, 1, (1, H, W, 6)).astype(np.float32)
    seg = np.eye(20, dtype=np.float32)[
        rng.randint(0, 20, (1, H, W, 2))].reshape(1, H, W, 40)
    return rgb, seg


@pytest.fixture(scope="module")
def jax_stage3():
    rgb, seg = _inputs()
    variables = jregistry.build_model(_cfg()).init(
        jax.random.PRNGKey(0), jnp.asarray(rgb), jnp.asarray(seg),
        train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return variables, params, rgb, seg


def _port(cfg, params):
    model = registry.build_model(cfg, device="cpu")
    left = load_jax_params(model, params)
    assert all(k.startswith("stage3_model.attn_fuse_layer.") for k in left)
    return model


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def _flow_agreement(a, b):
    return np.mean(np.all(_np(a) == _np(b), axis=-1))


@pytest.mark.parametrize("dtype,tol,agree,flow_agree", [
    ("float32", 1e-3, 0.999, 0.999), ("bfloat16", 5e-2, 0.95, 0.90)])
def test_stage3_matches_jax(jax_stage3, dtype, tol, agree, flow_agree):
    variables, params, rgb, seg = jax_stage3
    cfg = _cfg(dtype)
    ref = jregistry.build_model(cfg).apply(
        variables, jnp.asarray(rgb), jnp.asarray(seg), train=False)
    with torch.inference_mode():
        out = _port(cfg, params)(torch.from_numpy(rgb), torch.from_numpy(seg))
    assert len(out) == 5 and len(out[2]) == len(out[3]) == len(out[4]) == 1
    floor = 1.0 if dtype == "bfloat16" else 0.0
    pairs = [(out[0], ref[0]), (out[1], ref[1]), (out[2][-1], ref[2][-1]),
             (out[3][-1], ref[3][-1])]
    for got, want in pairs:
        got, want = _np(got), _np(want)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= tol * max(floor, np.abs(want).max())
    assert (_np(out[1]).argmax(-1) == _np(ref[1]).argmax(-1)).mean() >= agree
    assert out[4][0].shape == (1, 2, H // 4, W // 4, 2)
    assert _flow_agreement(out[4][0], ref[4][0]) >= flow_agree


def test_refinenet_matches_jax(jax_stage3):
    """InterRefineNet is InterStage3Net without stage 3, its refined frames
    clipped to [-10, 10] (f32)."""
    _, params, rgb, seg = jax_stage3
    cfg = _cfg(model="InterRefineNet")
    sub = {k: params[k] for k in ("coarse_model", "refine_model")}
    ref = jregistry.build_model(cfg).apply(
        {"params": sub}, jnp.asarray(rgb), jnp.asarray(seg), train=False)
    with torch.inference_mode():
        out = _port(cfg, sub)(torch.from_numpy(rgb), torch.from_numpy(seg))
    assert len(out) == 3
    for got, want in ((out[0], ref[0]), (out[2][-1], ref[2][-1])):
        want = _np(want)
        assert np.abs(_np(got) - want).max() <= 1e-3 * np.abs(want).max()
    r, _ = serve.forward(_port(cfg, sub), torch.from_numpy(rgb),
                         torch.from_numpy(seg))
    torch.testing.assert_close(r, out[2][-1], rtol=0, atol=0)


@pytest.mark.parametrize("name", ["refine_model", "stage3_model"])
def test_mappers_cover_every_leaf_once(jax_stage3, name):
    _, params, _, _ = jax_stage3
    keys = {"refine_model": refine_key_map,
            "stage3_model": stage3_key_map}[name](params[name])
    paths = [p for _, p in keys]
    leaves = [tuple(k.key for k in path) for path, _ in
              jax.tree_util.tree_leaves_with_path(params[name])]
    assert sorted(paths) == sorted(leaves)
    port = getattr(registry.build_model(_cfg(), device="cpu"), name)
    fn = {"refine_model": from_jax_refine, "stage3_model": from_jax_stage3}
    sd = fn[name](params[name])
    absent = sorted(set(port.state_dict()) - set(sd))
    assert set(sd) <= set(port.state_dict())
    assert absent == ([] if name == "refine_model" else [
        "attn_fuse_layer.0.bias", "attn_fuse_layer.0.weight",
        "attn_fuse_layer.2.bias", "attn_fuse_layer.2.weight"])
    for k, v in sd.items():
        assert v.shape == port.state_dict()[k].shape, k


@pytest.mark.parametrize("name", ["refine_model", "stage3_model"])
def test_torch_port_inverts_the_mappers(jax_stage3, name):
    """port_srn_refine / port_ms_res_attn_refine of the port's state_dict
    reproduce the JAX tree exactly (the ConvT flip included)."""
    _, params, _, _ = jax_stage3
    fn, back = {"refine_model": (from_jax_refine, port_srn_refine),
                "stage3_model": (from_jax_stage3,
                                 port_ms_res_attn_refine)}[name]
    sd = {k: v.numpy() for k, v in fn(params[name]).items()}
    got = back(sd, params[name])
    flat_a = jax.tree_util.tree_leaves_with_path(params[name])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a)


@pytest.fixture(scope="module")
def runner(tmp_path_factory):
    cfg = _cfg(split="cycgen", num_pred_step=2, num_pred_once=1)
    exp_dir = str(tmp_path_factory.mktemp("exp"))
    os.makedirs(exp_dir, exist_ok=True)
    return Runner(cfg, exp_dir)


def test_rollout_matches_mini_test(runner):
    """``serve.rollout`` slides the window on the stage-3 frame, as
    ``_mini_test`` does: 2 steps, f32; frames max|d| <= 1e-4, seg ids
    agree on >= 99.9% of the pixels (as the InterNet rollout test)."""
    rng = np.random.RandomState(7)
    imgs = [rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32)
            for _ in range(2)]
    ids = [rng.randint(0, 20, (1, H, W)).astype(np.uint8) for _ in range(2)]
    runner.rng = jax.random.PRNGKey(0)
    ref_imgs, ref_ids = runner._mini_test(
        [jnp.asarray(i) for i in imgs],
        [jnp.asarray(np.eye(20, dtype=np.float32)[i]) for i in ids])
    model = _port(runner.cfg, jax.tree_util.tree_map(np.asarray,
                                                     runner.state.params))
    out_imgs, out_ids = serve.rollout(
        model, [torch.from_numpy(i) for i in imgs],
        [torch.from_numpy(i) for i in ids], 2)
    assert len(out_imgs) == len(ref_imgs) == 2
    for k in range(2):
        np.testing.assert_allclose(out_imgs[k].numpy(),
                                   np.asarray(ref_imgs[k]), atol=1e-4, rtol=0)
        assert (out_ids[k].numpy() == np.asarray(ref_ids[k])).mean() >= 0.999


def test_final_output_picks_the_last_stage():
    a, b, c, d, e = (torch.full((1,), float(i)) for i in range(5))
    assert serve.final_output((a, b, [c, d], [e], [a])) == (e, b)
    assert serve.final_output((a, b, [c, d])) == (d, b)
    assert serve.final_output((a, b)) == (a, b)


@pytest.mark.parametrize("kw,exc", [
    (dict(coarse_model="VAEHRNet"), None),
    (dict(model="ExtraNet", syn_type="extra", highres_large=True,
          inpaint=True, inpaint_mask=True), None),
    (dict(model="InterGANNet", coarse_model="VAEHRNet", track_gen=True),
     None),
    (dict(stage3_model="MSResAttnRefineV9"), KeyError)])
def test_unported_stage3_routes_raise(kw, exc):
    """An unknown stage-3 name raises KeyError, as the JAX registry does;
    the 4-part head at N2 = 216 (``--highres_large`` with a 24-wide head)
    and TrackGen are ported and build, and so does InterStage3Net on a
    VAEHRNet, as in the JAX registry (its train step refuses it,
    tests/test_torch_port_train.py)."""
    if exc is None:
        model = registry.build_model(_cfg(**kw), device="cpu")
        assert (model.coarse_model.highres_large
                or model.coarse_model.vae)
        return
    with pytest.raises(exc, match="ROADMAP" if exc is NotImplementedError
                       else None):
        registry.build_model(_cfg(**kw), device="cpu")


def test_build_model_defaults_to_the_card():
    """No device argument means the card; without one it raises rather
    than building on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.build_model(_cfg(model="InterRefineNet"))
