"""The whole ported slice, InterNet/HRNet at full width, against the JAX
package on the same weights (JAX init mapped with
``tools/jax_weights.from_jax_params``), and the weight mapper against
``tools/torch_port.port_hrnet``.

Sizes: 32x64, B=1, CPU.  Tolerances:
- f32: max|d| <= 1e-3 * max|ref| on rgb and seg logits, seg argmax
  agreement >= 99.9%.  Both sides compute the same f32 graph; only the
  summation order of ~45 convolutions differs.
- bf16: max|d| <= 5e-2 * max(1, max|ref|), seg argmax agreement >= 95%.
  Both sides round every conv output to bf16 (8 bits of mantissa), but at
  places that differ slightly: the port's fuse sum adds in f32 and rounds
  once, as the TPU kernel's reference does, where the JAX CPU path adds in
  bf16; lrelu's slope is 0.2 in f32 here and bf16(0.2) there.  A few ulps
  per layer over ~45 layers gives a few percent; random-init seg logits
  have small margins, so a few argmaxes flip.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.core.config import Config
from deep_video_interpolation_extrapolation_tpu.models import registry as jregistry
from deep_video_interpolation_extrapolation_tpu.tools.torch_port import port_hrnet
from deep_video_interpolation_extrapolation_tpu_torch import serve
from deep_video_interpolation_extrapolation_tpu_torch.core.config import (
    Config as PortConfig,
)
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    from_jax_params,
)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

H, W = 32, 64


def _cfg(dtype="float32", **kw):
    base = dict(runner="INTER", model="InterNet", syn_type="inter",
                mode="xs2xs", coarse_model="HRNet", compute_dtype=dtype,
                input_h=H, input_w=W, batch_size=1, dataset="synthetic")
    return Config(**{**base, **kw})


@pytest.fixture(scope="module")
def jax_model():
    rng = np.random.RandomState(0)
    rgb = rng.uniform(-1, 1, (1, H, W, 6)).astype(np.float32)
    seg = np.eye(20, dtype=np.float32)[
        rng.randint(0, 20, (1, H, W, 2))].reshape(1, H, W, 40)
    model = jregistry.build_model(_cfg())
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(rgb),
                           jnp.asarray(seg), train=False)
    params = jax.tree_util.tree_map(np.asarray,
                                    variables["params"]["coarse_model"])
    return variables, params, rgb, seg


def _port(params, dtype):
    model = registry.build_model(_cfg(dtype), device="cpu")
    model.coarse_model.load_state_dict(from_jax_params(params))
    return model


@pytest.mark.parametrize("dtype,tol,agree", [("float32", 1e-3, 0.999),
                                             ("bfloat16", 5e-2, 0.95)])
def test_internet_matches_jax(jax_model, dtype, tol, agree):
    variables, params, rgb, seg = jax_model
    jr, js = jregistry.build_model(_cfg(dtype)).apply(
        variables, jnp.asarray(rgb), jnp.asarray(seg), train=False)
    jr, js = np.asarray(jr, np.float32), np.asarray(js, np.float32)
    r, s = serve.forward(_port(params, dtype), torch.from_numpy(rgb),
                         torch.from_numpy(seg))
    r, s = r.float().numpy(), s.float().numpy()
    assert r.shape == (1, H, W, 3) and s.shape == (1, H, W, 20)
    floor = 1.0 if dtype == "bfloat16" else 0.0
    for out, ref in ((r, jr), (s, js)):
        bound = tol * max(floor, np.abs(ref).max())
        assert np.abs(out - ref).max() <= bound
    assert (s.argmax(-1) == js.argmax(-1)).mean() >= agree


def test_from_jax_params_covers_every_key(jax_model):
    _, params, _, _ = jax_model
    sd = from_jax_params(params)
    port = registry.build_model(_cfg(), device="cpu")
    assert sorted(sd) == sorted(port.coarse_model.state_dict())
    missing, unexpected = port.coarse_model.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(params))
    n_port = sum(p.numel() for p in port.parameters())
    assert n_port == n_jax and 9.9e6 < n_port < 10.0e6


def test_port_hrnet_inverts_the_mapper(jax_model):
    """port_hrnet(port state_dict) reproduces the JAX tree exactly."""
    _, params, _, _ = jax_model
    sd = {k: v.numpy() for k, v in from_jax_params(params).items()}
    back = port_hrnet(sd, params)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a)


def test_kernel_and_plain_models_agree_on_cpu(jax_model):
    """use_kernels only selects kernels vs plain versions; on CPU tensors
    both routes run the plain versions, so the outputs are identical."""
    _, params, rgb, seg = jax_model
    a = serve.forward(_port(params, "float32"), torch.from_numpy(rgb),
                      torch.from_numpy(seg))
    plain = registry.build_model(_cfg(), device="cpu", use_kernels=False)
    plain.coarse_model.load_state_dict(from_jax_params(params))
    b = serve.forward(plain, torch.from_numpy(rgb), torch.from_numpy(seg))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_port_config_mirrors_the_jax_config():
    """The port's Config has every field of the JAX Config, in the same
    order, with the same default, so a JAX Config builds the same port
    model and the port's parser fills every field."""
    jax_fields = [(f.name, f.default) for f in dataclasses.fields(Config)]
    port_fields = [(f.name, f.default) for f in dataclasses.fields(PortConfig)]
    assert port_fields == jax_fields
    assert PortConfig().n_classes == Config().n_classes
    assert PortConfig().seg_encode_dim == Config().seg_encode_dim
    port = registry.build_model(PortConfig(syn_type="inter"), device="cpu",
                                  seed=5)
    ref = registry.build_model(_cfg("bfloat16"), device="cpu", seed=5)
    assert port.coarse_model.dtype == ref.coarse_model.dtype == torch.bfloat16
    for a, b in zip(port.state_dict().values(), ref.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kw", [dict(model="InterGANNet",
                                     coarse_model="VAEHRNet", track_gen=True),
                                dict(coarse_model="VAEHRNet"),
                                dict(model="ExtraNet", syn_type="extra",
                                     coarse_model="VAEHRNet"),
                                dict(model="ExtraInpaintNet",
                                     syn_type="extra", inpaint=True,
                                     inpaint_mask=True, highres_large=True),
                                dict(coarse_model="UNet"),
                                dict(model="GridNet")])
def test_registry_refuses_unported_models(kw):
    """Every model the JAX registry builds is ported and builds: TrackGen,
    the plain VAE (VAEHRNet under InterNet and ExtraNet), the 4-part head at
    N2 = 216 (ExtraInpaintNet ``--inpaint_mask --highres_large``) and the
    legacy models (a UNet coarse, GridNet), which the registry refused
    before ``train/legacy.py``; tests/test_torch_port_legacy_models.py holds
    them to the JAX modules."""
    if kw.get("highres_large"):
        model = registry.build_model(_cfg(**kw), device="cpu")
        assert model.coarse_model.rgb_dim + model.coarse_model.seg_dim == 24
        return
    if kw.get("coarse_model") == "VAEHRNet":
        model = registry.build_model(_cfg(**kw), device="cpu")
        assert model.coarse_model.vae
        assert hasattr(model, "track_gen_model") == bool(kw.get("track_gen"))
        return
    model = registry.build_model(_cfg(**kw), device="cpu")
    built = (model.coarse_model if "coarse_model" in kw else model)
    assert type(built).__name__ == kw.get("coarse_model", kw.get("model"))
