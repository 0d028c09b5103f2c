"""The ported video VAE (``models/vae_video.VideoVAE`` on ``models/subnets``)
against the JAX package's on the same weights and inputs, and the weight
mapper ``tools/jax_weights.vae_key_map`` / ``from_jax_vae``.

The JAX tree comes from an init in train mode (so the posterior encoders
exist); every leaf is then replaced from ``numpy.random.RandomState``:
kernels lecun-normal, biases and BN scales near 0 and 1, and BN running
statistics away from their init (mean in [-0.2, 0.2], var in [0.5, 2]), so
a mean or var taken from the wrong place shows.  Eval forward at 2x32x32
(the smallest size ``LegacyRefineNet`` takes), T = 2, with the same
``z_m``; frames are smooth (bilinear upsamplings of a 4x4 field), so a
bf16-sized change of the flow moves the warped frame by little.

Tolerances, on every output (output, y_pred, flow, flowback, mask_fw,
mask_bw): f32 max|d| <= 1e-4 * max(1, max|ref|), the same f32 graph on
both sides summed in another order; bf16 max|d| <= 5e-2 * max(1,
max|ref|), the two frameworks round at other points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.models import subnets as jsub
from deep_video_interpolation_extrapolation_tpu.models import vae_video as jvae
from deep_video_interpolation_extrapolation_tpu_torch.core.config import (
    Config as PortConfig,
)
from deep_video_interpolation_extrapolation_tpu_torch.models import (
    registry,
    subnets,
    vae_video,
)
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    KERNEL_TRANSFORM,
    from_jax_vae,
    vae_key_map,
)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

B, T, H, W = 2, 2, 32, 32


def _smooth(rng, shape):
    """(B, T+1, H, W, C) fields in [0, 1], bilinear upsamplings of 4x4."""
    coarse = torch.from_numpy(rng.uniform(0, 1, shape[:2] + (4, 4, shape[-1]))
                              .astype(np.float32))
    flat = coarse.reshape((-1, 4, 4, shape[-1])).permute(0, 3, 1, 2)
    up = torch.nn.functional.interpolate(flat, size=shape[2:4],
                                         mode="bilinear", align_corners=False)
    return up.permute(0, 2, 3, 1).reshape(shape).numpy()


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    rgb = _smooth(rng, (B, T + 1, H, W, 3))
    seg = np.eye(20, dtype=np.float32)[rng.randint(0, 20, (B, T + 1, H, W))]
    fg = (rng.uniform(0, 1, (B, T + 1, H, W, 1)) > 0.5).astype(np.float32)
    noise = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    z = rng.normal(0, 1, (B, 1024)).astype(np.float32)
    return rgb, seg, 1.0 - fg, fg, noise, z


def _randomized(variables, seed):
    """Every leaf of the JAX variables replaced from numpy."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        name = path[-1].key
        shape = np.shape(a)
        if name == "kernel":
            v = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name == "scale":
            v = rng.uniform(0.8, 1.2, shape)
        elif name == "mean":
            v = rng.uniform(-0.2, 0.2, shape)
        elif name == "var":
            v = rng.uniform(0.5, 2.0, shape)
        else:
            v = rng.uniform(-0.1, 0.1, shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module", params=["vae", "vae_s"])
def jax_vae(request):
    variant = request.param
    rgb, seg, bg, fg, noise, _ = _inputs()
    model = jvae.VideoVAE(vid_length=T, variant=variant)
    variables = model.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.asarray(rgb), jnp.asarray(seg), jnp.asarray(bg), jnp.asarray(fg),
        jnp.asarray(noise), train=True)
    variables = _randomized(
        {k: variables[k] for k in ("params", "batch_stats")}, 7)
    return variant, variables


def _port(variant, variables, dtype=None):
    model = vae_video.VideoVAE(vid_length=T, variant=variant, dtype=dtype,
                               size=(H, W))
    model.load_state_dict(from_jax_vae(variables["params"],
                                       variables["batch_stats"]), strict=True)
    return model.eval()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_video_vae_eval_matches_jax(jax_vae, dtype, tol):
    variant, variables = jax_vae
    rgb, seg, bg, fg, noise, z = _inputs(1)
    jdt = None if dtype == "float32" else jnp.bfloat16
    jmodel = jvae.VideoVAE(vid_length=T, variant=variant, dtype=jdt)
    ref = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        variables, *(jnp.asarray(a) for a in (rgb, seg, bg, fg, noise)), z)
    port = _port(variant, variables,
                 None if dtype == "float32" else torch.bfloat16)
    with torch.no_grad():
        out = port(*(torch.from_numpy(a) for a in (rgb, seg, bg, fg, noise)),
                   z_m=torch.from_numpy(z))
    assert len(out) == len(ref) == 6
    for name, o, r in zip(("output", "y_pred", "flow", "flowback", "mask_fw",
                           "mask_bw"), out, ref):
        r = np.asarray(r, np.float32)
        o = o.float().numpy()
        assert o.shape == r.shape, (name, o.shape, r.shape)
        bound = tol * max(1.0, np.abs(r).max())
        assert np.abs(o - r).max() <= bound, (name, np.abs(o - r).max(),
                                              bound)


def test_video_vae_train_mode_matches_jax(jax_vae):
    """train=True with a given z_m: every BatchNorm normalizes by its batch
    statistics; mu and logvar are None on both sides.  f32, max|d| <= 1e-3
    * max(1, max|ref|): at 2x32x32 the encoder's deepest statistics are
    over 2 to 8 values (the 1x1 code, the 2x2 level), whose E[x^2] -
    E[x]^2 amplifies summation-order differences (1.1e-4 seen)."""
    variant, variables = jax_vae
    rgb, seg, bg, fg, noise, z = _inputs(3)
    jmodel = jvae.VideoVAE(vid_length=T, variant=variant)
    ref, _ = jax.jit(lambda v, *a: jmodel.apply(
        v, *a, train=True, mutable=["batch_stats"]))(
        variables, *(jnp.asarray(a) for a in (rgb, seg, bg, fg, noise)), z)
    port = _port(variant, variables)
    with torch.no_grad():
        out = port(*(torch.from_numpy(a) for a in (rgb, seg, bg, fg, noise)),
                   z_m=torch.from_numpy(z), train=True)
    assert len(out) == len(ref) == 8
    assert out[2] is None and out[3] is None and ref[2] is None
    for o, r in zip(out[:2] + out[4:], ref[:2] + ref[4:]):
        r = np.asarray(r, np.float32)
        assert np.abs(o.numpy() - r).max() <= 1e-3 * max(1.0, np.abs(r).max())


def test_flow_encoder_matches_jax(jax_vae):
    """The posterior encoder (NHWC flatten before its Dense layers), on the
    VAE tree's own weights, eval statistics."""
    variant, variables = jax_vae
    port = _port(variant, variables)
    cin = port.flow_encoder_fg.convs[0].weight.shape[1]
    x = np.random.RandomState(5).uniform(-1, 1, (B, H, W, cin)).astype(
        np.float32)
    sub = {k: variables[k]["flow_encoder_fg"]
           for k in ("params", "batch_stats")}
    ref = jsub.FlowEncoder(port.latent_fg).apply(sub, jnp.asarray(x),
                                                 train=False)
    with torch.no_grad():
        out = port.flow_encoder_fg(torch.from_numpy(x), train=False)
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert np.abs(o.numpy() - r).max() <= 1e-4 * max(1.0, np.abs(r).max())


@pytest.mark.parametrize("name", ["Flow2FrameWarped", "GetFrames"])
def test_subnets_off_the_vae_path_match_jax(name):
    """The two sub-networks VideoVAE does not run, on randomized JAX
    weights mapped by ``from_jax_vae(root=...)``, eval statistics."""
    rng = np.random.RandomState(6)
    if name == "Flow2FrameWarped":
        args = (rng.uniform(0, 1, (B, H, W, 3)), rng.normal(0, 1, (B, H, W, 2)))
        jmod, port, root = jsub.Flow2FrameWarped(3), \
            subnets.Flow2FrameWarped(3, (H, W)), name
    else:
        args = (rng.normal(0, 1, (B, H, W, 64)),)
        jmod, port, root = jsub.GetFrames(), subnets.GetFrames(64), "ConvHead"
    args = [a.astype(np.float32) for a in args]
    variables = jmod.init(jax.random.PRNGKey(0), *map(jnp.asarray, args),
                          train=True)
    variables = _randomized({k: variables[k] for k in variables}, 8)
    variables.setdefault("batch_stats", {})
    ref = np.asarray(jmod.apply(variables, *map(jnp.asarray, args),
                                train=False))
    port.load_state_dict(from_jax_vae(variables["params"],
                                      variables["batch_stats"], root),
                         strict=True)
    with torch.no_grad():
        out = port(*map(torch.from_numpy, args), train=False).numpy()
    assert np.abs(out - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())


def test_vae_key_map_covers_the_tree_exactly(jax_vae):
    """Every flax leaf maps exactly once, onto a port key of the right
    shape, and the port's state_dict has no other key."""
    variant, variables = jax_vae
    leaves = {tuple([coll] + [p.key for p in path])
              for coll in ("params", "batch_stats")
              for path, _ in jax.tree_util.tree_flatten_with_path(
                  variables[coll])[0]}
    pairs = list(vae_key_map(variables["params"], variables["batch_stats"]))
    mapped = [path for _, path, _ in pairs]
    assert len(mapped) == len(set(mapped)) and set(mapped) == leaves
    sd = from_jax_vae(variables["params"], variables["batch_stats"])
    port = vae_video.VideoVAE(vid_length=T, variant=variant, size=(H, W))
    want = port.state_dict()
    assert set(sd) == set(want) and len(sd) == len(pairs)
    for k, v in sd.items():
        assert v.shape == want[k].shape, (k, v.shape, want[k].shape)


def test_conv_transpose_map_matches_flax():
    """The flax ConvTranspose (stride 1, unflipped kernel) against the
    port's on the weight the mapper makes of its kernel, both paddings: a
    wrong flip or transpose fails here."""
    import flax.linen as nn
    rng = np.random.RandomState(3)
    for k, pad, size in ((4, "VALID", 1), (3, "SAME", 5)):
        x = rng.normal(0, 1, (2, size, size, 6)).astype(np.float32)
        layer = nn.ConvTranspose(5, kernel_size=(k, k), padding=pad)
        params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
        ref = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))
        port = subnets.ConvTranspose(6, 5, k, pad)
        weight = KERNEL_TRANSFORM["convT"](np.asarray(params["kernel"]))
        with torch.no_grad():
            port.weight.copy_(torch.from_numpy(np.ascontiguousarray(weight)))
            port.bias.copy_(torch.from_numpy(np.array(params["bias"])))
            out = port(torch.from_numpy(x)).numpy()
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_batchnorm_train_mode_matches_flax():
    """Batch statistics (biased, E[x^2] - E[x]^2) normalize in train mode
    and move the running ones by flax's momentum 0.9."""
    import flax.linen as nn
    rng = np.random.RandomState(4)
    x = rng.normal(0.5, 2.0, (2, 3, 4, 5, 8)).astype(np.float32)
    layer = nn.BatchNorm(use_running_average=False, momentum=0.9)
    variables = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref, upd = layer.apply(variables, jnp.asarray(x),
                           mutable=["batch_stats"])
    bn = subnets.BatchNorm(8)
    out = bn(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    stats = upd["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), atol=1e-6)


def test_registry_builds_the_vaes_and_refuses_the_rest():
    cfg = PortConfig(model="VAE_S", vid_length=2, input_h=32, input_w=32,
                     compute_dtype="float32")
    model = registry.build_model(cfg, device="cpu", seed=2)
    assert isinstance(model, vae_video.VideoVAE) and not model.training
    assert model.variant == "vae_s" and model.vid_length == 2
    bn = model.seg_encoder.bn1
    assert torch.equal(bn.weight, torch.ones(32))
    # the legacy models the registry refused before train/legacy.py build
    for name in ("GridNet", "RefineGAN"):
        assert type(registry.build_model(PortConfig(model=name),
                                         device="cpu")).__name__ == name


def test_eval_without_z_draws_from_the_generator():
    """No ``z_m``: the code is drawn from the given generator, so the same
    seed gives the same frames."""
    model = registry.build_model(
        PortConfig(model="VAE", vid_length=1, input_h=32, input_w=32,
                   compute_dtype="float32"), device="cpu", seed=0)
    rgb, seg, bg, fg, noise, _ = (torch.from_numpy(a) for a in _inputs(2))
    args = (rgb[:, :2], seg[:, :2], bg[:, :2], fg[:, :2], noise)
    with torch.no_grad():
        a = model(*args, generator=torch.Generator().manual_seed(5))
        b = model(*args, generator=torch.Generator().manual_seed(5))
        c = model(*args, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a[0], b[0]) and not torch.equal(a[2], c[2])
