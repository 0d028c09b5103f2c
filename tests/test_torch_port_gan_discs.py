"""The ported discriminators (``models/discriminators``: the frame and video
families, global and local, plain and SN; ``models/detdisc``: the six
box-patch classes recipe 4 and its neighbours run; the other seven:
tests/test_torch_port_detdisc_rest.py), ``ops/roi.crop_resize``
and the GAN and KL losses, against the JAX package.

Each JAX discriminator is initialised at B=2 32x64, every leaf replaced
from ``numpy.random.RandomState`` (spectral-norm ``u`` included) and
carried across by ``tools/jax_weights.from_jax_disc``.  Train and eval
passes are compared on their logits, and the state a train pass moves (the
spectral norms' ``u`` and ``sigma``, the BatchNorms' running statistics)
after 1 and 3 passes; an eval pass moves nothing.

Tolerances, f32: logits and state max|d| <= 1e-4 * max(1, max|ref|); the
same f32 graph on both sides summed in another order.  ``crop_resize``
1e-5 (bilinear weights from box coordinates up to 64).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.losses import gan as jgan
from deep_video_interpolation_extrapolation_tpu.losses.vae import (
    kld_loss as jkld,
)
from deep_video_interpolation_extrapolation_tpu.models import detdisc as jdet
from deep_video_interpolation_extrapolation_tpu.models import (
    discriminators as jdisc,
)
from deep_video_interpolation_extrapolation_tpu.ops import roi as jroi
from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.losses import gan
from deep_video_interpolation_extrapolation_tpu_torch.losses.vae import (
    kld_loss,
)
from deep_video_interpolation_extrapolation_tpu_torch.models import (
    detdisc,
    registry,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.roi import (
    crop_resize,
)
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    disc_key_map,
    from_jax_disc,
)

torch.set_num_threads(2)

B, H, W, T = 2, 32, 64, 3

FRAME = ["FrameDiscriminator", "FrameLocalDiscriminator",
         "FrameSNDiscriminator", "FrameSNLocalDiscriminator",
         "FrameDetDiscriminator", "FrameSNDetDiscriminator",
         "FrameLSSNDetDiscriminator"]
VIDEO = ["VideoDiscriminator", "VideoLocalDiscriminator",
         "VideoSNDiscriminator", "VideoSNLocalDiscriminator",
         "VideoDetDiscriminator", "VideoSNDetDiscriminator",
         "VideoLSSNDetDiscriminator"]


def _jax_disc(name, seg_disc=False):
    if hasattr(jdisc, name):
        return getattr(jdisc, name)(seg_disc=seg_disc)
    return jdet.build(name, type("C", (), {"seg_disc": seg_disc})())


def _boxes(rng, fields=4):
    y1 = rng.uniform(0, H - 8, (B, 3, T))
    x1 = rng.uniform(0, W - 8, (B, 3, T))
    b = np.stack([y1, x1, y1 + rng.uniform(4, 20, (B, 3, T)),
                  x1 + rng.uniform(4, 30, (B, 3, T))], -1)
    if fields == 5:
        b = np.concatenate([rng.uniform(0.2, 1, (B, 3, T, 1)), b], -1)
    return b.astype(np.float32)


def _inputs(seed, fields=4):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    seg = rng.uniform(0, 1, (B, H, W, 20)).astype(np.float32)
    ix = rng.uniform(-1, 1, (B, H, W, 6)).astype(np.float32)
    iseg = np.eye(20, dtype=np.float32)[rng.randint(0, 20, (B, H, W, 2))]
    return x, seg, ix, iseg.reshape(B, H, W, 40), _boxes(rng, fields)


def _randomized(variables, seed):
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        name = getattr(path[-1], "key", "")
        shape = np.shape(a)
        if name == "kernel":
            v = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name == "scale":
            v = rng.uniform(0.8, 1.2, shape)
        elif name == "mean":
            v = rng.uniform(-0.2, 0.2, shape)
        elif name == "var":
            v = rng.uniform(0.5, 2.0, shape)
        elif name.endswith("/u"):
            v = rng.normal(0, 1, shape)
        else:
            v = rng.uniform(-0.1, 0.1, shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _args(name, inputs):
    x, seg, ix, iseg, bb = inputs
    return (x, seg, ix, iseg) if name.startswith("Video") else (x, seg)


@functools.lru_cache(maxsize=None)
def _jax_vars(name, seg_disc=False, fields=4):
    inputs = _inputs(0, fields)
    v = _jax_disc(name, seg_disc).init(
        jax.random.PRNGKey(0), *map(jnp.asarray, _args(name, inputs)),
        bboxes=jnp.asarray(inputs[-1]), train=True)
    v = {"params": v["params"], "batch_stats": v.get("batch_stats", {})}
    return _randomized(v, 1)


def _port(name, variables, seg_disc=False):
    cfg = Config(seg_disc=seg_disc, compute_dtype="float32")
    disc = registry.build_disc(cfg, name)
    disc.load_state_dict(from_jax_disc(disc, variables["params"],
                                       variables["batch_stats"]), strict=True)
    return disc


def _close(out, ref, tol=1e-4):
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy()
    assert out.shape == ref.shape, (out.shape, ref.shape)
    bound = tol * max(1.0, np.abs(ref).max())
    assert np.abs(out - ref).max() <= bound, (np.abs(out - ref).max(), bound)


def _state_close(disc, variables):
    """The port's buffers against the JAX variables, through the key map
    (u, sigma, running statistics)."""
    want = from_jax_disc(disc, variables["params"], variables["batch_stats"])
    n = 0
    for k, t in disc.state_dict().items():
        if k.endswith(("u", "sigma", "running_mean", "running_var")):
            _close(t, want[k].numpy())
            n += 1
    return n


CASES = ([(n, False, 4) for n in FRAME + VIDEO]
         + [("FrameSNDiscriminator", True, 4),
            ("VideoSNDetDiscriminator", True, 4),
            ("VideoLSSNDetDiscriminator", False, 5)])


@pytest.mark.parametrize("name,seg_disc,fields", CASES)
def test_discriminator_matches_jax(name, seg_disc, fields):
    """Train passes (1, then 2 more) and an eval pass: the logits, and the
    moved state after 1 and 3 train passes; eval stores nothing (the SN
    ``u`` and ``sigma`` and the BN statistics unchanged)."""
    v = _jax_vars(name, seg_disc, fields)
    jm = _jax_disc(name, seg_disc)
    port = _port(name, v, seg_disc)
    assert len(list(disc_key_map(port))) == len(
        jax.tree_util.tree_leaves(v))

    def jrun(v, *a, train):
        return jm.apply(v, *a[:-1], bboxes=a[-1], train=train,
                        mutable=["batch_stats"] if train else False)
    jtrain = jax.jit(functools.partial(jrun, train=True))
    jeval = jax.jit(functools.partial(jrun, train=False))
    n_state = None
    for step in range(3):
        inputs = _inputs(10 + step, fields)
        a = _args(name, inputs) + (inputs[-1],)
        ref, upd = jtrain(v, *map(jnp.asarray, a))
        v = {"params": v["params"], "batch_stats": upd.get("batch_stats",
                                                           {})}
        with torch.no_grad():
            out = port(*map(torch.from_numpy, a[:-1]),
                       bboxes=torch.from_numpy(a[-1]), train=True)
        _close(out, ref)
        if step in (0, 2):
            n_state = _state_close(port, v)
    assert n_state > 0
    inputs = _inputs(20, fields)
    a = _args(name, inputs) + (inputs[-1],)
    before = {k: t.clone() for k, t in port.state_dict().items()}
    with torch.no_grad():
        out = port(*map(torch.from_numpy, a[:-1]),
                   bboxes=torch.from_numpy(a[-1]), train=False)
    _close(out, jeval(v, *map(jnp.asarray, a)))
    for k, t in port.state_dict().items():
        assert torch.equal(t, before[k]), k


@pytest.mark.parametrize("name", ["VideoSNDetDiscriminator",
                                  "VideoLSSNDetDiscriminator"])
def test_sync_neg_matches_jax(name, monkeypatch):
    """The sync_neg pass (each track's mid box swapped for another
    track's): without a generator the roll by one of the JAX module
    without the ``sync_neg`` rng; with one, offsets in [1, T) — the JAX
    draw recorded by a wrapper of ``detdisc._sync_neg_boxes`` and handed
    to the port's through the same indices."""
    v = _jax_vars(name)
    jm = _jax_disc(name)
    port = _port(name, v)
    inputs = _inputs(30)
    a = tuple(map(jnp.asarray, inputs))
    ref = jm.apply(v, *a[:-1], bboxes=a[-1], sync_neg=True, train=False)
    with torch.no_grad():
        out = port(*map(torch.from_numpy, inputs[:-1]),
                   bboxes=torch.from_numpy(inputs[-1]), sync_neg=True)
    _close(out, ref)

    seen = []
    orig = jdet._sync_neg_boxes

    def recording(module, mid):
        got = orig(module, mid)
        seen.append(got)
        return got
    monkeypatch.setattr(jdet, "_sync_neg_boxes", recording)
    ref = jm.apply(v, *a[:-1], bboxes=a[-1], sync_neg=True, train=False,
                   rngs={"sync_neg": jax.random.PRNGKey(3)})
    swapped = np.asarray(seen[0])
    mid = inputs[-1][:, 1]
    # recover the JAX offsets: the track whose box each slot took
    idx = np.array([[int(np.flatnonzero((mid[b] == swapped[b, t]).all(-1))[0])
                     for t in range(T)] for b in range(B)])
    off = (idx - np.arange(T)[None]) % T
    assert ((off >= 1) & (off < T)).all()
    monkeypatch.setattr(torch, "randint", lambda lo, hi, size, **kw:
                        torch.from_numpy(off))
    with torch.no_grad():
        out = port(*map(torch.from_numpy, inputs[:-1]),
                   bboxes=torch.from_numpy(inputs[-1]), sync_neg=True,
                   generator=torch.Generator())
    _close(out, ref)
    g = torch.Generator().manual_seed(0)
    monkeypatch.undo()
    swapped = detdisc._sync_neg_boxes(torch.from_numpy(mid), g)
    for b in range(B):
        for t in range(T):
            assert not torch.equal(swapped[b, t], torch.from_numpy(mid[b, t]))


def test_unported_det_discriminators_raise():
    """Every box discriminator of the JAX registry is ported and builds
    (tests/test_torch_port_detdisc_rest.py holds the seven that came last
    to JAX); an unknown name raises KeyError, as there."""
    cfg = Config()
    for name in jdet._REGISTRY:
        assert type(registry.build_disc(cfg, name)).__name__ == name
    assert set(detdisc.CLASSES) == set(jdet._REGISTRY)
    with pytest.raises(KeyError):
        registry.build_disc(cfg, "NoSuchDiscriminator")


@pytest.mark.parametrize("case", ["inside", "border", "degenerate"])
def test_crop_resize_matches_jax(case):
    """64x64 align-corners bilinear patches of (B, N) boxes: inside the
    image, on and past its border (clamped), and degenerate (zero-size,
    inverted)."""
    rng = np.random.RandomState(40)
    img = rng.normal(0, 1, (B, H, W, 5)).astype(np.float32)
    if case == "inside":
        boxes = _boxes(rng)[:, 1]
    elif case == "border":
        boxes = np.array([[[0, 0, H - 1, W - 1], [-3, W - 10, 5, W + 4],
                           [H - 6, -2, H + 3, 7]]] * B, np.float32)
    else:
        boxes = np.array([[[5, 7, 5, 7], [10, 20, 4, 12],
                           [3.5, 2.5, 3.5, 40]]] * B, np.float32)
    ref = jroi.crop_resize(jnp.asarray(img), jnp.asarray(boxes), (64, 64))
    out = crop_resize(torch.from_numpy(img), torch.from_numpy(boxes),
                      (64, 64))
    _close(out, ref, 1e-5)


def test_gan_and_kld_losses_match_jax():
    """The hinge losses (D real, D fake, G; the d and g helpers) on logits
    and patch maps, and the KL term, against losses/gan.py and
    losses/vae.py."""
    rng = np.random.RandomState(41)
    for shape in ((B,), (B, 4, 8, 1)):
        lg = rng.normal(0, 1.5, shape).astype(np.float32)
        lt, lj = torch.from_numpy(lg), jnp.asarray(lg)
        for real in (True, False):
            _close(gan.gan_scalar_loss(lt, real, 0.4),
                   jgan.gan_scalar_loss(lj, real, 0.4), 1e-6)
        _close(gan.hinge_d_loss(lt, -lt, 0.01),
               jgan.hinge_d_loss(lj, -lj, 0.01), 1e-6)
        _close(gan.hinge_g_loss(lt, 0.4), jgan.hinge_g_loss(lj, 0.4), 1e-6)
    mu = rng.normal(0, 1, (B, 128)).astype(np.float32)
    lv = rng.normal(0, 0.5, (B, 128)).astype(np.float32)
    _close(kld_loss(torch.from_numpy(mu), torch.from_numpy(lv), 20.0),
           jkld(jnp.asarray(mu), jnp.asarray(lv), 20.0), 1e-5)
