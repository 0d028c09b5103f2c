"""The seven box discriminators of ``models/detdisc`` that recipe 4's video
det family may take besides the LS one (``VideoVecSN``, ``VideoPoolSN``,
``VideoGlobalZero/Mask/Coord/ResSN``, ``VideoLocalPatchSN``) against the
JAX package's, at B=2 32x64, 2 tracks, f32.

Each port discriminator's leaves are drawn from
``numpy.random.RandomState`` (spectral-norm ``u`` included) and the JAX
tree is built from the same values through ``tools/jax_weights.disc_key_map``
(JAX applies it, so the map covers every leaf the JAX module reads); the
moved state is read back through ``from_jax_disc``.  One train pass (the spectral norms' power
iteration and the BatchNorms' statistics move; the JAX ``port_frame_sn_disc``
stores sigma = 1.0, so the state is compared after such a step): its
logits, the gradient of a probe of them with respect to the prediction,
and the moved state; then an eval sync_neg pass: its logits, and no state
moved.  GlobalMask and LocalPatch
take the ground truth (``gt_x``), as the JAX step hands it to them.

Tolerances, f32: logits and state max|d| <= 1e-4 * max(1, max|ref|), the
gradient rel-L2 <= GRAD_TOL: the same f32 graph summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.models import detdisc as jdet
from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.models import (
    detdisc,
    registry,
)
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    disc_key_map,
    from_jax_disc,
)

torch.set_num_threads(2)

B, H, W, T = 2, 32, 64, 2
# rel-L2 of the prediction's gradient.  The deep towers' input gradient is
# ill-conditioned: their logits hardly depend on the frames, so an ulp of a
# crop's sample position moves it by up to ~5e-3 (the JAX f32 gradient is
# up to 3e-4 from its own f64 one; in f64, with the same f64 sample
# positions, the port's is within 4e-7 of the JAX one for PoolSN)
GRAD_TOL = 1e-2
REST = ["VideoVecSNDetDiscriminator", "VideoPoolSNDetDiscriminator",
        "VideoGlobalZeroSNDetDiscriminator",
        "VideoGlobalMaskSNDetDiscriminator",
        "VideoGlobalCoordSNDetDiscriminator",
        "VideoGlobalResSNDetDiscriminator",
        "VideoLocalPatchSNDetDiscriminator"]
# (name, seg_disc, box fields): each class on rgb; GlobalMask with
# --seg_disc (the ground truth zero-padded to the prediction's channels),
# GlobalCoord on 5-field boxes (the scores weigh the tracks)
CASES = ([(n, False, 4) for n in REST]
         + [("VideoGlobalMaskSNDetDiscriminator", True, 4),
            ("VideoGlobalCoordSNDetDiscriminator", False, 5)])


def _inputs(seed, fields=4):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    seg = rng.uniform(0, 1, (B, H, W, 20)).astype(np.float32)
    ix = rng.uniform(-1, 1, (B, H, W, 6)).astype(np.float32)
    iseg = np.eye(20, dtype=np.float32)[rng.randint(0, 20, (B, H, W, 2))]
    gt = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    y1 = rng.uniform(0, H - 8, (B, 3, T))
    x1 = rng.uniform(0, W - 8, (B, 3, T))
    bb = np.stack([y1, x1, y1 + rng.uniform(4, 20, (B, 3, T)),
                   x1 + rng.uniform(4, 30, (B, 3, T))], -1)
    if fields == 5:
        bb = np.concatenate([rng.uniform(0.2, 1, (B, 3, T, 1)), bb], -1)
    return (x, seg, ix, iseg.reshape(B, H, W, 40), bb.astype(np.float32),
            gt)


def _jax_disc(name, seg_disc):
    return jdet.build(name, type("C", (), {"seg_disc": seg_disc})())


# torch weight -> flax kernel, by leaf kind (the inverse of
# tools/jax_weights.KERNEL_TRANSFORM)
TO_FLAX = {"conv": lambda a: np.transpose(a, (2, 3, 1, 0)),
           "dense": lambda a: np.transpose(a, (1, 0))}


def _leaf(rng, key, kind, shape):
    """A seeded value for a leaf, in the port's layout."""
    if kind in TO_FLAX and key.endswith("weight"):
        return rng.normal(0, 1 / np.sqrt(np.prod(shape[1:])), shape)
    if key.endswith("bn.weight") or ".fc_bn." in key and key.endswith(
            "weight"):
        return rng.uniform(0.8, 1.2, shape)
    if key.endswith("running_mean"):
        return rng.uniform(-0.2, 0.2, shape)
    if key.endswith("running_var"):
        return rng.uniform(0.5, 2.0, shape)
    if key.endswith(".u"):
        return rng.normal(0, 1, shape)
    if key.endswith(".sigma"):
        return np.ones(shape)
    return rng.uniform(-0.1, 0.1, shape)


def _variables(port, seed):
    """Seeded weights for ``port``, and the JAX tree of the same values
    built through ``disc_key_map`` (no flax init: on the CPU it takes
    longer than the comparison)."""
    rng = np.random.RandomState(seed)
    tree = {"params": {}, "batch_stats": {}}
    sd = {}
    for key, (coll, *path), kind in disc_key_map(port):
        shape = tuple(port.state_dict()[key].shape)
        a = _leaf(rng, key, kind, shape).astype(np.float32)
        sd[key] = torch.from_numpy(a)
        node = tree[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = jnp.asarray(TO_FLAX[kind](a) if kind in TO_FLAX
                                     and path[-1] == "kernel" else a)
    port.load_state_dict(sd, strict=True)
    return tree


def _gt_kw(name, gt, wrap):
    return ({"gt_x": wrap(gt)} if name in (
        "VideoGlobalMaskSNDetDiscriminator",
        "VideoLocalPatchSNDetDiscriminator") else {})


def _close(out, ref, tol=1e-4):
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy()
    assert out.shape == ref.shape, (out.shape, ref.shape)
    bound = tol * max(1.0, np.abs(ref).max())
    assert np.abs(out - ref).max() <= bound, (np.abs(out - ref).max(), bound)


@pytest.mark.parametrize("name,seg_disc,fields", CASES)
def test_det_discriminator_matches_jax(name, seg_disc, fields):
    jm = _jax_disc(name, seg_disc)
    cfg = Config(seg_disc=seg_disc, compute_dtype="float32")
    port = registry.build_disc(cfg, name)
    assert port.supports_sync_neg
    v = _variables(port, 1)

    x, seg, ix, iseg, bb, gt = _inputs(10, fields)
    ja = tuple(map(jnp.asarray, (x, seg, ix, iseg)))
    jb, jkw = jnp.asarray(bb), _gt_kw(name, gt, jnp.asarray)
    ta = tuple(map(torch.from_numpy, (x, seg, ix, iseg)))
    tb, tkw = torch.from_numpy(bb), _gt_kw(name, gt, torch.from_numpy)
    # a train pass and its vjp of the logits under a fixed probe
    probe = np.array([1.0, -0.6], np.float32)

    def jtrain(xx):
        return jm.apply(v, xx, *ja[1:], bboxes=jb, train=True,
                        mutable=["batch_stats"], **jkw)
    (ref, upd), vjp = jax.vjp(jtrain, ja[0])
    gref = np.asarray(vjp((jnp.asarray(probe), jax.tree_util.tree_map(
        jnp.zeros_like, upd)))[0])
    xt = ta[0].clone().requires_grad_()
    out = port(xt, *ta[1:], bboxes=tb, train=True, **tkw)
    _close(out, ref)
    (out * torch.from_numpy(probe)).sum().backward()
    g = xt.grad.numpy()
    err = np.sqrt(((g - gref) ** 2).sum() / max((gref ** 2).sum(), 1e-30))
    assert err <= GRAD_TOL, err
    v = {"params": v["params"], "batch_stats": upd.get("batch_stats", {})}
    want = from_jax_disc(port, v["params"], v["batch_stats"])
    n = 0
    for k, t in port.state_dict().items():
        if k.endswith(("u", "sigma", "running_mean", "running_var")):
            _close(t, want[k].numpy())
            n += 1
    assert n > 0
    # an eval sync_neg pass (the mid boxes rolled by one without the rng,
    # or, VecSN and PoolSN, the mid patch upside down): no state moves
    before = {k: t.clone() for k, t in port.state_dict().items()}
    with torch.no_grad():
        out = port(*ta, bboxes=tb, sync_neg=True, **tkw)
    _close(out, jm.apply(v, *ja, bboxes=jb, sync_neg=True, train=False,
                         **jkw))
    for k, t in port.state_dict().items():
        assert torch.equal(t, before[k]), k


def test_every_jax_det_discriminator_builds():
    """The registry builds every class of the JAX registry, and no other
    name (detdisc.py:499-533)."""
    names = set(jdet._REGISTRY)
    assert set(detdisc.CLASSES) == names
    for name in sorted(names):
        assert type(registry.build_disc(Config(), name)).__name__ == name
    with pytest.raises(KeyError):
        registry.build_disc(Config(), "NoSuchDiscriminator")
