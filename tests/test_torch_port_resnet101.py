"""``models/features.ResNet101Features`` (the track-object loss's frozen
network) against the JAX package's, f32, on 64x128 patches (the loss's
crop size).

The JAX module is initialised and every BatchNorm's scale, bias, mean and
var replaced from ``numpy.random.RandomState`` (at the flax init they are
the identity, which would hide a mapped-wrong statistic), then carried
across by ``tools/jax_weights.from_jax_resnet101``.  The three stage maps
agree within 1e-4 of max|ref| (104 convs and 104 eval-mode BatchNorms in
f32, summed in another order); the stage-4 map's gradient of a probe with
respect to the input within 1e-4 rel-L2.  ``train/common.init_resnet_frozen``
builds it frozen and in eval mode, from a numpy seed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deep_video_interpolation_extrapolation_tpu.models import (
    features as jfeat,
)
from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.models.features import (
    ResNet101Features,
)
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    from_jax_resnet101,
    resnet101_key_map,
)
from deep_video_interpolation_extrapolation_tpu_torch.train.common import (
    init_resnet_frozen,
)

torch.set_num_threads(2)

PH, PW = 64, 128


@functools.lru_cache(maxsize=None)
def jax_resnet():
    """The JAX module and its variables, the BatchNorms randomized."""
    m = jfeat.ResNet101Features()
    v = jax.jit(functools.partial(m.init, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, PH, PW, 3), jnp.float32))
    rng = np.random.RandomState(1)

    def leaf(path, a):
        name = getattr(path[-1], "key", "")
        shape = np.shape(a)
        if name == "kernel":
            return np.asarray(a)
        v = {"scale": lambda: rng.uniform(0.5, 1.0, shape),
             "bias": lambda: rng.uniform(-0.1, 0.1, shape),
             "mean": lambda: rng.uniform(-0.1, 0.1, shape),
             "var": lambda: rng.uniform(0.8, 2.0, shape)}[name]()
        return v.astype(np.float32)
    return m, jax.tree_util.tree_map_with_path(leaf, dict(v))


def port_resnet():
    _, v = jax_resnet()
    net = ResNet101Features(dtype=torch.float32)
    net.load_state_dict(from_jax_resnet101(v["params"], v["batch_stats"]),
                        strict=True)
    return net.eval()


def test_key_map_covers_every_leaf():
    _, v = jax_resnet()
    keys = list(resnet101_key_map())
    assert len(keys) == len(jax.tree_util.tree_leaves(v))
    assert len(keys) == len(ResNet101Features().state_dict())


def test_features_match_jax():
    m, v = jax_resnet()
    x = np.random.RandomState(2).normal(0, 1, (2, PH, PW, 3)).astype(
        np.float32)
    probe = np.random.RandomState(3).normal(0, 1, (2, 2, 4, 2048)).astype(
        np.float32)

    def f(x):
        outs = m.apply(v, x, train=False)
        return jnp.sum(outs[2] * probe), outs
    g_ref, refs = jax.grad(f, has_aux=True)(jnp.asarray(x))
    net = port_resnet()
    xt = torch.from_numpy(x).requires_grad_()
    outs = net(xt)
    assert [tuple(o.shape) for o in outs] == [(2, 8, 16, 512),
                                              (2, 4, 8, 1024),
                                              (2, 2, 4, 2048)]
    for o, r in zip(outs, refs):
        r = np.asarray(r)
        assert np.abs(o.detach().numpy() - r).max() <= 1e-4 * np.abs(r).max()
    (outs[2] * torch.from_numpy(probe)).sum().backward()
    g, g_ref = xt.grad.numpy(), np.asarray(g_ref)
    assert np.sqrt(((g - g_ref) ** 2).sum() / (g_ref ** 2).sum()) <= 1e-4


def test_init_resnet_frozen():
    """Frozen, eval-mode, in the compute dtype, weights from the seed: the
    same seed gives the same network, and every BatchNorm starts at flax's
    init."""
    cfg = Config(compute_dtype="bfloat16")
    a = init_resnet_frozen(cfg, seed=3, device="cpu")
    b = init_resnet_frozen(cfg, seed=3, device="cpu")
    assert a.dtype == torch.bfloat16 and not a.training
    assert not any(p.requires_grad for p in a.parameters())
    for (k, t), u in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(t, u), k
    assert torch.equal(a.layer3[5].bn2.running_var, torch.ones(256))
    assert float(a.conv1.weight.std()) > 0
