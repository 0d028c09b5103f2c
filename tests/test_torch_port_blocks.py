"""The port's building blocks against the JAX modules, with the JAX
parameters mapped across (HWIO -> OIHW), in f32 on the CPU.

Tolerance: max|d| <= 1e-4 * max(1, max|ref|) — the same f32 products summed
in another order by XLA and by PyTorch's CPU convolutions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.models import blocks as jblocks
from deep_video_interpolation_extrapolation_tpu.ops import resize as jresize
from deep_video_interpolation_extrapolation_tpu_torch.models import blocks
from deep_video_interpolation_extrapolation_tpu_torch.models.hrnet import (
    _concat_pyramid,
    _Head,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops import (
    resize,
    shiftadd,
    upshead,
)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _oihw(k):
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _close(out, ref, tol=1e-4):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    bound = tol * max(1.0, np.abs(ref).max())
    err = np.abs(out - ref).max()
    assert err <= bound, f"max|d| {err:.3g} > {bound:.3g}"


def _load(conv, p):
    with torch.no_grad():
        conv.weight.copy_(_oihw(p["kernel"]))
        if conv.bias is not None:
            conv.bias.copy_(_t(p["bias"]))


def test_lrelu_slope():
    x = torch.tensor([-1.0, 0.0, 2.0])
    np.testing.assert_allclose(blocks.lrelu(x).numpy(),
                               np.asarray(jblocks.lrelu(jnp.asarray(x.numpy()))))


@pytest.mark.parametrize("kernel", [False, True])
def test_basicblock_matches_jax(kernel):
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (2, 8, 16, 64)).astype(np.float32)
    m = jblocks.BasicBlock(64, dtype=jnp.float32)
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = m.apply(v, jnp.asarray(x))
    blk = blocks.BasicBlock(64)
    _load(blk.conv1, v["params"]["Conv_0"])
    _load(blk.conv2, v["params"]["Conv_1"])
    _close(blk(_t(x), kernel=kernel).detach().numpy(), ref)


@pytest.mark.parametrize("cin", [64, 256])
def test_bottleneck_matches_jax(cin):
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (1, 8, 16, cin)).astype(np.float32)
    m = jblocks.Bottleneck(64, dtype=jnp.float32)
    v = m.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = m.apply(v, jnp.asarray(x))
    blk = blocks.Bottleneck(cin, 64)
    p = v["params"]
    for conv, name in ((blk.conv1, "Conv_0"), (blk.conv2, "Conv_1"),
                       (blk.conv3, "Conv_2")):
        _load(conv, p[name])
    assert (blk.downsample is not None) == ("Conv_3" in p)
    if blk.downsample is not None:
        _load(blk.downsample[0], p["Conv_3"])
    _close(blk(_t(x)).detach().numpy(), ref)


def test_segencoder_matches_jax():
    rng = np.random.RandomState(2)
    seg = np.eye(20, dtype=np.float32)[rng.randint(0, 20, (2, 8, 16))]
    m = jblocks.SegEncoder(dtype=jnp.float32)
    v = m.init(jax.random.PRNGKey(2), jnp.asarray(seg))
    ref = m.apply(v, jnp.asarray(seg))
    enc = blocks.SegEncoder()
    for i, name in ((0, "Conv_0"), (2, "Conv_1"), (4, "Conv_2")):
        _load(enc[i], v["params"][name])
    out = enc(_t(seg)).detach()
    assert out.shape == (2, 8, 16, 4)
    _close(out.numpy(), ref)


@pytest.mark.parametrize("size", [(16, 32), (32, 64), (5, 7), (8, 8),
                                  (4, 8), (16, 64)])
def test_interpolate_bilinear_matches_jax(size):
    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, (2, 8, 16, 5)).astype(np.float32)
    ref = jresize.interpolate_bilinear(jnp.asarray(x), size=size,
                                       align_corners=False)
    out = resize.interpolate_bilinear(_t(x), size=size)
    _close(out.numpy(), ref)


@pytest.mark.parametrize("factor", [2.0, 0.5, 1.5])
def test_interpolate_bilinear_scale_factor_matches_jax(factor):
    rng = np.random.RandomState(4)
    x = rng.uniform(-1, 1, (2, 8, 16, 5)).astype(np.float32)
    ref = jresize.interpolate_bilinear(jnp.asarray(x), scale_factor=factor,
                                       align_corners=False)
    out = resize.interpolate_bilinear(_t(x), scale_factor=factor)
    _close(out.numpy(), ref)


@pytest.mark.parametrize("shape", [(2, 8, 16, 5), (1, 7, 9, 3)])
def test_max_pool_matches_jax(shape):
    """VALID, stride = window: a ragged last row and column are dropped."""
    x = np.random.RandomState(5).uniform(-1, 1, shape).astype(np.float32)
    ref = jresize.max_pool(jnp.asarray(x), (2, 2))
    out = resize.max_pool(_t(x), (2, 2))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_fused_head_path_equals_unfused_heads():
    """The K4 route (fused upsample-concat + both 1x1s + taps product, then
    the shifted add) == each _Head run on the concat pyramid."""
    g = torch.Generator().manual_seed(4)
    parts = [torch.randn(1, 8, 16, 64, generator=g),
             torch.randn(1, 4, 8, 128, generator=g),
             torch.randn(1, 2, 4, 256, generator=g)]
    rgb_head, seg_head = _Head(448, 3), _Head(448, 20)
    with torch.no_grad():
        for p in list(rgb_head.parameters()) + list(seg_head.parameters()):
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
        feat = _concat_pyramid(parts)
        ref_r, ref_s = rgb_head(feat), seg_head(feat)
        w1 = torch.cat([rgb_head[0].weight[:, :, 0, 0].t(),
                        seg_head[0].weight[:, :, 0, 0].t()], dim=1)
        b1 = torch.cat([rgb_head[0].bias, seg_head[0].bias])
        w2t = upshead.build_dual_tap_kernel(rgb_head[2].weight,
                                            seg_head[2].weight, torch.float32)
        yt = upshead.ups_head_taps(*parts, w1, b1, w2t)
        out = shiftadd.shifted_add_bias(yt, torch.cat([rgb_head[2].bias,
                                                       seg_head[2].bias]))
    _close(out[..., :3].numpy(), ref_r.numpy())
    _close(out[..., 3:].numpy(), ref_s.numpy())


@pytest.mark.parametrize("kernel,dilation", [((1, 3), 1), ((3, 1), 1),
                                             ((3, 5), 2)])
def test_conv_default_padding_is_same_per_axis(kernel, dilation):
    """A non-square ``Conv`` pads each axis by its own half-width: SAME, as
    XLA's convolution with SAME padding."""
    rng = np.random.RandomState(7)
    x = rng.uniform(-1, 1, (2, 6, 9, 5)).astype(np.float32)
    k = rng.uniform(-1, 1, kernel + (5, 4)).astype(np.float32)     # HWIO
    b = rng.uniform(-1, 1, (4,)).astype(np.float32)
    conv = blocks.Conv(5, 4, kernel=kernel, dilation=dilation)
    with torch.no_grad():
        conv.weight.copy_(_oihw(k))
        conv.bias.copy_(_t(b))
        out = conv(_t(x)).numpy()
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), "SAME",
        rhs_dilation=(dilation, dilation),
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    _close(out, ref)
