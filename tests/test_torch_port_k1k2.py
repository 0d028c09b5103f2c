"""K1's and K2's kernel wrappers (``ops/conv3x3.py``,
``ops/bottleneck_tail.py``) on the CPU.

The kernels run only on the card (chip_smoke.py holds them against their
plain versions there; tests/test_torch_port_kernels.py holds the plain
versions against the JAX package's Pallas kernels).  What the wrappers do
around a launch runs here: the weight units they build must decode back to
the HWIO taps and (I, O) matrices in the order the kernels consume them,
and a shape the kernels cannot take must raise ``ValueError`` before any
launch (the kernel library is never reached and no counter moves).
"""

import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.ops import (
    _build,
    bottleneck_tail,
    conv3x3,
    trainchain,
)


def _w(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _unit_matrix(u):
    """A (8, 64, 8) unit back to its (64 k, 64 n) matrix."""
    return u.permute(0, 2, 1).reshape(64, 64)


@pytest.fixture
def no_launch(monkeypatch):
    """The kernel library must not be reached; counters must not move."""
    def library():
        raise AssertionError("the kernel library was reached")
    monkeypatch.setattr(_build, "library", library)
    hw.reset_counters()
    yield
    assert all(v == 0 for v in hw.launches.values())


# ---- K1 -------------------------------------------------------------------

@pytest.mark.parametrize("cin", [64, 256])
def test_k1_units_decode_to_the_hwio_taps(cin):
    """Unit kc * 9 + t holds tap t = ky * 3 + kx of input channels
    [64 kc, 64 kc + 64) as (in, out): the kernel's resident nine units at
    Cin = 64, and its streamed (chunk, tap) order at Cin = 256."""
    rng = np.random.RandomState(cin)
    w = _w(rng, 64, cin, 3, 3)
    u = conv3x3.conv_units(w, "cpu")
    assert u.shape == (cin // 64 * 9, 8, 64, 8)
    assert u.dtype == torch.bfloat16 and u.is_contiguous()
    hwio = w.permute(2, 3, 1, 0)
    for kc in range(cin // 64):
        for t in range(9):
            want = hwio[t // 3, t % 3, kc * 64:(kc + 1) * 64]
            assert torch.equal(_unit_matrix(u[kc * 9 + t]),
                               want.to(torch.bfloat16)), (kc, t)


@pytest.mark.parametrize("shape", [(1, 512, 1024), (2, 128, 256),
                                   (24, 128, 128), (2, 37, 130), (1, 1, 1),
                                   (3, 7, 17)])
@pytest.mark.parametrize("cin", [64, 256])
def test_k1_tile_picker_takes_every_nonempty_shape(cin, shape):
    """One tile at every (B, H, W), 4x16 at Cin = 64 and 8x16 at 256:
    ragged edges are masked in the kernel, so odd and small shapes take it
    too."""
    assert conv3x3.pick_tile(cin, 64, *shape) == ((4, 16) if cin == 64
                                                  else (8, 16))


@pytest.mark.parametrize("cin,cout,shape,match", [
    (128, 64, (1, 8, 16), "Cin in"),
    (32, 64, (1, 8, 16), "Cin in"),
    (64, 128, (1, 8, 16), "Cout == 64"),
    (64, 64, (0, 8, 16), "empty"),
    (64, 64, (1, 8, 0), "empty"),
    (256, 64, (4096, 1024, 1024), "32-bit"),
])
def test_k1_tile_picker_refuses(cin, cout, shape, match):
    with pytest.raises(ValueError, match=match):
        conv3x3.pick_tile(cin, cout, *shape)


@pytest.mark.parametrize("cin,cout,wshape,match", [
    (128, 64, None, "Cin in"),
    (64, 128, None, "Cout == 64"),
    (64, 64, (64, 32, 3, 3), "does not match"),
    (64, 64, None, "expected a CUDA tensor"),   # a shape it takes: the device
])
def test_k1_wrapper_raises_before_any_launch(no_launch, cin, cout, wshape,
                                             match):
    x = torch.zeros(1, 3, 20, cin)
    w = torch.zeros(wshape or (cout, cin, 3, 3))
    with pytest.raises(ValueError, match=match):
        conv3x3._kernel(x, w, None, None, True)


# ---- K2 -------------------------------------------------------------------

@pytest.mark.parametrize("has_res,has_next", [
    (True, True), (False, True), (False, False), (True, False)])
def test_k2_units_order(has_res, has_next):
    """w2's nine taps (in, out), then per 64 outputs nc: w3's (in, out)
    block, wres's (in, out) block (block 0) and w1_next's rows [64 nc,
    64 nc + 64) (in, out), the order a tile takes them."""
    rng = np.random.RandomState(2 * has_res + has_next)
    w2, w3 = _w(rng, 64, 64, 3, 3), _w(rng, 256, 64, 1, 1)
    wres = _w(rng, 256, 64, 1, 1) if has_res else None
    w1n = _w(rng, 64, 256, 1, 1) if has_next else None
    u = bottleneck_tail.tail_units(w2, w3, wres, w1n, "cpu")
    hwio = w2.permute(2, 3, 1, 0)
    want = [hwio[t // 3, t % 3] for t in range(9)]
    for nc in range(4):
        o = slice(nc * 64, (nc + 1) * 64)
        want.append(w3[:, :, 0, 0].t()[:, o])
        if has_res:
            want.append(wres[:, :, 0, 0].t()[:, o])
        if has_next:
            want.append(w1n[:, :, 0, 0].t()[o, :])
    assert u.shape == (9 + 4 * (1 + has_res + has_next), 8, 64, 8)
    assert u.dtype == torch.bfloat16 and u.is_contiguous()
    for i, m in enumerate(want):
        assert torch.equal(_unit_matrix(u[i]), m.to(torch.bfloat16)), i


@pytest.mark.parametrize("shape", [(1, 512, 1024), (2, 128, 256),
                                   (1, 66, 260), (1, 1, 1)])
@pytest.mark.parametrize("cx,has_res", [(64, True), (256, False)])
def test_k2_tile_picker_takes_every_nonempty_shape(cx, has_res, shape):
    assert bottleneck_tail.pick_tile(cx, has_res, *shape) == (8, 16)


@pytest.mark.parametrize("cx,has_res,shape,match", [
    (256, True, (1, 8, 16), "Cx = 64 with Wres"),
    (64, False, (1, 8, 16), "Cx = 64 with Wres"),
    (128, True, (1, 8, 16), "Cx = 64 with Wres"),
    (64, True, (1, 0, 16), "empty"),
    (256, False, (4096, 1024, 1024), "32-bit"),
])
def test_k2_tile_picker_refuses(cx, has_res, shape, match):
    with pytest.raises(ValueError, match=match):
        bottleneck_tail.pick_tile(cx, has_res, *shape)


@pytest.mark.parametrize("case,match", [
    ("wres_cx256", "Cx = 64 with Wres"),
    ("identity_cx64", "Cx = 64 with Wres"),
    ("p32", "P=64"),
    ("w1n", "w1_next"),
    ("ok", "expected a CUDA tensor"),   # a shape it takes: the device
])
def test_k2_wrapper_raises_before_any_launch(no_launch, case, match):
    p = 32 if case == "p32" else 64
    cx = 256 if case in ("wres_cx256", "ok") else 64
    h1, x = torch.zeros(1, 5, 18, p), torch.zeros(1, 5, 18, cx)
    w2, w3 = torch.zeros(64, p, 3, 3), torch.zeros(256, 64, 1, 1)
    wres = (torch.zeros(256, cx, 1, 1)
            if case in ("wres_cx256", "p32", "w1n") else None)
    w1n = torch.zeros(64, 128 if case == "w1n" else 256, 1, 1)
    with pytest.raises(ValueError, match=match):
        bottleneck_tail._kernel(h1, x, w2, w3, wres, w1n)


# ---- the weight layouts, built once per weight ----------------------------

def _param(rng, *shape):
    return torch.nn.Parameter(_w(rng, *shape))


@pytest.mark.parametrize("change", ["in_place", "new_storage", "bias"])
def test_k1_weights_built_once_until_a_weight_changes(change):
    """``conv3x3.weights`` returns the units and bias of an earlier call
    while neither weight changed, and rebuilds them (decoding to the new
    weights) after an in-place update or a new storage."""
    rng = np.random.RandomState(5)
    conv = torch.nn.Conv2d(64, 64, 3, padding=1)
    u1, b1 = conv3x3.weights(conv.weight, conv.bias, "cpu")
    u2, b2 = conv3x3.weights(conv.weight, conv.bias, "cpu")
    assert u2 is u1 and b2 is b1
    with torch.no_grad():
        if change == "in_place":
            conv.weight.add_(1.0)
        elif change == "new_storage":
            conv.weight.data = _w(rng, 64, 64, 3, 3)
        else:
            conv.bias.mul_(2.0)
    u3, b3 = conv3x3.weights(conv.weight, conv.bias, "cpu")
    assert torch.equal(u3, conv3x3.conv_units(conv.weight, "cpu"))
    assert torch.equal(b3, conv.bias.detach().to(torch.bfloat16))
    assert u3 is not u1 and b3 is not b1


def test_k1_weights_of_inference_tensors_built_every_call():
    """Inference tensors keep no version counter: nothing is kept."""
    rng = np.random.RandomState(6)
    with torch.inference_mode():
        w = _w(rng, 64, 64, 3, 3)
        u1, _ = conv3x3.weights(w, None, "cpu")
        u2, _ = conv3x3.weights(w, None, "cpu")
    assert u1 is not u2 and torch.equal(u1, u2)


@pytest.mark.parametrize("which", ["w2", "w3", "wres", "w1_next"])
def test_k2_units_built_once_until_a_weight_changes(which):
    """``tail_units`` keeps one layout per weight set; an optimizer-style
    in-place update of any of the four weights rebuilds it."""
    rng = np.random.RandomState(7)
    ws = {"w2": _param(rng, 64, 64, 3, 3), "w3": _param(rng, 256, 64, 1, 1),
          "wres": _param(rng, 256, 64, 1, 1),
          "w1_next": _param(rng, 64, 256, 1, 1)}
    u1 = bottleneck_tail.tail_units(*ws.values(), "cpu")
    assert bottleneck_tail.tail_units(*ws.values(), "cpu") is u1
    opt = torch.optim.SGD([ws[which]], lr=1.0)
    ws[which].grad = torch.ones_like(ws[which])
    opt.step()
    u2 = bottleneck_tail.tail_units(*ws.values(), "cpu")
    assert u2 is not u1
    assert torch.equal(u2, trainchain.bottleneck_units(
        None, ws["w2"], ws["w3"], ws["wres"], "cpu",
        k1_next=ws["w1_next"]))
