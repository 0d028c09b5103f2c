"""The 4-part head's and the train stem's kernel wrappers (``ops/upshead.py``,
``ops/trainchain.py``) on the CPU.

The kernels (``csrc/upshead4.cu``, ``csrc/trainchain_stem.cu``) run only on
the card, where chip_smoke.py holds them against their plain versions.
What surrounds a launch runs here: the weight units the wrappers build must
decode back to the weights they came from, in the order the kernels take
them, and the model keeps its head weights while no grad is needed; the stem's weight-grad partials must decode to OIHW grads; the
plain backward the card holds the stem's backward kernel against must
equal the hand-written one; ``_Stem`` must keep s1 only when a backward
can follow; and whatever the kernels cannot take must raise ``ValueError``
before any launch.  Layouts are exact copies (equality); the two plain
stem backwards take the same masks, so they agree to the last bit in f32
and bf16.
"""

import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.models import hrnet, registry
from deep_video_interpolation_extrapolation_tpu_torch.ops import (
    _build,
    trainchain,
    upshead,
)

torch.set_num_threads(1)


def _w(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


@pytest.fixture
def no_launch(monkeypatch):
    """The kernel library must not be reached; counters must not move."""
    def library():
        raise AssertionError("the kernel library was reached")
    monkeypatch.setattr(_build, "library", library)
    hw.reset_counters()
    yield
    assert all(v == 0 for v in hw.launches.values())


# ---- the 4-part head --------------------------------------------------------

@pytest.mark.parametrize("ct,n1", [(960, 1920), (192, 320)])
def test_taps4_w1_units_decode_to_w1(ct, n1):
    """``w1_units4``: unit [p, u, j] holds W1[64 u + 8 kg + k, 64 (2p + j)
    + n] at [kg, n, k]; hidden channels past N1 (N1 not a multiple of 128)
    are zero."""
    rng = np.random.RandomState(0)
    w1 = _w(rng, ct, n1).to(torch.bfloat16)
    u = upshead.w1_units4(w1, "cpu")
    n1p = -(-n1 // 128) * 128
    assert u.shape == (n1p // 128, ct // 64, 2, 8, 64, 8)
    assert u.dtype == torch.bfloat16 and u.is_contiguous()
    # (p, u, j, kg, n, k) -> (u, kg, k, p, j, n) = W1 rows, padded columns
    back = u.permute(1, 3, 5, 0, 2, 4).reshape(ct, n1p)
    assert torch.equal(back[:, :n1], w1)
    assert not back[:, n1:].any()
    for k, n in rng.randint(0, [ct, n1], (40, 2)):
        assert u[n // 128, k // 64, (n // 64) % 2, (k % 64) // 8, n % 64,
                 k % 8] == w1[k, n]


def test_taps4_w2_chunks_decode_to_w2t():
    """``w2_chunks`` at 1920 x 207: chunk nc holds W2t[64 nc + 8 kg + k, n]
    at [kg, n, k], the columns past 207 zero."""
    rng = np.random.RandomState(1)
    w2t = _w(rng, 1920, 207).to(torch.bfloat16)
    c = upshead.w2_chunks(w2t, "cpu")
    assert c.shape == (30, 8, upshead.N2_MAX, 8) and c.is_contiguous()
    back = c.permute(0, 1, 3, 2).reshape(1920, upshead.N2_MAX)
    assert torch.equal(back[:, :207], w2t)
    assert not back[:, 207:].any()


def test_taps4_weights_pad_hidden_channels_to_nothing():
    """``taps4_weights`` pads N1 to a multiple of 128 in W1, b1 and W2t
    alike; a padded hidden channel's h is lrelu(0 + 0) = 0, so the plain
    head on the padded weights is the head on the given ones."""
    rng = np.random.RandomState(2)
    ct, n1 = 64 + 64 + 64 + 64, 192
    w1, b1, w2t = _w(rng, ct, n1) * 0.1, _w(rng, n1) * 0.1, _w(rng, n1, 23)
    w1u, b1k, w2u = upshead.taps4_weights(w1, b1, w2t, "cpu")
    assert b1k.dtype == torch.float32 and b1k.shape == (256,)
    assert torch.equal(b1k[:n1], b1) and not b1k[n1:].any()
    w1p = w1u.permute(1, 3, 5, 0, 2, 4).reshape(ct, 256).float()
    w2p = w2u.permute(0, 1, 3, 2).reshape(256, upshead.N2_MAX)[:, :23].float()
    assert not w2p[n1:].any()
    parts = [torch.from_numpy(rng.uniform(-1, 1, (1, 16 // f, 32 // f, 64))
                              .astype(np.float32)) for f in (1, 2, 4, 8)]
    want = upshead.ups_head_taps4_plain(*parts, w1.to(torch.bfloat16).float(),
                                        b1, w2t.to(torch.bfloat16).float())
    got = upshead.ups_head_taps4_plain(*parts, w1p, b1k, w2p)
    # the padded products sum the same terms and zeros, maybe in another
    # blocking: f32 rounding at most
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_taps4_weights_built_once_until_a_weight_changes():
    """The 4-part kernel's weights are built once per weight set and built
    again after an in-place update of any of the three."""
    rng = np.random.RandomState(3)
    w1, b1, w2t = _w(rng, 256, 128), _w(rng, 128), _w(rng, 128, 207)
    first = upshead.taps4_weights(w1, b1, w2t, "cpu")
    assert upshead.taps4_weights(w1, b1, w2t, "cpu") is first
    w2t.add_(1.0)
    second = upshead.taps4_weights(w1, b1, w2t, "cpu")
    assert second is not first
    assert torch.equal(second[2].permute(0, 1, 3, 2).reshape(128, 208)[:, :207],
                       w2t.to(torch.bfloat16))


def _pyramid(c=(64, 128, 256, 512), hw_=((16, 64), (8, 32), (4, 16), (2, 8)),
             b=1):
    return [torch.zeros((b, h, w, ch), dtype=torch.bfloat16)
            for ch, (h, w) in zip(c, hw_)]


@pytest.mark.parametrize("case,match", [
    ("channels", "4-part kernel"), ("part channels", "4-part kernel"),
    ("batch", "4-part kernel"), ("w1", "do not match"),
    ("n1", "N1 % 64"), ("n2", "N2 <= 216"), ("empty", "empty image"),
    ("cpu", "CUDA")])
def test_taps4_kernel_raises_before_any_launch(no_launch, case, match):
    """What the 4-part kernel cannot take is a ``ValueError`` before the
    library is reached: a concat over 960 channels or not a multiple of 64,
    a part's channels not a multiple of 8, batches that differ, weights
    that do not match, N1 not a multiple of 64, N2 over 216, an empty
    image; and on the CPU every operand (a CUDA tensor is required)."""
    parts = _pyramid()
    w1 = torch.zeros((960, 1920))
    b1, w2t = torch.zeros((1920,)), torch.zeros((1920, 207))
    if case == "channels":
        parts[0] = torch.zeros((1, 16, 64, 72), dtype=torch.bfloat16)
        w1 = torch.zeros((968, 1920))
    elif case == "part channels":
        parts[0] = torch.zeros((1, 16, 64, 60), dtype=torch.bfloat16)
        parts[1] = torch.zeros((1, 8, 32, 132), dtype=torch.bfloat16)
    elif case == "batch":
        parts[3] = torch.zeros((2, 2, 8, 512), dtype=torch.bfloat16)
    elif case == "w1":
        w1 = torch.zeros((896, 1920))
    elif case == "n1":
        w1, b1, w2t = (torch.zeros((960, 1900)), torch.zeros((1900,)),
                       torch.zeros((1900, 207)))
    elif case == "n2":
        w2t = torch.zeros((1920, 217))
    elif case == "empty":
        parts = _pyramid(hw_=((16, 64), (8, 32), (4, 16), (0, 8)))
    with pytest.raises(ValueError, match=match):
        upshead._taps4_kernel(*parts, w1, b1, w2t)


@pytest.mark.parametrize("hw_", [((37, 130), (19, 65), (10, 33), (5, 17)),
                                 ((16, 64), (8, 32), (4, 16), (2, 8))])
def test_taps4_checks_take_any_pyramid_size(hw_):
    """``check_taps4`` takes the ragged pyramid chip_smoke.py runs (not
    ``fits4``) as it takes a ``fits4`` one."""
    parts = _pyramid(hw_=hw_)
    upshead.check_taps4(*parts, torch.zeros((960, 1920)),
                        torch.zeros((1920,)), torch.zeros((1920, 207)))


@pytest.mark.parametrize("highres_large", [False, True])
def test_head_weights_kept_without_grad_until_a_weight_changes(highres_large):
    """The model's (w1, b1, w2t) of both heads, on the 3-part (K4) and the
    4-part route alike: kept across forwards without grad, under
    ``inference_mode`` as plain tensors (so the 4-part kernel's units of
    them are kept too), built again after an in-place update of a head
    weight, and built fresh, with grad, on every call under grad."""
    model = registry.init_weights(
        hrnet.HRNet(dtype=torch.bfloat16, highres_large=highres_large), 0)
    dt = torch.bfloat16
    with torch.inference_mode():
        first = model._head_weights(dt)
        assert model._head_weights(dt) is first
    assert not any(t.is_inference() for t in first)
    with torch.no_grad():
        assert model._head_weights(dt) is first
        model.seg_layer[2].weight.add_(1.0)
        second = model._head_weights(dt)
    assert second is not first
    fresh = model._head_weights(dt)
    assert fresh is not second and fresh[0].requires_grad
    assert model._head_weights(dt) is not fresh
    for a, b in zip(second, fresh):
        assert torch.equal(a, b.detach())


# ---- the stem -----------------------------------------------------------------

def _stem_params(rng, ci=14):
    return (_w(rng, 64, ci, 3, 3) * 0.1, _w(rng, 64) * 0.1,
            _w(rng, 64, 64, 3, 3) * 0.05, _w(rng, 64) * 0.1)


def test_stem_units_decode_to_the_weights():
    """``stem_units``: tap t = 3 ky + kx of each unit set, (k-group, n, k):
    w1u k1[n, 8 kg + k, ky, kx] (input channels 14, 15 zero); w2u k2[n,
    8 kg + k, ky, kx]; the backward's w2f k2[8 kg + k, n, 2 - ky, 2 - kx]
    and wxf k1[8 kg + k, n, 2 - ky, 2 - kx] (outputs 14, 15 zero): the
    transposed convs as SAME convs."""
    rng = np.random.RandomState(4)
    k1, b1, k2, b2 = _stem_params(rng)
    u = trainchain.stem_units(k1, b1, k2, b2, "cpu")
    shapes = dict(w1u=(9, 2, 64, 8), w2u=(9, 8, 64, 8), w2f=(9, 8, 64, 8),
                  wxf=(9, 8, 16, 8))
    for name, shape in shapes.items():
        assert u[name].shape == shape and u[name].is_contiguous(), name
        assert u[name].dtype == torch.bfloat16, name
    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731
    for t in range(9):
        ky, kx = divmod(t, 3)
        # (kg, n, k) -> (kg, k, n): K rows, N columns
        m1 = u["w1u"][t].permute(0, 2, 1).reshape(16, 64)
        assert torch.equal(m1[:14], bf(k1[:, :, ky, kx].t()))
        assert not m1[14:].any()
        m2 = u["w2u"][t].permute(0, 2, 1).reshape(64, 64)
        assert torch.equal(m2, bf(k2[:, :, ky, kx].t()))
        mf = u["w2f"][t].permute(0, 2, 1).reshape(64, 64)
        assert torch.equal(mf, bf(k2[:, :, 2 - ky, 2 - kx]))
        mx = u["wxf"][t].permute(0, 2, 1).reshape(64, 16)
        assert torch.equal(mx[:, :14], bf(k1[:, :, 2 - ky, 2 - kx]))
        assert not mx[:, 14:].any()
    assert torch.equal(u["b1"], bf(b1)) and torch.equal(u["b2"], bf(b2))


def test_stem_units_built_once_until_a_weight_changes():
    """One layout serves a step's forward and backward: built once per
    weight set, again after an optimizer-style in-place update."""
    rng = np.random.RandomState(5)
    ws = _stem_params(rng)
    first = trainchain.stem_units(*ws, "cpu")
    assert trainchain.stem_units(*ws, "cpu") is first
    ws[3].mul_(0.5)
    assert trainchain.stem_units(*ws, "cpu") is not first


@pytest.mark.parametrize("ci", [14, 16])
def test_stem_wgrads_decode_the_partials(ci):
    """``stem_wgrads``: the weight-grad launch's partials [tap, input,
    output] summed over pixel ranges come back as OIHW dk1 (cut to ci
    inputs) and dk2; dbp's first s0 rows are db2's, the rest db1's."""
    rng = np.random.RandomState(6)
    s0, s1 = 5, 2
    dk2p = _w(rng, s0, 9, 64, 64)
    dk1p = _w(rng, 3 * s1, 9, 16, 64)
    dbp = _w(rng, s0 + s1, 64)
    dk1, db1, dk2, db2 = trainchain.stem_wgrads(dk2p, dk1p, dbp, s0, ci)
    assert dk1.shape == (64, ci, 3, 3) and dk2.shape == (64, 64, 3, 3)
    s2, s1_ = dk2p.sum(0), dk1p.sum(0)
    for t in range(9):
        ky, kx = divmod(t, 3)
        assert torch.equal(dk2[:, :, ky, kx], s2[t].t())
        assert torch.equal(dk1[:, :, ky, kx], s1_[t, :ci].t())
    assert torch.equal(db2, dbp[:s0].sum(0))
    assert torch.equal(db1, dbp[s0:].sum(0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("padded", [False, True])
def test_stem_bwd_saved_equals_recomputed(dtype, padded):
    """``stem_bwd_saved_plain`` (masks from the signs of the kept s1 and
    y) equals ``stem_bwd_plain`` (masks from the recomputed
    pre-activations) exactly, in f32 and bf16, given x or its copy
    zero-padded to 16 channels."""
    rng = np.random.RandomState(7)
    k1, b1, k2, b2 = _stem_params(rng)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 12, 20, 14))
                         .astype(np.float32)).to(dtype)
    dy = _w(rng, 2, 12, 20, 64).to(dtype)
    s1 = trainchain._lrelu(trainchain._conv(x, k1) + b1.to(dtype))
    y = trainchain.stem_plain(x, k1, b1, k2, b2)
    xs = trainchain._pad16(x) if padded else x
    got = trainchain.stem_bwd_saved_plain(xs, dy, s1, y, k1, b1, k2, b2)
    want = trainchain.stem_bwd_plain(x, dy, k1, b1, k2, b2)
    assert got[0].dtype == dtype and got[0].shape == x.shape
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


class _FakeKernels:
    """The stem kernels' plain stand-ins on the CPU, recording what the
    autograd Function asks of them."""

    def __init__(self):
        self.saves, self.bwd_calls = [], 0

    def fwd(self, x16, k1, b1, k2, b2, save):
        x = x16[..., :k1.shape[1]]
        self.saves.append(save)
        s1 = trainchain._lrelu(trainchain._conv(x, k1) + b1.to(x.dtype))
        return trainchain.stem_plain(x, k1, b1, k2, b2), s1 if save else None

    def bwd(self, x16, dy, s1, y, k1, b1, k2, b2):
        self.bwd_calls += 1
        assert x16.shape[-1] == trainchain.STEM_CIN_PAD
        return trainchain.stem_bwd_saved_plain(x16, dy, s1, y, k1, b1, k2, b2)


@pytest.fixture
def fake_stem(monkeypatch):
    fake = _FakeKernels()
    monkeypatch.setattr(hw, "use_kernel", lambda t: True)
    monkeypatch.setattr(trainchain, "_check_stem", lambda *a: None)
    monkeypatch.setattr(trainchain, "_stem_fwd", fake.fwd)
    monkeypatch.setattr(trainchain, "stem_bwd_kernel", fake.bwd)
    return fake


def test_stem_keeps_s1_only_when_a_backward_can_follow(fake_stem):
    """On the kernel route ``stem`` asks the forward to store s1 only with
    grad enabled and an input requiring it; the Function then keeps the
    padded x, y and s1 (and the weights), and its backward reads them
    through the backward kernel: the grads are plain autograd's."""
    rng = np.random.RandomState(8)
    ws = [p.requires_grad_() for p in _stem_params(rng)]
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 8, 16, 14)).astype(
        np.float32)).requires_grad_()
    with torch.no_grad():
        trainchain.stem(x, *ws)
    trainchain.stem(x.detach(), *(p.detach() for p in ws))
    assert fake_stem.saves == [False, False]
    y = trainchain.stem(x, *ws)
    assert fake_stem.saves == [False, False, True]
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 7 and saved[0].shape[-1] == trainchain.STEM_CIN_PAD
    dy = _w(rng, 1, 8, 16, 64)
    got = torch.autograd.grad(y, [x, *ws], dy)
    assert fake_stem.bwd_calls == 1
    want = torch.autograd.grad(trainchain.stem_plain(x, *ws), [x, *ws], dy)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,match", [
    ((0, 8, 16), "empty input"), ((1, 0, 16), "empty input"),
    ((2**16, 2**8, 2**7), "32-bit")])
def test_stem_tiles_refuse(shape, match):
    """The stem kernels' tile count refuses an empty input and one with too
    many pixels for 32-bit indices."""
    with pytest.raises(ValueError, match=match):
        trainchain.stem_tiles(*shape)


@pytest.mark.parametrize("shape,tiles,splits", [
    ((24, 128, 128), 3072, (99, 33)), ((2, 36, 120), 80, (80, 27)),
    ((1, 1, 1), 1, (1, 1))])
def test_stem_tiles_and_splits(shape, tiles, splits):
    """Any non-empty shape is taken (ragged edges are masked): 8x16 tiles,
    and the weight-grad pixel ranges (dk2 and db2, dk1 and db1)."""
    assert trainchain.stem_tiles(*shape) == tiles
    assert trainchain.stem_wgrad_splits(*shape) == splits


@pytest.mark.parametrize("case,match", [
    ("k1 inputs", "Ci <= 16"), ("x channels", "Ci <= 16"),
    ("k2", "Ci <= 16"), ("empty", "empty input"), ("cpu", "CUDA")])
def test_stem_wrappers_raise_before_any_launch(no_launch, case, match):
    """The stem's forward and backward wrappers raise ``ValueError`` for
    what the kernels cannot take before the library is reached: k1 with
    over 64 inputs, x whose channels are neither k1's nor 16, another k2,
    an empty input, and on the CPU any operand."""
    rng = np.random.RandomState(9)
    k1, b1, k2, b2 = _stem_params(rng)
    x = torch.zeros((1, 8, 16, 14), dtype=torch.bfloat16)
    if case == "k1 inputs":
        k1, x = _w(rng, 64, 66, 3, 3), torch.zeros((1, 8, 16, 66),
                                                    dtype=torch.bfloat16)
    elif case == "x channels":
        x = torch.zeros((1, 8, 16, 12), dtype=torch.bfloat16)
    elif case == "k2":
        k2 = _w(rng, 64, 32, 3, 3)
    elif case == "empty":
        x = torch.zeros((1, 0, 16, 14), dtype=torch.bfloat16)
    act = torch.zeros((*x.shape[:3], 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        trainchain.stem_fwd_kernel(x, k1, b1, k2, b2, save=True)
    with pytest.raises(ValueError, match=match):
        trainchain.stem_bwd_kernel(x, act, act, act, k1, b1, k2, b2)
