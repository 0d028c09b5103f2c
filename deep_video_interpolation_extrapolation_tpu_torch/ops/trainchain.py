"""The stem + layer1 train chain: forward and backward kernels, NHWC.

Counterpart of ``ops/pallas_trainchain.packed_stem`` and
``packed_bottleneck`` (each a ``jax.custom_vjp`` pair of Pallas kernels):

    stem:        s1 = lrelu(conv3x3(x, k1) + b1);  y = lrelu(conv3x3(s1, k2) + b2)
    bottleneck:  h1 = lrelu(x . k1);  h2 = lrelu(conv3x3(h1, k2));
                 y  = lrelu(h2 . k3 + (x . kres  if kres is given  else x))

The Bottleneck's forward kernel keeps h1 and h2 on chip and its backward
kernels recompute them from the saved block input; the stem's forward
stores s1 when autograd needs it and its backward reads s1 and y, the
lrelu masks their signs (``stem_bwd_saved_plain``).  Both return dx in the
compute dtype and f32 weight grads.  The kernels are
``csrc/trainchain_stem.cu`` and ``csrc/trainchain_bottleneck.cu``; their
notes say how each pass is split into launches.  The Bottleneck kernels
take the blocks of the main path: Ci = 64 with the projection residual,
Ci = 256 with the identity one.

Rounding follows the JAX kernels (pallas_trainchain.py module docstring):
every product is an f32-accumulated product of compute-dtype operands,
rounded to the compute dtype before a bias or residual add; bias and
residual adds and the lrelu run in the compute dtype; the lrelu masks of
the backward come from the pre-activation signs (recomputed, or the kept
activations', the same but at -0.0); dx is rounded
once, weight grads stay f32.  The ``*_plain`` functions below write that
arithmetic out in PyTorch: the forward ones are what a plain model
differentiates with autograd, the backward ones are the hand-written
backward the CPU tests hold against ``jax.grad`` and the card holds the
backward kernels against.

``stem`` and ``bottleneck`` are ``torch.autograd.Function``s: on CUDA bf16
tensors both passes launch the kernels, on CPU tensors both take the plain
versions.  Weights are torch OIHW tensors (the f32 masters); their grads
come back in the same layout and dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.ops import _build
from deep_video_interpolation_extrapolation_tpu_torch.ops.resize import (
    nchw,
    nhwc,
)
from deep_video_interpolation_extrapolation_tpu_torch.parallel import spatial

STEM_FWD, STEM_BWD = "stem_fwd", "stem_bwd"
STEM48_FWD, STEM48_BWD = "stem48_fwd", "stem48_bwd"   # the kernels at Ci 48
STEM64_FWD, STEM64_BWD = "stem64_fwd", "stem64_bwd"   # ... and at Ci 64
BN_FWD, BN_BWD = "bottleneck_fwd", "bottleneck_bwd"
BN_WGRAD = "bottleneck_wgrad"
P, CO = 64, 256      # layer1 widths: planes and planes * expansion
STEM_CIN_PAD = 16    # the stem kernels take x zero-padded to 16 channels
STEM_CIN_PADS = (16, 48, 64)   # ... or, VAEHRNet's 46 and 53, to 48, 64
# the (forward, backward) kernels at each input width
STEM_KERNELS = {16: (STEM_FWD, STEM_BWD), 48: (STEM48_FWD, STEM48_BWD),
                64: (STEM64_FWD, STEM64_BWD)}


# ---- plain versions -------------------------------------------------------

def _lrelu(v: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(v, 0.2)


def _masked(pre: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """lrelu vjp: g where pre >= 0, else 0.2 * g (in g's dtype)."""
    return torch.where(pre >= 0, g, 0.2 * g)


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 conv of NHWC x with an OIHW weight: f32 accumulation of
    compute-dtype operands, rounded to x's dtype; on a band with its
    neighbours' rows (``spatial.conv2d``)."""
    dt = x.dtype
    return nhwc(spatial.conv2d(nchw(x).float(), w.to(dt).float(),
                               padding=1)).to(dt)


def _conv_t(g: torch.Tensor, w: torch.Tensor, cin: int) -> torch.Tensor:
    """Input grad of ``_conv`` (the transposed conv), f32, NHWC."""
    b, h, wd, _ = g.shape
    return nhwc(torch.nn.grad.conv2d_input(
        (b, cin, h, wd), w.to(g.dtype).float(), nchw(g).float(), padding=1))


def _conv_wgrad(x: torch.Tensor, g: torch.Tensor, shape) -> torch.Tensor:
    """Weight grad of ``_conv``, f32, OIHW."""
    return torch.nn.grad.conv2d_weight(nchw(x).float(), shape,
                                       nchw(g).float(), padding=1)


def _mat(w: torch.Tensor) -> torch.Tensor:
    """(O, I, 1, 1) weight -> (O, I)."""
    return w[:, :, 0, 0]


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC 1x1 conv a . w, f32 accumulation, rounded to a's dtype."""
    dt = a.dtype
    return torch.matmul(a.float(), _mat(w).to(dt).float().t()).to(dt)


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1]).float()


def stem_plain(x, k1, b1, k2, b2):
    """x (B,H,W,Ci) in the compute dtype; k1 (P,Ci,3,3), b1 (P,),
    k2 (P,P,3,3), b2 (P,).  Returns y (B,H,W,P)."""
    dt = x.dtype
    s1 = _lrelu(_conv(x, k1) + b1.to(dt))
    return _lrelu(_conv(s1, k2) + b2.to(dt))


def stem_bwd_plain(x, dy, k1, b1, k2, b2):
    """Hand-written backward of ``stem_plain`` (``_stem_bwd_kernel``,
    pallas_trainchain.py:482-508): pre1, s1 and pre2 recomputed, the lrelu
    masks from the pre-activations' signs.  Returns (dx in x's dtype; dk1,
    db1, dk2, db2 in f32)."""
    dt = x.dtype
    pre1 = _conv(x, k1) + b1.to(dt)
    s1 = _lrelu(pre1)
    pre2 = _conv(s1, k2) + b2.to(dt)
    return _stem_bwd(x, dy, s1, pre1, pre2, k1, k2)


def stem_bwd_saved_plain(x, dy, s1, y, k1, b1, k2, b2):
    """The same backward from what the forward kept, as the backward
    kernel computes it: s1 and y, whose signs are the lrelu masks (a bf16
    lrelu keeps the sign, so they are the pre-activations' masks but at
    -0.0).  x: the stem input, or its copy zero-padded to 16 channels.
    What the card holds the backward kernel against."""
    return _stem_bwd(x[..., :k1.shape[1]], dy, s1, s1, y, k1, k2)


def _stem_bwd(x, dy, s1, m1, m2, k1, k2):
    """The stem's backward with the lrelu masks from the signs of m1 (pre1
    or s1) and m2 (pre2 or y)."""
    dt = x.dtype
    dpre2 = _masked(m2, dy.to(dt))
    db2 = _flat(dpre2).sum(0)
    dk2 = _conv_wgrad(s1, dpre2, tuple(k2.shape))
    ds1 = _conv_t(dpre2, k2, s1.shape[-1]).to(dt)
    dpre1 = _masked(m1, ds1)
    db1 = _flat(dpre1).sum(0)
    dk1 = _conv_wgrad(x, dpre1, tuple(k1.shape))
    dx = _conv_t(dpre1, k1, x.shape[-1]).to(dt)
    return dx, dk1, db1, dk2, db2


def bottleneck_plain(x, k1, k2, k3, kres=None):
    """x (B,H,W,Ci) in the compute dtype; k1 (P,Ci,1,1), k2 (P,P,3,3),
    k3 (Co,P,1,1), kres (Co,Ci,1,1) or None (then Ci == Co).  Returns y
    (B,H,W,Co)."""
    h1 = _lrelu(_dot(x, k1))
    h2 = _lrelu(_conv(h1, k2))
    res = _dot(x, kres) if kres is not None else x
    return _lrelu(_dot(h2, k3) + res)


def bottleneck_bwd_plain(x, dy, k1, k2, k3, kres=None):
    """Hand-written backward of ``bottleneck_plain`` (``_bn_bwd_kernel``,
    pallas_trainchain.py:261-315).  Returns (dx in x's dtype; dk1, dk2,
    dk3, dkres (None without kres) in f32)."""
    dt = x.dtype
    h1 = _lrelu(_dot(x, k1))
    h2 = _lrelu(_conv(h1, k2))
    res = _dot(x, kres) if kres is not None else x
    pre_y = _dot(h2, k3) + res
    dpre_y = _masked(pre_y, dy.to(dt))
    dh2 = torch.matmul(dpre_y.float(), _mat(k3).to(dt).float()).to(dt)
    dpre2 = _masked(h2, dh2)
    dh1 = _conv_t(dpre2, k2, h1.shape[-1]).to(dt)
    dpre1 = _masked(h1, dh1)
    dx = torch.matmul(dpre1.float(), _mat(k1).to(dt).float())
    if kres is not None:
        dx = dx + torch.matmul(dpre_y.float(), _mat(kres).to(dt).float())
    else:
        dx = dx + dpre_y.float()
    dk1, dk2, dk3, dkres = bottleneck_wgrad_plain(
        x, h1, h2, dpre2, dpre1, dpre_y, kres is not None)
    return dx.to(dt), dk1, dk2, dk3, dkres


def bottleneck_wgrad_plain(x, h1, h2, dpre2, dpre1, dpre_y, has_res=None):
    """The Bottleneck's weight grads from its backward's operands (x;
    h1, h2, dpre2, dpre1 at P channels; dpre_y at Co), each a sum over
    pixels in f32: (dk1, dk2, dk3, dkres) OIHW f32, dkres None without the
    projection residual (by default: Ci == Co)."""
    if has_res is None:
        has_res = x.shape[-1] != CO
    dk1 = (_flat(dpre1).t() @ _flat(x))[:, :, None, None]
    dk2 = _conv_wgrad(h1, dpre2, (P, P, 3, 3))
    dk3 = (_flat(dpre_y).t() @ _flat(h2))[:, :, None, None]
    dkres = ((_flat(dpre_y).t() @ _flat(x))[:, :, None, None] if has_res
             else None)
    return dk1, dk2, dk3, dkres


# ---- kernel wrappers ------------------------------------------------------

def _check_pixels(b, h, w):
    if b * h * w >= 2**31 - 4096:
        raise ValueError("kernels index pixels with 32-bit ints: "
                         f"{b}x{h}x{w} is too many")


def _bf(t: torch.Tensor, dev) -> torch.Tensor:
    return t.to(device=dev, dtype=torch.bfloat16).contiguous()


def _taps(w: torch.Tensor, dev) -> torch.Tensor:
    """OIHW 3x3 weight -> (9, I, O) bf16: tap ky*3+kx, K rows, N cols."""
    return _bf(w.permute(2, 3, 1, 0).reshape(9, w.shape[1], w.shape[0]), dev)


def _taps_t(w: torch.Tensor, dev) -> torch.Tensor:
    """The transposed conv as a SAME conv: (9, O, I) bf16 with the taps
    flipped, so conv3x3(g, _taps_t(w)) == conv2d_input(g, w)."""
    return _bf(w.flip(2, 3).permute(2, 3, 0, 1).reshape(9, w.shape[0],
                                                        w.shape[1]), dev)


def stem_cin_pad(ci: int) -> int:
    """The input width of the stem kernels that take ``ci`` channels: 16
    (HRNet's 14), 48 (VAEHRNet's 46) or 64 (VAEHRNet's 53 in extrapolation
    with three input frames); raises above 64."""
    for cp in STEM_CIN_PADS:
        if ci <= cp:
            return cp
    raise ValueError(f"stem kernel takes Ci <= {STEM_CIN_PADS[-1]}, got {ci}")


def _pad_to(t: torch.Tensor, cp: int) -> torch.Tensor:
    return F.pad(t, (0, cp - t.shape[-1])).contiguous()


def _pad16(t: torch.Tensor) -> torch.Tensor:
    return _pad_to(t, STEM_CIN_PAD)


def stem_units(k1, b1, k2, b2, dev) -> dict:
    """The stem kernels' weights, bf16 on ``dev``, built once per weight
    set (``hw.derived``: a train step's forward and backward share them),
    as tap units (tap ky*3+kx; (k-group, n, k) in the no-swizzle K-major
    core-matrix order of csrc/hopper.cuh), in the order the kernels keep
    them, at the kernels' input width cp (``stem_cin_pad``, 16, 48, 64):
    ``w1u`` k1 (9, cp/8, 64, 8), its input channels zero-padded to cp;
    ``w2u`` k2 (9, 8, 64, 8); ``w2f`` and ``wxf`` the flipped, transposed
    k2 (9, 8, 64, 8) and k1 (9, 8, cp, 8) of the backward (the transposed
    convs as SAME convs); ``b1``, ``b2``."""
    cp = stem_cin_pad(k1.shape[1])

    def build():
        k1p = F.pad(k1, (0, 0, 0, 0, 0, cp - k1.shape[1]))
        return dict(
            w1u=_taps(k1p, dev).reshape(9, cp // 8, 8, P).permute(0, 1, 3, 2)
            .contiguous(),
            w2u=_tap_units(_taps(k2, dev)).contiguous(),
            w2f=_tap_units(_taps_t(k2, dev)).contiguous(),
            wxf=_taps_t(k1p, dev).reshape(9, 8, 8, cp)
            .permute(0, 1, 3, 2).contiguous(),
            b1=_bf(b1, dev), b2=_bf(b2, dev))
    return hw.derived(f"stem:{dev}", (k1, b1, k2, b2), build)


def stem_tiles(b: int, h: int, w: int) -> int:
    """The stem kernels' 8x16 pixel tiles of a (b, h, w) input; raises
    ``ValueError`` for an empty input or too many pixels for the kernels'
    32-bit indices.  Ragged edges are masked in the kernels, so every other
    shape is taken."""
    if min(b, h, w) < 1:
        raise ValueError(f"stem kernel: empty input {b}x{h}x{w}")
    _check_pixels(b, h, w)
    return b * -(-h // 8) * -(-w // 16)


def stem_wgrad_splits(b: int, h: int, w: int, cp: int = STEM_CIN_PAD
                      ) -> Tuple[int, int]:
    """Pixel ranges of the stem's weight-grad launch: s0 for dk2 and db2,
    s1 for dk1 and db1, together one block per SM of an H100 (132), at
    least one tile (dk1 at cp 16: three) per range.  At cp 16 dk1 is a
    third of dk2's work a tile (16 input channels against 64, three tiles
    a step): 99 and 33.  At cp 48 and 64 a dk1 step is dk2's (one tile,
    the channels in 64 rows): 66 and 66."""
    tiles = stem_tiles(b, h, w)
    if cp != STEM_CIN_PAD:
        return max(1, min(66, tiles)), max(1, min(66, tiles))
    return max(1, min(99, tiles)), max(1, min(33, -(-tiles // 3)))


def _check_stem(x, k1, k2):
    b, h, w, ci = x.shape
    cin = k1.shape[1]
    if cin > STEM_CIN_PADS[-1] or ci not in (cin, stem_cin_pad(cin)) \
            or tuple(k1.shape) != (P, cin, 3, 3) \
            or tuple(k2.shape) != (P, P, 3, 3):
        raise ValueError(f"stem kernel takes Ci <= {STEM_CIN_PAD} (x "
                         f"padded to {STEM_CIN_PAD}) or Ci <= "
                         f"{STEM_CIN_PADS[-1]} (x padded to "
                         f"{STEM_CIN_PADS[-1]}), P = {P}: "
                         f"x {tuple(x.shape)}, k1 {tuple(k1.shape)}, "
                         f"k2 {tuple(k2.shape)}")
    stem_tiles(b, h, w)
    hw.check_bf16("x", x)


def _launch(fn: str, count: str, like: torch.Tensor, *args) -> None:
    """Call the exported C function ``dvie_{fn}``: tensors go as device
    pointers (None as NULL), ints as ints, then the stream of ``like``'s
    device; add one to the launch counter ``count``.  ``args`` holds every
    operand until the launch is queued."""
    ptrs = [_build.ptr(a) if a is None or torch.is_tensor(a) else a
            for a in args]
    _build.check_launch(fn, getattr(_build.library(), f"dvie_{fn}")(
        *ptrs, _build.stream(like)))
    hw.launches[count] += 1


def _call(name: str, *args) -> None:
    """``_launch`` of ``dvie_{name}`` on the first tensor's stream, counted
    under ``name``."""
    _launch(name, name, next(a for a in args if torch.is_tensor(a)), *args)


def _stem_fwd(xp, k1, b1, k2, b2, save):
    """The forward launch on x zero-padded to the kernels' width (16: the
    ``stem_fwd`` kernel, 48: ``stem48_fwd``, 64: ``stem64_fwd``)."""
    b, h, w, cp = xp.shape
    wt = stem_units(k1, b1, k2, b2, xp.device)
    act = dict(device=xp.device, dtype=torch.bfloat16)
    y = torch.empty((b, h, w, P), **act)
    s1 = torch.empty((b, h, w, P), **act) if save else None
    _call(STEM_KERNELS[cp][0], xp, wt["w1u"],
          wt["b1"], wt["w2u"], wt["b2"], y, s1, b, h, w)
    return y, s1


def stem_fwd_kernel(x, k1, b1, k2, b2, save=False):
    """The stem forward on the card (``csrc/trainchain_stem.cu``), one
    launch: y, or (y, s1) with ``save`` (s1 stored for the backward)."""
    _check_stem(x, k1, k2)
    y, s1 = _stem_fwd(_pad_to(x, stem_cin_pad(k1.shape[1])), k1, b1, k2,
                      b2, save)
    return (y, s1) if save else y


def stem_wgrads(dk2p, dk1p, dbp, s0, ci):
    """The weight-grad launch's f32 partials -> (dk1, db1, dk2, db2), dk1
    and dk2 OIHW: dk2p (s0, 9, 64, 64) and dk1p (n, 9, cp, 64) [tap, input
    channel, output channel] summed over pixel ranges, dk1 cut to ``ci``
    input channels; the first s0 rows of dbp (s0 + s1, 64) db2's, the rest
    db1's."""
    dk2 = dk2p.sum(0).reshape(3, 3, P, P).permute(3, 2, 0, 1).contiguous()
    dk1 = dk1p.sum(0).reshape(3, 3, dk1p.shape[2], P).permute(3, 2, 0, 1)
    return (dk1[:, :ci].contiguous(), dbp[s0:].sum(0), dk2,
            dbp[:s0].sum(0))


def stem_bwd_kernel(x, dy, s1, y, k1, b1, k2, b2):
    """The stem backward on the card from what the forward kept (s1, y):
    one launch for dx (storing dpre2 and dpre1), one for the f32 weight and
    bias grads, whose partials are summed here.  x: the stem input, or its
    copy zero-padded to the kernels' width (16, or 48 or 64 for more than
    16 input channels); dx has k1's input channels."""
    _check_stem(x, k1, k2)
    b, h, w, _ = x.shape
    ci = k1.shape[1]
    for name, t in (("dy", dy), ("s1", s1), ("y", y)):
        hw.check_bf16(name, t, (b, h, w, P))
    dev = x.device
    cp = stem_cin_pad(ci)
    xp = x if x.shape[-1] == cp else _pad_to(x, cp)
    wt = stem_units(k1, b1, k2, b2, dev)
    act = dict(device=dev, dtype=torch.bfloat16)
    dpre2, dpre1 = (torch.empty((b, h, w, P), **act) for _ in range(2))
    dx = torch.empty((b, h, w, ci), **act)
    s0, s1n = stem_wgrad_splits(b, h, w, cp)
    f32 = dict(device=dev, dtype=torch.float32)
    dk2p = torch.empty((s0, 9, P, P), **f32)
    dk1p = torch.empty(((3 if cp == STEM_CIN_PAD else 1) * s1n, 9, cp, P),
                       **f32)
    dbp = torch.empty((s0 + s1n, P), **f32)
    _call(STEM_KERNELS[cp][1], dy, y, s1, xp,
          wt["w2f"], wt["wxf"], dpre2, dpre1, dx, dk2p, dk1p, dbp, b, h, w,
          ci, s0, s1n)
    return (dx, *stem_wgrads(dk2p, dk1p, dbp, s0, ci))


def _check_bottleneck(x, k1, k2, k3, kres):
    b, h, w, ci = x.shape
    if (tuple(k1.shape) != (P, ci, 1, 1) or tuple(k2.shape) != (P, P, 3, 3)
            or tuple(k3.shape) != (CO, P, 1, 1)):
        raise ValueError(f"bottleneck kernel takes P = {P}, Co = {CO}: x "
                         f"{tuple(x.shape)}, k1 {tuple(k1.shape)}, k2 "
                         f"{tuple(k2.shape)}, k3 {tuple(k3.shape)}")
    if (ci, kres is None) not in ((P, False), (CO, True)):
        raise ValueError(f"bottleneck kernel takes Ci = {P} with kres or Ci "
                         f"= {CO} without, got Ci = {ci}, kres "
                         f"{'given' if kres is not None else 'None'}")
    if kres is not None and tuple(kres.shape) != (CO, ci, 1, 1):
        raise ValueError(f"kres {tuple(kres.shape)} for Ci={ci}")
    if min(b, h, w) < 1:
        raise ValueError(f"bottleneck kernel: empty input {b}x{h}x{w}")
    _check_pixels(b, h, w)
    hw.check_bf16("x", x)


def _blocks(wm: torch.Tensor) -> torch.Tensor:
    """(K, N) matrix, K and N multiples of 64 -> its (64 x 64) weight units
    (K/64, N/64, 8, 64, 8): wm[kc*64 + 8*kg + k, nc*64 + n] at [kc, nc,
    kg, n, k], the no-swizzle K-major core-matrix order (csrc/hopper.cuh)."""
    k, n = wm.shape
    return (wm.reshape(k // 64, 8, 8, n // 64, 64).permute(0, 3, 1, 4, 2)
            .contiguous())


def _tap_units(taps: torch.Tensor) -> torch.Tensor:
    """(9, 64, 64) taps (K rows, N columns) -> their units (9, 8, 64, 8)."""
    return taps.reshape(9, 8, 8, P).permute(0, 1, 3, 2)


def bottleneck_units(k1, k2, k3, kres, dev, bwd: bool = False,
                     k1_next=None) -> torch.Tensor:
    """The weight units of a Bottleneck kernel, bf16 (U, 8, 64, 8), in the
    order a tile takes them: k1 per 64 input channels (none for None, the
    tail kernel of ops/bottleneck_tail.py); k2's nine taps; then per 64
    outputs nc k3, kres per 64 input channels, and either k3^T in the
    backward (``bwd``: dh2 = dpre_y . k3^T) or the next block's k1 rows
    [64 nc, 64 nc + 64) (``k1_next``: h1_next = y . k1_next)."""
    def blocks(k, t=True):   # (O, I, 1, 1) -> its (I, O) matrix's units
        return None if k is None else _blocks(
            _bf(_mat(k).t() if t else _mat(k), dev))

    b1, b3, br, bn = blocks(k1), blocks(k3), blocks(kres), blocks(k1_next)
    b3t = blocks(k3, t=False) if bwd else None
    seq = [] if b1 is None else [b1[kc, 0] for kc in range(b1.shape[0])]
    seq += list(_tap_units(_taps(k2, dev)))
    for nc in range(CO // 64):
        seq.append(b3[0, nc])
        if br is not None:
            seq += [br[kc, nc] for kc in range(br.shape[0])]
        if b3t is not None:
            seq.append(b3t[nc, 0])
        if bn is not None:
            seq.append(bn[nc, 0])
    return torch.stack(seq).contiguous()


def bottleneck_back_units(k1, k2, kres, dev) -> torch.Tensor:
    """The weight units of the second backward launch, bf16 (U, 8, 64, 8):
    k2's flipped transposed taps (conv_t as a SAME conv), then per 64
    input channels k1^T and kres^T per 64 of its 256 rows."""
    b1t = _blocks(_bf(_mat(k1), dev))
    brt = _blocks(_bf(_mat(kres), dev)) if kres is not None else None
    seq = list(_tap_units(_taps_t(k2, dev)))
    for cc in range(b1t.shape[1]):
        seq.append(b1t[0, cc])
        if brt is not None:
            seq += [brt[kc, cc] for kc in range(CO // 64)]
    return torch.stack(seq).contiguous()


def bottleneck_fwd_kernel(x, k1, k2, k3, kres=None):
    """The Bottleneck forward on the card (``csrc/trainchain_bottleneck.cu``)."""
    _check_bottleneck(x, k1, k2, k3, kres)
    b, h, w, ci = x.shape
    y = torch.empty((b, h, w, CO), device=x.device, dtype=torch.bfloat16)
    _call(BN_FWD, x, bottleneck_units(k1, k2, k3, kres, x.device), y,
          b, h, w, ci)
    return y


def wgrad_splits(b: int, h: int, w: int) -> Tuple[int, int]:
    """Pixel ranges of the weight-grad launch's two jobs (dk2's taps; the
    1x1 grads, about four times the bytes): together one block per SM of
    an H100 (132), in that ratio, at least one 8x16 tile per range."""
    tiles = b * -(-h // 8) * -(-w // 16)
    return max(1, min(26, tiles)), max(1, min(106, 2 * tiles))


def bottleneck_wgrad_kernel(x, h1, h2, dpre2, dpre1, dpre_y):
    """The four weight grads in one launch from what the backward stored
    (a sum over pixels of a(p)^T . d(p) per weight): (dk1, dk2, dk3,
    dkres or None), f32 OIHW."""
    b, h, w, ci = x.shape
    if ci not in (P, CO) or min(b, h, w) < 1:
        raise ValueError(f"bottleneck weight-grad kernel takes Ci in "
                         f"({P}, {CO}), got x {tuple(x.shape)}")
    _check_pixels(b, h, w)
    hw.check_bf16("x", x)
    for name, t in (("h1", h1), ("h2", h2), ("dpre2", dpre2),
                    ("dpre1", dpre1)):
        hw.check_bf16(name, t, (b, h, w, P))
    hw.check_bf16("dpre_y", dpre_y, (b, h, w, CO))
    nk = ci // 64
    s0, s1 = wgrad_splits(b, h, w)
    pk = torch.empty((s0 + s1, 9, P, P), device=x.device,
                     dtype=torch.float32)
    _launch(BN_WGRAD, BN_WGRAD, x, x, h1, h2, dpre2, dpre1, dpre_y, pk,
            b, h, w, ci, s0, s1)
    part = (pk[:s0].sum(0), pk[s0:].sum(0))
    dk2 = part[0].reshape(3, 3, P, P).permute(3, 2, 0, 1).contiguous()
    dk1 = part[1][:nk].reshape(ci, P).t()[:, :, None, None].contiguous()

    def per_output(slots):   # (4, a channel, 64 outputs) -> (256, a channel)
        return slots.permute(0, 2, 1).reshape(CO, -1)[:, :, None, None]

    dk3 = per_output(part[1][nk:nk + 4]).contiguous()
    dkres = per_output(part[1][5:9]).contiguous() if ci == P else None
    return dk1, dk2, dk3, dkres


def bottleneck_bwd_kernel(x, dy, k1, k2, k3, kres=None):
    """The Bottleneck backward on the card: two launches for dx (see the
    .cu note), then one for the four weight grads."""
    _check_bottleneck(x, k1, k2, k3, kres)
    hw.check_bf16("dy", dy, (*x.shape[:3], CO))
    b, h, w, ci = x.shape
    dev = x.device
    act = dict(device=dev, dtype=torch.bfloat16)
    h1, h2, dpre2, dpre1 = (torch.empty((b, h, w, P), **act) for _ in range(4))
    dpre_y = torch.empty((b, h, w, CO), **act)
    dx = torch.empty((b, h, w, ci), **act)
    _call(BN_BWD, x, dy, bottleneck_units(k1, k2, k3, kres, dev, bwd=True),
          bottleneck_back_units(k1, k2, kres, dev), h1, h2, dpre_y, dpre2,
          dpre1, dx, b, h, w, ci)
    return (dx, *bottleneck_wgrad_kernel(x, h1, h2, dpre2, dpre1, dpre_y))


# ---- autograd -------------------------------------------------------------

def _grad_like(g: Optional[torch.Tensor], p: Optional[torch.Tensor]):
    return None if g is None or p is None else g.to(p.dtype)


class _Stem(torch.autograd.Function):
    """On the card the forward keeps the zero-padded x, y and, when a
    backward will run (``save``), s1; the backward kernel reads them and
    recomputes nothing.  On the CPU the plain backward recomputes from x."""

    @staticmethod
    def forward(ctx, x, k1, b1, k2, b2, save):
        ctx.kernel = hw.use_kernel(x)
        if not ctx.kernel:
            ctx.save_for_backward(x, k1, b1, k2, b2)
            return stem_plain(x, k1, b1, k2, b2)
        _check_stem(x, k1, k2)
        xp = _pad_to(x, stem_cin_pad(k1.shape[1]))
        y, s1 = _stem_fwd(xp, k1, b1, k2, b2, save)
        if save:
            ctx.save_for_backward(xp, y, s1, k1, b1, k2, b2)
        return y

    @staticmethod
    def backward(ctx, dy):
        if ctx.kernel:
            xp, y, s1, k1, b1, k2, b2 = ctx.saved_tensors
            grads = stem_bwd_kernel(xp, dy.contiguous(), s1, y, k1, b1, k2,
                                    b2)
        else:
            x, k1, b1, k2, b2 = ctx.saved_tensors
            grads = stem_bwd_plain(x, dy.contiguous(), k1, b1, k2, b2)
        dx, dk1, db1, dk2, db2 = grads
        return (dx, _grad_like(dk1, k1), _grad_like(db1, b1),
                _grad_like(dk2, k2), _grad_like(db2, b2), None)


class _Bottleneck(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k1, k2, k3, kres):
        ctx.save_for_backward(x, k1, k2, k3, kres)
        if hw.use_kernel(x):
            return bottleneck_fwd_kernel(x, k1, k2, k3, kres)
        return bottleneck_plain(x, k1, k2, k3, kres)

    @staticmethod
    def backward(ctx, dy):
        x, k1, k2, k3, kres = ctx.saved_tensors
        bwd = (bottleneck_bwd_kernel if hw.use_kernel(x)
               else bottleneck_bwd_plain)
        dx, dk1, dk2, dk3, dkres = bwd(x, dy.contiguous(), k1, k2, k3, kres)
        return (dx, _grad_like(dk1, k1), _grad_like(dk2, k2),
                _grad_like(dk3, k3), _grad_like(dkres, kres))


def stem(x: torch.Tensor, k1: torch.Tensor, b1: torch.Tensor,
         k2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Both stem convs; differentiable.  Kernels for a CUDA bf16 ``x``,
    the plain versions for a CPU one.  The forward kernel stores s1 only
    when a backward can follow (grad enabled and an input requiring it)."""
    save = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, k1, b1, k2, b2))
    return _Stem.apply(x, k1, b1, k2, b2, save)


def bottleneck(x: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
               k3: torch.Tensor, kres: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """One whole Bottleneck; differentiable.  Kernels for a CUDA bf16
    ``x``, the plain versions for a CPU one."""
    return _Bottleneck.apply(x, k1, k2, k3, kres)


def stem_layer1(x: torch.Tensor, stem_params: Tuple, block_params,
                kernels: bool = True) -> torch.Tensor:
    """The stem then the Bottlenecks (``stem_layer1_chain``,
    pallas_trainchain.py:797): stem_params = (k1, b1, k2, b2),
    block_params = [(k1, k2, k3, kres or None), ...].  ``kernels=False``
    runs the plain forwards, differentiated by autograd (the plain
    model)."""
    stem_fn, block_fn = ((stem, bottleneck) if kernels
                         else (stem_plain, bottleneck_plain))
    x = stem_fn(x, *stem_params)
    for k1, k2, k3, kres in block_params:
        x = block_fn(x, k1, k2, k3, kres)
    return x
