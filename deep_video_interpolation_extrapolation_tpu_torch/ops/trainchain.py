"""The stem + layer1 train chain: forward and backward kernels, NHWC.

Counterpart of ``ops/pallas_trainchain.packed_stem`` and
``packed_bottleneck`` (each a ``jax.custom_vjp`` pair of Pallas kernels):

    stem:        s1 = lrelu(conv3x3(x, k1) + b1);  y = lrelu(conv3x3(s1, k2) + b2)
    bottleneck:  h1 = lrelu(x . k1);  h2 = lrelu(conv3x3(h1, k2));
                 y  = lrelu(h2 . k3 + (x . kres  if kres is given  else x))

The forward kernels keep s1 / h1 and h2 on chip; the backward kernels
recompute them from the saved block input and return dx in the compute
dtype and f32 weight grads.  The kernels are ``csrc/trainchain_stem.cu`` and
``csrc/trainchain_bottleneck.cu``; their notes say how each pass is split
into launches.

Rounding follows the JAX kernels (pallas_trainchain.py module docstring):
every product is an f32-accumulated product of compute-dtype operands,
rounded to the compute dtype before a bias or residual add; bias and
residual adds and the lrelu run in the compute dtype; the lrelu masks of
the backward come from the recomputed pre-activation signs; dx is rounded
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

STEM_FWD, STEM_BWD = "stem_fwd", "stem_bwd"
BN_FWD, BN_BWD = "bottleneck_fwd", "bottleneck_bwd"
P, CO = 64, 256      # layer1 widths: planes and planes * expansion
STEM_CIN_PAD = 16    # the stem kernels take x zero-padded to 16 channels


# ---- plain versions -------------------------------------------------------

def _lrelu(v: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(v, 0.2)


def _masked(pre: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """lrelu vjp: g where pre >= 0, else 0.2 * g (in g's dtype)."""
    return torch.where(pre >= 0, g, 0.2 * g)


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 conv of NHWC x with an OIHW weight: f32 accumulation of
    compute-dtype operands, rounded to x's dtype."""
    dt = x.dtype
    return nhwc(F.conv2d(nchw(x).float(), w.to(dt).float(), padding=1)).to(dt)


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
    pallas_trainchain.py:482-508).  Returns (dx in x's dtype; dk1, db1,
    dk2, db2 in f32)."""
    dt = x.dtype
    pre1 = _conv(x, k1) + b1.to(dt)
    s1 = _lrelu(pre1)
    pre2 = _conv(s1, k2) + b2.to(dt)
    dpre2 = _masked(pre2, dy.to(dt))
    db2 = _flat(dpre2).sum(0)
    dk2 = _conv_wgrad(s1, dpre2, tuple(k2.shape))
    ds1 = _conv_t(dpre2, k2, s1.shape[-1]).to(dt)
    dpre1 = _masked(pre1, ds1)
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
    dk3 = (_flat(dpre_y).t() @ _flat(h2))[:, :, None, None]
    dh2 = torch.matmul(dpre_y.float(), _mat(k3).to(dt).float()).to(dt)
    dpre2 = _masked(h2, dh2)
    dk2 = _conv_wgrad(h1, dpre2, tuple(k2.shape))
    dh1 = _conv_t(dpre2, k2, h1.shape[-1]).to(dt)
    dpre1 = _masked(h1, dh1)
    dk1 = (_flat(dpre1).t() @ _flat(x))[:, :, None, None]
    dx = torch.matmul(dpre1.float(), _mat(k1).to(dt).float())
    dkres = None
    if kres is not None:
        dkres = (_flat(dpre_y).t() @ _flat(x))[:, :, None, None]
        dx = dx + torch.matmul(dpre_y.float(), _mat(kres).to(dt).float())
    else:
        dx = dx + dpre_y.float()
    return dx.to(dt), dk1, dk2, dk3, dkres


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


def _splits(tiles: int, m: int) -> int:
    """Pixel splits of the weight-grad launch: about two blocks per SM of
    an H100 (132 SMs), at least 64 pixels per split."""
    return max(1, min(-(-264 // tiles), m // 64))


def _pad16(t: torch.Tensor) -> torch.Tensor:
    return F.pad(t, (0, STEM_CIN_PAD - t.shape[-1])).contiguous()


def _stem_weights(x, k1, b1, k2, b2):
    dev = x.device
    k1p = F.pad(k1, (0, 0, 0, 0, 0, STEM_CIN_PAD - k1.shape[1]))
    return dict(w1=_taps(k1p, dev), b1=_bf(b1, dev), w2=_taps(k2, dev),
                b2=_bf(b2, dev), k1p=k1p)


def _check_stem(x, k1, k2):
    b, h, w, ci = x.shape
    if ci > STEM_CIN_PAD or tuple(k1.shape) != (P, ci, 3, 3) \
            or tuple(k2.shape) != (P, P, 3, 3):
        raise ValueError(f"stem kernel takes Ci <= {STEM_CIN_PAD}, P = {P}: "
                         f"x {tuple(x.shape)}, k1 {tuple(k1.shape)}, "
                         f"k2 {tuple(k2.shape)}")
    _check_pixels(b, h, w)
    hw.check_bf16("x", x)


def _call(name: str, *args) -> None:
    """Call the exported C function ``name``: tensors go as device
    pointers (None as NULL), ints as ints, then the stream of the first
    tensor.  ``args`` holds every operand until the launch is queued."""
    ptrs = [_build.ptr(a) if a is None or torch.is_tensor(a) else a
            for a in args]
    stream = _build.stream(next(a for a in args if torch.is_tensor(a)))
    _build.check_launch(name, getattr(_build.library(), f"dvie_{name}")(
        *ptrs, stream))
    hw.launches[name] += 1


def stem_fwd_kernel(x, k1, b1, k2, b2):
    """The stem forward on the card (``csrc/trainchain_stem.cu``)."""
    _check_stem(x, k1, k2)
    b, h, w, _ = x.shape
    wt = _stem_weights(x, k1, b1, k2, b2)
    y = torch.empty((b, h, w, P), device=x.device, dtype=torch.bfloat16)
    _call(STEM_FWD, _pad16(x), wt["w1"], wt["b1"], wt["w2"], wt["b2"], y,
          b, h, w)
    return y


def stem_bwd_kernel(x, dy, k1, b1, k2, b2):
    """The stem backward on the card: three launches (see the .cu note),
    then the f32 weight-grad partials summed here."""
    _check_stem(x, k1, k2)
    hw.check_bf16("dy", dy, (*x.shape[:3], P))
    b, h, w, ci = x.shape
    dev = x.device
    wt = _stem_weights(x, k1, b1, k2, b2)
    act = dict(device=dev, dtype=torch.bfloat16)
    dpre2, s1, dpre1 = (torch.empty((b, h, w, P), **act) for _ in range(3))
    dx16 = torch.empty((b, h, w, STEM_CIN_PAD), **act)
    s = _splits(20, b * h * w)
    f32 = dict(device=dev, dtype=torch.float32)
    pk1 = torch.empty((s, 9, STEM_CIN_PAD, P), **f32)
    pk2 = torch.empty((s, 9, P, P), **f32)
    pb1 = torch.empty((s, STEM_CIN_PAD, P), **f32)
    pb2 = torch.empty((s, STEM_CIN_PAD, P), **f32)
    _call(STEM_BWD, _pad16(x), dy, wt["w1"], wt["b1"], wt["w2"], wt["b2"],
          _taps_t(wt["k1p"], dev), _taps_t(k2, dev), dpre2, s1, dpre1, dx16,
          pk1, pb1, pk2, pb2, b, h, w, s)
    dk1 = pk1.sum(0).reshape(3, 3, STEM_CIN_PAD, P).permute(3, 2, 0, 1)
    dk2 = pk2.sum(0).reshape(3, 3, P, P).permute(3, 2, 0, 1)
    return (dx16[..., :ci].contiguous(), dk1[:, :ci].contiguous(),
            pb1.sum(0)[0], dk2.contiguous(), pb2.sum(0)[0])


def _check_bottleneck(x, k1, k2, k3, kres):
    b, h, w, ci = x.shape
    if (ci % 64 or tuple(k1.shape) != (P, ci, 1, 1)
            or tuple(k2.shape) != (P, P, 3, 3)
            or tuple(k3.shape) != (CO, P, 1, 1)):
        raise ValueError(f"bottleneck kernel takes Ci % 64 == 0, P = {P}, "
                         f"Co = {CO}: x {tuple(x.shape)}, k1 "
                         f"{tuple(k1.shape)}, k2 {tuple(k2.shape)}, k3 "
                         f"{tuple(k3.shape)}")
    if kres is None and ci != CO:
        raise ValueError(f"identity residual needs Ci == {CO}, got {ci}")
    if kres is not None and tuple(kres.shape) != (CO, ci, 1, 1):
        raise ValueError(f"kres {tuple(kres.shape)} for Ci={ci}")
    _check_pixels(b, h, w)
    hw.check_bf16("x", x)


def bottleneck_fwd_kernel(x, k1, k2, k3, kres=None):
    """The Bottleneck forward on the card (``csrc/trainchain_bottleneck.cu``)."""
    _check_bottleneck(x, k1, k2, k3, kres)
    b, h, w, ci = x.shape
    dev = x.device
    y = torch.empty((b, h, w, CO), device=dev, dtype=torch.bfloat16)
    wres = _bf(_mat(kres).t(), dev) if kres is not None else None
    _call(BN_FWD, x, _bf(_mat(k1).t(), dev), _taps(k2, dev),
          _bf(_mat(k3).t(), dev), wres, y, b, h, w, ci)
    return y


def bottleneck_bwd_kernel(x, dy, k1, k2, k3, kres=None):
    """The Bottleneck backward on the card: three launches (see the .cu
    note), then the f32 weight-grad partials summed here."""
    _check_bottleneck(x, k1, k2, k3, kres)
    hw.check_bf16("dy", dy, (*x.shape[:3], CO))
    b, h, w, ci = x.shape
    dev = x.device
    act = dict(device=dev, dtype=torch.bfloat16)
    h1, h2, dpre2, dpre1 = (torch.empty((b, h, w, P), **act) for _ in range(4))
    dpre_y = torch.empty((b, h, w, CO), **act)
    dx = torch.empty((b, h, w, ci), **act)
    has_res = kres is not None
    s = _splits(ci // 64 + 9 + CO // 64 + (ci // 64) * (CO // 64) * has_res,
                b * h * w)
    f32 = dict(device=dev, dtype=torch.float32)
    pk1 = torch.empty((s, ci, P), **f32)
    pk2 = torch.empty((s, 9, P, P), **f32)
    pk3 = torch.empty((s, P, CO), **f32)
    pkres = torch.empty((s, ci, CO), **f32) if has_res else None
    w1, w3 = _mat(k1).t(), _mat(k3).t()
    wres = _mat(kres).t() if has_res else None
    _call(BN_BWD, x, dy, _bf(w1, dev), _taps(k2, dev), _bf(w3, dev),
          _bf(wres, dev) if has_res else None, _bf(w1.t(), dev),
          _taps_t(k2, dev), _bf(w3.t(), dev),
          _bf(wres.t(), dev) if has_res else None,
          h1, h2, dpre_y, dpre2, dpre1, dx, pk1, pk2, pk3, pkres,
          b, h, w, ci, s)
    dk1 = pk1.sum(0).t()[:, :, None, None].contiguous()
    dk2 = pk2.sum(0).reshape(3, 3, P, P).permute(3, 2, 0, 1).contiguous()
    dk3 = pk3.sum(0).t()[:, :, None, None].contiguous()
    dkres = (pkres.sum(0).t()[:, :, None, None].contiguous()
             if has_res else None)
    return dx, dk1, dk2, dk3, dkres


# ---- autograd -------------------------------------------------------------

def _grad_like(g: Optional[torch.Tensor], p: Optional[torch.Tensor]):
    return None if g is None or p is None else g.to(p.dtype)


class _Stem(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k1, b1, k2, b2):
        ctx.save_for_backward(x, k1, b1, k2, b2)
        if hw.use_kernel(x):
            return stem_fwd_kernel(x, k1, b1, k2, b2)
        return stem_plain(x, k1, b1, k2, b2)

    @staticmethod
    def backward(ctx, dy):
        x, k1, b1, k2, b2 = ctx.saved_tensors
        bwd = stem_bwd_kernel if hw.use_kernel(x) else stem_bwd_plain
        dx, dk1, db1, dk2, db2 = bwd(x, dy.contiguous(), k1, b1, k2, b2)
        return (dx, _grad_like(dk1, k1), _grad_like(db1, b1),
                _grad_like(dk2, k2), _grad_like(db2, b2))


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
    the plain versions for a CPU one."""
    return _Stem.apply(x, k1, b1, k2, b2)


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
