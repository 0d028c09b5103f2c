"""K4: fused upsample-concat + both heads' 1x1 + lrelu + taps product, NHWC.

Counterpart of ``ops/pallas_upshead.ups_head_taps_x0f4`` /
``ups_head_taps`` and of ``ups_head_1x1`` (all three ``_pallas_impl``):

    h  = lrelu(concat([p0, up2(p1), up4(p2)]) . W1 + b1)    (ups_head_1x1)
    yt = h . W2t                                             (ups_head_taps)

``W2t`` stacks both heads' 3x3 convs tap by tap (``build_dual_tap_kernel``),
so ``yt`` holds 9 * (Cr + Cs) channels and the heads finish with the 9-way
shifted add + bias of ``ops/shiftadd.shifted_add_bias``, on its own kernel.

The kernel is ``csrc/upshead.cu``, in two modes: taps (the heads'
forward) and h (``ups_head_1x1``: the recompute of the backward, and the
heads' route where the taps product does not fit, ``--num_pred_once 2``
of extrapolation).  The taps mode has two instances, by the taps matrix's
padded width: 208 (N2 <= 208: a head of 23 channels, counter
``ups_head_taps``) and 216 (208 < N2 <= 216: ExtraInpaintNet's 24 with
``--inpaint_mask``, counter ``upshead_taps_n216``).
``ups_head_taps`` is a ``torch.autograd.Function`` whose backward is
``pallas_upshead._explicit_taps_bwd`` (``ups_head_taps_bwd``): h is
recomputed once through the h mode, the lrelu mask comes from the sign of
h, the weight grads are f32 products, and dp1/dp2 go through the vjp of
the bilinear upsampling.  ``ups_head_1x1`` is differentiable too, by
autograd of its plain version recomputed (``ops/recompute.py``), as the
JAX ``_bwd`` is ``jax.vjp`` of ``_ups_head_ref``.  The plain versions round where
``pallas_upshead._ups_head_taps_ref`` rounds (upsampled parts, h and yt in
the compute dtype).

``ups_head_taps4`` is the 4-part head of ``--highres_large``
(``pallas_upshead.ups_head_taps4``: p3 at 1/8 resolution added, 960 ->
1920 -> 207 or 216), on its own kernel ``csrc/upshead4.cu``, with the same
two taps instances (208: counter ``ups_head_taps4``; 216: ExtraInpaintNet
``--inpaint_mask``, counter ``upshead4_taps_n216``) and an h mode
(``ups_head_1x1_4``, the ``w2t=None`` mode of ``_pallas_impl4``, counter
``ups_head_1x1_4``; its only caller is the backward).  It is a ``torch.autograd.Function`` whose backward
is ``ups_head_taps4_bwd``, K4's explicit backward on four parts: h
recomputed once through the h mode, the products on compute-dtype
operands, as the JAX ``_bwd_taps4`` (``jax.vjp`` of
``_ups_head_taps_ref4``) computes them outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.ops import _build
from deep_video_interpolation_extrapolation_tpu_torch.ops.recompute import (
    recompute_vjp,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.resize import (
    interpolate_bilinear,
    nchw,
    nhwc,
)

NAME, NAME_1X1, NAME4 = "ups_head_taps", "ups_head_1x1", "ups_head_taps4"
NAME_N216 = "upshead_taps_n216"   # the taps mode's 216-wide instance
NAME4_N216 = "upshead4_taps_n216"  # the 4-part taps mode's 216-wide instance
NAME4_1X1 = "ups_head_1x1_4"      # the 4-part head's h mode
CT_MAX, N2_MAX = 448, 208   # the kernel's shared-memory tile widths
# the taps mode's instances: padded width -> (C entry, launch counter)
N2_WIDTHS = {208: ("dvie_ups_head_taps", NAME),
             216: ("dvie_ups_head_taps_n216", NAME_N216)}
N2_WIDTHS4 = {208: ("dvie_ups_head_taps4", NAME4),
              216: ("dvie_ups_head_taps4_n216", NAME4_N216)}
CT4_MAX = 960               # upshead4.cu's concat width


def _h_plain(parts, w1, b1):
    """h = lrelu(bf16(concat(parts upsampled to parts[0]'s size) . w1) +
    b1), in parts[0]'s dtype (``_ups_head_ref`` / ``_ups_head_ref4``)."""
    dt = parts[0].dtype
    size = tuple(parts[0].shape[1:3])
    cat = torch.cat([parts[0]] + [interpolate_bilinear(p, size=size)
                                  for p in parts[1:]], dim=-1)
    h = torch.matmul(cat.float(), w1.to(dt).float()).to(dt) + b1.to(dt)
    return torch.where(h >= 0, h, 0.2 * h)


def _taps_plain(h, w2t):
    return torch.matmul(h.float(), w2t.to(h.dtype).float()).to(h.dtype)


def ups_head_1x1_plain(p0, p1, p2, w1, b1):
    """p0 (B,H,W,C0), p1 (B,H/2,W/2,C1), p2 (B,H/4,W/4,C2); w1 (C0+C1+C2, N1),
    b1 (N1,), any float dtype (cast to p0's).  Returns h (B,H,W,N1)."""
    return _h_plain((p0, p1, p2), w1, b1)


def ups_head_taps_plain(p0, p1, p2, w1, b1, w2t):
    """``ups_head_1x1_plain`` then the taps product by w2t (N1, N2).
    Returns yt (B,H,W,N2)."""
    return _taps_plain(_h_plain((p0, p1, p2), w1, b1), w2t)


def ups_head_1x1_4_plain(p0, p1, p2, p3, w1, b1):
    """The 4-part head's h (``_ups_head_ref4``): as ``ups_head_1x1_plain``
    with p3 (B,H/8,W/8,C3) and w1 (C0+C1+C2+C3, N1).  Returns h
    (B,H,W,N1)."""
    return _h_plain((p0, p1, p2, p3), w1, b1)


def ups_head_taps4_plain(p0, p1, p2, p3, w1, b1, w2t):
    """The 4-part head (``_ups_head_taps_ref4``): as ``ups_head_taps_plain``
    with p3 (B,H/8,W/8,C3) and w1 (C0+C1+C2+C3, N1).  Returns yt
    (B,H,W,N2)."""
    return _taps_plain(_h_plain((p0, p1, p2, p3), w1, b1), w2t)


def fits4(p0, p1, p2, p3) -> bool:
    """``pallas_upshead.fits4`` (:1156): the pyramid shapes the JAX package
    routes through its 4-part head kernel.  The port's kernel tiles over
    pixels and takes any pyramid size (``_taps4_kernel`` raises only for
    channel counts), so the model does not route by it; it names the
    shapes at which the JAX kernel, and so the parity tests, can run."""
    b, h, w, _ = p0.shape
    return (h % 8 == 0 and w % 64 == 0 and w >= 64
            and tuple(p1.shape[1:3]) == (h // 2, w // 2)
            and tuple(p2.shape[1:3]) == (h // 4, w // 4)
            and tuple(p3.shape[1:3]) == (h // 8, w // 8)
            and p1.shape[-1] % 128 == 0 and p2.shape[-1] % 128 == 0
            and p3.shape[-1] % 128 == 0 and (h // 8) >= 2)


def _check(p0, p1, p2, w1, b1, n1):
    b = p0.shape[0]
    ct = p0.shape[-1] + p1.shape[-1] + p2.shape[-1]
    if (p1.shape[0] != b or p2.shape[0] != b or p0.shape[-1] % 8
            or p1.shape[-1] % 8 or p2.shape[-1] % 8 or ct % 64
            or ct > CT_MAX):
        raise ValueError(f"pyramid {tuple(p0.shape)} {tuple(p1.shape)} "
                         f"{tuple(p2.shape)} not taken by the kernel")
    if tuple(w1.shape) != (ct, n1) or tuple(b1.shape) != (n1,):
        raise ValueError(f"w1 {tuple(w1.shape)} / b1 {tuple(b1.shape)} do "
                         f"not match C={ct}, N1={n1}")
    if n1 % 64:
        raise ValueError(f"kernel takes N1 % 64 == 0, got N1={n1}")
    for name, t in (("p0", p0), ("p1", p1), ("p2", p2)):
        hw.check_bf16(name, t)


def w1_units(w1: torch.Tensor, dev) -> torch.Tensor:
    """W1 (CT, N1) -> the kernel's weight units, bf16 (N1/64, CT/64, 8, 64,
    8): unit (nc, kc) holds W1[kc*64 + 8*kg + k, nc*64 + n] at [kg, n, k],
    the no-swizzle K-major core-matrix order (csrc/hopper.cuh), in the
    order the kernel's ring takes them (hidden chunk by hidden chunk)."""
    ct, n1 = w1.shape
    return (w1.to(device=dev, dtype=torch.bfloat16)
            .reshape(ct // 64, 8, 8, n1 // 64, 64).permute(3, 0, 1, 4, 2)
            .contiguous())


def padded_taps(w2t: torch.Tensor, dev, n2p: int = N2_MAX) -> torch.Tensor:
    """The taps matrix (N1, N2) in bf16, zero-padded to the kernel's tile
    width ``n2p`` (208, or 216 for the 216 instance) so each row is one run
    of 16-byte words (yt itself keeps its N2 columns)."""
    n1, n2 = w2t.shape
    w2k = torch.zeros((n1, n2p), device=dev, dtype=torch.bfloat16)
    w2k[:, :n2] = w2t
    return w2k


def w2_chunks(w2t: torch.Tensor, dev, n2p: int = N2_MAX) -> torch.Tensor:
    """``padded_taps`` as K4's bf16 chunks (N1/64, 8, n2p, 8) of 64 hidden
    rows: W2t[nc*64 + 8*kg + k, n] at [nc, kg, n, k], K-major core
    matrices."""
    n1 = w2t.shape[0]
    return (padded_taps(w2t, dev, n2p).reshape(n1 // 64, 8, 8, n2p)
            .permute(0, 1, 3, 2).contiguous())


def taps_width(n2: int) -> int:
    """The padded width of the taps instance that takes N2 columns: 208
    up to 208, 216 up to 216; a ValueError above."""
    for n2p in sorted(N2_WIDTHS):
        if n2 <= n2p:
            return n2p
    raise ValueError(f"kernel takes N2 <= {max(N2_WIDTHS)}, got N2={n2}")


def _launch(fn, p0, p1, p2, w1, b1, w2k, out, *tail):
    dev = p0.device
    # converted weights held in locals until the launch is queued
    w1k = w1_units(w1, dev)
    b1k = b1.to(device=dev, dtype=torch.float32).contiguous()
    b, h, w, c0 = p0.shape
    _, h1, w1_, c1 = p1.shape
    _, h2, w2_, c2 = p2.shape
    p = _build.ptr
    ptrs = [p(p0), p(p1), p(p2), p(w1k), p(b1k)]
    ptrs += [p(w2k)] if w2k is not None else []
    return fn(*ptrs, p(out), b, h, w, h1, w1_, h2, w2_, c0, c1, c2,
              w1.shape[1], *tail, _build.stream(p0))


def _taps_kernel(p0, p1, p2, w1, b1, w2t):
    n1, n2 = w2t.shape
    _check(p0, p1, p2, w1, b1, n1)
    n2p = taps_width(n2)
    entry, counter = N2_WIDTHS[n2p]
    yt = torch.empty((*p0.shape[:3], n2), device=p0.device,
                     dtype=torch.bfloat16)
    err = _launch(getattr(_build.library(), entry), p0, p1, p2, w1, b1,
                  w2_chunks(w2t, p0.device, n2p), yt, n2)
    _build.check_launch(counter, err)
    hw.launches[counter] += 1
    return yt


def _h_kernel(p0, p1, p2, w1, b1) -> torch.Tensor:
    n1 = w1.shape[1]
    _check(p0, p1, p2, w1, b1, n1)
    h = torch.empty((*p0.shape[:3], n1), device=p0.device,
                    dtype=torch.bfloat16)
    err = _launch(_build.library().dvie_ups_head_1x1, p0, p1, p2, w1, b1,
                  None, h)
    _build.check_launch(NAME_1X1, err)
    hw.launches[NAME_1X1] += 1
    return h


def ups_head_1x1(p0: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                 w1: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """h on CUDA bf16 tensors through the kernel's h mode; on CPU tensors
    through the plain version.  Differentiable, by autograd of
    ``ups_head_1x1_plain`` recomputed: the route of the heads whose taps
    product does not fit the taps mode (``pallas_upshead.ups_head_1x1``,
    a ``custom_vjp`` whose backward is the vjp of ``_ups_head_ref``).  The
    backward of ``ups_head_taps`` calls it without grad, for h alone.
    Without a gradient, through its op ``dvie::ups_head_1x1``."""
    if hw.serving(p0, p1, p2, w1, b1):
        return torch.ops.dvie.ups_head_1x1(p0, p1, p2, w1, b1)
    return recompute_vjp(_h_kernel, ups_head_1x1_plain, p0, p1, p2, w1, b1)


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b summed in f32 and returned in f32, on the operands as they are
    (no f32 copy of a bf16 operand): on the card one product of bf16
    operands with an f32 output (``torch.mm(..., out_dtype=float32)``); on
    the CPU, which has no kernel for that, the product in the operands'
    dtype."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a, b).float()


def _taps_bwd(parts, w1, b1, w2t, g, h):
    """The explicit backward of a head over ``parts`` (3 or 4) given its
    cotangent g and the hidden map h: grads of (*parts, w1, b1, w2t).  The
    products take the JAX dtypes (``_explicit_taps_bwd``, :450-466): dh =
    g . W2t^T and dcat = dpre . W1^T on compute-dtype operands, rounded
    once to it; dw2t = h^T . g and dw1 = part^T . dpre (per pyramid part,
    no concat is built) on compute-dtype operands with f32 results; db1
    summed in f32; the upsampled parts' grads the upsampling's vjp of
    dcat's slices."""
    dt = parts[0].dtype
    size = tuple(parts[0].shape[1:3])
    g = g.to(dt)
    dw2t = _mm_f32(_flat(h).t(), _flat(g))
    dh = torch.matmul(g, w2t.to(dt).t())
    dpre = torch.where(h >= 0, dh, 0.2 * dh)
    dflat = _flat(dpre)
    db1 = dflat.sum(0, dtype=torch.float32)
    ups = [parts[0]] + [interpolate_bilinear(p, size=size) for p in parts[1:]]
    dw1 = torch.cat([_mm_f32(_flat(u).t(), dflat) for u in ups], dim=0)
    dcat = torch.matmul(dpre, w1.to(dt).t())
    dps, c = [], 0
    for p in parts:
        dps.append(_upsample_vjp(dcat[..., c:c + p.shape[-1]], p.shape))
        c += p.shape[-1]
    return (*dps, dw1, db1, dw2t)


def ups_head_taps_bwd(p0, p1, p2, w1, b1, w2t, g, h=None):
    """``pallas_upshead._explicit_taps_bwd`` (:415-472): grads of yt
    w.r.t. (p0, p1, p2, w1, b1, w2t) given its cotangent g (``_taps_bwd``);
    ``h``, the hidden map, is recomputed through ``ups_head_1x1`` unless
    given."""
    if h is None:
        h = ups_head_1x1(p0, p1, p2, w1, b1)             # recomputed once
    return _taps_bwd((p0, p1, p2), w1, b1, w2t, g, h)


def _upsample_vjp(g: torch.Tensor, shape) -> torch.Tensor:
    """The vjp of ``interpolate_bilinear`` from an NHWC input of ``shape``
    to g's size, given the cotangent g: summed in f32 and rounded once to
    g's dtype, as the JAX vjp (an f32-accumulated einsum) rounds; the
    kernel's bf16 form adds into bf16 one contribution at a time (its dp2
    drifted 2.3% of max from the f32 sum at 24x128x128)."""
    b, hi, wi, c = shape
    if (hi, wi) == tuple(g.shape[1:3]):
        return g
    d = torch.ops.aten.upsample_bilinear2d_backward(
        nchw(g.float()), list(g.shape[1:3]), [b, c, hi, wi], False, None,
        None)
    return nhwc(d).to(g.dtype)


class _UpsHeadTaps(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p0, p1, p2, w1, b1, w2t):
        ctx.save_for_backward(p0, p1, p2, w1, b1, w2t)
        if hw.use_kernel(p0):
            return _taps_kernel(p0, p1, p2, w1, b1, w2t)
        return ups_head_taps_plain(p0, p1, p2, w1, b1, w2t)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        grads = ups_head_taps_bwd(*saved, g.contiguous())
        return tuple(d.to(s.dtype) for d, s in zip(grads, saved))


def ups_head_taps(p0: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                  w1: torch.Tensor, b1: torch.Tensor,
                  w2t: torch.Tensor) -> torch.Tensor:
    """The fused head on CUDA bf16 tensors through the Hopper kernel; on
    CPU tensors through the plain version.  Same arguments as the plain
    version; differentiable, by the explicit backward.  Without a
    gradient, through its op ``dvie::ups_head_taps``."""
    if hw.serving(p0, p1, p2, w1, b1, w2t):
        return torch.ops.dvie.ups_head_taps(p0, p1, p2, w1, b1, w2t)
    return _UpsHeadTaps.apply(p0, p1, p2, w1, b1, w2t)


def build_dual_tap_kernel(w_rgb: torch.Tensor, w_seg: torch.Tensor,
                          dtype: torch.dtype) -> torch.Tensor:
    """(2Cin, 9*(Cr+Cs)) taps-in-N matrix of both heads' 3x3 convs, from
    torch (Cr, Cin, 3, 3) / (Cs, Cin, 3, 3) weights.  Rows [0:Cin] (the rgb
    half of h) feed each tap's rgb columns, rows [Cin:2Cin] the seg
    columns; tap t = ky*3 + kx owns columns [t*(Cr+Cs), (t+1)*(Cr+Cs))."""
    cr, cin = w_rgb.shape[:2]
    cs = w_seg.shape[0]
    co = cr + cs
    wr9 = w_rgb.reshape(cr, cin, 9).permute(1, 2, 0)   # (Cin, 9, Cr)
    ws9 = w_seg.reshape(cs, cin, 9).permute(1, 2, 0)
    wt = torch.zeros((2 * cin, 9, co), dtype=dtype, device=w_rgb.device)
    wt[:cin, :, :cr] = wr9.to(dtype)
    wt[cin:, :, cr:] = ws9.to(dtype)
    return wt.reshape(2 * cin, 9 * co)


# ---- the 4-part head ------------------------------------------------------

def w1_units4(w1: torch.Tensor, dev) -> torch.Tensor:
    """W1 (CT, N1) -> the 4-part kernel's weight units, bf16 (N1p/128,
    CT/64, 2, 8, 64, 8), N1 zero-padded to N1p, a multiple of 128: unit
    [p, u, j] holds W1[64 u + 8 kg + k, 64 (2p + j) + n] at [kg, n, k]
    (K4's K-major core-matrix units), the units of hidden chunks 2p and 2p
    + 1 interleaved: the order in which the kernel's two warpgroups take
    them, the even chunks warpgroup 0's and the odd ones warpgroup 1's."""
    ct, n1 = w1.shape
    n1p = -(-n1 // 128) * 128
    wk = torch.zeros((ct, n1p), device=dev, dtype=torch.bfloat16)
    wk[:, :n1] = w1
    return (wk.reshape(ct // 64, 8, 8, n1p // 128, 2, 64)
            .permute(3, 0, 4, 1, 5, 2).contiguous())


def taps4_weights(w1: torch.Tensor, b1: torch.Tensor,
                  w2t: Optional[torch.Tensor], dev):
    """The 4-part kernel's weights on ``dev``, built once per weight
    (``hw.derived``): W1 units (``w1_units4``), b1 in f32 and W2t chunks
    at the taps instance's width (``w2_chunks``; None for the h mode), all
    three zero-padded to the same N1p hidden channels (a padded channel's h
    is lrelu(0 + 0) = 0 and adds nothing)."""
    def build():
        n1 = w1.shape[1]
        n1p = -(-n1 // 128) * 128
        b1k = torch.zeros((n1p,), device=dev, dtype=torch.float32)
        b1k[:n1] = b1
        w2u = None
        if w2t is not None:
            w2p = torch.zeros((n1p, w2t.shape[1]), device=dev,
                              dtype=torch.bfloat16)
            w2p[:n1] = w2t
            w2u = w2_chunks(w2p, dev, taps_width(w2t.shape[1]))
        return w1_units4(w1, dev), b1k, w2u
    return hw.derived(f"{NAME4}:{dev}:{w2t is not None}", (w1, b1, w2t),
                      build)


def check_taps4(p0, p1, p2, p3, w1, b1, w2t=None) -> None:
    """Raises ``ValueError`` for what the 4-part kernel cannot take: the
    batch differing between parts, a part's channels not a multiple of 8,
    the concat's not a multiple of 64 or over 960, weights that do not
    match, N1 not a multiple of 64, N2 over 216 (``w2t`` None: the h
    mode), an empty image or too many pixels for the kernel's 32-bit tile
    count.  Any pyramid size is taken (``fits4`` or not)."""
    parts = (p0, p1, p2, p3)
    b = p0.shape[0]
    cs = [p.shape[-1] for p in parts]
    n1, n2 = (w1.shape[1], 0) if w2t is None else w2t.shape
    n2_max = max(N2_WIDTHS4)
    if (any(p.shape[0] != b for p in parts) or any(c % 8 for c in cs)
            or sum(cs) % 64 or sum(cs) > CT4_MAX):
        raise ValueError(f"pyramid {[tuple(p.shape) for p in parts]} not "
                         "taken by the 4-part kernel")
    if tuple(w1.shape) != (sum(cs), n1) or tuple(b1.shape) != (n1,):
        raise ValueError(f"w1 {tuple(w1.shape)} / b1 {tuple(b1.shape)} do "
                         f"not match C={sum(cs)}, N1={n1}")
    if n1 % 64 or n2 > n2_max:
        raise ValueError(f"kernel takes N1 % 64 == 0 and N2 <= {n2_max}, "
                         f"got N1={n1} N2={n2}")
    if min(p.shape[1] * p.shape[2] for p in parts) < 1:
        raise ValueError("4-part kernel: an empty image in the pyramid "
                         f"{[tuple(p.shape) for p in parts]}")
    if b * p0.shape[1] * p0.shape[2] >= 2**31:
        raise ValueError(f"4-part kernel counts 64-pixel tiles in 32-bit "
                         f"ints: {tuple(p0.shape[:3])} is too many pixels")


def _taps4_kernel(p0, p1, p2, p3, w1, b1, w2t=None):
    """One launch of ``csrc/upshead4.cu``: the taps mode at the instance
    N2 takes (yt), or with ``w2t`` None the h mode (h, N1 channels)."""
    parts = (p0, p1, p2, p3)
    check_taps4(*parts, w1, b1, w2t)
    for i, p in enumerate(parts):
        hw.check_bf16(f"p{i}", p)
    dev = p0.device
    w1u, b1k, w2u = taps4_weights(w1, b1, w2t, dev)
    if w2t is None:
        n, entry, counter = w1.shape[1], "dvie_ups_head_1x1_4", NAME4_1X1
    else:
        n = w2t.shape[1]
        entry, counter = N2_WIDTHS4[taps_width(n)]
    out = torch.empty((*p0.shape[:3], n), device=dev, dtype=torch.bfloat16)
    p = _build.ptr
    sizes = [d for q in parts[1:] for d in q.shape[1:3]]
    ptrs = [p(q) for q in parts] + [p(w1u), p(b1k)]
    ptrs += [p(w2u)] if w2u is not None else []
    err = getattr(_build.library(), entry)(
        *ptrs, p(out), *p0.shape[:3], *sizes, *(q.shape[-1] for q in parts),
        b1k.shape[0], n, _build.stream(p0))
    _build.check_launch(counter, err)
    hw.launches[counter] += 1
    return out


def ups_head_1x1_4(p0: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                   p3: torch.Tensor, w1: torch.Tensor,
                   b1: torch.Tensor) -> torch.Tensor:
    """The 4-part head's h on CUDA bf16 tensors through the kernel's h mode
    (``_pallas_impl4(..., w2t=None)``); on CPU tensors through
    ``ups_head_1x1_4_plain``.  The backward of ``ups_head_taps4`` calls it
    for h alone, without grad."""
    if hw.use_kernel(p0):
        return _taps4_kernel(p0, p1, p2, p3, w1, b1)
    return ups_head_1x1_4_plain(p0, p1, p2, p3, w1, b1)


def ups_head_taps4_bwd(p0, p1, p2, p3, w1, b1, w2t, g, h=None):
    """The 4-part head's backward: grads of yt w.r.t. (p0, p1, p2, p3, w1,
    b1, w2t) given its cotangent g, as ``ups_head_taps_bwd`` on four parts
    (``_taps_bwd``): h recomputed through ``ups_head_1x1_4`` (on the card
    the kernel's h mode) unless given, the products on compute-dtype
    operands (dh and dcat rounded once; dw1, per part, and dw2t f32
    results; db1 summed in f32), dp1..dp3 the upsampling's vjp of dcat's
    slices: the vjp of ``_ups_head_taps_ref4``."""
    if h is None:
        h = ups_head_1x1_4(p0, p1, p2, p3, w1, b1)       # recomputed once
    return _taps_bwd((p0, p1, p2, p3), w1, b1, w2t, g, h)


class _UpsHeadTaps4(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p0, p1, p2, p3, w1, b1, w2t):
        ctx.save_for_backward(p0, p1, p2, p3, w1, b1, w2t)
        if hw.use_kernel(p0):
            return _taps4_kernel(p0, p1, p2, p3, w1, b1, w2t)
        return ups_head_taps4_plain(p0, p1, p2, p3, w1, b1, w2t)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        grads = ups_head_taps4_bwd(*saved, g.contiguous())
        return tuple(d.to(s.dtype) for d, s in zip(grads, saved))


def ups_head_taps4(p0: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                   p3: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2t: torch.Tensor) -> torch.Tensor:
    """The 4-part head on CUDA bf16 tensors through ``csrc/upshead4.cu``
    (its 208 or 216 instance by N2); on CPU tensors through
    ``ups_head_taps4_plain``.  Same arguments as the plain version;
    differentiable, by the explicit backward ``ups_head_taps4_bwd``.
    Without a gradient, through its op ``dvie::ups_head_taps4``."""
    if hw.serving(p0, p1, p2, p3, w1, b1, w2t):
        return torch.ops.dvie.ups_head_taps4(p0, p1, p2, p3, w1, b1, w2t)
    return _UpsHeadTaps4.apply(p0, p1, p2, p3, w1, b1, w2t)
