"""K4: fused upsample-concat + both heads' 1x1 + lrelu + taps product, NHWC.

Counterpart of ``ops/pallas_upshead.ups_head_taps_x0f4`` /
``ups_head_taps`` and of ``ups_head_1x1`` (all three ``_pallas_impl``):

    h  = lrelu(concat([p0, up2(p1), up4(p2)]) . W1 + b1)    (ups_head_1x1)
    yt = h . W2t                                             (ups_head_taps)

``W2t`` stacks both heads' 3x3 convs tap by tap (``build_dual_tap_kernel``),
so ``yt`` holds 9 * (Cr + Cs) channels and the heads finish with the 9-way
shifted add + bias of ``finish_taps``.  That tail stays plain PyTorch, as it
is XLA code in the JAX package (hrnet.py ``_finish_taps``,
ops/tapped_conv.py).

The kernel is ``csrc/upshead.cu``, in two modes: taps (the heads'
forward) and h (``ups_head_1x1``, the recompute of the backward).
``ups_head_taps`` is a ``torch.autograd.Function`` whose backward is
``pallas_upshead._explicit_taps_bwd`` (``ups_head_taps_bwd``): h is
recomputed once through the h mode, the lrelu mask comes from the sign of
h, the weight grads are f32 products, and dp1/dp2 go through the vjp of
the bilinear upsampling.  The plain versions round where
``pallas_upshead._ups_head_taps_ref`` rounds (upsampled parts, h and yt in
the compute dtype).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.ops import _build
from deep_video_interpolation_extrapolation_tpu_torch.ops.resize import (
    interpolate_bilinear,
)

NAME, NAME_1X1 = "ups_head_taps", "ups_head_1x1"
CT_MAX, N2_MAX = 448, 208   # the kernel's shared-memory tile widths


def ups_head_1x1_plain(p0, p1, p2, w1, b1):
    """p0 (B,H,W,C0), p1 (B,H/2,W/2,C1), p2 (B,H/4,W/4,C2); w1 (C0+C1+C2, N1),
    b1 (N1,), any float dtype (cast to p0's).  Returns h (B,H,W,N1)."""
    dt = p0.dtype
    size = tuple(p0.shape[1:3])
    cat = torch.cat([p0, interpolate_bilinear(p1, size=size),
                     interpolate_bilinear(p2, size=size)], dim=-1)
    h = torch.matmul(cat.float(), w1.to(dt).float()).to(dt) + b1.to(dt)
    return torch.where(h >= 0, h, 0.2 * h)


def ups_head_taps_plain(p0, p1, p2, w1, b1, w2t):
    """``ups_head_1x1_plain`` then the taps product by w2t (N1, N2).
    Returns yt (B,H,W,N2)."""
    h = ups_head_1x1_plain(p0, p1, p2, w1, b1)
    return torch.matmul(h.float(), w2t.to(h.dtype).float()).to(h.dtype)


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


def _launch(fn, p0, p1, p2, w1, b1, w2k, out, *tail):
    dev = p0.device
    # converted weights held in locals until the launch is queued
    w1k = w1.to(device=dev, dtype=torch.bfloat16).contiguous()
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
    if n2 > N2_MAX:
        raise ValueError(f"kernel takes N2 <= {N2_MAX}, got N2={n2}")
    # the taps matrix, zero-padded to the kernel's tile width N2_MAX so each
    # row is one run of 16-byte words (yt itself keeps its n2 columns)
    w2k = torch.zeros((n1, N2_MAX), device=p0.device, dtype=torch.bfloat16)
    w2k[:, :n2] = w2t
    yt = torch.empty((*p0.shape[:3], n2), device=p0.device,
                     dtype=torch.bfloat16)
    err = _launch(_build.library().dvie_ups_head_taps, p0, p1, p2, w1, b1,
                  w2k, yt, n2)
    _build.check_launch(NAME, err)
    hw.launches[NAME] += 1
    return yt


def ups_head_1x1(p0: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                 w1: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """h on CUDA bf16 tensors through the kernel's h mode; on CPU tensors
    through the plain version.  Not differentiable (the backward of
    ``ups_head_taps`` calls it)."""
    if not hw.use_kernel(p0):
        return ups_head_1x1_plain(p0, p1, p2, w1, b1)
    n1 = w1.shape[1]
    _check(p0, p1, p2, w1, b1, n1)
    h = torch.empty((*p0.shape[:3], n1), device=p0.device,
                    dtype=torch.bfloat16)
    err = _launch(_build.library().dvie_ups_head_1x1, p0, p1, p2, w1, b1,
                  None, h)
    _build.check_launch(NAME_1X1, err)
    hw.launches[NAME_1X1] += 1
    return h


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1]).float()


def ups_head_taps_bwd(p0, p1, p2, w1, b1, w2t, g):
    """``pallas_upshead._explicit_taps_bwd`` (:415-472): grads of yt
    w.r.t. (p0, p1, p2, w1, b1, w2t) given its cotangent g.  Pyramid
    grads in the compute dtype; dw1, db1, dw2t f32."""
    dt = p0.dtype
    c0, c1 = p0.shape[-1], p1.shape[-1]
    size = tuple(p0.shape[1:3])
    h = ups_head_1x1(p0, p1, p2, w1, b1)                 # recomputed once
    dw2t = _flat(h).t() @ _flat(g)
    dh = torch.matmul(g.float(), w2t.to(dt).float().t()).to(dt)
    dpre = torch.where(h >= 0, dh, 0.2 * dh)
    dflat = _flat(dpre)
    db1 = dflat.sum(0)
    with torch.enable_grad():
        p1v = p1.detach().requires_grad_()
        p2v = p2.detach().requires_grad_()
        up1 = interpolate_bilinear(p1v, size=size)
        up2 = interpolate_bilinear(p2v, size=size)
    # dw1 per pyramid part: no 448-ch concat is built
    dw1 = torch.cat([_flat(part).t() @ dflat
                     for part in (p0, up1.detach(), up2.detach())], dim=0)
    dcat = torch.matmul(dpre.float(), w1.to(dt).float().t()).to(dt)
    (dp1,) = torch.autograd.grad(up1, p1v, dcat[..., c0:c0 + c1])
    (dp2,) = torch.autograd.grad(up2, p2v, dcat[..., c0 + c1:])
    return dcat[..., :c0], dp1, dp2, dw1, db1, dw2t


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
    version; differentiable, by the explicit backward."""
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


def taps_shifted_add(yt: torch.Tensor, co: int) -> torch.Tensor:
    """9-way shifted add over a (B, H, W, 9*co) taps tensor:
    out[y, x] = sum_t yt[y + ky - 1, x + kx - 1, t], zero outside the
    image (the 3x3 conv's SAME padding)."""
    b, h, w, n = yt.shape
    if n != 9 * co:
        raise ValueError(f"taps tensor has {n} channels, expected 9*{co}")
    ytp = F.pad(yt.reshape(b, h, w, 9, co), (0, 0, 0, 0, 1, 1, 1, 1))
    out = None
    for ky in range(3):
        for kx in range(3):
            sl = ytp[:, ky:ky + h, kx:kx + w, ky * 3 + kx]
            out = sl if out is None else out + sl
    return out


def finish_taps(yt: torch.Tensor, co: int, b2: torch.Tensor) -> torch.Tensor:
    """Shifted add + bias: the heads' 3x3 convs from their taps tensor."""
    return taps_shifted_add(yt, co) + b2.to(yt.dtype)
