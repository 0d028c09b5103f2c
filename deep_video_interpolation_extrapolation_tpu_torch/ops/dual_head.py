"""Both HRNet heads over one full-resolution feature map, NHWC.

Counterpart of ``ops/pallas_head.fused_dual_head`` (same arguments, in the
JAX order and layouts): for each head, ``h = lrelu(feat . W1 + b1)`` (448 ->
448 at serving) then a 3x3 conv (SAME, h zero outside the image) to 3
(rgb) and ``seg_dim`` (seg) channels.  The plain version computes as the
Pallas kernel does: the 1x1 in f32 over compute-dtype operands, h rounded to
the compute dtype, the 3x3 summed in f32 and rounded once.

The kernel keeps the 896-channel hidden map out of device memory by the
taps route: K4's device code (``csrc/upshead.cu``, entry
``dvie_dual_head_taps``: the taps mode on one part, no upsampling) writes
``yt = bf16(h . W2t)``, both heads' 3x3 convs as a (896 -> 9 * 23) product,
and the shift-add kernel (``ops/shiftadd.py``) finishes the convs with
their biases.  So yt is rounded to bf16 before the f32 shifted add, where
the Pallas kernel keeps the taps in f32.  The JAX HRNet never calls this
function (its heads run through K4), and neither does the port's: no
model route reaches it, and it has no backward (the JAX kernel has none),
so the wrapper raises for inputs that require grad.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.ops import _build
from deep_video_interpolation_extrapolation_tpu_torch.ops.resize import (
    nchw,
    nhwc,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.shiftadd import (
    shifted_add_bias,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.upshead import (
    CT_MAX,
    N2_MAX,
    build_dual_tap_kernel,
    w1_units,
    w2_chunks,
)

NAME = "dual_head"


def _oihw(w_hwio: torch.Tensor) -> torch.Tensor:
    return w_hwio.permute(3, 2, 0, 1)


def _check_seg_dim(w2_seg, seg_dim):
    if w2_seg.shape[-1] != seg_dim:
        raise ValueError(f"w2_seg has {w2_seg.shape[-1]} outputs, "
                         f"seg_dim={seg_dim}")


def fused_dual_head_plain(feat, w1_rgb, b1_rgb, w2_rgb, b2_rgb, w1_seg,
                          b1_seg, w2_seg, b2_seg, seg_dim: int = 20
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """feat (B,H,W,C); w1_* (C, C) (in, out); w2_rgb (3,3,C,3), w2_seg
    (3,3,C,seg_dim) HWIO; biases 1-D.  Returns (rgb, seg) in feat's
    dtype."""
    _check_seg_dim(w2_seg, seg_dim)
    dt = feat.dtype

    def head(w1, b1, w2, b2):
        h = torch.matmul(feat.float(), w1.to(dt).float()) + b1.float()
        h = torch.where(h >= 0, h, 0.2 * h).to(dt).float()
        out = F.conv2d(nchw(h), _oihw(w2).to(dt).float(), padding=1)
        return (nhwc(out) + b2.float()).to(dt)

    return (head(w1_rgb, b1_rgb, w2_rgb, b2_rgb),
            head(w1_seg, b1_seg, w2_seg, b2_seg))


def _kernel(feat, w1, b1, w2t, b2):
    b, h, w, c = feat.shape
    n1, n2 = w2t.shape
    if c % 64 or c > CT_MAX or tuple(w1.shape) != (c, n1) or n1 % 64:
        raise ValueError(f"kernel takes C % 64 == 0, C <= {CT_MAX} and N1 % "
                         f"64 == 0, got feat {tuple(feat.shape)}, w1 "
                         f"{tuple(w1.shape)}")
    if n2 > N2_MAX:
        raise ValueError(f"kernel takes N2 <= {N2_MAX}, got N2={n2}")
    hw.check_bf16("feat", feat)
    dev = feat.device
    # weights converted and held in locals until the launch is queued
    w1k = w1_units(w1, dev)
    b1k = b1.to(device=dev, dtype=torch.float32).contiguous()
    w2k = w2_chunks(w2t, dev)
    yt = torch.empty((b, h, w, n2), device=dev, dtype=torch.bfloat16)
    p = _build.ptr
    err = _build.library().dvie_dual_head_taps(
        p(feat), p(w1k), p(b1k), p(w2k), p(yt), b, h, w, c, n1, n2,
        _build.stream(feat))
    _build.check_launch(NAME, err)
    hw.launches[NAME] += 1
    return shifted_add_bias(yt, b2)


def fused_dual_head(feat, w1_rgb, b1_rgb, w2_rgb, b2_rgb, w1_seg, b1_seg,
                    w2_seg, b2_seg, seg_dim: int = 20
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both heads on a CUDA bf16 ``feat`` through the taps kernel and the
    shift-add kernel; on a CPU ``feat`` through the plain version.  Same
    arguments as the plain version; not differentiable."""
    args = (feat, w1_rgb, b1_rgb, w2_rgb, b2_rgb, w1_seg, b1_seg, w2_seg,
            b2_seg)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise NotImplementedError(
            "fused_dual_head has no backward (the JAX kernel has none)")
    if not hw.use_kernel(feat):
        return fused_dual_head_plain(*args, seg_dim=seg_dim)
    _check_seg_dim(w2_seg, seg_dim)
    rgb_dim = w2_rgb.shape[-1]
    w1 = torch.cat([w1_rgb, w1_seg], dim=1)
    b1 = torch.cat([b1_rgb, b1_seg])
    w2t = build_dual_tap_kernel(_oihw(w2_rgb), _oihw(w2_seg), torch.bfloat16)
    out = _kernel(feat, w1, b1, w2t, torch.cat([b2_rgb, b2_seg]))
    return out[..., :rgb_dim], out[..., rgb_dim:]
