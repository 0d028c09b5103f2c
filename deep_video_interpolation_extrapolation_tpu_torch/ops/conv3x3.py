"""K1: 3x3 stride-1 SAME conv + bias + residual + leaky-ReLU, NHWC.

Counterpart of ``ops/pallas_ae_conv.conv3x3_packed_ae_hwnc`` (and of its
NHWC-packed twin ``conv3x3_packed_ae``).  The kernel is
``csrc/conv3x3.cu``; the plain version rounds where the JAX reference
``_ref_hwnc`` rounds (conv output in the compute dtype, then bias, residual
and lrelu in that dtype); the kernel adds bias and residual and applies the
lrelu in f32 and rounds once.  The kernel takes Cin = 64 or 256 and Cout =
64 (every site of the main path), any (B, H, W).  The backward recomputes
the plain version and differentiates it (``ops/recompute.py``), the JAX
kernel's own rule.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.ops import (
    _build,
    bbchain,
    trainchain,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.recompute import (
    recompute_vjp,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.resize import (
    nchw,
    nhwc,
)
from deep_video_interpolation_extrapolation_tpu_torch.parallel import spatial

NAME = "conv3x3_bias_res_lrelu"


def conv3x3_bias_res_lrelu_plain(x, w, bias=None, res=None, relu=True):
    """x (B,H,W,Cin); w (Cout,Cin,3,3) torch layout, any float dtype (cast
    to x's dtype); bias (Cout,) or None; res (B,H,W,Cout) or None.  On a
    band, with its neighbours' rows (``spatial.conv2d``)."""
    dt = x.dtype
    out = nhwc(spatial.conv2d(nchw(x), w.to(dt), padding=1))
    if bias is not None:
        out = out + bias.to(dt)
    if res is not None:
        out = out + res
    if relu:
        out = F.leaky_relu(out, 0.2)
    return out


def conv3x3_bias_res_lrelu(x: torch.Tensor, w: torch.Tensor,
                           bias: Optional[torch.Tensor] = None,
                           res: Optional[torch.Tensor] = None,
                           relu: bool = True) -> torch.Tensor:
    """The conv on a CUDA bf16 tensor through the Hopper kernel; on a CPU
    tensor through the plain version.  Same arguments as the plain
    version; differentiable.  Without a gradient, through its op
    ``dvie::conv3x3``."""
    if hw.serving(x, w, bias, res):
        return torch.ops.dvie.conv3x3(x, w, bias, res, relu)
    return recompute_vjp(_kernel, conv3x3_bias_res_lrelu_plain, x, w, bias,
                         res, relu)


def pick_tile(cin: int, cout: int, b: int, h: int, w: int) -> Tuple[int, int]:
    """The kernel's pixel tile (rows, columns) for a (b, h, w, cin) input
    and ``cout`` outputs: 4x16 a warpgroup group at Cin = 64, 8x16 at Cin
    = 256 (csrc/conv3x3.cu); raises ``ValueError`` for a shape the kernel
    cannot take (Cin other than 64 or 256, Cout other than 64, an empty
    input, too many pixels for 32-bit indices).  Ragged edges are masked
    in the kernel, so any other (b, h, w) takes the tile."""
    if cin not in (64, 256) or cout != 64:
        raise ValueError(f"kernel takes Cin in (64, 256) and Cout == 64, "
                         f"got Cin={cin} Cout={cout}")
    if min(b, h, w) < 1:
        raise ValueError(f"kernel: empty input {b}x{h}x{w}")
    if b * h * w >= 2**31 - 4096:
        raise ValueError("kernel indexes pixels with 32-bit ints: "
                         f"{b}x{h}x{w} is too many")
    return (4, 16) if cin == 64 else (8, 16)


def conv_units(w: torch.Tensor, dev) -> torch.Tensor:
    """OIHW 3x3 weight (64, Cin, 3, 3) -> the kernel's weight units, bf16
    (Cin / 64 * 9, 8, 64, 8): unit kc * 9 + t holds tap t = ky * 3 + kx
    of input channels [64 kc, 64 kc + 64), w[n, 64 kc + 8 g + k, ky, kx]
    at [g, n, k] (the no-swizzle K-major core-matrix order of
    csrc/hopper.cuh), in the order the kernel consumes them."""
    u = bbchain._units(trainchain._taps(w, dev))    # (9, Cin/64, 8, 64, 8)
    return u.transpose(0, 1).reshape(-1, 8, w.shape[0], 8).contiguous()


def weights(w: torch.Tensor, bias: Optional[torch.Tensor], dev
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The kernel's weight units (``conv_units``) and its bf16 bias (or
    None) on ``dev``, built once per weight (``hw.derived``)."""
    def build():
        bk = (None if bias is None else
              bias.to(device=dev, dtype=torch.bfloat16).contiguous())
        return conv_units(w, dev), bk
    return hw.derived(f"{NAME}:{dev}", (w, bias), build)


def _kernel(x, w, bias, res, relu):
    b, h, wd, cin = x.shape
    cout = w.shape[0]
    if tuple(w.shape) != (cout, cin, 3, 3):
        raise ValueError(f"weight shape {tuple(w.shape)} does not match "
                         f"Cin={cin}")
    pick_tile(cin, cout, b, h, wd)
    hw.check_bf16("x", x)
    wu, bk = weights(w, bias, x.device)
    if bk is not None:
        hw.check_bf16("bias", bk, (cout,))
    if res is not None:
        hw.check_bf16("res", res, (b, h, wd, cout))
    out = torch.empty((b, h, wd, cout), device=x.device, dtype=torch.bfloat16)
    err = _build.library().dvie_conv3x3(
        _build.ptr(x), _build.ptr(wu), _build.ptr(bk), _build.ptr(res),
        _build.ptr(out), b, h, wd, cin, cout, int(relu), _build.stream(x))
    _build.check_launch(NAME, err)
    hw.launches[NAME] += 1
    return out
