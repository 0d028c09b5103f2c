"""K1: 3x3 stride-1 SAME conv + bias + residual + leaky-ReLU, NHWC.

Counterpart of ``ops/pallas_ae_conv.conv3x3_packed_ae_hwnc`` (and of its
NHWC-packed twin ``conv3x3_packed_ae``).  The kernel is
``csrc/conv3x3.cu``; the plain version rounds where the JAX reference
``_ref_hwnc`` rounds (conv output in the compute dtype, then bias, residual
and lrelu in that dtype).  The backward recomputes the plain version and
differentiates it (``ops/recompute.py``), the JAX kernel's own rule.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.ops import _build
from deep_video_interpolation_extrapolation_tpu_torch.ops.recompute import (
    recompute_vjp,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.resize import (
    nchw,
    nhwc,
)

NAME = "conv3x3_bias_res_lrelu"


def conv3x3_bias_res_lrelu_plain(x, w, bias=None, res=None, relu=True):
    """x (B,H,W,Cin); w (Cout,Cin,3,3) torch layout, any float dtype (cast
    to x's dtype); bias (Cout,) or None; res (B,H,W,Cout) or None."""
    dt = x.dtype
    out = nhwc(F.conv2d(nchw(x), w.to(dt), padding=1))
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
    version; differentiable."""
    return recompute_vjp(_kernel, conv3x3_bias_res_lrelu_plain, x, w, bias,
                         res, relu)


def _kernel(x, w, bias, res, relu):
    b, h, wd, cin = x.shape
    cout = w.shape[0]
    if tuple(w.shape) != (cout, cin, 3, 3):
        raise ValueError(f"weight shape {tuple(w.shape)} does not match "
                         f"Cin={cin}")
    if cin % 64 or cout % 64:
        raise ValueError(f"kernel takes Cin % 64 == 0 and Cout % 64 == 0, "
                         f"got Cin={cin} Cout={cout}")
    if b * h * wd >= 2**31 - 256:
        raise ValueError("kernel indexes pixels with 32-bit ints: "
                         f"{b}x{h}x{wd} is too many")
    hw.check_bf16("x", x)
    wk = w.to(device=x.device, dtype=torch.bfloat16).permute(
        2, 3, 1, 0).contiguous()                       # HWIO
    bk = None
    if bias is not None:
        bk = bias.to(device=x.device, dtype=torch.bfloat16).contiguous()
        hw.check_bf16("bias", bk, (cout,))
    if res is not None:
        hw.check_bf16("res", res, (b, h, wd, cout))
    out = torch.empty((b, h, wd, cout), device=x.device, dtype=torch.bfloat16)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.library().dvie_conv3x3(
        _build.ptr(x), _build.ptr(wk), _build.ptr(bk), _build.ptr(res),
        _build.ptr(out), b, h, wd, cin, cout, int(relu), stream)
    _build.check_launch(NAME, err)
    hw.launches[NAME] += 1
    return out
