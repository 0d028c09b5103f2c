"""The heads' 9-way shifted add + bias over a taps tensor, NHWC.

Counterpart of ``ops/pallas_shiftadd.shifted_add_bias``: given the
(B, H, W, 9*co) taps tensor of a taps-in-N 3x3 conv (K4, the 4-part head
or the dual head write it) and the bias b2 (co,),

    out[b, y, x, c] = b2[c] + sum_{ky, kx} yt[b, y+ky-1, x+kx-1, (3ky+kx)*co + c]

with yt zero outside the image (SAME padding), summed in f32 and rounded
once to yt's dtype.  The plain version is the JAX ``_ref``; the kernel is
``csrc/shiftadd.cu``, in two instances: co = 23 (every head but one,
counter ``shifted_add_bias``) and co = 24 (ExtraInpaintNet's with
``--inpaint_mask``, counter ``shiftadd_co24``).  The op is linear, so its backward needs no forward
and keeps no tensor: the adjoint shifted add of the output grad (zero
outside the image) and the bias grad as its sum over pixels, the vjp of
``_ref`` that the JAX ``custom_vjp`` takes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.ops import _build
from deep_video_interpolation_extrapolation_tpu_torch.parallel import spatial

NAME = "shifted_add_bias"


def _co(yt: torch.Tensor, b2: torch.Tensor) -> int:
    co = b2.shape[0]
    if b2.dim() != 1 or yt.dim() != 4 or yt.shape[-1] != 9 * co:
        raise ValueError(f"taps tensor {tuple(yt.shape)} and bias "
                         f"{tuple(b2.shape)}: expected (B,H,W,9*co) and (co,)")
    return co


def shifted_add_bias_plain(yt: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """yt (B,H,W,9*co), b2 (co,) -> (B,H,W,co) in yt's dtype.  On a band
    the rows above and below are the neighbouring bands' (``spatial.halo``),
    zero beyond the image."""
    co = _co(yt, b2)
    b, h, w, _ = yt.shape
    ytp = F.pad(spatial.halo(yt, 1, 1).float().reshape(b, h + 2, w, 9, co),
                (0, 0, 0, 0, 1, 1))
    out = None
    for ky in range(3):
        for kx in range(3):
            sl = ytp[:, ky:ky + h, kx:kx + w, ky * 3 + kx]
            out = sl if out is None else out + sl
    return (out + b2.float()).to(yt.dtype)


# the kernel's tiling (csrc/shiftadd.cu): co = CO, the width of every
# head but ExtraInpaintNet's with --inpaint_mask (CO24); a block owns
# STRIP_W output columns of STRIP_ROWS rows and keeps RING yt row segments
# in shared memory
CO, CO24, STRIP_W, STRIP_ROWS, RING = 23, 24, 32, 16, 5
# the instances: co -> (C entry, launch counter)
INSTANCES = {CO: ("dvie_shifted_add_bias", NAME),
             CO24: ("dvie_shifted_add_bias_co24", "shiftadd_co24")}


def plan(b: int, h: int, w: int, co: int):
    """The kernel's grid for a (b, h, w, 9*co) taps tensor, or a
    ValueError for what it does not take."""
    if co not in INSTANCES:
        raise ValueError(f"kernel takes co = {CO} or {CO24} (the heads' "
                         f"widths), got {co}")
    if b * h * w == 0:
        raise ValueError("kernel takes a non-empty taps tensor")
    return -(-w // STRIP_W), -(-h // STRIP_ROWS), b


def _kernel(yt: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    co = _co(yt, b2)
    b, h, w, _ = yt.shape
    plan(b, h, w, co)
    hw.check_bf16("yt", yt)
    b2k = b2.to(device=yt.device, dtype=torch.float32).contiguous()
    out = torch.empty((b, h, w, co), device=yt.device, dtype=torch.bfloat16)
    entry, counter = INSTANCES[co]
    err = getattr(_build.library(), entry)(
        _build.ptr(yt), _build.ptr(b2k), _build.ptr(out), b, h, w,
        _build.stream(yt))
    _build.check_launch(counter, err)
    hw.launches[counter] += 1
    return out


def shifted_add_bias_bwd(g: torch.Tensor, yt_dtype: torch.dtype,
                         b2_dtype: torch.dtype):
    """The vjp of the shifted add: (dyt, db2) for the output grad g
    (B,H,W,co), in f32 and rounded once to the operands' dtypes:
    ``dyt[b, y, x, (3ky+kx)*co + c] = g[b, y-ky+1, x-kx+1, c]``, zero
    outside the image, and ``db2 = sum of g over b, y, x``."""
    b, h, w, co = g.shape
    gp = F.pad(g.float(), (0, 0, 1, 1, 1, 1))
    taps = [gp[:, 2 - ky:2 - ky + h, 2 - kx:2 - kx + w]
            for ky in range(3) for kx in range(3)]
    dyt = torch.stack(taps, dim=3).reshape(b, h, w, 9 * co)
    return dyt.to(yt_dtype), g.float().sum((0, 1, 2)).to(b2_dtype)


class _ShiftedAddBias(torch.autograd.Function):
    @staticmethod
    def forward(ctx, yt, b2):
        ctx.dtypes = (yt.dtype, b2.dtype)
        if hw.use_kernel(yt):
            return _kernel(yt, b2)
        return shifted_add_bias_plain(yt, b2)

    @staticmethod
    def backward(ctx, g):
        return shifted_add_bias_bwd(g, *ctx.dtypes)


def shifted_add_bias(yt: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The shifted add + bias on a CUDA bf16 tensor through the Hopper
    kernel; on a CPU tensor through the plain version.  Differentiable,
    by ``shifted_add_bias_bwd``.  Without a gradient, through its op
    ``dvie::shifted_add_bias``."""
    if hw.serving(yt, b2):
        return torch.ops.dvie.shifted_add_bias(yt, b2)
    return _ShiftedAddBias.apply(yt, b2)
