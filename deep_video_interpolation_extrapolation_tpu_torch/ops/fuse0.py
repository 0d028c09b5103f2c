"""K3: HRNet out-0 fuse sum, lrelu(y0 + up2(t1) [+ up4(t2)]), NHWC.

Counterpart of ``ops/pallas_fuse0.fused_out0_hwnc`` (stage-2 out-0) and
``fused_out0`` (stage-3 out-0): one function, one kernel here, since the
packed/HWNC output layouts were TPU devices.  Upsampling is the half-pixel,
edge-clamped bilinear of ``F.interpolate(align_corners=False)``.

The kernel is Triton.  Bound on the H100 at the main-path shape (B=1,
512x1024, C=64): no product at all; y0 64 MiB + t1 16 MiB + t2 4 MiB in,
64 MiB out = 148 MiB, 46 us of HBM time at 3.35 TB/s.  Design: one program
per 32 consecutive pixels x all 64 channels; the four bilinear neighbours
of t1 and t2 are gathered per pixel (they hit L2: t1/t2 are 4x/16x smaller
than the output), the sum and lrelu run in f32 and the result is rounded
once.  The plain version rounds where ``pallas_fuse0._ref`` rounds (each
upsampled part in the compute dtype, the sum and lrelu in f32).  The
backward recomputes the plain version and differentiates it
(``ops/recompute.py``), the JAX kernel's own rule.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import torch

from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.ops import _build
from deep_video_interpolation_extrapolation_tpu_torch.ops.recompute import (
    recompute_vjp,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.resize import (
    interpolate_bilinear,
)

NAME = "fuse_out0"
BLOCK_P = 32


def fuse_out0_plain(y0, t1, t2=None):
    """y0 (B,H,W,C); t1 (B,H/2,W/2,C); t2 (B,H/4,W/4,C) or None."""
    size = tuple(y0.shape[1:3])
    s = y0.float() + interpolate_bilinear(t1, size=size).float()
    if t2 is not None:
        s = s + interpolate_bilinear(t2, size=size).float()
    return torch.where(s >= 0, s, 0.2 * s).to(y0.dtype)


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    """The Triton kernel, defined on first use (triton is imported here:
    the CPU-only environments that import this module have none) and kept
    for the life of the process so its compiled variants stay cached.  The
    bilinear gather is written out once per part: the kernel body calls no
    other jitted function."""
    # Triton's cache goes beside the CUDA build, not under $HOME
    os.environ.setdefault("TRITON_CACHE_DIR", str(_build.BUILD / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def _fuse_out0(y0_ptr, t1_ptr, t2_ptr, out_ptr, n_pix, H, W, H1, W1, H2,
                   W2, sh1, sw1, sh2, sw2, C: tl.constexpr,
                   HAS_T2: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        pix = pid * BLOCK + tl.arange(0, BLOCK)
        pmask = pix < n_pix
        m2 = pmask[:, None]
        cc = tl.arange(0, C)[None, :]
        xx = pix % W
        t = pix // W
        yy = t % H
        b = (t // H).to(tl.int64)
        off = pix.to(tl.int64)[:, None] * C + cc
        acc = tl.load(y0_ptr + off, mask=m2, other=0.0).to(tl.float32)

        # up2(t1): half-pixel source coordinate, clamped at the edges
        fy = tl.maximum((yy.to(tl.float32) + 0.5) * sh1 - 0.5, 0.0)
        fx = tl.maximum((xx.to(tl.float32) + 0.5) * sw1 - 0.5, 0.0)
        ya = tl.minimum(fy.to(tl.int32), H1 - 1)
        xa = tl.minimum(fx.to(tl.int32), W1 - 1)
        yb = tl.minimum(ya + 1, H1 - 1)
        xb = tl.minimum(xa + 1, W1 - 1)
        ly = (fy - ya.to(tl.float32))[:, None]
        lx = (fx - xa.to(tl.float32))[:, None]
        rb = b * H1
        v00 = tl.load(t1_ptr + (((rb + ya) * W1 + xa) * C)[:, None] + cc,
                      mask=m2, other=0.0).to(tl.float32)
        v01 = tl.load(t1_ptr + (((rb + ya) * W1 + xb) * C)[:, None] + cc,
                      mask=m2, other=0.0).to(tl.float32)
        v10 = tl.load(t1_ptr + (((rb + yb) * W1 + xa) * C)[:, None] + cc,
                      mask=m2, other=0.0).to(tl.float32)
        v11 = tl.load(t1_ptr + (((rb + yb) * W1 + xb) * C)[:, None] + cc,
                      mask=m2, other=0.0).to(tl.float32)
        acc += ((1.0 - ly) * ((1.0 - lx) * v00 + lx * v01)
                + ly * ((1.0 - lx) * v10 + lx * v11))

        if HAS_T2:
            # up4(t2), the same gather at a quarter of the resolution
            fy = tl.maximum((yy.to(tl.float32) + 0.5) * sh2 - 0.5, 0.0)
            fx = tl.maximum((xx.to(tl.float32) + 0.5) * sw2 - 0.5, 0.0)
            ya = tl.minimum(fy.to(tl.int32), H2 - 1)
            xa = tl.minimum(fx.to(tl.int32), W2 - 1)
            yb = tl.minimum(ya + 1, H2 - 1)
            xb = tl.minimum(xa + 1, W2 - 1)
            ly = (fy - ya.to(tl.float32))[:, None]
            lx = (fx - xa.to(tl.float32))[:, None]
            rb = b * H2
            v00 = tl.load(t2_ptr + (((rb + ya) * W2 + xa) * C)[:, None] + cc,
                          mask=m2, other=0.0).to(tl.float32)
            v01 = tl.load(t2_ptr + (((rb + ya) * W2 + xb) * C)[:, None] + cc,
                          mask=m2, other=0.0).to(tl.float32)
            v10 = tl.load(t2_ptr + (((rb + yb) * W2 + xa) * C)[:, None] + cc,
                          mask=m2, other=0.0).to(tl.float32)
            v11 = tl.load(t2_ptr + (((rb + yb) * W2 + xb) * C)[:, None] + cc,
                          mask=m2, other=0.0).to(tl.float32)
            acc += ((1.0 - ly) * ((1.0 - lx) * v00 + lx * v01)
                    + ly * ((1.0 - lx) * v10 + lx * v11))

        acc = tl.where(acc >= 0, acc, 0.2 * acc)
        tl.store(out_ptr + off, acc.to(out_ptr.dtype.element_ty), mask=m2)

    return _fuse_out0


def fuse_out0(y0: torch.Tensor, t1: torch.Tensor,
              t2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fuse sum on CUDA bf16 tensors through the Triton kernel; on CPU
    tensors through the plain version.  Differentiable."""
    return recompute_vjp(_kernel, fuse_out0_plain, y0, t1, t2)


def _kernel(y0, t1, t2):
    b, h, w, c = y0.shape
    if c & (c - 1):
        raise ValueError(f"kernel takes a power-of-two C, got {c}")
    hw.check_bf16("y0", y0)
    hw.check_bf16("t1", t1)
    if t1.shape[0] != b or t1.shape[3] != c:
        raise ValueError(f"t1 {tuple(t1.shape)} does not match y0 "
                         f"{tuple(y0.shape)}")
    if t2 is not None:
        hw.check_bf16("t2", t2)
        if t2.shape[0] != b or t2.shape[3] != c:
            raise ValueError(f"t2 {tuple(t2.shape)} does not match y0 "
                             f"{tuple(y0.shape)}")
    h1, w1 = t1.shape[1:3]
    h2, w2 = (t2.shape[1:3] if t2 is not None else (1, 1))
    out = torch.empty_like(y0)
    n_pix = b * h * w
    kern = _triton_kernel()
    with torch.cuda.device(y0.device):
        kern[((n_pix + BLOCK_P - 1) // BLOCK_P,)](
            y0, t1, t2 if t2 is not None else t1, out, n_pix, h, w, h1, w1,
            h2, w2, h1 / h, w1 / w, h2 / h, w2 / w, C=c,
            HAS_T2=t2 is not None, BLOCK=BLOCK_P, num_warps=4)
    hw.launches[NAME] += 1
    return out
