"""The warp-fusion refine U-Net (counterpart of models/optical.py's
``_WarpUNet`` :36-67 and ``RefineUnet`` :101-119; reference
nets/OpticalUnet.py:151-232): the Config's default ``--refine_model``
(``refineUnet``).  It runs no grid sample; ``OpticalUnet`` and
``OpticalRefineNet`` wait in ROADMAP.md queue 1 (item 8).

The layers carry the JAX module names (``unet.encoder_1_0``, ...,
``unet.output_layer``); the reference's torch names are not known to the
JAX package (it has no torch_port mapper for this module).  Every layer
computes in ``dtype``; the parameters are f32 masters.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.models.blocks import (
    Conv,
    ConvT,
    lrelu,
)


class WarpUNet(nn.Module):
    """Encoder/decoder skeleton: per level ``enc_convs`` ConvLReLUs of
    kernel ``enc_kernels`` (the first of stride 2 below level 1), a
    ``bottom``-wide stride-2 bottom of ``dec_convs`` ConvLReLUs, per level
    an lrelu'd ConvT x2, the skip concat and ``dec_convs`` 3x3
    ConvLReLUs, then a linear ``out_kernel`` conv to ``out_dim``."""

    def __init__(self, cin: int, out_dim: int,
                 widths: Sequence[int] = (32, 64, 128, 256), bottom: int = 512,
                 enc_kernels: Sequence[int] = (7, 5, 3, 3),
                 enc_convs: Sequence[int] = (3, 4, 4, 4), dec_convs: int = 4,
                 out_kernel: int = 5):
        super().__init__()
        self.widths = tuple(widths)
        self.enc_convs = tuple(enc_convs)
        self.dec_convs = dec_convs
        c = cin
        for li, (w, k, n) in enumerate(zip(widths, enc_kernels, enc_convs)):
            for ci in range(n):
                stride = 2 if li > 0 and ci == 0 else 1
                setattr(self, f"encoder_{li + 1}_{ci}", Conv(c, w, k, stride))
                c = w
        for ci in range(dec_convs):
            setattr(self, f"bottom_{ci}",
                    Conv(c, bottom, 3, 2 if ci == 0 else 1))
            c = bottom
        for li in range(len(widths) - 1, -1, -1):
            w = widths[li]
            setattr(self, f"up_{li + 1}", ConvT(c, w))
            c = 2 * w
            for ci in range(dec_convs):
                setattr(self, f"decoder_{li + 1}_{ci}", Conv(c, w, 3))
                c = w
        self.output_layer = Conv(c, out_dim, out_kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        h = x
        for li, n in enumerate(self.enc_convs):
            for ci in range(n):
                h = lrelu(getattr(self, f"encoder_{li + 1}_{ci}")(h))
            skips.append(h)
        for ci in range(self.dec_convs):
            h = lrelu(getattr(self, f"bottom_{ci}")(h))
        for li in range(len(self.widths) - 1, -1, -1):
            h = lrelu(getattr(self, f"up_{li + 1}")(h))
            h = torch.cat([h, skips[li]], dim=-1)
            for ci in range(self.dec_convs):
                h = lrelu(getattr(self, f"decoder_{li + 1}_{ci}")(h))
        return self.output_layer(h)


class RefineUnet(nn.Module):
    """``forward(img1, mask1=None, img2=None, mask2=None)``: the channel
    concat of the given inputs -> one fused rgb (B,H,W,3) in ``dtype``.
    The refine composites call it with (coarse rgb, soft seg, encoded
    features): 3 + 20 + 14 = ``cin`` channels.  H and W must divide by 16
    (four stride-2 levels)."""

    def __init__(self, cin: int = 37, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.unet = WarpUNet(cin, 3, widths=(32, 64, 128, 256), bottom=256,
                             enc_kernels=(3, 3, 3, 3), enc_convs=(3, 3, 3, 3),
                             dec_convs=3, out_kernel=3)

    def forward(self, img1, mask1=None, img2=None, mask2=None
                ) -> torch.Tensor:
        parts = [p for p in (img1, mask1, img2, mask2) if p is not None]
        return self.unet(torch.cat([p.to(self.dtype) for p in parts], dim=-1))
