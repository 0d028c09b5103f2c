"""The voxel-flow warp networks (counterpart of models/optical.py;
reference nets/OpticalUnet.py):

- ``WarpUNet`` (optical.py:36-67), the encoder/decoder skeleton of both;
- ``OpticalUnet`` (:70-98): the skeleton at its defaults to 6 channels,
  tanh'd into forward and backward flows and masks; both frames are
  backward-warped by ``ops/warp.grid_sample_border`` (border padding, the
  coordinates in f32, weights and sums in the frame's dtype, as the JAX
  function) and multiplied by their masks ``0.5 * (1 + tanh)``;
- ``RefineUnet`` (:101-116), the warp-fusion refiner: the Config's default
  ``--refine_model`` (``refineUnet``);
- ``OpticalRefineNet`` (:119-131): OpticalUnet, then RefineUnet on its two
  masked warps and masks; returns JAX's 7-tuple.

The warp is the plain gather composition, as JAX's is XLA.  The layers
carry the JAX module names (``unet.encoder_1_0``, ...,
``unet.output_layer``); the reference's torch names are not known to the
JAX package (it has no torch_port mapper for these modules).  Every layer
computes in ``dtype``; the parameters are f32 masters.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.models.blocks import (
    Conv,
    ConvT,
    lrelu,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.warp import (
    grid_sample_border,
    make_base_grid,
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


class OpticalUnet(nn.Module):
    """``forward(rgb)``: two frames (B,H,W,6) -> (for_output, for_flow,
    for_mask, back_output, back_flow, back_mask): each flow (B,H,W,2) and
    mask (B,H,W,1) in ``dtype``; each output the frame warped by its flow
    (``base - for_flow`` and ``base + back_flow`` in normalized
    coordinates) times its mask, promoted to the wider of the frame's dtype
    and ``dtype``, as the JAX product is.  H and W divide by 16."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.unet = WarpUNet(6, 6)

    def forward(self, rgb: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        _, h, w, _ = rgb.shape
        out = torch.tanh(self.unet(rgb[..., :6].to(self.dtype)))
        for_flow, for_mask = out[..., 0:2], out[..., 2:3]
        back_flow, back_mask = out[..., 3:5], out[..., 5:6]
        base = make_base_grid(h, w, device=rgb.device)[None]
        for_out = grid_sample_border(rgb[..., 0:3], base - for_flow.float())
        back_out = grid_sample_border(rgb[..., 3:6], base + back_flow.float())
        for_mask = 0.5 * (1.0 + for_mask)
        back_mask = 0.5 * (1.0 + back_mask)
        return (for_out * for_mask, for_flow, for_mask, back_out * back_mask,
                back_flow, back_mask)


class OpticalRefineNet(nn.Module):
    """``forward(rgb)``: OpticalUnet, then RefineUnet on (for_output,
    for_mask, back_output, back_mask) -> (output, for_output, for_flow,
    for_mask, back_output, back_flow, back_mask) (:119-131)."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.coarse_model = OpticalUnet(dtype)
        self.refine_model = RefineUnet(cin=8, dtype=dtype)

    def forward(self, rgb: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        coarse = self.coarse_model(rgb)
        for_out, _, for_mask, back_out, _, back_mask = coarse
        return (self.refine_model(for_out, for_mask, back_out, back_mask),
                *coarse)
