"""UNet and SepUNet generators (counterpart of the JAX package's
``models/unet.py``: reference nets/UNet.py:16-157, nets/SepUNet.py:12-71).

NHWC.  Unlike HRNet these carry BatchNorms (``subnets.BatchNorm``: flax's
momentum and biased running variance), so every forward takes ``train``.
Submodules carry the flax module names (``Conv_0``, ``BatchNorm_0``,
``encoder_0``, ...), so ``tools/jax_weights.flax_key_map`` maps a JAX tree
onto them one to one.  Each conv computes in ``dtype`` (None: its input's),
each BatchNorm returns ``dtype`` (None: f32), as the JAX modules do.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.models.blocks import (
    Conv,
    SegEncoder,
    lrelu0,
)
from deep_video_interpolation_extrapolation_tpu_torch.models.subnets import (
    BatchNorm,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.resize import (
    interpolate_bilinear,
)


def conv_bn_lrelu(conv: Conv, bn: BatchNorm, x: torch.Tensor, train: bool,
                  dtype: Optional[torch.dtype]) -> torch.Tensor:
    """conv -> BatchNorm -> LeakyReLU(0.2) (the JAX lrelu's derivative at 0:
    a train-mode BatchNorm can put a whole channel there)."""
    return lrelu0(bn(conv(x, dtype), train, dtype))


class DoubleConv(nn.Module):
    """(conv => BN => LeakyReLU) * 2 (nets/UNet.py:16-31)."""

    def __init__(self, cin: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(cin, features, 3)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = Conv(features, features, 3)
        self.BatchNorm_1 = BatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = conv_bn_lrelu(self.Conv_0, self.BatchNorm_0, x, train, self.dtype)
        return conv_bn_lrelu(self.Conv_1, self.BatchNorm_1, x, train,
                             self.dtype)


class Down(nn.Module):
    """stride-2 conv + BN + LeakyReLU + double conv (nets/UNet.py:47-62)."""

    def __init__(self, cin: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(cin, features, 3, stride=2)
        self.BatchNorm_0 = BatchNorm(features)
        self.DoubleConv_0 = DoubleConv(features, features, dtype)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = conv_bn_lrelu(self.Conv_0, self.BatchNorm_0, x, train, self.dtype)
        return self.DoubleConv_0(x, train)


class Up(nn.Module):
    """bilinear 2x upsample (align_corners) + double conv
    (nets/UNet.py:65-96); ``skip`` is concatenated first when given."""

    def __init__(self, cin: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.DoubleConv_0 = DoubleConv(cin, features, dtype)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None,
                train: bool = True) -> torch.Tensor:
        x = interpolate_bilinear(x, scale_factor=2.0, align_corners=True)
        if skip is not None:
            x = torch.cat([skip, x], dim=-1)
        return self.DoubleConv_0(x, train)


def _encode(seg_encoder: SegEncoder, seg: torch.Tensor, i: int,
            dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The seg embedding of frame ``i`` of the 40-channel seg pair."""
    return seg_encoder(seg[..., i * 20:(i + 1) * 20], dtype)


def _heads(model: nn.Module, d0: torch.Tensor):
    """tanh rgb head and seg logits of the UNets' last features."""
    return (torch.tanh(model.rgb_decoder(d0, model.dtype)),
            model.seg_decoder(d0, model.dtype))


class UNet(nn.Module):
    """4-down/4-up UNet with a SegEncoder and a tanh rgb head
    (nets/UNet.py:109-157).  ``forward(rgb, seg, train=True)``: rgb
    (B,H,W,6) two frames, seg (B,H,W,40) one-hot -> (rgb (B,H,W,3), seg
    logits (B,H,W,20)).  H and W divide by 8."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.seg_encoder = SegEncoder()
        self.encoder_0 = DoubleConv(6 + 8, 64, dtype)
        self.encoder_1 = Down(64, 128, dtype)
        self.encoder_2 = Down(128, 256, dtype)
        self.encoder_3 = Down(256, 256, dtype)
        self.decoder_3 = Up(256, 256, dtype)
        self.decoder_2 = Up(256 + 256, 128, dtype)
        self.decoder_1 = Up(128 + 128, 64, dtype)
        self.decoder_0 = DoubleConv(64 + 64, 32, dtype)
        self.rgb_decoder = Conv(32, 3, 3)
        self.seg_decoder = Conv(32, 20, 3)

    def forward(self, rgb: torch.Tensor, seg: torch.Tensor,
                train: bool = True):
        encoded = [_encode(self.seg_encoder, seg, i, self.dtype)
                   for i in range(2)]
        x = torch.cat([rgb] + [e.to(rgb.dtype) for e in encoded], dim=-1)
        e0 = self.encoder_0(x, train)
        e1 = self.encoder_1(e0, train)
        e2 = self.encoder_2(e1, train)
        e3 = self.encoder_3(e2, train)
        d3 = self.decoder_3(e3, train=train)
        d2 = self.decoder_2(torch.cat([d3, e2], -1), train=train)
        d1 = self.decoder_1(torch.cat([d2, e1], -1), train=train)
        d0 = self.decoder_0(torch.cat([d1, e0], -1), train)
        return _heads(self, d0)


class SepUNet(nn.Module):
    """Separate foreground / background stream UNet (nets/SepUNet.py:12-71):
    the seg embeddings split by each frame's foreground mask feed two
    encoder streams whose skips both reach the decoder.
    ``forward(rgb, seg, fg_mask, train=True)`` with fg_mask (B,H,W,2)."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.seg_encoder = SegEncoder()
        for p in ("fg", "bg"):
            setattr(self, f"{p}_encoder_0", DoubleConv(6 + 8, 32, dtype))
            setattr(self, f"{p}_encoder_1", Down(32, 64, dtype))
            setattr(self, f"{p}_encoder_2", Down(64, 128, dtype))
            setattr(self, f"{p}_encoder_3", Down(128, 128, dtype))
        self.decoder_3 = Up(128 + 128, 256, dtype)
        self.decoder_2 = Up(256 + 128 + 128, 128, dtype)
        self.decoder_1 = Up(128 + 64 + 64, 64, dtype)
        self.decoder_0 = DoubleConv(64 + 32 + 32, 32, dtype)
        self.rgb_decoder = Conv(32, 3, 3)
        self.seg_decoder = Conv(32, 20, 3)

    def _stream(self, x: torch.Tensor, prefix: str, train: bool):
        e0 = getattr(self, f"{prefix}_encoder_0")(x, train)
        e1 = getattr(self, f"{prefix}_encoder_1")(e0, train)
        e2 = getattr(self, f"{prefix}_encoder_2")(e1, train)
        e3 = getattr(self, f"{prefix}_encoder_3")(e2, train)
        return e0, e1, e2, e3

    def forward(self, rgb: torch.Tensor, seg: torch.Tensor,
                fg_mask: torch.Tensor, train: bool = True):
        enc = [_encode(self.seg_encoder, seg, i, self.dtype)
               for i in range(2)]
        fg = torch.cat([enc[i] * fg_mask[..., i:i + 1] for i in range(2)], -1)
        bg = torch.cat([enc[i] * (1 - fg_mask[..., i:i + 1])
                        for i in range(2)], -1)
        f0, f1, f2, f3 = self._stream(torch.cat([rgb, fg.to(rgb.dtype)], -1),
                                      "fg", train)
        b0, b1, b2, b3 = self._stream(torch.cat([rgb, bg.to(rgb.dtype)], -1),
                                      "bg", train)
        d3 = self.decoder_3(torch.cat([f3, b3], -1), train=train)
        d2 = self.decoder_2(torch.cat([d3, f2, b2], -1), train=train)
        d1 = self.decoder_1(torch.cat([d2, f1, b1], -1), train=train)
        d0 = self.decoder_0(torch.cat([d1, f0, b0], -1), train)
        return _heads(self, d0)
