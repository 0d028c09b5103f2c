"""Frame and video discriminator families (counterpart of
models/discriminators.py; the reference's nets/FrameDisc.py and
nets/VidDisc.py), on NHWC tensors.

Spectral normalisation is flax's ``nn.SpectralNorm`` around a conv
(``SNConv``), not torch's parametrization: one power-iteration step per
forward on the kernel as its (kh*kw*cin, cout) matrix from the stored ``u``
(1, cout), ``u`` and ``v`` without gradient, ``sigma = v W u^T`` with it,
the kernel divided by sigma, the bias untouched; a train forward stores the
new ``u`` and ``sigma``, an eval forward computes them the same way and
stores nothing.  torch's parametrization skips the iteration in eval and
iterates on W as (cout, ...), so its numbers differ.

Global discriminators end in a mean over (H, W, C): a (B,) logit.  Local
ones return a (B, h, w, 1) patch map.  ``seg_disc`` concatenates the
20-channel seg maps to the images.

Each container keeps its children in call order with the flax names they
have in the JAX tree (``names``), which ``tools/jax_weights`` maps.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from deep_video_interpolation_extrapolation_tpu_torch.models.blocks import (
    Conv,
    lrelu,
)
from deep_video_interpolation_extrapolation_tpu_torch.models.subnets import (
    BatchNorm,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.resize import (
    nchw,
    nhwc,
)


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    """flax's ``_l2_normalize``: x * rsqrt(sum(x^2) + eps)."""
    return x * torch.rsqrt((x * x).sum() + eps)


class SNConv(nn.Module):
    """flax ``nn.SpectralNorm(nn.Conv(...))``: a conv with ``padding``
    (default kernel // 2) whose kernel is divided by its spectral norm,
    estimated by one power-iteration step a forward.  Buffers ``u`` (1,
    cout) and ``sigma`` (), f32."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 stride: int = 1, padding: Optional[int] = None,
                 eps: float = 1e-12):
        super().__init__()
        self.stride = stride
        self.padding = kernel // 2 if padding is None else padding
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.register_buffer("u", torch.ones(1, cout))
        self.register_buffer("sigma", torch.ones(()))

    def normalized_weight(self, update_stats: bool) -> torch.Tensor:
        w = self.weight
        o, i, kh, kw = w.shape
        mat = w.permute(2, 3, 1, 0).reshape(kh * kw * i, o)   # HWIO rows
        with torch.no_grad():
            m = mat.detach().float()
            v0 = _l2_normalize(self.u @ m.t(), self.eps)
            u0 = _l2_normalize(v0 @ m, self.eps)
        sigma = (v0 @ mat.float() @ u0.t())[0, 0]
        mat = mat / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u0)
                self.sigma.copy_(sigma.detach())
        return mat.reshape(kh, kw, i, o).permute(3, 2, 0, 1)

    def forward(self, x: torch.Tensor, update_stats: bool,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dt = dtype or x.dtype
        w = self.normalized_weight(update_stats)
        out = nhwc(F.conv2d(nchw(x.to(dt)), w.to(dt), stride=self.stride,
                            padding=self.padding))
        return out + self.bias.to(dt)


class Block(nn.Module):
    """A conv (SN or plain), optional BatchNorm, optional lrelu
    (``_Block``); the conv's flax name is ``_SNConv_0`` or ``Conv_0``."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 stride: int = 1, sn: bool = False, bn: bool = False,
                 act: bool = True):
        super().__init__()
        self.sn, self.act = sn, act
        self.conv = (SNConv(cin, cout, kernel, stride) if sn
                     else Conv(cin, cout, kernel, stride))
        self.bn = BatchNorm(cout) if bn else None

    def forward(self, x: torch.Tensor, train: bool,
                dtype: Optional[torch.dtype]) -> torch.Tensor:
        x = (self.conv(x, train, dtype) if self.sn
             else self.conv(x, dtype))
        if self.bn is not None:
            x = self.bn(x, train, dtype)
        return lrelu(x) if self.act else x


class Seq(nn.Module):
    """Children applied in order, each named as the flax tree names it
    (``names``: ``_Block_k``, ``_ResBlock_k``, ...)."""

    def __init__(self):
        super().__init__()
        self.layers = nn.ModuleList()
        self.names: List[str] = []
        self._count = {}

    def add(self, module: nn.Module) -> nn.Module:
        cls = {Block: "_Block", ResBlock: "_ResBlock",
               SNResBlock: "_SNResBlock"}[type(module)]
        k = self._count.get(cls, 0)
        self._count[cls] = k + 1
        self.names.append(f"{cls}_{k}")
        self.layers.append(module)
        return module

    def block(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
              sn: bool = False, bn: bool = False, act: bool = True) -> int:
        self.add(Block(cin, cout, kernel, stride, sn, bn, act))
        return cout

    def forward(self, x: torch.Tensor, train: bool,
                dtype: Optional[torch.dtype]) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, train, dtype)
        return x


class ResBlock(Seq):
    """Two 3x3 blocks (the second without lrelu) plus the input
    (``_ResBlock``)."""

    def __init__(self, features: int, sn: bool = False):
        super().__init__()
        self.block(features, features, sn=sn)
        self.block(features, features, sn=sn, act=False)

    def forward(self, x, train, dtype):
        return super().forward(x, train, dtype) + x


class SNResBlock(Seq):
    """Two SN 3x3 blocks (the second without lrelu), the input through an
    SN 1x1 without lrelu where the widths differ, summed, then lrelu
    (``_SNResBlock``, detdisc.py:189-199; the reference's ResnetSNBlock)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.block(cin, features, sn=True)
        self.block(features, features, sn=True, act=False)
        if cin != features:
            self.block(cin, features, 1, sn=True, act=False)

    def forward(self, x, train, dtype):
        h = self.layers[1](self.layers[0](x, train, dtype), train, dtype)
        if len(self.layers) == 3:
            x = self.layers[2](x, train, dtype)
        return lrelu(h + x)


def scalar_head(x: torch.Tensor) -> torch.Tensor:
    """Mean over (H, W, C) -> (B,) logits, accumulated in f32."""
    return x.float().mean(dim=(1, 2, 3)).to(x.dtype)


def image_channels(seg_disc: bool) -> int:
    return 3 + 20 if seg_disc else 3


class _Disc(Seq):
    """A discriminator tower; ``dtype`` is the compute dtype."""

    def __init__(self, seg_disc: bool, sn: bool, dtype):
        super().__init__()
        self.seg_disc, self.sn, self.dtype = seg_disc, sn, dtype


class FrameDiscriminator(_Disc):
    """Global single-frame discriminator (discriminators.py:89-108):
    ``forward(x, seg=None, bboxes=None, train=False)`` -> (B,)."""

    def __init__(self, seg_disc: bool = False, sn: bool = False,
                 dtype=None):
        super().__init__(seg_disc, sn, dtype)
        c = self.block(image_channels(seg_disc), 16, 3, sn=sn)
        c = self.block(c, 32, 5, sn=sn, bn=not sn)
        # the SN variant stops at 128 channels, 3 downsamples
        for ch in ((64, 96, 128) if sn else (64, 96, 128, 192)):
            c = self.block(c, ch, 3, stride=2, sn=sn)
            self.add(ResBlock(ch, sn=sn))
        self.block(c, c, 3, sn=sn, act=False)

    def forward(self, x, seg=None, bboxes=None, train: bool = False):
        if self.seg_disc:
            x = torch.cat([x, seg], dim=-1)
        return scalar_head(super().forward(x, train, self.dtype))


class FrameLocalDiscriminator(_Disc):
    """Patch-map single-frame discriminator (discriminators.py:111-134):
    (B, H/4, W/4, 1)."""

    def __init__(self, seg_disc: bool = False, sn: bool = False,
                 dtype=None):
        super().__init__(seg_disc, sn, dtype)
        bn = not sn
        c = self.block(image_channels(seg_disc), 16, 3, sn=sn)
        c = self.block(c, 32, 5, sn=sn, bn=bn)
        for ch, s in ((64, 2), (64, 1), (128, 2), (128, 1), (64, 1)):
            c = self.block(c, ch, 3, stride=s, sn=sn, bn=bn)
        self.out = (SNConv(c, 1, 1, padding=0) if sn
                    else Conv(c, 1, 1, padding=0))
        self.out_name = "_SNConv_0" if sn else "Conv_0"

    def forward(self, x, seg=None, bboxes=None, train: bool = False):
        if self.seg_disc:
            x = torch.cat([x, seg], dim=-1)
        h = super().forward(x, train, self.dtype)
        return (self.out(h, train, self.dtype) if self.sn
                else self.out(h, self.dtype))


def FrameSNDiscriminator(seg_disc: bool = False, dtype=None):
    return FrameDiscriminator(seg_disc=seg_disc, sn=True, dtype=dtype)


def FrameSNLocalDiscriminator(seg_disc: bool = False, dtype=None):
    return FrameLocalDiscriminator(seg_disc=seg_disc, sn=True, dtype=dtype)


def video_channels(seg_disc: bool) -> int:
    """The frame, its seg, the two input frames and their segs."""
    return 3 * image_channels(seg_disc)


def _video_input(seg_disc, x, seg, input_x, input_seg) -> torch.Tensor:
    if seg_disc:
        return torch.cat([x, seg, input_x, input_seg], dim=-1)
    return torch.cat([x, input_x], dim=-1)


class VideoDiscriminator(_Disc):
    """Global 3-frame discriminator (discriminators.py:145-167):
    ``forward(x, seg, input_x, input_seg, bboxes=None, train=False)``."""

    def __init__(self, seg_disc: bool = False, sn: bool = False,
                 dtype=None):
        super().__init__(seg_disc, sn, dtype)
        c = self.block(video_channels(seg_disc), 32, 3, sn=sn)
        c = self.block(c, 64, 5, sn=sn, bn=not sn)
        c = self.block(c, 32, 3, sn=sn, bn=not sn)
        for ch in ((32, 64, 128) if sn else (32, 64, 128, 256)):
            c = self.block(c, ch, 3, stride=2, sn=sn)
            self.add(ResBlock(ch, sn=sn))
        self.block(c, c, 3, sn=sn, act=False)

    def forward(self, x, seg=None, input_x=None, input_seg=None,
                bboxes=None, train: bool = False):
        inp = _video_input(self.seg_disc, x, seg, input_x, input_seg)
        return scalar_head(super().forward(inp, train, self.dtype))


class VideoLocalDiscriminator(_Disc):
    """Patch-map 3-frame discriminator (discriminators.py:170-201)."""

    def __init__(self, seg_disc: bool = False, sn: bool = False,
                 dtype=None):
        super().__init__(seg_disc, sn, dtype)
        bn = not sn
        c = self.block(video_channels(seg_disc), 64, 1, sn=sn)
        for ch, k, s in ((64, 3, 1), (64, 3, 2), (64, 3, 1), (64, 3, 1),
                         (128, 3, 2), (128, 3, 1), (128, 3, 2), (128, 3, 1),
                         (256, 3, 2), (256, 3, 1), (64, 1, 1)):
            c = self.block(c, ch, k, stride=s, sn=sn, bn=bn)
        self.out = (SNConv(c, 1, 1, padding=0) if sn
                    else Conv(c, 1, 1, padding=0))
        self.out_name = "_SNConv_0" if sn else "Conv_0"

    def forward(self, x, seg=None, input_x=None, input_seg=None,
                bboxes=None, train: bool = False):
        inp = _video_input(self.seg_disc, x, seg, input_x, input_seg)
        h = super().forward(inp, train, self.dtype)
        return (self.out(h, train, self.dtype) if self.sn
                else self.out(h, self.dtype))


def VideoSNDiscriminator(seg_disc: bool = False, dtype=None):
    return VideoDiscriminator(seg_disc=seg_disc, sn=True, dtype=dtype)


def VideoSNLocalDiscriminator(seg_disc: bool = False, dtype=None):
    return VideoLocalDiscriminator(seg_disc=seg_disc, sn=True, dtype=dtype)


FACTORIES = {
    "FrameDiscriminator": lambda s, d: FrameDiscriminator(s, dtype=d),
    "FrameLocalDiscriminator": lambda s, d: FrameLocalDiscriminator(
        s, dtype=d),
    "FrameSNDiscriminator": FrameSNDiscriminator,
    "FrameSNLocalDiscriminator": FrameSNLocalDiscriminator,
    "VideoDiscriminator": lambda s, d: VideoDiscriminator(s, dtype=d),
    "VideoLocalDiscriminator": lambda s, d: VideoLocalDiscriminator(
        s, dtype=d),
    "VideoSNDiscriminator": VideoSNDiscriminator,
    "VideoSNLocalDiscriminator": VideoSNLocalDiscriminator,
}
