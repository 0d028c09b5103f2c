"""Building blocks of the ported models (counterpart of models/blocks.py).

Modules take and return NHWC tensors.  Convolutions run through
``F.conv2d`` on the logical-NCHW, channels_last view of the same memory, so
no layout copies are made.  Parameters are f32 masters in torch's OIHW
layout (the reference's state_dict naming); each conv casts its input and
weights to the compute dtype and rounds its output there, as the JAX
``Conv`` does (``preferred_element_type=dtype``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from deep_video_interpolation_extrapolation_tpu_torch.ops.conv3x3 import (
    conv3x3_bias_res_lrelu,
    conv3x3_bias_res_lrelu_plain,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.resize import (
    nchw,
    nhwc,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.trainchain import (
    bottleneck_plain,
)
from deep_video_interpolation_extrapolation_tpu_torch.parallel import spatial


def lrelu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU with the reference's slope 0.2 (blocks.py:23)."""
    return F.leaky_relu(x, 0.2)


def lrelu0(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.2) with the JAX package's derivative at 0 (1, where
    ``F.leaky_relu``'s is the slope): for the modules where whole channels
    sit exactly at 0 -- a train-mode BatchNorm over a constant channel
    (VAEHRNet's encoder at its 1/16 maps), a zero canvas under a zero bias
    (TrackGen's pasted tracks) -- and the two conventions part."""
    return torch.where(x >= 0, x, x * 0.2)


def needs_grad(module: nn.Module) -> bool:
    """Whether autograd needs ``module``'s gradient here: grad is enabled
    and one of its parameters requires it (a frozen submodel's do not)."""
    return torch.is_grad_enabled() and any(
        p.requires_grad for p in module.parameters())


class Conv(nn.Module):
    """torch-style Conv2d on NHWC tensors: symmetric padding
    ``(kh // 2, kw // 2) * dilation`` (unless given), optional bias,
    compute in ``dtype`` (default: the input's).  ``kernel`` is a size or a
    (kh, kw) pair.  On a band (``parallel/spatial.banded``) H's padding is
    the neighbouring bands' rows (``spatial.conv2d``)."""

    def __init__(self, cin: int, cout: int, kernel=3, stride: int = 1,
                 padding: Optional[int] = None, bias: bool = True,
                 dilation: int = 1):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        self.stride = stride
        self.dilation = dilation
        self.padding = ((kh // 2) * dilation, (kw // 2) * dilation) \
            if padding is None else padding
        self.weight = nn.Parameter(torch.zeros(cout, cin, kh, kw))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dt = dtype or x.dtype
        out = nhwc(spatial.conv2d(nchw(x.to(dt)), self.weight.to(dt),
                                  stride=self.stride, padding=self.padding,
                                  dilation=self.dilation))
        if self.bias is not None:
            out = out + self.bias.to(dt)
        return out


def conv3x3_site(x: torch.Tensor, conv: Conv, res=None, relu: bool = True,
                 kernel: bool = False) -> torch.Tensor:
    """A stride-1 3x3 conv (+ bias) (+ residual) (+ lrelu): through K1 at
    the sites where the JAX package routes its Pallas conv kernel
    (``kernel=True``), through the same plain composition elsewhere."""
    fn = conv3x3_bias_res_lrelu if kernel else conv3x3_bias_res_lrelu_plain
    return fn(x, conv.weight, conv.bias, res, relu)


class BasicBlock(nn.Module):
    """conv3x3-lrelu-conv3x3 + identity, lrelu; no BN (blocks.py:269)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv(features, features, 3, bias=False)
        self.conv2 = Conv(features, features, 3, bias=False)

    def forward(self, x: torch.Tensor, kernel: bool = False) -> torch.Tensor:
        h = conv3x3_site(x, self.conv1, kernel=kernel)
        return conv3x3_site(h, self.conv2, res=x, kernel=kernel)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (x4) residual block, lrelu (blocks.py:401).

    ``forward`` is the plain block (``ops/trainchain.bottleneck_plain``);
    HRNet's layer1 runs the same weights through the fused tail
    (ops/bottleneck_tail.py) or the train-chain kernels (ops/trainchain.py)."""
    expansion = 4

    def __init__(self, cin: int, planes: int):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = Conv(cin, planes, 1, padding=0, bias=False)
        self.conv2 = Conv(planes, planes, 3, bias=False)
        self.conv3 = Conv(planes, out_ch, 1, padding=0, bias=False)
        self.downsample = (nn.Sequential(Conv(cin, out_ch, 1, padding=0,
                                              bias=False))
                           if cin != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bottleneck_plain(
            x, self.conv1.weight, self.conv2.weight, self.conv3.weight,
            self.downsample[0].weight if self.downsample is not None else None)


class SegEncoder(nn.Sequential):
    """20-class one-hot -> 4-ch embedding: conv-ELU-conv-ELU-conv,
    20 -> 32 -> 32 -> 4 (blocks.py:506).  The Sequential's indices give the
    reference's state_dict keys (seg_encoder.0/2/4)."""

    def __init__(self):
        super().__init__(Conv(20, 32, 3), nn.ELU(), Conv(32, 32, 3), nn.ELU(),
                         Conv(32, 4, 3))

    def forward(self, seg: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        x = F.elu(self[0](seg, dtype))
        x = F.elu(self[2](x))
        return self[4](x)


class ConvT(nn.Module):
    """torch ConvTranspose2d(k=4, s=2, p=1) on NHWC tensors, an exact 2x
    upsample (blocks.py:247-266), computed in the input's dtype; weight
    (Cin, Cout, 4, 4) as the reference's state_dict holds it."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, 4, 4))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        return nhwc(F.conv_transpose2d(nchw(x), self.weight.to(dt),
                                       self.bias.to(dt), stride=2, padding=1))


def conv_lrelu(cin: int, cout: int, stride: int = 1,
               dilation: int = 1) -> Tuple[nn.Module, nn.Module]:
    """A 3x3 conv and its lrelu (``ConvLReLU``, blocks.py:542), as the two
    entries of the reference's ``nn.Sequential`` (so the conv keeps its
    state_dict index)."""
    return Conv(cin, cout, 3, stride, dilation=dilation), nn.LeakyReLU(0.2)


class ResnetBlock(nn.Module):
    """conv-lrelu-conv + input, both convs ``kernel`` x ``kernel``
    (blocks.py:492); ``conv.0`` / ``conv.2`` are the reference's state_dict
    keys."""

    def __init__(self, features: int, kernel: int = 3):
        super().__init__()
        self.conv = nn.Sequential(Conv(features, features, kernel),
                                  nn.LeakyReLU(0.2),
                                  Conv(features, features, kernel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x) + x
