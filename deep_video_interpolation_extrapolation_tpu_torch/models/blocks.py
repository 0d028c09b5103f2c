"""Building blocks of the HRNet slice (counterpart of models/blocks.py).

Modules take and return NHWC tensors.  Convolutions run through
``F.conv2d`` on the logical-NCHW, channels_last view of the same memory, so
no layout copies are made.  Parameters are f32 masters in torch's OIHW
layout (the reference's state_dict naming); each conv casts its input and
weights to the compute dtype and rounds its output there, as the JAX
``Conv`` does (``preferred_element_type=dtype``).
"""

from __future__ import annotations

from typing import Optional

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


def lrelu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU with the reference's slope 0.2 (blocks.py:23)."""
    return F.leaky_relu(x, 0.2)


class Conv(nn.Module):
    """torch-style Conv2d on NHWC tensors: symmetric padding ``k // 2``
    (unless given), optional bias, compute in ``dtype`` (default: the
    input's)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: Optional[int] = None, bias: bool = True):
        super().__init__()
        self.stride = stride
        self.padding = kernel // 2 if padding is None else padding
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dt = dtype or x.dtype
        out = nhwc(F.conv2d(nchw(x.to(dt)), self.weight.to(dt),
                            stride=self.stride, padding=self.padding))
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
