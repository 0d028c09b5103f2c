"""Frozen feature extractors (counterpart of models/features.py): VGG19
(:27-60) and ResNet101 (:63-103).

VGG19 with *average* pooling, returning the relu1_2 / relu2_2 / relu3_4 /
relu4_4 / relu5_4 maps, NHWC.  ResNet101 returns its stage-2, -3 and -4
maps (the reference's layer2 / layer3 / layer4), its BatchNorms in eval
mode; its modules carry torchvision's ``state_dict`` names (``conv1``,
``bn1``, ``layer{1..4}.{b}.conv{1..3}`` / ``bn{1..3}``, block 0's
``downsample.0`` / ``.1``), so its ImageNet weights load as they are.
Every conv is ``F.conv2d`` in the compute dtype, as the JAX package leaves
them to XLA.  The weights are frozen (no grad);
``train/common.init_vgg_frozen`` and ``init_resnet_frozen`` fill them from a
numpy seed, and ``tools/jax_weights.from_jax_vgg`` and
``from_jax_resnet101`` map the JAX package's variables.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from deep_video_interpolation_extrapolation_tpu_torch.models.blocks import (
    Conv,
)
from deep_video_interpolation_extrapolation_tpu_torch.models.subnets import (
    BatchNorm,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.resize import (
    nchw,
    nhwc,
)
from deep_video_interpolation_extrapolation_tpu_torch.parallel import spatial

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

VGG19_PLAN = ((64, 64), (128, 128), (256, 256, 256, 256),
              (512, 512, 512, 512), (512, 512, 512, 512))


def conv_names():
    """The conv layer names, in order: conv{block}_{index}, both from 1."""
    return [f"conv{bi + 1}_{ci + 1}" for bi, block in enumerate(VGG19_PLAN)
            for ci in range(len(block))]


def imagenet_norm(x: torch.Tensor) -> torch.Tensor:
    """[0,1] RGB -> ImageNet-normalized, in f32 (the constants are f32, so
    a bf16 input promotes, as in the JAX package)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


class VGG19Features(nn.Module):
    """``forward(x)``: x NHWC, ImageNet-normalized; returns the 5 feature
    maps in ``dtype`` (the input's if None).  On a band
    (``parallel/spatial.banded``) each 3x3 conv takes its neighbours' rows
    (``spatial.conv2d``); the 2x2 pools stay inside an even band."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        widths = [3] + [c for block in VGG19_PLAN for c in block]
        self.convs = nn.ModuleDict(
            (name, nn.Conv2d(cin, cout, 3, padding=1))
            for name, cin, cout in zip(conv_names(), widths, widths[1:]))
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        dt = self.dtype or x.dtype
        h = nchw(x.to(dt))
        feats = []
        names = iter(conv_names())
        for bi, block in enumerate(VGG19_PLAN):
            if bi > 0:
                h = F.avg_pool2d(h, 2)
            for _ in block:
                conv = self.convs[next(names)]
                h = F.relu(spatial.conv2d(h, conv.weight.to(dt), padding=1)
                           + conv.bias.to(dt)[:, None, None])
            feats.append(nhwc(h))
        return feats


def init_vgg_weights(vgg: VGG19Features, seed: int) -> VGG19Features:
    """Conv weights lecun-normal (std 1/sqrt(fan_in), the flax Conv
    default's scale) and zero biases from ``numpy.random.RandomState(seed)``,
    layer by layer in order."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name in conv_names():
            conv = vgg.convs[name]
            fan_in = int(np.prod(conv.weight.shape[1:]))
            conv.weight.copy_(torch.from_numpy(rng.normal(
                0.0, 1.0 / np.sqrt(fan_in), conv.weight.shape).astype(
                    np.float32)))
            conv.bias.zero_()
    return vgg


# (planes, blocks, stride of block 0) of the four stages (features.py:93)
RESNET101_PLAN = ((64, 3, 1), (128, 4, 2), (256, 23, 2), (512, 3, 2))


class RNBottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4), each conv without bias and followed
    by an eval-mode BatchNorm, plus the identity or a strided 1x1 + BN
    projection, then relu (``_RNBottleneck``, features.py:63-82)."""

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        out_ch = planes * 4
        self.conv1 = Conv(cin, planes, 1, padding=0, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, stride=stride, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv(planes, out_ch, 1, padding=0, bias=False)
        self.bn3 = BatchNorm(out_ch)
        self.downsample = (nn.Sequential(
            Conv(cin, out_ch, 1, stride=stride, padding=0, bias=False),
            BatchNorm(out_ch)) if stride != 1 or cin != out_ch else None)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x, dt), False, dt))
        h = F.relu(self.bn2(self.conv2(h, dt), False, dt))
        h = self.bn3(self.conv3(h, dt), False, dt)
        if self.downsample is not None:
            x = self.downsample[1](self.downsample[0](x, dt), False, dt)
        return F.relu(h + x)


class ResNet101Features(nn.Module):
    """``forward(x)``: x NHWC, ImageNet-normalized; returns the stage-2, -3
    and -4 maps (512, 1024 and 2048 channels at 1/8, 1/16 and 1/32 scale)
    in ``dtype`` (the input's if None).  The BatchNorms use their running
    statistics (the JAX module at ``train=False``, as the track-object loss
    applies it)."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(3, 64, 7, stride=2, bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        for i, (planes, blocks, stride) in enumerate(RESNET101_PLAN):
            layer = []
            for b in range(blocks):
                layer.append(RNBottleneck(cin, planes,
                                          stride if b == 0 else 1))
                cin = planes * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor, last: int = 4) -> List[torch.Tensor]:
        """The maps of stages 2 to ``last`` (later stages are not run)."""
        dt = self.dtype or x.dtype
        h = F.relu(self.bn1(self.conv1(x, dt), False, dt))
        h = nhwc(F.max_pool2d(nchw(h), 3, stride=2, padding=1))
        stages = []
        for i in range(last):
            for block in getattr(self, f"layer{i + 1}"):
                h = block(h, dt)
            stages.append(h)
        return stages[1:]


def init_resnet_weights(net: ResNet101Features, seed: int
                        ) -> ResNet101Features:
    """Conv weights lecun-normal (std 1/sqrt(fan_in), the flax Conv
    default's scale) from ``numpy.random.RandomState(seed)``, in module
    order; every BatchNorm at the flax init (scale 1, bias 0, mean 0, var
    1)."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, Conv):
                fan_in = int(np.prod(m.weight.shape[1:]))
                m.weight.copy_(torch.from_numpy(rng.normal(
                    0.0, 1.0 / np.sqrt(fan_in), m.weight.shape).astype(
                        np.float32)))
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return net
