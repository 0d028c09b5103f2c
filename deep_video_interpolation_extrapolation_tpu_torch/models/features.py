"""Frozen VGG19 features (counterpart of models/features.py:27-60).

VGG19 with *average* pooling, returning the relu1_2 / relu2_2 / relu3_4 /
relu4_4 / relu5_4 maps, NHWC.  Every conv is ``F.conv2d`` in the compute
dtype, as the JAX package leaves them to XLA.  The weights are frozen (no
grad); ``train/common.init_vgg_frozen`` fills them from a numpy seed, and
``tools/jax_weights.from_jax_vgg`` maps the JAX package's VGG params.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from deep_video_interpolation_extrapolation_tpu_torch.ops.resize import (
    nchw,
    nhwc,
)

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
    maps in ``dtype`` (the input's if None)."""

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
                h = F.relu(F.conv2d(h, conv.weight.to(dt), padding=1)
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
