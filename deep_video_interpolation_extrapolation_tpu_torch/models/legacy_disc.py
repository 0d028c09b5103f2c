"""The legacy discriminators (counterpart of the JAX package's
``models/legacy_disc.py``): pix2pixHD's multiscale PatchGAN and the motion
discriminator (reference nets/multi_scale_discriminator.py,
nets/motion_discriminator.py).

NHWC; every forward takes ``train`` for its BatchNorms
(``subnets.BatchNorm``: flax's momentum and biased running variance).
Submodules carry the flax module names (``Conv_k``, ``BatchNorm_k``,
``scale{i}``), so ``tools/jax_weights.flax_key_map`` maps a JAX tree onto
them one to one.  Each conv computes in ``dtype`` (None: its input's).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.models.blocks import Conv
from deep_video_interpolation_extrapolation_tpu_torch.models.subnets import (
    BatchNorm,
)
from deep_video_interpolation_extrapolation_tpu_torch.models.unet import (
    conv_bn_lrelu,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.resize import (
    avg_pool,
)


class _ConvBNStack(nn.Module):
    """``Conv_k`` -> ``BatchNorm_k`` -> LeakyReLU(0.2) for each (cout,
    kernel, stride) of ``plan``, then the 1-channel 3x3 ``Conv_n``."""

    def __init__(self, cin: int, plan, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n, self.dtype = len(plan), dtype
        for i, (cout, k, s) in enumerate(plan):
            setattr(self, f"Conv_{i}", Conv(cin, cout, k, stride=s))
            setattr(self, f"BatchNorm_{i}", BatchNorm(cout))
            cin = cout
        setattr(self, f"Conv_{self.n}", Conv(cin, 1, 3))

    def features(self, x: torch.Tensor, train: bool) -> List[torch.Tensor]:
        """Every stage's activation, the 1-channel patch map last."""
        feats = []
        for i in range(self.n):
            x = conv_bn_lrelu(getattr(self, f"Conv_{i}"),
                              getattr(self, f"BatchNorm_{i}"), x, train,
                              self.dtype)
            feats.append(x)
        feats.append(getattr(self, f"Conv_{self.n}")(x, self.dtype))
        return feats


class NLayerDiscriminator(_ConvBNStack):
    """PatchGAN tower (nets/multi_scale_discriminator.py:57-126): 5x5 convs
    with BN at strides 1,1,2,1,2,1,4,1, a 1-channel patch head, optional
    sigmoid.  ``get_interm_feat`` returns every stage's activation."""

    def __init__(self, cin: int, ndf: int = 64, use_sigmoid: bool = False,
                 get_interm_feat: bool = False,
                 dtype: Optional[torch.dtype] = None):
        plan = [(ndf, 5, 1), (ndf, 5, 1), (2 * ndf, 5, 2), (2 * ndf, 5, 1),
                (2 * ndf, 5, 2), (2 * ndf, 5, 1), (4 * ndf, 5, 4),
                (4 * ndf, 5, 1)]
        super().__init__(cin, plan, dtype)
        self.use_sigmoid, self.get_interm_feat = use_sigmoid, get_interm_feat

    def forward(self, x: torch.Tensor, train: bool = True):
        feats = self.features(x, train)
        if self.use_sigmoid:
            feats[-1] = torch.sigmoid(feats[-1])
        return feats if self.get_interm_feat else feats[-1]


class MultiscaleDiscriminator(nn.Module):
    """``num_d`` PatchGAN towers over an input pyramid
    (nets/multi_scale_discriminator.py:9-54): a list over scales, the tower
    ``scale{num_d - 1}`` on the full-size input first (the reference's
    reversed indexing), each entry the intermediate-feature list or
    ``[patch map]``; between scales a 3x3 stride-2 average pool that counts
    only in-image pixels."""

    def __init__(self, cin: int, ndf: int = 64, num_d: int = 3,
                 use_sigmoid: bool = False, get_interm_feat: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_d = num_d
        for i in range(num_d):
            setattr(self, f"scale{i}", NLayerDiscriminator(
                cin, ndf, use_sigmoid, get_interm_feat, dtype))

    def forward(self, x: torch.Tensor, train: bool = True) -> List:
        results = []
        for i in range(self.num_d):
            out = getattr(self, f"scale{self.num_d - 1 - i}")(x, train)
            results.append(out if isinstance(out, list) else [out])
            if i != self.num_d - 1:
                x = avg_pool(x, (3, 3), ((1, 1), (1, 1)),
                             count_include_pad=False, stride=(2, 2))
        return results


class MotionDiscriminator(_ConvBNStack):
    """Three-frame motion patch discriminator
    (nets/motion_discriminator.py:10-29, its active path)."""

    def __init__(self, cin: int, ndf: int = 64,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(cin, [(ndf, 3, 1), (ndf, 3, 2), (ndf, 3, 1),
                               (2 * ndf, 3, 2), (2 * ndf, 3, 1), (ndf, 3, 1)],
                         dtype)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return self.features(x, train)[-1]
