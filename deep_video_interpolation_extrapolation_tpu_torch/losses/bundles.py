"""Weighted RGB loss bundle (counterpart of losses/bundles.py).

The ordered keys '{prefix}_l1_loss', '_gdl_loss', '_vgg_loss',
'_ssim_loss' and the weighting of the reference's ``RGBLoss``, so training
logs compare line for line.  The VGG term is a callable (None drops it to
a zero).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional

import torch

from deep_video_interpolation_extrapolation_tpu_torch.losses.image import (
    gdl_loss,
    l1_loss,
    ssim_loss,
)


def rgb_loss_bundle(pred: torch.Tensor, gt: torch.Tensor, l1_w: float,
                    gdl_w: float, vgg_w: float, ssim_w: float,
                    vgg_fn: Optional[Callable] = None, prefix: str = ""
                    ) -> "OrderedDict[str, torch.Tensor]":
    """pred/gt NHWC in [-1, 1] (VGG preprocessing happens inside the VGG
    term)."""
    out = OrderedDict()
    out[f"{prefix}_l1_loss"] = l1_w * l1_loss(pred, gt)
    out[f"{prefix}_gdl_loss"] = gdl_w * gdl_loss(pred, gt)
    out[f"{prefix}_vgg_loss"] = (vgg_w * vgg_fn(pred, gt) if vgg_fn is not None
                                 else torch.zeros((), device=pred.device))
    out[f"{prefix}_ssim_loss"] = ssim_w * ssim_loss(pred, gt)
    return out
