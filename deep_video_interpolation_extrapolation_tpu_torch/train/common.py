"""Shared pieces of the train and eval steps (counterpart of
train/common.py)."""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Optional

import torch

from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.core.seg import seg_oh
from deep_video_interpolation_extrapolation_tpu_torch.losses.bundles import (
    rgb_loss_bundle,
)
from deep_video_interpolation_extrapolation_tpu_torch.losses.perceptual import (
    make_vgg_l1_loss,
)
from deep_video_interpolation_extrapolation_tpu_torch.models.features import (
    VGG19Features,
    init_vgg_weights,
)
from deep_video_interpolation_extrapolation_tpu_torch.models.registry import (
    compute_dtype,
)

def init_vgg_frozen(cfg: Config, seed: int, device="cpu") -> VGG19Features:
    """A frozen VGG19 in the compute dtype, weights from a numpy seed (the
    reference's ImageNet weights cannot be fetched; see the JAX package's
    models/features.py docstring)."""
    vgg = VGG19Features(dtype=compute_dtype(cfg))
    return init_vgg_weights(vgg, seed).to(device).eval()


def vgg_loss_from_frozen(vgg: Optional[VGG19Features]) -> Optional[Callable]:
    return make_vgg_l1_loss(vgg) if vgg is not None else None


def rgb_bundle(cfg: Config, pred: torch.Tensor, gt: torch.Tensor,
               vgg_fn: Optional[Callable], prefix: str
               ) -> "OrderedDict[str, torch.Tensor]":
    """The RGB loss bundle with the global weights (losses.py:228-241)."""
    return rgb_loss_bundle(pred, gt, cfg.l1_weight, cfg.gdl_weight,
                           cfg.vgg_weight, cfg.ssim_weight, vgg_fn=vgg_fn,
                           prefix=prefix)


def sum_losses(loss_dict: "OrderedDict[str, torch.Tensor]") -> torch.Tensor:
    """Sum of each term's mean, in f32."""
    total = torch.zeros((), device=next(iter(loss_dict.values())).device)
    for v in loss_dict.values():
        total = total + v.mean()
    return total


def get_inter_inputs(batch: Dict[str, torch.Tensor]):
    """(frame1, frame3) -> predict frame2 (runners/InterTrainer.py:389-394).
    Returns (x, seg, gt_x, gt_seg)."""
    x = torch.cat([batch["frame1"], batch["frame3"]], dim=-1)
    seg = torch.cat([seg_oh(batch["seg1"]), seg_oh(batch["seg3"])], dim=-1)
    return x, seg, batch["frame2"], seg_oh(batch["seg2"])


def normalize01(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1]."""
    return (img + 1.0) / 2.0


def seg_id_targets(seg: torch.Tensor) -> torch.Tensor:
    """Integer class-id targets from uint8 (B,H,W) ids."""
    return seg.long()
