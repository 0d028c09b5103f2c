"""Shared pieces of the train and eval steps (counterpart of
train/common.py)."""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Optional

import torch

from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.core.remat import (
    checkpoint,
)
from deep_video_interpolation_extrapolation_tpu_torch.core.seg import (
    oh_ids,
    seg_oh,
)
from deep_video_interpolation_extrapolation_tpu_torch.losses.bundles import (
    rgb_loss_bundle,
)
from deep_video_interpolation_extrapolation_tpu_torch.losses.perceptual import (
    make_vgg_l1_loss,
)
from deep_video_interpolation_extrapolation_tpu_torch.models.features import (
    ResNet101Features,
    VGG19Features,
    init_resnet_weights,
    init_vgg_weights,
)
from deep_video_interpolation_extrapolation_tpu_torch.models.registry import (
    compute_dtype,
)

def init_vgg_frozen(cfg: Config, seed: int, device="cuda") -> VGG19Features:
    """A frozen VGG19 in the compute dtype, weights from a numpy seed (the
    reference's ImageNet weights cannot be fetched; see the JAX package's
    models/features.py docstring), on ``device`` (the card unless the
    caller asks for the CPU; without a card it raises)."""
    device = hw.entry_device(device)
    vgg = VGG19Features(dtype=compute_dtype(cfg))
    return init_vgg_weights(vgg, seed).to(device).eval()


def init_resnet_frozen(cfg: Config, seed: int, device="cuda"
                       ) -> ResNet101Features:
    """A frozen ResNet101 for the track-object loss (common.py:31-40 of the
    JAX package), in the compute dtype, its BatchNorms in eval mode, weights
    from a numpy seed (its ImageNet weights are not in the repository; a
    torchvision state_dict loads into it as it is), on ``device`` (the card
    unless the caller asks for the CPU; without a card it raises)."""
    device = hw.entry_device(device)
    net = ResNet101Features(dtype=compute_dtype(cfg))
    return init_resnet_weights(net, seed).to(device).eval()


def vgg_loss_from_frozen(vgg: Optional[VGG19Features]) -> Optional[Callable]:
    return make_vgg_l1_loss(vgg) if vgg is not None else None


def rgb_bundle(cfg: Config, pred: torch.Tensor, gt: torch.Tensor,
               vgg_fn: Optional[Callable], prefix: str, refine: bool = False
               ) -> "OrderedDict[str, torch.Tensor]":
    """The RGB loss bundle with the global weights, or with the
    ``refine_*`` weights for a refine or stage-3 output (losses.py:228-241,
    common.py:50-79).  Under ``--remat`` the whole bundle (L1, GDL, SSIM
    and the frozen VGG19 tower) is one checkpoint region: its outputs are
    scalars, so only (pred, gt) are kept across the backward."""
    if refine:
        w = (cfg.refine_l1_weight, cfg.refine_gdl_weight,
             cfg.refine_vgg_weight, cfg.refine_ssim_weight)
    else:
        w = (cfg.l1_weight, cfg.gdl_weight, cfg.vgg_weight, cfg.ssim_weight)

    def bundle(p, g):
        return rgb_loss_bundle(p, g, *w, vgg_fn=vgg_fn, prefix=prefix)
    return checkpoint(bundle, pred, gt) if cfg.remat else bundle(pred, gt)


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
    """Integer class-id targets from uint8 (B,H,W) ids; a frame with no
    segmentation (``NO_SEG``) targets class 0, the argmax of the JAX
    package's all-zero one-hot (``core/seg.oh_ids``)."""
    return oh_ids(seg).long()
