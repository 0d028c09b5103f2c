"""Perceptual losses on the frozen VGG19 (counterpart of
losses/perceptual.py): the reference's ``normed=False`` path, ImageNet
normalization applied to whatever range the caller passes."""

from __future__ import annotations

from typing import Callable

import torch

from deep_video_interpolation_extrapolation_tpu_torch.models.features import (
    VGG19Features,
    imagenet_norm,
)


def make_vgg_l1_loss(vgg: VGG19Features) -> Callable:
    """Mean L1 over the 5 feature maps; no gradient flows into gt."""
    def loss(pred, gt):
        fp = vgg(imagenet_norm(pred))
        with torch.no_grad():
            fg = vgg(imagenet_norm(gt))
        return sum((a - b).abs().mean() for a, b in zip(fp, fg)) / len(fp)
    return loss


def make_vgg_cosine_score(vgg: VGG19Features) -> Callable:
    """Mean channelwise cosine over the 5 feature maps."""
    def score(pred, gt):
        fp, fg = vgg(imagenet_norm(pred)), vgg(imagenet_norm(gt))
        total = 0.0
        for a, b in zip(fp, fg):
            an = a / torch.sqrt((a * a).sum(dim=-1, keepdim=True))
            bn = b / torch.sqrt((b * b).sum(dim=-1, keepdim=True))
            total = total + (an * bn).sum(dim=-1).mean()
        return total / len(fp)
    return score
