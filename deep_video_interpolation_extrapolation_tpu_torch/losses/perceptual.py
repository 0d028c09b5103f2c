"""Perceptual losses on the frozen VGG19 and ResNet101 (counterpart of
losses/perceptual.py): the reference's ``normed=False`` path, ImageNet
normalization applied to whatever range the caller passes."""

from __future__ import annotations

from typing import Callable

import torch

from deep_video_interpolation_extrapolation_tpu_torch.models.features import (
    ResNet101Features,
    VGG19Features,
    imagenet_norm,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.roi import (
    crop_resize,
)
from deep_video_interpolation_extrapolation_tpu_torch.parallel import spatial


def make_vgg_l1_loss(vgg: VGG19Features) -> Callable:
    """Mean L1 over the 5 feature maps; no gradient flows into gt.  On a
    band, each mean the band's share (``spatial.mean``)."""
    def loss(pred, gt):
        fp = vgg(imagenet_norm(pred))
        with torch.no_grad():
            fg = vgg(imagenet_norm(gt))
        return sum(spatial.mean((a - b).abs()) for a, b in zip(fp, fg)
                   ) / len(fp)
    return loss


def make_vgg_cosine_score(vgg: VGG19Features) -> Callable:
    """Mean channelwise cosine over the 5 feature maps (on a band, its
    share)."""
    def score(pred, gt):
        fp, fg = vgg(imagenet_norm(pred)), vgg(imagenet_norm(gt))
        total = 0.0
        for a, b in zip(fp, fg):
            an = a / torch.sqrt((a * a).sum(dim=-1, keepdim=True))
            bn = b / torch.sqrt((b * b).sum(dim=-1, keepdim=True))
            total = total + spatial.mean((an * bn).sum(dim=-1))
        return total / len(fp)
    return score


def make_track_obj_loss(resnet: ResNet101Features,
                        patch_hw=(64, 128)) -> Callable:
    """The track-consistency loss (perceptual.py:62-100; the reference's
    TrackObjLoss, losses.py:374-414): ``loss(pred, for_img, back_img,
    bboxes)``, bboxes (B, 3, N, 4).  Each track's box is cropped from the
    forward, predicted and backward frames (``crop_resize`` at
    ``patch_hw``), the (for, cur, back) patches embedded by the frozen
    ResNet101's stage-4 map, globally pooled and L2-normalised, and the
    loss is 1 - the mean of the two cosines of the prediction with its
    neighbours.  The pooling and the cosines are taken in f32 (the JAX
    package takes them in the compute dtype: in bf16 a cosine near 1 rounds
    to a multiple of 2^-8, so 1 - cosine does too)."""
    h, w = patch_hw

    def loss(pred_img, for_img, back_img, bboxes):
        b, _, n, _ = bboxes.shape
        cur_p = crop_resize(imagenet_norm(pred_img), bboxes[:, 1], (h, w))
        for_p = crop_resize(imagenet_norm(for_img), bboxes[:, 0], (h, w))
        back_p = crop_resize(imagenet_norm(back_img), bboxes[:, 2], (h, w))
        flat = torch.stack([for_p, cur_p, back_p], dim=2).reshape(
            b * n * 3, h, w, -1)
        feat = resnet(flat)[-1].float().mean(dim=(1, 2))   # (B*N*3, 2048)
        feat = feat / torch.linalg.vector_norm(feat, dim=-1, keepdim=True)
        groups = feat.reshape(b * n, 3, -1)
        fwd_s = (groups[:, 0] * groups[:, 1]).sum(-1)
        bwd_s = (groups[:, 2] * groups[:, 1]).sum(-1)
        return (1.0 - (fwd_s + bwd_s) / 2.0).mean()
    return loss
