"""The INTER train and eval steps (counterpart of train/inter.py:68-216)
for ``--model InterNet``.

- train: the coarse model's weighted {l1, gdl, vgg, ssim} bundle on the
  raw [-1, 1] output plus cross-entropy on the seg logits
  (InterTrainer.py:411-414), one backward of their sum, then the
  per-submodel optimizer steps behind the train_* flags.  The step
  updates the model's parameters and the optimizer state in place.
- eval: L1 / PSNR / SSIM on [0, 1], IoU (pixel accuracy) of the argmax
  ids and the VGG cosine (InterTrainer.py:612-633), without gradients.

The loss-dict keys are the reference's logging keys.  Batches are dicts of
NHWC tensors: frame1..3 in [-1, 1], seg1..3 as uint8 id maps
(``core/seg``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.losses.image import (
    cross_entropy_loss,
    iou_accuracy,
    l1_loss,
    psnr,
    ssim,
)
from deep_video_interpolation_extrapolation_tpu_torch.losses.perceptual import (
    make_vgg_cosine_score,
)
from deep_video_interpolation_extrapolation_tpu_torch.train import (
    state as state_lib,
)
from deep_video_interpolation_extrapolation_tpu_torch.train.common import (
    get_inter_inputs,
    normalize01,
    rgb_bundle,
    seg_id_targets,
    sum_losses,
    vgg_loss_from_frozen,
)

_QUEUE = "ROADMAP.md queue 1"


def _check(cfg: Config) -> None:
    if cfg.model != "InterNet":
        raise NotImplementedError(
            f"the {cfg.model} train step is not ported yet ({_QUEUE}, "
            "items 5-7)")


def make_train_step(cfg: Config, model: nn.Module) -> Callable:
    """``train_step(state, batch) -> (state, loss_dict)``; the loss dict's
    values are detached scalars."""
    _check(cfg)
    if cfg.highres_large:
        raise NotImplementedError(
            f"--highres_large training is not ported yet ({_QUEUE}, item 2)")
    if cfg.remat:
        raise NotImplementedError(
            f"--remat is not ported yet ({_QUEUE}, item 4)")

    def train_step(state: state_lib.TrainState, batch):
        x, seg, gt_x, _ = get_inter_inputs(batch)
        for opt in state.optimizers.values():
            opt.zero_grad(set_to_none=True)
        coarse_img, coarse_seg = model(x, seg)
        loss_dict = rgb_bundle(cfg, coarse_img, gt_x,
                               vgg_loss_from_frozen(state.frozen_vgg),
                               "coarse")
        if cfg.mode == "xs2xs":
            loss_dict["coarse_ce_loss"] = cfg.ce_weight * cross_entropy_loss(
                coarse_seg, seg_id_targets(batch["seg2"]))
        total = sum_losses(loss_dict)
        loss_dict["loss_all"] = total
        total.backward()
        state_lib.apply_updates(cfg, state)
        return state, OrderedDict((k, v.detach())
                                  for k, v in loss_dict.items())

    return train_step


def make_eval_step(cfg: Config, model: nn.Module) -> Callable:
    """``eval_step(state, batch) -> metrics`` (an ordered dict of
    scalars)."""
    _check(cfg)

    @torch.no_grad()
    def eval_step(state: state_lib.TrainState, batch):
        x, seg, gt_x, _ = get_inter_inputs(batch)
        coarse_img, coarse_seg = model(x, seg)
        p = normalize01(torch.clamp(coarse_img, -1, 1))
        g = normalize01(gt_x)
        metrics = OrderedDict()
        metrics["coarse_l1"] = l1_loss(p, g)
        metrics["coarse_psnr"] = psnr(p, g)
        metrics["coarse_ssim"] = ssim(p, g)
        if cfg.mode == "xs2xs":
            metrics["coarse_iou"] = iou_accuracy(
                coarse_seg.argmax(dim=-1), seg_id_targets(batch["seg2"]))
        if state.frozen_vgg is not None:
            metrics["coarse_vgg"] = make_vgg_cosine_score(state.frozen_vgg)(
                p, g)
        return metrics

    return eval_step
