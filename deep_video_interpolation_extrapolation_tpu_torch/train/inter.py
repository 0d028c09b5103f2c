"""The INTER train and eval steps (counterpart of train/inter.py:53-216)
for ``--model InterNet``, ``InterRefineNet`` and ``InterStage3Net``.

- train: the coarse model's weighted {l1, gdl, vgg, ssim} bundle on the
  raw [-1, 1] output plus cross-entropy on the seg logits
  (InterTrainer.py:411-414); for the refine composites, per stage and per
  scale the refine-weighted bundle against the ground truth downscaled
  with align_corners=True (InterTrainer.py:415-425), keyed
  ``refine_<scale>_*`` then ``stage3_<scale>_*`` by each stage's actual
  output count; one backward of their sum, then the per-submodel
  optimizer steps behind the train_* flags.  On a VAEHRNet coarse (the
  plain VAE, inter.py:53-65, :107-125) the posterior is conditioned on the
  ground truth, eps drawn from the step's ``generator``, and
  ``coarse_kld_loss`` follows the cross-entropy.  The step updates the
  model's parameters and the optimizer state in place.  Under ``--remat``
  the HRNet coarse checkpoints its stages, the refine composites' whole
  forward is one checkpoint region, and so is each loss bundle.
- eval: L1 / PSNR / SSIM on [0, 1], IoU (pixel accuracy) of the argmax
  ids and the VGG cosine (InterTrainer.py:612-633) of the coarse frame,
  then the same of the last refined and stage-3 frames (``refine_*``,
  ``stage3_*``), without gradients; a VAEHRNet draws z from its prior (the
  runner evaluates it through ``inter_gan.GanEvalAdapter``, z from its
  generator).

The loss-dict and metric keys are the reference's logging keys, in the
JAX package's order.  Batches are dicts of NHWC tensors: frame1..3 in
[-1, 1], seg1..3 as uint8 id maps (``core/seg``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.core.remat import (
    checkpoint,
)
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
from deep_video_interpolation_extrapolation_tpu_torch.losses.vae import (
    kld_loss,
)
from deep_video_interpolation_extrapolation_tpu_torch.models.registry import (
    remat_internal,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.resize import (
    interpolate_bilinear,
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

_REFINE = ("InterRefineNet", "InterStage3Net")


def _check(cfg: Config) -> None:
    if cfg.model != "InterNet" and cfg.model not in _REFINE:
        raise NotImplementedError(
            f"the {cfg.model} train and eval steps are not here "
            "(InterGANNet: train/inter_gan.py; ExtraNet and "
            "ExtraInpaintNet: train/extra.py; the video VAEs and the legacy "
            "models: train/legacy.py)")


def _check_vae_combo(cfg: Config) -> None:
    """A VAEHRNet coarse under a refine composite would train with an
    unregularised posterior; the JAX package refuses it (inter.py:53-65)."""
    if cfg.coarse_model == "VAEHRNet" and cfg.model in _REFINE:
        raise ValueError(
            f"--coarse_model VAEHRNet is not supported under {cfg.model}; "
            "use --model InterNet (plain VAE) or InterGANNet (--vae)")


def _per_scale(cfg: Config, loss_dict, imgs, gt_x, vgg_fn, stem: str):
    """The refine-weighted bundle of each scale's output against the
    ground truth at that scale (inter.py:130-143); ``str(scale)`` is the
    reference's key suffix ('0.25', '0.5', '1.0')."""
    n_sc = len(imgs)
    for i, img in enumerate(imgs):
        scale = 1 / (2 ** (n_sc - i - 1))
        gt_s = gt_x if scale == 1.0 else interpolate_bilinear(
            gt_x, scale_factor=scale, align_corners=True)
        loss_dict.update(rgb_bundle(cfg, img, gt_s, vgg_fn,
                                    stem + str(scale), refine=True))


def make_train_step(cfg: Config, model: nn.Module,
                    generator: Optional[torch.Generator] = None) -> Callable:
    """``train_step(state, batch) -> (state, loss_dict)``; the loss dict's
    values are detached scalars.  ``generator`` draws a VAEHRNet's eps."""
    _check_vae_combo(cfg)
    _check(cfg)
    # --remat: the HRNet-family coarse checkpoints its own stages; any other
    # model's whole forward is one checkpoint region (inter.py:86-99)
    outer = cfg.remat and not remat_internal(cfg)
    vae = cfg.model == "InterNet" and cfg.coarse_model == "VAEHRNet"

    def train_step(state: state_lib.TrainState, batch):
        x, seg, gt_x, gt_seg = get_inter_inputs(batch)
        for opt in state.optimizers.values():
            opt.zero_grad(set_to_none=True)
        if vae:
            out = model(x, seg, gt_seg, gt_x, train=True,
                        generator=generator)
        else:
            out = (checkpoint(model, x, seg, modules=(model,)) if outer
                   else model(x, seg))
        vgg_fn = vgg_loss_from_frozen(state.frozen_vgg)
        loss_dict = rgb_bundle(cfg, out[0], gt_x, vgg_fn, "coarse")
        if cfg.mode == "xs2xs":
            loss_dict["coarse_ce_loss"] = cfg.ce_weight * cross_entropy_loss(
                out[1], seg_id_targets(batch["seg2"]))
        if vae:
            loss_dict["coarse_kld_loss"] = kld_loss(out[2], out[3],
                                                    cfg.kld_weight)
        if cfg.model in _REFINE:
            _per_scale(cfg, loss_dict, out[2], gt_x, vgg_fn, "refine_")
        if cfg.model == "InterStage3Net":
            _per_scale(cfg, loss_dict, out[3], gt_x, vgg_fn, "stage3_")
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
        x, seg, gt_x, gt_seg = get_inter_inputs(batch)
        out = model(x, seg, gt_seg=gt_seg)
        g = normalize01(gt_x)
        cos = (make_vgg_cosine_score(state.frozen_vgg)
               if state.frozen_vgg is not None else None)
        metrics = OrderedDict()

        def frame(prefix, img):
            p = normalize01(torch.clamp(img, -1, 1))
            metrics[f"{prefix}_l1"] = l1_loss(p, g)
            metrics[f"{prefix}_psnr"] = psnr(p, g)
            metrics[f"{prefix}_ssim"] = ssim(p, g)
            if prefix == "coarse" and cfg.mode == "xs2xs":
                metrics["coarse_iou"] = iou_accuracy(
                    out[1].argmax(dim=-1), seg_id_targets(batch["seg2"]))
            if cos is not None:
                metrics[f"{prefix}_vgg"] = cos(p, g)

        frame("coarse", out[0])
        if cfg.model in _REFINE:
            frame("refine", out[2][-1])
        if cfg.model == "InterStage3Net":
            frame("stage3", out[3][-1])
        return metrics

    return eval_step
