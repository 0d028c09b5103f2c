"""The EXTRA train and eval steps (counterpart of train/extra.py; the
reference's runners/ExtraTrainer.py) for ``--model ExtraNet`` and
``ExtraInpaintNet``.

An autoregressive rollout over ``num_pred_step`` steps, each predicting
``num_pred_once`` frames from the two newest (ExtraTrainer.py:254-310):

- train: back-propagation through time.  The predicted rgb is fed back
  with its gradient, unclipped; the predicted seg as the one-hot of its
  argmax, which carries none.  Per step and frame the coarse model's
  weighted {l1, gdl, vgg, ssim} bundle and its cross-entropy, keyed
  ``step_{i+1}_frame_{j+1}_coarse_*``; under ``--inpaint`` the bundle of
  the inpainted frame on the region to inpaint (``* (1 - m)``) and the
  mask term (weight 80 with ``--inpaint_mask``, else 0), keyed
  ``..._inpaint_*``.  On a VAEHRNet coarse (the plain VAE, extra.py:120-145)
  each step's posterior is conditioned on that step's ground truth, a
  fresh eps drawn from the step's ``generator``, and the step's
  ``step_{i+1}_coarse_kld_loss`` comes before its frame terms.  One backward of their sum, then the per-submodel
  optimizer steps behind the train_* flags.  Under ``--remat`` ExtraNet's
  HRNet checkpoints its stages, ExtraInpaintNet's each rollout forward is
  one checkpoint region, and so is each loss bundle.
- eval: the full rollout with the same feedback, without gradients:
  L1 / PSNR / SSIM / VGG cosine of each predicted frame on [0, 1] and the
  IoU (pixel accuracy) of its seg, keyed ``step_{i}_frame_{j}_coarse_*``
  (0-indexed, the reference's validate naming), and ``..._inpaint_*``.

``--fix_init_frames`` prepends the second input frame (and its seg) to
every step's input.  Batches are dicts of NHWC tensors: frame1..frameN in
[-1, 1], seg1..segN as uint8 id maps (``core/seg``), N = 2 + num_pred_once
* num_pred_step.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.core.remat import (
    checkpoint,
)
from deep_video_interpolation_extrapolation_tpu_torch.core.seg import (
    N_CLASSES,
    seg_oh,
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
from deep_video_interpolation_extrapolation_tpu_torch.train import (
    state as state_lib,
)
from deep_video_interpolation_extrapolation_tpu_torch.train.common import (
    normalize01,
    rgb_bundle,
    seg_id_targets,
    sum_losses,
    vgg_loss_from_frozen,
)

MODELS = ("ExtraNet", "ExtraInpaintNet")


def one_hot_from_logits(seg_logits: torch.Tensor) -> torch.Tensor:
    """The one-hot of the argmax class, in the logits' dtype; no gradient
    (``_one_hot_from_logits``)."""
    return F.one_hot(seg_logits.argmax(dim=-1), N_CLASSES).to(seg_logits.dtype)


def _check_mode(cfg: Config) -> None:
    """Extrapolation is xs2xs-only (extra.py:60-70): the reference's xx2x
    branch is dead code."""
    if cfg.mode != "xs2xs":
        raise ValueError(
            f"EXTRA supports --mode xs2xs only (got {cfg.mode!r}); the "
            "reference's xx2x extrapolation path was never functional")


def _check(cfg: Config) -> None:
    _check_mode(cfg)
    if cfg.model not in MODELS:
        raise NotImplementedError(
            f"EXTRA runs --model ExtraNet or ExtraInpaintNet, not "
            f"{cfg.model!r}")
    if cfg.num_pred_step > 1 and cfg.num_pred_once != 1:
        raise AssertionError("multi-step rollout requires num_pred_once=1 "
                             "(ExtraTrainer.py:253)")


def _frames(batch, stem: str, start: int, n: int, expand=lambda t: t):
    return torch.cat([expand(batch[f"{stem}{i}"])
                      for i in range(start, start + n)], dim=-1)


def _window(cfg: Config, batch, last_rgb, last_seg):
    """A step's input: the two newest frames, behind frame2 under
    ``--fix_init_frames``."""
    if not cfg.fix_init_frames:
        return last_rgb, last_seg
    return (torch.cat([batch["frame2"], last_rgb], dim=-1),
            torch.cat([seg_oh(batch["seg2"]), last_seg], dim=-1))


def _unpack(cfg: Config, out):
    """(coarse_img, coarse_seg, mask, inpaint_img) of a composite's output;
    the last two None without ``--inpaint``."""
    if cfg.inpaint:
        return out
    return out[0], out[1], None, None


def _feedback(x, seg, back_img, coarse_seg):
    """The next window: the newest input frame and the prediction (rgb
    with its gradient, seg as the one-hot of its argmax)."""
    return (torch.cat([x[..., -3:], back_img.to(x.dtype)], dim=-1),
            torch.cat([seg[..., -N_CLASSES:],
                       one_hot_from_logits(coarse_seg).to(seg.dtype)], dim=-1))


def make_train_step(cfg: Config, model: nn.Module,
                    generator: Optional[torch.Generator] = None) -> Callable:
    """``train_step(state, batch) -> (state, loss_dict)``; the loss dict's
    values are detached scalars.  ``generator`` draws a VAEHRNet's eps."""
    _check(cfg)
    p = cfg.num_pred_once
    vae = cfg.model == "ExtraNet" and cfg.coarse_model == "VAEHRNet"
    # --remat: ExtraNet's HRNet checkpoints its own stages; ExtraInpaintNet's
    # each rollout forward is one checkpoint region (extra.py:89-101)
    outer = cfg.remat and not remat_internal(cfg)

    def train_step(state: state_lib.TrainState, batch):
        for opt in state.optimizers.values():
            opt.zero_grad(set_to_none=True)
        vgg_fn = vgg_loss_from_frozen(state.frozen_vgg)
        loss_dict = OrderedDict()
        last_rgb = torch.cat([batch["frame1"], batch["frame2"]], dim=-1)
        last_seg = torch.cat([seg_oh(batch["seg1"]), seg_oh(batch["seg2"])],
                             dim=-1)
        for ii in range(cfg.num_pred_step):
            start = 3 + ii * p
            gt_x = _frames(batch, "frame", start, p)
            x, seg = _window(cfg, batch, last_rgb, last_seg)
            if vae:
                out = model(x, seg, _frames(batch, "seg", start, p, seg_oh),
                            gt_x, train=True, generator=generator)
                loss_dict[f"step_{ii + 1}_coarse_kld_loss"] = kld_loss(
                    out[2], out[3], cfg.kld_weight)
            else:
                out = (checkpoint(model, x, seg, modules=(model,)) if outer
                       else model(x, seg))
            coarse_img, coarse_seg, mask, inpaint_img = _unpack(cfg, out)
            for j in range(p):
                prefix = f"step_{ii + 1}_frame_{j + 1}_coarse"
                gt = gt_x[..., 3 * j:3 * j + 3]
                loss_dict.update(rgb_bundle(
                    cfg, coarse_img[..., 3 * j:3 * j + 3], gt, vgg_fn,
                    prefix))
                loss_dict[prefix + "_ce_loss"] = cfg.ce_weight * \
                    cross_entropy_loss(
                        coarse_seg[..., N_CLASSES * j:N_CLASSES * (j + 1)],
                        seg_id_targets(batch[f"seg{start + j}"]))
                if cfg.inpaint:
                    iprefix = f"step_{ii + 1}_frame_{j + 1}_inpaint"
                    m = mask[..., j:j + 1]
                    loss_dict.update(rgb_bundle(
                        cfg, inpaint_img[..., 3 * j:3 * j + 3] * (1 - m),
                        gt * (1 - m), vgg_fn, iprefix))
                    mask_w = 80.0 if cfg.inpaint_mask else 0.0
                    loss_dict[iprefix + "_mask_loss"] = mask_w * m.float(
                    ).mean()
            if cfg.num_pred_step == 1:
                break
            last_rgb, last_seg = _feedback(
                x, seg, inpaint_img if cfg.inpaint else coarse_img,
                coarse_seg)
        total = sum_losses(loss_dict)
        loss_dict["loss_all"] = total
        total.backward()
        state_lib.apply_updates(cfg, state)
        return state, OrderedDict((k, v.detach())
                                  for k, v in loss_dict.items())

    return train_step


def make_eval_step(cfg: Config, model: nn.Module) -> Callable:
    """``eval_step(state, batch) -> metrics`` (an ordered dict of scalars)
    over the full rollout (extra.py:191-262)."""
    _check(cfg)
    p = cfg.num_pred_once

    @torch.no_grad()
    def eval_step(state: state_lib.TrainState, batch):
        metrics = OrderedDict()
        cos = (make_vgg_cosine_score(state.frozen_vgg)
               if state.frozen_vgg is not None else None)

        def rgb_metrics(pre, img, gt):
            pr, g = normalize01(torch.clamp(img, -1, 1)), normalize01(gt)
            metrics[pre + "l1"] = l1_loss(pr, g)
            metrics[pre + "psnr"] = psnr(pr, g)
            metrics[pre + "ssim"] = ssim(pr, g)
            if cos is not None:
                metrics[pre + "vgg"] = cos(pr, g)

        last_rgb = torch.cat([batch["frame1"], batch["frame2"]], dim=-1)
        last_seg = torch.cat([seg_oh(batch["seg1"]), seg_oh(batch["seg2"])],
                             dim=-1)
        for ii in range(cfg.num_pred_step):
            start = 3 + ii * p
            gt_x = _frames(batch, "frame", start, p)
            x, seg = _window(cfg, batch, last_rgb, last_seg)
            coarse_img, coarse_seg, _, inpaint_img = _unpack(cfg,
                                                             model(x, seg))
            for j in range(p):
                pre = f"step_{ii}_frame_{j}_"
                gt = gt_x[..., 3 * j:3 * j + 3]
                rgb_metrics(pre + "coarse_", coarse_img[..., 3 * j:3 * j + 3],
                            gt)
                metrics[pre + "coarse_iou"] = iou_accuracy(
                    coarse_seg[..., N_CLASSES * j:N_CLASSES * (j + 1)].argmax(
                        dim=-1), seg_id_targets(batch[f"seg{start + j}"]))
                if cfg.inpaint:
                    rgb_metrics(pre + "inpaint_",
                                inpaint_img[..., 3 * j:3 * j + 3], gt)
            if cfg.num_pred_step == 1:
                break
            last_rgb, last_seg = _feedback(
                x, seg, inpaint_img if cfg.inpaint else coarse_img,
                coarse_seg)
        return metrics

    return eval_step
