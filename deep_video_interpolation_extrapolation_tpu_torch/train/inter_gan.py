"""The InterGAN train step (counterpart of train/inter_gan.py; the
reference's runners/InterGANTrainer.py): the generator and every
discriminator trained from ONE backward, as the reference and the JAX step.

- D losses see the detached fake, so they reach only the discriminators;
- the G hinge losses apply each discriminator with its parameters detached
  (``torch.func.functional_call``), so they reach only the generator;
- one ``backward()`` over the sum of every term, then the per-submodel
  optimizer steps (Adamax for the coarse model, Adam for each
  discriminator) behind the ``--train_*`` flags.

Per family the passes run in the JAX order, fake (detached) -> sync_neg
(``video_det`` only, averaged into the fake logits) -> real -> G, each a
train-mode pass that moves the BatchNorm statistics and the spectral
norms' ``u`` (inter_gan.py:209-238).  The coarse RGB bundle is computed on
[0, 1]-normalised images (InterGANTrainer.py:395), unlike the INTER step.
The loss keys and their order are InterGANTrainer.py:395-436's.

``--track_gen`` runs the track generator on the coarse outputs, whose
refined rgb and seg then stand for the coarse ones in every later term,
and adds ``coarse_loc_diff_loss`` (inter_gan.py:178-203).
``--track_obj_loss`` adds ``coarse_track_obj_loss``, the frozen
ResNet101's track-consistency term on [0, 1] images (inter_gan.py:141-163,
:194-197); it raises the JAX ``ValueError`` without the network or the
boxes.  A discriminator that takes the ground truth (``wants_gt``:
GlobalMask, LocalPatch) is given it on every pass, as the JAX step does.

The VAE's eps and the sync_neg offsets come from the step's ``generator``
(the JAX step's ``noise`` and ``sync_neg`` keys).  Under ``--remat`` the
VAEHRNet checkpoints its stages and each family's passes are one
checkpoint region (inter_gan.py:239-247), whose recompute sees the
spectral-norm vectors, BatchNorm statistics and generator state of the
first pass (``core/remat.checkpoint``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional

import torch
import torch.nn as nn
from torch.func import functional_call

from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.core.remat import (
    checkpoint,
)
from deep_video_interpolation_extrapolation_tpu_torch.losses.gan import (
    gan_scalar_loss,
)
from deep_video_interpolation_extrapolation_tpu_torch.losses.image import (
    cross_entropy_loss,
)
from deep_video_interpolation_extrapolation_tpu_torch.losses.perceptual import (
    make_track_obj_loss,
)
from deep_video_interpolation_extrapolation_tpu_torch.losses.vae import (
    kld_loss,
)
from deep_video_interpolation_extrapolation_tpu_torch.models.blocks import (
    needs_grad,
)
from deep_video_interpolation_extrapolation_tpu_torch.models.composite import (
    _grad_through,
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

def frozen_call(module: nn.Module, *args, **kwargs):
    """``module`` applied with its parameters detached (its buffers, the
    BatchNorm statistics and spectral-norm vectors, still move): the
    gradient reaches the inputs only."""
    params = {k: p.detach() for k, p in module.named_parameters()}
    return functional_call(module, params, args, kwargs)


def make_train_step(cfg: Config, model: nn.Module,
                    generator: Optional[torch.Generator] = None) -> Callable:
    """``train_step(state, batch) -> (state, loss_dict)`` for an
    InterGANNet ``model``; the loss dict's values are detached scalars.
    ``generator`` draws the VAE's eps and the sync_neg offsets.  The
    track-object loss takes its frozen ResNet101 from the state
    (``state.frozen_resnet``)."""
    discs = []
    # the model's families in the JAX step's order (inter_gan.py:55-65):
    # attr ``<family>_model``, loss-key stem ``<family>`` less ``_disc``
    for attr, video in model.families:
        fam = attr[:-len("_model")]
        stem = fam[:-len("_disc")]
        disc = getattr(model, attr)
        if stem == "video_det" and not getattr(disc, "supports_sync_neg",
                                               False):
            # the sync_neg track-mismatch negative defines this family
            # (inter_gan.py:121-132)
            raise ValueError(
                f"--video_det_disc_model {type(disc).__name__!r} has no "
                "sync_neg support; pick a Video*DetDiscriminator")
        discs.append((disc, stem, video, getattr(cfg, f"{fam}_disc_weight"),
                      getattr(cfg, f"{fam}_gen_weight"),
                      getattr(disc, "wants_gt", False)))

    def train_step(state: state_lib.TrainState, batch):
        x, seg, gt_x, gt_seg = get_inter_inputs(batch)
        bboxes = batch.get("bboxes")
        track_obj = None
        if cfg.track_obj_loss:
            if state.frozen_resnet is None or bboxes is None:
                # the reference asserts the boxes; a configured term never
                # quietly drops out of the loss (inter_gan.py:156-163)
                missing = ("ResNet101 features (state.frozen_resnet)"
                           if state.frozen_resnet is None
                           else "bbox tracks in the batch")
                raise ValueError(f"--track_obj_loss requires {missing}")
            track_obj = make_track_obj_loss(state.frozen_resnet)
        for opt in state.optimizers.values():
            opt.zero_grad(set_to_none=True)
        coarse = model.coarse_model
        with torch.set_grad_enabled(needs_grad(coarse)):
            coarse_rgb, coarse_seg, mu, logvar = coarse(
                x, seg, gt_x, gt_seg, train=True, generator=generator)
        if cfg.track_gen:
            track = model.track_gen_model
            with torch.set_grad_enabled(_grad_through(track, coarse_rgb)):
                coarse_rgb, coarse_seg, _, loc_diff = track(
                    x, seg, coarse_rgb, coarse_seg, bboxes, **model.track_kw)
        soft = torch.softmax(coarse_seg, dim=-1)
        vgg_fn = vgg_loss_from_frozen(state.frozen_vgg)
        ld = rgb_bundle(cfg, normalize01(coarse_rgb), normalize01(gt_x),
                        vgg_fn, "coarse")
        if track_obj is not None:
            ld["coarse_track_obj_loss"] = cfg.track_obj_weight * track_obj(
                normalize01(coarse_rgb), normalize01(x[..., :3]),
                normalize01(x[..., 3:6]), bboxes)
        if cfg.mode == "xs2xs":
            ld["coarse_ce_loss"] = cfg.ce_weight * cross_entropy_loss(
                coarse_seg, seg_id_targets(batch["seg2"]))
        if cfg.track_gen:
            ld["coarse_loc_diff_loss"] = cfg.loc_diff_weight * \
                loc_diff.float().mean()
        if cfg.vae:
            ld["coarse_kld_loss"] = kld_loss(mu, logvar, cfg.kld_weight)
        fake, fake_soft = coarse_rgb.detach(), soft.detach()
        for disc, stem, video, d_w, g_w, wants_gt in discs:
            extra = (x, seg) if video else ()
            gt_kw = {"gt_x": gt_x} if wants_gt else {}

            def family(coarse_rgb, soft, disc=disc, stem=stem, extra=extra,
                       gt_kw=gt_kw):
                with torch.set_grad_enabled(needs_grad(disc)):
                    d_fake = disc(fake, fake_soft, *extra, bboxes=bboxes,
                                  train=True, **gt_kw)
                    if stem == "video_det":
                        d_sync = disc(gt_x, gt_seg, *extra, bboxes=bboxes,
                                      sync_neg=True, train=True,
                                      generator=generator, **gt_kw)
                        d_fake = (d_fake + d_sync) / 2
                    d_real = disc(gt_x, gt_seg, *extra, bboxes=bboxes,
                                  train=True, **gt_kw)
                g_fake = frozen_call(disc, coarse_rgb, soft, *extra,
                                     bboxes=bboxes, train=True, **gt_kw)
                return d_fake, d_real, g_fake

            d_fake, d_real, g_fake = (
                checkpoint(family, coarse_rgb, soft, modules=(disc,),
                           generators=(generator,)) if cfg.remat
                else family(coarse_rgb, soft))
            ld[f"coarse_{stem}_loss"] = gan_scalar_loss(g_fake, True, g_w)
            ld[f"disc_{stem}_real_loss"] = gan_scalar_loss(d_real, True, d_w)
            ld[f"disc_{stem}_fake_loss"] = gan_scalar_loss(d_fake, False,
                                                           d_w)
        total = sum_losses(ld)
        ld["loss_all"] = total
        total.backward()
        state_lib.apply_updates(cfg, state)
        return state, OrderedDict((k, v.detach()) for k, v in ld.items())

    return train_step


class GanEvalAdapter(nn.Module):
    """The GAN's coarse model (VAEHRNet) on the (rgb, seg) interface of the
    INTER eval step, cycgen and serving (runner.py:949-967 of the JAX
    package): eval mode, z drawn from ``generator``.  Returns (rgb,
    seg_logits)."""

    def __init__(self, coarse: nn.Module,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.coarse_model = coarse
        self.generator = generator

    def forward(self, rgb, seg, gt_seg=None):
        out = self.coarse_model(rgb, seg, train=False,
                                generator=self.generator)
        return out[0], out[1]
