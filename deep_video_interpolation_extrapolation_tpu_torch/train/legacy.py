"""The legacy train steps (counterpart of the JAX package's
``train/legacy.py``: reference runners/ganer.py, VAEer.py, trainer.py,
refiner.py, refiner_gan.py, the pre-INTER/EXTRA training loops).

- ``make_vae_train_step``: the VAEer recipe (VAEer.py:169-240) on a video
  VAE (``models/vae_video``): L1 on the warped and the refined frames, the
  KL term, VGG on the refined sequence and the flow-consistency term.  On
  the card every warp runs on the grid-sample kernel and trains through its
  backward kernel (``ops/warp.warp_steps``): the model's warp of frame1 for
  all steps is one launch, the consistency warps of the ground-truth frames
  one more (B * T frames at T = 1), so a step launches the grid sample
  twice and its backward twice.
- ``make_simple_train_step``: the plain Trainer recipe (trainer.py:254-320):
  RGB bundle + cross-entropy on a single generator.
- ``make_gan_train_step``: the GANer recipe (ganer.py:265-410) on the
  ``GAN`` head: RGB bundle + CE + the weighted patch-map GAN losses in one
  backward; D's losses see the detached fake and the G pass runs against
  the frozen netD (``models/legacy_heads``), so scaling the adversarial
  term leaves netD's update unchanged.  ``init_gan_variables`` applies the
  reference's construction-time DCGAN init.
- ``make_refiner_train_step``: the Refiner recipe (refiner.py:398-520) on
  ``RefineNet``: the coarse bundle (+ CE) behind ``--train_coarse`` and the
  multiscale refine bundle behind ``--train_refine``.
- ``make_refiner_gan_train_step``: the RefinerGAN recipe
  (refiner_gan.py:218-300) on ``RefineGAN``: the refine bundle and the BCE
  GAN terms once ``global_step`` passes ``adv_warmup_steps``, the G pass
  against the frozen discriminator.

Each step is ``train_step(state, batch) -> (state, loss_dict)`` on a
``train/state.TrainState`` (``create_train_state`` builds the optimizers
the JAX ``init_*_opt_states`` build: ``state.submodel_specs``); it updates
the model's parameters and the optimizer state in place.  The loss keys
and their order are the JAX step's.  Batches are dicts of NHWC tensors:
frame1..3 in [-1, 1] and seg1..3 as uint8 id maps; the VAE's ``frames``
(B, T+1, H, W, 3) in [0, 1], ``segs`` (B, T+1, H, W) ids and the fg / bg
masks (B, T+1, H, W, 1).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.core.seg import seg_oh
from deep_video_interpolation_extrapolation_tpu_torch.losses.gan import (
    bce_gan_loss,
    gan_map_loss,
)
from deep_video_interpolation_extrapolation_tpu_torch.losses.image import (
    cross_entropy_loss,
    l1_loss,
)
from deep_video_interpolation_extrapolation_tpu_torch.losses.vae import (
    kld_loss,
)
from deep_video_interpolation_extrapolation_tpu_torch.models.legacy_heads import (
    frozen,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.resize import (
    interpolate_bilinear,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.warp import (
    backward_warp,
    warp_steps,
)
from deep_video_interpolation_extrapolation_tpu_torch.train import (
    state as state_lib,
)
from deep_video_interpolation_extrapolation_tpu_torch.train.common import (
    get_inter_inputs,
    rgb_bundle,
    seg_id_targets,
    sum_losses,
    vgg_loss_from_frozen,
)

# GANOptions defaults the reference recipe trains with (gan_options.py):
# --d_w 10 scales both D terms, --adv_w 1 the G adversarial term
_GANER_D_WEIGHT = 10.0
_GANER_ADV_WEIGHT = 1.0


def _finish(state: state_lib.TrainState, cfg: Config, ld: OrderedDict):
    """``loss_all``, one backward, the optimizer steps; the detached
    losses."""
    total = sum_losses(ld)
    ld["loss_all"] = total
    total.backward()
    state_lib.apply_updates(cfg, state)
    return state, OrderedDict((k, v.detach()) for k, v in ld.items())


def _zero_grads(state: state_lib.TrainState) -> None:
    for opt in state.optimizers.values():
        opt.zero_grad(set_to_none=True)


def _ce(cfg: Config, logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return cfg.ce_weight * cross_entropy_loss(logits, seg_id_targets(ids))


def make_simple_train_step(cfg: Config, model: nn.Module) -> Callable:
    """A single generator ``(rgb, seg, train) -> (rgb, seg logits)``
    (legacy.py:492-524): the ``gen`` RGB bundle and, in ``xs2xs``,
    ``gen_ce_loss``; the coarse optimizer over the whole model."""

    def train_step(state: state_lib.TrainState, batch):
        x, seg, gt_x, _ = get_inter_inputs(batch)
        _zero_grads(state)
        rgb, seg_logits = model(x, seg, train=True)
        vgg_fn = vgg_loss_from_frozen(state.frozen_vgg)
        ld = rgb_bundle(cfg, rgb, gt_x, vgg_fn, "gen")
        if seg_logits is not None and cfg.mode == "xs2xs":
            ld["gen_ce_loss"] = _ce(cfg, seg_logits, batch["seg2"])
        return _finish(state, cfg, ld)

    return train_step


def flow_consistency_warps(model: nn.Module, gt: torch.Tensor,
                           flowback: torch.Tensor,
                           mask_bw: torch.Tensor) -> torch.Tensor:
    """``backward_warp(gt_t, -flowback_t * mask_bw_t)`` for every step t
    (B, T, H, W, C) (net_utils.warp_back, utils/net_utils.py:124-130): on
    the card one launch of the flow entry over the B * T frames at T = 1,
    ``mask_bw`` its mask; elsewhere (and for a model built with
    ``use_kernels=False``) per step, the JAX order."""
    b, t, h, w, c = gt.shape
    if model.use_kernels and hw.use_kernel(gt):
        out = warp_steps(gt.reshape(b * t, h, w, c),
                         (-flowback).reshape(b * t, 1, h, w, 2),
                         mask_bw.reshape(b * t, 1, h, w, 1))
        return out.reshape(b, t, h, w, c)
    return torch.stack([
        backward_warp(gt[:, i], -flowback[:, i] * mask_bw[:, i],
                      use_kernels=model.use_kernels)
        for i in range(t)], dim=1)


def make_vae_train_step(cfg: Config, model: nn.Module,
                        generator: Optional[torch.Generator] = None
                        ) -> Callable:
    """``models/vae_video.VideoVAE`` (legacy.py:175-235):
    ``train_step(state, batch, eps=None)``; the posterior's eps comes from
    ``generator`` unless given.  Loss keys: ``recon_warp_loss``,
    ``recon_refine_loss``, ``kld_loss``, ``vgg_loss`` (with a frozen VGG:
    the refined frames against the ground truth, both mapped [0, 1] ->
    [-1, 1], averaged over the steps), ``flow_consist_loss`` (10 times the
    mean over the steps of L1(warp(gt_t, -flowback_t * mask_bw_t) *
    mask_bw_t, frame1 * mask_bw_t): it trains flowback and mask_bw)."""

    def train_step(state: state_lib.TrainState, batch,
                   eps: Optional[torch.Tensor] = None):
        rgb_seq = batch["frames"]
        gt = rgb_seq[:, 1:]
        frame1 = rgb_seq[:, 0]
        _zero_grads(state)
        (output, y_pred, mu, logvar, _, flowback, _, mask_bw) = model(
            rgb_seq, seg_oh(batch["segs"]), batch["bg_masks"],
            batch["fg_masks"], train=True, generator=generator, eps=eps)
        ld = OrderedDict()
        ld["recon_warp_loss"] = cfg.l1_weight * l1_loss(output, gt)
        ld["recon_refine_loss"] = cfg.l1_weight * l1_loss(y_pred, gt)
        ld["kld_loss"] = kld_loss(mu, logvar, cfg.kld_weight)
        t = gt.shape[1]
        vgg_fn = vgg_loss_from_frozen(state.frozen_vgg)
        if vgg_fn is not None:
            v = sum(vgg_fn(y_pred[:, i] * 2.0 - 1.0, gt[:, i] * 2.0 - 1.0)
                    for i in range(t))
            ld["vgg_loss"] = cfg.vgg_weight * v / t
        back = flow_consistency_warps(model, gt, flowback, mask_bw)
        cons = sum(l1_loss(back[:, i] * mask_bw[:, i],
                           frame1 * mask_bw[:, i]) for i in range(t))
        ld["flow_consist_loss"] = 10.0 * cons / t
        return _finish(state, cfg, ld)

    return train_step


def init_gan_variables(model: nn.Module, seed: int) -> nn.Module:
    """The reference's construction of the legacy GAN head: nets/GAN.py:32-33
    applies the DCGAN ``weights_init`` to netG and netD right after
    building them, so the default init is re-sampled here
    (``state.gan_weights_init``, draws from a generator of ``seed``)."""
    gen = torch.Generator(device=next(model.parameters()).device)
    return state_lib.gan_weights_init(model, gen.manual_seed(seed))


def make_gan_train_step(cfg: Config, model: nn.Module) -> Callable:
    """The ``GAN`` head (legacy.py:80-160): the ``gen`` RGB bundle,
    ``gen_ce_loss``, then ``adv_loss`` (_GANER_ADV_WEIGHT times the patch-map
    loss of the G pass against the real target) and ``d_real_loss`` /
    ``d_fake_loss`` (_GANER_D_WEIGHT times those of D on the real and the
    detached fake), one backward; netG steps with Adamax at the coarse
    learning rate, netD with SGD (momentum 0.9) at the frame
    discriminator's."""

    def train_step(state: state_lib.TrainState, batch):
        x, seg, gt_x, gt_seg = get_inter_inputs(batch)
        _zero_grads(state)
        fake_rgb, fake_seg, d_fake, d_real, g_fake = model(
            x, seg, gt_x, gt_seg, train=True)
        vgg_fn = vgg_loss_from_frozen(state.frozen_vgg)
        ld = rgb_bundle(cfg, fake_rgb, gt_x, vgg_fn, "gen")
        if fake_seg is not None:
            ld["gen_ce_loss"] = _ce(cfg, fake_seg, batch["seg2"])
        ld["adv_loss"] = _GANER_ADV_WEIGHT * gan_map_loss(g_fake, None, True)
        ld["d_real_loss"] = _GANER_D_WEIGHT * gan_map_loss(d_real, None, True)
        ld["d_fake_loss"] = _GANER_D_WEIGHT * gan_map_loss(d_fake, None,
                                                           False)
        return _finish(state, cfg, ld)

    return train_step


def _refiner_inputs(cfg: Config, batch):
    """(x, seg, gt_x, gt_seg, target seg key) per syn type (refiner.py
    get_input_output): inter (frame1, frame3) -> frame2; extra (frame1,
    frame2) -> frame3."""
    if cfg.syn_type == "extra":
        x = torch.cat([batch["frame1"], batch["frame2"]], dim=-1)
        seg = torch.cat([seg_oh(batch["seg1"]), seg_oh(batch["seg2"])], -1)
        return x, seg, batch["frame3"], seg_oh(batch["seg3"]), "seg3"
    return (*get_inter_inputs(batch), "seg2")


def _coarse_terms(cfg: Config, ld, coarse_rgb, out_seg, gt_x, vgg_fn, ids):
    """The coarse bundle and, in ``xs2xs``, ``coarse_ce_loss``, where
    ``--train_coarse`` is set."""
    if cfg.train_coarse:
        ld.update(rgb_bundle(cfg, coarse_rgb, gt_x, vgg_fn, "coarse"))
        if cfg.mode == "xs2xs":
            ld["coarse_ce_loss"] = _ce(cfg, out_seg, ids)


def _refine_terms(cfg: Config, ld, refine_rgbs, gt_x, vgg_fn):
    """The refine-weighted bundle of each of the ``--n_sc`` scales, the
    finest (the last output) first, against the ground truth downscaled
    with align_corners (refiner_gan.py:245), keyed ``refine_<i>``."""
    for i in range(cfg.n_scales):
        gt_i = gt_x if i == 0 else interpolate_bilinear(
            gt_x, scale_factor=0.5 ** i, align_corners=True)
        ld.update(rgb_bundle(cfg, refine_rgbs[-i - 1], gt_i, vgg_fn,
                             f"refine_{i}", refine=True))


def make_refiner_train_step(cfg: Config, model: nn.Module) -> Callable:
    """The ``RefineNet`` head (legacy.py:250-335): the coarse terms behind
    ``--train_coarse``, the refine terms behind ``--train_refine`` (an
    extrapolation RefineNet trains its coarse alone); each submodel steps
    on its own optimizer behind its flag."""

    def train_step(state: state_lib.TrainState, batch):
        x, seg, gt_x, gt_seg, tgt_key = _refiner_inputs(cfg, batch)
        _zero_grads(state)
        out = model(x, seg, gt_x, gt_seg, train=True)
        coarse_rgb, out_seg = out[:2]
        refine_rgbs = out[2] if len(out) == 3 else []
        if not isinstance(refine_rgbs, (list, tuple)):
            refine_rgbs = [refine_rgbs]
        vgg_fn = vgg_loss_from_frozen(state.frozen_vgg)
        ld = OrderedDict()
        _coarse_terms(cfg, ld, coarse_rgb, out_seg, gt_x, vgg_fn,
                      batch[tgt_key])
        if cfg.train_refine and refine_rgbs:
            _refine_terms(cfg, ld, refine_rgbs, gt_x, vgg_fn)
        return _finish(state, cfg, ld)

    return train_step


def make_refiner_gan_train_step(cfg: Config, model: nn.Module,
                                adv_warmup_steps: int = 1000) -> Callable:
    """The ``RefineGAN`` head (legacy.py:351-476):
    ``train_step(state, batch, global_step=None)``.  G: the coarse terms
    behind ``--train_coarse``, the refine terms, and ``adv_loss``
    (``--frame_disc_gen_weight`` times BCE of the G pass against the real
    target); D: ``d_real_loss`` and ``d_fake_loss``
    (``--frame_disc_disc_weight`` times BCE on the real and the detached
    fake).  The three GAN terms are zero until ``global_step`` passes
    ``adv_warmup_steps`` (always on without a step).  The generator runs
    its train-mode forward without the discriminator (``with_disc=False``);
    the discriminator passes run here, the G pass against the frozen
    discriminator.  The coarse and refine models step with the coarse
    optimizer, the discriminator with SGD (momentum 0.9), both at the
    coarse learning rate."""

    def train_step(state: state_lib.TrainState, batch,
                   global_step: Optional[int] = None):
        x, seg, gt_x, gt_seg = get_inter_inputs(batch)
        adv_on = 1.0 if global_step is None else float(
            global_step > adv_warmup_steps)
        _zero_grads(state)
        coarse_rgb, refine_rgbs, out_seg = model(
            x, seg, gt_x, gt_seg, train=True, with_disc=False)
        last = refine_rgbs[-1]
        vgg_fn = vgg_loss_from_frozen(state.frozen_vgg)
        ld = OrderedDict()
        _coarse_terms(cfg, ld, coarse_rgb, out_seg, gt_x, vgg_fn,
                      batch["seg2"])
        _refine_terms(cfg, ld, refine_rgbs, gt_x, vgg_fn)
        disc = model.discriminator
        d_fake = disc(torch.cat([last.detach(), gt_seg], -1), True)
        d_real = disc(torch.cat([gt_x, gt_seg], -1), True)
        with frozen(disc):
            g_fake = disc(torch.cat([last, gt_seg], -1), True)
        ld["adv_loss"] = adv_on * cfg.frame_disc_gen_weight * bce_gan_loss(
            g_fake, True)
        ld["d_real_loss"] = adv_on * cfg.frame_disc_disc_weight * \
            bce_gan_loss(d_real, True)
        ld["d_fake_loss"] = adv_on * cfg.frame_disc_disc_weight * \
            bce_gan_loss(d_fake, False)
        return _finish(state, cfg, ld)

    return train_step
