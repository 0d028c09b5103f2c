"""Composite model heads (counterpart of models/composite.py): ``InterNet``,
``InterRefineNet``, ``InterStage3Net``, ``InterGANNet``, ``ExtraNet`` and
``ExtraInpaintNet``, for training and eval.

Where JAX stops the gradient, the port detaches.  A submodel whose
parameters do not require grad (frozen by ``train/state``) runs without
autograd where no gradient has to pass through it: a frozen HRNet then
launches only its forward kernels.  It runs under ``no_grad``, not
``inference_mode``, so the weight layouts its kernels keep
(``core/hw.derived``) stay usable by a later training forward.  In an
extrapolation rollout a later step's input carries the gradient of an
earlier step's output, so there a frozen submodel runs under autograd
(``_grad_through``) and passes it on.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.models.blocks import (
    needs_grad,
)


def _grad_through(module: nn.Module, *inputs: torch.Tensor) -> bool:
    """Whether ``module`` runs under autograd: its parameters need a
    gradient, or one of ``inputs`` carries one that must pass through."""
    return needs_grad(module) or (torch.is_grad_enabled() and any(
        t.requires_grad for t in inputs))


def _coarse(model: nn.Module, rgb, seg, gt_rgb, gt_seg, train: bool,
            generator: Optional[torch.Generator]):
    """The coarse model's outputs: (rgb, seg) of an HRNet; of a VAEHRNet
    (the plain VAE) (rgb, seg, mu, logvar) in train mode, its posterior
    conditioned on (gt_rgb, gt_seg), and (rgb, seg) at eval, z from the
    prior (composite.py:36-42), eps and z drawn from ``generator``."""
    if not model.vae:
        return tuple(model(rgb, seg)[:2])
    out = model(rgb, seg, gt_rgb, gt_seg, train=train, generator=generator)
    return tuple(out if train else out[:2])


class InterNet(nn.Module):
    """Coarse-only interpolation (composite.py:28-42):
    ``(rgb, seg) -> (rgb_out, seg_out)``, differentiable.  On a VAEHRNet
    coarse (the plain VAE), ``forward(rgb, seg, gt_seg, gt_rgb, train=True,
    generator=None)`` also returns (mu, logvar) for the KL term."""

    def __init__(self, cfg: Config, use_kernels: bool = True):
        super().__init__()
        self.coarse_model = registry.build_coarse(cfg, use_kernels)

    def forward(self, rgb: torch.Tensor, seg: torch.Tensor,
                gt_seg: Optional[torch.Tensor] = None,
                gt_rgb: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        return _coarse(self.coarse_model, rgb, seg, gt_rgb, gt_seg, train,
                       generator)


def _as_scale_list(refine_out) -> List[torch.Tensor]:
    """A refiner's output as the per-scale list: SRNRefine returns a list,
    RefineUnet a single image (composite.py:45-52)."""
    if isinstance(refine_out, (list, tuple)):
        return list(refine_out)
    return [refine_out]


class InterRefineNet(nn.Module):
    """Coarse + refine (composite.py:55-80): ``(rgb, seg, gt_seg=None) ->
    (coarse_rgb, coarse_seg, refine_rgbs)``, the refined frames clipped to
    [-10, 10].  With ``--with_gt_seg`` an eval forward given ``gt_seg``
    refines on it in place of the coarse soft seg (the train step passes
    none)."""

    clip = 10.0

    def __init__(self, cfg: Config, use_kernels: bool = True):
        super().__init__()
        self.with_gt_seg = cfg.with_gt_seg
        self.coarse_model = registry.build_coarse(cfg, use_kernels)
        self.refine_model = registry.build_refine(cfg)

    def _refine(self, rgb: torch.Tensor, seg: torch.Tensor,
                gt_seg: Optional[torch.Tensor] = None):
        """The coarse forward and the refiner on its detached outputs:
        (coarse_rgb, coarse_seg, soft seg, refine_rgbs clipped)."""
        with torch.set_grad_enabled(needs_grad(self.coarse_model)):
            coarse_rgb, coarse_seg = self.coarse_model(rgb, seg)[:2]
            # per-frame seg embeddings of the coarse model's encoder, in
            # its dtype, detached (composite.py:68-75)
            enc = self.coarse_model.seg_encoder
            dt = self.coarse_model.dtype
            feats = [enc(seg[..., :20], dt).detach(),
                     enc(seg[..., 20:40], dt).detach()]
        soft = torch.softmax(coarse_seg, dim=-1).detach()
        if self.with_gt_seg and gt_seg is not None:
            soft = gt_seg
        encoded_feat = torch.cat([rgb] + [f.to(rgb.dtype) for f in feats],
                                 dim=-1)
        coarse_in = torch.clamp(coarse_rgb.detach(), -1, 1)
        with torch.set_grad_enabled(needs_grad(self.refine_model)):
            refine_rgbs = _as_scale_list(
                self.refine_model(coarse_in, soft, encoded_feat))
        refine_rgbs = [torch.clamp(r, -self.clip, self.clip)
                       for r in refine_rgbs]
        return coarse_rgb, coarse_seg, soft, refine_rgbs

    def forward(self, rgb: torch.Tensor, seg: torch.Tensor,
                gt_seg: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
        coarse_rgb, coarse_seg, _, refine_rgbs = self._refine(rgb, seg, gt_seg)
        return coarse_rgb, coarse_seg, refine_rgbs


class InterStage3Net(InterRefineNet):
    """Coarse + refine + attention re-refine (composite.py:83-111):
    ``(rgb, seg, gt_seg=None) -> (coarse_rgb, coarse_seg, refine_rgbs,
    stage3_rgbs, flow_maps)``; the refined frames clipped to [-1, 1], the
    stage-3 ones to [-10, 10]; ``flow_maps`` is None for V2Base."""

    clip = 1.0

    def __init__(self, cfg: Config, use_kernels: bool = True):
        super().__init__(cfg, use_kernels)
        self.stage3_model = registry.build_stage3(cfg, use_kernels)

    def forward(self, rgb: torch.Tensor, seg: torch.Tensor,
                gt_seg: Optional[torch.Tensor] = None):
        coarse_rgb, coarse_seg, soft, refine_rgbs = self._refine(rgb, seg,
                                                                 gt_seg)
        with torch.set_grad_enabled(needs_grad(self.stage3_model)):
            stage3_rgbs, flow_maps = self.stage3_model(
                refine_rgbs[-1].detach(), soft, rgb, seg)
        stage3_rgbs = [torch.clamp(r, -10, 10) for r in stage3_rgbs]
        return coarse_rgb, coarse_seg, refine_rgbs, stage3_rgbs, flow_maps


# (train flag, submodule and model-name attribute, takes the input frames)
# of the four discriminator families (InterGANNet.py:10-26)
DISC_FAMILIES = (("frame_disc", "frame_disc_model", False),
                 ("frame_det_disc", "frame_det_disc_model", False),
                 ("video_disc", "video_disc_model", True),
                 ("video_det_disc", "video_det_disc_model", True))


class InterGANNet(nn.Module):
    """VAE coarse + the four discriminator families (composite.py:153-224):
    ``coarse_model`` (VAEHRNet), ``track_gen_model`` under ``--track_gen``
    and ``<family>_model`` for each family whose flag is set.
    ``forward(rgb, seg, gt_rgb=None, gt_seg=None, bboxes=None,
    train=False, generator=None)`` returns the reference's
    19-tuple (coarse_rgb, coarse_seg, mu, logvar, D_fake_frame,
    D_real_frame, D_fake_video, D_real_video, G_fake_frame, G_fake_video,
    D_fake_fdet, D_real_fdet, D_fake_vdet, D_syncfake_vdet, D_real_vdet,
    G_fake_fdet, G_fake_vdet, gen_bbox, loc_diff_loss); the discriminator
    terms are None at eval.  The track branch runs on the coarse outputs in
    train mode, or at eval when boxes are given (composite.py:185-193); it
    is given ``gt_bbox_for_loss`` where its name holds "V2".  The train
    step (``train/inter_gan``) applies the submodules itself, isolating the
    gradients there."""

    def __init__(self, cfg: Config, use_kernels: bool = True):
        super().__init__()
        if cfg.coarse_model != "VAEHRNet":
            raise ValueError("InterGANNet takes --coarse_model VAEHRNet "
                             f"(its (rgb, seg, mu, logvar)), not "
                             f"{cfg.coarse_model!r}")
        self.coarse_model = registry.build_coarse(cfg, use_kernels)
        self.track_kw = None
        if cfg.track_gen:
            self.track_gen_model = registry.build_track_gen(cfg)
            self.track_kw = ({"gt_bbox_for_loss": True}
                             if "V2" in cfg.track_gen_model else {})
        self.families = []
        for flag, attr, video in DISC_FAMILIES:
            if getattr(cfg, flag):
                setattr(self, attr, registry.build_disc(cfg, getattr(cfg,
                                                                     attr)))
                self.families.append((attr, video))

    def forward(self, rgb, seg, gt_rgb=None, gt_seg=None, bboxes=None,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        coarse_rgb, coarse_seg, mu, logvar = self.coarse_model(
            rgb, seg, gt_rgb, gt_seg, train=train, generator=generator)
        gen_bbox, loc_diff = None, torch.zeros((), device=rgb.device)
        if self.track_kw is not None and (train or bboxes is not None):
            coarse_rgb, coarse_seg, gen_bbox, loc_diff = self.track_gen_model(
                rgb, seg, coarse_rgb, coarse_seg, bboxes, **self.track_kw)
        out = {}
        if train:
            soft = torch.softmax(coarse_seg, dim=-1)
            for attr, video in self.families:
                disc = getattr(self, attr)
                extra = (rgb, seg) if video else ()
                out[attr] = (
                    disc(coarse_rgb.detach(), soft.detach(), *extra,
                         bboxes=bboxes, train=True),
                    disc(gt_rgb, gt_seg, *extra, bboxes=bboxes, train=True),
                    disc(coarse_rgb, soft, *extra, bboxes=bboxes,
                         train=True))
            if "video_det_disc_model" in out:
                out["sync"] = self.video_det_disc_model(
                    gt_rgb, gt_seg, rgb, seg, bboxes=bboxes, sync_neg=True,
                    train=True, generator=generator)
        none3 = (None, None, None)
        fr, fd = out.get("frame_disc_model", none3), out.get(
            "frame_det_disc_model", none3)
        vi, vd = out.get("video_disc_model", none3), out.get(
            "video_det_disc_model", none3)
        return (coarse_rgb, coarse_seg, mu, logvar, fr[0], fr[1], vi[0],
                vi[1], fr[2], vi[2], fd[0], fd[1], vd[0], out.get("sync"),
                vd[1], fd[2], vd[2], gen_bbox, loc_diff)


class ExtraNet(nn.Module):
    """Coarse-only extrapolation (composite.py:114-128): ``(rgb, seg) ->
    (rgb_out, seg_out)`` of ``num_pred_once`` frames, differentiable.  On a
    VAEHRNet coarse (the plain VAE), ``forward(rgb, seg, gt_seg, gt_rgb,
    train=True, generator=None)`` also returns (mu, logvar) for the KL
    term, as InterNet."""

    def __init__(self, cfg: Config, use_kernels: bool = True):
        super().__init__()
        self.coarse_model = registry.build_coarse(cfg, use_kernels)

    def forward(self, rgb: torch.Tensor, seg: torch.Tensor,
                gt_seg: Optional[torch.Tensor] = None,
                gt_rgb: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        with torch.set_grad_enabled(_grad_through(self.coarse_model, rgb)):
            return _coarse(self.coarse_model, rgb, seg, gt_rgb, gt_seg,
                           train, generator)


class ExtraInpaintNet(nn.Module):
    """Coarse + occlusion-mask inpainting (composite.py:131-151): ``(rgb,
    seg) -> (coarse_rgb, coarse_seg, mask, inpainted)``; the inpainter
    takes the coarse outputs with their gradient, as the JAX module does.
    A coarse model that returns no mask (HRNet without ``--inpaint``)
    raises the JAX ``ValueError``."""

    def __init__(self, cfg: Config, use_kernels: bool = True):
        super().__init__()
        self.coarse_name = cfg.coarse_model
        self.coarse_model = registry.build_coarse(cfg, use_kernels)
        self.inpaint_model = registry.build_inpaint(cfg)

    def forward(self, rgb: torch.Tensor, seg: torch.Tensor,
                gt_seg: Optional[torch.Tensor] = None):
        with torch.set_grad_enabled(_grad_through(self.coarse_model, rgb)):
            out = self.coarse_model(rgb, seg)
        if len(out) != 3:
            raise ValueError(
                "ExtraInpaintNet needs a mask-producing coarse model (HRNet "
                f"with inpaint, nets/HRNet.py:585-601); {self.coarse_name!r} "
                f"returned {len(out)} outputs")
        coarse_rgb, out_seg, mask = out
        with torch.set_grad_enabled(_grad_through(
                self.inpaint_model, coarse_rgb, mask, out_seg)):
            inpainted = self.inpaint_model(coarse_rgb, mask, out_seg)
        return coarse_rgb, out_seg, mask, inpainted
