"""Composite model heads (counterpart of models/composite.py): ``InterNet``,
``InterRefineNet`` and ``InterStage3Net``, for training and eval.  The
other composites wait in ROADMAP.md queue 1.

Where JAX stops the gradient, the port detaches.  A submodel whose
parameters do not require grad (frozen by ``train/state``) runs without
autograd: a frozen HRNet then launches only its forward kernels.  It runs
under ``no_grad``, not ``inference_mode``, so the weight layouts its
kernels keep (``core/hw.derived``) stay usable by a later training
forward.
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


class InterNet(nn.Module):
    """Coarse-only interpolation (composite.py:28-42):
    ``(rgb, seg) -> (rgb_out, seg_out)``, differentiable."""

    def __init__(self, cfg: Config, use_kernels: bool = True):
        super().__init__()
        self.coarse_model = registry.build_coarse(cfg, use_kernels)

    def forward(self, rgb: torch.Tensor, seg: torch.Tensor,
                gt_seg: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        out = self.coarse_model(rgb, seg)
        return out[0], out[1]


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
