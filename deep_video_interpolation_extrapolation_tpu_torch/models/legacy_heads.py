"""The legacy composite heads (counterpart of the JAX package's
``models/legacy_heads.py``: reference nets/GAN.py, RefineNet.py,
RefineGAN.py), the GANer / Refiner era wiring.

Where JAX stops the gradient, the port detaches.  The G pass of ``GAN``
runs its discriminator with the parameters frozen (``frozen``: they stop
requiring grad for that pass, the reference's ``set_net_grad(netD,
False)``), so the adversarial term's gradient reaches the generator and
never the discriminator: the update the JAX step makes by re-running the
head on a stop-gradient'ed netD subtree.  A submodel whose parameters do
not require grad (frozen by ``train/state``) runs without autograd where
nothing has to pass through it: a frozen HRNet coarse then launches only
its forward kernels.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.models.blocks import (
    needs_grad,
)
from deep_video_interpolation_extrapolation_tpu_torch.models.hrnet import HRNet
from deep_video_interpolation_extrapolation_tpu_torch.models.legacy_disc import (
    MotionDiscriminator,
    MultiscaleDiscriminator,
)
from deep_video_interpolation_extrapolation_tpu_torch.models.legacy_gen import (
    MyFRRN,
)
from deep_video_interpolation_extrapolation_tpu_torch.models.optical import (
    RefineUnet,
)

# the discriminator input's channels by --netD (nets/GAN.py:21-31)
D_CHANNELS = {"multi_scale": 9, "multi_scale_img": 3, "motion_img": 9,
              "multi_scale_img_seg": 23}


@contextlib.contextmanager
def frozen(module: nn.Module):
    """``module``'s parameters stop requiring grad inside the block (the
    gradient still passes through to its inputs), then are restored."""
    flags = [(p, p.requires_grad) for p in module.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def apply_coarse(model: nn.Module, rgb: torch.Tensor, seg: torch.Tensor,
                 train: bool):
    """(rgb, seg logits) of a coarse model: HRNet takes no ``train``, the
    legacy generators do (registry.py:72-82)."""
    if isinstance(model, HRNet):
        return tuple(model(rgb, seg)[:2])
    return tuple(model(rgb, seg, train=train)[:2])


class GAN(nn.Module):
    """MyFRRN generator + multiscale or motion discriminator
    (nets/GAN.py:14-217).  ``forward(rgb, seg, gt_rgb=None, gt_seg=None,
    train=True)`` returns (fake_rgb, fake_seg, pred_fake_D, pred_real_D,
    pred_fake_G) at train, (fake_rgb, fake_seg) at eval; D sees the
    detached fake, and the G pass runs against the frozen netD."""

    def __init__(self, net_d: str = "multi_scale_img_seg", num_d: int = 2,
                 mode: str = "xs2xs", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.net_d = net_d
        self.netG = MyFRRN(mode=mode, dtype=dtype)
        cin = D_CHANNELS[net_d]
        if net_d.startswith("multi_scale"):
            self.netD = MultiscaleDiscriminator(
                cin, num_d=num_d, use_sigmoid=True, get_interm_feat=True,
                dtype=dtype)
        else:
            self.netD = MotionDiscriminator(cin, dtype=dtype)

    def _d_input(self, rgb_pred, gt_seg, rgb_in):
        if self.net_d == "multi_scale":       # input pair + prediction
            return torch.cat([rgb_in[..., :6], rgb_pred], -1)
        if self.net_d == "multi_scale_img":
            return rgb_pred
        if self.net_d == "motion_img":        # (frame1, pred, frame2)
            return torch.cat([rgb_in[..., :3], rgb_pred, rgb_in[..., 3:6]], -1)
        # multi_scale_img_seg: the ground-truth seg rides along on both the
        # fake and the real input (nets/GAN.py:120-126)
        return torch.cat([rgb_pred, gt_seg], -1)

    def forward(self, rgb, seg, gt_rgb=None, gt_seg=None, train: bool = True):
        fake_rgb, fake_seg = self.netG(rgb, seg, train=train)
        if not train:
            return fake_rgb, fake_seg
        pred_fake_d = self.netD(self._d_input(fake_rgb.detach(), gt_seg, rgb),
                                train)
        pred_real_d = self.netD(self._d_input(gt_rgb, gt_seg, rgb), train)
        with frozen(self.netD):
            pred_fake_g = self.netD(self._d_input(fake_rgb, gt_seg, rgb),
                                    train)
        return fake_rgb, fake_seg, pred_fake_d, pred_real_d, pred_fake_g


class RefineNet(nn.Module):
    """Legacy coarse + refine head (nets/RefineNet.py:13-41; the reference's
    inter branch is broken, so as in the JAX package: coarse, then the
    refiner on the detached coarse rgb, the coarse soft seg (not detached:
    the refine losses reach a trained coarse through it) and the detached
    seg embeddings).  ``forward(rgb, seg, gt_rgb=None, gt_seg=None,
    train=True)`` -> (coarse_rgb, coarse_seg, refine_rgbs), or (coarse_rgb,
    coarse_seg) under ``--syn_type extra``."""

    def __init__(self, cfg: Config, use_kernels: bool = True):
        super().__init__()
        self.extra = cfg.syn_type == "extra"
        self.coarse_model = registry.build_coarse(cfg, use_kernels)
        self.refine_model = registry.build_refine(cfg)

    def forward(self, rgb, seg, gt_rgb=None, gt_seg=None, train: bool = True):
        coarse = self.coarse_model
        with torch.set_grad_enabled(needs_grad(coarse)):
            coarse_rgb, out_seg = apply_coarse(coarse, rgb, seg, train)
        if self.extra:
            return coarse_rgb, out_seg
        soft = torch.softmax(out_seg, dim=-1)
        with torch.no_grad():
            enc = [coarse.seg_encoder(seg[..., :20], coarse.dtype),
                   coarse.seg_encoder(seg[..., 20:40], coarse.dtype)]
        feat = torch.cat([rgb] + [e.to(rgb.dtype) for e in enc], dim=-1)
        with torch.set_grad_enabled(needs_grad(self.refine_model)
                                    or soft.requires_grad):
            refine_rgbs = self.refine_model(coarse_rgb.detach(), soft, feat)
        return coarse_rgb, out_seg, refine_rgbs


class RefineGAN(nn.Module):
    """Coarse + refine + a 23-channel two-scale PatchGAN
    (nets/RefineGAN.py:14-46): the refiner sees only the detached coarse
    rgb, so its losses never reach the coarse model (``--refine_model
    refineUnet``: a RefineUnet of 3 input channels).  ``forward(rgb, seg,
    gt_rgb=None, gt_seg=None, train=True, with_disc=True)`` -> (coarse_rgb,
    refine_rgbs, coarse_seg, pred_fake_D, pred_real_D, pred_fake_G), or the
    first three at eval or with ``with_disc=False`` (the train step applies
    the discriminator itself, freezing it for the G pass)."""

    def __init__(self, cfg: Config, use_kernels: bool = True):
        super().__init__()
        if cfg.refine_model == "SRNRefine":
            raise NotImplementedError(
                "RefineGAN on SRNRefine (a refiner fed the coarse rgb alone) "
                "is not ported: use --refine_model refineUnet")
        self.coarse_model = registry.build_coarse(cfg, use_kernels)
        self.refine_model = RefineUnet(cin=3, dtype=registry.compute_dtype(cfg))
        self.discriminator = MultiscaleDiscriminator(
            23, num_d=2, use_sigmoid=True, get_interm_feat=False,
            dtype=registry.compute_dtype(cfg))

    def forward(self, rgb, seg, gt_rgb=None, gt_seg=None, train: bool = True,
                with_disc: bool = True):
        with torch.set_grad_enabled(needs_grad(self.coarse_model)):
            coarse_rgb, out_seg = apply_coarse(self.coarse_model, rgb, seg,
                                               train)
        refine_rgbs = self.refine_model(coarse_rgb.detach())
        if not isinstance(refine_rgbs, (list, tuple)):
            refine_rgbs = [refine_rgbs]
        if not train or not with_disc:
            return coarse_rgb, refine_rgbs, out_seg
        last = refine_rgbs[-1]
        disc = self.discriminator
        pred_fake_d = disc(torch.cat([last.detach(), gt_seg], -1), train)
        pred_real_d = disc(torch.cat([gt_rgb, gt_seg], -1), train)
        pred_fake_g = disc(torch.cat([last, gt_seg], -1), train)
        return (coarse_rgb, refine_rgbs, out_seg, pred_fake_d, pred_real_d,
                pred_fake_g)
