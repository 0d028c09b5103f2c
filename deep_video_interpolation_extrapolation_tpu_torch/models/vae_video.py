"""The flow-based video VAE family (counterpart of the JAX package's
``models/vae_video.py``: reference nets/VAE.py, VAE_S.py, VAE_SD.py).

frame1 + a latent motion code -> per-step forward/backward flows and
occlusion masks -> frame1 backward-warped into ``vid_length`` future frames
(on the card one launch of the grid-sample kernel's flow entry,
``ops/warp.warp_steps``, for all steps; on the CPU ``backward_warp`` per
step, the JAX model's own order of operations) -> an encoder-decoder
refinement.  The variants differ in how segmentation
conditions the posterior: ``vae`` embeds the first frame's seg only
(latent 128 bg / 896 fg, refine on rgb); ``vae_s`` and ``vae_sd`` embed
every frame's, take frame differences as the motion input (latent 512 /
512) and refine on rgb + 20 zero seg channels (``vae_sd`` is the same
module structure).  Time is an explicit axis (B, T, ...).

``forward(rgb_seq, seg_seq, bg_mask, fg_mask, noise_bg=None, z_m=None,
train=None, generator=None, eps=None)``: rgb_seq (B, T+1, H, W, 3) in [0, 1],
seg_seq (B, T+1, H, W, 20) one-hot, masks (B, T+1, H, W, 1), noise_bg
(B, H, W, 3).  ``train`` (default: ``self.training``) picks the BatchNorm
statistics and, without ``z_m``, whether the code comes from the posterior
(mu + eps * std) or from the prior; the noise is drawn from ``generator``,
where the JAX forward draws from its ``noise`` rng, unless the posterior's
``eps`` (B, 1024) is given (a test feeds the JAX draw).  On the card the
warp trains through the grid-sample kernel's backward (``warp_steps``).  Returns (train)
(output, y_pred, mu, logvar, flow, flowback, mask_fw, mask_bw), (eval)
(output, y_pred, flow, flowback, mask_fw, mask_bw).  Shapes the JAX module
takes from its input at init are fixed by ``size`` = (H, W).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.models.subnets import (
    ConvBase,
    Dense,
    FlowDecoder,
    FlowEncoder,
    FrameEncoder,
    GetFlow,
    GetOcclusionMask,
    LegacyRefineNet,
    SegEncoderBN,
)
from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.ops.warp import (
    backward_warp,
    warp_steps,
)
from deep_video_interpolation_extrapolation_tpu_torch.parallel import dist

VARIANTS = ("vae", "vae_s", "vae_sd")


class VideoVAE(nn.Module):
    """Shared implementation; ``variant`` in ``VARIANTS``."""

    def __init__(self, vid_length: int = 1, variant: str = "vae",
                 refine: bool = True, dtype: Optional[torch.dtype] = None,
                 size: Tuple[int, int] = (128, 128), use_kernels: bool = True):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"variant {variant!r} not in {VARIANTS}")
        h, w = size
        if h % 8 or w % 8:
            raise ValueError(f"VideoVAE takes sizes divisible by 8, got {size}")
        t = self.vid_length = vid_length
        self.variant, self.refine, self.dtype = variant, refine, dtype
        self.use_kernels = use_kernels
        if variant == "vae":
            self.latent_bg, self.latent_fg = 128, 896
            flow_cin = 3 * (t + 1) + 4
        else:
            self.latent_bg, self.latent_fg = 512, 512
            flow_cin = 3 * (t + 1) + 4 * (t + 1)
        self.seg_encoder = SegEncoderBN(dtype=dtype)
        self.encoder = FrameEncoder(3 + 4, dtype=dtype)
        self.flow_encoder_bg = FlowEncoder(flow_cin, self.latent_bg, size,
                                           dtype)
        self.flow_encoder_fg = FlowEncoder(flow_cin, self.latent_fg, size,
                                           dtype)
        self.zh, self.zw = h // 8, w // 8
        self.fc = Dense(self.latent_bg + self.latent_fg,
                        48 * self.zh * self.zw)
        self.zconv = ConvBase(48 + 256, 16 * t, dtype=dtype)
        self.flow_decoder = FlowDecoder(t, 256 + 16, dtype)
        self.flownext = GetFlow(dtype=dtype)
        self.flowprev = GetFlow(dtype=dtype)
        self.get_mask = GetOcclusionMask(dtype=dtype)
        self.nc = 3 if variant == "vae" else 23
        if refine:
            self.refine_net = LegacyRefineNet(self.nc, size, dtype)

    def forward(self, rgb_seq, seg_seq, bg_mask, fg_mask, noise_bg=None,
                z_m=None, train: Optional[bool] = None,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        train = self.training if train is None else train
        t = self.vid_length
        b, _, h, w, _ = rgb_seq.shape
        frame1, future = rgb_seq[:, 0], rgb_seq[:, 1:]

        if self.variant == "vae":
            seg0 = self.seg_encoder(seg_seq[:, 0], train)
            fg_seg, bg_seg = seg0 * fg_mask[:, 0], seg0 * bg_mask[:, 0]
            y = torch.cat([frame1] + [future[:, i] for i in range(t)], -1)
        else:
            segs = [self.seg_encoder(seg_seq[:, i], train)
                    for i in range(t + 1)]
            fg_seg = torch.cat([segs[i] * fg_mask[:, i]
                                for i in range(t + 1)], -1)
            bg_seg = torch.cat([segs[i] * bg_mask[:, i]
                                for i in range(t + 1)], -1)
            seg0 = segs[0]
            y = torch.cat([frame1] + [future[:, i] - frame1
                                      for i in range(t)], -1)

        enco1, enco2, enco3, codex = self.encoder(
            torch.cat([frame1, seg0], -1), train)

        mu = logvar = None
        if z_m is None:
            if train:
                mu_bg, logvar_bg = self.flow_encoder_bg(
                    torch.cat([y, bg_seg], -1), train)
                mu_fg, logvar_fg = self.flow_encoder_fg(
                    torch.cat([y, fg_seg], -1), train)
                mu = torch.cat([mu_bg, mu_fg], -1)
                logvar = torch.cat([logvar_bg, logvar_fg], -1)
                if eps is None:
                    eps = dist.global_draw(
                        lambda s: torch.randn(s, generator=generator,
                                              device=mu.device), mu.shape)
                eps = eps.to(mu.dtype)
                z_m = mu + eps * torch.exp(0.5 * logvar)
            else:
                z_m = dist.global_draw(
                    lambda s: torch.randn(s, generator=generator,
                                          device=frame1.device),
                    (b, self.latent_bg + self.latent_fg)).to(frame1.dtype)

        fc = self.fc(z_m, self.dtype).reshape(b, self.zh, self.zw, 48)
        codey = self.zconv(torch.cat([fc, codex], -1))
        codey = codey.reshape(b, self.zh, self.zw, t, 16).permute(0, 3, 1, 2, 4)
        codex_t = codex[:, None].expand((b, t) + codex.shape[1:])
        z = torch.cat([codex_t, codey], -1)              # (B, T, zh, zw, 272)

        deco = self.flow_decoder(enco1, enco2, enco3, z, train)
        df = deco.reshape((b * t,) + deco.shape[2:])
        flow = self.flownext(df, train).reshape(b, t, h, w, 2)
        flowback = self.flowprev(df, train).reshape(b, t, h, w, 2)
        masks = self.get_mask(df, train).reshape(b, t, h, w, 2)
        mask_fw, mask_bw = masks[..., 0:1], masks[..., 1:2]

        # the masked backward warp of frame1 per step (utils/net_utils.py:116-122)
        if self.use_kernels and hw.use_kernel(frame1):
            output = warp_steps(frame1, flow, mask_fw)   # (B, T, H, W, 3)
        else:
            output = torch.stack([
                backward_warp(frame1, flow[:, i] * mask_fw[:, i],
                              use_kernels=self.use_kernels)
                for i in range(t)], dim=1)

        y_pred = output
        if self.refine:
            if noise_bg is None:
                noise_bg = torch.zeros_like(frame1)
            noise, pad = noise_bg, None
            if self.nc == 23:
                pad = torch.zeros((b, h, w, 20), dtype=noise_bg.dtype,
                                  device=noise_bg.device)
                noise = torch.cat([noise_bg, pad], -1)
            preds = []
            for i in range(t):
                inp = output[:, i] * mask_fw[:, i]
                if pad is not None:
                    inp = torch.cat([inp, pad.to(inp.dtype)], -1)
                inp = inp + noise * (1.0 - mask_fw[:, i])
                preds.append(self.refine_net(inp, flow[:, i], train)[..., :3])
            y_pred = torch.stack(preds, dim=1)

        if train:
            return output, y_pred, mu, logvar, flow, flowback, mask_fw, mask_bw
        return output, y_pred, flow, flowback, mask_fw, mask_bw

