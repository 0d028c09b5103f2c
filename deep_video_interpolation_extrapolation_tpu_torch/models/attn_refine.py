"""Stage-3 attention refiner (counterpart of models/attn_refine.py):
``MSResAttnRefine`` (V1, attn_refine.py:74-199, reference
nets/refine_nets.py:138-399) at ``n_scales == 1`` without ``stage3_prop``,
the route of the CLI's stage-3 defaults.

Its window attention is ``ops/window_attn.window_attention``: the Hopper
kernel on a CUDA tensor at any feature size (the JAX guard
``pallas_corr.fits_vmem`` is a TPU VMEM budget, so at the 512x1024 serving
shape JAX takes its XLA composition, which has the same numerics); the
plain model (``use_kernels=False``) runs ``window_attention_plain``.

Layers carry the reference's state_dict names (``port_ms_res_attn_refine``,
tools/torch_port.py:145-193).  ``attn_fuse_layer`` keeps its parameters as
the reference module does, although at ``n_scales == 1`` no route calls it
(and the JAX module never creates them).  Every layer computes in
``dtype``; the parameters are f32 masters.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.models.blocks import (
    Conv,
    ConvT,
    ResnetBlock,
    conv_lrelu,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.window_attn import (
    window_attention,
    window_attention_plain,
)

_QUEUE = "ROADMAP.md queue 1 item 7"


def _seq(cin: int, couts: Sequence[int], stride: int = 1,
         dilations: Sequence[int] = (1, 1)) -> nn.Sequential:
    """ConvLReLU layers to ``couts``: the first of stride ``stride``, the
    i-th of dilation ``dilations[i]``."""
    mods = []
    for i, (cout, dil) in enumerate(zip(couts, dilations)):
        mods += conv_lrelu(cin, cout, stride if i == 0 else 1, dil)
        cin = cout
    return nn.Sequential(*mods)


class MSResAttnRefine(nn.Module):
    """``forward(coarse_img, coarse_seg, neighbors_img, neighbors_seg)``:
    (B,H,W,3), (B,H,W,20), (B,H,W,6), (B,H,W,40) -> ([rgb (B,H,W,3)],
    [flow (B,2,H/4,W/4,2)]), the flow's channels (dx, dy) per neighbour."""

    def __init__(self, n_scales: int = 1, stage3_prop: bool = False,
                 win_h: int = 5, win_w: int = 9,
                 dtype: torch.dtype = torch.bfloat16,
                 use_kernels: bool = True):
        super().__init__()
        if n_scales != 1 or stage3_prop:
            raise NotImplementedError(
                f"MSResAttnRefine at n_scales={n_scales}, stage3_prop="
                f"{stage3_prop} (prob-map reuse, align_corners=True resizes) "
                f"is not ported yet ({_QUEUE})")
        self.win = (win_h, win_w)
        self.dtype = dtype
        self.attention = window_attention if use_kernels else \
            window_attention_plain
        self.input_layer = _seq(23, (32, 64))
        self.attn_input_layer = _seq(64, (64, 64))
        self.attn_encoder_1 = _seq(64, (64, 64), stride=2)
        self.attn_encoder_2 = _seq(64, (128, 128), stride=2)
        self.attn_fuse_layer = _seq(128, (128, 128))
        self.attn_img_fuse_layer = _seq(256, (128, 128))
        self.img_input_layer = _seq(192, (64, 64))
        self.img_encoder_1 = _seq(64, (64, 64), stride=2)
        self.img_encoder_2 = _seq(64, (128, 128), stride=2)
        self.img_atrous_layer = _seq(128, (128,) * 4, dilations=(1, 2, 4, 8))
        self.img_fuse_layer = _seq(256, (128, 128))
        self.decoder_2 = nn.Sequential(ConvT(128, 64), nn.LeakyReLU(0.2),
                                       ResnetBlock(64))
        self.decoder_1 = nn.Sequential(ConvT(64, 64), nn.LeakyReLU(0.2),
                                       ResnetBlock(64))
        self.output_layer = nn.Sequential(*conv_lrelu(64, 64),
                                          *conv_lrelu(64, 32), Conv(32, 3, 3))

    def _attn_features(self, x: torch.Tensor) -> torch.Tensor:
        return self.attn_encoder_2(self.attn_encoder_1(self.attn_input_layer(x)))

    def forward(self, coarse_img: torch.Tensor, coarse_seg: torch.Tensor,
                neighbors_img: torch.Tensor, neighbors_seg: torch.Tensor
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        def comb(img, seg):
            return torch.cat([img.to(self.dtype), seg.to(self.dtype)], dim=-1)

        x_in = self.input_layer(comb(coarse_img, coarse_seg))
        f_in = self.input_layer(comb(neighbors_img[..., :3],
                                     neighbors_seg[..., :20]))
        b_in = self.input_layer(comb(neighbors_img[..., 3:6],
                                     neighbors_seg[..., 20:40]))
        x_e2, f_e2, b_e2 = map(self._attn_features, (x_in, f_in, b_in))
        # one attention over both neighbours' windows: keys and values are
        # the same features at n_scales == 1 (attn_refine.py:148,173-174)
        agg, flow4 = self.attention(x_e2, f_e2, b_e2, f_e2, b_e2, *self.win)
        flow = torch.stack([flow4[..., 0:2], flow4[..., 2:4]], dim=1)
        attn_fused = self.attn_img_fuse_layer(torch.cat([x_e2, agg], dim=-1))

        im = self.img_input_layer(torch.cat([x_in, f_in, b_in], dim=-1))
        im1 = self.img_encoder_1(im)
        atrous = self.img_atrous_layer(self.img_encoder_2(im1))
        fused = self.img_fuse_layer(torch.cat([atrous, attn_fused], dim=-1))
        d2 = self.decoder_2(fused)
        d1 = self.decoder_1(d2 + im1)
        return [self.output_layer(d1 + im)], [flow]
