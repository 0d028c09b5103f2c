"""SRN-style multi-scale refinement network (counterpart of
models/refine.py, reference nets/refine_nets.py:27-135).

The scales run coarsest first.  At each scale the rgb and the other
inputs are downscaled bilinearly with align_corners=True, the previous
scale's prediction (detached) and the hidden state are upsampled x2, and
one core, shared by every scale, maps them to this scale's prediction and
hidden state.

The layers of the JAX ``_SRNCore`` are the reference's ``nn.Sequential``s
here, so the state_dict keys are the reference's (``port_srn_refine``,
tools/torch_port.py:95-142, maps the same names).  Every layer computes in
``dtype``; the parameters are f32 masters.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.models.blocks import (
    Conv,
    ConvT,
    ResnetBlock,
    conv_lrelu,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.resize import (
    interpolate_bilinear,
)

IN_CHANNELS = 3 + 3 + 20 + 14   # rgb, previous prediction, seg, encoded feat


def _res(features: int, n: int = 3) -> List[nn.Module]:
    return [ResnetBlock(features) for _ in range(n)]


class SRNRefine(nn.Module):
    """``forward(input_rgb, input_seg, encoded_feat)``: (B,H,W,3),
    (B,H,W,20), (B,H,W,14) -> the list of ``n_scales`` predictions,
    coarsest first, the last at (B,H,W,3), in ``dtype``."""

    def __init__(self, n_scales: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.n_scales = n_scales
        self.dtype = dtype
        self.input_layer = nn.Sequential(
            *conv_lrelu(IN_CHANNELS, 32), *conv_lrelu(32, 32),
            *conv_lrelu(32, 64), *_res(64))
        self.encoder_1 = nn.Sequential(*conv_lrelu(64, 128, stride=2),
                                       *_res(128))
        self.encoder_2 = nn.Sequential(*conv_lrelu(128, 256, stride=2),
                                       *_res(256))
        self.bottle_dilated = nn.Sequential(
            *(m for rate in (1, 2, 4, 8)
              for m in conv_lrelu(256, 256, dilation=rate)))
        self.hidden_comb = nn.Sequential(*conv_lrelu(512, 256),
                                         *conv_lrelu(256, 256))
        self.decoder_2 = nn.Sequential(*_res(256), ConvT(256, 128),
                                       nn.LeakyReLU(0.2))
        self.decoder_1 = nn.Sequential(*_res(128), ConvT(128, 64),
                                       nn.LeakyReLU(0.2))
        self.output_layer = nn.Sequential(*_res(64), *conv_lrelu(64, 32),
                                          Conv(32, 3, 3))

    def _core(self, x: torch.Tensor, hidden: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One scale pass (``_SRNCore``, refine.py:30-75): (prediction,
        hidden state).  The coarsest scale, with no hidden state yet,
        feeds its own bottleneck as one."""
        in_out = self.input_layer(x)
        e1 = self.encoder_1(in_out)
        e2 = self.encoder_2(e1)
        b = self.bottle_dilated(e2)
        hc = self.hidden_comb(torch.cat([b, b if hidden is None else hidden],
                                        dim=-1))
        d1 = self.decoder_2(hc + e2) + e1
        o = self.decoder_1(d1) + in_out
        return self.output_layer(o), hc

    def forward(self, input_rgb: torch.Tensor, input_seg: torch.Tensor,
                encoded_feat: torch.Tensor) -> List[torch.Tensor]:
        # the seg and the encoded features are resized together, in their
        # promoted dtype, as the JAX module concatenates them first
        dt = torch.promote_types(input_seg.dtype, encoded_feat.dtype)
        others = torch.cat([input_seg.to(dt), encoded_feat.to(dt)], dim=-1)
        preds: List[torch.Tensor] = []
        hidden = None
        for scale_idx in range(self.n_scales - 1, -1, -1):
            scale = 1.0 / (2 ** scale_idx)

            def down(t):
                return t if scale == 1.0 else interpolate_bilinear(
                    t, scale_factor=scale, align_corners=True)

            ori = down(input_rgb)
            # the first scale feeds its rgb as the previous prediction
            pred_in = ori if not preds else interpolate_bilinear(
                preds[-1].detach(), scale_factor=2.0, align_corners=True)
            x = torch.cat([t.to(self.dtype) for t in (ori, pred_in,
                                                      down(others))], dim=-1)
            if hidden is not None:
                hidden = interpolate_bilinear(hidden, scale_factor=2.0,
                                              align_corners=True)
            pred, hidden = self._core(x, hidden)
            preds.append(pred)
        return preds
