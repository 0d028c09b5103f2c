"""SRN-style refinement network (counterpart of models/refine.py, reference
nets/refine_nets.py:27-135), at ``n_scales == 1``.

The layers of the JAX ``_SRNCore`` are the reference's ``nn.Sequential``s
here, so the state_dict keys are the reference's (``port_srn_refine``,
tools/torch_port.py:95-142, maps the same names).  Every layer computes in
``dtype``; the parameters are f32 masters.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.models.blocks import (
    Conv,
    ConvT,
    ResnetBlock,
    conv_lrelu,
)

IN_CHANNELS = 3 + 3 + 20 + 14   # rgb, previous prediction, seg, encoded feat


def _res(features: int, n: int = 3) -> List[nn.Module]:
    return [ResnetBlock(features) for _ in range(n)]


class SRNRefine(nn.Module):
    """``forward(input_rgb, input_seg, encoded_feat)``: (B,H,W,3),
    (B,H,W,20), (B,H,W,14) -> the list of per-scale predictions (one at
    ``n_scales == 1``), (B,H,W,3) in ``dtype``."""

    def __init__(self, n_scales: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if n_scales != 1:
            raise NotImplementedError(
                f"SRNRefine at n_scales={n_scales} (align_corners=True "
                "resizes) is not ported yet (ROADMAP.md queue 1 item 7)")
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

    def _core(self, x: torch.Tensor) -> torch.Tensor:
        """One scale pass (``_SRNCore``, refine.py:30-75) with no previous
        hidden state, which the single scale feeds as its own bottleneck."""
        in_out = self.input_layer(x)
        e1 = self.encoder_1(in_out)
        e2 = self.encoder_2(e1)
        b = self.bottle_dilated(e2)
        hc = self.hidden_comb(torch.cat([b, b], dim=-1))
        d1 = self.decoder_2(hc + e2) + e1
        o = self.decoder_1(d1) + in_out
        return self.output_layer(o)

    def forward(self, input_rgb: torch.Tensor, input_seg: torch.Tensor,
                encoded_feat: torch.Tensor) -> List[torch.Tensor]:
        # the first (and only) scale feeds the input rgb as the previous
        # prediction (refine.py:100-118)
        parts = (input_rgb, input_rgb, input_seg, encoded_feat)
        x = torch.cat([t.to(self.dtype) for t in parts], dim=-1)
        return [self._core(x)]
