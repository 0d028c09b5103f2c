"""Composite model heads (counterpart of models/composite.py).

Only ``InterNet`` is ported so far; the other composites wait in ROADMAP.md
queue 1.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.models import registry


class InterNet(nn.Module):
    """Coarse-only interpolation (composite.py:28-42):
    ``(rgb, seg) -> (rgb_out, seg_out)``, differentiable."""

    def __init__(self, cfg: Config, use_kernels: bool = True):
        super().__init__()
        self.coarse_model = registry.build_coarse(cfg, use_kernels)

    def forward(self, rgb: torch.Tensor, seg: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        out = self.coarse_model(rgb, seg)
        return out[0], out[1]
