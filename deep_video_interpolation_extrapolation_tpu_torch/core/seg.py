"""Segmentation-id contract shared by serving and training.

Seg maps travel as integer (B, H, W) class ids (the uint8-id contract: 80x
fewer bytes than the one-hot cross the host boundary) and expand to one-hots
on their own device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

N_CLASSES = 20


def seg_oh(ids: torch.Tensor) -> torch.Tensor:
    """Integer (B,H,W) class ids -> f32 (B,H,W,20) one-hot on the ids'
    device."""
    return F.one_hot(ids.long(), N_CLASSES).to(torch.float32)
