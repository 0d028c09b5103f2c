"""Segmentation-id contract shared by serving and training.

Seg maps travel as integer (B, H, W) class ids (the uint8-id contract: 80x
fewer bytes than the one-hot cross the host boundary) and expand to one-hots
on their own device.  A frame that has no segmentation (the vimeo and ucf101
triplets) carries the reserved id ``NO_SEG``, which expands to an all-zero
row: the JAX package's dummy one-hot (JAX ``data/folder.py:394-405``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deep_video_interpolation_extrapolation_tpu_torch.data.cityscapes import (
    N_CLASSES,
    NO_SEG,
)


def seg_oh(ids: torch.Tensor) -> torch.Tensor:
    """Integer (B,H,W) class ids -> f32 (B,H,W,20) one-hot on the ids'
    device; ``NO_SEG`` gives a row of zeros, any other id >= 20 raises as
    ``F.one_hot`` does."""
    ids = ids.long()
    none = ids == NO_SEG
    oh = F.one_hot(ids.masked_fill(none, 0), N_CLASSES).to(torch.float32)
    return oh.masked_fill_(none.unsqueeze(-1), 0.0)


def oh_ids(ids: torch.Tensor) -> torch.Tensor:
    """The ids of ``seg_oh(ids).argmax(-1)``: ``NO_SEG`` becomes class 0, as
    the argmax of the JAX package's all-zero one-hot does (its cycgen trees,
    image panels and the targets of a seg loss on such frames)."""
    return ids.masked_fill(ids == NO_SEG, 0)
