"""Serving entry points of the port.

- ``forward(model, rgb, seg)``: the serving forward, counterpart of
  ``tools/export.forward_fn`` (export.py:37-56): eval mode, no gradient.
- ``rollout(model, img_list, seg_list, num_pred_step)``: the cycgen sliding
  window, counterpart of ``Runner._mini_test`` (runner.py:806-853) for
  ``num_pred_once == 1``: each step predicts from (img1, img2) and slides
  img1 <- img2, img2 <- pred; the predicted seg ids come back as one-hots.
  (Not ``export.rollout_fn``, whose window carries [pred, pred]; ROADMAP.md
  queue 3.)

Tensors are NHWC.  Seg ids travel as ``uint8`` (B, H, W) maps and expand to
one-hots on their own device (``core/seg.seg_oh``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.core.seg import seg_oh


def forward(model: nn.Module, rgb: torch.Tensor, seg: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rgb (B,H,W,6) in [-1, 1], seg (B,H,W,40) one-hot) ->
    (rgb_pred (B,H,W,3), seg_logits (B,H,W,20))."""
    with torch.inference_mode():
        out = model(rgb, seg)
    return out[0], out[1]


def rollout(model: nn.Module, img_list: Sequence[torch.Tensor],
            seg_list: Sequence[torch.Tensor], num_pred_step: int
            ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Sliding-window rollout from two frames.

    img_list: two (B,H,W,3) frames in [0, 1]; seg_list: two (B,H,W) uint8
    id maps.  Returns ``num_pred_step`` predicted frames in
    [0, 1] and their uint8 seg id maps."""
    img1, img2 = [im * 2.0 - 1.0 for im in img_list]
    seg1, seg2 = [seg_oh(s) for s in seg_list]
    pred_imgs, pred_ids = [], []
    for _ in range(num_pred_step):
        img, seg_logits = forward(model, torch.cat([img1, img2], dim=-1),
                                  torch.cat([seg1, seg2], dim=-1))
        pred = torch.clamp((img + 1.0) / 2.0, 0, 1)
        ids = torch.argmax(seg_logits, dim=-1).to(torch.uint8)
        pred_imgs.append(pred)
        pred_ids.append(ids)
        img1, img2 = img2, pred * 2.0 - 1.0
        seg1, seg2 = seg2, seg_oh(ids)
    return pred_imgs, pred_ids
