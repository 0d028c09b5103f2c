"""Serving entry points of the port.

- ``forward(model, rgb, seg)``: the serving forward, counterpart of
  ``tools/export.forward_fn`` (export.py:37-56): eval mode, no gradient;
  it returns the composite's final stage (``final_output``).
- ``rollout(model, img_list, seg_list, num_pred_step, num_pred_once=1,
  fix_init_frames=False)``: the cycgen sliding window, counterpart of
  ``Runner._mini_test`` (runner.py:806-853): each step predicts from
  (img1, img2) and, at ``num_pred_once == 1``, slides img1 <- img2, img2 <-
  pred; at more, both slots take the two newest predictions; the predicted
  seg ids come back as one-hots.  ``fix_init_frames`` puts the second
  input frame before every step's window (extrapolation's
  ``--fix_init_frames``).  (Not ``export.rollout_fn``, whose window carries
  [pred, pred]; ROADMAP.md queue 3.)  ``rollout_with(fwd, ...)`` is the
  same window on a forward function (the runner's ``_forward``).
- ``predict_video(model, rgb_seq, seg_seq, bg_mask, fg_mask, ...)``: the
  serving forward of the video VAEs (``--model VAE|VAE_S|VAE_SD``): eval
  mode, no gradient, the motion code drawn from ``generator`` unless
  ``z_m`` is given; returns the eval tuple (output, y_pred, flow,
  flowback, mask_fw, mask_bw).

Tensors are NHWC.  Seg ids travel as ``uint8`` (B, H, W) maps and expand to
one-hots on their own device (``core/seg.seg_oh``).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.core.seg import (
    N_CLASSES,
    seg_oh,
)


def final_output(out: Sequence) -> Tuple[torch.Tensor, torch.Tensor]:
    """The final (rgb, seg) of a composite's output, the stage that is
    rolled out (``Runner._final_output``, runner.py:785-804): the last
    stage-3 frame of InterStage3Net's 5-tuple, the inpainted frames of
    ExtraInpaintNet's 4-tuple, the last refined frame of InterRefineNet's
    3-tuple, else the coarse pair."""
    if len(out) == 5:
        return out[3][-1], out[1]
    if len(out) == 4:
        return out[3], out[1]
    if len(out) == 3 and isinstance(out[2], (list, tuple)):
        return out[2][-1], out[1]
    return out[0], out[1]


def forward(model: nn.Module, rgb: torch.Tensor, seg: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rgb (B,H,W,6) in [-1, 1], seg (B,H,W,40) one-hot) ->
    (rgb_pred (B,H,W,3), seg_logits (B,H,W,20))."""
    with torch.inference_mode():
        return final_output(model(rgb, seg))


def rollout(model: nn.Module, img_list: Sequence[torch.Tensor],
            seg_list: Sequence[torch.Tensor], num_pred_step: int,
            num_pred_once: int = 1, fix_init_frames: bool = False
            ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Sliding-window rollout from two frames.

    img_list: two (B,H,W,3) frames in [0, 1]; seg_list: two (B,H,W) uint8
    id maps.  Returns ``num_pred_step * num_pred_once`` predicted frames in
    [0, 1] and their uint8 seg id maps."""
    return rollout_with(lambda x, seg: forward(model, x, seg), img_list,
                        seg_list, num_pred_step, num_pred_once,
                        fix_init_frames)


def rollout_with(fwd: Callable, img_list: Sequence[torch.Tensor],
                 seg_list: Sequence[torch.Tensor], num_pred_step: int,
                 num_pred_once: int = 1, fix_init_frames: bool = False
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """``rollout`` on ``fwd(rgb, seg) -> (rgb_pred, seg_logits)``, the
    serving forward of the model (the runner's, which may wrap it)."""
    img1, img2 = [im * 2.0 - 1.0 for im in img_list]
    seg1, seg2 = [seg_oh(s) for s in seg_list]
    init_img2, init_seg2 = img2, seg2
    pred_imgs, pred_ids = [], []
    for _ in range(num_pred_step):
        x, seg = (torch.cat([img1, img2], dim=-1),
                  torch.cat([seg1, seg2], dim=-1))
        if fix_init_frames:
            x = torch.cat([init_img2, x], dim=-1)
            seg = torch.cat([init_seg2, seg], dim=-1)
        img, seg_logits = fwd(x, seg)
        for j in range(num_pred_once):
            pred_imgs.append(torch.clamp(
                (img[..., 3 * j:3 * j + 3] + 1.0) / 2.0, 0, 1))
            pred_ids.append(torch.argmax(
                seg_logits[..., N_CLASSES * j:N_CLASSES * (j + 1)],
                dim=-1).to(torch.uint8))
        if num_pred_once == 1:
            img1, img2 = img2, pred_imgs[-1] * 2.0 - 1.0
            seg1, seg2 = seg2, seg_oh(pred_ids[-1])
        else:
            img1, img2 = pred_imgs[-2] * 2.0 - 1.0, pred_imgs[-1] * 2.0 - 1.0
            seg1, seg2 = seg_oh(pred_ids[-2]), seg_oh(pred_ids[-1])
    return pred_imgs, pred_ids


def predict_video(model: nn.Module, rgb_seq: torch.Tensor,
                  seg_seq: torch.Tensor, bg_mask: torch.Tensor,
                  fg_mask: torch.Tensor, noise_bg=None, z_m=None,
                  generator=None) -> Tuple[torch.Tensor, ...]:
    """rgb_seq (B,T+1,H,W,3) in [0, 1], seg_seq (B,T+1,H,W,20) one-hot,
    masks (B,T+1,H,W,1) -> ``vid_length`` predicted frames and their
    flows and masks (``models/vae_video.VideoVAE``, eval)."""
    with torch.inference_mode():
        return model(rgb_seq, seg_seq, bg_mask, fg_mask, noise_bg, z_m,
                     train=False, generator=generator)
