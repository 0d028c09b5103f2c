"""Image-grid helpers for TensorBoard logging (a copy of the JAX package's
``utils/vis.py`` ``to01``, ``seg_to_rgb`` and ``make_grid``; reference
runners/InterTrainer.py:499-513 image grids, utils/net_utils.py:57-70 seg
visualization).  They take numpy arrays."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from deep_video_interpolation_extrapolation_tpu_torch.data.cityscapes import (
    vis_seg_ids,
)


def to01(img: np.ndarray) -> np.ndarray:
    """[-1,1] -> [0,1] clipped."""
    return np.clip((np.asarray(img, np.float32) + 1.0) / 2.0, 0.0, 1.0)


def seg_to_rgb(seg_logits_or_onehot: np.ndarray) -> np.ndarray:
    """(H,W,20) -> (H,W,3) float [0,1] color map."""
    ids = np.argmax(np.asarray(seg_logits_or_onehot), axis=-1)
    return vis_seg_ids(ids).astype(np.float32)


def make_grid(images: Sequence[np.ndarray], pad: int = 2,
              nrow: int = 0) -> np.ndarray:
    """Tile same-height HWC [0,1] images -> CHW for tensorboardX
    ``add_image``.  ``nrow`` > 0 wraps into a grid of nrow images per row
    (torchvision make_grid semantics, runners/InterGANTrainer.py:256)."""
    h = max(im.shape[0] for im in images)

    def prep(im):
        im = np.asarray(im, np.float32)
        if im.ndim == 2:
            im = np.stack([im] * 3, -1)
        if im.shape[0] != h:
            reps = max(1, h // im.shape[0])
            im = np.repeat(np.repeat(im, reps, 0), reps, 1)
        return im

    imgs = [prep(im) for im in images]
    # integer-rep upscaling can leave ragged cells (h % im_h != 0, or
    # mixed widths); zero-pad every cell to a uniform (h, wmax) so the
    # row/column concatenations never mismatch
    wmax = max(im.shape[1] for im in imgs)
    imgs = [
        im if im.shape[:2] == (h, wmax) else np.pad(
            im, ((0, h - im.shape[0]), (0, wmax - im.shape[1]), (0, 0)))
        for im in imgs
    ]
    if nrow <= 0:
        nrow = len(imgs)
    rows = []
    for r in range(0, len(imgs), nrow):
        chunk = imgs[r:r + nrow]
        while len(chunk) < nrow:  # pad the last row
            chunk.append(np.zeros_like(imgs[0]))
        parts = []
        for im in chunk:
            parts.append(im)
            parts.append(np.ones((h, pad, 3), np.float32))
        rows.append(np.concatenate(parts[:-1], axis=1))
        rows.append(np.ones((pad, rows[0].shape[1], 3), np.float32))
    grid = np.concatenate(rows[:-1], axis=0)
    return np.transpose(grid, (2, 0, 1))
