"""Image-grid helpers for TensorBoard logging (a copy of the JAX package's
``utils/vis.py`` ``to01``, ``seg_to_rgb``, ``make_grid``, ``draw_bbox``
and ``prob_heatmap``; reference
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


def draw_bbox(img01: np.ndarray, boxes: np.ndarray, width: int = 2
              ) -> np.ndarray:
    """Per-track coloured rectangles (InterGANTrainer.py:189-210).

    img01 (H,W,3) float [0,1]; boxes (N,4) rows (y1, x1, y2, x2) in pixel
    coordinates.  Colours cycle the reference's BGR list converted to RGB
    [0,1]; lines ``width`` pixels wide, in numpy."""
    colors = np.asarray([
        (240, 32, 32), (53, 32, 240), (32, 240, 74),
        (240, 157, 32), (19, 55, 80), (156, 161, 157),
    ], np.float32) / 255.0
    out = np.array(img01, np.float32, copy=True)
    h, w = out.shape[:2]
    for i, box in enumerate(np.asarray(boxes)):
        y1, x1, y2, x2 = [int(v) for v in box]
        y1, y2 = sorted((max(0, min(y1, h - 1)), max(0, min(y2, h - 1))))
        x1, x2 = sorted((max(0, min(x1, w - 1)), max(0, min(x2, w - 1))))
        c = colors[i % len(colors)]
        t = width
        out[y1:y1 + t, x1:x2 + 1] = c
        out[max(y2 - t + 1, 0):y2 + 1, x1:x2 + 1] = c
        out[y1:y2 + 1, x1:x1 + t] = c
        out[y1:y2 + 1, max(x2 - t + 1, 0):x2 + 1] = c
    return out


def prob_heatmap(p: np.ndarray) -> np.ndarray:
    """A discriminator's probability map -> RGB heatmap
    (InterGANTrainer.py:168-179): ratio = 2p; R = 1 - ratio, G = ratio - 1
    (clamped), B = 1 - R - G."""
    p = np.asarray(p, np.float32)
    if p.ndim == 3:
        p = p[..., 0]
    ratio = 2.0 * np.clip(p, 0.0, 1.0)
    r = np.clip(1.0 - ratio, 0.0, 1.0)
    g = np.clip(ratio - 1.0, 0.0, 1.0)
    b = 1.0 - r - g
    return np.stack([r, g, b], axis=-1)
