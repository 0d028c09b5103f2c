"""Optical-flow -> color-image visualization (Middlebury color wheel); a
copy of the JAX package's ``utils/flow_vis.py``.

Reference: utils/net_utils.py:149-339 carries two copies of the classic
Middlebury flow-visualization code (make_color_wheel/compute_color/
flow_to_image).  This is the standard public algorithm (Baker et al.,
"A Database and Evaluation Methodology for Optical Flow"), re-implemented
vectorized over the whole field (the reference loops per color-wheel bin).
"""

from __future__ import annotations

import numpy as np

_UNKNOWN_THRESH = 1e7


def make_color_wheel() -> np.ndarray:
    """(55, 3) RGB color wheel: RY/YG/GC/CB/BM/MR segments."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    ncols = ry + yg + gc + cb + bm + mr
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:ry, 0] = 255
    wheel[0:ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    wheel[col:col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col:col + yg, 1] = 255
    col += yg
    wheel[col:col + gc, 1] = 255
    wheel[col:col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    wheel[col:col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col:col + cb, 2] = 255
    col += cb
    wheel[col:col + bm, 2] = 255
    wheel[col:col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    wheel[col:col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col:col + mr, 0] = 255
    return wheel


_WHEEL = make_color_wheel()


def compute_color(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(H, W) flow components (already normalized) -> (H, W, 3) uint8."""
    nan_mask = np.isnan(u) | np.isnan(v)
    u = np.where(nan_mask, 0.0, u)
    v = np.where(nan_mask, 0.0, v)

    ncols = _WHEEL.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = (fk - k0)[..., None]
    col0 = _WHEEL[k0] / 255.0
    col1 = _WHEEL[k1] / 255.0
    col = (1 - f) * col0 + f * col1
    small = rad[..., None] <= 1
    col = np.where(small, 1 - rad[..., None] * (1 - col), col * 0.75)
    col = np.where(nan_mask[..., None], 0.0, col)
    return np.floor(255 * col).astype(np.uint8)


def flow_to_image(flow: np.ndarray, max_flow: float | None = None) -> np.ndarray:
    """(H, W, 2) flow in pixels -> (H, W, 3) uint8 visualization."""
    u = flow[..., 0].astype(np.float64)
    v = flow[..., 1].astype(np.float64)
    bad = (np.abs(u) > _UNKNOWN_THRESH) | (np.abs(v) > _UNKNOWN_THRESH)
    u = np.where(bad, 0, u)
    v = np.where(bad, 0, v)
    rad = np.sqrt(u ** 2 + v ** 2)
    maxrad = max_flow if max_flow is not None else max(float(rad.max()), 1e-8)
    img = compute_color(u / maxrad, v / maxrad)
    return np.where(bad[..., None], 0, img)
