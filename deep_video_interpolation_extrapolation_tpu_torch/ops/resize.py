"""NHWC resize and pooling (counterpart of the JAX package's ops/resize.py).

``interpolate_bilinear`` keeps ``torch.nn.functional.interpolate``
semantics, which the JAX function reproduces: with ``align_corners=False``
half-pixel sample positions with an edge clamp, no antialiasing; with
``align_corners=True`` (the refiners' resizes and the per-scale ground
truth) the corner pixels of input and output aligned, computed as the JAX
``_resize_axis_align_corners`` computes it (resize.py:28-45): one axis at
a time, H then W, each a lerp of two gathered rows in x's dtype,
``x_lo * (1 - frac) + x_hi * frac``, rounded after every operation.
``interpolate_nearest`` is the JAX function of the same name
(resize.py:210-222).  ``avg_pool`` is the JAX ``avg_pool`` (resize.py:223-245)
with explicit paddings; ``max_pool`` the JAX ``max_pool`` with its defaults: VALID,
stride = window.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from deep_video_interpolation_extrapolation_tpu_torch.parallel import spatial


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> logical NCHW view (channels_last memory, no copy)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """Logical NCHW -> contiguous NHWC (free for a channels_last tensor)."""
    return x.permute(0, 2, 3, 1).contiguous()


def _resize_axis_align_corners(x: torch.Tensor, axis: int,
                               out_size: int) -> torch.Tensor:
    """1-D bilinear resize of ``x`` along ``axis`` with align_corners=True,
    in x's dtype (the JAX function of the same name)."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    idx = torch.arange(out_size, device=x.device)
    if out_size == 1:
        return x.index_select(axis, idx[:1] * 0)
    scale = (in_size - 1) / (out_size - 1)
    coords = idx.to(torch.float32) * scale
    lo = torch.clamp(torch.floor(coords).long(), 0, in_size - 1)
    hi = torch.clamp(lo + 1, 0, in_size - 1)
    shape = [1] * x.dim()
    shape[axis] = out_size
    frac = (coords - lo.to(torch.float32)).reshape(shape).to(x.dtype)
    return (x.index_select(axis, lo) * (1 - frac)
            + x.index_select(axis, hi) * frac)


def interpolate_bilinear(x: torch.Tensor,
                         size: Optional[Tuple[int, int]] = None,
                         scale_factor: Optional[float] = None,
                         align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of an NHWC tensor to ``size``, or by ``scale_factor``
    (the size is ``int(n * factor)``, as the JAX function computes it).
    Returns ``x`` itself when the size is unchanged.  On a band
    (``parallel/spatial.banded``) ``size`` is the band's, and the
    half-pixel resize reads the neighbouring bands' edge rows
    (``spatial.bilinear``); the align_corners=True resize of the refine
    stages is not ported there."""
    if x.dim() != 4:
        raise ValueError(f"expected an NHWC tensor, got shape {tuple(x.shape)}")
    if size is None:
        if scale_factor is None:
            raise ValueError("give size or scale_factor")
        size = (x.shape[1] * scale_factor, x.shape[2] * scale_factor)
    size = (int(size[0]), int(size[1]))
    if size == tuple(x.shape[1:3]):
        return x
    if spatial.current() is not None:
        if align_corners:
            raise NotImplementedError(
                "the align_corners=True resize on a band is not ported yet "
                "(ROADMAP.md queue 1, item 10)")
        return spatial.bilinear(x, size)
    if align_corners:
        return _resize_axis_align_corners(
            _resize_axis_align_corners(x, 1, size[0]), 2, size[1])
    out = F.interpolate(nchw(x), size=size, mode="bilinear",
                        align_corners=False)
    return nhwc(out).to(x.dtype)


def avg_pool(x: torch.Tensor, window: Tuple[int, int],
             padding: Sequence[Tuple[int, int]],
             count_include_pad: bool = True,
             stride: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """NHWC average pool at ``stride`` (default 1) with symmetric
    ``padding`` ((top, bottom), (left, right)), each at most half its
    window (torch's ``F.avg_pool2d``); ``count_include_pad=False`` divides
    each sum by the window's in-image pixels."""
    (pt, pb), (pl, pr) = padding
    if pt != pb or pl != pr:
        raise ValueError(f"symmetric paddings only, got {padding}")
    return nhwc(F.avg_pool2d(nchw(x), tuple(window), stride=tuple(stride),
                             padding=(pt, pl),
                             count_include_pad=count_include_pad))


def interpolate_nearest(x: torch.Tensor,
                        size: Optional[Tuple[int, int]] = None,
                        scale_factor: Optional[float] = None) -> torch.Tensor:
    """Nearest-neighbour resize of an NHWC tensor to ``size``, or by
    ``scale_factor`` (the size ``int(n * factor)``), as the JAX function's
    ``jax.image.resize(method="nearest")``: output pixel i reads input
    pixel floor((i + 0.5) * in / out), torch's ``nearest-exact``."""
    if x.dim() != 4:
        raise ValueError(f"expected an NHWC tensor, got shape {tuple(x.shape)}")
    if size is None:
        size = (int(x.shape[1] * scale_factor), int(x.shape[2] * scale_factor))
    return nhwc(F.interpolate(nchw(x), size=tuple(size),
                              mode="nearest-exact")).to(x.dtype)


def max_pool(x: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """NHWC max pool, VALID, stride = window."""
    return nhwc(F.max_pool2d(nchw(x), kernel_size=tuple(window),
                             stride=tuple(window)))
