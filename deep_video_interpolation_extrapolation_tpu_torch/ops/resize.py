"""NHWC resize and pooling (counterpart of the JAX package's ops/resize.py).

``interpolate_bilinear`` keeps ``torch.nn.functional.interpolate``
semantics with ``align_corners=False`` (the only mode the ported slices
use), which the JAX function reproduces: half-pixel sample positions with
an edge clamp, no antialiasing.  ``max_pool`` is the JAX ``max_pool`` with
its defaults: VALID, stride = window.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> logical NCHW view (channels_last memory, no copy)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """Logical NCHW -> contiguous NHWC (free for a channels_last tensor)."""
    return x.permute(0, 2, 3, 1).contiguous()


def interpolate_bilinear(x: torch.Tensor,
                         size: Optional[Tuple[int, int]] = None,
                         scale_factor: Optional[float] = None) -> torch.Tensor:
    """Bilinear resize of an NHWC tensor to ``size``, or by ``scale_factor``
    (the size is ``int(n * factor)``, as the JAX function computes it),
    align_corners=False: half-pixel sample positions, edge clamp.  Returns
    ``x`` itself when the size is unchanged."""
    if x.dim() != 4:
        raise ValueError(f"expected an NHWC tensor, got shape {tuple(x.shape)}")
    if size is None:
        if scale_factor is None:
            raise ValueError("give size or scale_factor")
        size = (x.shape[1] * scale_factor, x.shape[2] * scale_factor)
    size = (int(size[0]), int(size[1]))
    if size == tuple(x.shape[1:3]):
        return x
    out = F.interpolate(nchw(x), size=size, mode="bilinear",
                        align_corners=False)
    return nhwc(out).to(x.dtype)


def max_pool(x: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """NHWC max pool, VALID, stride = window."""
    return nhwc(F.max_pool2d(nchw(x), kernel_size=tuple(window),
                             stride=tuple(window)))
