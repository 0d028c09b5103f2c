"""Flow backward warp: the bilinear ``grid_sample`` of the reference, NHWC.

Counterpart of the JAX package's ``ops/warp.py``: a base grid of normalized
(x, y) coordinates in [-1, 1] with ``linspace`` spacing, the flow
*subtracted* (``grid = base - flow``), and the frame sampled bilinearly
with torch-1.x ``F.grid_sample`` semantics (align_corners=True, zero or
border padding).

``grid_sample`` runs on the hand-written kernel ``csrc/grid_sample.cu`` for
a CUDA tensor and on ``grid_sample_plain`` for a CPU one, in two modes: the
JAX ``grid_sample`` (unbounded; XLA code in the JAX package) and, with
``max_disp = R``, the function of the TPU kernel
``pallas_warp.grid_sample_pallas``: a corner at (y, x) counts for output
pixel (i, j) only if y - i and x - j lie in [-R, R+1], so samples farther
than R pixels give 0.  Both sum in f32 and round once to x's dtype, as the
Pallas kernel does.  ``backward_warp`` takes the bounded mode for
``use_pallas=True`` (the TPU kernel's own function) and the unbounded one
by default.  Neither mode has a backward on the card: the JAX kernel has
none, and VideoVAE training is not ported (ROADMAP.md queue 1 item 8), so
the wrapper raises for CUDA inputs that require grad; the plain version is
differentiable.  ``grid_sample_border`` (border padding) stays plain, as
the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.ops import _build

NAME = "grid_sample"
NAME_BOUNDED = "grid_sample_bounded"     # the same kernel with max_disp set


def make_base_grid(h: int, w: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """(H, W, 2) grid of normalized (x, y) in [-1, 1], linspace spacing:
    channel 0 is x along W, channel 1 is y along H."""
    xs = torch.linspace(-1.0, 1.0, w, dtype=dtype, device=device)
    ys = torch.linspace(-1.0, 1.0, h, dtype=dtype, device=device)
    return torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)],
                       dim=-1)


def _pixel_coords(grid: torch.Tensor, h: int, w: int):
    """Normalized grid -> f32 pixel coordinates (fx, fy), align_corners."""
    fx = (grid[..., 0].float() + 1.0) * 0.5 * (w - 1)
    fy = (grid[..., 1].float() + 1.0) * 0.5 * (h - 1)
    return fx, fy


def grid_sample_plain(x: torch.Tensor, grid: torch.Tensor,
                      max_disp: Optional[int] = None) -> torch.Tensor:
    """Bilinear sample of NHWC ``x`` (B,H,W,C) at the normalized ``grid``
    (B,H,W,2), zero padding, f32 sums, in x's dtype; with ``max_disp`` the
    corners outside the window of the TPU kernel count as zero."""
    b, h, w, c = x.shape
    fx, fy = _pixel_coords(grid, h, w)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = (fx - x0)[..., None], (fy - y0)[..., None]
    flat = x.float().reshape(b, h * w, c)
    rows = torch.arange(h, device=x.device, dtype=torch.float32)[:, None]
    cols = torch.arange(w, device=x.device, dtype=torch.float32)[None, :]

    def counts(v, n, p):
        ok = (v >= 0) & (v <= n - 1)
        if max_disp is not None:
            ok &= (v - p >= -max_disp) & (v - p <= max_disp + 1)
        return ok

    def corner(yv, xv):
        ok = counts(yv, h, rows) & counts(xv, w, cols)
        idx = torch.where(ok, yv * w + xv, 0).long()    # in range where ok
        v = torch.gather(flat, 1, idx.reshape(b, -1, 1).expand(-1, -1, c))
        return v.reshape(b, h, w, c) * ok[..., None]

    top = corner(y0, x0) * (1 - tx) + corner(y0, x0 + 1) * tx
    bot = corner(y0 + 1, x0) * (1 - tx) + corner(y0 + 1, x0 + 1) * tx
    return (top * (1 - ty) + bot * ty).to(x.dtype)


def _kernel(x: torch.Tensor, grid: torch.Tensor,
            max_disp: Optional[int]) -> torch.Tensor:
    b, h, w, c = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"kernel takes bf16 or f32 x, got {x.dtype}")
    if tuple(grid.shape) != (b, h, w, 2):
        raise ValueError(f"grid {tuple(grid.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError("kernel takes a non-empty x")
    if max_disp is not None and max_disp < 0:
        raise ValueError(f"max_disp must be >= 0, got {max_disp}")
    x = x.contiguous()                  # a frame sliced from a sequence
    gk = grid.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    err = _build.library().dvie_grid_sample(
        _build.ptr(x), _build.ptr(gk), _build.ptr(out), b, h, w, c,
        -1 if max_disp is None else max_disp, int(x.dtype == torch.bfloat16),
        _build.stream(x))
    _build.check_launch(NAME, err)
    hw.launches[NAME if max_disp is None else NAME_BOUNDED] += 1
    return out


def grid_sample(x: torch.Tensor, grid: torch.Tensor,
                max_disp: Optional[int] = None) -> torch.Tensor:
    """The sample on a CUDA tensor through the Hopper kernel; on a CPU
    tensor through ``grid_sample_plain``.  Same arguments; unbounded
    unless ``max_disp`` is given."""
    if not hw.use_kernel(x):
        return grid_sample_plain(x, grid, max_disp)
    if torch.is_grad_enabled() and (x.requires_grad or grid.requires_grad):
        raise NotImplementedError(
            "grid_sample has no backward on the card: VideoVAE training is "
            "not ported yet (ROADMAP.md queue 1 item 8)")
    return _kernel(x, grid, max_disp)


def grid_sample_border(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample with border (clamp) padding, torch
    ``F.grid_sample(padding_mode='border')``; the JAX function's
    arithmetic: coordinates in f32, weights and sums in x's dtype."""
    b, h, w, c = x.shape
    fx, fy = _pixel_coords(grid, h, w)
    fx, fy = fx.clamp(0, w - 1), fy.clamp(0, h - 1)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx = (fx - x0)[..., None].to(x.dtype)
    ty = (fy - y0)[..., None].to(x.dtype)
    x0i, y0i = x0.long().clamp(0, w - 1), y0.long().clamp(0, h - 1)
    x1i, y1i = (x0i + 1).clamp(0, w - 1), (y0i + 1).clamp(0, h - 1)
    flat = x.reshape(b, h * w, c)

    def gather(yi, xi):
        idx = (yi * w + xi).reshape(b, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(b, h, w, c)

    top = gather(y0i, x0i) * (1 - tx) + gather(y0i, x1i) * tx
    bot = gather(y1i, x0i) * (1 - tx) + gather(y1i, x1i) * tx
    return top * (1 - ty) + bot * ty


def backward_warp(x: torch.Tensor, flow: torch.Tensor,
                  use_pallas: Optional[bool] = None, max_disp: int = 8,
                  use_kernels: bool = True) -> torch.Tensor:
    """Warp NHWC ``x`` backward by ``flow`` (B,H,W,2, normalized units):
    ``out(p) = x(base(p) - flow(p))``.  ``use_pallas=True`` takes the
    bounded mode (exact within ``max_disp`` pixels, 0 beyond); the default
    is unbounded.  ``use_kernels=False`` takes the plain version on any
    device."""
    b, h, w, _ = x.shape
    grid = make_base_grid(h, w, device=x.device)[None] - flow.float()
    sample = grid_sample if use_kernels else grid_sample_plain
    return sample(x, grid, max_disp if use_pallas else None)


def flow_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """``backward_warp`` with its defaults (the reference's ``warp``)."""
    return backward_warp(x, flow)
