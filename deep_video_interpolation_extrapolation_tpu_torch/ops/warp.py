"""Flow backward warp: the bilinear ``grid_sample`` of the reference, NHWC.

Counterpart of the JAX package's ``ops/warp.py``: a base grid of normalized
(x, y) coordinates in [-1, 1] with ``linspace`` spacing, the flow
*subtracted* (``grid = base - flow``), and the frame sampled bilinearly
with torch-1.x ``F.grid_sample`` semantics (align_corners=True, zero or
border padding).

Two entries run on the hand-written kernel ``csrc/grid_sample.cu`` for a
CUDA tensor and on their plain versions for a CPU one, each in two modes:
the JAX ``grid_sample`` (unbounded; XLA code in the JAX package) and, with
``max_disp = R``, the function of the TPU kernel
``pallas_warp.grid_sample_pallas``: a corner at (y, x) counts for output
pixel (i, j) only if y - i and x - j lie in [-R, R+1], so samples farther
than R pixels give 0.  Both sum in f32 and round once to x's dtype, as the
Pallas kernel does.
- ``grid_sample(x, grid, max_disp)`` samples at a normalized grid.
- ``warp_steps(x, flow, mask, max_disp)``, the flow entry, warps one frame
  by T steps of flow (times an optional mask) in one launch:
  ``stack_t backward_warp(x, flow[:, t] * mask[:, t])``, the product
  rounded to the flow's dtype as the model's own product is, the base grid
  from linspaces kept once per shape and device (``base_vectors``).  No
  grid is written.  ``backward_warp`` takes it with T = 1 on the card.
``backward_warp`` takes the bounded mode for ``use_pallas=True`` (the TPU
kernel's own function) and the unbounded one by default.  The flow entry
in the unbounded mode has a backward on the card with respect to flow and
mask, the kernel's second entry ``dvie_warp_steps_bwd`` (counter
``grid_sample_bwd``), through ``_WarpSteps``: the VideoVAE trains on it
(``train/legacy.make_vae_train_step``).  Every path that trains through a
warp warps data (frame1, the ground-truth frames), so the kernel gives no
gradient for x: the wrappers raise, before any launch, for a CUDA x that
requires grad, for the bounded mode with a gradient and for the grid entry
with a gradient (no path reaches them; ROADMAP.md section 3).  The plain
versions are differentiable everywhere and are the CPU route.
``grid_sample_border`` (border padding) stays plain, as the JAX package
leaves it to XLA.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.ops import _build

NAME = "grid_sample"
NAME_BOUNDED = "grid_sample_bounded"     # the same kernel with max_disp set
NAME_BWD = "grid_sample_bwd"             # the flow entry's backward


def make_base_grid(h: int, w: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """(H, W, 2) grid of normalized (x, y) in [-1, 1], linspace spacing:
    channel 0 is x along W, channel 1 is y along H."""
    xs = torch.linspace(-1.0, 1.0, w, dtype=dtype, device=device)
    ys = torch.linspace(-1.0, 1.0, h, dtype=dtype, device=device)
    return torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)],
                       dim=-1)


@functools.lru_cache(maxsize=64)
def base_vectors(h: int, w: int, device) -> tuple:
    """(xs, ys): the f32 linspaces of ``make_base_grid(h, w)`` on
    ``device``, made once per shape and device (the flow entry's base
    grid; no later call launches anything for it)."""
    with torch.inference_mode(False):
        grid = make_base_grid(h, w, device=device)
        return grid[0, :, 0].contiguous(), grid[:, 0, 1].contiguous()


def _pixel(g: torch.Tensor, n: int) -> torch.Tensor:
    """Normalized coordinate -> f32 pixel coordinate, align_corners."""
    return (g.float() + 1.0) * 0.5 * (n - 1)


def _pixel_coords(grid: torch.Tensor, h: int, w: int):
    """Normalized grid -> f32 pixel coordinates (fx, fy), align_corners."""
    return _pixel(grid[..., 0], w), _pixel(grid[..., 1], h)


def flow_coords(flow: torch.Tensor, mask: Optional[torch.Tensor], h: int,
                w: int):
    """The flow entry's coordinates, as its kernel forms them: f = flow *
    mask in f32, rounded to the flow's dtype (the model's own product),
    then g = base - f with the base of ``base_vectors``, then (fx, fy).
    ``flow`` (..., H, W, 2), ``mask`` (..., H, W, 1) or None."""
    f = flow if mask is None else (flow.float() * mask.float()).to(flow.dtype)
    xs, ys = base_vectors(h, w, flow.device)
    return (_pixel(xs - f[..., 0].float(), w),
            _pixel(ys[:, None] - f[..., 1].float(), h))


def grid_sample_plain(x: torch.Tensor, grid: torch.Tensor,
                      max_disp: Optional[int] = None) -> torch.Tensor:
    """Bilinear sample of NHWC ``x`` (B,H,W,C) at the normalized ``grid``
    (B,H,W,2), zero padding, f32 sums, in x's dtype; with ``max_disp`` the
    corners outside the window of the TPU kernel count as zero."""
    b, h, w, c = x.shape
    return _sample(x, *_pixel_coords(grid, h, w), max_disp)


def warp_steps_plain(x: torch.Tensor, flow: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     max_disp: Optional[int] = None) -> torch.Tensor:
    """``x`` (B,H,W,C) warped by each step of ``flow`` (B,T,H,W,2) times
    ``mask`` (B,T,H,W,1) if given: (B,T,H,W,C), the coordinates of
    ``flow_coords`` and the sample of ``grid_sample_plain``."""
    b, h, w, c = x.shape
    return torch.stack([
        _sample(x, *flow_coords(flow[:, t],
                                None if mask is None else mask[:, t], h, w),
                max_disp)
        for t in range(flow.shape[1])], dim=1)


def _sample(x: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
            max_disp: Optional[int]) -> torch.Tensor:
    """x (B,H,W,C) sampled at the f32 pixel coordinates (fx, fy) (B,H,W)."""
    b, h, w, c = x.shape
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


_DTYPES = (torch.bfloat16, torch.float32)


def _check_frames(x: torch.Tensor, max_disp: Optional[int]):
    """The checks both entries make of x and max_disp."""
    b, h, w, c = x.shape
    if (x.dtype not in _DTYPES or x.numel() == 0 or b > 65535
            or h * w * c * x.element_size() >= 2 ** 31):
        raise ValueError(f"kernel takes a non-empty bf16 or f32 x of at most "
                         f"65535 frames under 2 GiB each, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if max_disp is not None and max_disp < 0:
        raise ValueError(f"max_disp must be >= 0, got {max_disp}")


_NO_GRAD = ("{} has no backward on the card for this call: only the flow "
            "entry's unbounded mode has one, with respect to flow and mask "
            "(x is data on every path that trains; ROADMAP.md section 3)")


def _count(max_disp: Optional[int]) -> None:
    hw.launches[NAME if max_disp is None else NAME_BOUNDED] += 1


def _kernel(x: torch.Tensor, grid: torch.Tensor,
            max_disp: Optional[int]) -> torch.Tensor:
    b, h, w, c = x.shape
    _check_frames(x, max_disp)
    if tuple(grid.shape) != (b, h, w, 2):
        raise ValueError(f"grid {tuple(grid.shape)} does not match x "
                         f"{tuple(x.shape)}")
    x = x.contiguous()                  # a frame sliced from a sequence
    gk = grid.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    err = _build.library().dvie_grid_sample(
        _build.ptr(x), _build.ptr(gk), _build.ptr(out), b, h, w, c,
        -1 if max_disp is None else max_disp, int(x.dtype == torch.bfloat16),
        _build.stream(x))
    _build.check_launch(NAME, err)
    _count(max_disp)
    return out


def grid_sample(x: torch.Tensor, grid: torch.Tensor,
                max_disp: Optional[int] = None) -> torch.Tensor:
    """The sample on a CUDA tensor through the Hopper kernel; on a CPU
    tensor through ``grid_sample_plain``.  Same arguments; unbounded
    unless ``max_disp`` is given."""
    if not hw.use_kernel(x):
        return grid_sample_plain(x, grid, max_disp)
    if torch.is_grad_enabled() and (x.requires_grad or grid.requires_grad):
        raise NotImplementedError(_NO_GRAD.format("grid_sample"))
    return _kernel(x, grid, max_disp)


def _steps_kernel(x: torch.Tensor, flow: torch.Tensor,
                  mask: Optional[torch.Tensor],
                  max_disp: Optional[int]) -> torch.Tensor:
    b, h, w, c = x.shape
    _check_frames(x, max_disp)
    t = flow.shape[1] if flow.dim() == 5 else 0
    dev = x.get_device()
    if (t == 0 or tuple(flow.shape) != (b, t, h, w, 2)
            or flow.dtype not in _DTYPES
            or flow.get_device() != dev):
        raise ValueError(f"flow {tuple(flow.shape)} {flow.dtype} on "
                         f"{flow.device} is not (B, T >= 1, H, W, 2) bf16 or "
                         f"f32 on {x.device} for x {tuple(x.shape)}")
    if mask is not None and (tuple(mask.shape) != (b, t, h, w, 1)
                             or mask.dtype != flow.dtype
                             or mask.get_device() != dev):
        raise ValueError(f"mask {tuple(mask.shape)} {mask.dtype} is not "
                         f"(B, T, H, W, 1) in the flow's dtype and device")
    if x.stride()[1:] != (w * c, c, 1):  # frames of a sequence keep theirs
        x = x.contiguous()
    bx, by = base_vectors(h, w, x.device)
    out = torch.empty((b, t, h, w, c), dtype=x.dtype, device=x.device)
    ms = (0, 0, 0, 0) if mask is None else mask.stride()[:4]
    err = _build.library().dvie_warp_steps(
        x.data_ptr(), flow.data_ptr(), _build.ptr(mask), bx.data_ptr(),
        by.data_ptr(), out.data_ptr(), b, t, h, w, c,
        -1 if max_disp is None else max_disp, x.dtype == torch.bfloat16,
        flow.dtype == torch.bfloat16, x.stride(0), *flow.stride(), *ms,
        _build.stream(x))
    _build.check_launch(NAME, err)
    _count(max_disp)
    return out


def _steps_bwd_kernel(x: torch.Tensor, flow: torch.Tensor,
                      mask: Optional[torch.Tensor], dout: torch.Tensor):
    """(dflow, dmask) of the unbounded flow entry, one launch: dflow
    (B,T,H,W,2) and dmask (B,T,H,W,1) (None without a mask), contiguous, in
    the flow's dtype.  Takes the operands the forward took."""
    b, h, w, c = x.shape
    t = flow.shape[1]
    if x.stride()[1:] != (w * c, c, 1):
        x = x.contiguous()
    dout = dout.to(x.dtype).contiguous()
    bx, by = base_vectors(h, w, x.device)
    dflow = torch.empty((b, t, h, w, 2), dtype=flow.dtype, device=x.device)
    dmask = None if mask is None else torch.empty(
        (b, t, h, w, 1), dtype=flow.dtype, device=x.device)
    ms = (0, 0, 0, 0) if mask is None else mask.stride()[:4]
    err = _build.library().dvie_warp_steps_bwd(
        x.data_ptr(), flow.data_ptr(), _build.ptr(mask), bx.data_ptr(),
        by.data_ptr(), dout.data_ptr(), dflow.data_ptr(), _build.ptr(dmask),
        b, t, h, w, c, x.dtype == torch.bfloat16,
        flow.dtype == torch.bfloat16, x.stride(0), *flow.stride(), *ms,
        _build.stream(x))
    _build.check_launch(NAME_BWD, err)
    hw.launches[NAME_BWD] += 1
    return dflow, dmask


class _WarpSteps(torch.autograd.Function):
    """The unbounded flow entry with its backward kernel: one forward
    launch, one backward launch giving (dflow, dmask); x takes no
    gradient."""

    @staticmethod
    def forward(ctx, x, flow, mask):
        ctx.save_for_backward(x, flow, mask)
        return _steps_kernel(x, flow, mask, None)

    @staticmethod
    def backward(ctx, dout):
        x, flow, mask = ctx.saved_tensors
        dflow, dmask = _steps_bwd_kernel(x, flow, mask, dout)
        return None, dflow, dmask


def warp_steps(x: torch.Tensor, flow: torch.Tensor,
               mask: Optional[torch.Tensor] = None,
               max_disp: Optional[int] = None) -> torch.Tensor:
    """``x`` (B,H,W,C) warped backward by each of the T steps of ``flow``
    (B,T,H,W,2, normalized units), times ``mask`` (B,T,H,W,1) if given:
    (B,T,H,W,C).  On a CUDA tensor one launch of the Hopper kernel for all
    T steps, and where flow or mask requires grad one launch of its
    backward kernel in the backward pass; on a CPU tensor
    ``warp_steps_plain``.  Unbounded unless ``max_disp`` is given."""
    if not hw.use_kernel(x):
        return warp_steps_plain(x, flow, mask, max_disp)
    if torch.is_grad_enabled() and (
            x.requires_grad or flow.requires_grad
            or (mask is not None and mask.requires_grad)):
        if x.requires_grad or max_disp is not None:
            raise NotImplementedError(_NO_GRAD.format("warp_steps"))
        return _WarpSteps.apply(x, flow, mask)
    return _steps_kernel(x, flow, mask, max_disp)


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
    is unbounded.  On a CUDA tensor the flow entry with T = 1;
    ``use_kernels=False`` takes the plain version on any device."""
    b, h, w, _ = x.shape
    r = max_disp if use_pallas else None
    if use_kernels and hw.use_kernel(x):
        return warp_steps(x, flow[:, None], None, r)[:, 0]
    grid = make_base_grid(h, w, device=x.device)[None] - flow.float()
    return grid_sample_plain(x, grid, r)


def flow_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """``backward_warp`` with its defaults (the reference's ``warp``)."""
    return backward_warp(x, flow)
