"""Spatial sharding: H of every full-resolution map split over the ranks of
a spatial group (counterpart of the JAX package's ``spatial`` mesh axis,
parallel/mesh.py:9, :78-102, and of ``Runner._shard``, train/runner.py:219-231).

JAX shards H across chips and lets XLA's SPMD partitioner insert the halo
exchanges a convolution needs.  The port runs one process a rank, so the
primitives that look across rows do it by hand while a step runs on a band
(``banded``):

- rank ``s`` of a group of ``S`` holds rows ``[s*H/S, (s+1)*H/S)`` of every
  map of global height H (``Band.rows``), at every scale of the network:
  H must divide by S x 16 (the VGG19's four pools);
- ``halo`` gives a band its neighbours' edge rows, zeros beyond the global
  top and bottom (``edge="replicate"``: the band's own edge row there, as a
  clamped bilinear reads it).  Its forward is one ``all_gather`` of each
  rank's edge rows; its backward sends each halo row's cotangent back to
  the rank that owns the row, one ``all_gather`` too, which adds it
  (point-to-point ops are not used: gloo refuses CUDA tensors there);
- ``conv2d`` is ``F.conv2d`` with a band's halo in place of H's zero
  padding: ``padding`` rows above and ``d (k - 1) - padding - stride + 1``
  below (a 3x3 conv takes 1 and 1, a 3x3 stride-2 conv 1 and 0);
- ``bilinear`` is the half-pixel bilinear upsampling of
  ``F.interpolate(align_corners=False)`` on a band: one halo row of the
  low-resolution input each side, the clamp at the global edges only;
- ``mean`` is a band's sum over the global count, the band's share of a
  global mean; each rank's loss is its share, and the gradients are summed
  over the group (``parallel/dist.average_grads``), so no collective sits
  inside an objective;
- ``all_sum`` completes a per-sample sum over the group (no gradient: the
  eval metrics), ``share`` turns a value the group holds whole into each
  rank's share of it, and ``gather_rows`` brings the bands of a map to the
  group's first rank (the image panels).

Outside ``banded`` every function is the unsharded one.  Every collective
runs on every rank of the group, in the same order and at the same shapes:
no branch on local data skips one.  ``exchanges`` counts the halo
exchanges, forward and backward.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import List, Optional

import torch
import torch.distributed as tdist
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Band:
    """Rank ``index`` of the ``count`` ranks of spatial group ``group``
    (None: the default group)."""
    count: int
    index: int
    group: Optional[object] = None

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.count - 1

    def rows(self, h: int) -> slice:
        """This band's rows of a map ``h`` rows high."""
        if h % self.count:
            raise ValueError(f"{h} rows do not divide over {self.count} "
                             "spatial shards")
        n = h // self.count
        return slice(self.index * n, (self.index + 1) * n)


_BAND: contextvars.ContextVar[Optional[Band]] = contextvars.ContextVar(
    "dvie_band", default=None)

exchanges = {"fwd": 0, "bwd": 0}


def current() -> Optional[Band]:
    """The band the running step works on; None outside ``banded``."""
    return _BAND.get()


@contextlib.contextmanager
def banded(band: Optional[Band]):
    """Run a step on ``band`` of every map (None: the whole maps)."""
    token = _BAND.set(band)
    try:
        yield
    finally:
        _BAND.reset(token)


def global_rows(h: int) -> int:
    """The global height of a map whose band is ``h`` rows high."""
    band = current()
    return h if band is None else h * band.count


def _all_gather(t: torch.Tensor, band: Band) -> List[torch.Tensor]:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(band.count)]
    tdist.all_gather(parts, t, group=band.group)
    return parts


def _zeros(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """Zeros shaped as ``n`` rows of ``x`` along ``dim``."""
    shape = list(x.shape)
    shape[dim] = n
    return x.new_zeros(shape)


class _Halo(torch.autograd.Function):
    """``x`` with ``top`` rows of the band above and ``bot`` rows of the
    band below along ``dim``, zeros beyond the global edges."""

    @staticmethod
    def forward(ctx, x, top, bot, dim, band):
        ctx.args = (top, bot, dim, band)
        h = x.shape[dim]
        if h < max(top, bot):
            raise ValueError(f"a band of {h} rows cannot lend {max(top, bot)}"
                             " halo rows")
        exchanges["fwd"] += 1
        parts = _all_gather(torch.cat([x.narrow(dim, 0, bot),
                                       x.narrow(dim, h - top, top)], dim),
                            band)
        up = (parts[band.index - 1].narrow(dim, bot, top) if not band.first
              else _zeros(x, dim, top))
        down = (parts[band.index + 1].narrow(dim, 0, bot) if not band.last
                else _zeros(x, dim, bot))
        return torch.cat([up, x, down], dim)

    @staticmethod
    def backward(ctx, g):
        top, bot, dim, band = ctx.args
        h = g.shape[dim] - top - bot
        exchanges["bwd"] += 1
        parts = _all_gather(torch.cat([g.narrow(dim, 0, top),
                                       g.narrow(dim, top + h, bot)], dim),
                            band)
        gx = g.narrow(dim, top, h).clone()
        if not band.last:     # the next band's top halo is my last rows
            gx.narrow(dim, h - top, top).add_(
                parts[band.index + 1].narrow(dim, 0, top))
        if not band.first:    # the previous band's bottom halo, my first
            gx.narrow(dim, 0, bot).add_(
                parts[band.index - 1].narrow(dim, top, bot))
        return gx, None, None, None, None


def halo(x: torch.Tensor, top: int, bot: int, dim: int = 1,
         edge: str = "zeros") -> torch.Tensor:
    """``x`` (a band) with ``top`` rows of the band above it and ``bot`` of
    the one below along ``dim``; beyond the global top and bottom zeros, or
    with ``edge="replicate"`` copies of the edge row.  Differentiable.
    Outside ``banded``: ``x`` padded so."""
    band = current()
    if band is None:
        padded = torch.cat([_zeros(x, dim, top), x, _zeros(x, dim, bot)],
                           dim)
        first = last = True
    else:
        padded = (_Halo.apply(x, top, bot, dim, band) if top or bot else x)
        first, last = band.first, band.last
    if edge == "zeros" or not (first or last):
        return padded
    if edge != "replicate":
        raise ValueError(f"edge {edge!r}: zeros or replicate")
    h = x.shape[dim]
    parts = [x.narrow(dim, 0, 1).expand_as(_zeros(x, dim, top)) if first
             else padded.narrow(dim, 0, top), x,
             x.narrow(dim, h - 1, 1).expand_as(_zeros(x, dim, bot)) if last
             else padded.narrow(dim, top + h, bot)]
    return torch.cat(parts, dim)


def rows_below(x: torch.Tensor, n: int = 1) -> torch.Tensor:
    """``x`` (NHWC) with the first ``n`` rows of the band below it, where
    one follows; the last band, or the whole map, as it is."""
    band = current()
    if band is None:
        return x
    ext = halo(x, 0, n)
    # the last band's rows through the exchange too: its backward is a
    # collective the other ranks wait in
    return ext.narrow(1, 0, x.shape[1]) if band.last else ext


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def conv2d(x: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride=1, padding=0,
           dilation=1) -> torch.Tensor:
    """``F.conv2d`` (NCHW, symmetric padding), on a band under ``banded``:
    H's padding replaced by the neighbours' rows, so the band's output is
    its rows of the global output."""
    band = current()
    if band is None:
        return F.conv2d(x, w, bias, stride, padding, dilation)
    sh, (ph, pw), dh = _pair(stride)[0], _pair(padding), _pair(dilation)[0]
    h = x.shape[2]
    if h % sh:
        raise ValueError(f"a band of {h} rows does not divide by the "
                         f"stride {sh}")
    bot = max(0, dh * (w.shape[2] - 1) - ph - sh + 1)
    out = F.conv2d(halo(x, ph, bot, dim=2), w, bias, stride, (0, pw),
                   dilation)
    if out.shape[2] != h // sh:
        raise ValueError(f"padding {padding} is not the band's: {h} rows "
                         f"give {out.shape[2]} at stride {sh}")
    return out


def bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """``F.interpolate(mode="bilinear", align_corners=False)`` of an NHWC
    band ``x`` to the band's output ``size`` (an integer factor in H), in
    x's dtype: the input with one halo row each side (edge rows replicated
    at the global edges, as the clamp reads them) is upsampled whole and
    its rows for this band kept; the factor is exact, so each output row
    samples the global coordinates the unsharded call samples."""
    h, (ho, wo) = x.shape[1], size
    f = ho // h
    if f < 1 or ho != f * h:
        raise NotImplementedError(
            f"a banded bilinear resize takes an integer upsampling factor "
            f"in H, not {h} -> {ho} rows")
    xp = halo(x, 1, 1, edge="replicate").permute(0, 3, 1, 2)
    out = F.interpolate(xp, size=((h + 2) * f, wo), mode="bilinear",
                        align_corners=False)
    return out.permute(0, 2, 3, 1)[:, f:f + ho].contiguous().to(x.dtype)


def mean(t: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
    """``t.mean()``; on a band (NHWC or NHW, H in dim 1) its sum over the
    global count, the band's share of the global mean, in t's dtype.
    ``rows``: the global count of rows (default: the global height)."""
    if current() is None:
        return t.mean()
    h = t.shape[1]
    rows = global_rows(h) if rows is None else rows
    return (t.sum(dtype=torch.promote_types(t.dtype, torch.float32)) / (t.numel() // h * rows)).to(t.dtype)


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the spatial group (a copy; no gradient), e.g. a
    band's per-sample sums; ``t`` outside ``banded``."""
    band = current()
    if band is None:
        return t
    t = t.detach().clone()
    tdist.all_reduce(t, group=band.group)
    return t


def share(t):
    """Each rank's share of a value its spatial group holds whole (``t``
    over the group's size), so that it sums over the group as ``mean``'s
    shares do; ``t`` outside ``banded``."""
    band = current()
    return t if band is None else t / band.count


def gather_rows(t: torch.Tensor) -> Optional[torch.Tensor]:
    """The whole map (H in dim 1) on the group's first rank from each
    rank's band, None on the others; ``t`` outside ``banded``."""
    band = current()
    if band is None:
        return t
    t = t.contiguous()
    dst = 0 if band.group is None else tdist.get_global_rank(band.group, 0)
    parts = ([torch.empty_like(t) for _ in range(band.count)] if band.first
             else None)
    tdist.gather(t, parts, dst=dst, group=band.group)
    return torch.cat(parts, 1) if band.first else None
