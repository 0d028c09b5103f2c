"""Windowed patch-correlation attention (counterpart of ops/corr.py).

For every position of an NHWC feature map: the cosine similarity of the
query feature with each offset of a (win_h x win_w) window of each neighbour
feature map (zero outside the map), and the probability-weighted sum of the
neighbours' shifted features.  Offsets are visited neighbour-major, then
``k = wy * win_w + wx`` (the reference's unfold order).

The argmax flow decodes window index k as
``(k % win_w - win_w//2, k // win_w - win_h//2)`` = (dx, dy), the JAX
package's documented fix of the reference's ``(k // win_h, k % win_h)``
(corr.py:22-26), which mis-decodes for win_h != win_w.

Every function computes in its input's dtype, as the JAX one does.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F


def _shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[i, j] = x[i+dy, j+dx], zero-filled out of range; x (B,H,W,C)."""
    _, h, w, _ = x.shape
    top, left = max(-dy, 0), max(-dx, 0)
    xp = F.pad(x, (0, 0, left, max(dx, 0), top, max(dy, 0)))
    return xp[:, top + dy:top + dy + h, left + dx:left + dx + w]


def _offsets(win_h: int, win_w: int) -> List[Tuple[int, int]]:
    """(dy, dx) of every window offset, wy outermost."""
    return [(wy - win_h // 2, wx - win_w // 2)
            for wy in range(win_h) for wx in range(win_w)]


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) over the channel axis."""
    norm = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    return x / torch.clamp_min(norm, eps)


def window_correlation(x: torch.Tensor, neighbors: Sequence[torch.Tensor],
                       win_h: int = 5, win_w: int = 9,
                       normalize: bool = True) -> torch.Tensor:
    """(B,H,W,C) query vs each (B,H,W,C) neighbour -> similarity logits
    (B,H,W,len(neighbors)*win_h*win_w), neighbour-major."""
    xq = _l2_normalize(x) if normalize else x
    sims = []
    for t in neighbors:
        tn = _l2_normalize(t) if normalize else t
        for dy, dx in _offsets(win_h, win_w):
            sims.append(torch.sum(xq * _shift2d(tn, dy, dx), dim=-1))
    return torch.stack(sims, dim=-1)


def window_aggregate(neighbors: Sequence[torch.Tensor], prob: torch.Tensor,
                     win_h: int = 5, win_w: int = 9) -> torch.Tensor:
    """sum over n, k of prob[..., n*K + k] * shift(neighbors[n], offset k)."""
    k = win_h * win_w
    out = None
    for n, t in enumerate(neighbors):
        for ki, (dy, dx) in enumerate(_offsets(win_h, win_w)):
            term = _shift2d(t, dy, dx) * prob[..., n * k + ki, None]
            out = term if out is None else out + term
    return out


def window_aggregate_per_neighbor(neighbors: Sequence[torch.Tensor],
                                  prob: torch.Tensor, win_h: int = 5,
                                  win_w: int = 9, eps: float = 1e-12
                                  ) -> List[torch.Tensor]:
    """Per neighbour n: its ``window_aggregate`` term over its own window
    probabilities, divided by their sum (at least ``eps``): the
    renormalised reuse of a coarser scale's probability map
    (corr.py:112-136)."""
    k = win_h * win_w
    outs = []
    for n, t in enumerate(neighbors):
        p = prob[..., n * k:(n + 1) * k]
        num = window_aggregate([t], p, win_h, win_w)
        outs.append(num / torch.clamp_min(p.sum(dim=-1, keepdim=True), eps))
    return outs


def argmax_flow(sim: torch.Tensor, num_neighbors: int, win_h: int = 5,
                win_w: int = 9) -> torch.Tensor:
    """Per-neighbour argmax window offset -> (B, num_neighbors, H, W, 2)
    f32 flow, channels (dx, dy); ties go to the first offset."""
    k = win_h * win_w
    flows = []
    for n in range(num_neighbors):
        idx = torch.argmax(sim[..., n * k:(n + 1) * k], dim=-1)
        dx = (idx % win_w - win_w // 2).to(torch.float32)
        dy = (idx // win_w - win_h // 2).to(torch.float32)
        flows.append(torch.stack([dx, dy], dim=-1))
    return torch.stack(flows, dim=1)
