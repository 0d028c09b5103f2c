"""Fused window attention of the stage-3 refiner, NHWC.

Counterpart of ``ops/pallas_corr.fused_window_attention``: for every pixel,
the cosine similarity of ``q`` with the keys ``k1``, ``k2`` at every offset
of a (win_h x win_w) window (zero outside the map), one softmax over all
``2 * win_h * win_w`` logits, the probability-weighted sum of the values
``v1``, ``v2`` at the same offsets, and per neighbour the first offset of
highest similarity as a flow (dx, dy).  Returns ``out (B,H,W,Cv)`` in q's
dtype and ``flow (B,H,W,4) = (dx1, dy1, dx2, dy2)`` in f32.

The kernel is ``csrc/window_attn.cu``; the plain version is the JAX
oracle ``fused_window_attention_reference`` (pallas_corr.py:218-233) on the
``ops/corr`` functions, computed in f32 as the Pallas kernel computes
(pallas_corr.py:80,104-105: q, keys and values cast to f32, f32 sums), the
output rounded to q's dtype once.  At f32 inputs it is the oracle exactly;
at bf16 the oracle instead rounds every similarity, probability and partial
sum of its 90-term aggregation to bf16, which moved the output by 2.4% of
its max from the f32 kernel's (H100, 1x128x256x128).

Neither has a gradient: the JAX kernel has no ``custom_vjp`` and stage-3
training is not ported (ROADMAP.md queue 1 item 7), so the wrapper raises
for inputs that require grad.
"""

from __future__ import annotations

from typing import Tuple

import torch

from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.ops import _build
from deep_video_interpolation_extrapolation_tpu_torch.ops.corr import (
    argmax_flow,
    window_aggregate,
    window_correlation,
)

NAME = "window_attention"
CHANNELS = 128        # the kernel's channel count (4 per lane of a warp)


def window_attention_plain(q, k1, k2, v1, v2, win_h: int = 5, win_w: int = 9
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k1, k2 (B,H,W,C), v1, v2 (B,H,W,Cv) -> (out, flow)."""
    dt = q.dtype
    q, k1, k2, v1, v2 = (t.float() for t in (q, k1, k2, v1, v2))
    sim = window_correlation(q, [k1, k2], win_h, win_w)
    prob = torch.softmax(sim, dim=-1)
    out = window_aggregate([v1, v2], prob, win_h, win_w)
    fl = argmax_flow(sim, 2, win_h, win_w)
    return out.to(dt), torch.cat([fl[:, 0], fl[:, 1]], dim=-1)


def window_attention(q, k1, k2, v1, v2, win_h: int = 5, win_w: int = 9
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention on CUDA bf16 tensors through the Hopper kernel; on CPU
    tensors through the plain version.  Same arguments as the plain
    version; not differentiable."""
    ins = (q, k1, k2, v1, v2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        raise NotImplementedError(
            "window_attention has no backward: stage-3 training is not "
            "ported yet (ROADMAP.md queue 1 item 7)")
    if not hw.use_kernel(q):
        return window_attention_plain(*ins, win_h, win_w)
    return _kernel(*ins, win_h, win_w)


def _kernel(q, k1, k2, v1, v2, win_h, win_w):
    b, h, w, c = q.shape
    if c != CHANNELS or v1.shape[-1] != CHANNELS:
        raise ValueError(f"kernel takes C = Cv = {CHANNELS}, got C={c} "
                         f"Cv={v1.shape[-1]}")
    if win_h % 2 == 0 or win_w % 2 == 0:
        raise ValueError(f"kernel takes odd windows, got {win_h}x{win_w}")
    if b * h * w * c >= 2**31:
        raise ValueError("kernel indexes elements with 32-bit ints: "
                         f"{b}x{h}x{w}x{c} is too many")
    for name, t in zip(("q", "k1", "k2", "v1", "v2"), (q, k1, k2, v1, v2)):
        hw.check_bf16(name, t, (b, h, w, c))
    out = torch.empty_like(q)
    flow = torch.empty((b, h, w, 4), device=q.device, dtype=torch.float32)
    err = _build.library().dvie_window_attn(
        *map(_build.ptr, (q, k1, k2, v1, v2, out, flow)), b, h, w, win_h,
        win_w, _build.stream(q))
    _build.check_launch(NAME, err)
    hw.launches[NAME] += 1
    return out, flow
