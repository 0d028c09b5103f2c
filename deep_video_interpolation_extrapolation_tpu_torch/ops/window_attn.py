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
sum of its 90-term aggregation to bf16.  The kernel runs both products on
tensor cores: qn rounded to bf16, raw bf16 keys scaled per column by their
f32 inverse norms, an online softmax over window rows with P rounded to
bf16 before P.V (``tests/test_torch_port_wattn_shiftadd.py`` emulates these
rounding points against the plain version and the JAX oracle).

The kernel has no backward, as the JAX kernel has no ``custom_vjp``: the
wrapper raises for inputs that require grad.  Stage-3 training takes the
gradient of ``window_attention_plain`` instead, a route that
``models/attn_refine.MSResAttnRefine`` chooses wherever autograd needs its
gradient.
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
CHANNELS = 128        # the kernel's channel count


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
    version; not differentiable: through its op ``dvie::window_attention``."""
    ins = (q, k1, k2, v1, v2)
    if not hw.serving(*ins):
        raise NotImplementedError(
            "window_attention has no backward (ROADMAP.md section 2): "
            "under autograd call window_attention_plain, as "
            "MSResAttnRefine does")
    return torch.ops.dvie.window_attention(*ins, win_h, win_w)


# the kernel's tiling (csrc/window_attn.cu): a block owns a TILE_Y x TILE_X
# query tile and stages, per neighbour, a (TILE_Y + win_h - 1) x SLAB_COLS key
# slab of pixels SLAB_PITCH bf16 apart, with an f32 inverse norm per pixel
TILE_Y, TILE_X, SLAB_COLS, SLAB_PITCH = 4, 16, 24, 136
MAX_WIN_W = SLAB_COLS - TILE_X + 1
SMEM_MAX = 232448      # the dynamic shared memory a block can use (H100)


def plan(q, k1, k2, v1, v2, win_h: int, win_w: int):
    """The launch of the kernel for these operands, or a ValueError for
    what it does not take: ``(kv_same, tiles, smem)``.  ``kv_same`` when k1
    is v1 and k2 is v2 (the path: one slab per neighbour serves both
    products), else keys and values are staged apart; ``tiles`` counts the
    query tiles along W, H and B, the kernel's grid (a block a tile);
    ``smem`` is a block's shared memory, two neighbours' slabs."""
    b, h, w, c = q.shape
    if c != CHANNELS or v1.shape[-1] != CHANNELS:
        raise ValueError(f"kernel takes C = Cv = {CHANNELS}, got C={c} "
                         f"Cv={v1.shape[-1]}")
    if win_h % 2 == 0 or win_w % 2 == 0 or win_w > MAX_WIN_W:
        raise ValueError(f"kernel takes odd windows at most {MAX_WIN_W} "
                         f"wide, got {win_h}x{win_w}")
    if b * h * w * c >= 2**31:
        raise ValueError("kernel indexes elements with 32-bit ints: "
                         f"{b}x{h}x{w}x{c} is too many")
    kv_same = (k1.data_ptr() == v1.data_ptr()
               and k2.data_ptr() == v2.data_ptr())
    npix = (TILE_Y + win_h - 1) * SLAB_COLS
    smem = (2 if kv_same else 4) * npix * SLAB_PITCH * 2 + 2 * npix * 4
    if smem > SMEM_MAX:
        raise ValueError(f"a {win_h}x{win_w} window needs {smem} bytes of "
                         f"shared memory (k {'is' if kv_same else 'is not'} "
                         f"v), more than {SMEM_MAX}")
    tiles = (-(-w // TILE_X), -(-h // TILE_Y), b)
    return kv_same, tiles, smem


def _kernel(q, k1, k2, v1, v2, win_h, win_w):
    b, h, w, c = q.shape
    kv_same, _, _ = plan(q, k1, k2, v1, v2, win_h, win_w)
    for name, t in zip(("q", "k1", "k2", "v1", "v2"), (q, k1, k2, v1, v2)):
        hw.check_bf16(name, t, (b, h, w, c))
    out = torch.empty_like(q)
    flow = torch.empty((b, h, w, 4), device=q.device, dtype=torch.float32)
    err = _build.library().dvie_window_attn(
        *map(_build.ptr, (q, k1, k2, v1, v2, out, flow)), b, h, w, win_h,
        win_w, int(kv_same), _build.stream(q))
    _build.check_launch(NAME, err)
    hw.launches[NAME] += 1
    return out, flow
