"""K2: the layer1 Bottleneck tail, NHWC.

Counterpart of ``ops/pallas_chain.fused_block`` (and of ``fused_boundary``,
the same tail without its conv3x3):

    h2 = lrelu(conv3x3(h1))
    y  = lrelu(h2 . W3 + (x . Wres  if Wres is given  else x))
    h1_next = lrelu(y . W1_next)                  (None without W1_next)

The kernel is ``csrc/bottleneck_tail.cu``.  The plain version rounds where
``pallas_chain._block_ref`` rounds: every conv/product is an f32-accumulated
product of compute-dtype operands, rounded to the compute dtype before the
next step; the kernel rounds at the same points.  It takes the two blocks
of layer1 (Cx = 64 with Wres, Cx = 256 without) at any (B, H, W).  The
backward recomputes the plain version and differentiates it
(``ops/recompute.py``), the JAX kernel's own rule.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.ops import (
    _build,
    trainchain as tc,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.recompute import (
    recompute_vjp,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.resize import (
    nchw,
    nhwc,
)
from deep_video_interpolation_extrapolation_tpu_torch.parallel import spatial

NAME = "bottleneck_tail"
P, CO = 64, 256   # layer1 widths: planes and planes * expansion


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC 1x1 conv a . w for a torch (O, I, 1, 1) weight: f32 accumulation
    of compute-dtype operands, rounded to a's dtype."""
    dt = a.dtype
    return torch.matmul(a.float(), w.to(dt).float()[:, :, 0, 0].t()).to(dt)


def bottleneck_tail_plain(h1, x, w2, w3, wres=None, w1_next=None):
    """h1 (B,H,W,P) post-lrelu conv1 output; x (B,H,W,Cx) block input;
    w2 (P,P,3,3), w3 (Co,P,1,1), wres (Co,Cx,1,1) or None (then Cx == Co),
    w1_next (Pn,Co,1,1) or None — torch conv weights, any float dtype.
    Returns (y (B,H,W,Co), h1_next (B,H,W,Pn) or None).  On a band, the
    3x3 with its neighbours' rows (``spatial.conv2d``)."""
    dt = h1.dtype
    h2 = nhwc(spatial.conv2d(nchw(h1).float(), w2.to(dt).float(),
                             padding=1))
    h2 = F.leaky_relu(h2.to(dt), 0.2)
    out = _dot(h2, w3)
    out = out + (_dot(x, wres) if wres is not None else x)
    y = F.leaky_relu(out, 0.2)
    if w1_next is None:
        return y, None
    return y, F.leaky_relu(_dot(y, w1_next), 0.2)


def bottleneck_tail(h1: torch.Tensor, x: torch.Tensor, w2: torch.Tensor,
                    w3: torch.Tensor, wres: Optional[torch.Tensor] = None,
                    w1_next: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The tail on CUDA bf16 tensors through the Hopper kernel; on CPU
    tensors through the plain version.  Same arguments as the plain
    version; the kernel takes P = 64, Co = 256, Pn = 64.  Differentiable.
    Without a gradient, through its op ``dvie::bottleneck_tail``."""
    if hw.serving(h1, x, w2, w3, wres, w1_next):
        y, h1n = torch.ops.dvie.bottleneck_tail(h1, x, w2, w3, wres, w1_next)
        return y, (h1n if w1_next is not None else None)
    return recompute_vjp(_kernel, bottleneck_tail_plain, h1, x, w2, w3,
                         wres, w1_next)


def pick_tile(cx: int, has_res: bool, b: int, h: int, w: int
              ) -> Tuple[int, int]:
    """The kernel's pixel tile (rows, columns), 8x16, for a (b, h, w) tail
    whose block input has ``cx`` channels; raises ``ValueError`` for a
    shape the kernel cannot take (Cx other than 64 with Wres or 256
    without, the two blocks of layer1; an empty input; too many pixels for
    32-bit indices).  Ragged edges are masked in the kernel."""
    if (cx, has_res) not in ((P, True), (CO, False)):
        raise ValueError(f"kernel takes Cx = {P} with Wres or Cx = {CO} "
                         f"without, got Cx = {cx}, Wres "
                         f"{'given' if has_res else 'None'}")
    if min(b, h, w) < 1:
        raise ValueError(f"kernel: empty input {b}x{h}x{w}")
    if b * h * w >= 2**31 - 4096:
        raise ValueError("kernel indexes pixels with 32-bit ints: "
                         f"{b}x{h}x{w} is too many")
    return (8, 16)


def tail_units(w2, w3, wres, w1_next, dev) -> torch.Tensor:
    """The kernel's weight units, bf16 (U, 8, 64, 8), in the order a tile
    takes them: w2's nine taps (tap ky*3+kx, (in, out)); then per 64
    outputs nc: w3's (64 in, 64 out) block, wres's (64 in, 64 out) block
    if given, and w1_next's rows [64 nc, 64 nc + 64) (64 in, 64 out) if
    given; each in the no-swizzle K-major core-matrix order.  The train
    chain's forward layout without its k1 (``trainchain.bottleneck_units``),
    built once per weight set (``hw.derived``)."""
    return hw.derived(f"{NAME}:{dev}", (w2, w3, wres, w1_next),
                      lambda: tc.bottleneck_units(None, w2, w3, wres, dev,
                                                  k1_next=w1_next))


def _kernel(h1, x, w2, w3, wres, w1_next):
    b, h, w, p = h1.shape
    cx = x.shape[-1]
    if p != P or tuple(w2.shape) != (P, P, 3, 3) or tuple(w3.shape) != (CO, P, 1, 1):
        raise ValueError(f"kernel takes P={P}, Co={CO}: h1 {tuple(h1.shape)}, "
                         f"w2 {tuple(w2.shape)}, w3 {tuple(w3.shape)}")
    pick_tile(cx, wres is not None, b, h, w)
    if wres is not None and tuple(wres.shape) != (CO, cx, 1, 1):
        raise ValueError(f"wres {tuple(wres.shape)} for Cx={cx}")
    if w1_next is not None and tuple(w1_next.shape) != (P, CO, 1, 1):
        raise ValueError(f"w1_next {tuple(w1_next.shape)}")
    hw.check_bf16("h1", h1)
    hw.check_bf16("x", x, (b, h, w, cx))
    dev = h1.device
    wu = tail_units(w2, w3, wres, w1_next, dev)
    y = torch.empty((b, h, w, CO), device=dev, dtype=torch.bfloat16)
    h1n = (torch.empty((b, h, w, P), device=dev, dtype=torch.bfloat16)
           if w1_next is not None else None)
    err = _build.library().dvie_bottleneck_tail(
        _build.ptr(h1), _build.ptr(x), _build.ptr(wu), _build.ptr(y),
        _build.ptr(h1n), b, h, w, int(wres is not None),
        int(w1_next is not None), _build.stream(h1))
    _build.check_launch(NAME, err)
    hw.launches[NAME] += 1
    return y, h1n
