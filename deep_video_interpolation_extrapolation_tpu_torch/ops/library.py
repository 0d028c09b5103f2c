"""The served kernels as ``torch.library`` custom ops, namespace ``dvie``.

Each kernel that a served forward launches is one op here, so that
``torch.export`` (``tools/export.py``) records it as a call in the graph and
an exported program runs the kernel when it is loaded and called:

- ``dvie::conv3x3`` K1 (``ops/conv3x3.py``);
- ``dvie::bottleneck_tail`` K2, block and boundary (``ops/bottleneck_tail.py``);
- ``dvie::fuse_out0`` K3, Triton (``ops/fuse0.py``);
- ``dvie::ups_head_taps`` K4's taps mode, its 208 and 216 instances, and
  ``dvie::ups_head_1x1`` its h mode (``ops/upshead.py``);
- ``dvie::ups_head_taps4`` the 4-part head, 208 and 216 (``ops/upshead.py``);
- ``dvie::shifted_add_bias`` the shift add, co 23 and 24 (``ops/shiftadd.py``);
- ``dvie::window_attention`` (``ops/window_attn.py``).

Each op has three implementations: a fake one, which gives the outputs'
shapes and dtypes to a tracer; a CUDA one, the kernel's launch as its
wrapper makes it (it counts in ``hw.launches`` and raises where the wrapper
raises); and a CPU one, the kernel's plain version, so that an artifact
holding the ops runs on the CPU too.  Weights enter an op raw: the kernels'
weight layouts are built inside the CUDA implementation (``hw.derived``
keeps them per weight), never while a graph is traced.

The wrappers route through an op where no gradient is wanted
(``core/hw.serving``); a forward under autograd keeps its
``autograd.Function`` and so its launches and its backward.  Importing the package's ``ops``
registers every op: an exported program needs that, and no model code.
"""

from typing import Optional, Tuple

import torch
from torch import Tensor

from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.ops import (
    bottleneck_tail as k2,
    conv3x3 as k1,
    fuse0 as k3,
    shiftadd,
    upshead,
    window_attn,
)


def _on_card(t: Tensor) -> None:
    """The CUDA implementations run on the Hopper card only."""
    if not hw.use_kernel(t):
        raise RuntimeError(f"dvie op given a tensor on {t.device}")


def _like(t: Tensor, *shape, dtype=None) -> Tensor:
    return t.new_empty(shape, dtype=dtype or t.dtype)


# ---- K1 -------------------------------------------------------------------

@torch.library.custom_op("dvie::conv3x3", mutates_args=(),
                         device_types="cuda")
def conv3x3(x: Tensor, w: Tensor, bias: Optional[Tensor],
            res: Optional[Tensor], relu: bool) -> Tensor:
    _on_card(x)
    return k1._kernel(x, w, bias, res, relu)


@conv3x3.register_kernel("cpu")
def _(x, w, bias, res, relu):
    return k1.conv3x3_bias_res_lrelu_plain(x, w, bias, res, relu)


@conv3x3.register_fake
def _(x, w, bias, res, relu):
    return _like(x, *x.shape[:3], w.shape[0])


# ---- K2 -------------------------------------------------------------------

@torch.library.custom_op("dvie::bottleneck_tail", mutates_args=(),
                         device_types="cuda")
def bottleneck_tail(h1: Tensor, x: Tensor, w2: Tensor, w3: Tensor,
                    wres: Optional[Tensor], w1_next: Optional[Tensor]
                    ) -> Tuple[Tensor, Tensor]:
    """(y, h1_next); h1_next is empty (0 elements) without ``w1_next``."""
    _on_card(h1)
    y, h1n = k2._kernel(h1, x, w2, w3, wres, w1_next)
    return y, (h1n if h1n is not None else _like(h1, 0))


@bottleneck_tail.register_kernel("cpu")
def _(h1, x, w2, w3, wres, w1_next):
    y, h1n = k2.bottleneck_tail_plain(h1, x, w2, w3, wres, w1_next)
    return y, (h1n if h1n is not None else _like(h1, 0))


@bottleneck_tail.register_fake
def _(h1, x, w2, w3, wres, w1_next):
    lead = h1.shape[:3]
    return (_like(h1, *lead, w3.shape[0]),
            _like(h1, *lead, w1_next.shape[0]) if w1_next is not None
            else _like(h1, 0))


# ---- K3 -------------------------------------------------------------------

@torch.library.custom_op("dvie::fuse_out0", mutates_args=(),
                         device_types="cuda")
def fuse_out0(y0: Tensor, t1: Tensor, t2: Optional[Tensor]) -> Tensor:
    _on_card(y0)
    return k3._kernel(y0, t1, t2)


@fuse_out0.register_kernel("cpu")
def _(y0, t1, t2):
    return k3.fuse_out0_plain(y0, t1, t2)


@fuse_out0.register_fake
def _(y0, t1, t2):
    return torch.empty_like(y0)


# ---- K4 and the 4-part head -----------------------------------------------

@torch.library.custom_op("dvie::ups_head_taps", mutates_args=(),
                         device_types="cuda")
def ups_head_taps(p0: Tensor, p1: Tensor, p2: Tensor, w1: Tensor,
                  b1: Tensor, w2t: Tensor) -> Tensor:
    _on_card(p0)
    return upshead._taps_kernel(p0, p1, p2, w1, b1, w2t)


@ups_head_taps.register_kernel("cpu")
def _(p0, p1, p2, w1, b1, w2t):
    return upshead.ups_head_taps_plain(p0, p1, p2, w1, b1, w2t)


@ups_head_taps.register_fake
def _(p0, p1, p2, w1, b1, w2t):
    return _like(p0, *p0.shape[:3], w2t.shape[1])


@torch.library.custom_op("dvie::ups_head_1x1", mutates_args=(),
                         device_types="cuda")
def ups_head_1x1(p0: Tensor, p1: Tensor, p2: Tensor, w1: Tensor,
                 b1: Tensor) -> Tensor:
    _on_card(p0)
    return upshead._h_kernel(p0, p1, p2, w1, b1)


@ups_head_1x1.register_kernel("cpu")
def _(p0, p1, p2, w1, b1):
    return upshead.ups_head_1x1_plain(p0, p1, p2, w1, b1)


@ups_head_1x1.register_fake
def _(p0, p1, p2, w1, b1):
    return _like(p0, *p0.shape[:3], w1.shape[1])


@torch.library.custom_op("dvie::ups_head_taps4", mutates_args=(),
                         device_types="cuda")
def ups_head_taps4(p0: Tensor, p1: Tensor, p2: Tensor, p3: Tensor,
                   w1: Tensor, b1: Tensor, w2t: Tensor) -> Tensor:
    _on_card(p0)
    return upshead._taps4_kernel(p0, p1, p2, p3, w1, b1, w2t)


@ups_head_taps4.register_kernel("cpu")
def _(p0, p1, p2, p3, w1, b1, w2t):
    return upshead.ups_head_taps4_plain(p0, p1, p2, p3, w1, b1, w2t)


@ups_head_taps4.register_fake
def _(p0, p1, p2, p3, w1, b1, w2t):
    return _like(p0, *p0.shape[:3], w2t.shape[1])


# ---- the shift add --------------------------------------------------------

@torch.library.custom_op("dvie::shifted_add_bias", mutates_args=(),
                         device_types="cuda")
def shifted_add_bias(yt: Tensor, b2: Tensor) -> Tensor:
    _on_card(yt)
    return shiftadd._kernel(yt, b2)


@shifted_add_bias.register_kernel("cpu")
def _(yt, b2):
    return shiftadd.shifted_add_bias_plain(yt, b2)


@shifted_add_bias.register_fake
def _(yt, b2):
    return _like(yt, *yt.shape[:3], b2.shape[0])


# ---- the window attention -------------------------------------------------

@torch.library.custom_op("dvie::window_attention", mutates_args=(),
                         device_types="cuda")
def window_attention(q: Tensor, k1: Tensor, k2: Tensor, v1: Tensor,
                     v2: Tensor, win_h: int, win_w: int
                     ) -> Tuple[Tensor, Tensor]:
    _on_card(q)
    return window_attn._kernel(q, k1, k2, v1, v2, win_h, win_w)


@window_attention.register_kernel("cpu")
def _(q, k1, k2, v1, v2, win_h, win_w):
    return window_attn.window_attention_plain(q, k1, k2, v1, v2, win_h,
                                              win_w)


@window_attention.register_fake
def _(q, k1, k2, v1, v2, win_h, win_w):
    return (_like(q, *q.shape[:3], v1.shape[-1]),
            _like(q, *q.shape[:3], 4, dtype=torch.float32))
