"""GridNet generator (counterpart of the JAX package's ``models/gridnet.py``:
reference nets/grid_net.py:15-364): a 3-row grid of lateral, down and up
flows of PReLU conv pairs.

NHWC.  The model is a pure function returning (rgb_out, seg_out), either
None by mode; the reference's in-forward losses live in the train step, as
in the JAX package.  Submodules and PReLU slopes carry the flax names
(``Conv_k``, ``a0``, ``a1``, ``row0``, ``down01``, ...), so
``tools/jax_weights.flax_key_map`` maps a JAX tree onto them one to one.
Each conv computes in ``dtype`` (None: its input's).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.models.blocks import Conv
from deep_video_interpolation_extrapolation_tpu_torch.models.legacy_gen import (
    up,
)

# the channels of each mode's input (the channel concat of rgb and seg)
IN_CHANNELS = {"x2x": 6, "s2s": 40}


class PReLUPair(nn.Module):
    """A module with the two PReLU slopes ``a0`` and ``a1`` of the JAX
    ``_prelu`` (one value each, 0.25 at init)."""

    def __init__(self):
        super().__init__()
        self.a0 = nn.Parameter(torch.full((1,), 0.25))
        self.a1 = nn.Parameter(torch.full((1,), 0.25))

    @staticmethod
    def prelu(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, a * x)


class Lateral(PReLUPair):
    """(PReLU -> conv) x 2, or conv (-> PReLU -> conv) x 2, with an optional
    shortcut (a conv where the widths differ) (grid_net.py:15-51)."""

    def __init__(self, cin: int, out_ch: int, shortcut_conv: bool = False,
                 prelu_first: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.prelu_first, self.dtype = prelu_first, dtype
        chans = [cin, out_ch, out_ch] if prelu_first else [cin] + [out_ch] * 3
        self.n = len(chans) - 1
        for i in range(self.n):
            setattr(self, f"Conv_{i}", Conv(chans[i], out_ch, 3))
        self.shortcut = None
        if shortcut_conv:
            self.shortcut = "identity"
            if cin != out_ch:
                self.shortcut = f"Conv_{self.n}"
                setattr(self, self.shortcut, Conv(cin, out_ch, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = [getattr(self, f"Conv_{i}") for i in range(self.n)]
        dt = self.dtype
        if self.prelu_first:
            h = c[1](self.prelu(c[0](self.prelu(x, self.a0), dt), self.a1), dt)
        else:
            h = self.prelu(c[0](x, dt), self.a0)
            h = c[2](self.prelu(c[1](h, dt), self.a1), dt)
        if self.shortcut == "identity":
            return h + x
        if self.shortcut is not None:
            return h + getattr(self, self.shortcut)(x, dt)
        return h


class _Resample(PReLUPair):
    """PReLU -> conv -> PReLU -> conv after a 2x bilinear upsample
    (``_UpSample``) or with the first conv at stride 2 (``_DownSample``)."""

    def __init__(self, cin: int, out_ch: int, down: bool,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.down, self.dtype = down, dtype
        self.Conv_0 = Conv(cin, out_ch, 3, stride=2 if down else 1)
        self.Conv_1 = Conv(out_ch, out_ch, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x if self.down else up(x, 2.0)
        h = self.Conv_0(self.prelu(h, self.a0), self.dtype)
        return self.Conv_1(self.prelu(h, self.a1), self.dtype)


class _Flow(nn.Module):
    """``Downflow`` (``down``) or ``Upflow``: a Lateral on each row, then the
    rows joined downwards (r1 += down01(r0), r2 += down12(r1)) or upwards
    (r1 += up21(r2), r0 += up10(r1))."""

    def __init__(self, chans: Tuple[int, int, int], down: bool,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.down = down
        for r in range(3):
            setattr(self, f"row{r}", Lateral(chans[r], chans[r], dtype=dtype))
        if down:
            self.down01 = _Resample(chans[0], chans[1], True, dtype)
            self.down12 = _Resample(chans[1], chans[2], True, dtype)
        else:
            self.up21 = _Resample(chans[2], chans[1], False, dtype)
            self.up10 = _Resample(chans[1], chans[0], False, dtype)

    def forward(self, r0, r1, r2):
        r0, r1, r2 = self.row0(r0), self.row1(r1), self.row2(r2)
        if self.down:
            r1 = self.down01(r0) + r1
            r2 = self.down12(r1) + r2
        else:
            r1 = self.up21(r2) + r1
            r0 = self.up10(r1) + r0
        return r0, r1, r2


class GridNet(nn.Module):
    """3 x 6 grid generator (grid_net.py:140-263).  ``forward(x,
    train=True)`` with the mode's channel-concat input (46 = 6 rgb + 40 seg
    channels, 6 for ``x2x``, 40 for ``s2s``) -> (rgb_out, seg_out), either
    None by mode.  H and W divide by 4."""

    def __init__(self, mode: str = "xs2xs", n_channels=(32, 64, 96),
                 n_classes: int = 20, split_tail: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mode, self.n_classes, self.split_tail = mode, n_classes, split_tail
        ch = tuple(n_channels)
        self.head = Lateral(IN_CHANNELS.get(mode, 46), ch[0], shortcut_conv=True, prelu_first=False,
                            dtype=dtype)
        self.neck_down01 = _Resample(ch[0], ch[1], True, dtype)
        self.neck_down12 = _Resample(ch[1], ch[2], True, dtype)
        for k in range(2):
            setattr(self, f"body_down{k}", _Flow(ch, True, dtype))
        for k in range(3):
            setattr(self, f"body_up{k}", _Flow(ch, False, dtype))
        # what the tail predicts: rgb, seg, or both (xs2xs and any other
        # mode, as the JAX module falls through to xs2xs)
        self.kind = ("rgb" if mode in ("x2x", "xs2x") else
                     "seg" if mode in ("s2s", "xs2s", "wing") else "both")
        if self.kind == "seg":
            self.tail = Lateral(ch[0], n_classes, dtype=dtype)
        elif self.kind == "both" and not split_tail:
            self.tail = Lateral(ch[0], 3 + n_classes, dtype=dtype)
        else:
            self.tail = Lateral(ch[0], 3, dtype=dtype)
            if self.kind == "both":
                self.tail_seg = Lateral(ch[0], n_classes, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = True):
        r0 = self.head(x)
        r1 = self.neck_down01(r0)
        r2 = self.neck_down12(r1)
        for name in ("body_down0", "body_down1", "body_up0", "body_up1",
                     "body_up2"):
            r0, r1, r2 = getattr(self, name)(r0, r1, r2)
        if self.kind == "rgb":
            return self.tail(r0), None
        if self.kind == "seg":
            return None, self.tail(r0)
        if self.split_tail:
            return self.tail(r0), self.tail_seg(r0)
        out = self.tail(r0)
        return out[..., :3], out[..., 3:]
