"""The legacy coarse generators (counterpart of the JAX package's
``models/legacy_gen.py``: reference nets/MyFRRN.py, PSPNet.py, B2SNet.py).

NHWC.  ``forward(rgb, seg=None, train=True)``: rgb (B,H,W,6) the two input
frames, seg (B,H,W,40) their one-hot pair, returning ``(rgb_out,
seg_out)`` (seg_out None outside ``xs2xs`` and for B2SNet, which is
``xx2x`` only).  None of them has a BatchNorm; ``train`` is taken for the
common call.  Submodules carry the flax module names (``Conv_k``,
``head_conv``, ``frru_d2``, ``pspconv_i``, ...), so
``tools/jax_weights.flax_key_map`` maps a JAX tree onto them one to one.
Each conv computes in ``dtype`` (None: its input's).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from deep_video_interpolation_extrapolation_tpu_torch.models.blocks import (
    Conv,
    SegEncoder,
    lrelu,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.resize import (
    interpolate_bilinear,
)


def up(x: torch.Tensor, factor: float) -> torch.Tensor:
    """Bilinear resize by ``factor``, align_corners (the legacy nets')."""
    return interpolate_bilinear(x, scale_factor=factor, align_corners=True)


def add_convs(module: nn.Module, specs: Sequence) -> None:
    """Register ``Conv_0``, ``Conv_1``, ... on ``module`` from (cin, cout,
    kwargs) specs, in the order the flax module creates them."""
    for i, (cin, cout, kw) in enumerate(specs):
        setattr(module, f"Conv_{i}", Conv(cin, cout, **kw))


def seg_features(model: nn.Module, rgb: torch.Tensor,
                 seg: Optional[torch.Tensor]) -> torch.Tensor:
    """The generators' input: rgb and both frames' seg embeddings in
    ``xs2xs``, the two rgb frames alone otherwise."""
    if model.mode != "xs2xs":
        return rgb[..., :6]
    enc = [model.seg_encoder(seg[..., :20], model.dtype),
           model.seg_encoder(seg[..., 20:40], model.dtype)]
    return torch.cat([rgb] + [e.to(rgb.dtype) for e in enc], dim=-1)


def feature_channels(mode: str) -> int:
    return 6 + 8 if mode == "xs2xs" else 6


class FRRU(nn.Module):
    """Full-resolution residual unit (nets/MyFRRN.py:6-45): the pooled
    stream y convolves with the downsampled z, and z gets the upsampled
    transform back."""

    def __init__(self, z_ch: int, y_ch: int, scale: int, botneck: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.scale, self.botneck, self.dtype = scale, botneck, dtype
        specs = [(z_ch, y_ch, dict(kernel=1 + scale, stride=scale,
                                   padding=(1 + scale) // 2)),
                 (2 * y_ch, y_ch, {})]
        if botneck:
            specs += [(y_ch, y_ch, dict(dilation=r)) for r in (2, 4, 8)]
        specs += [(y_ch, y_ch, {}), (y_ch, z_ch, {}), (z_ch, z_ch, {})]
        add_convs(self, specs)
        self.n = len(specs)

    def forward(self, z: torch.Tensor, y: torch.Tensor):
        c = [getattr(self, f"Conv_{i}") for i in range(self.n)]
        dt = self.dtype
        h = torch.cat([c[0](z, dt), y.to(dt or z.dtype)], dim=-1)
        for conv in c[1:-2]:
            h = F.elu(conv(h, dt))
        t = up(h, float(self.scale))
        t = c[-1](F.elu(c[-2](t, dt)), dt)
        return z + t, h


class _HeadBlock(nn.Module):
    """4-conv ELU block plus a conv shortcut (nets/MyFRRN.py:47-62)."""

    def __init__(self, cin: int, out_ch: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        add_convs(self, [(cin, 64, {}), (64, 128, {}), (128, 128, {}),
                         (128, out_ch, {}), (cin, out_ch, {})])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = F.elu(self.Conv_0(x, dt))
        h = F.elu(self.Conv_1(h, dt))
        h = F.elu(self.Conv_2(h, dt))
        return self.Conv_3(h, dt) + self.Conv_4(x, dt)


class MyFRRN(nn.Module):
    """FRRN-style two-stream generator (nets/MyFRRN.py:124-211)."""

    def __init__(self, mode: str = "xs2xs",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mode, self.dtype = mode, dtype
        if mode == "xs2xs":
            self.seg_encoder = SegEncoder()
        self.head_conv = _HeadBlock(feature_channels(mode), 32, dtype)
        self.frru_d2 = FRRU(32, 64, 2, dtype=dtype)
        self.frru_bottleneck = FRRU(32, 96, 4, botneck=True, dtype=dtype)
        self.frru_u2 = FRRU(32, 64, 2, dtype=dtype)
        specs = [(32, 64, dict(stride=2)), (64, 96, dict(stride=2)),
                 (96, 64, {}), (32, 32, {}), (32, 3, {}), (32, 3, {})]
        if mode == "xs2xs":
            specs += [(32, 64, {}), (64, 20, {})]
        add_convs(self, specs)

    def forward(self, rgb: torch.Tensor, seg: Optional[torch.Tensor] = None,
                train: bool = True):
        dt = self.dtype
        z0 = self.head_conv(seg_features(self, rgb, seg))
        y0 = F.elu(self.Conv_0(F.elu(z0), dt))                 # down 2
        z1, y1 = self.frru_d2(z0, y0)
        y1 = F.elu(self.Conv_1(y1, dt))                        # down 4
        z2, y2 = self.frru_bottleneck(z1, y1)
        y2 = F.elu(self.Conv_2(up(y2, 2.0), dt))               # up
        z3, _ = self.frru_u2(z2, y2)
        h = F.elu(self.Conv_3(F.elu(z3), dt))
        rgb_out = torch.tanh(self.Conv_4(h, dt) + self.Conv_5(z3, dt))
        seg_out = None
        if self.mode == "xs2xs":
            s = F.elu(self.Conv_6(F.elu(z3), dt))
            seg_out = self.Conv_7(s, dt)
        return rgb_out, seg_out


class _PSPResBlock(nn.Module):
    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        add_convs(self, [(features, features, {})] * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = lrelu(self.Conv_0(x, self.dtype))
        return self.Conv_1(h, self.dtype) + x


class PSPConv(nn.Module):
    """Pyramid-scale conv block (nets/PSPNet.py:20-55): scale i takes i
    stride-2 convs, ``layers`` residual blocks and an upsample back; the
    scales are concatenated and fused.  ``v2`` adds the previous block's
    per-scale features before the residual blocks and returns this block's
    (nets/PSPNet.py:133-172)."""

    def __init__(self, cin: int = 64, out_dim: int = 64, n_scales: int = 3,
                 layers: int = 2, inter_dims=(64, 128, 256), v2: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_scales, self.layers, self.v2 = n_scales, layers, v2
        self.dtype = dtype
        convs, k = [], 0
        for i in range(n_scales):
            c = cin
            for _ in range(i):
                convs.append((c, inter_dims[i], dict(stride=2)))
                c = inter_dims[i]
            for _ in range(layers):
                setattr(self, f"_PSPResBlock_{k}",
                        _PSPResBlock(inter_dims[i], dtype))
                k += 1
        convs.append((sum(inter_dims[:n_scales]), out_dim, {}))
        add_convs(self, convs)

    def forward(self, x: torch.Tensor,
                feats: Optional[List[torch.Tensor]] = None):
        outs, out_feats, ci, k = [], [], 0, 0
        for i in range(self.n_scales):
            h = x
            for _ in range(i):
                h = lrelu(getattr(self, f"Conv_{ci}")(h, self.dtype))
                ci += 1
            if self.v2 and feats is not None:
                h = h + feats[i]
            for _ in range(self.layers):
                h = getattr(self, f"_PSPResBlock_{k}")(h)
                k += 1
            out_feats.append(h)
            if i > 0:
                h = up(h, float(2 ** i))
            outs.append(h)
        out = getattr(self, f"Conv_{ci}")(lrelu(torch.cat(outs, -1)),
                                           self.dtype)
        return (out, out_feats) if self.v2 else out


class PSPNet(nn.Module):
    """Four PSPConv blocks (nets/PSPNet.py:58-130; ``v2``: 175-246).  H and
    W divide by 4."""

    def __init__(self, mode: str = "xs2xs", v2: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mode, self.v2, self.dtype = mode, v2, dtype
        if mode == "xs2xs":
            self.seg_encoder = SegEncoder()
        for i in range(4):
            setattr(self, f"pspconv_{i}", PSPConv(v2=v2, dtype=dtype))
        specs = [(feature_channels(mode), 64, {}), (64, 64, {}), (64, 32, {}),
                 (32, 3, {})]
        if mode == "xs2xs":
            specs += [(64, 64, {}), (64, 20, {})]
        add_convs(self, specs)

    def forward(self, rgb: torch.Tensor, seg: Optional[torch.Tensor] = None,
                train: bool = True):
        dt = self.dtype
        h = self.Conv_0(seg_features(self, rgb, seg), dt)
        h = self.Conv_1(lrelu(h), dt)
        feats = None
        for i in range(4):
            block = getattr(self, f"pspconv_{i}")
            if self.v2:
                h, feats = block(h, feats)
            else:
                h = block(h)
        r = lrelu(self.Conv_2(lrelu(h), dt))
        rgb_out = torch.clamp(self.Conv_3(r, dt), -1, 1)
        seg_out = None
        if self.mode == "xs2xs":
            s = lrelu(self.Conv_4(lrelu(h), dt))
            seg_out = self.Conv_5(s, dt)
        return rgb_out, seg_out


def PSPNetV2(mode: str = "xs2xs", dtype: Optional[torch.dtype] = None
             ) -> PSPNet:
    return PSPNet(mode=mode, v2=True, dtype=dtype)


def _cascade(x: torch.Tensor, n: int, cells) -> torch.Tensor:
    """The coarse-to-fine cascade of B2SNet and its cells: level i of n
    takes x at 1 / 2^(n-1-i) (the last at full size), concatenated with the
    previous level's output upsampled by 2, through ``cells[i]``."""
    out = None
    for i in range(n):
        last = i == n - 1
        scaled = x if last else up(x, 1.0 / 2 ** (n - 1 - i))
        out = cells[i](scaled if out is None else torch.cat([scaled, out], -1))
        if not last:
            out = up(out, 2.0)
    return out


class _B2SConv(nn.Module):
    """Coarse-to-fine conv cascade cell (nets/B2SNet.py:8-39)."""

    def __init__(self, cin: int, med_dim: int, out_dim: int, n_conv: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_conv, self.dtype = n_conv, dtype
        add_convs(self, [(cin + (med_dim if i else 0),
                          out_dim if i == n_conv - 1 else med_dim, {})
                         for i in range(n_conv)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _cascade(x, self.n_conv, [
            lambda t, c=getattr(self, f"Conv_{i}"): lrelu(c(t, self.dtype))
            for i in range(self.n_conv)])


class _B2SModule(nn.Module):
    def __init__(self, cin: int, med_dim: int, out_dim: int,
                 n_scales: int = 2, n_conv: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_scales = n_scales
        for i in range(n_scales):
            last = i == n_scales - 1
            setattr(self, f"_B2SConv_{i}", _B2SConv(
                cin + (med_dim if i else 0), med_dim,
                out_dim if last else med_dim, n_conv, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _cascade(x, self.n_scales, [getattr(self, f"_B2SConv_{i}")
                                           for i in range(self.n_scales)])


class B2SNet(nn.Module):
    """Big-to-small multiscale cascade, ``xx2x`` only
    (nets/B2SNet.py:72-113); returns (rgb, None).  H and W divide by 8."""

    def __init__(self, n_scales: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_scales, self.dtype = n_scales, dtype
        for i in range(n_scales):
            setattr(self, f"conv{i}", _B2SModule(6 + (64 if i else 0), 64, 64,
                                                 2, 2, dtype))
        add_convs(self, [(64, 32, {}), (32, 3, {})])

    def forward(self, rgb: torch.Tensor, seg: Optional[torch.Tensor] = None,
                train: bool = True):
        out = _cascade(rgb[..., :6], self.n_scales,
                       [getattr(self, f"conv{i}")
                        for i in range(self.n_scales)])
        h = lrelu(self.Conv_0(out, self.dtype))
        return self.Conv_1(h, self.dtype), None
