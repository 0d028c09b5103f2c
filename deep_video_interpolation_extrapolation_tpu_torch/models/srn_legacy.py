"""The SRN-era refiners (counterpart of models/srn_legacy.py; reference
nets/SRN.py:14-1375, whose registry import the reference comments out):

- ``SRN4`` / ``SRN4Seg`` / ``SRN4Sharp`` (srn_legacy.py:111-192): a
  scale-recurrent encoder-decoder whose hidden state crosses scales; Sharp
  adds an encoder stream over the two neighbour frames;
- ``HResUnet`` (:195-205): a shallow full-resolution refiner that adds the
  SRN's last feature after its stride-2 stage;
- ``AttnRefine`` / ``AttnBaseRefine`` (:208-263): a 5x5 cosine window
  attention over both neighbours at 1/4 resolution (one softmax over both
  windows), and its ablation that sums the neighbours;
- ``MSConv2d`` / ``MSResnetBlock`` / ``MSBaseRefine`` (:266-312): parallel
  3x3, 5x5 and 7x7 convs concatenated.

The window correlation is the plain ``ops/corr`` composition, as JAX's is
XLA (no Pallas kernel stands behind these modules).  Submodules carry the
flax module names (``encoder_1``, ``Conv_0``, ``ResnetBlock_2``,
``ConvT_0``, ``MSConv2d_1``), so ``tools/jax_weights.flax_key_map`` maps a
JAX tree onto them.  As in flax, SRN4's two unnamed convs get new names at
each scale: ``Conv_0`` / ``Conv_1`` at the coarsest, ``Conv_2`` / ``Conv_3``
at the next, so each scale has its own.  Inputs are cast to ``dtype`` where
the JAX modules' first conv casts them (SRN4 resizes its frames in their
own dtype first); parameters are f32 masters.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.models.attn_refine import (
    _up_ac,
)
from deep_video_interpolation_extrapolation_tpu_torch.models.blocks import (
    Conv,
    ConvT,
    ResnetBlock,
    lrelu,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.corr import (
    window_aggregate,
    window_correlation,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.resize import (
    interpolate_bilinear,
)


def _add_blocks(module: nn.Module, features: int, kernel: int, n: int):
    for k in range(n):
        setattr(module, f"ResnetBlock_{k}", ResnetBlock(features, kernel))
    module.n_blocks = n


def _run_blocks(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    for k in range(module.n_blocks):
        x = getattr(module, f"ResnetBlock_{k}")(x)
    return x


class _EncStage(nn.Module):
    """stride-2 conv + lrelu + ``blocks`` resblocks (srn_legacy.py:52-64)."""

    def __init__(self, cin: int, features: int, kernel: int = 5,
                 blocks: int = 3):
        super().__init__()
        self.Conv_0 = Conv(cin, features, kernel, stride=2)
        _add_blocks(self, features, kernel, blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _run_blocks(self, lrelu(self.Conv_0(x)))


class _DecStage(nn.Module):
    """``blocks`` resblocks + lrelu'd 2x transposed conv (:67-78)."""

    def __init__(self, cin: int, features: int, res_kernel: int = 5,
                 blocks: int = 3):
        super().__init__()
        _add_blocks(self, cin, res_kernel, blocks)
        self.ConvT_0 = ConvT(cin, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lrelu(self.ConvT_0(_run_blocks(self, x)))


class _DecOut(nn.Module):
    """3 resblocks + output conv; ``get_feature`` also returns the
    resblocks' output (:81-95)."""

    def __init__(self, cin: int, out_dim: int = 3, kernel: int = 5,
                 get_feature: bool = False):
        super().__init__()
        self.get_feature = get_feature
        _add_blocks(self, cin, kernel, 3)
        self.Conv_0 = Conv(cin, out_dim, kernel)

    def forward(self, x: torch.Tensor):
        x = _run_blocks(self, x)
        out = self.Conv_0(x)
        return (out, x) if self.get_feature else out


class _Head(nn.Module):
    """5x5 conv + lrelu + 3 5x5 resblocks (:98-108)."""

    def __init__(self, cin: int, features: int = 32):
        super().__init__()
        self.Conv_0 = Conv(cin, features, 5)
        _add_blocks(self, features, 5, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _run_blocks(self, lrelu(self.Conv_0(x)))


class SRN4(nn.Module):
    """``forward(input_rgb, input_seg=None, neighbor_imgs=None)``: rgb
    (B,H,W,3), seg (B,H,W,``seg_ch``) where ``with_seg``, the two neighbour
    frames (B,H,W,6) where ``sharp`` -> (the per-scale rgb list, coarsest
    first; the last resblocks' 32-channel feature where ``high_res``, else
    None; None), as the reference returns.  H and W divide by
    ``4 * 2 ** (n_scales - 1)``."""

    def __init__(self, n_scales: int = 1, with_seg: bool = False,
                 sharp: bool = False, high_res: bool = False,
                 seg_ch: int = 20, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.n_scales, self.with_seg, self.sharp = n_scales, with_seg, sharp
        self.high_res = high_res
        self.dtype = dtype
        self.encoder_1 = _Head(6 + (seg_ch if with_seg else 0), 32)
        self.encoder_2 = _EncStage(32, 64)
        self.encoder_3 = _EncStage(64, 128)
        self.decoder_3 = _DecStage(128, 64)
        self.decoder_2 = _DecStage(64, 32)
        self.decoder_1 = _DecOut(32, 3, 5, get_feature=high_res)
        if sharp:
            self.sharp_encoder_1 = _Head(6, 32)
            self.sharp_encoder_2 = _EncStage(32, 64)
            self.sharp_encoder_3 = _EncStage(64, 128)
        for i in range(n_scales):      # each scale's hidden-state fuse
            setattr(self, f"Conv_{2 * i}", Conv(256, 128, 3))
            setattr(self, f"Conv_{2 * i + 1}", Conv(128, 128, 3))

    def forward(self, input_rgb: torch.Tensor,
                input_seg: Optional[torch.Tensor] = None,
                neighbor_imgs: Optional[torch.Tensor] = None
                ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor], None]:
        sharp_feats = None
        if self.sharp:
            if neighbor_imgs is None:
                raise ValueError("SRN4Sharp needs neighbor_imgs")
            s1 = self.sharp_encoder_1(neighbor_imgs.to(self.dtype))
            sharp_feats = self.sharp_encoder_3(self.sharp_encoder_2(s1))
        preds: List[torch.Tensor] = []
        hidden = feature = None
        for i, si in enumerate(range(self.n_scales - 1, -1, -1)):
            scale = 1.0 / (2 ** si)
            x_ori = input_rgb if scale == 1.0 else _up_ac(input_rgb, scale)
            # the previous scale's prediction, without its gradient
            x_pred = _up_ac(preds[-1].detach(), 2.0) if preds else x_ori
            parts = [x_ori, x_pred]
            if self.with_seg:
                parts.append(input_seg if scale == 1.0
                             else _up_ac(input_seg, scale))
            x = torch.cat([p.to(self.dtype) for p in parts], dim=-1)
            e1 = self.encoder_1(x)
            e2 = self.encoder_2(e1)
            e3 = self.encoder_3(e2)
            if sharp_feats is not None:
                e3 = e3 + interpolate_bilinear(sharp_feats, size=e3.shape[1:3],
                                               align_corners=True)
            last_hidden = _up_ac(hidden, 2.0) if hidden is not None else e3
            h = lrelu(getattr(self, f"Conv_{2 * i}")(
                torch.cat([e3, last_hidden], dim=-1)))
            e3 = hidden = getattr(self, f"Conv_{2 * i + 1}")(h)
            out = self.decoder_1(e1 + self.decoder_2(e2 + self.decoder_3(e3)))
            if self.high_res:
                out, feature = out
            preds.append(out)
        return preds, feature, None


def SRN4Seg(n_scales: int = 1, seg_ch: int = 20,
            dtype: torch.dtype = torch.bfloat16) -> SRN4:
    return SRN4(n_scales=n_scales, with_seg=True, seg_ch=seg_ch, dtype=dtype)


def SRN4Sharp(n_scales: int = 1, high_res: bool = False,
              dtype: torch.dtype = torch.bfloat16) -> SRN4:
    return SRN4(n_scales=n_scales, sharp=True, high_res=high_res, dtype=dtype)


class HResUnet(nn.Module):
    """``forward(refine_out, low_feature, x)``: x (B,H,W,``cin``) and the
    32-channel ``low_feature`` (B,H/2,W/2,32) of an SRN4 ``high_res`` run
    on the half-resolution frames -> rgb (B,H,W,3); ``refine_out`` is
    unused, as in the reference (:195-205)."""

    def __init__(self, cin: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.head = _Head(cin, 32)
        self.encoder_1 = _EncStage(32, 32)
        self.decoder_1 = _DecStage(32, 32)
        self.tail = _DecOut(32, 3, 5)

    def forward(self, refine_out, low_feature: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
        e1 = self.encoder_1(self.head(x.to(self.dtype)))
        return self.tail(self.decoder_1(e1 + low_feature.to(self.dtype)))


class AttnRefine(nn.Module):
    """``forward(coarse, seg=None, neighbors=None)``: coarse (B,H,W,3) and
    the two neighbour frames (B,H,W,6) -> rgb (B,H,W,3); ``seg`` is unused.
    One encoder to 1/4 resolution serves all three frames; the neighbours'
    features are re-aggregated by a softmax over both ``win`` x ``win``
    windows of cosine logits, or summed where ``base_only``
    (AttnBaseRefine).  H and W divide by 4."""

    def __init__(self, base_only: bool = False, win: int = 5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.base_only, self.win, self.dtype = base_only, win, dtype
        self.enc_e1 = Conv(3, 32, 3)
        self.enc_e2a = Conv(32, 64, 3, stride=2)
        self.enc_e2b = Conv(64, 64, 3)
        self.enc_e3a = Conv(64, 64, 3, stride=2)
        self.enc_e3b = Conv(64, 64, 3)
        convs = ((192, 128), (128, 64), (64, 64), (64, 64), (64, 32),
                 (32, 32), (32, 3))
        for k, (cin, cout) in enumerate(convs):
            setattr(self, f"Conv_{k}", Conv(cin, cout, 3))
        for k, c in enumerate((64, 64, 32)):
            setattr(self, f"ResnetBlock_{k}", ResnetBlock(c))

    def _enc(self, x: torch.Tensor) -> torch.Tensor:
        h1 = lrelu(self.enc_e1(x))
        h2 = lrelu(self.enc_e2b(lrelu(self.enc_e2a(h1))))
        return self.enc_e3b(lrelu(self.enc_e3a(h2)))

    def forward(self, coarse: torch.Tensor, seg=None,
                neighbors: Optional[torch.Tensor] = None) -> torch.Tensor:
        nb = neighbors.to(self.dtype)
        q = self._enc(coarse.to(self.dtype))
        k1, k2 = self._enc(nb[..., :3]), self._enc(nb[..., 3:6])
        if self.base_only:
            agg = k1 + k2
        else:
            sim = window_correlation(q, [k1, k2], self.win, self.win)
            agg = window_aggregate([k1, k2], torch.softmax(sim, dim=-1),
                                   self.win, self.win)
        h = torch.cat([q, agg, k1 + k2], dim=-1)
        h = lrelu(self.Conv_1(lrelu(self.Conv_0(h))))
        h = self.ResnetBlock_1(self.ResnetBlock_0(h))
        h = lrelu(self.Conv_3(lrelu(self.Conv_2(_up_ac(h, 2.0)))))
        h = lrelu(self.Conv_5(lrelu(self.Conv_4(_up_ac(h, 2.0)))))
        return self.Conv_6(self.ResnetBlock_2(h))


def AttnBaseRefine(dtype: torch.dtype = torch.bfloat16) -> AttnRefine:
    return AttnRefine(base_only=True, dtype=dtype)


class MSConv2d(nn.Module):
    """Parallel convs of each size in ``kernels``, concatenated over
    channels: ``features // len(kernels)`` each, the rest to the last
    (:266-281)."""

    def __init__(self, cin: int, features: int,
                 kernels: Sequence[int] = (3, 5, 7)):
        super().__init__()
        self.n = len(kernels)
        per, rem = features // self.n, features
        for i, k in enumerate(kernels):
            ch = per if i < self.n - 1 else rem
            rem -= ch
            setattr(self, f"Conv_{i}", Conv(cin, ch, k))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([getattr(self, f"Conv_{i}")(x)
                          for i in range(self.n)], dim=-1)


class MSResnetBlock(nn.Module):
    """MSConv2d-lrelu-MSConv2d + input (:284-293)."""

    def __init__(self, features: int):
        super().__init__()
        self.MSConv2d_0 = MSConv2d(features, features)
        self.MSConv2d_1 = MSConv2d(features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.MSConv2d_1(lrelu(self.MSConv2d_0(x))) + x


class MSBaseRefine(nn.Module):
    """``forward(coarse, seg=None, neighbors=None)``: the channel concat of
    the given inputs (``cin`` channels in all) -> rgb (B,H,W,3): an
    MSConv2d, a stride-2 conv, 3 MSResnetBlocks at half resolution, a 2x
    bilinear upsample and two convs (:296-312).  H and W divide by 2."""

    def __init__(self, cin: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.MSConv2d_0 = MSConv2d(cin, 64)
        self.Conv_0 = Conv(64, 64, 3, stride=2)
        for k in range(3):
            setattr(self, f"MSResnetBlock_{k}", MSResnetBlock(64))
        self.Conv_1 = Conv(64, 32, 3)
        self.Conv_2 = Conv(32, 3, 3)

    def forward(self, coarse: torch.Tensor, seg=None,
                neighbors: Optional[torch.Tensor] = None) -> torch.Tensor:
        parts = [p for p in (coarse, seg, neighbors) if p is not None]
        x = torch.cat([p.to(self.dtype) for p in parts], dim=-1)
        h = lrelu(self.Conv_0(lrelu(self.MSConv2d_0(x))))
        for k in range(3):
            h = getattr(self, f"MSResnetBlock_{k}")(h)
        return self.Conv_2(lrelu(self.Conv_1(_up_ac(h, 2.0))))
