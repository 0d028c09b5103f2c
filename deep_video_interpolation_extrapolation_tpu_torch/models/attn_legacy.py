"""The legacy attention refiners V2..V4 (counterpart of
models/attn_legacy.py; reference nets/SRN.py:581-1242, dead code there).
Every one is ``forward(x, neighbors) -> (rgb (B,H,W,3), flow map or
None)``, x (B,H,W,3) and the two neighbour frames (B,H,W,6):

- ``AttnRefineV2`` (attn_legacy.py:218-272): a 4-level encoder to 1/8;
  the frozen ResNet101's layer2 maps (the raw frames in, its BatchNorms on
  running statistics) drive a 5x9 L2-distance window correlation, whose
  per-neighbour softmax of ``1 / (dist + 1e-6)`` re-aggregates the
  neighbours' level-4 features; a 4-level decoder with skip adds;
- ``AttnRefineV2O``: the same on the model's own level-4 features;
- ``AttnRefineV2Base``: the level-4 features concatenated, no attention;
- ``AttnRefineV3`` (:284-344): an image stream and an attention stream to
  1/4, a 9x17 cosine window correlation with the reference's -100 pad on
  the normalized neighbour, per-neighbour softmax, a 3-level decoder
  without skips; ``V3Base`` without the attention stream;
- ``AttnRefineV4``: V3 with a wider, shallower attention stem and the JAX
  package's completion of the ``attn_encoder_3`` that the reference never
  defines (attn_legacy.py:27-33); ``V4Base`` is V3Base under its own name.

The flow map is (B, 2, h, w, 2), channels (dx, dy), the first maximum of
each neighbour's logits (``ops/corr.argmax_flow``'s decode).  The
arithmetic is JAX's: the L2 distance is the decomposition
``||t||^2`` shifted + pad terms - 2 corr + ``||x||^2`` in f32 with the corr
term in the features' dtype (``_l2_window_distance``), not a direct
``||t - x||^2``; the correlations are the plain ``ops/corr`` composition
(JAX's is XLA; the window-attention kernel has no per-neighbour softmax).

Layers carry the reference's state_dict names, the ones JAX
``tools/torch_port.port_attn_legacy`` reads (``encoder_1.0``,
``encoder_2.conv.{0,2..4}``, ``mid.{0,2,4,5}``, ``decoder_4.conv.3``, V2's
ResNet under ``resnet101.resnet101.``), so a reference state_dict loads as
it is.  Inputs are cast to ``dtype``; parameters are f32 masters.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.models.blocks import (
    Conv,
    ConvT,
    ResnetBlock,
)
from deep_video_interpolation_extrapolation_tpu_torch.models.features import (
    ResNet101Features,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.corr import (
    _l2_normalize,
    _offsets,
    _shift2d,
    argmax_flow,
    window_aggregate_per_neighbor,
    window_correlation,
)

PAD_VAL = -100.0   # the reference's distance-enlarging pad (SRN.py:616)


def _enc_head(cin: int, features: int = 32, blocks: int = 3) -> nn.Sequential:
    """3x3 conv + lrelu + ``blocks`` resblocks (``_EncHead``, :79-90)."""
    return nn.Sequential(Conv(cin, features, 3), nn.LeakyReLU(0.2),
                         *[ResnetBlock(features) for _ in range(blocks)])


def _mid(cin: int, features: int, second: Optional[int] = None
         ) -> nn.Sequential:
    """conv + lrelu (+ conv + lrelu) + 2 resblocks (``_Mid``, :131-146)."""
    mods = [Conv(cin, features, 3), nn.LeakyReLU(0.2)]
    if second is not None:
        mods += [Conv(features, second, 3), nn.LeakyReLU(0.2)]
        features = second
    return nn.Sequential(*mods, ResnetBlock(features), ResnetBlock(features))


class _Stage(nn.Module):
    """A reference ``encoder_layer3`` / ``decoder_layer5`` /
    ``decoder_layer_out``: its layers in the Sequential ``conv``."""

    def __init__(self, *mods: nn.Module):
        super().__init__()
        self.conv = nn.Sequential(*mods)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def _enc_l3(cin: int, features: int) -> _Stage:
    """stride-2 3x3 conv + lrelu + 3 resblocks (``_EncL3``, :93-103)."""
    return _Stage(Conv(cin, features, 3, stride=2), nn.LeakyReLU(0.2),
                  *[ResnetBlock(features) for _ in range(3)])


def _dec_l5(cin: int, features: int) -> _Stage:
    """3 resblocks + 2x transposed conv + lrelu (``_DecL5``, :106-115)."""
    return _Stage(*[ResnetBlock(cin) for _ in range(3)], ConvT(cin, features),
                  nn.LeakyReLU(0.2))


def _dec_out3(cin: int, out_dim: int = 3) -> _Stage:
    """3 5x5 resblocks + 3x3 output conv (``_DecOut3``, :118-128)."""
    return _Stage(*[ResnetBlock(cin, 5) for _ in range(3)],
                  Conv(cin, out_dim, 3))


def _pad_masks(x: torch.Tensor, win_h: int, win_w: int) -> torch.Tensor:
    """(B,H,W,win_h*win_w) f32: 1 where window offset k of a position
    falls outside the map, 0 inside."""
    ones = torch.ones(x.shape[:3] + (1,), dtype=torch.float32, device=x.device)
    return torch.cat([1.0 - _shift2d(ones, dy, dx)
                      for dy, dx in _offsets(win_h, win_w)], dim=-1)


def _l2_window_distance(x: torch.Tensor, neighbors: Sequence[torch.Tensor],
                        win_h: int, win_w: int) -> torch.Tensor:
    """Per-offset squared L2 distance of x to each neighbour's shifted
    features with the reference's -100 pad, f32 (B,H,W,len(neighbors) *
    win_h * win_w), neighbour-major (attn_legacy.py:149-175):
    ``shift(||t||^2) + pad*C*PAD^2 + 2*PAD*pad*sum(x) + ||x||^2 - 2*corr``,
    the corr term the zero-filled shifted dot in x's dtype."""
    c = x.shape[-1]
    x32 = x.float()
    sum_x = x32.sum(dim=-1, keepdim=True)
    x_sq = x32.square().sum(dim=-1, keepdim=True)
    corr = window_correlation(x, neighbors, win_h, win_w, normalize=False)
    pad = _pad_masks(x, win_h, win_w)
    cols = []
    for t in neighbors:
        t_sq = t.float().square().sum(dim=-1, keepdim=True)
        t_sq_s = torch.cat([_shift2d(t_sq, dy, dx)
                            for dy, dx in _offsets(win_h, win_w)], dim=-1)
        t_sq_s = t_sq_s + pad * (c * PAD_VAL ** 2)
        cols.append(t_sq_s + 2.0 * PAD_VAL * pad * sum_x + x_sq)
    return torch.cat(cols, dim=-1) - 2.0 * corr.float()


def _per_neighbor_softmax(logits: torch.Tensor, n_neighbors: int
                          ) -> torch.Tensor:
    """A softmax over each neighbour's block of window logits on its own
    (:178-186)."""
    return torch.cat([torch.softmax(b, dim=-1) for b in
                      logits.chunk(n_neighbors, dim=-1)], dim=-1)


def _corr_l2(x, t1, t2, win_h, win_w):
    dist = _l2_window_distance(x, [t1, t2], win_h, win_w)
    flow = argmax_flow(-dist, 2, win_h, win_w)
    return _per_neighbor_softmax(1.0 / (dist + 1e-6), 2), flow


def _cos_logits(x, t1, t2, win_h, win_w):
    """Cosine logits, f32, with the -100 pad on the normalized neighbour:
    each padded offset's logit is ``PAD * sum(x_hat)`` (:196-213)."""
    xn = _l2_normalize(x.float())
    corr = window_correlation(xn, [_l2_normalize(t1.float()),
                                   _l2_normalize(t2.float())],
                              win_h, win_w, normalize=False)
    pad = _pad_masks(x, win_h, win_w) * PAD_VAL * xn.sum(dim=-1, keepdim=True)
    return corr + torch.cat([pad, pad], dim=-1)


def _corr_cos(x, t1, t2, win_h, win_w):
    sim = _cos_logits(x, t1, t2, win_h, win_w)
    flow = argmax_flow(sim, 2, win_h, win_w)
    return _per_neighbor_softmax(sim, 2), flow


class _MyResNet101(nn.Module):
    """The reference's ``my_resnet101`` wrapper: its torchvision net is the
    child ``resnet101`` (nets/resnet101.py:5-9)."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.resnet101 = ResNet101Features(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnet101(x, last=2)[0]          # layer2, 1/8, 512 ch


V2_VARIANTS = ("v2", "v2o", "v2base")


class AttnV2Core(nn.Module):
    """V2 / V2O / V2Base (``variant``): a 4-level encoder to 1/8, the fuse
    there, a UNet decoder with skip adds.  H and W divide by 8."""

    def __init__(self, variant: str, win_h: int = 5, win_w: int = 9,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if variant not in V2_VARIANTS:
            raise KeyError(variant)
        self.variant, self.win, self.dtype = variant, (win_h, win_w), dtype
        self.encoder_1 = _enc_head(3, 32)
        self.encoder_2 = _enc_l3(32, 64)
        self.encoder_3 = _enc_l3(64, 128)
        self.encoder_4 = _enc_l3(128, 128)
        if variant == "v2":
            self.resnet101 = _MyResNet101(dtype)
        self.mid = _mid(384, 128)
        self.decoder_4 = _dec_l5(128, 128)
        self.decoder_3 = _dec_l5(128, 64)
        self.decoder_2 = _dec_l5(64, 32)
        self.decoder_1 = _dec_out3(32)

    def _encode(self, im: torch.Tensor) -> List[torch.Tensor]:
        e = [self.encoder_1(im)]
        for enc in (self.encoder_2, self.encoder_3, self.encoder_4):
            e.append(enc(e[-1]))
        return e

    def forward(self, x: torch.Tensor, neighbors: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        x, nb = x.to(self.dtype), neighbors.to(self.dtype)
        img1, img2 = nb[..., :3], nb[..., 3:6]
        x_e1, x_e2, x_e3, x_e4 = self._encode(x)
        i1_e4, i2_e4 = self._encode(img1)[3], self._encode(img2)[3]
        flow = None
        if self.variant == "v2base":
            f1w, f2w = i1_e4, i2_e4
        else:
            feats = (tuple(map(self.resnet101, (x, img1, img2)))
                     if self.variant == "v2" else (x_e4, i1_e4, i2_e4))
            prob, flow = _corr_l2(*feats, *self.win)
            f1w, f2w = window_aggregate_per_neighbor([i1_e4, i2_e4], prob,
                                                     *self.win)
        d4 = self.decoder_4(self.mid(torch.cat([x_e4, f1w, f2w], dim=-1)))
        d3 = self.decoder_3(d4 + x_e3)
        d2 = self.decoder_2(d3 + x_e2)
        return self.decoder_1(d2 + x_e1), flow


def AttnRefineV2(dtype: torch.dtype = torch.bfloat16, **kw) -> AttnV2Core:
    return AttnV2Core("v2", dtype=dtype, **kw)


def AttnRefineV2O(dtype: torch.dtype = torch.bfloat16, **kw) -> AttnV2Core:
    return AttnV2Core("v2o", dtype=dtype, **kw)


def AttnRefineV2Base(dtype: torch.dtype = torch.bfloat16, **kw) -> AttnV2Core:
    return AttnV2Core("v2base", dtype=dtype, **kw)


V3_VARIANTS = ("v3", "v3base", "v4", "v4base")


class AttnV3Core(nn.Module):
    """V3 / V3Base / V4 / V4Base (``variant``): an image stream to 1/4
    (and an attention stream where the variant attends), the fuse there,
    a 3-level decoder without skips.  H and W divide by 4."""

    def __init__(self, variant: str, win_h: int = 9, win_w: int = 17,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if variant not in V3_VARIANTS:
            raise KeyError(variant)
        self.variant, self.win, self.dtype = variant, (win_h, win_w), dtype
        self.has_attn = variant in ("v3", "v4")
        img_c3 = 64 if self.has_attn else 128
        self.img_encoder_1 = _enc_head(3, 32)
        self.img_encoder_2 = _enc_l3(32, 64)
        self.img_encoder_3 = _enc_l3(64, img_c3)
        if variant == "v3":
            self.attn_encoder_1 = _enc_head(3, 32)
            self.attn_encoder_2 = _enc_l3(32, 64)
            self.attn_encoder_3 = _enc_l3(64, 64)
        elif variant == "v4":
            # attn_encoder_3 completes the reference's undefined layer
            self.attn_encoder_1 = _enc_head(3, 64, blocks=1)
            self.attn_encoder_2 = _enc_l3(64, 128)
            self.attn_encoder_3 = _enc_l3(128, 64)
        mid_c = 64 if self.has_attn else 128
        self.mid = _mid(3 * img_c3, 128, second=mid_c)
        self.decoder_3 = _dec_l5(mid_c, 64)
        self.decoder_2 = _dec_l5(64, 32)
        self.decoder_1 = _dec_out3(32)

    def _img(self, im: torch.Tensor) -> torch.Tensor:
        return self.img_encoder_3(self.img_encoder_2(self.img_encoder_1(im)))

    def _attn(self, im: torch.Tensor) -> torch.Tensor:
        return self.attn_encoder_3(self.attn_encoder_2(
            self.attn_encoder_1(im)))

    def forward(self, x: torch.Tensor, neighbors: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        x, nb = x.to(self.dtype), neighbors.to(self.dtype)
        img1, img2 = nb[..., :3], nb[..., 3:6]
        x_e3, i1_e3, i2_e3 = map(self._img, (x, img1, img2))
        flow = None
        if self.has_attn:
            prob, flow = _corr_cos(*map(self._attn, (x, img1, img2)),
                                   *self.win)
            f1w, f2w = window_aggregate_per_neighbor([i1_e3, i2_e3], prob,
                                                     *self.win)
        else:
            f1w, f2w = i1_e3, i2_e3
        mid = self.mid(torch.cat([x_e3, f1w, f2w], dim=-1))
        return self.decoder_1(self.decoder_2(self.decoder_3(mid))), flow


def AttnRefineV3(dtype: torch.dtype = torch.bfloat16, **kw) -> AttnV3Core:
    return AttnV3Core("v3", dtype=dtype, **kw)


def AttnRefineV3Base(dtype: torch.dtype = torch.bfloat16, **kw) -> AttnV3Core:
    return AttnV3Core("v3base", dtype=dtype, **kw)


def AttnRefineV4(dtype: torch.dtype = torch.bfloat16, **kw) -> AttnV3Core:
    return AttnV3Core("v4", dtype=dtype, **kw)


def AttnRefineV4Base(dtype: torch.dtype = torch.bfloat16, **kw) -> AttnV3Core:
    return AttnV3Core("v4base", dtype=dtype, **kw)
