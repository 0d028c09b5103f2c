"""Stage-3 attention refiners (counterpart of models/attn_refine.py):

- ``MSResAttnRefine`` (V1, attn_refine.py:74-199, reference
  nets/refine_nets.py:138-399): a per-scale loop, a 5x9 window correlation
  at 1/4 of each scale, a dual stream (attention + dilated image);
- ``MSResAttnRefineV2`` / ``V2Base`` / ``V3`` (``PyramidAttnRefine``,
  attn_refine.py:202-358): a 3-level coarse-to-fine pyramid, a 5x5 window
  correlation at 1/4 of each level upsampled x4 before the softmax, the
  lower levels' probability maps re-warping the upper levels' neighbour
  features; V2Base without attention, V3 with ResnetBlocks and a
  direct-residual fuse.

V1 at ``n_scales == 1`` without ``stage3_prop`` runs its window attention
through ``ops/window_attn.window_attention``: the Hopper kernel on a CUDA
tensor at any feature size (the JAX guard ``pallas_corr.fits_vmem`` is a
TPU VMEM budget, so at the 512x1024 serving shape JAX takes its XLA
composition, which has the same numerics); the plain model
(``use_kernels=False``) runs ``window_attention_plain``.  The kernel has no
backward (nor has the JAX one), so where autograd needs stage 3's gradient
(grad enabled and the module's parameters requiring it) the attention runs
the plain composition of ``ops/window_attn``: a rule of the path, not a
fallback.  Every other route (``n_scales > 1``, ``stage3_prop``, the
pyramid) runs the plain ``ops/corr`` composition, as the JAX package does
(attn_refine.py:159-176).

Layers carry the reference's state_dict names (``port_ms_res_attn_refine``
and ``port_pyramid_attn``, tools/torch_port.py:174-193, :268-335).  V1's
``attn_fuse_layer`` runs only at ``n_scales > 1``; at one scale it keeps
its parameters as the reference module does (the JAX module never creates
them).  Every layer computes in ``dtype``; the parameters are f32 masters.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.models.blocks import (
    Conv,
    ConvT,
    ResnetBlock,
    conv_lrelu,
    needs_grad,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.corr import (
    argmax_flow,
    window_aggregate,
    window_aggregate_per_neighbor,
    window_correlation,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.resize import (
    avg_pool,
    interpolate_bilinear,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.window_attn import (
    window_attention,
    window_attention_plain,
)


def _seq(cin: int, couts: Sequence[int], stride: int = 1,
         dilations: Optional[Sequence[int]] = None, strides=None,
         resblocks: int = 0) -> nn.Sequential:
    """ConvLReLU layers to ``couts`` (the first of stride ``stride``, or the
    i-th of ``strides[i]``; the i-th of dilation ``dilations[i]``), then
    ``resblocks`` ResnetBlocks."""
    mods = []
    for i, cout in enumerate(couts):
        s = strides[i] if strides is not None else (stride if i == 0 else 1)
        mods += conv_lrelu(cin, cout, s, dilations[i] if dilations else 1)
        cin = cout
    mods += [ResnetBlock(cin) for _ in range(resblocks)]
    return nn.Sequential(*mods)


def _comb(img: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """The channel concat of an image and its seg, in their promoted dtype
    (as the JAX modules concatenate before resizing)."""
    dt = torch.promote_types(img.dtype, seg.dtype)
    return torch.cat([img.to(dt), seg.to(dt)], dim=-1)


def _up_ac(t: torch.Tensor, factor: float) -> torch.Tensor:
    return interpolate_bilinear(t, scale_factor=factor, align_corners=True)


def _corr_probmap(x, t_for, t_back, win_h: int, win_w: int, prop: bool,
                  upsample4: bool = False, prop_window=(3, 5)):
    """Cosine window correlation -> (prob_map, flow_map)
    (attn_refine.py:48-71): the flow is the first-max offset of the logits;
    ``upsample4`` upsamples the logits x4 (align_corners=True) before the
    softmax, ``prop`` smooths the probabilities by a count_include_pad=False
    average pool."""
    sim = window_correlation(x, [t_for, t_back], win_h, win_w)
    flow = argmax_flow(sim, 2, win_h, win_w)
    if upsample4:
        sim = _up_ac(sim, 4.0)
    prob = torch.softmax(sim, dim=-1)
    if prop:
        ph, pw = prop_window
        prob = avg_pool(prob, (ph, pw), ((ph // 2, ph // 2), (pw // 2, pw // 2)),
                        count_include_pad=False)
    return prob, flow


def _reuse_probmaps(feats: List[torch.Tensor], prob_maps: List[torch.Tensor],
                    win_h: int, win_w: int) -> List[torch.Tensor]:
    """Re-warp the neighbour features by every earlier (coarser) scale's
    probability map, upsampled to this scale, each renormalised per
    neighbour (attn_refine.py:150-157, :314-319)."""
    for k, prob in enumerate(prob_maps):
        low = _up_ac(prob, float(2 ** (len(prob_maps) - k)))
        feats = window_aggregate_per_neighbor(feats, low, win_h, win_w)
    return feats


class MSResAttnRefine(nn.Module):
    """``forward(coarse_img, coarse_seg, neighbors_img, neighbors_seg)``:
    (B,H,W,3), (B,H,W,20), (B,H,W,6), (B,H,W,40) -> (the per-scale rgb
    list, coarsest first, the last (B,H,W,3); the per-scale flow list, each
    (B,2,h/4,w/4,2), the flow's channels (dx, dy) per neighbour)."""

    def __init__(self, n_scales: int = 1, stage3_prop: bool = False,
                 win_h: int = 5, win_w: int = 9,
                 dtype: torch.dtype = torch.bfloat16,
                 use_kernels: bool = True):
        super().__init__()
        self.n_scales = n_scales
        self.stage3_prop = stage3_prop
        self.win = (win_h, win_w)
        self.dtype = dtype
        self.attention = window_attention if use_kernels else \
            window_attention_plain
        self.input_layer = _seq(23, (32, 64))
        self.attn_input_layer = _seq(64, (64, 64))
        self.attn_encoder_1 = _seq(64, (64, 64), stride=2)
        self.attn_encoder_2 = _seq(64, (128, 128), stride=2)
        self.attn_fuse_layer = _seq(128, (128, 128))
        self.attn_img_fuse_layer = _seq(256, (128, 128))
        self.img_input_layer = _seq(192, (64, 64))
        self.img_encoder_1 = _seq(64, (64, 64), stride=2)
        self.img_encoder_2 = _seq(64, (128, 128), stride=2)
        self.img_atrous_layer = _seq(128, (128,) * 4, dilations=(1, 2, 4, 8))
        self.img_fuse_layer = _seq(256, (128, 128))
        self.decoder_2 = nn.Sequential(ConvT(128, 64), nn.LeakyReLU(0.2),
                                       ResnetBlock(64))
        self.decoder_1 = nn.Sequential(ConvT(64, 64), nn.LeakyReLU(0.2),
                                       ResnetBlock(64))
        self.output_layer = nn.Sequential(*conv_lrelu(64, 64),
                                          *conv_lrelu(64, 32), Conv(32, 3, 3))

    def _attn_features(self, x: torch.Tensor) -> torch.Tensor:
        return self.attn_encoder_2(self.attn_encoder_1(self.attn_input_layer(x)))

    def forward(self, coarse_img: torch.Tensor, coarse_seg: torch.Tensor,
                neighbors_img: torch.Tensor, neighbors_seg: torch.Tensor
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        combs = (_comb(coarse_img, coarse_seg),
                 _comb(neighbors_img[..., :3], neighbors_seg[..., :20]),
                 _comb(neighbors_img[..., 3:6], neighbors_seg[..., 20:40]))
        fused_route = self.n_scales == 1 and not self.stage3_prop
        # the kernel has no backward: under autograd the plain composition
        attention = window_attention_plain if needs_grad(self) else \
            self.attention
        prob_maps: List[torch.Tensor] = []
        flow_maps: List[torch.Tensor] = []
        outputs: List[torch.Tensor] = []
        for scale_idx in range(self.n_scales - 1, -1, -1):
            scale = 1.0 / (2 ** scale_idx)
            x_in, f_in, b_in = (
                self.input_layer((t if scale == 1.0 else _up_ac(t, scale)
                                  ).to(self.dtype)) for t in combs)
            x_e2, f_e2, b_e2 = map(self._attn_features, (x_in, f_in, b_in))
            f_w, b_w = f_e2, b_e2
            if scale_idx != self.n_scales - 1:     # not the coarsest scale
                f_w, b_w = _reuse_probmaps([f_w, b_w], prob_maps, *self.win)
                f_w, b_w = self.attn_fuse_layer(f_w), self.attn_fuse_layer(b_w)
            if fused_route:
                # one attention over both neighbours' windows: keys and
                # values are the same features here (attn_refine.py:159-176)
                agg, flow4 = attention(x_e2, f_w, b_w, f_e2, b_e2, *self.win)
                flow_maps.append(torch.stack([flow4[..., 0:2],
                                              flow4[..., 2:4]], dim=1))
            else:
                prob, flow = _corr_probmap(x_e2, f_w, b_w, *self.win,
                                           self.stage3_prop)
                prob_maps.append(prob)
                flow_maps.append(flow)
                agg = window_aggregate([f_e2, b_e2], prob, *self.win)
            attn_fused = self.attn_img_fuse_layer(torch.cat([x_e2, agg],
                                                            dim=-1))
            im = self.img_input_layer(torch.cat([x_in, f_in, b_in], dim=-1))
            im1 = self.img_encoder_1(im)
            atrous = self.img_atrous_layer(self.img_encoder_2(im1))
            fused = self.img_fuse_layer(torch.cat([atrous, attn_fused],
                                                  dim=-1))
            d2 = self.decoder_2(fused)
            d1 = self.decoder_1(d2 + im1)
            outputs.append(self.output_layer(d1 + im))
        return outputs, flow_maps


class _Deconv(nn.Sequential):
    """``decoder_layer_k``: ConvT x2 + lrelu, a ConvLReLU, then a ConvLReLU
    (V2, V2Base) or two ResnetBlocks (V3) (attn_refine.py:262-275)."""

    def __init__(self, cin: int, ch: int, res: bool):
        tail = ([ResnetBlock(ch), ResnetBlock(ch)] if res
                else list(conv_lrelu(ch, ch)))
        super().__init__(ConvT(cin, ch), nn.LeakyReLU(0.2),
                         *conv_lrelu(ch, ch), *tail)


class _Out(nn.Sequential):
    """``out_layer_k``: two ConvLReLUs (V2, V2Base) or a ConvLReLU and two
    ResnetBlocks (V3), then the 3-channel conv at index 4
    (attn_refine.py:280-291)."""

    def __init__(self, cin: int, chs: Tuple[int, int], res: bool):
        if res:
            body = [*conv_lrelu(cin, chs[1]), ResnetBlock(chs[1]),
                    ResnetBlock(chs[1])]
        else:
            body = [*conv_lrelu(cin, chs[0]), *conv_lrelu(chs[0], chs[1])]
        super().__init__(*body, Conv(chs[1], 3, 3))


class PyramidAttnRefine(nn.Module):
    """The 3-level skeleton of V2, V2Base and V3 (``variant`` "v2",
    "v2base" or "v3").  ``forward`` takes V1's arguments and returns (the
    three levels' rgb, coarsest (H/4) first, the last (B,H,W,3); the three
    levels' flows, each (B,2,h/4,w/4,2) at its level's h, or None for
    V2Base)."""

    def __init__(self, variant: str = "v2", stage3_prop: bool = False,
                 win: int = 5, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if variant not in ("v2", "v2base", "v3"):
            raise KeyError(variant)
        self.variant = variant
        self.stage3_prop = stage3_prop
        self.win = win
        self.dtype = dtype
        res = variant == "v3"
        nres = 2 if res else 0
        self.input_layer = _seq(23, (32, 32), resblocks=nres)
        self.encoder_layer_1 = _seq(32, (32,) if res else (32, 32),
                                    resblocks=nres)
        self.encoder_layer_2 = _seq(32, (64, 64) if res else (64, 64, 64),
                                    stride=2, resblocks=nres)
        self.encoder_layer_3 = _seq(64, (128, 128) if res else (128,) * 3,
                                    stride=2, resblocks=nres)
        if variant != "v2base":
            for k, cin, c1, c2 in ((1, 32, 64, 128), (2, 64, 128, 256),
                                     (3, 128, 256, 512)):
                setattr(self, f"attn_down_layer_{k}",
                        _seq(cin, (c1, c2, c2), strides=(2, 2, 1)))
        self.layer_1_neighbor_tf = _seq(32, (32, 32), resblocks=nres)
        self.layer_2_neighbor_tf = _seq(64, (64, 64), resblocks=nres)
        self.layer_3_fuse = _seq(256, (256, 128), resblocks=nres)
        if not res:
            self.layer_2_fuse = _seq(128, (128, 64))
            self.layer_1_fuse = _seq(64, (64, 32))
        self.decoder_layer_3 = _Deconv(128, 64, res)
        self.decoder_layer_2 = _Deconv(64, 32, res)
        self.out_layer_3 = _Out(128, (128, 64), res)
        self.out_layer_2 = _Out(64, (64, 32), res)
        self.out_layer_1 = _Out(32, (32, 32), res)

    def _pyramid(self, t: torch.Tensor) -> List[torch.Tensor]:
        """[e3 (H/4, 128), e2 (H/2, 64), e1 (H, 32)], coarse to fine."""
        e1 = self.encoder_layer_1(self.input_layer(t.to(self.dtype)))
        e2 = self.encoder_layer_2(e1)
        return [self.encoder_layer_3(e2), e2, e1]

    def forward(self, coarse_img: torch.Tensor, coarse_seg: torch.Tensor,
                neighbors_img: torch.Tensor, neighbors_seg: torch.Tensor):
        v = self.variant
        x_f = self._pyramid(_comb(coarse_img, coarse_seg))
        f_f = self._pyramid(_comb(neighbors_img[..., :3],
                                  neighbors_seg[..., :20]))
        b_f = self._pyramid(_comb(neighbors_img[..., 3:6],
                                  neighbors_seg[..., 20:40]))
        if v != "v2base":
            downs = [self.attn_down_layer_3, self.attn_down_layer_2,
                     self.attn_down_layer_1]
        tfs = [None, self.layer_2_neighbor_tf, self.layer_1_neighbor_tf]
        fuses = [self.layer_3_fuse] + ([None, None] if v == "v3" else
                                       [self.layer_2_fuse, self.layer_1_fuse])
        decs = [self.decoder_layer_3, self.decoder_layer_2]
        outs = [self.out_layer_3, self.out_layer_2, self.out_layer_1]
        prob_maps: List[torch.Tensor] = []
        flow_maps: List[torch.Tensor] = []
        outputs: List[torch.Tensor] = []
        fused_prev = None
        for i in range(3):
            f_i, b_i = f_f[i], b_f[i]
            if v != "v2base":
                f_i, b_i = _reuse_probmaps([f_i, b_i], prob_maps, self.win,
                                           self.win)
            if i != 0:
                f_i, b_i = tfs[i](f_i), tfs[i](b_i)
            if v == "v2base":
                fused = fuses[i](torch.cat([x_f[i], f_i + b_i], dim=-1))
            else:
                prob, flow = _corr_probmap(
                    downs[i](x_f[i]), downs[i](f_i), downs[i](b_i), self.win,
                    self.win, self.stage3_prop, upsample4=True,
                    prop_window=(3, 3))
                prob_maps.append(prob)
                flow_maps.append(flow)
                agg = window_aggregate([f_i, b_i], prob, self.win, self.win)
                fused = agg if v == "v3" and i != 0 else fuses[i](
                    torch.cat([x_f[i], agg], dim=-1))
            if i != 0:
                fused = fused + fused_prev
            if i != 2:
                fused_prev = decs[i](fused)
            outputs.append(outs[i](fused))
        return outputs, (None if v == "v2base" else flow_maps)

