"""Object-track generators (counterpart of models/trackgen.py; the
reference's nets/TrackGen.py): ``TrackGen`` and ``TrackGenV2``, the
``--track_gen`` branch of InterGANNet.

Per track, the forward and backward frames' boxes are cropped to 64x64
(``ops/roi.crop_resize``, rgb and seg), a patch U-Net decodes them, and its
features are pasted back at the mid frame's box (``ops/roi.paste_patches``)
into one canvas per track; a fusion head takes the canvases, the coarse
rgb and seg and the union of the boxes to the refined rgb and seg.
TrackGenV2 adds coordinate planes to the patches and regresses the mid
box from two extra decoder channels (a location map): the features are
pasted at that box, its gradient stopped.

Boxes are (B, 3, N, 4) (y1, x1, y2, x2) pixel coordinates, inclusive, the
frame axis (for, mid, back).  The modules carry the reference's
``state_dict`` names (``encoder_1.0``, ..., ``up_4.0``, ``decoder_1.4``,
``track_fusion_layer.0``, ``fusion_layer.0``, ``rgb_out_layer.0``, ...),
which ``tools/jax_weights.trackgen_key_map`` maps to the JAX tree.  Every
conv runs in ``dtype`` (``F.conv2d``; the JAX package leaves them to XLA).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.models.blocks import (
    Conv,
    ConvT,
    lrelu0,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.roi import (
    crop_resize,
    paste_patches,
)

PATCH = 64
FEAT = 32          # the U-Net's output features per track


class _ConvStack(nn.Sequential):
    """3x3 convs, each followed by an lrelu but the last when ``linear_last``
    (the reference's ``nn.Sequential`` of conv and LeakyReLU entries, so the
    convs keep their indices 0, 2, 4, ...)."""

    def __init__(self, cin: int, widths, stride: int = 1,
                 linear_last: bool = False):
        mods = []
        for i, cout in enumerate(widths):
            mods.append(Conv(cin, cout, 3, stride=stride if i == 0 else 1))
            if not (linear_last and i == len(widths) - 1):
                mods.append(nn.LeakyReLU(0.2))
            cin = cout
        super().__init__(*mods)
        self.linear_last = linear_last

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        convs = [m for m in self if isinstance(m, Conv)]
        for i, conv in enumerate(convs):
            x = conv(x, dtype)
            if not (self.linear_last and i == len(convs) - 1):
                x = lrelu0(x)
        return x


class _TrackModel(nn.Module):
    """The patch U-Net (``_TrackUNet``, trackgen.py:37-76) and the fusion
    head (``_FusionHead``, :79-95) under the reference's names; V2's last
    decoder conv is linear with 2 more channels (the location map)."""

    def __init__(self, cin: int, num_track: int, out_extra: int,
                 dtype: torch.dtype):
        super().__init__()
        self.num_track, self.dtype = num_track, dtype
        self.encoder_1 = _ConvStack(cin, (32, 32, 32))
        self.encoder_2 = _ConvStack(32, (64, 64, 64), stride=2)
        self.encoder_3 = _ConvStack(64, (128, 128, 128), stride=2)
        self.encoder_4 = _ConvStack(128, (128, 128, 128), stride=2)
        self.bottom_layer = _ConvStack(128, (256, 256, 256), stride=2)
        self.up_4 = nn.Sequential(ConvT(256, 128))
        self.decoder_4 = _ConvStack(256, (128, 128, 128))
        self.up_3 = nn.Sequential(ConvT(128, 128))
        self.decoder_3 = _ConvStack(256, (128, 128, 128))
        self.up_2 = nn.Sequential(ConvT(128, 64))
        self.decoder_2 = _ConvStack(128, (64, 64, 64))
        self.up_1 = nn.Sequential(ConvT(64, 32))
        self.decoder_1 = _ConvStack(64, (32, 32, FEAT + out_extra),
                                    linear_last=bool(out_extra))
        self.track_fusion_layer = _ConvStack(num_track * FEAT, (128, 64, 32),
                                             linear_last=True)
        self.fusion_layer = _ConvStack(32 + 3 + 20 + 1, (48, 48, 32, 32, 32))
        self.rgb_out_layer = _ConvStack(32, (32, 3), linear_last=True)
        self.seg_out_layer = _ConvStack(32, (32, 20), linear_last=True)

    def unet(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        e1 = self.encoder_1(x, dt)
        e2 = self.encoder_2(e1, dt)
        e3 = self.encoder_3(e2, dt)
        e4 = self.encoder_4(e3, dt)
        h = self.bottom_layer(e4, dt)
        for up, dec, skip in ((self.up_4, self.decoder_4, e4),
                              (self.up_3, self.decoder_3, e3),
                              (self.up_2, self.decoder_2, e2)):
            h = dec(torch.cat([lrelu0(up[0](h.to(dt))), skip], dim=-1), dt)
        h = torch.cat([lrelu0(self.up_1[0](h)), e1], dim=-1)
        return self.decoder_1(h, dt)

    def head(self, feats: torch.Tensor, boxes: torch.Tensor,
             coarse_rgb: torch.Tensor, coarse_seg: torch.Tensor):
        """Each track's features pasted at its box into a canvas of its own,
        the canvases side by side (N * 32 channels), through the fusion
        head with the coarse outputs and the union of the boxes."""
        dt = self.dtype
        b, h, w = coarse_rgb.shape[:3]
        canvas = feats.new_zeros((b, h, w, feats.shape[-1]))
        track_feats = torch.cat([
            paste_patches(canvas, feats[:, k:k + 1], boxes[:, k:k + 1])
            for k in range(self.num_track)], dim=-1)
        x = self.track_fusion_layer(track_feats, dt)
        x = torch.cat([x, coarse_rgb.to(dt), coarse_seg.to(dt),
                       box_mask(h, w, boxes).to(dt)], dim=-1)
        x = self.fusion_layer(x, dt)
        return self.rgb_out_layer(x, dt), self.seg_out_layer(x, dt)


def box_mask(h: int, w: int, boxes: torch.Tensor) -> torch.Tensor:
    """(B, N, 4) -> (B, H, W, 1) f32 mask of the union of the boxes
    (``_box_mask``)."""
    dev = boxes.device
    ii = torch.arange(h, dtype=torch.float32, device=dev)[None, None, :, None]
    jj = torch.arange(w, dtype=torch.float32, device=dev)[None, None, None, :]
    y1, x1, y2, x2 = (t[..., None, None] for t in boxes.float().unbind(-1))
    inside = (ii >= y1) & (ii <= y2) & (jj >= x1) & (jj <= x2)
    return inside.any(dim=1).float()[..., None]


def split_frames(rgb: torch.Tensor, seg: torch.Tensor):
    """(B,H,W,6) + (B,H,W,40) -> the forward and backward frames, rgb and
    seg side by side (23 channels each) (``_split_frames``)."""
    return (torch.cat([rgb[..., :3], seg[..., :20]], dim=-1),
            torch.cat([rgb[..., 3:6], seg[..., 20:40]], dim=-1))


def crop_tracks(for_img, back_img, boxes) -> torch.Tensor:
    """The (for, back) patches of every track: (B, N, 64, 64, 2C)."""
    return torch.cat([crop_resize(for_img, boxes[:, 0], (PATCH, PATCH)),
                      crop_resize(back_img, boxes[:, 2], (PATCH, PATCH))],
                     dim=-1)


class TrackGen(_TrackModel):
    """The track branch on the ground-truth mid boxes (trackgen.py:111-146):
    ``forward(rgb, seg, coarse_rgb, coarse_seg, boxes)`` -> (rgb_out,
    seg_out, None, zero aux loss)."""

    def __init__(self, num_track: int = 4, dtype=torch.bfloat16):
        super().__init__(46, num_track, 0, dtype)

    def forward(self, rgb, seg, coarse_rgb, coarse_seg, boxes,
                gt_bbox_for_loss: bool = False):
        b, n = rgb.shape[0], self.num_track
        patches = crop_tracks(*split_frames(rgb, seg), boxes)
        feats = self.unet(patches.reshape(b * n, PATCH, PATCH, -1))
        rgb_out, seg_out = self.head(feats.reshape(b, n, PATCH, PATCH, -1),
                                     boxes[:, 1], coarse_rgb, coarse_seg)
        return rgb_out, seg_out, None, torch.zeros((), device=rgb.device)


def coord_planes(b: int, h: int, w: int, dtype, device) -> torch.Tensor:
    """(B, H, W, 2): linspace(-1, 1) down the rows, then across the
    columns."""
    ys = torch.linspace(-1.0, 1.0, h, device=device)
    xs = torch.linspace(-1.0, 1.0, w, device=device)
    coord = torch.stack([ys[:, None].expand(h, w), xs[None, :].expand(h, w)],
                        dim=-1)
    return coord[None].expand(b, h, w, 2).to(dtype)


class TrackGenV2(_TrackModel):
    """The track branch that predicts the mid box (trackgen.py:149-229):
    ``forward(rgb, seg, coarse_rgb, coarse_seg, boxes, gt_bbox_for_loss=
    False)`` -> (rgb_out, seg_out, gen_boxes (B, N, 4), aux_loss).  The
    patches carry two coordinate planes; the decoder's first two channels
    are a location map whose mean is the box centre and whose edge rows and
    columns give its extent.  aux_loss is the L1 of the location map
    against the coordinate planes cropped at the ground-truth mid box
    (``gt_bbox_for_loss``, as the GAN step asks), else the range term."""

    def __init__(self, num_track: int = 4, dtype=torch.bfloat16):
        super().__init__(50, num_track, 2, dtype)

    def forward(self, rgb, seg, coarse_rgb, coarse_seg, boxes,
                gt_bbox_for_loss: bool = False):
        b, h, w, _ = rgb.shape
        n = self.num_track
        coord = coord_planes(b, h, w, rgb.dtype, rgb.device)
        for_img, back_img = split_frames(rgb, seg)
        patches = crop_tracks(torch.cat([coord, for_img], dim=-1),
                              torch.cat([coord, back_img], dim=-1), boxes)
        out = self.unet(patches.reshape(b * n, PATCH, PATCH, -1))

        loc_ori = out[..., :2]
        loc = torch.clamp(loc_ori, -1, 1)
        center = loc.mean(dim=(1, 2))                        # (B*N, 2) (y, x)
        hrange = loc[:, -1, :, 0].mean(1) - loc[:, 0, :, 0].mean(1)
        wrange = loc[:, :, -1, 1].mean(1) - loc[:, :, 0, 1].mean(1)
        loc_range_loss = ((2 - hrange) + (2 - wrange)).mean()
        hrange, wrange = torch.relu(hrange), torch.relu(wrange)
        y1 = torch.clamp((center[:, 0] - hrange / 2 + 1) / 2 * h, 0, h - 1)
        y2 = torch.clamp((center[:, 0] + hrange / 2 + 1) / 2 * h, 0, h - 1)
        x1 = torch.clamp((center[:, 1] - wrange / 2 + 1) / 2 * w, 0, w - 1)
        x2 = torch.clamp((center[:, 1] + wrange / 2 + 1) / 2 * w, 0, w - 1)
        gen_boxes = torch.stack([y1, x1, y2, x2], dim=-1).reshape(b, n, 4)

        if gt_bbox_for_loss:
            gt_coord = crop_resize(coord, boxes[:, 1], (PATCH, PATCH))
            aux_loss = (gt_coord.reshape(b * n, PATCH, PATCH, 2).float()
                        - loc_ori.float()).abs().mean()
        else:
            aux_loss = loc_range_loss
        feats = out[..., 2:].reshape(b, n, PATCH, PATCH, -1)
        rgb_out, seg_out = self.head(feats, gen_boxes.detach(), coarse_rgb,
                                     coarse_seg)
        return rgb_out, seg_out, gen_boxes, aux_loss


CLASSES = {"TrackGen": TrackGen, "TrackGenV2": TrackGenV2}


def build(name: str, num_track: int, dtype: Optional[torch.dtype]):
    return CLASSES[name](num_track=num_track, dtype=dtype)
