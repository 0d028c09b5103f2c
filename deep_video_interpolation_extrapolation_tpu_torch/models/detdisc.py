"""Object-centric (detection-box) discriminators (counterpart of
models/detdisc.py; the reference's nets/DetDisc.py), the thirteen classes
of the JAX registry: ``FrameDetDiscriminator``, ``FrameSNDetDiscriminator``,
``FrameLSSNDetDiscriminator``, ``VideoDetDiscriminator``,
``VideoSNDetDiscriminator``, ``VideoLSSNDetDiscriminator``,
``VideoVecSNDetDiscriminator``, ``VideoPoolSNDetDiscriminator``,
``VideoGlobalZeroSNDetDiscriminator``, ``VideoGlobalMaskSNDetDiscriminator``,
``VideoGlobalCoordSNDetDiscriminator``, ``VideoGlobalResSNDetDiscriminator``
and ``VideoLocalPatchSNDetDiscriminator``.

Most crop per-track patches with ``ops/roi.crop_resize`` (64x64, one
bilinear gather over the (B, T) box grid), score them as one (B*T, 64,
64, C) conv batch, and average the scores over the tracks: (B,) logits.
The Global variants score the full frames, zeroed outside each track's
box (GlobalZero, GlobalRes) or the ground truth with the box's pixels
swapped for the prediction and the masks as channels (GlobalMask, which
takes ``gt_x``).
Boxes are (B, 3 frames, T tracks, 4) (y1, x1, y2, x2) pixel coordinates,
or (B, 3, T, 5) with a leading score, which the LS video variant uses as
the per-track weight.  ``sync_neg`` (the video variants) pairs each
track's mid-frame box with another track's: an offset in [1, T) per (batch,
track) drawn from the caller's ``generator`` (the JAX ``sync_neg`` rng),
or a roll by one without it, as the JAX module without the rng.

VecSN and PoolSN embed the rgb of each patch on its own and compare the
three (by an MLP, or by SN convs on the channel concat); their sync_neg
pass flips the mid patch upside down (detdisc.py:367, :395) in place of
swapping boxes.  Each container keeps its children's flax names (``names``
of ``discriminators.Seq``; ``fc.k`` and ``fc_bn.k`` are VecSN's
``Dense_k`` and ``BatchNorm_k``), which ``tools/jax_weights`` maps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.models.blocks import (
    lrelu,
)
from deep_video_interpolation_extrapolation_tpu_torch.models.discriminators import (
    Seq,
    SNResBlock,
    image_channels,
    scalar_head,
)
from deep_video_interpolation_extrapolation_tpu_torch.models.subnets import (
    BatchNorm,
    Dense,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.roi import (
    crop_resize,
)
from deep_video_interpolation_extrapolation_tpu_torch.parallel import dist

PATCH = 64


def _split_video_inputs(x, seg, input_x, input_seg, seg_disc: bool):
    """(forward, current, backward) full images, with their segs under
    ``seg_disc`` (detdisc.py:57-66)."""
    if seg_disc:
        cur = torch.cat([x, seg], dim=-1)
        fwd = torch.cat([input_x[..., :3], input_seg[..., :20]], dim=-1)
        back = torch.cat([input_x[..., 3:6], input_seg[..., 20:40]], dim=-1)
        return fwd, cur, back
    return input_x[..., :3], x, input_x[..., 3:6]


def _boxes_yx(bboxes: torch.Tensor
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(B,3,T,4) or (B,3,T,5) -> ((B,3,T,4) boxes, scores or None)."""
    if bboxes.shape[-1] == 5:
        return bboxes[..., 1:], bboxes[..., 0]
    return bboxes, None


def _sync_neg_boxes(mid_boxes: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Each track's mid-frame box replaced by another track's
    (detdisc.py:76-86): offsets in [1, T) from ``generator``, else 1."""
    b, t, _ = mid_boxes.shape
    if t == 1:
        return mid_boxes
    if generator is not None:
        off = dist.global_draw(
            lambda s: torch.randint(1, t, s, generator=generator,
                                    device=generator.device),
            (b, t)).to(mid_boxes.device)
    else:
        off = torch.ones((b, t), dtype=torch.long, device=mid_boxes.device)
    idx = (torch.arange(t, device=mid_boxes.device)[None, :] + off) % t
    return torch.gather(mid_boxes, 1, idx[..., None].expand(-1, -1, 4))


def _track_mean(scores: torch.Tensor, b: int, t: int,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    s = scores.reshape(b, t)
    if weights is not None:
        w = weights / torch.clamp(weights.sum(1, keepdim=True), min=1e-12)
        return (s.float() * w.float()).sum(1)
    return s.float().mean(1).to(s.dtype)


def _flatten_tracks(patches: torch.Tensor) -> torch.Tensor:
    return patches.reshape((-1,) + tuple(patches.shape[2:]))


class PatchTower(Seq):
    """16-16 / 32-32 / 64-64 / 96-96 patch scorer, a conv to 1 channel and
    the mean (``_PatchTower``, detdisc.py:116-135): BatchNorm in the plain
    variant, SN without BN in the SN one."""

    def __init__(self, cin: int, sn: bool):
        super().__init__()
        bn = not sn
        c = self.block(cin, 16, sn=sn)
        c = self.block(c, 16, sn=sn, bn=bn)
        for ch in (32, 64, 96):
            c = self.block(c, ch, stride=2, sn=sn, bn=bn)
            c = self.block(c, ch, sn=sn, bn=bn)
        self.block(c, 1, sn=sn, act=False)

    def forward(self, p, train, dtype):
        return scalar_head(super().forward(p, train, dtype))


class DeepSNTower(Seq):
    """The 64..256 deep SN tower of the LS variants (``_DeepSNTower``,
    detdisc.py:138-162)."""

    def __init__(self, cin: int):
        super().__init__()
        c = self.block(cin, 64, sn=True)
        for _ in range(3):
            c = self.block(c, 64, sn=True)
        for ch in (128, 256, 256):
            c = self.block(c, ch, stride=2, sn=True)
            for _ in range(2):
                c = self.block(c, ch, sn=True)
        c = self.block(c, 64, sn=True)
        self.block(c, 1, sn=True, act=False)

    def forward(self, p, train, dtype):
        return scalar_head(super().forward(p, train, dtype))


def _mask_from_boxes(boxes: torch.Tensor, h: int, w: int,
                     dtype) -> torch.Tensor:
    """(B, T, 4) boxes -> (B, T, H, W, 1) {0, 1} masks, inclusive bounds
    (``_mask_from_boxes``)."""
    dev = boxes.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    y1, x1, y2, x2 = (t[..., None, None] for t in boxes.float().unbind(-1))
    m = (ys >= y1) & (ys <= y2) & (xs >= x1) & (xs <= x2)
    return m.to(dtype)[..., None]


class GlobalSNTower(Seq):
    """The full-image 5x5 SN tower of the Global variants
    (``_GlobalSNTower``, detdisc.py:165-186)."""

    def __init__(self, cin: int):
        super().__init__()
        c = cin
        for _ in range(3):
            c = self.block(c, 16, 5, sn=True)
        for ch in (32, 64, 128):
            c = self.block(c, ch, 5, stride=2, sn=True)
            for _ in range(2):
                c = self.block(c, ch, 5, sn=True)
        c = self.block(c, 128, stride=2, sn=True)
        for _ in range(6):
            c = self.block(c, 128, sn=True)
        self.block(c, 1, sn=True, act=False)

    def forward(self, p, train, dtype):
        return scalar_head(super().forward(p, train, dtype))


class _DetDisc(torch.nn.Module):
    """A tower named as its flax child (``tower_name``; None where its
    layers are the discriminator's own children)."""
    wants_gt = False      # GlobalMask and LocalPatch take the ground truth

    def __init__(self, tower: Seq, tower_name: str, seg_disc: bool, dtype):
        super().__init__()
        self.tower, self.tower_name = tower, tower_name
        self.seg_disc, self.dtype = seg_disc, dtype


class FrameDetDiscriminator(_DetDisc):
    """Mid-frame box patches -> patch tower -> track mean
    (detdisc.py:201-215): ``forward(x, seg=None, bboxes=None,
    train=False)``."""
    sn = False

    def __init__(self, seg_disc: bool = False, dtype=None):
        super().__init__(PatchTower(image_channels(seg_disc), self.sn),
                         "_PatchTower_0", seg_disc, dtype)

    def forward(self, x, seg=None, bboxes=None, train: bool = False):
        inp = torch.cat([x, seg], -1) if self.seg_disc else x
        boxes, _ = _boxes_yx(bboxes)
        mid = boxes[:, 1]
        b, t = mid.shape[:2]
        s = self.tower(_flatten_tracks(crop_resize(inp, mid, (PATCH, PATCH))),
                       train, self.dtype)
        return _track_mean(s, b, t)


class FrameSNDetDiscriminator(FrameDetDiscriminator):
    sn = True


class FrameLSSNDetDiscriminator(FrameDetDiscriminator):
    """The deep-SN frame variant (detdisc.py:223-236)."""

    def __init__(self, seg_disc: bool = False, dtype=None):
        _DetDisc.__init__(self, DeepSNTower(image_channels(seg_disc)),
                          "_DeepSNTower_0", seg_disc, dtype)


class VideoDetDiscriminator(_DetDisc):
    """(forward, current, backward) patches concatenated on channels ->
    patch tower -> track mean (detdisc.py:260-271): ``forward(x, seg,
    input_x, input_seg, bboxes, sync_neg=False, train=False,
    generator=None)``."""
    sn = False
    supports_sync_neg = True
    weighted = False

    def __init__(self, seg_disc: bool = False, dtype=None):
        super().__init__(PatchTower(3 * image_channels(seg_disc), self.sn),
                         "_PatchTower_0", seg_disc, dtype)

    def forward(self, x, seg=None, input_x=None, input_seg=None,
                bboxes=None, sync_neg: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None):
        return self._score(*_split_video_inputs(x, seg, input_x, input_seg,
                                                self.seg_disc),
                           bboxes, sync_neg, train, generator)

    def _score(self, fwd, cur, back, bboxes, sync_neg, train, generator):
        """The three frames' patches at their boxes (the mid ones swapped
        by sync_neg), side by side, through the tower; the track mean."""
        boxes, scores = _boxes_yx(bboxes)
        mid = boxes[:, 1]
        if sync_neg:
            mid = _sync_neg_boxes(mid, generator)
        comb = torch.cat([crop_resize(fwd, boxes[:, 0], (PATCH, PATCH)),
                          crop_resize(cur, mid, (PATCH, PATCH)),
                          crop_resize(back, boxes[:, 2], (PATCH, PATCH))],
                         dim=-1)
        b, t = comb.shape[:2]
        s = self.tower(_flatten_tracks(comb), train, self.dtype)
        w = scores[:, 1] if self.weighted and scores is not None else None
        return _track_mean(s, b, t, weights=w)


class VideoSNDetDiscriminator(VideoDetDiscriminator):
    sn = True


class VideoLSSNDetDiscriminator(VideoDetDiscriminator):
    """The deep-SN triple tower with per-track score weights
    (detdisc.py:278-292)."""
    weighted = True

    def __init__(self, seg_disc: bool = False, dtype=None):
        _DetDisc.__init__(self, DeepSNTower(3 * image_channels(seg_disc)),
                          "_DeepSNTower_0", seg_disc, dtype)


class VideoLocalPatchSNDetDiscriminator(VideoDetDiscriminator):
    """RGB-only patch triples through the SN patch tower, weighted by the
    track scores (detdisc.py:477-496); takes (and ignores) ``gt_x``, and
    leaves out the seg maps even under ``seg_disc``."""
    sn = True
    weighted = True
    wants_gt = True

    def __init__(self, seg_disc: bool = False, dtype=None):
        _DetDisc.__init__(self, PatchTower(9, sn=True), "_PatchTower_0",
                          False, dtype)

    def forward(self, *args, gt_x=None, **kwargs):
        return super().forward(*args, **kwargs)


class _PatchEmbed(_DetDisc):
    """The rgb of each (for, cur, back) patch embedded on its own: 16-16,
    then (32, 64, 96, 128) each stride 2 then 1, all but the first conv with
    BatchNorm (detdisc.py:371-375, :398-402); the triples as one (B*T*3,
    64, 64, 3) batch.  ``n_embed`` blocks of ``tower`` embed, the rest
    compare."""
    supports_sync_neg = True

    def __init__(self, dtype):
        super().__init__(Seq(), None, False, dtype)
        t = self.tower
        c = t.block(3, 16)
        c = t.block(c, 16, bn=True)
        for ch in (32, 64, 96, 128):
            c = t.block(c, ch, stride=2, bn=True)
            c = t.block(c, ch, bn=True)
        self.n_embed = len(t.layers)

    def _embed(self, x, seg, input_x, input_seg, bboxes, sync_neg, train):
        fwd, cur, back = input_x[..., :3], x[..., :3], input_x[..., 3:6]
        boxes, _ = _boxes_yx(bboxes)
        fp = crop_resize(fwd, boxes[:, 0], (PATCH, PATCH))
        cp = crop_resize(cur, boxes[:, 1], (PATCH, PATCH))
        bp = crop_resize(back, boxes[:, 2], (PATCH, PATCH))
        if sync_neg:
            cp = cp.flip(2)       # the mid patch upside down
        b, t = fp.shape[:2]
        p = torch.stack([fp, cp, bp], dim=2).reshape(
            (b * t * 3,) + tuple(fp.shape[2:]))
        for layer in self.tower.layers[:self.n_embed]:
            p = layer(p, train, self.dtype)
        return p, b, t


class VideoVecSNDetDiscriminator(_PatchEmbed):
    """Per-patch conv embedding (to 2x2x256) and a 1024-wide Dense, the
    triple's three embeddings concatenated through Dense 512 / 64 with
    BatchNorm and a Dense to the score (``VideoVecSNDetDiscriminator``,
    detdisc.py:356-384): ``forward`` as VideoDetDiscriminator's."""

    def __init__(self, seg_disc: bool = False, dtype=None):
        super().__init__(dtype)
        t = self.tower
        t.block(128, 256, stride=2, bn=True)
        t.block(256, 256, act=False)
        self.fc = nn.ModuleList([Dense(4 * 256, 1024), Dense(3 * 1024, 512),
                                 Dense(512, 64), Dense(64, 1)])
        self.fc_bn = nn.ModuleList([BatchNorm(512), BatchNorm(64)])

    def forward(self, x, seg=None, input_x=None, input_seg=None,
                bboxes=None, sync_neg: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None):
        dt = self.dtype
        p, b, t = self._embed(x, seg, input_x, input_seg, bboxes, sync_neg,
                              train)
        for layer in self.tower.layers[self.n_embed:]:
            p = layer(p, train, dt)
        feat = self.fc[0](p.reshape(b * t * 3, -1), dt)
        h = feat.reshape(b * t, 3 * feat.shape[-1])
        for dense, bn in zip(self.fc[1:3], self.fc_bn):
            h = lrelu(bn(dense(h, dt), train, dt))
        return _track_mean(self.fc[3](h, dt)[:, 0], b, t)


class VideoPoolSNDetDiscriminator(_PatchEmbed):
    """Per-patch conv features (4x4x128), the triple's three maps
    concatenated on channels through SN convs 256 / 128 / 64 / 1 and the
    mean (``VideoPoolSNDetDiscriminator``, detdisc.py:387-414)."""

    def __init__(self, seg_disc: bool = False, dtype=None):
        super().__init__(dtype)
        c = 3 * 128
        for ch in (256, 128, 64):
            c = self.tower.block(c, ch, sn=True)
        self.tower.block(c, 1, sn=True, act=False)

    def forward(self, x, seg=None, input_x=None, input_seg=None,
                bboxes=None, sync_neg: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None):
        p, b, t = self._embed(x, seg, input_x, input_seg, bboxes, sync_neg,
                              train)
        ph, pw, pc = p.shape[1:]
        g = p.reshape(b * t, 3, ph, pw, pc)
        h = torch.cat([g[:, 0], g[:, 1], g[:, 2]], dim=-1)
        for layer in self.tower.layers[self.n_embed:]:
            h = layer(h, train, self.dtype)
        return _track_mean(scalar_head(h), b, t)


class _GlobalDetDisc(_DetDisc):
    """The (for, cur, back) full frames and each track's box masks of the
    Global variants: ``_masks`` gives the frames and the (B, T, H, W, 1)
    masks of the three frames' boxes (the mid ones swapped by sync_neg)."""
    supports_sync_neg = True

    def _masks(self, x, seg, input_x, input_seg, bboxes, sync_neg,
               generator):
        fwd, cur, back = _split_video_inputs(x, seg, input_x, input_seg,
                                             self.seg_disc)
        boxes, _ = _boxes_yx(bboxes)
        mid = boxes[:, 1]
        if sync_neg:
            mid = _sync_neg_boxes(mid, generator)
        h, w = x.shape[1:3]
        masks = [_mask_from_boxes(bx, h, w, x.dtype)
                 for bx in (boxes[:, 0], mid, boxes[:, 2])]
        return (fwd, cur, back), masks

    def _zeroed(self, *args):
        """The three frames zeroed outside each track's box, side by side:
        (B*T, H, W, 3C)."""
        frames, masks = self._masks(*args)
        return _flatten_tracks(torch.cat(
            [f[:, None] * m for f, m in zip(frames, masks)], dim=-1))


class VideoGlobalZeroSNDetDiscriminator(_GlobalDetDisc):
    """Full frames zeroed outside each track's box through the global SN
    tower (detdisc.py:417-439)."""

    def __init__(self, seg_disc: bool = False, dtype=None):
        super().__init__(GlobalSNTower(3 * image_channels(seg_disc)),
                         "_GlobalSNTower_0", seg_disc, dtype)

    def forward(self, x, seg=None, input_x=None, input_seg=None,
                bboxes=None, sync_neg: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None):
        comb = self._zeroed(x, seg, input_x, input_seg, bboxes, sync_neg,
                            generator)
        b, t = x.shape[0], bboxes.shape[2]
        return _track_mean(self.tower(comb, train, self.dtype), b, t)


class VideoGlobalMaskSNDetDiscriminator(_GlobalDetDisc):
    """The ground truth with each track's box swapped for the prediction,
    and the frames beside it, each with its box mask as a channel, through
    the global SN tower (detdisc.py:442-477).  ``gt_x`` is the base (zeros
    without it), zero-padded to the prediction's channels."""
    wants_gt = True

    def __init__(self, seg_disc: bool = False, dtype=None):
        super().__init__(GlobalSNTower(3 * (image_channels(seg_disc) + 1)),
                         "_GlobalSNTower_0", seg_disc, dtype)

    def forward(self, x, seg=None, input_x=None, input_seg=None,
                bboxes=None, sync_neg: bool = False, gt_x=None,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        (fwd, cur, back), (fm, cm, bm) = self._masks(
            x, seg, input_x, input_seg, bboxes, sync_neg, generator)
        base = gt_x if gt_x is not None else torch.zeros_like(cur)
        if base.shape[-1] != cur.shape[-1]:
            base = torch.cat([base, base.new_zeros(
                cur.shape[:-1] + (cur.shape[-1] - base.shape[-1],))], -1)
        swap = base[:, None] * (1 - cm) + cur[:, None] * cm
        comb = torch.cat([
            torch.cat([fwd[:, None] * torch.ones_like(fm), fm], dim=-1),
            torch.cat([swap, cm], dim=-1),
            torch.cat([back[:, None] * torch.ones_like(bm), bm], dim=-1)],
            dim=-1)
        b, t = x.shape[0], bboxes.shape[2]
        return _track_mean(self.tower(_flatten_tracks(comb), train,
                                      self.dtype), b, t)


class VideoGlobalCoordSNDetDiscriminator(VideoDetDiscriminator):
    """Patch triples with two coordinate planes (linspace(-1, 1) down the
    rows, then across) through the deep SN tower, weighted by the track
    scores (detdisc.py:480-510)."""
    weighted = True

    def __init__(self, seg_disc: bool = False, dtype=None):
        _DetDisc.__init__(self, DeepSNTower(3 * (image_channels(seg_disc)
                                                 + 2)),
                          "_DeepSNTower_0", seg_disc, dtype)

    def forward(self, x, seg=None, input_x=None, input_seg=None,
                bboxes=None, sync_neg: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None):
        b, h, w = x.shape[:3]
        hs = torch.linspace(-1.0, 1.0, h, device=x.device).to(x.dtype)
        ws = torch.linspace(-1.0, 1.0, w, device=x.device).to(x.dtype)
        coord = torch.stack([hs[:, None].expand(h, w),
                             ws[None, :].expand(h, w)], -1)
        coord = coord[None].expand(b, h, w, 2)
        fwd, cur, back = _split_video_inputs(x, seg, input_x, input_seg,
                                             self.seg_disc)
        return self._score(torch.cat([coord, fwd], -1),
                           torch.cat([coord, cur], -1),
                           torch.cat([coord, back], -1), bboxes, sync_neg,
                           train, generator)


class VideoGlobalResSNDetDiscriminator(_GlobalDetDisc):
    """Full frames zeroed outside each track's box through SN residual
    blocks (64 x2, 128 x6, 256 x2, with strided SN convs between) and the
    mean (detdisc.py:513-536)."""

    def __init__(self, seg_disc: bool = False, dtype=None):
        tower = Seq()
        c = tower.block(3 * image_channels(seg_disc), 64, sn=True)
        for ch, n in ((64, 2), (128, 6), (256, 2)):
            if ch != 64:
                c = tower.block(c, ch, stride=2, sn=True)
            for _ in range(n):
                tower.add(SNResBlock(c, ch))
        tower.block(c, 1, sn=True, act=False)
        super().__init__(tower, None, seg_disc, dtype)

    def forward(self, x, seg=None, input_x=None, input_seg=None,
                bboxes=None, sync_neg: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None):
        comb = self._zeroed(x, seg, input_x, input_seg, bboxes, sync_neg,
                            generator)
        b, t = x.shape[0], bboxes.shape[2]
        return _track_mean(scalar_head(self.tower(comb, train, self.dtype)),
                           b, t)


CLASSES = {c.__name__: c for c in (
    FrameDetDiscriminator, FrameSNDetDiscriminator, FrameLSSNDetDiscriminator,
    VideoDetDiscriminator, VideoSNDetDiscriminator,
    VideoLSSNDetDiscriminator, VideoVecSNDetDiscriminator,
    VideoPoolSNDetDiscriminator, VideoGlobalZeroSNDetDiscriminator,
    VideoGlobalMaskSNDetDiscriminator, VideoGlobalCoordSNDetDiscriminator,
    VideoGlobalResSNDetDiscriminator, VideoLocalPatchSNDetDiscriminator)}
