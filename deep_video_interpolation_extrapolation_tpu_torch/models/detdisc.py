"""Object-centric (detection-box) discriminators (counterpart of
models/detdisc.py; the reference's nets/DetDisc.py): the six classes that
recipe 4 and its neighbours run, ``FrameDetDiscriminator``,
``FrameSNDetDiscriminator``, ``FrameLSSNDetDiscriminator``,
``VideoDetDiscriminator``, ``VideoSNDetDiscriminator`` and
``VideoLSSNDetDiscriminator``.

Each crops per-track patches with ``ops/roi.crop_resize`` (64x64, one
bilinear gather over the (B, T) box grid), scores them as one (B*T, 64,
64, C) conv batch, and averages the scores over the tracks: (B,) logits.
Boxes are (B, 3 frames, T tracks, 4) (y1, x1, y2, x2) pixel coordinates,
or (B, 3, T, 5) with a leading score, which the LS video variant uses as
the per-track weight.  ``sync_neg`` (the video variants) pairs each
track's mid-frame box with another track's: an offset in [1, T) per (batch,
track) drawn from the caller's ``generator`` (the JAX ``sync_neg`` rng),
or a roll by one without it, as the JAX module without the rng.

The other video classes (``VecSN``, ``PoolSN``, ``GlobalZero``,
``GlobalMask``, ``GlobalCoord``, ``GlobalRes``, ``LocalPatchSN``) wait in
ROADMAP.md queue 1, item 5; the registry refuses them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deep_video_interpolation_extrapolation_tpu_torch.models.discriminators import (
    Seq,
    image_channels,
    scalar_head,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.roi import (
    crop_resize,
)

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
        off = torch.randint(1, t, (b, t), generator=generator,
                            device=generator.device).to(mid_boxes.device)
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


class _DetDisc(torch.nn.Module):
    """A tower named as its flax child (``tower_name``)."""

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
        fwd, cur, back = _split_video_inputs(x, seg, input_x, input_seg,
                                             self.seg_disc)
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


CLASSES = {c.__name__: c for c in (
    FrameDetDiscriminator, FrameSNDetDiscriminator, FrameLSSNDetDiscriminator,
    VideoDetDiscriminator, VideoSNDetDiscriminator,
    VideoLSSNDetDiscriminator)}
# the JAX registry's other names (detdisc.py:499-526)
NOT_PORTED = ("VideoVecSNDetDiscriminator", "VideoPoolSNDetDiscriminator",
              "VideoGlobalZeroSNDetDiscriminator",
              "VideoGlobalMaskSNDetDiscriminator",
              "VideoGlobalCoordSNDetDiscriminator",
              "VideoGlobalResSNDetDiscriminator",
              "VideoLocalPatchSNDetDiscriminator")
