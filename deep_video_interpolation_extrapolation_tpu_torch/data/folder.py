"""Cityscapes clip dataset and loader of the port (counterpart of the JAX
package's ``data/folder.py``: ``correlated_crop_params`` :67,
``ClipDataset`` :83 and ``Loader`` :413; reference folder.py:38-313).

Host-side numpy pipeline producing fixed-shape batches:

- 3-frame clips of rgb normalized to [-1, 1] ((v / 255) * 2 - 1,
  folder.py:187-191) and uint8 (H, W) seg class ids (the port's seg
  contract, ``core/seg.py``; the JAX ``ClipDataset(seg_ids=True)``);
- train-time correlated crop-motion augmentation: the per-frame crops drift
  linearly across the clip, simulating camera motion (folder.py:125-149,
  183-194), plus horizontal flip (folder.py:166-180), from the reference's
  150 px train and 128 px val source trees;
- bbox tracks: input pkl rows [score, x1, y1, x2, y2] at 1024x512 rescaled
  to image scale and converted to (y1, x1, y2, x2) (folder.py:108-123),
  crop/flip-adjusted and clamped, degenerate tracks dropped, missing tracks
  re-sampled by duplication, and clips with no usable track resampled
  (folder.py:219-276).

PNGs decode through ``native/png.py``.  Every random draw is the JAX
copy's, in the same order, so the two give the same batches bit for bit.
``TripletDataset`` (ucf101, vimeo) is not ported yet (ROADMAP.md queue 1,
item 4).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from deep_video_interpolation_extrapolation_tpu_torch.data.cityscapes import (
    IMG_EXT,
    N_CLASSES,
    SEG_EXT,
)
from deep_video_interpolation_extrapolation_tpu_torch.native import png

# (v / 255) * 2 - 1 in f32 for every byte value, as the JAX package's
# native decoder and its PIL branch compute it
_NORM = np.arange(256, dtype=np.float32) / np.float32(255.0) * np.float32(
    2.0) - np.float32(1.0)


def correlated_crop_params(rng: np.random.RandomState, src: int, crop: int):
    """Linear-drift crop offsets for a 3-frame clip (folder.py:125-149)."""
    margin = src - crop
    assert margin >= 0, (src, crop)
    if margin == 0:   # crop == source: no room to drift
        return 0, 0, 0
    interval = rng.randint(margin)
    direction = rng.randint(2)
    mid = rng.randint(interval // 2, margin - interval // 2)
    if direction == 1:
        first, last = mid - interval // 2, mid + interval // 2
    else:
        first, last = mid + interval // 2, mid - interval // 2
    return first, mid, last


class ClipDataset:
    """Fixed-shape clip sampler (reference ImageFolder/DatasetFolder)."""

    def __init__(
        self,
        cfg,
        clips: Sequence[Sequence[str]],
        bboxes: Optional[List] = None,
        split: str = "train",
        img_dir: Optional[str] = None,
        seg_dir: Optional[str] = None,
        src_size: Optional[int] = None,
    ):
        self.cfg = cfg
        self.clips = list(clips)
        self.split = split
        self.img_dir = img_dir or cfg.img_dir
        self.seg_dir = seg_dir or cfg.seg_dir
        # reference: 150px train source, 128px val source (folder.py:85-98)
        self.src_size = src_size or (150 if split == "train" else 128)
        self.vid_len = len(self.clips[0]) if self.clips else 3
        self.bboxes = self._convert(bboxes) if bboxes is not None else None

    def __len__(self):
        return len(self.clips)

    def _convert(self, clips_boxes):
        """Rescale 1024x512 [score,x1,y1,x2,y2] -> img-scale (y1,x1,y2,x2)
        keeping score (folder.py:108-123)."""
        out = []
        s = self.src_size
        for clip in clips_boxes:
            cb = []
            for frame in clip:
                fb = []
                for box in frame:
                    if box is None:
                        fb.append(None)
                        continue
                    score, x1, y1, x2, y2 = box
                    x1 = np.floor(x1 * s / 1024.0)
                    y1 = np.floor(y1 * s / 512.0)
                    x2 = np.floor(x2 * s / 1024.0)
                    y2 = np.floor(y2 * s / 512.0)
                    if y2 <= y1 or x2 <= x1:
                        fb.append(None)
                    else:
                        fb.append([score, y1, x1, y2, x2])
                cb.append(fb)
            out.append(cb)
        return out

    def sample(self, index: int, rng: np.random.RandomState) -> Dict[str, np.ndarray]:
        for _attempt in range(16):
            item = self._try_sample(index, rng)
            if item is not None:
                return item
            if len(self.clips) > 1:
                index = (index + rng.randint(1, len(self.clips))) % len(self.clips)
        raise RuntimeError("no clip with usable tracks after 16 resamples")

    @staticmethod
    def _check_ids(ids: np.ndarray) -> np.ndarray:
        """An id >= N_CLASSES raises rather than becoming an all-zero
        one-hot row on the device."""
        if ids.max(initial=0) >= N_CLASSES:
            raise IndexError(
                f"seg id {int(ids.max())} >= N_CLASSES ({N_CLASSES})")
        return np.ascontiguousarray(ids)

    def _try_sample(self, index, rng):
        cfg = self.cfg
        clip = self.clips[index]
        img_bytes = [
            open(os.path.join(self.img_dir, p + IMG_EXT), "rb").read()
            for p in clip
        ]
        seg_bytes = [
            open(os.path.join(self.seg_dir, p + SEG_EXT), "rb").read()
            for p in clip
        ]
        # header only: the pixels decode after the bbox validity check, so
        # a clip rejected for losing every track to the crop costs no
        # decode
        src_h, src_w = png.png_info(img_bytes[0])[:2]
        n_track = cfg.num_track_per_img
        if self.bboxes is not None:
            # _convert scales the pkl boxes by src_size and a flip reflects
            # about src_size - 1: the frames must be square src_size
            if not (src_h == src_w == self.src_size):
                raise ValueError(
                    f"bbox tracks need square {self.src_size}px frames, "
                    f"got {src_h}x{src_w} — pass the matching "
                    "--img_dir/--seg_dir tree or src_size")
            clip_boxes = [
                [None if b is None else list(b) for b in frame]
                for frame in self.bboxes[index]
            ]
        else:
            clip_boxes = None

        flip = rng.randint(0, 3) and self.split == "train"
        if flip:
            if clip_boxes is not None:
                w_last = self.src_size - 1
                for frame in clip_boxes:
                    for b in frame:
                        if b is not None:
                            b[2], b[4] = w_last - b[4], w_last - b[2]

        ch, cw = cfg.input_h, cfg.input_w
        if self.split == "train":
            hs = correlated_crop_params(rng, src_h, ch)
            ws = correlated_crop_params(rng, src_w, cw)
            crops = [(hs[i], ws[i]) for i in range(min(3, self.vid_len))]
            # clips longer than 3 frames continue the per-step drift,
            # clamped to the valid range
            while len(crops) < self.vid_len:
                (h2, w2), (h1, w1) = crops[-1], crops[-2]
                crops.append((
                    int(np.clip(2 * h2 - h1, 0, src_h - ch)),
                    int(np.clip(2 * w2 - w1, 0, src_w - cw)),
                ))
        else:
            crops = [(0, 0)] * self.vid_len

        # bbox adjust + validity filtering (folder.py:219-276); RNG draw
        # order: flip -> crops -> duplication
        if clip_boxes is not None:
            kept = [[], [], []]
            for j in range(min(n_track, len(clip_boxes[0]))):
                track = []
                ok = True
                for i in range(3):
                    b = clip_boxes[i][j]
                    if b is None:
                        ok = False
                        break
                    y0, x0 = crops[i] if self.split == "train" else (0, 0)
                    y1 = max(0.0, b[1] - y0)
                    y2 = min(ch - 1.0, b[3] - y0)
                    x1 = max(0.0, b[2] - x0)
                    x2 = min(cw - 1.0, b[4] - x0)
                    if y2 <= y1 or x2 <= x1:
                        ok = False
                        break
                    track.append([y1, x1, y2, x2])
                if ok:
                    for i in range(3):
                        kept[i].append(track[i])
            if len(kept[1]) == 0:
                return None
            while len(kept[1]) < n_track:
                k = rng.randint(len(kept[1]))
                for i in range(3):
                    kept[i].append(list(kept[i][k]))
            boxes = np.asarray(kept, np.float32)
        else:
            boxes = np.tile(
                np.array([0.0, 0.0, ch - 1.0, cw - 1.0], np.float32),
                (3, n_track, 1))

        out: Dict[str, np.ndarray] = {}
        for i in range(self.vid_len):
            y0, x0 = crops[i]
            rgb = png.decode_u8(img_bytes[i], 3)
            ids = png.decode_u8(seg_bytes[i], 1)
            if flip:
                rgb, ids = rgb[:, ::-1], ids[:, ::-1]
            out[f"frame{i + 1}"] = _NORM[rgb[y0:y0 + ch, x0:x0 + cw]]
            out[f"seg{i + 1}"] = self._check_ids(ids[y0:y0 + ch, x0:x0 + cw])
        out["bboxes"] = boxes
        return out


class Loader:
    """Epoch-seeded shuffling batcher (DistributedSampler.set_epoch
    semantics, runners/InterTrainer.py:117-120) with multi-worker
    prefetching (the reference's ``DataLoader(num_workers=args.nw)``,
    runners/InterTrainer.py:84-87).

    ``num_workers > 0`` decodes/augments samples on a thread pool while a
    producer thread assembles batches into a bounded queue (``prefetch``
    batches deep), overlapping host data work with device compute.
    Augmentation RNG is per-sample — seeded by (seed, epoch, position) —
    so the worker and sequential paths produce IDENTICAL batches and
    same-epoch iteration stays reproducible regardless of thread timing.
    """

    def __init__(self, dataset: ClipDataset, batch_size: int, seed: int = 0,
                 shuffle: bool = True, drop_last: bool = True,
                 num_workers: int = 0, prefetch: int = 2):
        self.ds = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_workers = int(num_workers)
        self.prefetch = max(int(prefetch), 1)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.ds) // self.batch_size
        if not self.drop_last and len(self.ds) % self.batch_size:
            n += 1
        return n

    def _sample_rng(self, pos: int) -> np.random.RandomState:
        # a (seed, epoch, position) stream that does not alias across
        # epochs
        ss = np.random.SeedSequence([self.seed, self.epoch, pos])
        return np.random.RandomState(ss.generate_state(4))

    def _order(self) -> np.ndarray:
        rng = np.random.RandomState(self.seed + self.epoch)
        return (rng.permutation(len(self.ds)) if self.shuffle
                else np.arange(len(self.ds)))

    def __iter__(self):
        order = self._order()
        nb = len(self)
        if self.num_workers <= 0:
            for bi in range(nb):
                idxs = order[bi * self.batch_size:(bi + 1) * self.batch_size]
                samples = [
                    self.ds.sample(int(i), self._sample_rng(
                        bi * self.batch_size + k))
                    for k, i in enumerate(idxs)
                ]
                yield {
                    k: np.stack([s[k] for s in samples]) for k in samples[0]
                }
            return
        yield from self._iter_workers(order, nb)

    def _iter_workers(self, order: np.ndarray, nb: int):
        import queue
        import threading
        from concurrent.futures import ThreadPoolExecutor

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_guarded(item) -> None:
            # every put respects `stop`: a blocking put would strand this
            # thread when the consumer abandons the iterator with the
            # bounded queue full
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        def produce(pool):
            try:
                # submit up to prefetch+1 batches of sample futures ahead
                pending = []
                bi_next = 0

                def submit(bi):
                    idxs = order[bi * self.batch_size:
                                 (bi + 1) * self.batch_size]
                    return [pool.submit(
                        self.ds.sample, int(i),
                        self._sample_rng(bi * self.batch_size + k))
                        for k, i in enumerate(idxs)]

                while bi_next < nb and len(pending) <= self.prefetch:
                    pending.append(submit(bi_next))
                    bi_next += 1
                while pending and not stop.is_set():
                    futs = pending.pop(0)
                    samples = [f.result() for f in futs]
                    batch = {k: np.stack([s[k] for s in samples])
                             for k in samples[0]}
                    if bi_next < nb:
                        pending.append(submit(bi_next))
                        bi_next += 1
                    put_guarded(batch)
            except Exception as e:  # surface worker errors to the consumer
                put_guarded(e)
                return
            put_guarded(None)

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            t = threading.Thread(target=produce, args=(pool,), daemon=True)
            t.start()
            try:
                while True:
                    item = q.get()
                    if item is None:
                        break
                    if isinstance(item, Exception):
                        raise item
                    yield item
            finally:
                stop.set()
