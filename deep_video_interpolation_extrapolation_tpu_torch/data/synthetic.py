"""Synthetic clip data for tests and benchmarks (a copy of the JAX
package's ``data/synthetic.py``).

Batches have the structure the Cityscapes pipeline emits (reference
folder.py:277-290): ``frame{i}`` in [-1,1] NHWC rgb, ``bboxes`` (3,
n_track, 4) valid boxes, and ``seg{i}`` as uint8 (B, H, W) class ids, the
port's seg contract (``core/seg.py``), not the JAX copy's f32 one-hots.
The numpy draws are the JAX copy's, in the same order from the same seed,
so the ids are the argmax of its one-hots.  Deterministic per (seed,
index).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def synthetic_batch(
    batch_size: int,
    h: int,
    w: int,
    vid_len: int = 3,
    n_track: int = 4,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    batch: Dict[str, np.ndarray] = {}
    base = rng.uniform(-1, 1, (batch_size, h, w, 3)).astype(np.float32)
    drift = rng.uniform(-0.05, 0.05, (batch_size, 1, 1, 3)).astype(np.float32)
    for i in range(vid_len):
        batch[f"frame{i + 1}"] = np.clip(base + i * drift, -1, 1)
        batch[f"seg{i + 1}"] = rng.randint(0, 20, (batch_size, h, w)).astype(
            np.uint8)
    boxes = np.zeros((batch_size, 3, n_track, 4), np.float32)
    for b in range(batch_size):
        for f in range(3):
            for t in range(n_track):
                y1 = rng.randint(0, max(1, h - 9))
                x1 = rng.randint(0, max(1, w - 9))
                hh = rng.randint(4, min(h - y1, max(5, h // 3)))
                ww = rng.randint(4, min(w - x1, max(5, w // 3)))
                boxes[b, f, t] = (y1, x1, y1 + hh, x1 + ww)
    batch["bboxes"] = boxes
    return batch


class SyntheticClipDataset:
    """Iterable of synthetic batches with the real pipeline's interface."""

    def __init__(self, cfg, batch_size: int, num_batches: int = 8,
                 vid_len: int = 3):
        self.cfg = cfg
        self.batch_size = batch_size
        self.num_batches = num_batches
        self.vid_len = vid_len
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.num_batches

    def __iter__(self):
        for i in range(self.num_batches):
            yield synthetic_batch(
                self.batch_size, self.cfg.input_h, self.cfg.input_w,
                vid_len=self.vid_len, n_track=self.cfg.num_track_per_img,
                seed=self.cfg.seed + self.epoch * 10007 + i)
