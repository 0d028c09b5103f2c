"""Clip/bbox split builders of the port (counterpart of the JAX package's
``tools/build_clips.py``; reference create_vid_file.py:63-758).

Offline, host-side, numpy/pickle only.  Produces the pickled artifacts the
data layer consumes:

- ``create_root_clip``: scan a Cityscapes sequence tree into 30-frame root
  clips per split (create_vid_file.py:63-92);
- ``create_pred_lsclip``: every length-``vid_len`` window with stride 1 and
  frame spacing ``interval`` (create_vid_file.py:151-167) — the file the
  active loaders read (named ``int_{i}_len_{n}_extra_lsclip.pkl``);
- ``create_interp_lsclip``: triplets ordered (first, last, middle)
  (create_vid_file.py:171-189; legacy ordering, kept verbatim);
- ``create_bbox_file`` / ``clean_bbox_file_max``: convert per-frame
  detection pickles (rows ``[score, x1, y1, x2, y2]`` at 1024x512) into
  per-clip track arrays, drop tracks below an area threshold, keep the
  top-``num_box`` by score (create_vid_file.py:192-439).

Reference deviations: no hard-coded ``/data/linz`` roots, no asserts on the
exact Cityscapes clip counts (any dataset layout with the same naming
works).
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from deep_video_interpolation_extrapolation_tpu_torch.data.cityscapes import (
    TRAIN_SCENES,
    VAL_SCENES,
)

SCENE_DICT = {"train": TRAIN_SCENES, "val": VAL_SCENES, "test": []}


def create_root_clip(load_dir: str, save_name: str,
                     tail: str = "leftImg8bit", ext: str = ".png",
                     clip_len: int = 30,
                     scene_dict: Optional[Dict[str, List[str]]] = None) -> Dict:
    """Group frames ``<scene>_<vid>_<frame>_<tail><ext>`` into fixed-length
    root clips per split."""
    scene_dict = scene_dict or SCENE_DICT
    clip_dict: Dict[str, List[List[str]]] = {}
    for split, scenes in scene_dict.items():
        clips: List[List[str]] = []
        for scene in scenes:
            files = sorted(glob.glob(
                os.path.join(load_dir, split, scene, f"*{tail}{ext}")))
            frames = []
            for f in files:
                parts = os.path.basename(f).split("_")
                frames.append((int(parts[1]), int(parts[2])))
            for vid_idx in sorted({t[0] for t in frames}):
                idxes = sorted(t[1] for t in frames if t[0] == vid_idx)
                for start in range(0, len(idxes) - clip_len + 1, clip_len):
                    clip = [
                        os.path.join(
                            split, scene,
                            f"{scene}_{vid_idx:06d}_{idxes[start + i]:06d}")
                        for i in range(clip_len)
                    ]
                    clips.append(clip)
        clip_dict[split] = clips
    with open(save_name, "wb") as f:
        pickle.dump(clip_dict, f)
    return clip_dict


def create_pred_lsclip(root_clip_file: str, save_name: str,
                       interval: int = 3, vid_len: int = 3) -> Dict:
    """Sliding windows [i, i+interval, ..., i+(vid_len-1)*interval]."""
    with open(root_clip_file, "rb") as f:
        root_clips = pickle.load(f)
    out: Dict[str, List[List[str]]] = {}
    for split, clips in root_clips.items():
        rows = []
        for rc in clips:
            last = interval * (vid_len - 1)
            for i in range(len(rc) - last):
                rows.append([rc[i + k * interval] for k in range(vid_len)])
        out[split] = rows
    with open(save_name, "wb") as f:
        pickle.dump(out, f)
    return out


def create_interp_lsclip(root_clip_file: str, save_name: str,
                         interval: int = 3) -> Dict:
    """Triplets ordered (first, last, middle) — the reference's interp
    ordering (create_vid_file.py:182)."""
    with open(root_clip_file, "rb") as f:
        root_clips = pickle.load(f)
    out: Dict[str, List[List[str]]] = {}
    for split, clips in root_clips.items():
        rows = []
        for rc in clips:
            for i in range(len(rc) - 2 * interval):
                rows.append([rc[i], rc[i + 2 * interval], rc[i + interval]])
        out[split] = rows
    with open(save_name, "wb") as f:
        pickle.dump(out, f)
    return out


def _box_area(box: Sequence[float]) -> float:
    # box = [score, x1, y1, x2, y2]
    return max(0.0, box[3] - box[1]) * max(0.0, box[4] - box[2])


def create_bbox_file(clip_file: str, bbox_src_dir: str, save_name: str) -> Dict:
    """Join per-frame detection pickles onto clips.

    Each frame's pickle (``<frame>.pkl`` under ``bbox_src_dir``) holds an
    (N, 5) float array of ``[score, x1, y1, x2, y2]`` rows at 1024x512.
    Output: {split: [ (3, N_i, 5) arrays aligned with the clip list ]}.
    Frames without detections get empty (0, 5) arrays.
    """
    with open(clip_file, "rb") as f:
        clips_all = pickle.load(f)
    out: Dict[str, List[np.ndarray]] = {}
    for split, clips in clips_all.items():
        rows = []
        for clip in clips:
            per_frame = []
            for frame in clip[:3]:
                p = os.path.join(bbox_src_dir, frame + ".pkl")
                if os.path.exists(p):
                    with open(p, "rb") as f:
                        per_frame.append(np.asarray(pickle.load(f), np.float32)
                                         .reshape(-1, 5))
                else:
                    per_frame.append(np.zeros((0, 5), np.float32))
            n = min(len(b) for b in per_frame)
            arr = np.stack([b[:n] for b in per_frame]) if n else np.zeros(
                (3, 0, 5), np.float32)
            rows.append(arr)
        out[split] = rows
    with open(save_name, "wb") as f:
        pickle.dump(out, f)
    return out


def clean_bbox_file_max(src_bbox_file: str, src_clip_file: str,
                        save_bbox_file: str, save_clip_file: str,
                        num_box: int = 8, area_thresh: float = 0.0) -> None:
    """Keep clips whose tracks pass the area threshold; cap tracks per clip
    at ``num_box`` by score (create_vid_file.py:355-439)."""
    with open(src_bbox_file, "rb") as f:
        bboxes_all = pickle.load(f)
    with open(src_clip_file, "rb") as f:
        clips_all = pickle.load(f)
    new_boxes: Dict[str, List[np.ndarray]] = {}
    new_clips: Dict[str, List[List[str]]] = {}
    for split in clips_all:
        nb, nc = [], []
        for clip, boxes in zip(clips_all[split], bboxes_all[split]):
            if boxes.shape[1] == 0:
                continue
            # a track passes if its box in EVERY frame clears the threshold
            ok = np.ones(boxes.shape[1], bool)
            for fidx in range(boxes.shape[0]):
                areas = np.array([_box_area(b) for b in boxes[fidx]])
                ok &= areas >= area_thresh
            if not ok.any():
                continue
            kept = boxes[:, ok]
            order = np.argsort(-kept[1, :, 0])[:num_box]  # mid-frame score
            nb.append(kept[:, order])
            nc.append(clip)
        new_boxes[split] = nb
        new_clips[split] = nc
    with open(save_bbox_file, "wb") as f:
        pickle.dump(new_boxes, f)
    with open(save_clip_file, "wb") as f:
        pickle.dump(new_clips, f)


def create_trackrcnn_track_pkl(clip_file: str, data_dir: str,
                               save_bbox_file: str, save_clip_file: str,
                               area_thresh: float = 0.0,
                               img_h: int = 512, img_w: int = 1024) -> Dict:
    """Convert TrackR-CNN per-frame track txts into per-clip bbox arrays
    (create_vid_file.py:701-748).

    Each frame has ``<frame>_leftImg8bit.txt`` under ``data_dir/<city>``
    holding one line of ``id,x1,y1,x2,y2`` entries joined by ``---``
    (track-consistent object order across the 3 frames).  Tracks whose
    MID-frame box area is <= ``area_thresh`` are dropped
    (create_vid_file.py:733-735); each kept box gets its area ratio
    prepended as the score column (create_vid_file.py:739).

    Reference deviation: the reference function builds the dicts but never
    pickles them (its save_pkl argument is unused — dead code); this writes
    both the bbox file and the filtered clip file in the same format
    ``create_bbox_file``/``clean_bbox_file_max`` produce, so the data layer
    can consume the result directly.
    """
    with open(clip_file, "rb") as f:
        clips_all = pickle.load(f)
    new_boxes: Dict[str, List[np.ndarray]] = {}
    new_clips: Dict[str, List[List[str]]] = {}
    for split, clips in clips_all.items():
        nb, nc = [], []
        for clip in clips:
            city = os.path.dirname(clip[1])
            per_frame = []
            ok = True
            for frame in clip[:3]:
                p = os.path.join(data_dir, city,
                                 os.path.basename(frame) + "_leftImg8bit.txt")
                if not os.path.exists(p):
                    ok = False
                    break
                with open(p) as f:
                    line = f.readline().strip()
                if not line:
                    ok = False
                    break
                boxes = []
                for obj in line.split("---"):
                    nums = list(map(int, obj.split(",")[1:]))
                    assert len(nums) == 4, obj
                    boxes.append(nums)
                per_frame.append(boxes)
            if not ok or not per_frame:
                continue
            n = min(len(b) for b in per_frame)
            keep = [j for j in range(n)
                    if _box_area([0.0] + per_frame[1][j]) > area_thresh]
            if not keep:
                continue
            arr = np.zeros((3, len(keep), 5), np.float32)
            for fi in range(3):
                for oi, j in enumerate(keep):
                    x1, y1, x2, y2 = per_frame[fi][j]
                    ratio = (x2 - x1) * (y2 - y1) / float(img_h * img_w)
                    arr[fi, oi] = [ratio, x1, y1, x2, y2]
            nb.append(arr)
            nc.append(clip)
        new_boxes[split] = nb
        new_clips[split] = nc
    with open(save_bbox_file, "wb") as f:
        pickle.dump(new_boxes, f)
    with open(save_clip_file, "wb") as f:
        pickle.dump(new_clips, f)
    return new_boxes


def main(argv=None):
    """CLI: mirrors running the reference's create_vid_file.py snippets.

        python -m deep_video_interpolation_extrapolation_tpu_torch.tools.build_clips \\
            root|pred|interp|clean_bbox|trackrcnn ...
    """
    import argparse
    p = argparse.ArgumentParser(description="clip/bbox split builders")
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("root")
    r.add_argument("load_dir")
    r.add_argument("save_name")
    r.add_argument("--clip_len", type=int, default=30)
    s = sub.add_parser("pred")
    s.add_argument("root_clip_file")
    s.add_argument("save_name")
    s.add_argument("--interval", type=int, default=3)
    s.add_argument("--vid_len", type=int, default=3)
    i = sub.add_parser("interp")
    i.add_argument("root_clip_file")
    i.add_argument("save_name")
    i.add_argument("--interval", type=int, default=3)
    c = sub.add_parser("clean_bbox")
    c.add_argument("src_bbox_file")
    c.add_argument("src_clip_file")
    c.add_argument("save_bbox_file")
    c.add_argument("save_clip_file")
    c.add_argument("--num_box", type=int, default=8)
    c.add_argument("--area_thresh", type=float, default=0.0)
    t = sub.add_parser("trackrcnn")
    t.add_argument("clip_file")
    t.add_argument("data_dir")
    t.add_argument("save_bbox_file")
    t.add_argument("save_clip_file")
    t.add_argument("--area_thresh", type=float, default=0.0)
    a = p.parse_args(argv)
    if a.cmd == "root":
        create_root_clip(a.load_dir, a.save_name, clip_len=a.clip_len)
    elif a.cmd == "pred":
        create_pred_lsclip(a.root_clip_file, a.save_name, a.interval, a.vid_len)
    elif a.cmd == "interp":
        create_interp_lsclip(a.root_clip_file, a.save_name, a.interval)
    elif a.cmd == "clean_bbox":
        clean_bbox_file_max(a.src_bbox_file, a.src_clip_file,
                            a.save_bbox_file, a.save_clip_file,
                            a.num_box, a.area_thresh)
    elif a.cmd == "trackrcnn":
        create_trackrcnn_track_pkl(a.clip_file, a.data_dir,
                                   a.save_bbox_file, a.save_clip_file,
                                   a.area_thresh)


if __name__ == "__main__":
    main()
