"""Image/video preprocess + assembly tools of the port (counterpart of the
JAX package's ``tools/video_tools.py``; reference flow_process.py).

- ``resize_images``: batch-resize an image tree (flow_process.py:307-341;
  bilinear for rgb, nearest for seg-id maps like resize_segs:271-305);
- ``filter_clips_by_flow``: drop clips whose mean optical-flow magnitude is
  below a threshold (flow_process.py:52-76 'effective flow' filtering; the
  reference reads precomputed .flo files, we also accept a callable);
- ``imgs2vid``: assemble a PNG sequence into an .avi
  (flow_process.py:106-206);
- ``combine_grids``: tile (pred, gt) frame trees into a side-by-side
  comparison video (the combine_*_avi family, flow_process.py:405-596).

Pillow (resize) and OpenCV (flow, videos) are imported inside the functions
that need them; 8-bit gray and RGB PNGs are read by ``native/png.py``.

    python -m deep_video_interpolation_extrapolation_tpu_torch.tools.video_tools \
        resize|imgs2vid|cycgen_videos ...
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from deep_video_interpolation_extrapolation_tpu_torch.native import png


def _imread(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        _, _, ctype, depth, interlace = png.png_info(data)
        if ctype in png.CHANNELS and depth == 8 and interlace == 0:
            return png.decode_u8(data, png.CHANNELS[ctype])
    import io

    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(data)))


def resize_images(src_dir: str, dst_dir: str, size: Tuple[int, int],
                  nearest: bool = False, exts: Sequence[str] = (".png",)) -> int:
    """Recursively resize ``src_dir`` into ``dst_dir`` at (w, h).

    ``nearest=True`` for segmentation id maps (labels must not blend).
    Returns the number of files written.
    """
    from PIL import Image
    n = 0
    for root, _dirs, files in os.walk(src_dir):
        rel = os.path.relpath(root, src_dir)
        out_root = os.path.join(dst_dir, rel) if rel != "." else dst_dir
        os.makedirs(out_root, exist_ok=True)
        for name in files:
            if not name.lower().endswith(tuple(exts)):
                continue
            img = Image.open(os.path.join(root, name))
            resample = Image.NEAREST if nearest else Image.BILINEAR
            img.resize(size, resample).save(os.path.join(out_root, name))
            n += 1
    return n


def flow_magnitude(frame_a: np.ndarray, frame_b: np.ndarray) -> float:
    """Mean Farneback optical-flow magnitude between two RGB frames."""
    import cv2
    ga = cv2.cvtColor(frame_a, cv2.COLOR_RGB2GRAY)
    gb = cv2.cvtColor(frame_b, cv2.COLOR_RGB2GRAY)
    flow = cv2.calcOpticalFlowFarneback(
        ga, gb, None, 0.5, 3, 15, 3, 5, 1.2, 0)
    return float(np.mean(np.linalg.norm(flow, axis=-1)))


def filter_clips_by_flow(
    clip_file: str,
    save_name: str,
    frame_loader: Callable[[str], np.ndarray],
    min_mag: float = 1.0,
) -> Dict:
    """Keep clips whose first->last flow magnitude exceeds ``min_mag``
    ('effective flow' splits, the --ef flag's data)."""
    with open(clip_file, "rb") as f:
        clips_all = pickle.load(f)
    out: Dict[str, List] = {}
    for split, clips in clips_all.items():
        kept = []
        for clip in clips:
            a = frame_loader(clip[0])
            b = frame_loader(clip[-1])
            if flow_magnitude(a, b) >= min_mag:
                kept.append(clip)
        out[split] = kept
    with open(save_name, "wb") as f:
        pickle.dump(out, f)
    return out


def imgs2vid(png_dir: str, out_path: str, fps: int = 10,
             pattern: str = "*.png") -> int:
    """PNG sequence -> .avi (flow_process.py:106-206)."""
    import cv2
    files = sorted(glob.glob(os.path.join(png_dir, pattern)))
    if not files:
        return 0
    first = _imread(files[0])
    h, w = first.shape[:2]
    writer = cv2.VideoWriter(
        out_path, cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
    for f in files:
        img = _imread(f)
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        writer.write(img[..., ::-1])  # RGB -> BGR
    writer.release()
    return len(files)


def assemble_cycgen_videos(cycgen_root: str, fps: int = 10) -> int:
    """Turn a runner cycgen output tree into per-clip .avi files
    (rgb | seg_vis side-by-side), the reference's offline
    ``combine_inter_avi``/``imgs2vid`` workflow (flow_process.py:405-596).

    Returns the number of videos written (saved as ``<clip>/clip.avi``).
    """
    n = 0
    for clip_dir in sorted(glob.glob(os.path.join(cycgen_root, "clip_*"))):
        rgb_dir = os.path.join(clip_dir, "rgb")
        vis_dir = os.path.join(clip_dir, "seg_vis")
        if not os.path.isdir(rgb_dir):
            continue
        dirs = [rgb_dir] + ([vis_dir] if os.path.isdir(vis_dir) else [])
        if combine_grids(dirs, os.path.join(clip_dir, "clip.avi"), fps=fps):
            n += 1
    return n


def combine_grids(dirs: Sequence[str], out_path: str, fps: int = 10,
                  pattern: str = "*.png") -> int:
    """Horizontally tile same-named frames from several trees into one
    comparison video (pred | gt | ... )."""
    import cv2
    seqs = [sorted(glob.glob(os.path.join(d, pattern))) for d in dirs]
    n = min(len(s) for s in seqs)
    if n == 0:
        return 0
    first = np.concatenate([_imread(s[0]) for s in seqs], axis=1)
    h, w = first.shape[:2]
    writer = cv2.VideoWriter(
        out_path, cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
    for i in range(n):
        row = np.concatenate([_imread(s[i]) for s in seqs], axis=1)
        if row.ndim == 2:
            row = np.stack([row] * 3, -1)
        writer.write(row[..., ::-1])
    writer.release()
    return n


def main(argv=None):
    """CLI: resize trees / assemble videos (reference flow_process.py)."""
    import argparse
    p = argparse.ArgumentParser(description="image/video preprocess tools")
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("resize")
    r.add_argument("src_dir")
    r.add_argument("dst_dir")
    r.add_argument("--width", type=int, required=True)
    r.add_argument("--height", type=int, required=True)
    r.add_argument("--nearest", action="store_true")
    v = sub.add_parser("imgs2vid")
    v.add_argument("png_dir")
    v.add_argument("out_path")
    v.add_argument("--fps", type=int, default=10)
    c = sub.add_parser("cycgen_videos")
    c.add_argument("cycgen_root")
    c.add_argument("--fps", type=int, default=10)
    a = p.parse_args(argv)
    if a.cmd == "resize":
        n = resize_images(a.src_dir, a.dst_dir, (a.width, a.height), a.nearest)
        print(f"resized {n} images")
    elif a.cmd == "imgs2vid":
        print(f"wrote {imgs2vid(a.png_dir, a.out_path, a.fps)} frames")
    elif a.cmd == "cycgen_videos":
        print(f"wrote {assemble_cycgen_videos(a.cycgen_root, a.fps)} videos")


if __name__ == "__main__":
    main()
