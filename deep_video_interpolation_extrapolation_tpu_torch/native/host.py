"""The fused PNG path of the port's loaders (counterpart of the JAX
package's ``native/host.py``: ``decode_rgb_norm`` :148 in its modes 0 and 1,
and ``decode_seg_onehot`` :164).

``decode_rgb_norm`` and ``decode_seg_ids`` decode one frame of an 8-bit,
non-interlaced gray or RGB PNG, flipped left to right or not, and cropped:

- ``native/png.inflate_rows`` checks the CRC of every chunk it reads and
  inflates the image data with the standard library's ``zlib`` only down to
  the crop's last row;
- ``dvie_host.cpp`` unfilters those rows (all five filter types), flips,
  crops and writes the caller's array: f32 rgb in [-1, 1] through ``NORM``,
  or uint8 class ids; an id of 20 or more raises an ``IndexError`` (it
  has no one-hot row), as the JAX loader's ``np.eye`` gather does.

No libpng: the library is built from ``dvie_host.cpp`` alone, by ``g++ -O2
-shared -fPIC`` at first use, into the package's ``_build/`` directory,
keyed by a hash of the source and flags, and loaded by ``ctypes``.  A failed
build raises with the compiler's output.  ``DVIE_NATIVE_LOADER=0`` (read
at every call) takes the zlib + numpy decoder of ``native/png.py`` instead,
on the same rows; a PNG of another format (palette, alpha, 16-bit,
interlaced) goes through ``png.decode_u8`` (Pillow where it can be
imported).  ``counts`` records which of the three decoded each frame.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from deep_video_interpolation_extrapolation_tpu_torch.data.cityscapes import (
    N_CLASSES,
)
from deep_video_interpolation_extrapolation_tpu_torch.native import png

SRC = Path(__file__).resolve().parent / "dvie_host.cpp"
BUILD = SRC.parent.parent / "_build"
FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

# (v / 255) * 2 - 1 in f32 for every byte value, as the JAX package's
# native decoder and its PIL branch compute it; the same values as its
# Triplet mode's (v / 255 - 0.5) / 0.5, since halving and doubling are exact
NORM = np.arange(256, dtype=np.float32) / np.float32(255.0) * np.float32(
    2.0) - np.float32(1.0)

# frames decoded by the fused path, by the numpy decoder
# (DVIE_NATIVE_LOADER=0) and by png.decode_u8 (other formats)
counts = {"fused": 0, "numpy": 0, "other": 0}
_count_lock = threading.Lock()
_build_lock = threading.Lock()

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
_i32 = ctypes.c_int32
# raw, raw_len, h, w, channels, y0, x0, ch, cw, flip, ...
_ROWS = [ctypes.c_char_p, ctypes.c_size_t] + [_i32] * 8


def enabled() -> bool:
    return os.environ.get("DVIE_NATIVE_LOADER", "1") != "0"


def reset_counts() -> None:
    with _count_lock:
        for k in counts:
            counts[k] = 0


def _count(kind: str) -> None:
    with _count_lock:
        counts[kind] += 1


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD / f"libdvie_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``dvie_host.cpp`` unless a library of the same source and
    flags exists; the output is renamed into place, so processes building
    at once each finish with a whole file."""
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                               f"{SRC.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded host library (built on first call; one per process: the
    loader's worker threads may ask for it at once)."""
    with _build_lock:
        path = build()
    lib = ctypes.CDLL(str(path))
    lib.dvie_rows_rgb_norm.argtypes = _ROWS + [_f32p, _f32p]
    lib.dvie_rows_rgb_norm.restype = ctypes.c_int
    lib.dvie_rows_u8.argtypes = _ROWS + [_u8p]
    lib.dvie_rows_u8.restype = ctypes.c_int
    lib.dvie_host_abi_version.restype = ctypes.c_int
    if lib.dvie_host_abi_version() != 1:
        raise RuntimeError(f"{lib._name}: unexpected ABI version")
    return lib


_ERRORS = {1: "image data shorter than its rows, or a bad row filter type",
           2: "channels must be 1 or 3", 4: "crop outside the image"}


def _fused_format(buf: bytes) -> int:
    """The channels of a PNG the fused path reads (8-bit, non-interlaced
    gray or RGB), else 0."""
    _, _, ctype, depth, interlace = png.png_info(buf)
    if depth != 8 or interlace != 0 or ctype not in png.CHANNELS:
        return 0
    return png.CHANNELS[ctype]


def _rows(fn, buf, channels, y0, x0, ch, cw, flip, *tail) -> None:
    h, w = png.png_info(buf)[:2]
    if y0 < 0 or x0 < 0 or ch <= 0 or cw <= 0 or y0 + ch > h or x0 + cw > w:
        raise ValueError(f"crop ({y0}, {x0}, {ch}, {cw}) outside a {h}x{w} "
                         "image")
    raw = png.inflate_rows(buf, y0 + ch)
    rc = fn(raw, len(raw), h, w, channels, y0, x0, ch, cw, int(bool(flip)),
            *tail)
    if rc:
        raise ValueError(f"fused PNG decode: {_ERRORS.get(rc, rc)}")


def _crop(arr: np.ndarray, y0, x0, ch, cw, flip) -> np.ndarray:
    if flip:
        arr = arr[:, ::-1]
    return np.ascontiguousarray(arr[y0:y0 + ch, x0:x0 + cw])


def decode_rgb_norm(buf: bytes, y0: int, x0: int, ch: int, cw: int,
                    flip: bool) -> np.ndarray:
    """Decode, flip, crop and normalize -> float32 (ch, cw, 3) in [-1, 1]; a
    gray PNG gives its value to all three channels."""
    channels = _fused_format(buf)
    if not enabled():
        _count("numpy")
        rgb = png.decode_crop(buf, channels or 3, y0, x0, ch, cw, flip)
        return NORM[rgb if rgb.ndim == 3 else rgb[..., None].repeat(3, -1)]
    if not channels:
        _count("other")
        return NORM[_crop(png.decode_u8(buf, 3), y0, x0, ch, cw, flip)]
    out = np.empty((ch, cw, 3), np.float32)
    _rows(library().dvie_rows_rgb_norm, buf, channels, y0, x0, ch, cw, flip,
          NORM.ctypes.data_as(_f32p), out.ctypes.data_as(_f32p))
    _count("fused")
    return out


def decode_seg_ids(buf: bytes, y0: int, x0: int, ch: int, cw: int,
                   flip: bool) -> np.ndarray:
    """Decode, flip and crop a gray id map -> uint8 (ch, cw); an id >=
    N_CLASSES raises an ``IndexError`` (a one-hot has no row for it)."""
    if not enabled():
        _count("numpy")
        ids = png.decode_crop(buf, 1, y0, x0, ch, cw, flip)
    elif _fused_format(buf) != 1:
        _count("other")
        ids = _crop(png.decode_u8(buf, 1), y0, x0, ch, cw, flip)
    else:
        ids = np.empty((ch, cw), np.uint8)
        _rows(library().dvie_rows_u8, buf, 1, y0, x0, ch, cw, flip,
              ids.ctypes.data_as(_u8p))
        _count("fused")
    if ids.max(initial=0) >= N_CLASSES:
        raise IndexError(
            f"seg id {int(ids.max())} >= N_CLASSES ({N_CLASSES})")
    return ids
