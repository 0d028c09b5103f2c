"""PNG input and output of the port, on the standard library's ``zlib`` and
numpy: no Pillow, no libpng (counterpart of the JAX package's
``native/host.py`` ``encode_png`` :184, ``save_png`` :213 and
``decode_u8`` :224).

- ``encode_png`` writes 8-bit gray (H, W) or RGB (H, W, 3) ``uint8``
  arrays, every row with filter 0, one IDAT chunk;
- ``decode_u8`` reads 8-bit, non-interlaced gray and RGB PNGs with any of
  the five row filters (0-4), checking every chunk's CRC, and refuses any
  other format (palette, alpha, 16-bit, interlaced) with a ``ValueError``
  naming it.  Where Pillow can be imported it decodes through Pillow
  instead, as the JAX package's ``data/folder.py`` does (``convert("RGB")``
  or ``convert("L")``); a test holds the two decoders to the same pixels.

Filters 0-2 reconstruct a row with numpy; the Average and Paeth filters
(3, 4) depend on the pixel to the left, so those rows run a Python loop
over their bytes (slower, and never written by ``encode_png``).

``inflate_rows`` inflates the image data only down to a given row and
stops reading there (the loaders' crops need no row below their last);
``decode_crop`` is the zlib + numpy decoder on those rows, with the flip
and the crop, the reference the fused path of ``native/host.py`` is held
to and the decoder it hands over to under ``DVIE_NATIVE_LOADER=0``.
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2}          # channels -> PNG color type (gray, RGB)
CHANNELS = {0: 1, 2: 3}             # PNG color type -> channels
_FORMAT_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha",
                 6: "RGBA"}

_pil = None                          # the PIL.Image module, False if absent


def _pil_image():
    global _pil
    if _pil is None:
        try:
            from PIL import Image
            _pil = Image
        except ImportError:
            _pil = False
    return _pil or None


def pil_available() -> bool:
    return _pil_image() is not None


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray, level: int = 1) -> bytes:
    """uint8 (H, W) gray or (H, W, 3) RGB -> PNG bytes.  ``level`` is the
    zlib effort (1, the fastest, by default; PNG is lossless at every
    level)."""
    arr = np.asarray(arr)
    channels = 1 if arr.ndim == 2 else (arr.shape[2] if arr.ndim == 3 else 0)
    if arr.dtype != np.uint8 or channels not in _COLOR_TYPE:
        raise ValueError(f"encode_png takes uint8 (H, W) or (H, W, 3), got "
                         f"{arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    raw = np.zeros((h, 1 + w * channels), np.uint8)      # filter byte 0
    raw[:, 1:] = arr.reshape(h, w * channels)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[channels], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def save_png(path: str, arr: np.ndarray, level: int = 1) -> None:
    """Write a uint8 gray or RGB array as a PNG file."""
    data = encode_png(arr, level)
    with open(path, "wb") as f:
        f.write(data)


def _chunks(buf: bytes):
    if buf[:8] != _SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(buf):
        n, tag = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", buf[pos + 8 + n:pos + 12 + n])
        if len(data) != n or zlib.crc32(tag + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {tag!r}: truncated or bad CRC")
        yield tag, data
        if tag == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG file ends before its IEND chunk")


def png_info(buf: bytes) -> Tuple[int, int, int, int, int]:
    """(h, w, color_type, bit_depth, interlace) from the IHDR chunk."""
    tag, data = next(_chunks(buf))
    if tag != b"IHDR" or len(data) != 13:
        raise ValueError("PNG file does not start with an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", data)
    return h, w, ctype, depth, interlace


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(h, 1 + stride)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:      # Sub: a running sum per channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:      # Up
            cur = line + prev
        elif kind in (3, 4):
            cur = np.asarray(_unfilter_left(int(kind), line.tolist(),
                                            prev.tolist(), bpp), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {int(kind)}")
        out[y] = cur
        prev = out[y]
    return out


def _unfilter_left(kind: int, line, prev, bpp: int):
    """Average (3) and Paeth (4): each byte depends on the reconstructed
    byte ``bpp`` to its left."""
    cur = list(line)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = prev[i - bpp] if i >= bpp else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[i] = (cur[i] + pred) & 0xFF
    return cur


def check_format(buf: bytes, channels: int) -> Tuple[int, int]:
    """(h, w) of an 8-bit non-interlaced PNG of ``channels`` (1 gray, 3
    RGB); a ``ValueError`` naming the format for any other."""
    h, w, ctype, depth, interlace = png_info(buf)
    want = _COLOR_TYPE[channels]
    if ctype != want or depth != 8 or interlace != 0:
        raise ValueError(
            f"PNG is {depth}-bit {_FORMAT_NAMES.get(ctype, ctype)}"
            f"{', interlaced' if interlace else ''}; this decoder reads "
            f"8-bit non-interlaced {_FORMAT_NAMES[want]} only")
    return h, w


def inflate_rows(buf: bytes, rows: int) -> bytes:
    """The inflated image data of rows [0, ``rows``) of an 8-bit gray or RGB
    PNG: each row its filter byte, then its pixels.  Below the last image
    row the IDAT chunks are inflated only until those rows are out, and the
    chunks after it are not read; every chunk read has its CRC checked.
    All rows: the whole stream, which must end where the image does."""
    h, w, ctype, _, _ = png_info(buf)
    size = rows * (1 + w * CHANNELS[ctype])
    d = zlib.decompressobj()
    parts, got = [], 0
    for tag, data in _chunks(buf):
        if tag != b"IDAT":
            continue
        # below the last row, stop at the crop's: max_length keeps the rest
        # of the stream in the decompressor, never inflated
        piece = d.decompress(data) if rows >= h else d.decompress(
            data, size - got)
        parts.append(piece)
        got += len(piece)
        if rows < h and got == size:
            break
    if got != size or (rows >= h and not d.eof):
        raise ValueError(f"PNG image data holds {got} bytes of {h} rows, "
                         f"expected {size}{'' if d.eof else ' (truncated)'}")
    return b"".join(parts)


def decode_crop(buf: bytes, channels: int, y0: int, x0: int, ch: int,
                cw: int, flip: bool) -> np.ndarray:
    """The zlib + numpy decoder down to the crop's last row: uint8 (ch, cw)
    or (ch, cw, 3) of the image flipped left to right (if ``flip``), then
    cropped at (y0, x0)."""
    h, w = check_format(buf, channels)
    if y0 < 0 or x0 < 0 or ch <= 0 or cw <= 0 or y0 + ch > h or x0 + cw > w:
        raise ValueError(f"crop ({y0}, {x0}, {ch}, {cw}) outside a {h}x{w} "
                         "image")
    rows = y0 + ch
    raw = np.frombuffer(inflate_rows(buf, rows), np.uint8)
    out = _unfilter(raw, rows, w * channels, channels)
    out = out.reshape((rows, w, 3) if channels == 3 else (rows, w))
    if flip:
        out = out[:, ::-1]
    return np.ascontiguousarray(out[y0:, x0:x0 + cw])


def decode_png(buf: bytes, channels: int) -> np.ndarray:
    """The zlib + numpy decoder: 8-bit non-interlaced gray (``channels``
    1) or RGB (3) -> uint8 (H, W) or (H, W, 3)."""
    h, w = check_format(buf, channels)
    return decode_crop(buf, channels, 0, 0, h, w, False)


def decode_u8(buf: bytes, channels: int,
              use_pil: Optional[bool] = None) -> np.ndarray:
    """PNG bytes -> uint8 (H, W) (``channels`` 1) or (H, W, 3) (3), through
    Pillow where it can be imported (``use_pil`` None) or as asked."""
    if channels not in _COLOR_TYPE:
        raise ValueError(f"channels must be 1 or 3, got {channels}")
    image = _pil_image() if use_pil is None or use_pil else None
    if use_pil and image is None:
        raise ImportError("Pillow is not installed")
    if image is not None:
        mode = "RGB" if channels == 3 else "L"
        return np.array(image.open(io.BytesIO(buf)).convert(mode), np.uint8)
    return decode_png(buf, channels)


def read_png(path: str, channels: int) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_u8(f.read(), channels)
