"""The port's PNG input and output (``native/png.py``): round trips of gray
and RGB arrays through its encoder and its zlib + numpy decoder, Pillow
reading what it writes, the decoder on Pillow-written PNGs of every row
filter type (0-4) pixel for pixel against Pillow, and the formats it
refuses."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from deep_video_interpolation_extrapolation_tpu_torch.native import png

SHAPES = [(1, 1), (37, 70), (64, 128), (1, 1, 3), (37, 70, 3), (64, 128, 3)]


def _array(shape, seed):
    rng = np.random.RandomState(seed)
    if seed % 2:       # smooth: long runs, so Pillow picks the other filters
        yy, xx = np.mgrid[:shape[0], :shape[1]]
        a = (yy * 3 + xx * 5 + seed) % 256
        if len(shape) == 3:
            a = np.stack([a, a[::-1] if a.shape[0] > 1 else a, a * 7 % 256],
                         -1)
        return a.astype(np.uint8)
    return rng.randint(0, 256, shape).astype(np.uint8)


def _pil_png(a, **kw):
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="PNG", **kw)
    return buf.getvalue()


def _filter_types(data):
    h, w, ctype, _, _ = png.png_info(data)
    idat = b"".join(d for t, d in png._chunks(data) if t == b"IDAT")
    raw = zlib.decompress(idat)
    stride = 1 + w * (3 if ctype == 2 else 1)
    return {raw[y * stride] for y in range(h)}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_round_trip(shape, seed):
    a = _array(shape, seed)
    data = png.encode_png(a)
    ch = 3 if a.ndim == 3 else 1
    assert np.array_equal(png.decode_u8(data, ch, use_pil=False), a)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), a)
    assert png.png_info(data)[:2] == a.shape[:2]


def test_save_and_read(tmp_path):
    a = _array((20, 30, 3), 0)
    png.save_png(str(tmp_path / "a.png"), a)
    assert np.array_equal(png.read_png(str(tmp_path / "a.png"), 3), a)


@pytest.mark.parametrize("optimize", [False, True])
def test_pillow_written_pngs_decode_alike(optimize):
    """Pillow's adaptive filtering (with ``optimize``) writes every filter
    type over these images; the zlib + numpy decoder reads them to the
    same pixels as Pillow."""
    seen = set()
    for shape in SHAPES:
        for seed in range(4):
            a = _array(shape, seed)
            data = _pil_png(a, optimize=optimize)
            seen |= _filter_types(data)
            ch = 3 if a.ndim == 3 else 1
            ours = png.decode_u8(data, ch, use_pil=False)
            assert np.array_equal(ours, a)
            assert np.array_equal(ours, png.decode_u8(data, ch, use_pil=True))
    if optimize:
        assert seen == {0, 1, 2, 3, 4}, seen


@pytest.mark.parametrize("mode,shape,why", [
    ("RGBA", (8, 8, 4), "RGBA"), ("P", (8, 8), "palette"),
    ("I;16", (8, 8), "16-bit")])
def test_other_formats_refused(mode, shape, why):
    a = np.zeros(shape, np.uint16 if mode == "I;16" else np.uint8)
    img = Image.fromarray(a)
    if mode != img.mode:
        img = img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    with pytest.raises(ValueError, match=why):
        png.decode_u8(buf.getvalue(), 3 if why == "RGBA" else 1,
                      use_pil=False)


def test_interlaced_and_wrong_channels_refused():
    data = _pil_png(_array((8, 8, 3), 0))
    with pytest.raises(ValueError, match="gray only"):
        png.decode_u8(data, 1, use_pil=False)
    # set the IHDR interlace byte (and its CRC)
    ihdr = bytearray(data[16:29])
    ihdr[12] = 1
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + bytes(ihdr)) & 0xFFFFFFFF)
    laced = data[:16] + bytes(ihdr) + crc + data[33:]
    with pytest.raises(ValueError, match="interlaced"):
        png.decode_u8(laced, 3, use_pil=False)


def test_corrupt_files_refused():
    data = bytearray(png.encode_png(_array((8, 8), 0)))
    with pytest.raises(ValueError, match="signature"):
        png.decode_u8(b"GIF89a" + bytes(data[6:]), 1, use_pil=False)
    data[40] ^= 0xFF                        # inside the IDAT chunk
    with pytest.raises(ValueError, match="CRC"):
        png.decode_u8(bytes(data), 1, use_pil=False)
    with pytest.raises(ValueError, match="uint8"):
        png.encode_png(np.zeros((4, 4), np.float32))
