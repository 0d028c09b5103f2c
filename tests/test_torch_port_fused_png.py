"""The port's fused PNG path (``native/host.py`` on ``native/dvie_host.cpp``)
against the zlib + numpy decoder of ``native/png.py``, the JAX package's
libpng path (``native/host.decode_rgb_norm`` modes 0 and 1, and the argmax
of ``decode_seg_onehot``) and Pillow, bit for bit:

- PNGs written here as raw rows through ``zlib``, every row with filter
  type 0, 1, 2, 3 or 4 (and a mix), gray and RGB, 37x70 with 3 IDAT chunks;
- crops at the edges and inside, flip on and off;
- the crop's rows only are inflated: a bad CRC in a chunk below them is
  not read, and refused by a whole decode;
- a bad CRC, a seg id of 20 or more and a crop outside the image refused;
- ``DVIE_NATIVE_LOADER=0`` takes the numpy decoder, a palette PNG Pillow;
- a failed ``g++`` build raises with the compiler's output.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from deep_video_interpolation_extrapolation_tpu.data.folder import (
    _pil_frame_rgb,
)
from deep_video_interpolation_extrapolation_tpu.native import host as jhost
from deep_video_interpolation_extrapolation_tpu_torch.native import host, png

H, W = 37, 70
CROPS = [(0, 0, H, W), (0, 0, 16, 24), (H - 16, W - 24, 16, 24),
         (5, 9, 20, 33), (H - 1, 0, 1, W)]


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_row(kind, row, prev, bpp):
    """The PNG encoder's side of each filter type (PNG spec, section 9)."""
    r, p = row.astype(np.int32), prev.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int32), p[:-bpp]])
    pred = {0: 0, 1: a, 2: p, 3: (a + p) // 2, 4: _paeth(a, p, c)}[kind]
    return ((r - pred) % 256).astype(np.uint8)


def _raw_png(arr, kinds, n_idat=3):
    """``arr`` as a PNG whose row y has filter ``kinds[y % len(kinds)]``,
    its zlib stream split over ``n_idat`` IDAT chunks."""
    h, w = arr.shape[:2]
    bpp = 1 if arr.ndim == 2 else 3
    rows = arr.reshape(h, w * bpp)
    prev = np.zeros(w * bpp, np.uint8)
    raw = b""
    for y in range(h):
        kind = kinds[y % len(kinds)]
        raw += bytes([kind]) + _filter_row(kind, rows[y], prev, bpp).tobytes()
        prev = rows[y]
    z = zlib.compress(raw, 6)
    cut = np.linspace(0, len(z), n_idat + 1).astype(int)
    header = struct.pack(">IIBBBBB", w, h, 8, 0 if bpp == 1 else 2, 0, 0, 0)
    return (png._SIGNATURE + png._chunk(b"IHDR", header)
            + b"".join(png._chunk(b"IDAT", z[a:b])
                       for a, b in zip(cut[:-1], cut[1:]))
            + png._chunk(b"IEND", b""))


def _image(channels, ids=False, seed=0):
    rng = np.random.RandomState(seed)
    shape = (H, W) if channels == 1 else (H, W, 3)
    if ids:
        return rng.randint(0, 20, shape).astype(np.uint8)
    yy, xx = np.mgrid[:H, :W]
    smooth = (yy * 3 + xx * 5) % 256
    if channels == 3:
        smooth = np.stack([smooth, smooth[::-1], (smooth * 7) % 256], -1)
    return ((smooth + rng.randint(0, 40, shape)) % 256).astype(np.uint8)


KINDS = [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)]


@pytest.mark.parametrize("kinds", KINDS, ids=lambda k: "".join(map(str, k)))
@pytest.mark.parametrize("flip", [False, True])
def test_rgb_matches_numpy_jax_and_pillow(kinds, flip):
    a = _image(3, seed=len(kinds))
    data = _raw_png(a, kinds)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), a)
    assert jhost.available()
    for y0, x0, ch, cw in CROPS:
        got = host.decode_rgb_norm(data, y0, x0, ch, cw, flip)
        ref = (a[:, ::-1] if flip else a)[y0:y0 + ch, x0:x0 + cw]
        assert np.array_equal(
            png.decode_crop(data, 3, y0, x0, ch, cw, flip), ref)
        assert got.dtype == np.float32 and got.shape == (ch, cw, 3)
        assert np.array_equal(got, host.NORM[ref])
        for mode in (0, 1):   # ClipDataset's and TripletDataset's
            j = jhost.decode_rgb_norm(data, y0, x0, ch, cw, flip, mode=mode)
            assert np.array_equal(got, j), (y0, x0, ch, cw, mode)


@pytest.mark.parametrize("kinds", KINDS, ids=lambda k: "".join(map(str, k)))
@pytest.mark.parametrize("flip", [False, True])
def test_seg_ids_and_gray_match(kinds, flip):
    ids = _image(1, ids=True, seed=len(kinds))
    gray = _image(1, seed=len(kinds))
    seg_data, gray_data = _raw_png(ids, kinds), _raw_png(gray, kinds)
    for y0, x0, ch, cw in CROPS:
        got = host.decode_seg_ids(seg_data, y0, x0, ch, cw, flip)
        ref = (ids[:, ::-1] if flip else ids)[y0:y0 + ch, x0:x0 + cw]
        assert got.dtype == np.uint8 and np.array_equal(got, ref)
        oh = jhost.decode_seg_onehot(seg_data, y0, x0, ch, cw, flip, 20)
        assert np.array_equal(got, oh.argmax(-1))
        assert np.array_equal(
            png.decode_crop(seg_data, 1, y0, x0, ch, cw, flip), ref)
        # a gray frame as rgb: its value in every channel, as Pillow's
        # convert("RGB") (the JAX native path declines it to that branch)
        rgb = host.decode_rgb_norm(gray_data, y0, x0, ch, cw, flip)
        assert np.array_equal(
            rgb, _pil_frame_rgb(gray_data, flip, y0, x0, ch, cw))


def test_partial_read_stops_at_the_crop():
    """The crop's rows lie in the first IDAT chunk: a bad CRC in the last
    one is never read by the crop, and refused by a whole decode."""
    a = _image(3)
    data = bytearray(_raw_png(a, (1,), n_idat=8))
    last = data.rindex(b"IDAT")
    data[last + 6] ^= 0xFF
    data = bytes(data)
    top = host.decode_rgb_norm(data, 0, 0, 2, W, False)
    assert np.array_equal(top, host.NORM[a[:2]])
    assert np.array_equal(png.decode_crop(data, 3, 0, 0, 2, W, False), a[:2])
    with pytest.raises(ValueError, match="CRC"):
        host.decode_rgb_norm(data, 0, 0, H, W, False)


def test_refusals():
    ids = _image(1, ids=True)
    ids[20, 30] = 20
    seg = _raw_png(ids, (4,))
    # the bad id outside the crop is no fault; inside it, it is
    assert host.decode_seg_ids(seg, 0, 0, 16, 24, False).max() < 20
    with pytest.raises(IndexError, match="seg id 20 >= N_CLASSES"):
        host.decode_seg_ids(seg, 10, 20, 16, 24, False)
    with pytest.raises(IndexError, match="seg id 255 >= N_CLASSES"):
        host.decode_seg_ids(png.encode_png(np.full((4, 4), 255, np.uint8)),
                            0, 0, 4, 4, True)
    data = bytearray(_raw_png(_image(3), (2,)))
    data[data.index(b"IDAT") + 6] ^= 0xFF       # inside the first IDAT
    with pytest.raises(ValueError, match="CRC"):
        host.decode_rgb_norm(bytes(data), 0, 0, 4, 4, False)
    with pytest.raises(ValueError, match="outside"):
        host.decode_rgb_norm(_raw_png(_image(3), (0,)), 30, 0, 16, 4, False)


def test_numpy_decoder_by_switch(monkeypatch):
    a, ids = _image(3), _image(1, ids=True)
    data, seg = _raw_png(a, (3, 4)), _raw_png(ids, (1, 2))
    fused = (host.decode_rgb_norm(data, 3, 4, 20, 30, True),
             host.decode_seg_ids(seg, 3, 4, 20, 30, True))
    monkeypatch.setenv("DVIE_NATIVE_LOADER", "0")
    host.reset_counts()
    slow = (host.decode_rgb_norm(data, 3, 4, 20, 30, True),
            host.decode_seg_ids(seg, 3, 4, 20, 30, True))
    assert host.counts == {"fused": 0, "numpy": 2, "other": 0}
    assert all(np.array_equal(f, s) for f, s in zip(fused, slow))


def test_other_formats_through_pillow():
    a = _image(3)
    buf = io.BytesIO()
    Image.fromarray(a).convert("P").save(buf, format="PNG")
    data = buf.getvalue()
    host.reset_counts()
    got = host.decode_rgb_norm(data, 2, 3, 10, 12, True)
    pal = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert np.array_equal(got, host.NORM[pal[:, ::-1][2:12, 3:15]])
    assert host.counts == {"fused": 0, "numpy": 0, "other": 1}


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "dvie_host.cpp"
    bad.write_text("int f( { return 0; }\n")
    monkeypatch.setattr(host, "SRC", bad)
    monkeypatch.setattr(host, "BUILD", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed .*error:"):
        host.build()
    assert not list((tmp_path / "_build").iterdir())


def test_built_from_the_source():
    """The library is built into the package's _build/, keyed by the
    source's hash, and answers its ABI version."""
    path = host.build()
    assert path.parent.name == "_build" and path.parent.parent.name == (
        "deep_video_interpolation_extrapolation_tpu_torch")
    assert host.library().dvie_host_abi_version() == 1
