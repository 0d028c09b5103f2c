"""The port's host tools against the JAX package's, on the CPU:

- ``tools/build_clips.py``: every builder and the ``main`` commands on a
  Cityscapes-named tree, detection pickles and TrackR-CNN track files
  written here; the port's pickles load equal to JAX's (lists equal,
  arrays equal bit for bit);
- ``tools/video_tools.py``: the resized trees (bilinear and nearest) equal
  file for file and pixel for pixel; ``flow_magnitude`` equal; the clips
  ``filter_clips_by_flow`` keeps equal; the three video writers write as
  many frames as JAX's and decodable videos;
- ``utils/flow_vis.py``: the colour wheel, ``compute_color`` and
  ``flow_to_image`` equal bit for bit, NaN and unknown (> 1e7) flows and
  ``max_flow`` included.
"""

import os
import pickle

import numpy as np
import pytest
from PIL import Image

from deep_video_interpolation_extrapolation_tpu.tools import (
    build_clips as jbuild,
    video_tools as jvideo,
)
from deep_video_interpolation_extrapolation_tpu.utils import flow_vis as jflow
from deep_video_interpolation_extrapolation_tpu_torch.tools import (
    build_clips,
    video_tools,
)
from deep_video_interpolation_extrapolation_tpu_torch.utils import flow_vis


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _same(a, b):
    """Nested dicts / lists / arrays equal, arrays bit for bit."""
    if isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            _same(a[k], b[k])
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


def _both(tmp, name, fn_port, fn_jax, *args, **kw):
    """Each side's builder writing ``name`` under its own directory."""
    out = {}
    for side, fn in (("port", fn_port), ("jax", fn_jax)):
        d = tmp / side
        d.mkdir(exist_ok=True)
        out[side] = fn(*[a(d) if callable(a) else a for a in args], **kw)
    return out


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    """A Cityscapes-named tree: two scenes, 31 and 12 frames of video 0
    (the rest of a 30-frame clip dropped), a val scene; detection pickles
    for some frames and TrackR-CNN track files for others."""
    tmp = tmp_path_factory.mktemp("city")
    for split, scene, n in (("train", "aachen", 31), ("train", "bochum", 12),
                            ("val", "lindau", 30)):
        d = tmp / "imgs" / split / scene
        d.mkdir(parents=True)
        for i in range(n):
            (d / f"{scene}_000000_{i:06d}_leftImg8bit.png").write_bytes(b"")
    rng = np.random.RandomState(0)
    dets = tmp / "dets"
    tracks = tmp / "tracks"
    for split, scene, n in (("train", "aachen", 31), ("val", "lindau", 30)):
        (dets / split / scene).mkdir(parents=True)
        (tracks / split / scene).mkdir(parents=True)
        for i in range(n):
            frame = f"{scene}_000000_{i:06d}"
            if i % 7 != 3:      # some frames have no detections
                k = rng.randint(1, 6)
                xy = rng.uniform(0, 900, (k, 2))
                wh = rng.uniform(1, 120, (k, 2))
                rows = np.concatenate([rng.uniform(0, 1, (k, 1)), xy,
                                       xy + wh], 1)
                with open(dets / split / scene / f"{frame}.pkl", "wb") as f:
                    pickle.dump(rows.astype(np.float32), f)
            if i % 5 != 2:      # some frames have no track file
                objs = [f"{j},{x},{y},{x + w},{y + h}" for j, (x, y, w, h) in
                        enumerate(rng.randint(0, 300, (3, 4)))]
                (tracks / split / scene / f"{frame}_leftImg8bit.txt"
                 ).write_text("---".join(objs) + "\n")
    return tmp


def test_build_clips_match_jax(city, tmp_path):
    scenes = {"train": ["aachen", "bochum"], "val": ["lindau"], "test": []}
    out = _both(tmp_path, "root", build_clips.create_root_clip,
                jbuild.create_root_clip, str(city / "imgs"),
                lambda d: str(d / "root.pkl"), clip_len=10,
                scene_dict=scenes)
    _same(out["port"], out["jax"])
    assert len(out["port"]["train"]) == 4 and len(out["port"]["val"]) == 3
    for side in ("port", "jax"):
        assert os.path.exists(tmp_path / side / "root.pkl")
    for name, port, ref, kw in (
            ("pred.pkl", build_clips.create_pred_lsclip,
             jbuild.create_pred_lsclip, dict(interval=2, vid_len=4)),
            ("interp.pkl", build_clips.create_interp_lsclip,
             jbuild.create_interp_lsclip, dict(interval=3))):
        res = _both(tmp_path, name, port, ref,
                    lambda d: str(d / "root.pkl"), lambda d, n=name: str(d / n),
                    **kw)
        _same(res["port"], res["jax"])
        _same(_load(tmp_path / "port" / name), _load(tmp_path / "jax" / name))
    boxes = _both(tmp_path, "bbox", build_clips.create_bbox_file,
                  jbuild.create_bbox_file, lambda d: str(d / "interp.pkl"),
                  str(city / "dets"), lambda d: str(d / "bbox.pkl"))
    _same(boxes["port"], boxes["jax"])
    assert any(b.shape[1] for b in boxes["port"]["train"])
    _both(tmp_path, "clean", build_clips.clean_bbox_file_max,
          jbuild.clean_bbox_file_max, lambda d: str(d / "bbox.pkl"),
          lambda d: str(d / "interp.pkl"), lambda d: str(d / "bbox_max.pkl"),
          lambda d: str(d / "clip_max.pkl"), num_box=2, area_thresh=400.0)
    track = _both(tmp_path, "track", build_clips.create_trackrcnn_track_pkl,
                  jbuild.create_trackrcnn_track_pkl,
                  lambda d: str(d / "interp.pkl"), str(city / "tracks"),
                  lambda d: str(d / "track_bb.pkl"),
                  lambda d: str(d / "track_clip.pkl"), area_thresh=2000.0)
    _same(track["port"], track["jax"])
    for name in ("bbox.pkl", "bbox_max.pkl", "clip_max.pkl", "track_bb.pkl",
                 "track_clip.pkl"):
        _same(_load(tmp_path / "port" / name), _load(tmp_path / "jax" / name))
    assert _load(tmp_path / "port" / "clip_max.pkl")["train"]


@pytest.mark.parametrize("argv", [
    ["root", "{imgs}", "{d}/root.pkl", "--clip_len", "12"],
    ["pred", "{d}/root.pkl", "{d}/pred.pkl", "--interval", "1"],
    ["interp", "{d}/root.pkl", "{d}/interp.pkl"],
    ["trackrcnn", "{d}/interp.pkl", "{tracks}", "{d}/tb.pkl", "{d}/tc.pkl",
     "--area_thresh", "10"]])
def test_build_clips_main_matches_jax(city, tmp_path, argv):
    for side, main in (("port", build_clips.main), ("jax", jbuild.main)):
        d = tmp_path / side
        d.mkdir()
        if argv[0] != "root":
            main(["root", str(city / "imgs"), f"{d}/root.pkl", "--clip_len",
                  "12"])
        if argv[0] == "trackrcnn":
            main(["interp", f"{d}/root.pkl", f"{d}/interp.pkl"])
        main([a.format(imgs=city / "imgs", tracks=city / "tracks", d=d)
              for a in argv])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        _same(_load(tmp_path / "port" / name), _load(tmp_path / "jax" / name))


def _frames(tmp, n=4, size=(24, 40)):
    src = tmp / "src"
    (src / "sub").mkdir(parents=True)
    for i in range(n):
        rng = np.random.RandomState(i)
        Image.fromarray(rng.randint(0, 256, size + (3,)).astype(np.uint8)
                        ).save(src / f"{i:03d}.png")
        Image.fromarray(rng.randint(0, 20, size).astype(np.uint8)
                        ).save(src / "sub" / f"{i:03d}.png")
    return src


@pytest.mark.parametrize("nearest", [False, True])
def test_resize_matches_jax(tmp_path, nearest):
    src = _frames(tmp_path)
    n = {side: mod.resize_images(str(src), str(tmp_path / side), (17, 11),
                                 nearest=nearest)
         for side, mod in (("port", video_tools), ("jax", jvideo))}
    assert n["port"] == n["jax"] == 8
    for rel in ("000.png", "003.png", "sub/001.png"):
        a = np.asarray(Image.open(tmp_path / "port" / rel))
        b = np.asarray(Image.open(tmp_path / "jax" / rel))
        assert a.shape[:2] == (11, 17) and np.array_equal(a, b)
        assert np.array_equal(video_tools._imread(str(tmp_path / "port" / rel)),
                              jvideo._imread(str(tmp_path / "jax" / rel)))


def _moving(shift):
    base = np.random.RandomState(0).randint(0, 255, (64, 96, 3), np.uint8)
    return np.roll(base, shift, axis=1)


def test_flow_filter_matches_jax(tmp_path):
    frames = {"a": _moving(0), "b": _moving(6), "c": _moving(2)}
    for a, b in (("a", "a"), ("a", "b"), ("a", "c")):
        assert (video_tools.flow_magnitude(frames[a], frames[b])
                == jvideo.flow_magnitude(frames[a], frames[b]))
    with open(tmp_path / "clips.pkl", "wb") as f:
        pickle.dump({"train": [["a", "x", "b"], ["a", "a"], ["c", "a"]],
                     "val": [["b", "a"]]}, f)
    kept = {side: mod.filter_clips_by_flow(
        str(tmp_path / "clips.pkl"), str(tmp_path / f"{side}.pkl"),
        frames.get, min_mag=1.0) for side, mod in (("port", video_tools),
                                                  ("jax", jvideo))}
    _same(kept["port"], kept["jax"])
    _same(_load(tmp_path / "port.pkl"), _load(tmp_path / "jax.pkl"))
    assert kept["port"]["train"] == [["a", "x", "b"], ["c", "a"]]


def test_video_writers_match_jax(tmp_path):
    import cv2
    src = _frames(tmp_path, n=3)
    for side, mod in (("port", video_tools), ("jax", jvideo)):
        out = tmp_path / side
        clip = out / "clip_00000"
        for sub in ("rgb", "seg_vis"):
            (clip / sub).mkdir(parents=True)
            for i in range(3):
                Image.open(src / f"{i:03d}.png").save(clip / sub / f"{i:03d}.png")
        assert mod.imgs2vid(str(src), str(out / "v.avi")) == 3
        assert mod.combine_grids([str(src), str(clip / "rgb")],
                                 str(out / "g.avi")) == 3
        assert mod.assemble_cycgen_videos(str(out)) == 1
        for name in ("v.avi", "g.avi", "clip_00000/clip.avi"):
            cap = cv2.VideoCapture(str(out / name))
            assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 3, (side, name)
            cap.release()


def test_flow_vis_matches_jax():
    rng = np.random.RandomState(0)
    assert np.array_equal(flow_vis.make_color_wheel(),
                          jflow.make_color_wheel())
    flow = rng.normal(0, 8, (33, 47, 2)).astype(np.float32)
    flow[3, 4] = np.nan
    flow[5, 6, 0] = 2e7            # unknown flow
    u, v = flow[..., 0] / 20, flow[..., 1] / 20
    assert np.array_equal(flow_vis.compute_color(u, v),
                          jflow.compute_color(u, v))
    for max_flow in (None, 5.0):
        img = flow_vis.flow_to_image(flow, max_flow)
        assert img.dtype == np.uint8 and img.shape == (33, 47, 3)
        assert np.array_equal(img, jflow.flow_to_image(flow, max_flow))
