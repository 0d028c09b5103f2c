"""The port's data layer against the JAX package's.

- ``data/synthetic.py``: the same frames and boxes, and seg ids equal to
  the argmax of the JAX one-hots.
- ``data/folder.py`` and ``data/datasets.py``: on a tiny Cityscapes-layout
  PNG tree (150 px train and 128 px val sources, its clip pkl and bbox pkl under
  ``$DVIE_DATA_ROOT``), ``get_dataset`` + ``make_loader`` give the JAX
  ``ClipDataset(seg_ids=True)`` / ``Loader`` batches bit for bit, at
  ``num_workers`` 0 and 2, over two epochs, train and val.  Train drops the
  tail batch, val keeps it.
"""

import dataclasses
import pickle

import numpy as np
import pytest
from PIL import Image

from deep_video_interpolation_extrapolation_tpu.core.config import Config
from deep_video_interpolation_extrapolation_tpu.data import datasets as jdatasets
from deep_video_interpolation_extrapolation_tpu.data import synthetic as jsynthetic
from deep_video_interpolation_extrapolation_tpu_torch.data import (
    datasets,
    folder,
    synthetic,
)
from deep_video_interpolation_extrapolation_tpu_torch.data.cityscapes import (
    IMG_EXT,
    SEG_EXT,
)

N_CLIPS = 7


def _cfg(tmp, **kw):
    base = dict(runner="INTER", model="InterNet", syn_type="inter",
                mode="xs2xs", input_h=32, input_w=64, batch_size=2,
                dataset="cityscape", num_track_per_img=4, interval=1,
                img_dir=str(tmp / "imgs"), seg_dir=str(tmp / "segs"),
                seed=5)
    base.update(kw)
    return Config(**base)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A Cityscapes-layout tree: 150 px train and 128 px val frames and
    20-class id maps, the clip pkl and a bbox pkl (1024x512 scale, some
    boxes missing)."""
    tmp = tmp_path_factory.mktemp("city")
    rng = np.random.RandomState(0)
    clips = {"train": [], "val": []}
    boxes = {"train": [], "val": []}
    for split, src in (("train", 150), ("val", 128)):
        for c in range(N_CLIPS):
            clip = [f"{split}/scene/clip{c}_{i:06d}" for i in range(3)]
            for rel in clip:
                for d, ext, arr in (
                        ("imgs", IMG_EXT, rng.randint(0, 255, (src, src, 3),
                                                      dtype=np.uint8)),
                        ("segs", SEG_EXT, rng.randint(
                            0, 20, (src, src)).astype(np.uint8))):
                    p = tmp / d / (rel + ext)
                    p.parent.mkdir(parents=True, exist_ok=True)
                    Image.fromarray(arr).save(p)
            clips[split].append(clip)
            tracks = []
            for _f in range(3):
                frame = []
                for t in range(4):
                    if (c + t) % 5 == 4:
                        frame.append(None)
                        continue
                    x1, y1 = rng.uniform(0, 300), rng.uniform(0, 100)
                    frame.append([0.9, x1, y1, x1 + rng.uniform(300, 700),
                                  y1 + rng.uniform(200, 400)])
                tracks.append(frame)
            boxes[split].append(tracks)
    cfg = _cfg(tmp)
    (tmp / "load_files").mkdir()
    (tmp / "obj_coords").mkdir()
    with open(jdatasets.clip_file_path(cfg).replace(
            jdatasets.data_root(), str(tmp)), "wb") as f:
        pickle.dump(clips, f)
    with open(jdatasets.obj_coord_file_path(cfg).replace(
            jdatasets.data_root(), str(tmp)), "wb") as f:
        pickle.dump(boxes, f)
    return tmp


@pytest.mark.parametrize("seed,shape", [(0, (2, 32, 64)), (7, (3, 16, 24))])
def test_synthetic_batches_match_jax(seed, shape):
    b, h, w = shape
    ours = synthetic.synthetic_batch(b, h, w, seed=seed)
    ref = jsynthetic.synthetic_batch(b, h, w, seed=seed)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        if k.startswith("seg"):
            assert ours[k].dtype == np.uint8 and ours[k].shape == (b, h, w)
            assert np.array_equal(ours[k], ref[k].argmax(-1))
        else:
            assert np.array_equal(ours[k], ref[k]), k


def test_synthetic_dataset_epochs_match_jax():
    cfg = dataclasses.replace(_cfg_synth(), split="train")
    ours, _ = datasets.get_dataset(cfg)
    ref, _ = jdatasets.get_dataset(cfg)
    assert datasets.make_loader(cfg, ours) is ours
    for epoch in (1, 2):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for a, b in zip(ours, ref):
            assert np.array_equal(a["frame2"], b["frame2"])
            assert np.array_equal(a["seg3"], b["seg3"].argmax(-1))


def _cfg_synth():
    return Config(runner="INTER", model="InterNet", syn_type="inter",
                  input_h=16, input_w=32, batch_size=2, dataset="synthetic")


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("workers", [0, 2])
def test_cityscape_batches_match_jax(tree, monkeypatch, split, workers):
    monkeypatch.setenv("DVIE_DATA_ROOT", str(tree))
    monkeypatch.setenv("DVIE_SEG_IDS", "1")
    cfg = _cfg(tree, split=split, num_workers=workers)
    pick = 0 if split == "train" else 1
    ours = datasets.make_loader(cfg, datasets.get_dataset(cfg)[pick])
    ref = jdatasets.make_loader(cfg, jdatasets.get_dataset(cfg)[pick])
    assert ours.ds.src_size == ref.ds.src_size == (150 if pick == 0 else 128)
    assert len(ours) == len(ref) == (3 if split == "train" else 4)
    for epoch in (1, 2):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        n = 0
        for a, b in zip(ours, ref):
            assert sorted(a) == sorted(b)
            for k in b:
                assert a[k].dtype == b[k].dtype, k
                assert np.array_equal(a[k], b[k]), (epoch, k)
            n += 1
        assert n == len(ref)


def test_workers_match_sequential(tree, monkeypatch):
    monkeypatch.setenv("DVIE_DATA_ROOT", str(tree))
    cfg = _cfg(tree, split="train")
    ds = datasets.get_dataset(cfg)[0]
    seq = folder.Loader(ds, 2, seed=3, num_workers=0)
    par = folder.Loader(ds, 2, seed=3, num_workers=2)
    for a, b in zip(seq, par):
        for k in a:
            assert np.array_equal(a[k], b[k])


def test_triplet_datasets_refused(tmp_path):
    """The triplet sets (``tests/test_torch_port_triplet_data.py`` holds
    them to the JAX package) refuse a tree without their clip lists, naming
    the missing file, and ucf101 offers no train set."""
    for name, missing in (("ucf101", "UCF101_test_root_clip.pkl"),
                          ("vimeo", "tri_testlist.txt")):
        with pytest.raises(FileNotFoundError, match=missing):
            datasets.get_dataset(_cfg(tmp_path, dataset=name, split="val",
                                      img_dir=str(tmp_path / "x")))
    (tmp_path / "UCF101_test_root_clip.pkl").write_bytes(
        pickle.dumps({"test": []}))
    train, val = datasets.get_dataset(_cfg(tmp_path, dataset="ucf101",
                                           split="train",
                                           img_dir=str(tmp_path / "x")))
    assert train is None and len(val) == 0


def test_out_of_range_ids_raise(tmp_path, monkeypatch):
    clip = ["val/x/c_000000", "val/x/c_000001", "val/x/c_000002"]
    for rel in clip:
        for d, ext, arr in (("imgs", IMG_EXT, np.zeros((40, 64, 3), np.uint8)),
                            ("segs", SEG_EXT, np.full((40, 64), 255,
                                                      np.uint8))):
            p = tmp_path / d / (rel + ext)
            p.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(arr).save(p)
    ds = folder.ClipDataset(_cfg(tmp_path), [clip], split="val")
    with pytest.raises(IndexError, match="N_CLASSES"):
        ds.sample(0, np.random.RandomState(0))
