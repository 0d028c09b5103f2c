"""The port's vimeo and ucf101 triplet sets (``data/folder.TripletDataset``,
``data/datasets.get_dataset``) against the JAX package's, on tiny trees
written here (frames 24x40 with Pillow's adaptive row filters, ucf101's
30x20 frames resized to 256x256):

- every frame and box equal to the JAX class's, bit for bit, through
  ``get_dataset`` + ``make_loader`` (train and val, loader workers 0 and 2);
- the seg maps are ``NO_SEG``, which ``core/seg.seg_oh`` expands to the JAX
  class's all-zero one-hots: the seg input the model sees is exactly zero,
  and ``oh_ids`` (what cycgen writes) is class 0, the JAX argmax of zeros;
- the vimeo lists end at the first row shorter than 4 characters; ucf101
  has a val split only;
- a Cityscapes tree holding ``NO_SEG`` still raises.
"""

import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from deep_video_interpolation_extrapolation_tpu.core.config import Config
from deep_video_interpolation_extrapolation_tpu.data import datasets as jdatasets
from deep_video_interpolation_extrapolation_tpu.train import common as jcommon
from deep_video_interpolation_extrapolation_tpu_torch.core.seg import (
    oh_ids,
    seg_oh,
)
from deep_video_interpolation_extrapolation_tpu_torch.data import (
    datasets,
    folder,
)
from deep_video_interpolation_extrapolation_tpu_torch.data.cityscapes import (
    IMG_EXT,
    NO_SEG,
    SEG_EXT,
)
from deep_video_interpolation_extrapolation_tpu_torch.native import host
from deep_video_interpolation_extrapolation_tpu_torch.train.common import (
    get_inter_inputs,
)

H, W = 24, 40
TRAIN = ["00001/0001", "00001/0002", "00002/0001", "00002/0007",
         "00003/0004"]
TEST = ["00004/0001", "00004/0002", "00005/0003"]


def _frame(rng, h, w):
    """Smooth gradients with noise: Pillow picks every row filter."""
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([yy * 5 + xx * 3, yy * 2 + 50, xx * 7], -1)
    return ((base + rng.randint(0, 12, (h, w, 3))) % 256).astype(np.uint8)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("triplets")
    rng = np.random.RandomState(0)
    vimeo = tmp / "vimeo_triplet"
    for rows in (TRAIN, TEST):
        for row in rows:
            d = vimeo / "sequences" / row
            d.mkdir(parents=True)
            for i in range(3):
                Image.fromarray(_frame(rng, H, W)).save(d / f"im{i + 1}.png")
    # a row shorter than 4 characters ends each list; rows after it are
    # not read
    (vimeo / "tri_trainlist.txt").write_text("\n".join(TRAIN) + "\n\n"
                                             + "00009/0009\n")
    (vimeo / "tri_testlist.txt").write_text("\n".join(TEST) + "\n")
    ucf = tmp / "ucf" / "ucf101_interp_ours"
    rows = []
    for c in range(3):
        row = []
        for i in range(3):
            rel = f"v{c}/frame{i}.png"
            (ucf / f"v{c}").mkdir(parents=True, exist_ok=True)
            Image.fromarray(_frame(rng, 20, 30)).save(ucf / rel)
            row.append(rel)
        rows.append(row)
    with open(tmp / "ucf" / "UCF101_test_root_clip.pkl", "wb") as f:
        pickle.dump({"test": rows}, f)
    return vimeo, ucf


def _cfg(**kw):
    base = dict(runner="INTER", model="InterNet", syn_type="inter",
                mode="xx2x", input_h=H, input_w=W, batch_size=2,
                num_track_per_img=3, seed=7)
    return Config(**{**base, **kw})


def _held(batch, ref):
    """A port batch against the JAX one: frames and boxes bit for bit, the
    seg ids NO_SEG, expanding to the JAX zero one-hots."""
    assert sorted(batch) == sorted(ref)
    for k, v in ref.items():
        if k.startswith("seg"):
            assert batch[k].dtype == np.uint8 and (batch[k] == NO_SEG).all()
            oh = seg_oh(torch.from_numpy(batch[k])).numpy()
            assert oh.dtype == v.dtype and np.array_equal(oh, v), k
        else:
            assert batch[k].dtype == v.dtype and np.array_equal(batch[k], v), k


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("workers", [0, 2])
def test_vimeo_batches_match_jax(trees, split, workers):
    vimeo, _ = trees
    kw = dict(dataset="vimeo", split=split, img_dir=str(vimeo),
              num_workers=workers)
    cfg, jcfg = _cfg(**kw), _cfg(**kw)
    ds = datasets.get_dataset(cfg)[split == "val"]
    jds = jdatasets.get_dataset(jcfg)[split == "val"]
    assert isinstance(ds, folder.TripletDataset)
    assert ds.clips == jds.clips == (TRAIN if split == "train" else TEST)
    loader = datasets.make_loader(cfg, ds)
    jloader = jdatasets.make_loader(jcfg, jds)
    host.reset_counts()
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        got, ref = list(loader), list(jloader)
        assert len(got) == len(ref) == (2 if split == "train" else 2)
        for b, r in zip(got, ref):
            _held(b, r)
            assert b["frame1"].shape == (b["frame1"].shape[0], H, W, 3)
    # every frame decoded whole by the fused path
    assert host.counts == {"fused": 2 * 3 * (4 if split == "train" else 3),
                           "numpy": 0, "other": 0}


def test_ucf101_is_val_only_and_matches_jax(trees):
    _, ucf = trees
    kw = dict(dataset="ucf101", split="val", img_dir=str(ucf))
    train, ds = datasets.get_dataset(_cfg(**kw))
    jtrain, jds = jdatasets.get_dataset(_cfg(**kw))
    assert train is None and jtrain is None
    assert ds.resize == (256, 256) and ds.style == "ucf101"
    for i in range(len(jds)):
        item = ds.sample(i, np.random.RandomState(i))
        ref = jds.sample(i, np.random.RandomState(i))
        assert item["frame1"].shape == (256, 256, 3)
        _held(item, ref)


def test_model_seg_input_is_zero(trees):
    """The xx2x step's seg input: exactly zero, equal to the JAX step's."""
    vimeo, _ = trees
    cfg = _cfg(dataset="vimeo", split="val", img_dir=str(vimeo))
    batch = next(iter(datasets.make_loader(cfg, datasets.get_dataset(cfg)[1])))
    jbatch = next(iter(jdatasets.make_loader(
        cfg, jdatasets.get_dataset(_cfg(dataset="vimeo", split="val",
                                        img_dir=str(vimeo)))[1])))
    x, seg, gt_x, gt_seg = get_inter_inputs(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    jx, jseg, jgt, jgt_seg = map(np.asarray, jcommon.get_inter_inputs(jbatch))
    assert seg.shape == (2, H, W, 40) and not seg.any() and not gt_seg.any()
    assert np.array_equal(seg.numpy(), jseg)
    assert np.array_equal(gt_seg.numpy(), jgt_seg)
    assert np.array_equal(x.numpy(), jx) and np.array_equal(gt_x.numpy(), jgt)
    # what cycgen writes and what a seg loss would target: class 0, the
    # argmax of the JAX zero one-hot
    ids = oh_ids(torch.from_numpy(batch["seg2"]))
    assert np.array_equal(ids.numpy(), np.argmax(jbatch["seg2"], -1))


def test_seg_oh_keeps_other_ids_loud():
    ids = torch.tensor([[0, 19, NO_SEG]], dtype=torch.uint8)
    oh = seg_oh(ids)
    assert oh[0, 0, 0] == 1 and oh[0, 1, 19] == 1 and not oh[0, 2].any()
    assert oh.sum() == 2
    with pytest.raises(RuntimeError):
        seg_oh(torch.tensor([[20]], dtype=torch.uint8))


def test_cityscapes_tree_refuses_no_seg(tmp_path):
    """NO_SEG is no Cityscapes id: ClipDataset raises for it as for every id
    >= 20."""
    clip = ["val/x/c_000000", "val/x/c_000001", "val/x/c_000002"]
    for rel in clip:
        for d, ext, arr in (("imgs", IMG_EXT, np.zeros((40, 64, 3), np.uint8)),
                            ("segs", SEG_EXT, np.full((40, 64), 7, np.uint8))):
            p = tmp_path / d / (rel + ext)
            p.parent.mkdir(parents=True, exist_ok=True)
            if d == "segs" and rel.endswith("2"):
                arr[3, 5] = NO_SEG
            Image.fromarray(arr).save(p)
    cfg = _cfg(img_dir=str(tmp_path / "imgs"), seg_dir=str(tmp_path / "segs"),
               input_h=32, input_w=64)
    ds = folder.ClipDataset(cfg, [clip], split="val")
    with pytest.raises(IndexError, match=f"seg id {NO_SEG} >= N_CLASSES"):
        ds.sample(0, np.random.RandomState(0))
