"""Dataset factory of the port (counterpart of the JAX package's
``data/datasets.py``; reference data.py:21-143) for every ``--dataset``.

The Cityscapes split comes from the reference's pickled clip lists, keyed
by interval, track count and area (data.py:25-32), with the bbox
coordinate pickles beside them; the root is ``$DVIE_DATA_ROOT`` and the
frame trees ``--img_dir`` / ``--seg_dir``, as in the JAX package.  ucf101
(val only: ``UCF101_test_root_clip.pkl`` beside ``--img_dir``, frames
resized to 256x256) and vimeo (``tri_trainlist.txt`` / ``tri_testlist.txt``
under ``--img_dir``, frames in its ``sequences/``) are
``TripletDataset``s.  ``--dataset synthetic`` generates clips, so every
stage runs without the download.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

from deep_video_interpolation_extrapolation_tpu_torch.data.folder import (
    ClipDataset,
    Loader,
    TripletDataset,
)
from deep_video_interpolation_extrapolation_tpu_torch.data.synthetic import (
    SyntheticClipDataset,
)


def data_root() -> str:
    return os.environ.get("DVIE_DATA_ROOT", "/data/cityscape")


def clip_file_path(cfg) -> str:
    """Mirror of the reference's clip-pkl naming (data.py:25-32)."""
    root = data_root()
    if cfg.effec_flow:
        return os.path.join(
            root, "load_files",
            f"effec_flow_int_{int(cfg.interval)}_len_3_extra_lsclip.pkl")
    if cfg.syn_type == "extra" and cfg.vid_length != 1:
        return os.path.join(
            root, "load_files",
            f"int_{int(cfg.interval)}_len_{cfg.vid_length + 2}_extra_lsclip.pkl")
    return os.path.join(
        root, "load_files",
        f"int_{int(cfg.interval)}_len_3_max_{int(cfg.num_track_per_img)}bb_"
        f"area_3000_extra_panet_lsclip.pkl")


def obj_coord_file_path(cfg) -> str:
    return os.path.join(
        data_root(), "obj_coords",
        f"int_{int(cfg.interval)}_len_3_extra_512x1024_max_"
        f"{int(cfg.num_track_per_img)}bb_area_3000_panet_lsclip.pkl")


def get_dataset(cfg, vid_len: int = 3):
    """Returns (train_dataset, val_dataset); each may be None per split."""
    if cfg.dataset == "synthetic":
        bs = cfg.batch_size
        train = SyntheticClipDataset(cfg, bs, num_batches=8, vid_len=vid_len)
        val = SyntheticClipDataset(cfg, bs, num_batches=4, vid_len=vid_len)
        return (train if cfg.split == "train" else None,
                val if cfg.split == "val" else None)

    if cfg.dataset == "cityscape":
        with open(clip_file_path(cfg), "rb") as f:
            clips = pickle.load(f)
        boxes = None
        coord_path = obj_coord_file_path(cfg)
        if os.path.exists(coord_path):
            with open(coord_path, "rb") as f:
                boxes = pickle.load(f)
        train = val = None
        if cfg.split == "train":
            train = ClipDataset(
                cfg, clips["train"],
                bboxes=boxes["train"] if boxes else None, split="train")
        if cfg.split == "val":
            val = ClipDataset(
                cfg, clips["val"],
                bboxes=boxes["val"] if boxes else None, split="val")
        return train, val

    if cfg.dataset == "ucf101":
        # val-only xx2x triplets from a pickled clip list (data.py:75-93)
        root = cfg.img_dir or os.path.join(data_root(), "ucf101_interp_ours")
        clip_path = os.path.join(
            os.path.dirname(root.rstrip("/")), "UCF101_test_root_clip.pkl")
        with open(clip_path, "rb") as f:
            clips = pickle.load(f)["test"]
        val = TripletDataset(cfg, clips, root, style="ucf101",
                             resize=(256, 256))
        return None, val

    if cfg.dataset == "vimeo":
        # tri_trainlist/tri_testlist of triplet dirs (data.py:95-137); a
        # row shorter than 4 characters ends the list
        root = cfg.img_dir or os.path.join(data_root(), "vimeo_triplet")

        def read_list(name):
            rows = []
            with open(os.path.join(root, name)) as f:
                for line in f:
                    line = line.strip()
                    if len(line) < 4:
                        break
                    rows.append(line)
            return rows

        seq_dir = os.path.join(root, "sequences")
        train = val = None
        if cfg.split == "train":
            train = TripletDataset(cfg, read_list("tri_trainlist.txt"),
                                   seq_dir)
        if cfg.split == "val":
            val = TripletDataset(cfg, read_list("tri_testlist.txt"), seq_dir)
        return train, val
    raise KeyError(cfg.dataset)


def make_loader(cfg, dataset, shuffle: Optional[bool] = None):
    if isinstance(dataset, SyntheticClipDataset):
        return dataset
    is_train = shuffle if shuffle is not None else (cfg.split == "train")
    # eval keeps the tail batch (the reference's DataLoader keeps it);
    # train drops it, so every step has one shape
    return Loader(
        dataset, cfg.batch_size, seed=cfg.seed,
        shuffle=is_train, drop_last=is_train,
        num_workers=cfg.num_workers)
