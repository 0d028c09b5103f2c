"""Cityscapes label/color metadata (a copy of the JAX package's
``data/cityscapes.py``; reference utils/cityscape_utils.py,
utils/data_utils.py)."""

from __future__ import annotations

import numpy as np

# 34 raw Cityscapes label ids -> 29-class LEGACY index (exact copy of the
# reference's seg_id2index_np, utils/cityscape_utils.py:82-117, which the
# reference itself marks "not used now") — values exceed N_CLASSES, so do
# NOT one-hot through this table.  The active pipeline loads pre-mapped
# 20-class ``_gtFine_myseg_id.png`` ids directly (data/folder.py); kept
# for metadata parity with the reference only.
SEG_ID2INDEX = np.array(
    [0, 0, 0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12,
     13, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28],
    dtype=np.int32,
)

N_CLASSES = 20

# The port's own: the seg id of a frame that has no segmentation (the
# vimeo and ucf101 triplets).  ``core/seg.seg_oh`` expands it to an all-zero
# row, the JAX package's dummy one-hot; ``ClipDataset`` still refuses it, as
# it refuses every id >= N_CLASSES.
NO_SEG = 255

# 20-class visualization palette (utils/data_utils.py color_map)
COLOR_MAP = np.array([
    [128, 64, 128],   # road
    [244, 35, 232],   # sidewalk
    [70, 70, 70],     # building
    [102, 102, 156],  # wall
    [190, 153, 153],  # fence
    [153, 153, 153],  # pole
    [250, 170, 30],   # traffic light
    [220, 220, 0],    # traffic sign
    [107, 142, 35],   # vegetation
    [152, 251, 152],  # terrain
    [70, 130, 180],   # sky
    [220, 20, 60],    # person
    [255, 0, 0],      # rider
    [0, 0, 142],      # car
    [0, 0, 70],       # truck
    [0, 60, 100],     # bus
    [0, 80, 100],     # train
    [0, 0, 230],      # motorcycle
    [119, 11, 32],    # bicycle
    [0, 0, 0],        # none
], dtype=np.float32)

TRAIN_SCENES = [
    "aachen", "bochum", "bremen", "cologne", "darmstadt", "dusseldorf",
    "erfurt", "hamburg", "hanover", "jena", "krefeld", "monchengladbach",
    "strasbourg", "stuttgart", "tubingen", "ulm", "weimar", "zurich",
]
VAL_SCENES = ["frankfurt", "lindau", "munster"]

IMG_EXT = "_leftImg8bit.png"
SEG_EXT = "_gtFine_myseg_id.png"


def vis_seg_ids(ids: np.ndarray) -> np.ndarray:
    """(H, W) int ids -> (H, W, 3) float rgb in [0,1] (utils/net_utils.py:57-70)."""
    return COLOR_MAP[ids] / 255.0
