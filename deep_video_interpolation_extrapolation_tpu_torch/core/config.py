"""Configuration of the ported slice.

The fields of the JAX package's ``core/config.Config`` that the port reads,
with the same names and defaults, so that either class can be handed to
``models/registry`` (the tests pass the JAX one, which checks that the names
match).  A field joins here when a ported module starts to read it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Config:
    syn_type: str = "extra"             # inter | extra
    highres_large: bool = False         # the 4-branch STAGE4_CFG
    coarse_model: str = "HRNet"
    model: str = "InterNet"
    compute_dtype: str = "bfloat16"     # activations/matmul dtype; masters f32
    # the INTER train step (train/inter.py)
    mode: str = "xs2xs"                 # xs2xs (rgb + seg) | xx2x
    l1_weight: float = 80.0
    gdl_weight: float = 80.0
    vgg_weight: float = 20.0
    ce_weight: float = 30.0
    ssim_weight: float = 20.0
    coarse_optimizer: str = "adamax"
    coarse_learning_rate: float = 0.001
    train_coarse: bool = False
    remat: bool = False                 # not ported: make_train_step raises
    # the refine and stage-3 composites (InterRefineNet, InterStage3Net)
    n_scales: int = 1                   # --n_sc
    refine_model: str = "refineUnet"    # only SRNRefine is ported
    stage3_model: str = "MSResAttnRefine"
    stage3_prop: bool = False
    # the video VAEs (models/vae_video.py)
    vid_length: int = 1                 # --vid_len
    input_h: int = 128                  # frame size the VAEs are built for
    input_w: int = 256
