"""Typed configuration of the port: the JAX package's ``core/config.Config``
field for field, with the same names, defaults and order (a test holds the
two equal), so that either class can be handed to ``models/registry`` and
``cli/options.parse_args`` fills every field.  The fields of paths the port
does not run yet (the GAN, EXTRA, sharding and ``--remat`` ones) are kept so
that every reference command line parses; the runner refuses those paths
with the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Config:
    # ---- global flags (options/options.py:11-165) ----
    dataset: str = "cityscape"          # cityscape | ucf101 | vimeo | synthetic
    split: str = "train"                # train | val | test | cycgen | mycycgen
    img_dir: Optional[str] = None
    seg_dir: Optional[str] = None
    cycgen_load_dir: Optional[str] = None
    input_h: int = 128
    input_w: int = 256
    syn_type: str = "extra"             # inter | extra
    mode: str = "xs2xs"                 # xs2xs | xx2x
    batch_size: int = 1                 # global batch over all devices (--bs)
    epochs: int = 20
    interval: float = 1.0
    num_workers: int = 4
    port: Optional[int] = None
    seed: int = 1024
    start_epoch: int = 1
    disp_interval: int = 10
    lr_decay_step: int = 5
    lr_decay_gamma: float = 1.0
    save_dir: str = "log"
    one_hot_seg: bool = False
    effec_flow: bool = False            # --ef
    session: int = 0                    # --s
    # resume / checkpoint (options/options.py:97-120)
    resume: bool = False                # --r
    checksession: int = 1
    checkepoch: int = 1
    checkepoch_range: bool = False
    checkepoch_low: int = 1
    checkepoch_up: int = 20
    checkpoint: int = 0
    load_dir: str = "models"
    # loss weights (options/options.py:122-152)
    l1_weight: float = 80.0
    gdl_weight: float = 80.0
    vgg_weight: float = 20.0
    ce_weight: float = 30.0
    ssim_weight: float = 20.0
    kld_weight: float = 20.0
    track_obj_loss: bool = False
    track_obj_weight: float = 80.0
    vid_length: int = 1                 # --vid_len
    num_track_per_img: int = 4          # --n_track
    highres_large: bool = False

    # ---- subparser selector ----
    runner: str = "INTER"               # EXTRA | INTER

    # ---- EXTRA subparser (options/options.py:173-234) ----
    # (model/load_model shared with INTER below)
    coarse_model: str = "HRNet"
    coarse_optimizer: str = "adamax"
    coarse_learning_rate: float = 0.001
    load_coarse: bool = False
    train_coarse: bool = False
    inpaint: bool = False
    inpaint_mask: bool = False
    inpaint_model: str = "InpaintUnet"
    inpaint_optimizer: str = "adamax"
    inpaint_learning_rate: float = 0.001
    load_inpaint: bool = False
    train_inpaint: bool = False
    num_pred_once: int = 1
    num_pred_step: int = 1
    fix_init_frames: bool = False

    # ---- INTER subparser (options/options.py:240-525) ----
    model: str = "InterNet"
    load_model: str = "InterNet"
    n_scales: int = 1                   # --n_sc
    gan: bool = False
    vae: bool = False
    seg_disc: bool = False
    track_gen: bool = False
    track_gen_model: str = "TrackGen"
    loc_diff_weight: float = 100.0
    # refine family
    refine: bool = False
    with_gt_seg: bool = False
    refine_model: str = "refineUnet"
    refine_optimizer: str = "adamax"
    refine_learning_rate: float = 0.001
    load_refine: bool = False
    train_refine: bool = False
    refine_l1_weight: float = 80.0
    refine_gdl_weight: float = 80.0
    refine_vgg_weight: float = 20.0
    refine_ssim_weight: float = 20.0
    # stage3 family
    stage3: bool = False
    train_stage3: bool = False
    load_stage3: bool = False
    stage3_model: str = "MSResAttnRefine"
    stage3_prop: bool = False
    stage3_flow_consist_weight: float = 0.0
    local_disc: bool = False
    # four discriminator families (options/options.py:366-525)
    frame_disc: bool = False
    frame_disc_optimizer: str = "adamax"
    frame_disc_learning_rate: float = 0.001
    train_frame_disc: bool = False
    load_frame_disc: bool = False
    load_frame_disc_model: str = "FrameDiscriminator"
    frame_disc_model: str = "FrameDiscriminator"
    frame_disc_disc_weight: float = 1.0
    frame_disc_gen_weight: float = 1.0
    frame_det_disc: bool = False
    frame_det_disc_optimizer: str = "adamax"
    frame_det_disc_learning_rate: float = 0.001
    train_frame_det_disc: bool = False
    load_frame_det_disc: bool = False
    load_frame_det_disc_model: str = "FrameDiscriminator"
    frame_det_disc_model: str = "FrameDiscriminator"
    frame_det_disc_disc_weight: float = 1.0
    frame_det_disc_gen_weight: float = 1.0
    video_disc: bool = False
    video_disc_optimizer: str = "adamax"
    video_disc_learning_rate: float = 0.001
    train_video_disc: bool = False
    load_video_disc: bool = False
    load_video_disc_model: str = "VideoDiscriminator"
    video_disc_model: str = "VideoDiscriminator"
    video_disc_disc_weight: float = 1.0
    video_disc_gen_weight: float = 1.0
    video_det_disc: bool = False
    video_det_disc_optimizer: str = "adamax"
    video_det_disc_learning_rate: float = 0.001
    train_video_det_disc: bool = False
    load_video_det_disc: bool = False
    load_video_det_disc_model: str = "VideoDiscriminator"
    video_det_disc_model: str = "VideoDiscriminator"
    video_det_disc_disc_weight: float = 1.0
    video_det_disc_gen_weight: float = 1.0

    # ---- additions of the JAX package (no reference flag) ----
    torch_ckpt: Optional[str] = None    # a reference .pth, loaded by name
    compute_dtype: str = "bfloat16"     # activations/matmul dtype; masters f32
    param_dtype: str = "float32"        # master params
    data_axis: str = "data"             # JAX mesh axis names: unused here
    spatial_axis: str = "spatial"       # mesh axis name for optional 2D sharding
    num_data_shards: int = 0            # > 1 waits for DDP (ROADMAP item 9)
    num_spatial_shards: int = 1
    remat: bool = False                 # not ported (ROADMAP item 4)
    donate_state: bool = True

    # -------------------------------------------------------------- helpers
    @property
    def n_classes(self) -> int:
        return 20

    @property
    def seg_encode_dim(self) -> int:
        return 4

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def crop_size(self) -> Tuple[int, int]:
        return (self.input_h, self.input_w)

    @classmethod
    def from_namespace(cls, ns: Any) -> "Config":
        """Build from an argparse namespace produced by ``cli.main``.

        Unknown attributes are ignored; missing ones keep their defaults.
        """
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in vars(ns).items() if k in fields}
        return cls(**kw)

    def validate(self) -> "Config":
        assert self.syn_type in ("inter", "extra"), self.syn_type
        assert self.mode in ("xs2xs", "xx2x"), self.mode
        assert self.runner in ("EXTRA", "INTER"), self.runner
        if self.runner == "EXTRA":
            assert self.model in ("ExtraNet", "ExtraInpaintNet"), self.model
        else:
            assert self.model in (
                "InterNet", "InterRefineNet", "InterStage3Net", "InterGANNet",
            ), self.model
        return self
