"""Argparse surface of the port: a copy of the JAX package's
``cli/options.py`` flag for flag (the reference's global flags plus the
``EXTRA`` and ``INTER`` subparsers and the four discriminator families,
``options/options.py:10-536``), with the same dest names, defaults and
choices, so every command line of ``docs/RECIPES.md`` parses the same.  It
returns the port's :class:`core.config.Config`.  It adds no flag: the CPU
is asked for through the ``device=`` keyword of ``cli.main.run``.
"""

from __future__ import annotations

import argparse

from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config


def _add_global_flags(p: argparse.ArgumentParser) -> None:
    g = p.add_argument
    g("--dataset", dest="dataset", default="cityscape",
      choices=["cityscape", "ucf101", "vimeo", "synthetic"])
    g("--split", dest="split", default="train",
      choices=["train", "val", "test", "cycgen", "mycycgen"])
    g("--img_dir", dest="img_dir", default=None, type=str)
    g("--seg_dir", dest="seg_dir", default=None, type=str)
    g("--cycgen_load_dir", dest="cycgen_load_dir", default=None, type=str)
    g("--input_h", dest="input_h", type=int, default=128)
    g("--input_w", dest="input_w", type=int, default=256)
    g("--syn_type", dest="syn_type", default="extra", choices=["inter", "extra"])
    g("--mode", dest="mode", default="xs2xs", choices=["xs2xs", "xx2x"])
    g("--bs", dest="batch_size", type=int, default=1)
    g("--epochs", dest="epochs", type=int, default=20)
    g("--interval", dest="interval", type=float, default=1)
    g("--nw", dest="num_workers", type=int, default=4)
    g("--port", dest="port", type=int, default=None)
    g("--seed", dest="seed", type=int, default=1024)
    g("--start_epoch", dest="start_epoch", type=int, default=1)
    g("--disp_interval", dest="disp_interval", type=int, default=10)
    g("--lr_decay_step", dest="lr_decay_step", type=int, default=5)
    g("--lr_decay_gamma", dest="lr_decay_gamma", type=float, default=1.0)
    g("--save_dir", dest="save_dir", default="log", type=str)
    g("--one_hot_seg", dest="one_hot_seg", action="store_true")
    g("--ef", dest="effec_flow", action="store_true")
    g("--s", dest="session", type=int, default=0)
    g("--r", dest="resume", action="store_true")
    g("--checksession", dest="checksession", type=int, default=1)
    g("--checkepoch", dest="checkepoch", type=int, default=1)
    g("--checkepoch_range", dest="checkepoch_range", action="store_true")
    g("--checkepoch_low", dest="checkepoch_low", type=int, default=1)
    g("--checkepoch_up", dest="checkepoch_up", type=int, default=20)
    g("--checkpoint", dest="checkpoint", type=int, default=0)
    g("--load_dir", dest="load_dir", default="models", type=str)
    g("--l1_w", dest="l1_weight", type=float, default=80)
    g("--gdl_w", dest="gdl_weight", type=float, default=80)
    g("--vgg_w", dest="vgg_weight", type=float, default=20)
    g("--ce_w", dest="ce_weight", type=float, default=30)
    g("--ssim_w", dest="ssim_weight", type=float, default=20)
    g("--kld_w", dest="kld_weight", type=float, default=20)
    g("--track_obj_loss", dest="track_obj_loss", action="store_true")
    g("--track_obj_w", dest="track_obj_weight", type=float, default=80)
    g("--vid_len", dest="vid_length", type=int, default=1)
    g("--n_track", dest="num_track_per_img", type=int, default=4)
    g("--highres_large", dest="highres_large", action="store_true")
    # ---- additions of the JAX package (no reference flag) ----
    g("--torch_ckpt", dest="torch_ckpt", default=None,
      help="reference .pth checkpoint to load (its state_dict names)")
    g("--compute_dtype", dest="compute_dtype", default="bfloat16",
      choices=["bfloat16", "float32"])
    g("--num_data_shards", dest="num_data_shards", type=int, default=0)
    g("--num_spatial_shards", dest="num_spatial_shards", type=int, default=1)
    g("--remat", dest="remat", action="store_true")


_OPTIMIZER_CHOICES = ["adamax", "adam", "sgd"]


def _add_coarse_flags(p: argparse.ArgumentParser, coarse_choices) -> None:
    p.add_argument("--coarse_model", dest="coarse_model", default="HRNet",
                   choices=coarse_choices)
    p.add_argument("--coarse_o", dest="coarse_optimizer", default="adamax",
                   choices=_OPTIMIZER_CHOICES)
    p.add_argument("--coarse_lr", dest="coarse_learning_rate", type=float, default=0.001)
    p.add_argument("--load_coarse", dest="load_coarse", action="store_true")
    p.add_argument("--train_coarse", dest="train_coarse", action="store_true")


def _add_extra_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", dest="model", default="ExtraNet",
                   choices=["ExtraNet", "ExtraInpaintNet"])
    p.add_argument("--load_model", dest="load_model", default="ExtraNet",
                   choices=["ExtraNet", "ExtraInpaintNet"])
    _add_coarse_flags(p, ["HRNet"])
    p.add_argument("--inpaint", dest="inpaint", action="store_true")
    p.add_argument("--inpaint_mask", dest="inpaint_mask", action="store_true")
    p.add_argument("--inpaint_model", dest="inpaint_model", default="InpaintUnet",
                   choices=["InpaintUnet"])
    p.add_argument("--inpaint_o", dest="inpaint_optimizer", default="adamax",
                   choices=_OPTIMIZER_CHOICES)
    p.add_argument("--inpaint_lr", dest="inpaint_learning_rate", type=float, default=0.001)
    p.add_argument("--load_inpaint", dest="load_inpaint", action="store_true")
    p.add_argument("--train_inpaint", dest="train_inpaint", action="store_true")
    p.add_argument("--num_pred_once", dest="num_pred_once", type=int, default=1)
    p.add_argument("--num_pred_step", dest="num_pred_step", type=int, default=1)
    p.add_argument("--fix_init_frames", dest="fix_init_frames", action="store_true")


_FRAME_DISC_CHOICES = [
    "FrameDiscriminator", "FrameLocalDiscriminator", "FrameSNDiscriminator",
    "FrameSNLocalDiscriminator", "FrameDetDiscriminator",
    "FrameSNDetDiscriminator",
]
_FRAME_DET_DISC_CHOICES = _FRAME_DISC_CHOICES + ["FrameLSSNDetDiscriminator"]
_VIDEO_DISC_CHOICES = [
    "VideoDiscriminator", "VideoLocalDiscriminator", "VideoSNDiscriminator",
    "VideoSNLocalDiscriminator", "VideoDetDiscriminator",
    "VideoSNDetDiscriminator", "VideoLSSNDetDiscriminator",
    "VideoVecSNDetDiscriminator", "VideoPoolSNDetDiscriminator",
]
_VIDEO_DET_DISC_CHOICES = _VIDEO_DISC_CHOICES[:7] + [
    "VideoLocalPatchSNDetDiscriminator",
] + _VIDEO_DISC_CHOICES[7:] + [
    "VideoGlobalZeroSNDetDiscriminator", "VideoGlobalResSNDetDiscriminator",
    "VideoGlobalMaskSNDetDiscriminator", "VideoGlobalCoordSNDetDiscriminator",
]


def _add_disc_family(p: argparse.ArgumentParser, stem: str, default_model: str,
                     model_choices) -> None:
    p.add_argument(f"--{stem}", dest=stem, action="store_true")
    p.add_argument(f"--{stem}_o", dest=f"{stem}_optimizer", default="adamax",
                   choices=_OPTIMIZER_CHOICES)
    p.add_argument(f"--{stem}_lr", dest=f"{stem}_learning_rate", type=float, default=0.001)
    p.add_argument(f"--train_{stem}", dest=f"train_{stem}", action="store_true")
    p.add_argument(f"--load_{stem}", dest=f"load_{stem}", action="store_true")
    p.add_argument(f"--load_{stem}_model", dest=f"load_{stem}_model",
                   default=default_model, choices=model_choices)
    p.add_argument(f"--{stem}_model", dest=f"{stem}_model",
                   default=default_model, choices=model_choices)
    p.add_argument(f"--{stem}_d_w", dest=f"{stem}_disc_weight", type=float, default=1.0)
    p.add_argument(f"--{stem}_g_w", dest=f"{stem}_gen_weight", type=float, default=1.0)


def _add_inter_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", dest="model", default="InterNet",
                   choices=["InterNet", "InterRefineNet", "InterStage3Net", "InterGANNet"])
    p.add_argument("--load_model", dest="load_model", default="InterNet",
                   choices=["InterNet", "InterRefineNet", "InterStage3Net",
                            "InterGANNet"])
    p.add_argument("--n_sc", dest="n_scales", type=int, default=1)
    p.add_argument("--gan", dest="gan", action="store_true")
    _add_coarse_flags(p, ["HRNet", "VAEHRNet"])
    p.add_argument("--vae", dest="vae", action="store_true")
    p.add_argument("--seg_disc", dest="seg_disc", action="store_true")
    p.add_argument("--track_gen", dest="track_gen", action="store_true")
    p.add_argument("--track_gen_model", dest="track_gen_model", default="TrackGen",
                   choices=["TrackGen", "TrackGenV2"])
    p.add_argument("--loc_diff_w", dest="loc_diff_weight", type=float, default=100)
    p.add_argument("--refine", dest="refine", action="store_true")
    p.add_argument("--with_gt_seg", dest="with_gt_seg", action="store_true")
    p.add_argument("--refine_model", dest="refine_model", default="refineUnet",
                   choices=["refineUnet", "SRNRefine"])
    p.add_argument("--refine_o", dest="refine_optimizer", default="adamax",
                   choices=_OPTIMIZER_CHOICES)
    p.add_argument("--refine_lr", dest="refine_learning_rate", type=float, default=0.001)
    p.add_argument("--load_refine", dest="load_refine", action="store_true")
    p.add_argument("--train_refine", dest="train_refine", action="store_true")
    p.add_argument("--refine_l1_w", dest="refine_l1_weight", type=float, default=80)
    p.add_argument("--refine_gdl_w", dest="refine_gdl_weight", type=float, default=80)
    p.add_argument("--refine_vgg_w", dest="refine_vgg_weight", type=float, default=20)
    p.add_argument("--refine_ssim_w", dest="refine_ssim_weight", type=float, default=20)
    p.add_argument("--stage3", dest="stage3", action="store_true")
    p.add_argument("--train_stage3", dest="train_stage3", action="store_true")
    p.add_argument("--load_stage3", dest="load_stage3", action="store_true")
    p.add_argument("--stage3_model", dest="stage3_model", default="MSResAttnRefine",
                   choices=["MSResAttnRefine", "MSResAttnRefineV2",
                            "MSResAttnRefineV2Base", "MSResAttnRefineV3"])
    p.add_argument("--stage3_prop", dest="stage3_prop", action="store_true")
    p.add_argument("--stage3_flow_consist_w", dest="stage3_flow_consist_weight",
                   type=float, default=0)
    p.add_argument("--local_disc", dest="local_disc", action="store_true")
    _add_disc_family(p, "frame_disc", "FrameDiscriminator",
                     _FRAME_DISC_CHOICES)
    _add_disc_family(p, "frame_det_disc", "FrameDiscriminator",
                     _FRAME_DET_DISC_CHOICES)
    _add_disc_family(p, "video_disc", "VideoDiscriminator",
                     _VIDEO_DISC_CHOICES)
    _add_disc_family(p, "video_det_disc", "VideoDiscriminator",
                     _VIDEO_DET_DISC_CHOICES)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="joint video interpolation & extrapolation (PyTorch)")
    _add_global_flags(parser)
    sub = parser.add_subparsers(dest="runner", required=True)
    _add_extra_flags(sub.add_parser("EXTRA"))
    _add_inter_flags(sub.add_parser("INTER"))
    return parser


def parse_args(argv=None) -> Config:
    ns = build_parser().parse_args(argv)
    return Config.from_namespace(ns).validate()
