"""Checkpoint save and load with per-submodel granularity (counterpart of the
JAX package's ``train/checkpoint.py``).

Reference: a per-epoch ``torch.save`` of {session, epoch, per-submodel
state and optimizer dicts} named ``<model>_<mode>_<syn_type>_<session>_
<epoch>_<step>`` under ``<exp>/checkpoint/`` (runners/InterTrainer.py:
867-886), with selective merge-loading through ``--load_coarse``,
``--load_refine``, ... (InterTrainer.py:889-960).

The file is one ``torch.save`` dict: ``session``, ``epoch`` (the finished
epoch + 1), ``step``, each submodel's ``state_dict`` under its name
(``coarse_model``, ...) and each optimizer's under ``<part>_optimizer``
(``coarse_optimizer``, ...).  The submodels carry the reference's
``state_dict`` names, so a reference checkpoint loads as it is.  Weights
load through ``load_state_dict``, which copies into each parameter in
place: the kernels' weight layouts (``core/hw.derived``) see the version
counter move and rebuild.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional

import torch

from deep_video_interpolation_extrapolation_tpu_torch.train.state import (
    TrainState,
)


def checkpoint_name(cfg, epoch: int, step: int) -> str:
    return f"{cfg.model}_{cfg.mode}_{cfg.syn_type}_{cfg.session}_{epoch}_{step}"


def checkpoint_dir(base_dir: str) -> str:
    return os.path.join(base_dir, "checkpoint")


def optimizer_key(submodel: str) -> str:
    """``coarse_model`` -> ``coarse_optimizer``."""
    return submodel[:-len("_model")] + "_optimizer"


def save_checkpoint(cfg, base_dir: str, state: TrainState, epoch: int,
                    step: int) -> str:
    path = os.path.abspath(
        os.path.join(checkpoint_dir(base_dir), checkpoint_name(cfg, epoch, step)))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    ckpt = {"session": cfg.session, "epoch": epoch + 1, "step": state.step}
    for name, sub in state.model.named_children():
        ckpt[name] = sub.state_dict()
    for name, opt in state.optimizers.items():
        ckpt[optimizer_key(name)] = opt.state_dict()
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)          # a reader never sees a partial file
    return path


def load_checkpoint(path: str, map_location="cpu"):
    return torch.load(os.path.abspath(path), map_location=map_location,
                      weights_only=True)


def _strip_module(sd):
    """Drop the ``module.`` prefix a DistributedDataParallel model's keys
    carry."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def selective_load(state: TrainState, ckpt,
                   submodels: Optional[Iterable[str]] = None,
                   load_opt: bool = True) -> List[str]:
    """Load chosen submodels (and their optimizers) from ``ckpt`` into
    ``state`` in place.  ``submodels=None`` loads every submodel present in
    both.  Returns the names loaded."""
    names = (list(submodels) if submodels is not None else
             [n for n, _ in state.model.named_children() if n in ckpt])
    loaded = []
    for name in names:
        if name not in ckpt or not hasattr(state.model, name):
            continue
        getattr(state.model, name).load_state_dict(_strip_module(ckpt[name]))
        loaded.append(name)
        okey = optimizer_key(name)
        if load_opt and okey in ckpt and name in state.optimizers:
            state.optimizers[name].load_state_dict(ckpt[okey])
    return loaded


def submodels_to_load(cfg):
    """--load_coarse/--load_refine/... flag mapping (InterTrainer.py:889-960)."""
    sel = []
    if cfg.load_coarse:
        sel.append("coarse_model")
    if cfg.load_refine:
        sel.append("refine_model")
    if cfg.load_stage3:
        sel.append("stage3_model")
    if cfg.load_inpaint:
        sel.append("inpaint_model")
    if cfg.load_frame_disc:
        sel.append("frame_disc_model")
    if cfg.load_frame_det_disc:
        sel.append("frame_det_disc_model")
    if cfg.load_video_disc:
        sel.append("video_disc_model")
    if cfg.load_video_det_disc:
        sel.append("video_det_disc_model")
    return sel or None
