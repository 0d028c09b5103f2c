"""Model registry (counterpart of models/registry.py) for the ported slice:
``--model InterNet`` with ``--coarse_model HRNet`` in interpolation mode.
Any other model raises ``NotImplementedError`` naming its ROADMAP queue."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config

_QUEUE = "ROADMAP.md queue 1"


def compute_dtype(cfg: Config) -> torch.dtype:
    return {"bfloat16": torch.bfloat16,
            "float32": torch.float32}[cfg.compute_dtype]


def build_coarse(cfg: Config, use_kernels: bool = True) -> nn.Module:
    from deep_video_interpolation_extrapolation_tpu_torch.models.hrnet import (
        HRNet,
    )
    if cfg.coarse_model != "HRNet":
        raise NotImplementedError(
            f"coarse model {cfg.coarse_model!r} is not ported yet "
            f"({_QUEUE}, items 5-8)")
    if cfg.syn_type != "inter":
        raise NotImplementedError(
            f"syn_type {cfg.syn_type!r} is not ported yet ({_QUEUE}, item 6)")
    return HRNet(dtype=compute_dtype(cfg), use_kernels=use_kernels,
                 highres_large=cfg.highres_large)


def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter from ``numpy.random.RandomState(seed)``: conv
    weights lecun-normal (std 1/sqrt(fan_in), the JAX ``Conv`` init's
    scale), biases zero.  Deterministic across devices and torch builds."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            if name.endswith("bias"):
                p.zero_()
            else:
                fan_in = int(np.prod(p.shape[1:]))
                p.copy_(torch.from_numpy(rng.normal(
                    0.0, 1.0 / np.sqrt(fan_in), p.shape).astype(np.float32)))
    return model


def build_model(cfg: Config, device="cpu", seed: int = 0,
                use_kernels: bool = True) -> nn.Module:
    """Build the composite named by ``cfg.model``, weights from ``seed``,
    in eval mode on ``device``."""
    from deep_video_interpolation_extrapolation_tpu_torch.models import (
        composite,
    )
    if cfg.model != "InterNet":
        raise NotImplementedError(
            f"model {cfg.model!r} is not ported yet ({_QUEUE})")
    model = composite.InterNet(cfg, use_kernels=use_kernels)
    init_weights(model, seed)
    return model.to(device).eval()
