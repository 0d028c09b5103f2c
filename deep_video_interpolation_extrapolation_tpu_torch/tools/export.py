"""Serving export on ``torch.export`` (counterpart of the JAX package's
``tools/export.py``, whose artifact is StableHLO from ``jax.export``).

The reference has no deployment story: inference is the training repo plus
a checkpoint.  This module freezes a composite head's serving forward, or
its whole cycgen rollout, into one ``torch.export`` artifact:

- the weights travel in the file; loading it needs no model code and no
  checkpoint, only the ``dvie::`` ops registered (``load_exported`` imports
  the package's ``ops``, whose ``library`` defines them);
- every served kernel is one ``dvie::`` op in the graph
  (``ops/library.py``): on the card the program launches the kernels, on the
  CPU their plain versions.  The program runs on the device it was
  exported on (its weights' and inputs'), the counterpart of JAX's
  ``platforms``: export on the CPU for the CPU, on the card for the card.

Departures from the JAX module (ROADMAP.md queue 3):
- the VAE-generator heads take their prior draw z as an input tensor (the
  port's ``VAEHRNet`` ``noise``) where JAX takes an int32 seed for its
  ``noise`` rng: torch's generators and JAX's keys draw different numbers,
  and a tensor keeps the draw the caller's;
- ``export_rollout`` carries the ``_mini_test`` window, [prev, pred] frames
  and two seg maps, as ``serve.rollout`` does, not JAX's [pred, pred];
- the artifact needs the ``dvie::`` ops registered (the port's ``ops``
  imported), where JAX's StableHLO needs nothing of the package;
- the forward returns the composite's final stage (``serve.final_output``,
  as ``serve.forward``); JAX's returns the first two outputs, the coarse
  pair of a refine or inpaint head.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch import serve
from deep_video_interpolation_extrapolation_tpu_torch.core.seg import N_CLASSES
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.models.hrnet import (
    LATENT_C,
    dense_latent,
)


def _needs_noise_rng(cfg) -> bool:
    """VAE generators sample a prior z at eval (models/hrnet.py VAEHRNet)."""
    return cfg.vae or cfg.coarse_model == "VAEHRNet"


def noise_shape(cfg, batch_size: int):
    """The shape of the prior draw a VAE head's export takes: the latent
    VAEHRNet draws at eval, (B, 16 * H/16 * W/16) where the latent is
    dense, else (B, H/16, W/16, 16)."""
    h, w = cfg.input_h, cfg.input_w
    if dense_latent(h, w):
        return (batch_size, LATENT_C * (h // 16) * (w // 16))
    return (batch_size, h // 16, w // 16, LATENT_C)


class _Forward(nn.Module):
    """The serving forward: (rgb, seg) -> (rgb_pred, seg_pred), the
    composite's final stage (``serve.final_output``)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, rgb: torch.Tensor, seg: torch.Tensor):
        return serve.final_output(self.model(rgb, seg))


class _VaeForward(_Forward):
    """A VAE generator's serving forward: (z, rgb, seg) -> (rgb_pred,
    seg_pred), its coarse VAEHRNet at eval on the prior draw z."""

    def forward(self, z: torch.Tensor, rgb: torch.Tensor, seg: torch.Tensor):
        out = self.model.coarse_model(rgb, seg, train=False, noise=z)
        return out[0], out[1]


def forward_fn(cfg, model: nn.Module) -> nn.Module:
    """The serving forward of ``model`` as a module: (rgb, seg) ->
    (rgb_pred, seg_pred); a VAE generator's takes the prior draw z first,
    (z, rgb, seg), of ``noise_shape``.  The same call ``serve.forward``
    and the runner's cycgen make per window."""
    return (_VaeForward if _needs_noise_rng(cfg) else _Forward)(model)


def _example_inputs(cfg, model, batch_size: Optional[int]):
    b = batch_size or cfg.batch_size
    dev = next(model.parameters()).device
    dt = registry.compute_dtype(cfg)
    n_in = 3 if (cfg.syn_type == "extra" and cfg.fix_init_frames) else 2
    rgb = torch.zeros((b, cfg.input_h, cfg.input_w, 3 * n_in), dtype=dt,
                      device=dev)
    seg = torch.zeros((b, cfg.input_h, cfg.input_w, N_CLASSES * n_in),
                      dtype=dt, device=dev)
    if _needs_noise_rng(cfg):
        return (torch.zeros(noise_shape(cfg, b), dtype=torch.float32,
                            device=dev), rgb, seg)
    return rgb, seg


def _export(module: nn.Module, args, path: str) -> str:
    with torch.no_grad():
        program = torch.export.export(module.eval(), args, strict=False)
    torch.export.save(program, path)
    return path


def export_forward(cfg, model: nn.Module, path: str,
                   batch_size: Optional[int] = None) -> str:
    """Serialize ``model``'s serving forward to ``path``; returns ``path``.

    ``batch_size`` defaults to ``cfg.batch_size``; the inputs are NHWC in
    the compute dtype (``--compute_dtype``) on the model's device: 2 input
    frames (rgb (B,H,W,6), seg (B,H,W,40)) for interpolation and plain
    extrapolation, 3 for ``--fix_init_frames`` extrapolation.  GAN and
    plain-VAE heads export their generator's eval forward, its prior draw
    z an f32 input first (``noise_shape``); the discriminators are
    training-only and are not serialized."""
    if cfg.model in ("VAE", "VAE_S", "VAE_SD"):
        raise ValueError(
            "legacy flow-VAE heads take 5-D video (+ fg/bg mask) inputs "
            "(models/vae_video.py) and do not fit the (rgb, seg) serving "
            "signature; export a composite head instead")
    return _export(forward_fn(cfg, model),
                   _example_inputs(cfg, model, batch_size), path)


class _Rollout(nn.Module):
    """``serve.rollout``'s window as one module: (img1, img2 (B,H,W,3) in
    [0, 1], seg1, seg2 (B,H,W) uint8) -> (frames (N,B,H,W,3) in [0, 1], ids
    (N,B,H,W) uint8), N = steps * num_pred_once."""

    def __init__(self, cfg, model: nn.Module, steps: int):
        super().__init__()
        self.forward_fn = _Forward(model)
        self.steps = steps
        self.num_pred_once = cfg.num_pred_once if cfg.syn_type == "extra" \
            else 1
        self.fix_init_frames = bool(cfg.syn_type == "extra"
                                    and cfg.fix_init_frames)

    def forward(self, img1, img2, seg1, seg2):
        frames, ids = serve.rollout_with(
            self.forward_fn, [img1, img2], [seg1, seg2], self.steps,
            self.num_pred_once, self.fix_init_frames)
        return torch.stack(frames), torch.stack(ids)


def rollout_fn(cfg, model: nn.Module, steps: int) -> nn.Module:
    """The autoregressive cycgen rollout as one module: ``steps`` forwards
    unrolled on ``Runner._mini_test``'s window (``serve.rollout_with``):
    each step slides [prev, pred] and the predicted seg ids come back as
    one-hots."""
    return _Rollout(cfg, model, steps)


def export_rollout(cfg, model: nn.Module, path: str, steps: int,
                   batch_size: Optional[int] = None) -> str:
    """Serialize the ``steps``-step rollout to ``path``; returns ``path``.

    Signature: (img1, img2 (B,H,W,3) in [0, 1] in the compute dtype, seg1,
    seg2 (B,H,W) uint8) -> (frames (N,B,H,W,3), ids (N,B,H,W) uint8), N =
    ``steps * num_pred_once``.  The whole inference product, N generated
    frames from one 2-frame window, is one artifact."""
    if _needs_noise_rng(cfg):
        raise ValueError("rollout export covers the deterministic "
                         "interpolation head; VAE heads need a seed per "
                         "window — export_forward serves those")
    b = batch_size or cfg.batch_size
    dev = next(model.parameters()).device
    dt = registry.compute_dtype(cfg)
    # four distinct tensors: an input passed twice would be traced as one
    imgs = [torch.zeros((b, cfg.input_h, cfg.input_w, 3), dtype=dt,
                        device=dev) for _ in range(2)]
    ids = [torch.zeros((b, cfg.input_h, cfg.input_w), dtype=torch.uint8,
                       device=dev) for _ in range(2)]
    return _export(rollout_fn(cfg, model, steps), (*imgs, *ids), path)


def load_exported(path: str) -> Callable:
    """Deserialize an ``export_forward`` or ``export_rollout`` artifact into
    a callable (the program's module, its weights frozen: a serving
    program builds no autograd graph).  No model code or checkpoint is
    needed; the ``dvie::`` ops are registered by importing the package's
    ``ops``."""
    from deep_video_interpolation_extrapolation_tpu_torch import (  # noqa: F401
        ops,
    )
    return torch.export.load(path).module().requires_grad_(False)
