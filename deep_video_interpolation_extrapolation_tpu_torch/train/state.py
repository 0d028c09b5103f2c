"""Train state with per-submodel optimizers (counterpart of train/state.py).

One torch optimizer per top-level submodule of the composite (the
reference builds one per submodel, runners/InterTrainer.py:79-83) and a
step behind each one's ``train_*`` flag.  Where some submodel trains, the
ones whose flag is off are frozen: their parameters stop requiring grad,
so their forward runs without autograd (``models/composite``) and no
gradient is made for them, the same update as the JAX step, which
computes their gradients and discards them.  Where none trains, every
gradient is computed and no submodel steps, as in the JAX step.  Adamax here is torch's, which
puts eps inside the max exactly as optax's adamax does
(u = max(b2 * u, |g| + eps)), with the same bias-corrected step; Adam is
torch's, the update of ``optax.adam`` (eps outside the square root of the
bias-corrected second moment); SGD is torch's without momentum, the update
of ``optax.sgd`` (w -= lr * g); the legacy discriminators' SGD with
momentum 0.9 (``sgd_momentum``) is torch's with no dampening, the update of
``optax.sgd(lr, momentum=0.9)`` (t = g + 0.9 t, w -= lr * t).

The legacy models (``train/legacy.py``) train under the same state: the
single generators and the video VAEs as one submodel, the whole model
(name ``""``), with the coarse optimizer; ``GAN``'s ``netG`` (Adamax) and
``netD`` (SGD with momentum at the frame discriminator's learning rate);
``RefineNet``'s coarse and refine models by their own flags and
optimizers; ``RefineGAN``'s coarse and refine models on the coarse
optimizer and its ``discriminator`` on SGD with momentum, both at the
coarse learning rate (legacy.py:351-490).

Unlike the JAX state, this one is mutable: ``apply_updates`` steps the
optimizers, which update the model's parameters in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.models.features import (
    ResNet101Features,
    VGG19Features,
)
from deep_video_interpolation_extrapolation_tpu_torch.parallel import dist

# the legacy models trained whole by the coarse optimizer (legacy.py:175,
# :492)
WHOLE = ("UNet", "SepUNet", "MyFRRN", "PSPNet", "PSPNetV2", "B2SNet",
         "GridNet", "VAE", "VAE_S", "VAE_SD")


def submodel_specs(cfg: Config) -> Dict[str, Tuple[str, float, bool]]:
    """Submodule name -> (optimizer, lr, train flag) (state.py:79-110): the
    coarse model Adamax(coarse_lr) (InterTrainer.py:79), the refiner
    Adamax(refine_lr) (:81), stage 3 the refiner's pair (:83); the
    inpainter of ExtraInpaintNet its own (``--inpaint_o``, ``--inpaint_lr``,
    ``--train_inpaint``; state.py:97-98); InterGANNet's track generator
    Adamax at the coarse learning rate behind ``--train_coarse``
    (InterGANTrainer.py:108, :452) and each discriminator Adam at its own
    learning rate behind its own flag (InterGANTrainer.py:110-116); the
    legacy models as the module docstring says."""
    coarse = (cfg.coarse_optimizer, cfg.coarse_learning_rate, True)
    if cfg.model in WHOLE:
        return {"": coarse}
    if cfg.model == "GAN":
        return {"netG": ("adamax", cfg.coarse_learning_rate, True),
                "netD": ("sgd_momentum", cfg.frame_disc_learning_rate, True)}
    if cfg.model == "RefineGAN":
        return {"coarse_model": coarse[:2] + (cfg.train_coarse,),
                "refine_model": coarse,
                "discriminator": ("sgd_momentum", cfg.coarse_learning_rate,
                                  True)}
    if cfg.model not in ("InterNet", "InterRefineNet", "InterStage3Net",
                         "InterGANNet", "ExtraNet", "ExtraInpaintNet",
                         "RefineNet"):
        raise KeyError(cfg.model)
    specs = {"coarse_model": (cfg.coarse_optimizer, cfg.coarse_learning_rate,
                              cfg.train_coarse)}
    if cfg.model in ("InterRefineNet", "InterStage3Net", "RefineNet"):
        specs["refine_model"] = (cfg.refine_optimizer,
                                 cfg.refine_learning_rate, cfg.train_refine)
    if cfg.model == "InterStage3Net":
        specs["stage3_model"] = (cfg.refine_optimizer,
                                 cfg.refine_learning_rate, cfg.train_stage3)
    if cfg.model == "ExtraInpaintNet":
        specs["inpaint_model"] = (cfg.inpaint_optimizer,
                                  cfg.inpaint_learning_rate,
                                  cfg.train_inpaint)
    if cfg.model == "InterGANNet":
        if cfg.track_gen:
            specs["track_gen_model"] = ("adamax", cfg.coarse_learning_rate,
                                        cfg.train_coarse)
        for fam in ("frame_disc", "frame_det_disc", "video_disc",
                    "video_det_disc"):
            if getattr(cfg, fam):
                specs[f"{fam}_model"] = (
                    "adam", getattr(cfg, f"{fam}_learning_rate"),
                    getattr(cfg, f"train_{fam}"))
    return specs


def make_optimizer(name: str, lr: float, params) -> torch.optim.Optimizer:
    """torch's Adamax or Adam (betas (0.9, 0.999), eps 1e-8), or plain SGD
    (no momentum, as ``optax.sgd(lr)``), at a constant learning rate, as
    the reference (state.py:60-76); ``sgd_momentum`` is SGD with momentum
    0.9, no dampening (``optax.sgd(lr, momentum=0.9)``, the legacy
    discriminators')."""
    if name == "sgd_momentum":
        return torch.optim.SGD(params, lr=lr, momentum=0.9, dampening=0.0)
    if name == "adamax":
        return torch.optim.Adamax(params, lr=lr, betas=(0.9, 0.999),
                                  eps=1e-8)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr)
    raise KeyError(name)


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizers: Dict[str, torch.optim.Optimizer]
    step: int = 0
    frozen_vgg: Optional[VGG19Features] = None   # not optimized
    # the track-object loss's network (--track_obj_loss), not optimized
    frozen_resnet: Optional[ResNet101Features] = None


def submodel(model: nn.Module, name: str) -> nn.Module:
    """The submodule a spec names; ``""`` is the whole model."""
    return getattr(model, name) if name else model


def create_train_state(cfg: Config, model: nn.Module,
                       frozen_vgg: Optional[VGG19Features] = None,
                       frozen_resnet: Optional[ResNet101Features] = None
                       ) -> TrainState:
    specs = {name: spec for name, spec in submodel_specs(cfg).items()
             if not name or hasattr(model, name)}
    optimizers = {name: make_optimizer(opt, lr,
                                       submodel(model, name).parameters())
                  for name, (opt, lr, _) in specs.items()}
    if any(trains for _, _, trains in specs.values()):
        for name, (_, _, trains) in specs.items():
            submodel(model, name).requires_grad_(trains)
    return TrainState(model=model, optimizers=optimizers,
                      frozen_vgg=frozen_vgg, frozen_resnet=frozen_resnet)


def apply_updates(cfg: Config, state: TrainState) -> TrainState:
    """Step every submodel whose train flag is set, on the grads left in
    its parameters' ``.grad``; the others do not move.  Under data
    parallelism (``parallel/dist``) each stepped submodel's grads are first
    averaged over the ranks, one flat bucket a submodel, as XLA reduces
    the gradients of a batch sharded over the ``data`` axis; under spatial
    sharding summed over each spatial group first (a band's gradient is
    its share); a frozen submodel has none to reduce."""
    for name, (_, _, trains) in submodel_specs(cfg).items():
        if trains and name in state.optimizers:
            dist.average_grads(submodel(state.model, name).parameters(),
                               cfg.num_spatial_shards)
            state.optimizers[name].step()
    state.step += 1
    return state


def gan_weights_init(model: nn.Module, generator: torch.Generator
                     ) -> nn.Module:
    """The DCGAN init of the legacy GAN head (nets/GAN.py:32-33 applies
    utils/net_utils.py:31-37 ``weights_init`` to netG and netD;
    state.py:184-208 of the JAX package): every conv and transposed-conv
    weight (a 4-D ``weight``) from N(0, 0.02), every BatchNorm scale from
    N(1, 0.02) and its bias 0; dense weights and conv biases untouched.
    Draws come from ``generator``, in the order of ``named_parameters``."""
    from deep_video_interpolation_extrapolation_tpu_torch.models.subnets import (
        BatchNorm,
    )
    bns = {id(m.weight): m for m in model.modules()
           if isinstance(m, BatchNorm)}
    bn_bias = {id(m.bias) for m in bns.values()}
    with torch.no_grad():
        for _, p in model.named_parameters():
            if id(p) in bns:
                p.copy_(1.0 + 0.02 * torch.randn(
                    p.shape, generator=generator, device=generator.device))
            elif id(p) in bn_bias:
                p.zero_()
            elif p.dim() == 4:
                p.copy_(0.02 * torch.randn(p.shape, generator=generator,
                                           device=generator.device))
    return model
