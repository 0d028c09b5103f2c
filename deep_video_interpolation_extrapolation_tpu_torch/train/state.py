"""Train state with per-submodel optimizers (counterpart of train/state.py).

One torch optimizer per top-level submodule of the composite (the
reference builds one per submodel, runners/InterTrainer.py:79-83) and a
step behind each one's ``train_*`` flag.  Adamax here is torch's, which
puts eps inside the max exactly as optax's adamax does
(u = max(b2 * u, |g| + eps)), with the same bias-corrected step.

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
    VGG19Features,
)

_QUEUE = "ROADMAP.md queue 1"


def submodel_specs(cfg: Config) -> Dict[str, Tuple[str, float, bool]]:
    """Submodule name -> (optimizer, lr, train flag).  InterNet has one,
    the coarse model (InterTrainer.py:79)."""
    if cfg.model != "InterNet":
        raise NotImplementedError(
            f"the {cfg.model} train state is not ported yet ({_QUEUE})")
    return {"coarse_model": (cfg.coarse_optimizer, cfg.coarse_learning_rate,
                             cfg.train_coarse)}


def make_optimizer(name: str, lr: float, params) -> torch.optim.Optimizer:
    """torch's Adamax (betas (0.9, 0.999), eps 1e-8) at a constant learning
    rate, as the reference; the recipe's only optimizer."""
    if name != "adamax":
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet ({_QUEUE})")
    return torch.optim.Adamax(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizers: Dict[str, torch.optim.Optimizer]
    step: int = 0
    frozen_vgg: Optional[VGG19Features] = None   # not optimized


def create_train_state(cfg: Config, model: nn.Module,
                       frozen_vgg: Optional[VGG19Features] = None
                       ) -> TrainState:
    optimizers = {
        name: make_optimizer(opt, lr, getattr(model, name).parameters())
        for name, (opt, lr, _) in submodel_specs(cfg).items()
        if hasattr(model, name)}
    return TrainState(model=model, optimizers=optimizers,
                      frozen_vgg=frozen_vgg)


def apply_updates(cfg: Config, state: TrainState) -> TrainState:
    """Step every submodel whose train flag is set, on the grads left in
    its parameters' ``.grad``; the others do not move."""
    for name, (_, _, trains) in submodel_specs(cfg).items():
        if trains and name in state.optimizers:
            state.optimizers[name].step()
    state.step += 1
    return state
