"""GAN losses (counterpart of losses/gan.py; the reference's
losses.py:247-256): the hinge ``GANScalarLoss``.

  D real:  weight * mean(relu(1 - D(real)))
  D fake:  weight * mean(relu(1 + D(fake)))
  G:       weight * mean(relu(1 - D(fake)))   (target_is_real=True)

``bce_gan_loss`` and ``gan_map_loss`` go with the legacy runners
(ROADMAP.md queue 1, item 8).
"""

from __future__ import annotations

import torch


def gan_scalar_loss(logits: torch.Tensor, target_is_real: bool,
                    weight: float = 1.0) -> torch.Tensor:
    """The hinge loss of ``GANScalarLoss.forward``, averaged in f32 and
    returned in the logits' dtype."""
    h = torch.relu(1.0 - logits) if target_is_real else torch.relu(
        logits + 1.0)
    return weight * h.float().mean().to(logits.dtype)


def hinge_d_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor,
                 weight: float = 1.0) -> torch.Tensor:
    return (gan_scalar_loss(real_logits, True, weight)
            + gan_scalar_loss(fake_logits, False, weight))


def hinge_g_loss(fake_logits: torch.Tensor,
                 weight: float = 1.0) -> torch.Tensor:
    return gan_scalar_loss(fake_logits, True, weight)
