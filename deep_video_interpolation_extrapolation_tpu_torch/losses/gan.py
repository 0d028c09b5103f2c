"""GAN losses (counterpart of losses/gan.py; the reference's
losses.py:247-256): the hinge ``GANScalarLoss``.

  D real:  weight * mean(relu(1 - D(real)))
  D fake:  weight * mean(relu(1 + D(fake)))
  G:       weight * mean(relu(1 - D(fake)))   (target_is_real=True)

``bce_gan_loss`` (the legacy ``GANLoss``, losses.py:260-300) and
``gan_map_loss`` (the patch-map L1 loss, losses.py:302-336) go with the
legacy train steps (``train/legacy.py``).
"""

from __future__ import annotations

from typing import Sequence

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


def bce_gan_loss(preds, target_is_real: bool) -> torch.Tensor:
    """BCE on sigmoid outputs (gan.py:36-53 of the JAX package), in f32:
    ``preds`` is a prediction, a list whose last element is one, or a list
    of per-scale lists (pix2pixHD's multiscale output), summed over scales.
    The prediction is clipped to [1e-12, 1 - 1e-12] as in JAX; only the
    target's term is formed and each log is held at >= -100 (torch's
    ``BCELoss`` rule, the reference's), which changes nothing where the JAX
    loss is finite and keeps a prediction of exactly 0 or 1 (1 - 1e-12
    rounds to 1 in f32) from giving inf or NaN."""
    def one(p):
        p = p.float().clamp(1e-12, 1 - 1e-12)
        logp = torch.log(p) if target_is_real else torch.log(1 - p)
        return -logp.clamp_min(-100.0).mean()

    if isinstance(preds, (list, tuple)) and isinstance(preds[0], (list, tuple)):
        return sum(one(p[-1]) for p in preds)
    if isinstance(preds, (list, tuple)):
        return one(preds[-1])
    return one(preds)


def gan_map_loss(preds: Sequence, label_map=None,
                 target_is_real: bool = True) -> torch.Tensor:
    """The legacy patch-map L1 GAN loss (gan.py:55-71 of the JAX package,
    with the reference's overrides: both ratios 1 and the fake path's label
    map zero-filled, so ``label_map`` is unused): the mean over scales of
    mean|D - 1| for the real target, of mean|D| for the fake one, each
    scale's prediction the last of its list, in f32."""
    loss = 0.0
    for pred_list in preds:
        pred = (pred_list[-1] if isinstance(pred_list, (list, tuple))
                else pred_list).float()
        loss = loss + ((pred - 1.0).abs().mean() if target_is_real
                       else pred.abs().mean())
    return loss / len(preds)
