"""The VAE's KL divergence (counterpart of losses/vae.py; the reference's
losses.py:50-60)."""

from __future__ import annotations

import torch


def kld_loss(mu: torch.Tensor, logvar: torch.Tensor,
             weight: float = 1.0) -> torch.Tensor:
    """-0.5 * sum(1 + logvar - mu^2 - exp(logvar)) / batch, times weight,
    in the moments' dtype."""
    kld = -0.5 * torch.sum(1.0 + logvar - mu * mu - torch.exp(logvar))
    return weight * kld / mu.shape[0]
