"""Recipe 4's step under ``--remat`` (VAEHRNet's stage checkpoints, each
discriminator family's passes one checkpoint region, the loss bundle one)
against the JAX package's ``--remat`` step, with the method and
tolerances of tests/test_torch_port_gan_traj.py: the first step whole
(loss terms, gradients, updates, BatchNorm statistics and spectral-norm
vectors moved once), then loss_all over three steps.
"""

from test_torch_port_gan_step import RECIPE4
from test_torch_port_gan_traj import held_over_steps


def test_recipe4_remat_steps_match_jax(monkeypatch):
    held_over_steps({**RECIPE4, "remat": True}, monkeypatch)
