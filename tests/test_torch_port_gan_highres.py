"""Recipe 4's step with ``--highres_large`` (VAEHRNet with the fourth,
512-channel branch and the 4-part head with its explicit backward) against
the JAX package's, with the method and tolerances of
tests/test_torch_port_gan_traj.py: the first step whole (loss terms,
gradients, updates, BatchNorm statistics and spectral-norm vectors), then
loss_all over three steps.
"""

from test_torch_port_gan_step import RECIPE4
from test_torch_port_gan_traj import held_over_steps


def test_recipe4_highres_steps_match_jax(monkeypatch):
    held_over_steps({**RECIPE4, "highres_large": True}, monkeypatch)
