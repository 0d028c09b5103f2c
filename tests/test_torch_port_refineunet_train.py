"""The CLI's default refiner, ported: ``--model InterRefineNet --refine``
with ``--refine_model refineUnet`` (the Config default) builds RefineUnet,
whose single image the composite wraps as a one-scale list
(composite.py:45-52), and trains: one step's loss dict, the refiner's
gradient and its update against the JAX package's, with the frozen VGG19
(the image is full size), under tests/test_torch_port_recipe2.py's
setup and tolerances.
"""

from tests.test_torch_port_recipe2 import RECIPE2, check_one_step, jax_side


def test_default_refiner_trains():
    """The CLI defaults (``--refine_model refineUnet``) build RefineUnet,
    whose single image becomes a one-scale list: one step's losses, keys
    and gradient against JAX."""
    kw = dict(RECIPE2, refine_model="refineUnet", n_scales=1)
    (_, jax_state), step, _ = jax_side(kw)
    losses = check_one_step(kw, jax_state, step, "refine_model")
    assert "refine_1.0_l1_loss" in losses and not any(
        k.startswith("refine_0.") for k in losses)
