"""Recipe 6's step with ``--highres_large`` on ExtraInpaintNet with
``--inpaint --inpaint_mask`` (the coarse heads 24 wide, so the 4-part head
at N2 = 216, and InpaintUnet), both submodels trained, against the JAX
package's, with the method and tolerances of
tests/test_torch_port_extra_traj.py: the first step whole (loss terms,
each submodel's gradient and update), then loss_all over three steps.
InpaintUnet's whole gradient is held by rel-L2 < 3e-3, as
tests/test_torch_port_extra_routes.py holds it (lrelu masks of its decoder
at pre-activations within f32 rounding of 0).
"""

from test_torch_port_extra_step import RECIPE6
from test_torch_port_extra_traj import INPAINT_MASK, held_over_steps


def test_highres_inpaint_mask_steps_match_jax(monkeypatch):
    held_over_steps({**RECIPE6, **INPAINT_MASK, "highres_large": True},
                    monkeypatch, whole={"inpaint_model": 3e-3})
