"""The EXTRA step on the routes recipe 6 does not take, against the JAX
package's ``train/extra.make_train_step``, at B=2 32x64 f32 (the method,
helpers and tolerances of tests/test_torch_port_extra_step.py):

- ExtraInpaintNet with ``--inpaint --inpaint_mask`` (the coarse heads 24
  wide: rgb 3 + mask 1 + seg 20) and ``--train_inpaint`` alone, over two
  steps: every submodel's gradient, then the step, where the frozen
  coarse model runs under autograd to pass the inpainter's gradient of
  step 2 back to step 1, and does not move;
- ExtraInpaintNet with ``--inpaint`` (the mask from the seg) and both
  submodels trained, one step;
- ExtraNet at ``--num_pred_once 2`` (the seg head 40 wide: K4's h mode and
  the two 3x3s on its halves, with their gradient), one step;
- ExtraNet with ``--fix_init_frames`` (three input frames, conv1 of 21
  channels), over two steps.

InpaintUnet's whole gradient is held by rel-L2 < 3e-3, not 1e-3: an
lrelu mask of its decoder flips where a pre-activation lies within f32
rounding of 0, and a flip or two move its whole gradient by ~1e-3.  (In
InpaintUnet alone at 2x32x64 on a soft mask, two of the 524288 values
before its second-last 3x3 (|x| < 6e-7) took another sign in the port's
f32 forward than in its f64 one, and moved the f32 gradient 1.8e-3 from
the f64 one's, where the JAX f32 gradient was within 1e-6 of it.)  With
the mask from the seg the port's whole InpaintUnet gradient is 1.2e-3 from
the JAX one's, each tensor's under 2e-3.
"""

import numpy as np
import pytest
import torch

from test_torch_port_extra_step import (
    RECIPE6,
    _np,
    check_grads,
    check_losses,
    check_update,
    jax_step,
    port_grads,
)
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    from_jax_submodel,
)

INPAINT = dict(model="ExtraInpaintNet", inpaint=True, inpaint_learning_rate=1e-3)
CASES = {
    "inpaint_mask": {**RECIPE6, **INPAINT, "inpaint_mask": True,
                     "train_coarse": False, "train_inpaint": True,
                     "num_pred_step": 2},
    "inpaint_seg_mask": {**RECIPE6, **INPAINT, "train_inpaint": True,
                         "num_pred_step": 1},
    "pred_once_2": {**RECIPE6, "num_pred_once": 2, "num_pred_step": 1},
    "fix_init_frames": {**RECIPE6, "fix_init_frames": True,
                        "num_pred_step": 2},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_extra_route_step_matches_jax(case, monkeypatch):
    kw = CASES[case]
    s0, s1, ld, grads_j, one_hots = jax_step(tuple(sorted(kw.items())))
    losses, grads, model = port_grads(kw, s0, one_hots, monkeypatch)
    check_losses(losses, ld)
    for name, sub in model.named_children():
        g_ref = from_jax_submodel(sub, grads_j[name])
        check_grads(grads, g_ref, name,
                    3e-3 if name == "inpaint_model" else 1e-3)
        after = from_jax_submodel(sub, _np(s1.params[name]))
        if kw.get(f"train_{name[:-len('_model')]}"):
            check_update(model, name, after, g_ref, grads[name])
        else:     # frozen: not moved
            for k, p in sub.named_parameters():
                assert torch.equal(p.detach(), after[k]), k
    if kw.get("inpaint"):
        keys = [k for k in losses if "_inpaint_" in k]
        assert keys[-1] == f"step_{kw['num_pred_step']}_frame_1_inpaint_mask_loss"
        w = 80.0 if kw.get("inpaint_mask") else 0.0
        assert (float(losses[keys[-1]]) > 0) == (w > 0)
    if case == "pred_once_2":
        assert [k for k in losses if k.endswith("_ce_loss")] == [
            "step_1_frame_1_coarse_ce_loss", "step_1_frame_2_coarse_ce_loss"]
    assert np.isfinite(float(losses["loss_all"]))
