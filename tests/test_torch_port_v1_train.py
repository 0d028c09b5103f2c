"""MSResAttnRefine (V1) at one scale trains on the port: where autograd
needs stage 3's gradient, the model runs its attention through the plain
composition of ``ops/window_attn`` (the Hopper kernel, like the JAX
Pallas kernel, has no backward).  One InterStage3Net step with
``--train_stage3`` (``refineUnet`` refiner, frozen) against the JAX step,
which differentiates its XLA oracle on the CPU, under
tests/test_torch_port_recipe2.py's setup and tolerances; the kernel's
wrapper is never called.
"""

from deep_video_interpolation_extrapolation_tpu_torch.models import (
    attn_refine,
)
from tests.test_torch_port_recipe2 import RECIPE2, check_one_step, jax_side


def test_v1_trains_on_the_plain_attention(monkeypatch):
    kw = dict(RECIPE2, model="InterStage3Net", train_refine=False,
              refine_model="refineUnet", n_scales=1, stage3=True,
              stage3_model="MSResAttnRefine", train_stage3=True)
    (_, jax_state), step, _ = jax_side(kw)

    def refuse(*a, **k):
        raise AssertionError("the kernel's wrapper ran under autograd")
    # the model is built after this: its wrapper is ``refuse``
    monkeypatch.setattr(attn_refine, "window_attention", refuse)
    check_one_step(kw, jax_state, step, "stage3_model")
