"""Recipe 3 (docs/RECIPES.md:28-40), ported: InterStage3Net, the HRNet
coarse and ``SRNRefine --n_sc 3`` frozen, ``MSResAttnRefineV2
--stage3_prop --train_stage3``, the refine weights 20.  The port's train
and eval steps against the JAX package's, as tests/test_torch_port_recipe2.py
holds recipe 2 (full width, 32x64, B=2, f32, CPU, the JAX init; its
tolerances and its reason to run the 3-scale step without the frozen
VGG19).
"""

import jax
import pytest

from deep_video_interpolation_extrapolation_tpu_torch.train import inter
from tests.test_torch_port_recipe2 import (
    RECIPE2,
    batch_of,
    check_one_step,
    jax_side,
    jb,
    port_side,
    rel,
    tb,
)

RECIPE3 = dict(RECIPE2, model="InterStage3Net", train_refine=False,
               stage3=True, stage3_model="MSResAttnRefineV2",
               train_stage3=True, stage3_prop=True, refine_l1_weight=20.0,
               refine_gdl_weight=20.0, refine_vgg_weight=20.0,
               refine_ssim_weight=20.0)


@pytest.fixture(scope="module")
def recipe3():
    return jax_side(RECIPE3)


def test_recipe3_one_step_matches_jax(recipe3):
    (jax_state, _), step, _ = recipe3
    losses = check_one_step(RECIPE3, jax_state, step, "stage3_model")
    stems = [k[:-len("_l1_loss")] for k in losses if k.endswith("_l1_loss")]
    assert stems == ["coarse", "refine_0.25", "refine_0.5", "refine_1.0",
                     "stage3_0.25", "stage3_0.5", "stage3_1.0"]


def test_recipe3_eval_metrics_match_jax(recipe3):
    (_, jax_state), _, evals = recipe3
    batch = batch_of(5)
    ref = evals(jax_state, jb(batch), jax.random.PRNGKey(0))
    cfg, model, state = port_side(RECIPE3, jax_state)
    out = inter.make_eval_step(cfg, model)(state, tb(batch))
    assert list(out) == list(ref)
    assert [k for k in out if k.endswith("_l1")] == [
        "coarse_l1", "refine_l1", "stage3_l1"]
    for k in ref:
        assert rel(out[k], ref[k]) < 1e-4, k
