"""Every model of the port, built directly (not through
``registry.build_model``), holds defined values: every parameter and buffer
is finite right after construction, before ``registry.init_weights`` fills
it.  A parameter made by ``torch.empty`` would hold whatever the allocator
handed out (NaN patterns included), and any test that compared such a
model would pass or fail by chance.  ``init_weights`` stays the one seeded
fill: the same seed gives the same weights.

Full published widths on the CPU, construction only (no forward).
"""

import pytest
import torch

from deep_video_interpolation_extrapolation_tpu_torch.models import (
    attn_refine,
    hrnet,
    refine,
    registry,
    vae_video,
)

BUILDERS = {
    "InterNet/HRNet": lambda: hrnet.HRNet(dtype=torch.bfloat16),
    "highres_large": lambda: hrnet.HRNet(dtype=torch.bfloat16,
                                         highres_large=True),
    "MSResAttnRefine": lambda: attn_refine.MSResAttnRefine(),
    "SRNRefine": lambda: refine.SRNRefine(),
    "VideoVAE": lambda: vae_video.VideoVAE(vid_length=2),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_a_model_built_directly_is_finite(name):
    model = BUILDERS[name]()
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    assert tensors
    bad = [n for n, t in tensors.items() if not torch.isfinite(t).all()]
    assert not bad, f"{name}: non-finite after construction: {bad[:5]}"


@pytest.mark.parametrize("name", ["SRNRefine", "MSResAttnRefine"])
def test_init_weights_is_the_one_seeded_fill(name):
    a = registry.init_weights(BUILDERS[name](), 3)
    b = registry.init_weights(BUILDERS[name](), 3)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    assert any(p.abs().sum() > 0 for n, p in a.named_parameters()
               if n.endswith("weight"))
