"""AttnRefineV3, V3Base, V4 and V4Base ported (models/attn_legacy.py)
against the JAX package's modules, by the checks of
tests/test_torch_port_attn_legacy.py (its helpers, its tolerances): B=2,
32x64, f32, on the CPU.  V3 and V4 run their 9x17 window on the 8x16 map of
a 32x64 input, so every position sees padded offsets; where the normalized
query sums below zero the padded offsets' equal logits are the largest,
and the first of the tie wins on both sides (the test counts such
positions).  The reference-name round trip of V3."""

import pytest

from test_torch_port_attn_legacy import check_forward, check_round_trip


@pytest.mark.parametrize("variant", ["v3", "v3base", "v4", "v4base"])
def test_forward_matches_jax(variant):
    ties = check_forward(variant)
    if variant in ("v3", "v4"):
        assert ties > 0


def test_reference_names_round_trip():
    check_round_trip("v3")
