"""The legacy attention refiners ported (models/attn_legacy.py), V2, V2O
and V2Base here, V3, V3Base, V4 and V4Base in
tests/test_torch_port_attn_legacy_v3.py (the JAX side of each compiles for
10-30 s on the CPU), against the JAX package's modules, as
tests/test_torch_port_srn_legacy.py holds the SRN family: each JAX
module's variables filled from a numpy seed in the shapes of its init
(V2's ResNet101 BatchNorms included), carried across by
``tools/jax_weights.load_jax_legacy`` (strictly, in the reference's
state_dict names), the same numpy inputs, B=2, 32x64, f32, on the CPU.

Tolerances: the rgb within 1e-4 of max|JAX rgb|; the flow maps equal, or
differing only where the port's top two logits of that neighbour's window
are within 1e-5 (two near-equal offsets that f32 sums in another order can
swap).  One gradient of V2O at 16x32 within 1e-4 rel-L2 per tensor.  The
reference-name round trip: a port model's random state_dict, as numpy,
through JAX ``tools/torch_port.port_attn_legacy`` gives a JAX model whose
forward equals the port's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.models import (
    attn_legacy as jal,
    features as jfeat,
)
from deep_video_interpolation_extrapolation_tpu.tools.torch_port import (
    port_attn_legacy,
)
from deep_video_interpolation_extrapolation_tpu_torch.models import (
    attn_legacy as al,
)
from deep_video_interpolation_extrapolation_tpu_torch.models.blocks import (
    ConvT,
)
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    legacy_state_dict,
    load_jax_legacy,
)
from test_torch_port_srn_legacy import (
    _close,
    _cotangents,
    _leaves,
    _np_tree,
    jax_compiled,
    jax_variables,
)

torch.set_num_threads(2)
B, H, W = 2, 32, 64
TOL, FLOW_GAP = 1e-4, 1e-5
F32 = torch.float32
# variant -> (JAX factory, port factory)
CASES = {
    "v2": (jal.AttnRefineV2, al.AttnRefineV2),
    "v2o": (jal.AttnRefineV2O, al.AttnRefineV2O),
    "v2base": (jal.AttnRefineV2Base, al.AttnRefineV2Base),
    "v3": (jal.AttnRefineV3, al.AttnRefineV3),
    "v3base": (jal.AttnRefineV3Base, al.AttnRefineV3Base),
    "v4": (jal.AttnRefineV4, al.AttnRefineV4),
    "v4base": (jal.AttnRefineV4Base, al.AttnRefineV4Base),
}


def _inputs(h=H, w=W, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (B, h, w, 3)).astype(np.float32),
            rng.uniform(-1, 1, (B, h, w, 6)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_side(variant):
    """(compiled apply, variables, rgb, flow or None).  The variables'
    shapes are traced at a 1x1 window (the window enters no parameter);
    V2's are V2O's and one ResNet101's.  V3's and V4's last attention conv
    has its bias lowered by 0.3, so that the normalized query sums below
    zero at part of the positions: their padded offsets win, tied."""
    x, nb = map(jnp.asarray, _inputs())
    jm = CASES[variant][0](dtype=jnp.float32)
    if variant == "v2":
        variables = jax_variables(
            jal.AttnRefineV2O(jnp.float32, win_h=1, win_w=1), x, nb)
        rn = jax_variables(jfeat.ResNet101Features(jnp.float32), x, seed=1)
        variables["params"]["resnet101"] = rn["params"]
        variables["batch_stats"] = {"resnet101": rn["batch_stats"]}
    else:
        variables = jax_variables(
            CASES[variant][0](dtype=jnp.float32, win_h=1, win_w=1), x, nb)
    if variant in ("v3", "v4"):
        variables["params"]["attn_encoder_3"]["ResnetBlock_2"]["Conv_1"][
            "bias"] -= 0.3
    apply = jax_compiled(jm.apply, variables, x, nb)
    rgb, flow = apply(variables, x, nb)
    return apply, variables, np.asarray(rgb), (None if flow is None
                                               else np.array(flow))


def _port(variant, variables):
    model = CASES[variant][1](dtype=F32)
    load_jax_legacy(model, variables["params"], variables.get("batch_stats"))
    return model.eval()


def _logits(model, x, nb):
    """The port's window logits (B,H,W,2K) that its flow map is the
    argmax of."""
    ims = (x, nb[..., :3], nb[..., 3:6])
    if model.variant == "v2":
        feats = [model.resnet101(t) for t in ims]
    elif model.variant == "v2o":
        feats = [model._encode(t)[3] for t in ims]
    else:
        return al._cos_logits(*[model._attn(t) for t in ims], *model.win)
    return -al._l2_window_distance(feats[0], feats[1:], *model.win)


def _flows_agree(model, x, nb, got, want):
    """Equal flows, or where they differ, the port's top two logits of
    that neighbour's window within ``FLOW_GAP``.  Returns the number of
    positions whose maximum is an exact tie."""
    logits = _logits(model, x, nb)
    k = logits.shape[-1] // 2
    ties = 0
    for n in range(2):
        block = logits[..., n * k:(n + 1) * k]
        top2 = block.topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        ties += int((gap == 0).sum())
        differ = (got[:, n] != torch.as_tensor(want[:, n])).any(-1)
        assert (gap[differ] <= FLOW_GAP).all(), (n, gap[differ])
    return ties


def check_forward(variant):
    """rgb and flow map against the JAX module's; the parameter count
    equals JAX's.  Returns the number of exact top ties in the port's
    logits."""
    _, variables, rgb, flow = _jax_side(variant)
    model = _port(variant, variables)
    n_jax = sum(np.size(a) for a in jax.tree_util.tree_leaves(
        variables["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    x, nb = map(torch.from_numpy, _inputs())
    with torch.no_grad():
        got_rgb, got_flow = model(x, nb)
        _close(_leaves(got_rgb), [rgb], TOL, variant)
        if flow is None:
            assert got_flow is None
            return 0
        assert got_flow.shape == flow.shape
        return _flows_agree(model, x, nb, got_flow, flow)


def check_round_trip(variant):
    """A port model's random state_dict, as numpy, through JAX
    ``port_attn_legacy`` (which reads the reference's names) -> the JAX
    forward equals the port's: the port's names are the reference's."""
    model = CASES[variant][1](dtype=F32)
    rng = np.random.RandomState(7)
    convt = {f"{m}.weight" for m, mod in model.named_modules()
             if isinstance(mod, ConvT)}
    with torch.no_grad():
        for name, p in model.named_parameters():
            fan_in = int(np.prod(p.shape[1:])) if p.dim() > 1 else 100
            if name in convt:                   # (in, out, 4, 4)
                fan_in = p.shape[0] * 16
            p.copy_(torch.from_numpy(rng.normal(
                0, 1 / np.sqrt(fan_in), p.shape).astype(np.float32)))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    apply, variables, _, _ = _jax_side(variant)
    x, nb = _inputs(seed=2)
    rgb, flow = apply(port_attn_legacy(sd, variables, variant), x, nb)
    with torch.no_grad():
        got_rgb, got_flow = model(torch.from_numpy(x), torch.from_numpy(nb))
        _close(_leaves(got_rgb), [np.asarray(rgb)], TOL, variant)
        _flows_agree(model, torch.from_numpy(x), torch.from_numpy(nb),
                     got_flow, np.array(flow))


@pytest.mark.parametrize("variant", ["v2", "v2o", "v2base"])
def test_forward_matches_jax(variant):
    check_forward(variant)


def test_reference_names_round_trip():
    check_round_trip("v2o")


def test_v2o_gradient_matches_jax():
    """One gradient of V2O at 16x32: d(sum of rgb times a fixed random
    cotangent) by every parameter and by both inputs, rel-L2 <= 1e-4 per
    tensor (the per-neighbour softmax of 1/(dist + 1e-6) included)."""
    x, nb = _inputs(16, 32, seed=4)
    jm = jal.AttnRefineV2O(dtype=jnp.float32)
    variables = jax_variables(jal.AttnRefineV2O(jnp.float32, win_h=1, win_w=1),
                              x, nb, seed=3)
    (ct,) = _cotangents([(B, 16, 32, 3)])

    def loss(params, x, nb):
        return jnp.sum(jm.apply({"params": params}, x, nb)[0] * ct)

    args = (variables["params"], x, nb)
    g_params, g_x, g_nb = jax_compiled(jax.grad(loss, argnums=(0, 1, 2)),
                                       *args)(*args)
    model = al.AttnRefineV2O(dtype=F32)
    load_jax_legacy(model, variables["params"])
    tx, tnb = (torch.from_numpy(a).requires_grad_() for a in (x, nb))
    (model(tx, tnb)[0] * torch.from_numpy(ct)).sum().backward()
    want = legacy_state_dict(model, _np_tree(g_params))
    grads = dict(model.named_parameters())
    assert set(want) == set(grads)
    pairs = [(tx.grad, np.asarray(g_x), "x"), (tnb.grad, np.asarray(g_nb), "nb")]
    pairs += [(grads[k].grad, v, k) for k, v in sorted(want.items())]
    for g, ref, key in pairs:
        ref = torch.as_tensor(np.array(ref))
        rel = (g - ref).norm() / ref.norm().clamp_min(1e-30)
        assert rel <= 1e-4, (key, float(rel))
