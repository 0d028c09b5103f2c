"""``ops/roi.paste_patches`` and ``models/trackgen`` (TrackGen, TrackGenV2)
against the JAX package, f32, at B=2 32x64 with 2 tracks.

- ``paste_patches``: the pasted canvas (boxes inside, across the border,
  overlapping: the later box wins, degenerate) and the gradient of a probe
  of it with respect to the patches and the canvas: max|d| <= 1e-5 (the
  bilinear weights of coordinates up to 64, f32).
- TrackGen / TrackGenV2: the JAX module initialised, every leaf carried
  across by ``tools/jax_weights.from_jax_submodel`` (the TrackGen key map,
  the inverse of ``port_track_gen``); rgb and seg out, V2's ``gen_boxes``
  and its aux loss (with and without ``gt_bbox_for_loss``): max|d| <= 1e-4
  * max(1, max|ref|) (~30 convs of the patch U-Net and the head, summed in
  another order), and the gradient of a probe of the outputs with respect
  to the coarse rgb (rel-L2 <= 1e-4).  V2's pasted boxes are regressed, so
  an output pixel on a box edge could fall on either side of it: the boxes
  agree to ~1e-6 here, far from any pixel centre.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.models import (
    trackgen as jtrack,
)
from deep_video_interpolation_extrapolation_tpu.ops import roi as jroi
from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.ops.roi import (
    paste_patches,
)
from deep_video_interpolation_extrapolation_tpu_torch.tools.jax_weights import (
    from_jax_submodel,
)

torch.set_num_threads(2)

B, H, W, N = 2, 32, 64, 2


def _close(out, ref, tol):
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy()
    assert out.shape == ref.shape, (out.shape, ref.shape)
    bound = tol * max(1.0, np.abs(ref).max())
    assert np.abs(out - ref).max() <= bound, (np.abs(out - ref).max(), bound)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(((a - b) ** 2).sum() / max((b ** 2).sum(), 1e-30))


def _boxes(rng, n=N, frames=None):
    shape = (B, n) if frames is None else (B, frames, n)
    y1 = rng.uniform(0, H - 8, shape)
    x1 = rng.uniform(0, W - 8, shape)
    return np.stack([y1, x1, y1 + rng.uniform(4, 20, shape),
                     x1 + rng.uniform(4, 30, shape)], -1).astype(np.float32)


@pytest.mark.parametrize("case", ["inside", "border", "overlap",
                                  "degenerate"])
def test_paste_patches_matches_jax(case):
    rng = np.random.RandomState(3)
    canvas = rng.normal(0, 1, (B, H, W, 5)).astype(np.float32)
    patches = rng.normal(0, 1, (B, 3, 16, 24, 5)).astype(np.float32)
    boxes = {
        "inside": _boxes(rng, 3),
        "border": np.array([[[-3, W - 10, 5, W + 4], [H - 6, -2, H + 3, 7],
                             [0, 0, H - 1, W - 1]]] * B, np.float32),
        "overlap": np.array([[[2, 3, 20, 30], [10.5, 12.25, 28, 50],
                              [4, 20, 14, 40]]] * B, np.float32),
        "degenerate": np.array([[[5, 7, 5, 7], [10, 20, 4, 12],
                                 [3.5, 2.5, 3.5, 40]]] * B, np.float32),
    }[case]
    probe = rng.normal(0, 1, (B, H, W, 5)).astype(np.float32)

    def jf(cv, pt):
        return jnp.sum(jroi.paste_patches(cv, pt, jnp.asarray(boxes))
                       * probe)
    ref = jroi.paste_patches(jnp.asarray(canvas), jnp.asarray(patches),
                             jnp.asarray(boxes))
    g_cv, g_pt = jax.grad(jf, argnums=(0, 1))(jnp.asarray(canvas),
                                              jnp.asarray(patches))
    cv = torch.from_numpy(canvas).requires_grad_()
    pt = torch.from_numpy(patches).requires_grad_()
    out = paste_patches(cv, pt, torch.from_numpy(boxes))
    _close(out, ref, 1e-5)
    (out * torch.from_numpy(probe)).sum().backward()
    _close(cv.grad, g_cv, 1e-5)
    _close(pt.grad, g_pt, 1e-5)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    rgb = rng.uniform(-1, 1, (B, H, W, 6)).astype(np.float32)
    seg = np.eye(20, dtype=np.float32)[rng.randint(0, 20, (B, H, W, 2))]
    c_rgb = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    c_seg = rng.normal(0, 1, (B, H, W, 20)).astype(np.float32)
    return rgb, seg.reshape(B, H, W, 40), c_rgb, c_seg, _boxes(rng,
                                                               frames=3)


@functools.lru_cache(maxsize=None)
def _jax_vars(name):
    rgb, seg, c_rgb, c_seg, bb = _inputs(0)
    m = getattr(jtrack, name)(num_track=N)
    return jax.jit(functools.partial(m.init, train=True))(
        jax.random.PRNGKey(0), *map(jnp.asarray, (rgb, seg, c_rgb, c_seg,
                                                  bb)))


@pytest.mark.parametrize("name,gt_loss", [("TrackGen", False),
                                          ("TrackGenV2", True),
                                          ("TrackGenV2", False)])
def test_trackgen_matches_jax(name, gt_loss):
    v = _jax_vars(name)
    jm = getattr(jtrack, name)(num_track=N)
    cfg = Config(track_gen_model=name, num_track_per_img=N,
                 compute_dtype="float32")
    port = registry.build_track_gen(cfg)
    port.load_state_dict(from_jax_submodel(port, v["params"]), strict=True)
    n_leaves = len(jax.tree_util.tree_leaves(v["params"]))
    assert len(port.state_dict()) == n_leaves
    rgb, seg, c_rgb, c_seg, bb = _inputs(1)
    kw = {"gt_bbox_for_loss": True} if gt_loss else {}
    rng = np.random.RandomState(2)
    p_rgb = rng.normal(0, 1, (B, H, W, 3)).astype(np.float32)
    p_seg = rng.normal(0, 1, (B, H, W, 20)).astype(np.float32)

    # eager: the CPU build's jit of the convolutions' backward moves this
    # gradient by ~3e-4 rel-L2 from the eager one (which f32 autograd in
    # the port meets to ~5e-7)
    def jrun(c_rgb):
        def f(c):
            r, s, boxes, aux = jm.apply(v, jnp.asarray(rgb), jnp.asarray(seg),
                                        c, jnp.asarray(c_seg),
                                        jnp.asarray(bb), **kw)
            return jnp.sum(r * p_rgb) + jnp.sum(s * p_seg), (r, s, boxes,
                                                              aux)
        return jax.grad(f, has_aux=True)(c_rgb)
    g_ref, (r_ref, s_ref, b_ref, a_ref) = jrun(jnp.asarray(c_rgb))

    c = torch.from_numpy(c_rgb).requires_grad_()
    r, s, boxes, aux = port(torch.from_numpy(rgb), torch.from_numpy(seg), c,
                            torch.from_numpy(c_seg), torch.from_numpy(bb),
                            **kw)
    _close(r, r_ref, 1e-4)
    _close(s, s_ref, 1e-4)
    _close(aux, a_ref, 1e-4)
    if name == "TrackGen":
        assert boxes is None and b_ref is None and float(aux) == 0.0
    else:
        assert boxes.shape == (B, N, 4)
        _close(boxes, b_ref, 1e-4)
    ((r * torch.from_numpy(p_rgb)).sum()
     + (s * torch.from_numpy(p_seg)).sum()).backward()
    assert _rel_l2(c.grad.numpy(), g_ref) <= 1e-4
