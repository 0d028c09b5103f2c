"""The arithmetic of the Hopper window attention (``csrc/window_attn.cu``)
and shifted add (``csrc/shiftadd.cu``), emulated on the CPU, and their
wrappers' planning.

The kernels run only on the card.  Their arithmetic is emulated here in
plain torch, tile by tile, with the kernels' rounding points and order:

- the window attention: qn normalised in f32 and rounded to bf16; for each
  4 x 16 query tile, neighbour and window row wy, the 16 x 24 product of a
  warp's queries with the slab row (raw bf16 keys, zero outside the map),
  scaled per column by the keys' f32 inverse norms, of which each query
  keeps its band of win_w columns; an online softmax over the 2 * win_h
  steps with P rounded to bf16 before P.V and l summing the rounded P; the
  flow as the first maximum in (wy, wx) order.  The emulation is held to
  chip_smoke.py's gates against ``window_attention_plain`` and against the
  JAX oracle ``fused_window_attention_reference`` (on the same bf16
  values, in f32, as ``tests/test_torch_port_corr.py`` runs it): out within
  2e-2 of max|ref|, the flow equal on >= 90% of pixels, and a rolled key's
  shift found on every interior pixel.
- the shifted add: each strip's yt row runs staged from the 8-element
  boundary at or below their start into a ring of RING rows, in the
  kernel's issue order; each output row formed from its three ring rows
  by the per-thread tap offsets, with the taps summed in f32 in the order
  t = 0..8, and stored as whole 16-byte chunks plus the two partial ends.
  It must equal the plain version bit for bit (the same f32 adds in the
  same order), which equals the JAX ``_ref``, at ragged shapes.

Inputs from ``numpy.random.RandomState``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deep_video_interpolation_extrapolation_tpu.ops import pallas_shiftadd as S
from deep_video_interpolation_extrapolation_tpu.ops.pallas_corr import (
    fused_window_attention_reference,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops import shiftadd as sa
from deep_video_interpolation_extrapolation_tpu_torch.ops import window_attn as wa

torch.set_num_threads(1)

KERNEL_TOL = 2e-2          # chip_smoke.py: max|d| / max|ref|
WA_FLOW_AGREE = 0.90       # chip_smoke.py: flow agreement
EPS = 1e-12


# ---- the window attention ---------------------------------------------------

def _bf16(shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).standard_normal(
        shape).astype(np.float32)).bfloat16()


def emulate_window_attention(q, k1, k2, v1, v2, win_h, win_w):
    """The kernel's arithmetic on bf16 (B,H,W,C) operands: (out bf16, flow
    f32), tile by tile as ``csrc/window_attn.cu`` computes it."""
    b, h, w, c = q.shape
    ty, tx, cols = wa.TILE_Y, wa.TILE_X, wa.SLAB_COLS
    ph, pw = win_h // 2, win_w // 2
    qf = q.float()
    qn = (qf / qf.norm(dim=-1, keepdim=True).clamp_min(EPS)).bfloat16().float()
    qn = F.pad(qn, (0, 0, 0, tx))                  # queries past W: zero
    # keys and values zero outside the map: padded row y + wy is key row
    # y + wy - ph, padded column x0 + j is key column x0 + j - pw
    pads = (0, 0, pw, cols + tx, ph, win_h + ty)
    keys = [F.pad(k.float(), pads) for k in (k1, k2)]
    vals = [F.pad(v.float(), pads) for v in (v1, v2)]
    kinv = [1.0 / k.norm(dim=-1).clamp_min(EPS) for k in keys]
    rows = torch.arange(tx)[:, None]
    wx = torch.arange(cols)[None, :] - rows       # offset of slab column j
    band = (wx >= 0) & (wx < win_w)
    out = torch.zeros(b, h, w, c)
    flow = torch.zeros(b, h, w, 4)
    for bi in range(b):
        for y in range(h):                        # a warp: one row segment
            for x0 in range(0, w, tx):
                qt = qn[bi, y, x0:x0 + tx]
                m = torch.full((tx,), -torch.inf)
                l = torch.zeros(tx)
                acc = torch.zeros(tx, c)
                fl = []
                for n in range(2):
                    best = torch.full((tx,), -torch.inf)
                    bidx = torch.zeros(tx, dtype=torch.long)
                    for wy in range(win_h):
                        ks = keys[n][bi, y + wy, x0:x0 + cols]
                        vs = vals[n][bi, y + wy, x0:x0 + cols]
                        s = (qt @ ks.t()) * kinv[n][bi, y + wy, x0:x0 + cols]
                        s = torch.where(band, s, -torch.inf)
                        smax = s.max(dim=1).values
                        j = s.argmax(dim=1)          # the first maximum
                        up = smax > best
                        best = torch.where(up, smax, best)
                        bidx = torch.where(up, wy * win_w + j - rows[:, 0],
                                           bidx)
                        m_new = torch.maximum(m, smax)
                        scale = torch.exp(m - m_new)
                        p = torch.exp(s - m_new[:, None]).bfloat16().float()
                        l = l * scale + p.sum(1)
                        acc = acc * scale[:, None] + p @ vs
                        m = m_new
                    fl += [bidx % win_w - pw, bidx // win_w - ph]
                n_x = min(tx, w - x0)
                out[bi, y, x0:x0 + n_x] = (acc / l.clamp_min(EPS)[:, None])[:n_x]
                flow[bi, y, x0:x0 + n_x] = torch.stack(fl, -1).float()[:n_x]
    return out.bfloat16(), flow


def _gates(out, flow, ref, ref_flow):
    d = (out.float() - ref.float()).abs().max().item()
    rel = d / ref.float().abs().max().item()
    agree = (flow == ref_flow).all(-1).float().mean().item()
    return rel, agree


@pytest.mark.parametrize("shape", [(1, 12, 40, 128), (2, 9, 21, 128)])
def test_window_attention_emulation_passes_the_card_gates(shape):
    """The redesign's rounding against the plain version (the card's
    reference) and the JAX oracle, at chip_smoke.py's bounds; k = v as on
    the path (k1 = v1, k2 = v2)."""
    q, f, bk = (_bf16(shape, s) for s in (1, 2, 3))
    out, flow = emulate_window_attention(q, f, bk, f, bk, 5, 9)
    assert out.shape == shape and flow.shape == shape[:3] + (4,)
    assert torch.isfinite(out.float()).all()
    ref, ref_flow = wa.window_attention_plain(q, f, bk, f, bk, 5, 9)
    rel, agree = _gates(out, flow, ref, ref_flow)
    assert rel <= KERNEL_TOL and agree >= WA_FLOW_AGREE, (rel, agree)
    jout, jflow = fused_window_attention_reference(
        *(jnp.asarray(t.float().numpy()) for t in (q, f, bk, f, bk)),
        win_h=5, win_w=9)
    rel, agree = _gates(out, flow, torch.from_numpy(np.array(jout)),
                        torch.from_numpy(np.array(jflow)))
    assert rel <= KERNEL_TOL and agree >= WA_FLOW_AGREE, (rel, agree)


def test_window_attention_emulation_with_distinct_values():
    """The general route (k != v) computes the same function."""
    shape = (1, 8, 20, 128)
    q, k1, k2, v1, v2 = (_bf16(shape, s) for s in range(10, 15))
    out, flow = emulate_window_attention(q, k1, k2, v1, v2, 5, 9)
    ref, ref_flow = wa.window_attention_plain(q, k1, k2, v1, v2, 5, 9)
    rel, agree = _gates(out, flow, ref, ref_flow)
    assert rel <= KERNEL_TOL and agree >= WA_FLOW_AGREE, (rel, agree)


def test_window_attention_emulation_finds_a_known_shift():
    """k1 = q rolled by (1, 2): the flow is (dx, dy) = (-2, -1) on every
    interior pixel, as chip_smoke.py asks of the kernel."""
    q, bk = _bf16((1, 12, 40, 128), 4), _bf16((1, 12, 40, 128), 5)
    k1 = torch.roll(q, shifts=(-1, -2), dims=(1, 2))
    _, flow = emulate_window_attention(q, k1, bk, k1, bk, 5, 9)
    inner = flow[0, 2:-2, 4:-4, :2]
    assert (inner == torch.tensor([-2.0, -1.0])).all()


def test_window_attention_emulation_takes_the_first_maximum():
    """Keys equal to the query everywhere: every in-map offset ties at
    s = 1, and the flow is the first in-map offset in (wy, wx) order."""
    q = _bf16((1, 6, 20, 128), 6)
    same = q[:, :1, :1].expand(1, 6, 20, 128).contiguous()
    _, flow = emulate_window_attention(same, same, same, same, same, 3, 5)
    # interior pixels: the first offset (wx, wy) = (0, 0) -> (-2, -1)
    assert (flow[0, 1:-1, 2:-2, :2] == torch.tensor([-2.0, -1.0])).all()
    # the top-left corner: the first in-map offset is (0, 0) -> (0, 0)
    assert tuple(flow[0, 0, 0, :2].tolist()) == (0.0, 0.0)


def _operands(shape=(1, 128, 256, 128)):
    return [torch.zeros(shape, dtype=torch.bfloat16) for _ in range(5)]


def test_window_attention_plan_stages_one_slab_when_k_is_v():
    q, k1, k2, v1, v2 = _operands()
    same, tiles, smem = wa.plan(q, k1, k2, k1, k2, 5, 9)
    assert same and tiles == (16, 32, 1)
    # two bf16 slabs of 8 x 24 pixels and their f32 inverse norms: two
    # blocks share an SM
    assert smem == 2 * 8 * 24 * wa.SLAB_PITCH * 2 + 2 * 8 * 24 * 4
    assert 2 * (smem + 1024) <= 233472
    general, _, smem_kv = wa.plan(q, k1, k2, v1, v2, 5, 9)
    assert not general and smem_kv <= wa.SMEM_MAX
    # one pair shared is not enough: both neighbours' values are staged
    assert not wa.plan(q, k1, k2, k1, v2, 5, 9)[0]


@pytest.mark.parametrize("shape,tiles", [((2, 37, 70, 128), (5, 10, 2)),
                                         ((1, 4, 16, 128), (1, 1, 1))])
def test_window_attention_plan_covers_a_ragged_map(shape, tiles):
    ops = _operands(shape)
    assert wa.plan(*ops, 5, 9)[1] == tiles


@pytest.mark.parametrize("args,match", [
    (dict(win=(4, 9)), "odd windows"),
    (dict(win=(5, 11)), "at most 9 wide"),
    (dict(win=(9, 9), kv=False), "shared memory"),
    (dict(c=64), "C = Cv = 128"),
])
def test_window_attention_plan_refuses_what_the_kernel_does_not_take(
        args, match):
    q, k1, k2, v1, v2 = _operands((1, 8, 16, args.get("c", 128)))
    if args.get("kv", True):
        v1, v2 = k1, k2
    with pytest.raises(ValueError, match=match):
        wa.plan(q, k1, k2, v1, v2, *args.get("win", (5, 9)))


# ---- the shifted add --------------------------------------------------------

def emulate_shifted_add(yt, b2):
    """``csrc/shiftadd.cu`` on a (B,H,W,207) taps tensor and a (23,) f32
    bias: per strip, rows staged in the kernel's order into a RING-row ring
    from the 8-element boundary at or below each run (zero past the
    tensor's end), each output row formed from its three ring rows, and
    stored as whole 16-byte chunks plus element stores at the two ends."""
    b, h, w, n = yt.shape
    co = n // 9
    flat = yt.reshape(-1).float().numpy()
    bias = b2.float().numpy()
    total = flat.size
    out = np.full(b * h * w * co, np.nan, np.float32)
    gx, gy, gb = sa.plan(b, h, w, co)
    slot_len = -(-((sa.STRIP_W + 2) * n + 7) // 8) * 8
    for bz in range(gb):
        for by in range(gy):
            for bx in range(gx):
                x0, y_lo = bx * sa.STRIP_W, by * sa.STRIP_ROWS
                y_hi = min(y_lo + sa.STRIP_ROWS, h)
                xs, xe = max(x0 - 1, 0), min(x0 + sa.STRIP_W + 1, w)
                npx = min(sa.STRIP_W, w - x0)
                ring = np.zeros((sa.RING, slot_len), np.float32)
                held = [None] * sa.RING

                def seg(r):
                    return ((bz * h + r) * w + xs) * n

                def stage(r):
                    if not (0 <= r < h and r <= y_hi):
                        return
                    s0 = seg(r)
                    a, s1 = s0 & ~7, s0 + (xe - xs) * n
                    assert 0 <= a <= s0 and s1 - a <= slot_len
                    chunk = np.zeros(-(-(s1 - a) // 8) * 8, np.float32)
                    got = flat[a:min(a + chunk.size, total)]
                    chunk[:got.size] = got
                    ring[(r + 1) % sa.RING, :chunk.size] = chunk
                    held[(r + 1) % sa.RING] = r

                for r in range(y_lo - 1, y_lo - 1 + sa.RING):
                    stage(r)
                e = np.arange(npx * co)
                px, c = e // co, e % co
                x = x0 + px
                off = (x - 1 - xs) * n + c
                xok = [x > 0, np.ones_like(x, bool), x + 1 < w]
                for y in range(y_lo, y_hi):
                    acc = np.zeros(e.size, np.float32)
                    for ky in range(3):
                        yy = y + ky - 1
                        if not 0 <= yy < h:
                            continue
                        assert held[(yy + 1) % sa.RING] == yy
                        row = ring[(yy + 1) % sa.RING, seg(yy) & 7:]
                        for kx in range(3):
                            idx = off + kx * n + (3 * ky + kx) * co
                            tap = np.where(xok[kx], row[np.where(
                                xok[kx], idx, 0)], 0.0)
                            acc = np.where(xok[kx], acc + tap, acc)
                    val = (acc + bias[c]).astype(np.float32)
                    stage(y + sa.RING - 1)
                    o0 = ((bz * h + y) * w + x0) * co
                    oa, o1 = o0 & ~7, o0 + e.size
                    buf = np.zeros(-(-(o1 - oa) // 8) * 8, np.float32)
                    buf[o0 - oa:o0 - oa + e.size] = val
                    for k in range(0, o1 - oa, 8):
                        lo, hi = max(oa + k, o0), min(oa + k + 8, o1)
                        out[lo:hi] = buf[lo - oa:hi - oa]
    out = torch.from_numpy(out.reshape(b, h, w, co))
    return out.to(yt.dtype)


@pytest.mark.parametrize("shape", [(2, 7, 13), (1, 37, 70), (3, 17, 33),
                                   (1, 5, 1)])
def test_shiftadd_emulation_equals_plain_and_ref(shape):
    """Odd and ragged shapes: strips cut at the right edge, row blocks cut
    at the bottom, runs that start off the 16-byte grid."""
    rng = np.random.RandomState(sum(shape))
    yt = rng.standard_normal(shape + (9 * sa.CO,)).astype(np.float32)
    b2 = rng.standard_normal((sa.CO,)).astype(np.float32)
    ytb = torch.from_numpy(yt).bfloat16()
    plain = sa.shifted_add_bias_plain(ytb, torch.from_numpy(b2))
    emu = emulate_shifted_add(ytb, torch.from_numpy(b2))
    assert torch.equal(emu, plain)
    ref = np.asarray(S._ref(jnp.asarray(ytb.float().numpy(), jnp.bfloat16),
                            jnp.asarray(b2)), np.float32)
    np.testing.assert_array_equal(plain.float().numpy(), ref)


def test_shiftadd_emulation_f32_is_exact():
    rng = np.random.RandomState(3)
    yt = torch.from_numpy(rng.standard_normal((2, 19, 41, 207)).astype(
        np.float32))
    b2 = torch.from_numpy(rng.standard_normal((23,)).astype(np.float32))
    assert torch.equal(emulate_shifted_add(yt, b2),
                       sa.shifted_add_bias_plain(yt, b2))


@pytest.mark.parametrize("shape,grid", [((1, 512, 1024), (32, 32, 1)),
                                        ((24, 128, 128), (4, 8, 24)),
                                        ((1, 37, 70), (3, 3, 1))])
def test_shiftadd_plan_covers_the_image(shape, grid):
    assert sa.plan(*shape, sa.CO) == grid


@pytest.mark.parametrize("shape,match", [((1, 8, 8, 12), "co = 23"),
                                         ((0, 8, 8, 23), "non-empty")])
def test_shiftadd_plan_refuses_what_the_kernel_does_not_take(shape, match):
    with pytest.raises(ValueError, match=match):
        sa.plan(*shape)
