"""The BasicBlock chain: N BasicBlocks at C = 64, 128 or 256 channels,
forward and backward kernels, NHWC.

Counterpart of ``ops/pallas_trainchain.basicblock_chain`` (a
``jax.custom_vjp`` pair of Pallas kernels, ``_bb_fwd_kernel`` /
``_bb_bwd_kernel``), the JAX package's training route for the BasicBlocks
of stage2 and stage3: branch 0 (C = 64, width-packed there) under
``DVIE_BBCHAIN=b0`` (the default) and ``all``, branches 1 and 2 (C = 128
and 256, unpacked) under ``rest`` and ``all``, wherever ``bb_fits`` holds
(``models/hrnet.bb_chain_route``).  With N = 1 it is also
``pallas_resblock.fused_basicblock`` and
``pallas_bb.fused_basicblock_hwnc``, one BasicBlock each.  Per block i:

    h       = lrelu(bf16(conv3x3(x_i, k1_i)))
    pre     = bf16(conv3x3(h, k2_i))
    x_{i+1} = lrelu(pre + x_i)

with the residual add and the lrelus in the compute dtype.  The backward
walks the blocks in reverse: dpre_y = lrelu'(x_{i+1}) * dy, dh =
bf16(conv_t(dpre_y, k2)), dpre_h = lrelu'(h) * dh, and dx =
bf16(conv_t(dpre_h, k1) + dpre_y), rounded once; the weight grads are f32.

The kernels are ``csrc/trainchain_basicblock.cu`` (its note gives the
design): per block one forward launch and one backward launch (dx, dpre_h
and dpre_y), then one weight-grad launch for the whole chain.  The TPU
kernel recomputes every block input, h and the pre-activations in the
backward because VMEM is small; here the forward keeps every block's output
and h (2 x 50 MB per block at the 24x128x128 recipe) for the backward,
which then runs no forward conv and computes the same function.

Launch counters: ``bb_chain_fwd`` / ``bb_chain_bwd`` count one per block at
C = 64, ``bb_chain_fwd_c128`` / ``bb_chain_bwd_c128`` and ``..._c256`` at
the other widths (each width is its own compiled kernel), and
``bb_chain_wgrad`` one per weight-grad launch.

``bb_chain`` is a ``torch.autograd.Function``: on CUDA bf16 tensors both
passes launch the kernels, on CPU tensors both take the plain versions
(the forward ``bb_chain_plain``, the hand-written backward
``bb_chain_bwd_plain``).  Weights are torch OIHW tensors (the f32
masters); their grads come back in the same layout and dtype.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.ops.trainchain import (
    _check_pixels,
    _conv,
    _conv_t,
    _conv_wgrad,
    _grad_like,
    _launch,
    _lrelu,
    _masked,
    _taps,
    _taps_t,
)

# the pixel tile (rows, columns) of each width's kernels (csrc BB<C>)
TILES = {64: (8, 16), 128: (8, 16), 256: (4, 16)}
WGRAD = "bb_chain_wgrad"
WGRAD_JOBS = 16          # weight grads per launch (dvie_bb_chain_wgrad)
WGRAD_TILE = (8, 16)

Pairs = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def counter(kind: str, c: int) -> str:
    """The launch counter of the ``kind`` ("fwd" or "bwd") kernel at C = c."""
    return f"bb_chain_{kind}" + ("" if c == 64 else f"_c{c}")


# ---- plain versions -------------------------------------------------------

def basicblock_plain(x: torch.Tensor, k1: torch.Tensor,
                     k2: torch.Tensor) -> torch.Tensor:
    """One BasicBlock; x (B,H,W,C) in the compute dtype, k1 and k2
    (C,C,3,3) OIHW, any float dtype (cast to x's)."""
    h = _lrelu(_conv(x, k1))
    return _lrelu(_conv(h, k2) + x)


def bb_chain_plain(x: torch.Tensor, pairs: Pairs) -> torch.Tensor:
    """``basicblock_plain`` over ``pairs`` = [(k1, k2), ...] in order."""
    for k1, k2 in pairs:
        x = basicblock_plain(x, k1, k2)
    return x


def bb_chain_bwd_plain(x: torch.Tensor, dy: torch.Tensor, pairs: Pairs,
                       inner: Optional[Sequence[torch.Tensor]] = None
                       ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor,
                                                           torch.Tensor]]]:
    """Hand-written backward of ``bb_chain_plain`` (``_bb_bwd_kernel``,
    pallas_trainchain.py:610-649): the block inputs recomputed from x
    (or taken from ``inner``, the outputs of blocks 0 .. N-2), h
    recomputed, the masks taken from the signs of h and of each block
    output.  Returns (dx in x's dtype, [(dk1, dk2) f32, ...])."""
    dt = x.dtype
    c = x.shape[-1]
    xs = [x] + list(inner or [])
    for k1, k2 in pairs[len(xs) - 1:]:
        xs.append(basicblock_plain(xs[-1], k1, k2))
    g = dy.to(dt)
    grads = [None] * len(pairs)
    for i in reversed(range(len(pairs))):
        k1, k2 = pairs[i]
        h = _lrelu(_conv(xs[i], k1))
        dpre_y = _masked(xs[i + 1], g)
        dk2 = _conv_wgrad(h, dpre_y, tuple(k2.shape))
        dh = _conv_t(dpre_y, k2, c).to(dt)
        dpre_h = _masked(h, dh)
        dk1 = _conv_wgrad(xs[i], dpre_h, tuple(k1.shape))
        g = (_conv_t(dpre_h, k1, c) + dpre_y.float()).to(dt)
        grads[i] = (dk1, dk2)
    return g, grads


# ---- kernel wrappers ------------------------------------------------------

def pick_tile(c: int, b: int, h: int, w: int) -> Tuple[int, int]:
    """The kernels' pixel tile at C = c for a (b, h, w) input; raises
    ``ValueError`` for a shape the kernels cannot take (a width other than
    64, 128, 256; an empty input; too many pixels for 32-bit indices)."""
    if c not in TILES:
        raise ValueError(f"BasicBlock chain kernel takes C in {sorted(TILES)}"
                         f", got C = {c}")
    if min(b, h, w) < 1:
        raise ValueError(f"BasicBlock chain kernel: empty input {b}x{h}x{w}")
    _check_pixels(b, h, w)
    return TILES[c]


def _check(x: torch.Tensor, pairs: Pairs) -> int:
    b, h, w, c = x.shape
    pick_tile(c, b, h, w)
    shapes = [tuple(k.shape) for pair in pairs for k in pair]
    if not pairs or any(s != (c, c, 3, 3) for s in shapes):
        raise ValueError(f"BasicBlock chain kernel takes 3x3 CxC weights: "
                         f"x {tuple(x.shape)}, weights {shapes}")
    hw.check_bf16("x", x)
    return c


def _units(taps: torch.Tensor) -> torch.Tensor:
    """(9, K, N) taps -> the kernels' weight units: for each tap and 64 input
    channels, (8 k-groups, N outputs, 8 k) bf16, the no-swizzle K-major
    wgmma layout (csrc/hopper.cuh)."""
    k, n = taps.shape[1:]
    return (taps.reshape(9, k // 64, 8, 8, n).permute(0, 1, 2, 4, 3)
            .contiguous())


def bb_chain_fwd_saved(x: torch.Tensor, pairs: Pairs, keep_h: bool = True
                       ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The chain's forward on the card (``csrc/trainchain_basicblock.cu``),
    one launch per block.  Returns (every block's output, every block's h;
    no h unless ``keep_h``): what the backward kernels read."""
    c = _check(x, pairs)
    b, h, w, _ = x.shape
    dev = x.device
    outs, hs = [], []
    for k1, k2 in pairs:
        y = torch.empty_like(x)
        hb = torch.empty_like(x) if keep_h else None
        _launch("bb_chain_fwd", counter("fwd", c), x, x,
                _units(_taps(k1, dev)), _units(_taps(k2, dev)), y, hb,
                b, h, w, c)
        outs.append(y)
        if keep_h:
            hs.append(hb)
        x = y
    return outs, hs


def bb_chain_fwd_kernel(x: torch.Tensor, pairs: Pairs) -> torch.Tensor:
    """The chain's forward on the card, its output only."""
    return bb_chain_fwd_saved(x, pairs, keep_h=False)[0][-1]


def _wgrad_splits(c: int, jobs: int, b: int, h: int, w: int) -> int:
    """Pixel ranges of the weight-grad launch: about two blocks per SM of
    an H100 (132 SMs), at least one tile per range."""
    tiles = b * -(-h // WGRAD_TILE[0]) * -(-w // WGRAD_TILE[1])
    return max(1, min(-(-264 // ((c // 64) ** 2 * jobs)), tiles))


def bb_chain_wgrad_kernel(pairs_ad: Sequence[Tuple[torch.Tensor,
                                                   torch.Tensor]]
                          ) -> List[torch.Tensor]:
    """Weight grads of 3x3 SAME convs on the card, all in one launch (up to
    ``WGRAD_JOBS`` per launch): for each (a, d), a the conv input and d the
    grad of its output (B,H,W,C) bf16, dk[o, i, ky, kx] = sum over pixels
    p of a(p + (ky-1, kx-1))[i] d(p)[o], f32 OIHW."""
    a0 = pairs_ad[0][0]
    b, h, w, c = a0.shape
    pick_tile(c, b, h, w)
    for i, (a, d) in enumerate(pairs_ad):
        hw.check_bf16(f"a[{i}]", a, a0.shape)
        hw.check_bf16(f"d[{i}]", d, a0.shape)
    grads = []
    for j0 in range(0, len(pairs_ad), WGRAD_JOBS):
        group = pairs_ad[j0:j0 + WGRAD_JOBS]
        s = _wgrad_splits(c, len(group), b, h, w)
        pk = torch.empty((len(group), s, 9, c, c), device=a0.device,
                         dtype=torch.float32)
        ptrs = (ctypes.c_void_p * (3 * len(group)))(*[
            p for j, (a, d) in enumerate(group)
            for p in (a.data_ptr(), d.data_ptr(), pk[j].data_ptr())])
        _launch(WGRAD, WGRAD, a0, ctypes.addressof(ptrs), len(group), c,
                b, h, w, s)
        # (jobs, tap, I, O) -> (jobs, O, I, 3, 3)
        dks = pk.sum(1).reshape(len(group), 3, 3, c, c).permute(0, 4, 3, 1, 2)
        grads += [dks[j].contiguous() for j in range(len(group))]
    return grads


def bb_chain_bwd_kernel(x: torch.Tensor, dy: torch.Tensor, pairs: Pairs,
                        outs: Sequence[torch.Tensor],
                        hs: Sequence[torch.Tensor]):
    """The chain's backward on the card: one launch per block (dx, dpre_h,
    dpre_y), then one weight-grad launch for every block.  ``outs`` and
    ``hs``: every block's output and h, as ``bb_chain_fwd_saved`` keeps
    them.  Returns (dx bf16, [(dk1, dk2) f32 OIHW, ...])."""
    c = _check(x, pairs)
    hw.check_bf16("dy", dy, x.shape)
    b, h, w, _ = x.shape
    n = len(pairs)
    dev = x.device
    if len(outs) != n or len(hs) != n:
        raise ValueError(f"{len(outs)} block outputs and {len(hs)} h for "
                         f"{n} blocks")
    for i in range(n):
        hw.check_bf16(f"outs[{i}]", outs[i], x.shape)
        hw.check_bf16(f"hs[{i}]", hs[i], x.shape)
    xs = [x, *outs[:-1]]
    dpre_y = [torch.empty_like(x) for _ in range(n)]
    dpre_h = [torch.empty_like(x) for _ in range(n)]
    g = dy
    for i in reversed(range(n)):
        k1, k2 = pairs[i]
        dx = torch.empty_like(x)
        _launch("bb_chain_bwd", counter("bwd", c), x, g, outs[i], hs[i],
                _units(_taps_t(k2, dev)), _units(_taps_t(k1, dev)), dx,
                dpre_h[i], dpre_y[i], b, h, w, c)
        g = dx
    dks = bb_chain_wgrad_kernel([ad for i in range(n) for ad in (
        (xs[i], dpre_h[i]), (hs[i], dpre_y[i]))])
    return g, [(dks[2 * i], dks[2 * i + 1]) for i in range(n)]


# ---- autograd -------------------------------------------------------------

def _pairs(ks) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    return list(zip(ks[0::2], ks[1::2]))


class _BBChain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, keep, x, *ks):
        pairs = _pairs(ks)
        saved = []
        if hw.use_kernel(x):
            outs, hs = bb_chain_fwd_saved(x, pairs, keep_h=keep)
            y = outs[-1]
            saved = outs + hs if keep else []
        else:
            y = bb_chain_plain(x, pairs)
        ctx.n_saved = len(saved)
        ctx.save_for_backward(x, *saved, *ks)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, *rest = ctx.saved_tensors
        saved, ks = rest[:ctx.n_saved], rest[ctx.n_saved:]
        pairs = _pairs(ks)
        if hw.use_kernel(x):
            n = len(pairs)
            dx, grads = bb_chain_bwd_kernel(x, dy.contiguous(), pairs,
                                            saved[:n], saved[n:])
        else:
            dx, grads = bb_chain_bwd_plain(x, dy.contiguous(), pairs)
        dks = [d for pair in grads for d in pair]
        return (None, dx, *(_grad_like(d, k) for d, k in zip(dks, ks)))


def bb_chain(x: torch.Tensor, pairs: Pairs) -> torch.Tensor:
    """The chain of BasicBlocks over ``pairs`` = [(k1, k2), ...];
    differentiable.  Kernels for a CUDA bf16 ``x``, the plain versions for
    a CPU one.  The forward keeps the backward's state only where autograd
    will ask for it."""
    ks = [k for pair in pairs for k in pair]
    keep = torch.is_grad_enabled() and any(t.requires_grad for t in [x, *ks])
    return _BBChain.apply(keep, x, *ks)
