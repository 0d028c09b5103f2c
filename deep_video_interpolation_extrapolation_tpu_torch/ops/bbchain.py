"""The BasicBlock chain: N BasicBlocks at 64 channels, forward and backward
kernels, NHWC.

Counterpart of ``ops/pallas_trainchain.basicblock_chain`` (a
``jax.custom_vjp`` pair of Pallas kernels, ``_bb_fwd_kernel`` /
``_bb_bwd_kernel``), the JAX package's default training route for the
branch-0 BasicBlocks of stage2 and stage3 (``DVIE_BBCHAIN=b0``).  With
N = 1 it is also ``pallas_resblock.fused_basicblock`` and
``pallas_bb.fused_basicblock_hwnc``, one BasicBlock each.  Per block i:

    h       = lrelu(bf16(conv3x3(x_i, k1_i)))
    pre     = bf16(conv3x3(h, k2_i))
    x_{i+1} = lrelu(pre + x_i)

with the residual add and the lrelus in the compute dtype.  The backward
walks the blocks in reverse: dpre_y = lrelu'(x_{i+1}) * dy, dh =
bf16(conv_t(dpre_y, k2)), dpre_h = lrelu'(h) * dh, and dx =
bf16(conv_t(dpre_h, k1) + dpre_y), rounded once; the weight grads are f32.

The kernels are ``csrc/trainchain_basicblock.cu``: one forward launch per
block, two backward launches per block (its note says why); each call of
a block's forward or backward counts one launch.  The TPU kernel recomputes
every block input, h and the pre-activations in the backward because VMEM
is small; here the forward keeps every block's output and h (2 x 50 MB per
block at the 24x128x128 recipe) for the backward, which then runs no
forward conv and computes the same function.

``bb_chain`` is a ``torch.autograd.Function``: on CUDA bf16 tensors both
passes launch the kernels, on CPU tensors both take the plain versions
(the forward ``bb_chain_plain``, the hand-written backward
``bb_chain_bwd_plain``).  Weights are torch OIHW tensors (the f32
masters); their grads come back in the same layout and dtype.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.ops.trainchain import (
    _call,
    _check_pixels,
    _conv,
    _conv_t,
    _conv_wgrad,
    _grad_like,
    _lrelu,
    _masked,
    _splits,
    _taps,
    _taps_t,
)

FWD, BWD = "bb_chain_fwd", "bb_chain_bwd"
C = 64            # the kernels take branch 0's 64 channels only

Pairs = Sequence[Tuple[torch.Tensor, torch.Tensor]]


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

def _check(x: torch.Tensor, pairs: Pairs) -> None:
    b, h, w, c = x.shape
    shapes = [tuple(k.shape) for pair in pairs for k in pair]
    if c != C or not pairs or any(s != (C, C, 3, 3) for s in shapes):
        raise ValueError(f"BasicBlock chain kernel takes C = {C} and 3x3 "
                         f"CxC weights: x {tuple(x.shape)}, weights {shapes}")
    _check_pixels(b, h, w)
    hw.check_bf16("x", x)


def bb_chain_fwd_saved(x: torch.Tensor, pairs: Pairs, keep_h: bool = True
                       ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The chain's forward on the card (``csrc/trainchain_basicblock.cu``),
    one launch per block.  Returns (every block's output, every block's h;
    no h unless ``keep_h``): what the backward kernels read."""
    _check(x, pairs)
    b, h, w, _ = x.shape
    dev = x.device
    outs, hs = [], []
    for k1, k2 in pairs:
        y = torch.empty_like(x)
        hb = torch.empty_like(x) if keep_h else None
        _call(FWD, x, _taps(k1, dev), _taps(k2, dev), y, hb, b, h, w)
        outs.append(y)
        if keep_h:
            hs.append(hb)
        x = y
    return outs, hs


def bb_chain_fwd_kernel(x: torch.Tensor, pairs: Pairs) -> torch.Tensor:
    """The chain's forward on the card, its output only."""
    return bb_chain_fwd_saved(x, pairs, keep_h=False)[0][-1]


def bb_chain_bwd_kernel(x: torch.Tensor, dy: torch.Tensor, pairs: Pairs,
                        outs: Sequence[torch.Tensor],
                        hs: Sequence[torch.Tensor]):
    """The chain's backward on the card: per block two launches (see the
    .cu note), then the f32 weight-grad partials summed here.  ``outs``
    and ``hs``: every block's output and h, as ``bb_chain_fwd_saved``
    keeps them.  Returns (dx bf16, [(dk1, dk2) f32 OIHW, ...])."""
    _check(x, pairs)
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
    dpre_y, dpre_h = torch.empty_like(x), torch.empty_like(x)
    s = _splits(18, b * h * w)
    pk = torch.empty((n, 2, s, 9, C, C), device=dev, dtype=torch.float32)
    g = dy
    for i in reversed(range(n)):
        k1, k2 = pairs[i]
        dx = torch.empty_like(x)
        _call(BWD, xs[i], outs[i], hs[i], g, _taps_t(k1, dev),
              _taps_t(k2, dev), dpre_y, dpre_h, dx, pk[i, 0], pk[i, 1],
              b, h, w, s)
        g = dx
    # (n, 2, tap, I, O) -> per block (O, I, 3, 3)
    dks = pk.sum(2).reshape(n, 2, 3, 3, C, C).permute(0, 1, 5, 4, 2, 3)
    return g, [(dks[i, 0].contiguous(), dks[i, 1].contiguous())
               for i in range(n)]


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
