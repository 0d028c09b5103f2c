"""Backward by recomputation for the forward-only kernels K1, K2 and K3.

The JAX package differentiates these kernels through a ``custom_vjp`` whose
backward is the vjp of the XLA composition (pallas_ae_conv.py:20,
pallas_fuse0.py:22, pallas_chain.py:19).  ``recompute_vjp`` is that rule
as a ``torch.autograd.Function``: the forward runs the kernel (or, for CPU
tensors, the plain version), the backward recomputes the plain version
under autograd and differentiates it.
"""

from __future__ import annotations

from typing import Callable

import torch

from deep_video_interpolation_extrapolation_tpu_torch.core import hw


class _RecomputeVjp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, plain, *args):
        ctx.plain = plain
        ctx.consts = [None if torch.is_tensor(a) else a for a in args]
        ctx.save_for_backward(*(a if torch.is_tensor(a) else None
                                for a in args))
        return kernel(*args) if hw.use_kernel(args[0]) else plain(*args)

    @staticmethod
    def backward(ctx, *grads):
        args = []
        for i, (t, c) in enumerate(zip(ctx.saved_tensors, ctx.consts)):
            if t is not None:
                t = t.detach().requires_grad_(ctx.needs_input_grad[2 + i])
            args.append(c if t is None else t)
        with torch.enable_grad():
            out = ctx.plain(*args)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if o is not None and g is not None]
        wanted = [a for a in args if torch.is_tensor(a) and a.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                       [g for _, g in pairs],
                                       allow_unused=True))
        return (None, None) + tuple(
            next(got) if torch.is_tensor(a) and a.requires_grad else None
            for a in args)


def recompute_vjp(kernel: Callable, plain: Callable, *args):
    """``kernel(*args)`` if ``args[0]`` is a tensor the kernels take (on
    CUDA), else ``plain(*args)`` (on the CPU); differentiable, by autograd
    of ``plain`` recomputed in the backward.  Non-tensor arguments pass
    through as constants."""
    return _RecomputeVjp.apply(kernel, plain, *args)
