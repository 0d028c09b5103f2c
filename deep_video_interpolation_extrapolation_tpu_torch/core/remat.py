"""Activation checkpoints with pure regions: the port's ``--remat``.

The JAX package's ``--remat`` regions (``nn.remat`` of the HRNet stages,
``jax.checkpoint`` of a whole forward, of the loss bundle and of each GAN
discriminator family) are pure functions: their recompute in the backward
sees the state and the random keys the first pass saw, and the state they
return is the first pass's.  ``torch.utils.checkpoint`` reruns the
region's Python instead, so in-place state would move a second time and
the recompute would read it after the first move:

- BatchNorm running statistics (``models/subnets.BatchNorm``);
- the spectral norms' ``u`` and ``sigma`` (``models/discriminators.SNConv``),
  whose power iteration the recompute would start from the moved ``u``,
  giving another sigma and so other gradients;
- explicit ``torch.Generator`` objects (VAEHRNet's eps, DetDisc's sync_neg
  offsets): ``preserve_rng_state`` restores only the default generators.

``checkpoint`` keeps the regions pure: it saves the buffers of ``modules``
and the states of ``generators`` before the first pass; the recompute
saves what they hold when it starts, restores the first pass's, runs, and
puts back what it saved.  So each moves once a step, in the order of the
first passes, whatever order the backward recomputes the regions in, and
the recompute computes what the first pass did.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint as _checkpoint


def checkpoint(fn: Callable, *args, modules: Iterable[nn.Module] = (),
               generators: Iterable[Optional[torch.Generator]] = ()):
    """``fn(*args)`` as a checkpoint region (``use_reentrant=False``): its
    activations are not kept but recomputed in the backward.  ``modules``:
    the modules whose buffers the region moves; ``generators``: the
    generators it draws from (None entries are skipped).  Without grad it
    is ``fn(*args)``."""
    if not torch.is_grad_enabled():
        return fn(*args)
    bufs = [b for m in modules for b in m.buffers()]
    gens = [g for g in generators if g is not None]

    def held():
        with torch.no_grad():
            return [b.clone() for b in bufs], [g.get_state() for g in gens]

    def put(state):
        with torch.no_grad():
            for b, v in zip(bufs, state[0]):
                b.copy_(v)
        for g, s in zip(gens, state[1]):
            g.set_state(s)

    entry, passes = held(), []

    def run(*a):
        if not passes:                  # the first pass
            passes.append(1)
            return fn(*a)
        now = held()                    # the recompute
        put(entry)
        try:
            return fn(*a)
        finally:                        # also when it stops early
            put(now)

    return _checkpoint(run, *args, use_reentrant=False)
