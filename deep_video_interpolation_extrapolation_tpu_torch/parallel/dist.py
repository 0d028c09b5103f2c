"""Data parallelism over ``torch.distributed`` (counterpart of the JAX
package's ``parallel/mesh.py`` and of the runner's ``data`` axis).

The reference runs one NCCL process per GPU, DDP with a TCP rendezvous
(main.py:76-77, 152-154; runners/InterTrainer.py:63-64, 84-87).  The JAX
package replaces it by one program over a device mesh whose ``data`` axis
shards the batch.  The port goes back to one process per rank:

- ``init_from_env`` starts the process group from the JAX package's
  contract, ``DVIE_MULTIHOST=1`` with ``DVIE_COORDINATOR=<host:port>``,
  ``DVIE_NUM_PROCS`` and ``DVIE_PROC_ID`` (a ``tcp://`` rendezvous), or
  without a coordinator torch's ``env://`` (``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``: a launcher such as
  ``torchrun`` sets them), which stands in for JAX's cluster detection;
- each rank takes its rows of the same global batch (``shard_of``), and
  while a step runs on such a shard (``sharded``) the BatchNorm statistics
  are those of the global batch (``batch_moments``) and every per-sample
  random draw is the global batch's draw, of which each rank keeps its
  rows (``global_draw``): the step of N ranks is the one-process step of
  the global batch;
- each trained submodel's gradients are averaged over the ranks in one
  flat bucket before its optimizer steps (``average_grads``), as XLA's
  gradient reduction over the ``data`` axis;
- losses and metrics are reduced across the ranks for the log.

Spatial sharding (JAX's ``spatial`` axis, ``--num_spatial_shards S``;
``parallel/spatial.py``): a world of D x S processes, rank ``d * S + s``
rank ``s`` of the spatial group ``d`` (spatial innermost, as JAX's mesh,
mesh.py:84-93).  Each spatial group holds one data shard's rows
(``shard_of``: by the data rank ``d``), each rank of it a band of their
rows (``spatial_band``).  A rank's loss is its band's share of the group's
loss, so ``average_grads`` sums the gradients over each spatial group and
averages them over the data groups, and ``mean_over_ranks`` reduces the
logged shares the same way: one all-reduce over the world divided by D
does both.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Callable, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from deep_video_interpolation_extrapolation_tpu_torch.parallel import spatial


@dataclasses.dataclass(frozen=True)
class Shard:
    """This process's part of a global batch: data rank ``rank`` of
    ``world`` data shards."""
    world: int
    rank: int

    def rows(self, n: int) -> slice:
        """This rank's rows of an ``n``-row global batch."""
        b = local_batch_size(n, self.world)
        return slice(self.rank * b, (self.rank + 1) * b)


# the shard the running step works on; None outside a sharded step
_SHARD: contextvars.ContextVar[Optional[Shard]] = contextvars.ContextVar(
    "dvie_shard", default=None)


def init_from_env(device="cuda") -> torch.device:
    """Start the process group under ``DVIE_MULTIHOST=1`` (JAX
    ``maybe_init_distributed``, mesh.py:43-73) and return this process's
    device: ``cuda:<rank mod device count>`` for a CUDA ``device``, else
    ``device``.  The group runs on NCCL where each rank has a card of its
    own, on gloo on the CPU and where ranks share a card (NCCL takes one
    rank a device).  Without ``DVIE_MULTIHOST`` nothing starts and
    ``device`` is returned as it is.  A partial or out-of-range contract
    raises the JAX ``RuntimeError``."""
    device = torch.device(device)
    if not int(os.environ.get("DVIE_MULTIHOST", "0")):
        return device
    if os.environ.get("DVIE_COORDINATOR"):
        nproc = os.environ.get("DVIE_NUM_PROCS")
        pid = os.environ.get("DVIE_PROC_ID")
        if nproc is None or pid is None:
            raise RuntimeError(
                "DVIE_COORDINATOR is set but the rendezvous contract "
                "needs all three variables: DVIE_COORDINATOR=<host:port>"
                ", DVIE_NUM_PROCS=<N>, DVIE_PROC_ID=<0..N-1> "
                f"(got DVIE_NUM_PROCS={nproc!r}, DVIE_PROC_ID={pid!r})")
        if not 0 <= int(pid) < int(nproc):
            raise RuntimeError(
                f"DVIE_PROC_ID={pid} out of range for "
                f"DVIE_NUM_PROCS={nproc}")
        world, rank = int(nproc), int(pid)
        kw = dict(init_method=f"tcp://{os.environ['DVIE_COORDINATOR']}",
                  world_size=world, rank=rank)
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        rank = int(os.environ.get("RANK", "0"))
        kw = dict(init_method="env://")
    backend = "gloo"
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("DVIE_MULTIHOST on the card, but "
                               "torch.cuda.is_available() is False")
        n_cards = torch.cuda.device_count()
        device = torch.device("cuda", rank % n_cards)
        torch.cuda.set_device(device)
        if world <= n_cards:
            backend = "nccl"
    if not dist.is_initialized():
        dist.init_process_group(backend, **kw)
    return device


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Rank 0, or the only process: the one that writes checkpoints, the
    config dump and the TensorBoard scalars."""
    return rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def broadcast(obj):
    """Rank 0's ``obj`` on every rank (a picklable value)."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def data_shards(requested: int, spatial_shards: int = 1) -> int:
    """The data-parallel degree D of ``--num_data_shards``: the group's
    world size (1 without a group) over ``--num_spatial_shards`` S, which
    must divide it; 0 means that D, any other value must equal it."""
    w = world_size()
    if spatial_shards < 1 or w % spatial_shards:
        raise ValueError(
            f"--num_spatial_shards {spatial_shards} does not divide the "
            f"{w} processes of this run")
    n = w // spatial_shards
    if requested > 0 and requested != n:
        raise ValueError(
            f"--num_data_shards {requested} needs {requested * spatial_shards}"
            f" processes (DVIE_MULTIHOST=1 with DVIE_NUM_PROCS="
            f"{requested * spatial_shards}); this run has {w}")
    return n


def local_batch_size(global_batch: int, n: int) -> int:
    """Per-rank batch (JAX ``local_batch_size``, mesh.py:110; the
    reference's ``bs // num_gpus``, InterTrainer.py:86): the global batch
    must divide by the ranks."""
    if global_batch % n:
        raise ValueError(f"batch {global_batch} does not divide over "
                         f"{n} data shards")
    return global_batch // n


def shard_of(n: int, spatial_shards: int = 1) -> Optional[Shard]:
    """The shard this rank takes of an ``n``-row global batch, by its data
    rank (rank // ``spatial_shards``), or None where there is one data
    shard or ``n`` does not divide over them (such a batch runs whole on
    every data shard, as JAX runs it replicated)."""
    w = world_size() // spatial_shards
    if w == 1 or n % w:
        return None
    return Shard(w, rank() // spatial_shards)


# the spatial groups of the running world, by S: (world group, this rank's
# band); rebuilt when the world is
_BANDS: dict = {}


def spatial_band(spatial_shards: int) -> Optional[spatial.Band]:
    """This rank's band under ``--num_spatial_shards`` S (None for S = 1):
    spatial group d holds ranks d*S .. d*S + S - 1.  Every rank creates
    every group, in the same order, once per world."""
    if spatial_shards <= 1:
        return None
    data_shards(0, spatial_shards)
    cached = _BANDS.get(spatial_shards)
    if cached is not None and cached[0] is dist.group.WORLD:
        return cached[1]
    w, r = world_size(), rank()
    band = None
    for d in range(w // spatial_shards):
        ranks = list(range(d * spatial_shards, (d + 1) * spatial_shards))
        group = dist.new_group(ranks)
        if r in ranks:
            band = spatial.Band(spatial_shards, r - ranks[0], group)
    _BANDS[spatial_shards] = (dist.group.WORLD, band)
    return band


@contextlib.contextmanager
def sharded(shard: Optional[Shard]):
    """Run a step on ``shard`` of the global batch (None: the whole
    batch)."""
    token = _SHARD.set(shard)
    try:
        yield
    finally:
        _SHARD.reset(token)


def global_draw(draw: Callable, shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)``, a per-sample draw over a batch of ``shape[0]``
    rows.  Under a sharded step every rank draws for the whole global
    batch from the same generator and keeps its rows, so the ranks draw
    what one process draws for the global batch."""
    s = _SHARD.get()
    if s is None:
        return draw(tuple(shape))
    b = shape[0]
    full = draw((b * s.world, *shape[1:]))
    return full[s.rank * b:(s.rank + 1) * b]


def batch_moments(x: torch.Tensor, axes: Tuple[int, ...]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-channel mean and biased variance E[x^2] - E[x]^2 (clipped at
    0, as flax) of ``x`` over ``axes``.  Under a sharded step, over the
    global batch: the sums of x and x^2 and the count are all-reduced
    (differentiably), as JAX's statistics of a sharded batch are.  On a
    band (spatial sharding) it raises: the moments over data x spatial are
    not ported (ROADMAP.md queue 1, item 10)."""
    if spatial.current() is not None:
        raise NotImplementedError(
            "BatchNorm statistics over the bands of a spatial group are not "
            "ported yet (ROADMAP.md queue 1, item 10)")
    if _SHARD.get() is None:
        mean = x.mean(axes)
        return mean, ((x * x).mean(axes) - mean * mean).clamp_min(0.0)
    from torch.distributed.nn.functional import all_reduce
    count = x.new_tensor([float(x.numel() // x.shape[-1])])
    sums = all_reduce(torch.cat([x.sum(axes), (x * x).sum(axes), count]))
    c = x.shape[-1]
    n = sums[-1]
    mean = sums[:c] / n
    return mean, (sums[c:2 * c] / n - mean * mean).clamp_min(0.0)


def average_grads(params: Iterable[torch.nn.Parameter],
                  spatial_shards: int = 1) -> None:
    """Sum the ``.grad`` of ``params`` over each spatial group (a band's
    gradient is its share of the group's) and average it over the data
    shards, in one flat bucket (one all-reduce over the world, divided by
    the data shards); a no-op in one process.  Every rank holds the same
    parameters, so the same ones carry a gradient."""
    if world_size() == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat)
    flat /= world_size() // spatial_shards
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def mean_over_ranks(t: torch.Tensor, spatial_shards: int = 1
                    ) -> torch.Tensor:
    """``t`` summed over each spatial group and averaged over the data
    shards (a copy): with ``spatial_shards`` S = 1 its mean over the ranks;
    under S > 1 each rank holds its band's share of its group's value.
    ``t`` in one process."""
    if world_size() == 1:
        return t
    t = t.clone()
    dist.all_reduce(t)
    return t / (world_size() // spatial_shards)
