"""Launcher of the port (counterpart of the JAX package's ``cli/main.py``;
reference ``main.py:36-158``):

    python -m deep_video_interpolation_extrapolation_tpu_torch.cli.main \\
        <global flags> INTER <flags>

Keeps the reference's experiment-dir and logging contract:
- exp dir ``<save_dir>/<model>_<mode>_<syn_type>_<session>_<timestamp>``;
- stdout + per-split file logger, full sorted config dump at startup;
- split dispatch: train -> epoch loop with checkpointing, val -> single or
  checkpoint-range sweep, cycgen / mycycgen -> recursive generation.

It runs on the card; ``run(cfg, device="cpu")`` asks for the CPU (the
tests do).  Without a card ``run`` raises rather than fall back.

Data parallelism: under ``DVIE_MULTIHOST=1`` each process is one rank of a
``torch.distributed`` group (``parallel/dist.init_from_env``: the
``DVIE_COORDINATOR`` / ``DVIE_NUM_PROCS`` / ``DVIE_PROC_ID`` contract of
JAX ``cli/main.py:52-57``), on ``cuda:<rank mod cards>`` or the CPU.  Rank 0
names the experiment directory and broadcasts it (the ranks' clocks
differ); every rank logs (rank r > 0 to ``experiment_<split>_rank<r>.log``),
rank 0 alone dumps the config.  cycgen and mycycgen write one tree: rank 0
runs them, the other ranks return None.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
import time
from typing import Optional

from deep_video_interpolation_extrapolation_tpu_torch.cli.options import parse_args


def get_exp_path(cfg) -> str:
    ts = time.strftime("%b%d-%H-%M-%S", time.localtime())
    name = f"{cfg.model}_{cfg.mode}_{cfg.syn_type}_{cfg.session}_{ts}"
    return os.path.join(cfg.save_dir, name)


def get_logger(exp_dir: str, split: str, rank: int = 0) -> logging.Logger:
    logger = logging.getLogger("dvie")
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter(
        "[%(asctime)s %(levelname)s] %(message)s", "%Y-%m-%d %H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    tag = f"_rank{rank}" if rank else ""
    fh = logging.FileHandler(os.path.join(exp_dir,
                                          f"experiment_{split}{tag}.log"))
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    return logger


def run(cfg, exp_dir: Optional[str] = None, device="cuda") -> object:
    """Build the runner on ``device`` and dispatch on the split; returns
    the split's result.  Under ``DVIE_MULTIHOST=1`` it starts the process
    group first and ends it before it returns."""
    import torch.distributed

    from deep_video_interpolation_extrapolation_tpu_torch.core import hw
    from deep_video_interpolation_extrapolation_tpu_torch.parallel import (
        dist,
    )

    device = hw.entry_device(device)   # no card: raise before any output
    started = not torch.distributed.is_initialized()
    device = dist.init_from_env(device)
    try:
        return _dispatch(cfg, exp_dir, device)
    finally:
        if started and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _dispatch(cfg, exp_dir: Optional[str], device) -> object:
    from deep_video_interpolation_extrapolation_tpu_torch.parallel import (
        dist,
    )
    from deep_video_interpolation_extrapolation_tpu_torch.train.runner import (
        Runner,
    )

    if exp_dir is None:
        exp_dir = dist.broadcast(get_exp_path(cfg) if dist.is_main()
                                 else None)
    if cfg.split in ("cycgen", "mycycgen") and not dist.is_main():
        return None
    os.makedirs(exp_dir, exist_ok=True)
    logger = get_logger(exp_dir, cfg.split, dist.rank())
    if dist.is_main():
        for k, v in sorted(dataclasses.asdict(cfg).items()):
            logger.info("%s: %s", k, v)

    runner = Runner(cfg, exp_dir, device=device)
    if cfg.split == "train":
        runner.train_epochs()
        return None
    if cfg.split == "val":
        if cfg.checkepoch_range:
            return runner.validate_range()
        return runner.validate()
    if cfg.split == "cycgen":
        return runner.cycgen()
    if cfg.split == "mycycgen":
        return runner.mycycgen()
    raise SystemExit(
        f"split {cfg.split!r} has no implementation for runner {cfg.runner}"
        " (the reference's active runners also lack test(), main.py:96-97)")


def main(argv=None) -> None:
    cfg = parse_args(argv)
    run(cfg)


if __name__ == "__main__":
    main()
