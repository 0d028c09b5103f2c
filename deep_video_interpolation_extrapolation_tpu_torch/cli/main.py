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


def get_logger(exp_dir: str, split: str) -> logging.Logger:
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
    fh = logging.FileHandler(os.path.join(exp_dir, f"experiment_{split}.log"))
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    return logger


def run(cfg, exp_dir: Optional[str] = None, device="cuda") -> object:
    """Build the runner on ``device`` and dispatch on the split; returns
    the split's result."""
    from deep_video_interpolation_extrapolation_tpu_torch.core import hw
    from deep_video_interpolation_extrapolation_tpu_torch.train.runner import (
        Runner,
    )

    device = hw.entry_device(device)   # no card: raise before any output
    if exp_dir is None:
        exp_dir = get_exp_path(cfg)
    os.makedirs(exp_dir, exist_ok=True)
    logger = get_logger(exp_dir, cfg.split)
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
