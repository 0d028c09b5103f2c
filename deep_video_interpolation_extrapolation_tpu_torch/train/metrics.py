"""Metric bookkeeping (a copy of the JAX package's ``train/metrics.py``;
reference utils/net_utils.py:72-87 AverageMeter and InterTrainer.sync):
running averages of the losses and metrics, aggregated on the host."""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict


class AverageMeter:
    """Running average (utils/net_utils.py:72-87)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class MetricBank:
    def __init__(self, names):
        self.meters: "OrderedDict[str, AverageMeter]" = OrderedDict(
            (n, AverageMeter()) for n in names)

    def update(self, values: Dict, n: int = 1):
        for k, v in values.items():
            if k not in self.meters:
                self.meters[k] = AverageMeter()
            self.meters[k].update(float(v), n)

    def averages(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}
