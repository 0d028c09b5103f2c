"""The runner's batch producer (``Runner._host_batches`` and, on the CPU,
``_device_prefetch``): a thread that builds the loader's batches ahead of
the consumer.  Under a shortened thread switch interval the batches come
in the loader's order and unchanged; an error in the loader is raised in
the consumer; a consumer that stops early stops the thread, which then
draws at most ``depth`` + 2 batches past the last one consumed."""

import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu_torch.train.runner import (
    Runner,
)

CPU = types.SimpleNamespace(device=torch.device("cpu"))


class _Loader:
    def __init__(self, n, fail_at=None):
        self.n, self.fail_at, self.drawn = n, fail_at, 0
        self.lock = threading.Lock()

    def __iter__(self):
        for i in range(self.n):
            if i == self.fail_at:
                raise RuntimeError(f"bad batch {i}")
            with self.lock:
                self.drawn += 1
            yield {"frame1": np.full((2, 3), i, np.float32),
                   "seg1": np.full((2, 3), i % 20, np.uint8)}


@pytest.fixture
def fast_switch():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def _prefetch(loader, depth=2):
    # _device_prefetch reads self.device and, on the card, its copy stream
    fake = types.SimpleNamespace(device=torch.device("cpu"))
    fake._host_batches = lambda ld, d: Runner._host_batches(fake, ld, d)
    return Runner._device_prefetch(fake, loader, depth)


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_batches_in_order(fast_switch, depth):
    got = [int(b["frame1"][0, 0]) for b in _prefetch(_Loader(200), depth)]
    assert got == list(range(200))


def test_loader_error_reaches_the_consumer(fast_switch):
    got = []
    with pytest.raises(RuntimeError, match="bad batch 7"):
        for b in Runner._host_batches(CPU, _Loader(50, fail_at=7), 2):
            got.append(int(b["seg1"][0, 0]))
    assert got == list(range(7))


def test_early_stop_stops_the_thread(fast_switch):
    loader = _Loader(10_000)
    before = threading.active_count()
    it = Runner._host_batches(CPU, loader, 2)
    for _ in range(5):
        next(it)
    it.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before
    assert loader.drawn <= 5 + 2 + 2
