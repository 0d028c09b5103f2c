"""Kernel routing and launch counters.

Counterpart of the JAX package's ``core/hw.pallas_enabled``, without an
environment kill-switch: the route is decided by the tensor alone.

- a tensor on ``cuda`` on a card of compute capability (9, 0) takes the
  hand-written kernel;
- a tensor on ``cpu`` takes the kernel's plain PyTorch version;
- anything else raises.

``launches`` holds one plain int per kernel (a backward wrapper that queues
several launches counts one per call).  Each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import torch

KERNELS = ("conv3x3_bias_res_lrelu", "bottleneck_tail", "fuse_out0",
           "ups_head_taps", "ups_head_1x1", "stem_fwd", "stem_bwd",
           "bottleneck_fwd", "bottleneck_bwd")

launches = {name: 0 for name in KERNELS}


def reset_counters() -> None:
    for name in launches:
        launches[name] = 0


def use_kernel(t: torch.Tensor) -> bool:
    """True for a tensor the Hopper kernels take, False for a CPU tensor."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        cap = torch.cuda.get_device_capability(t.device)
        if cap == (9, 0):
            return True
        raise RuntimeError(
            f"the kernels are built for sm_90a (H100/H200); {t.device} has "
            f"compute capability {cap}")
    raise RuntimeError(f"no route for a tensor on {t.device}")


def check_bf16(name: str, t: torch.Tensor, shape=None) -> None:
    """Device, dtype, shape, contiguity and alignment checks of a kernel
    operand (raise on anything the kernel does not take)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name}: expected bfloat16, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")
