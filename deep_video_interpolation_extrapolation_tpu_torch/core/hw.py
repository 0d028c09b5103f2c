"""Kernel routing, launch counters, and kernel weight layouts kept per weight.

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

from typing import Callable, Sequence

import torch
from torch.utils.weak import WeakIdKeyDictionary

KERNELS = ("conv3x3_bias_res_lrelu", "bottleneck_tail", "fuse_out0",
           "ups_head_taps", "ups_head_1x1", "stem_fwd", "stem_bwd",
           "bottleneck_fwd", "bottleneck_bwd", "bb_chain_fwd", "bb_chain_bwd",
           "ups_head_taps4", "window_attention", "shifted_add_bias",
           "grid_sample", "grid_sample_bounded", "dual_head",
           "bb_chain_fwd_c128", "bb_chain_bwd_c128", "bb_chain_fwd_c256",
           "bb_chain_bwd_c256", "bb_chain_wgrad", "bottleneck_wgrad",
           "stem48_fwd", "stem48_bwd", "upshead_taps_n216", "shiftadd_co24",
           "upshead4_taps_n216", "ups_head_1x1_4", "stem64_fwd", "stem64_bwd",
           "grid_sample_bwd")

launches = {name: 0 for name in KERNELS}


def reset_counters() -> None:
    for name in launches:
        launches[name] = 0


def entry_device(device) -> torch.device:
    """The device an entry point builds on (``"cuda"`` unless the caller
    asks for another): raises for a CUDA device when there is no card,
    rather than running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for {device} (torch.cuda.is_available() is "
            "False); pass device='cpu' to build on the CPU")
    return device


# compute capability by CUDA device index, read once per device (the
# wrappers route every call by it)
_capability = {}


def tracing() -> bool:
    """Whether the running code is being traced (``torch.export``,
    ``torch.compile``): its tensors are fake, with no data to launch on."""
    return torch.compiler.is_compiling()


def serving(*tensors) -> bool:
    """Whether a kernel call on these operands takes its ``dvie::`` op
    (``ops/library.py``): none of them needs a gradient here (grad mode
    off, or no operand requires one)."""
    return not (torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors))


def use_kernel(t: torch.Tensor) -> bool:
    """True for a tensor the Hopper kernels take, False for a CPU tensor.
    A CUDA tensor under a tracer raises: a kernel reached outside its
    ``dvie::`` op cannot be recorded in a graph."""
    device = t.device
    if device.type == "cpu":
        return False
    if device.type == "cuda":
        if tracing():
            raise RuntimeError(
                "a kernel without a dvie:: op (ops/library.py) was reached "
                "while tracing on the card; only the served kernels are "
                "ops (export at a serving shape, W >= 256)")
        cap = _capability.get(device.index)
        if cap is None:
            cap = _capability[device.index] = \
                torch.cuda.get_device_capability(device)
        if cap == (9, 0):
            return True
        raise RuntimeError(
            f"the kernels are built for sm_90a (H100/H200); {device} has "
            f"compute capability {cap}")
    raise RuntimeError(f"no route for a tensor on {device}")


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


# per weight tensor (the first of a set), while it lives: {key: (stamp, value)}
_derived = WeakIdKeyDictionary()


def derived(key: str, weights: Sequence, build: Callable):
    """``build()``, kept from an earlier call with the same ``key`` and the
    same ``weights`` (tensors or None) unchanged: a kernel's weight layout
    is built once per weight, not once per call.  A weight counts as
    changed when its storage or its version counter (bumped by every
    in-place update, an optimizer step included) has moved.  Inference
    tensors keep no version counter, so for them ``build()`` runs on every
    call; under a tracer it runs too, and its ops enter the graph."""
    ts = [t for t in weights if t is not None]
    if tracing() or any(t.is_inference() for t in ts):
        return build()
    stamp = tuple(None if t is None else (id(t), t.data_ptr(), t._version)
                  for t in weights)
    slot = _derived.get(ts[0])
    if slot is None:
        slot = _derived[ts[0]] = {}
    kept = slot.get(key)
    if kept is not None and kept[0] == stamp:
        return kept[1]
    value = build()
    slot[key] = (stamp, value)
    return value
