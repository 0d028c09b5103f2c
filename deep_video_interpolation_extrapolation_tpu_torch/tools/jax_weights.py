"""JAX HRNet (and frozen VGG19) parameters -> the port's ``state_dict``.

The inverse of the JAX package's ``tools/torch_port.port_hrnet`` (which maps
the reference's torch HRNet state_dict onto the flax tree): flax HWIO conv
kernels become torch OIHW weights (transpose (3, 2, 0, 1)), biases copy.
Takes the ``params["coarse_model"]`` tree as nested dicts of numpy arrays;
imports no jax (callers convert with ``np.asarray``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from deep_video_interpolation_extrapolation_tpu_torch.models.features import (
    conv_names,
)


def key_map(params: Mapping) -> Iterator[Tuple[str, Tuple[str, ...]]]:
    """(torch key, path in the flax tree) for every parameter of the port's
    HRNet, in the order and naming of port_hrnet (torch_port.py:42-92)."""
    for cv, tid in (("Conv_0", 0), ("Conv_1", 2), ("Conv_2", 4)):
        yield f"seg_encoder.{tid}.weight", ("seg_encoder", cv, "kernel")
        yield f"seg_encoder.{tid}.bias", ("seg_encoder", cv, "bias")
    for cv in ("conv1", "conv2"):
        yield f"{cv}.weight", ("backbone", cv, "kernel")
        yield f"{cv}.bias", ("backbone", cv, "bias")
    bb = params["backbone"]
    for i in range(4):
        blk = ("backbone", f"layer1_{i}")
        yield f"layer1.{i}.conv1.weight", blk + ("Conv_0", "kernel")
        yield f"layer1.{i}.conv2.weight", blk + ("Conv_1", "kernel")
        yield f"layer1.{i}.conv3.weight", blk + ("Conv_2", "kernel")
        if "Conv_3" in bb[f"layer1_{i}"]:
            yield (f"layer1.{i}.downsample.0.weight",
                   blk + ("Conv_3", "kernel"))
    yield ("transition1.0.0.weight",
           ("backbone", "transition1", "trans_0", "kernel"))
    yield ("transition1.1.0.0.weight",
           ("backbone", "transition1", "trans_1_0", "kernel"))
    yield ("transition2.2.0.0.weight",
           ("backbone", "transition2", "trans_2_0", "kernel"))
    for stage, n_br in (("stage2", 2), ("stage3", 3)):
        sp = ("backbone", stage)
        for br in range(n_br):
            for k in range(4):
                blk = sp + (f"BasicBlock_{br * 4 + k}",)
                yield (f"{stage}.0.branches.{br}.{k}.conv1.weight",
                       blk + ("Conv_0", "kernel"))
                yield (f"{stage}.0.branches.{br}.{k}.conv2.weight",
                       blk + ("Conv_1", "kernel"))
        for i in range(n_br):
            for j in range(n_br):
                if j > i:
                    yield (f"{stage}.0.fuse_layers.{i}.{j}.0.weight",
                           sp + (f"fuse_{i}_{j}", "kernel"))
                elif j < i:
                    for k in range(i - j):
                        yield (f"{stage}.0.fuse_layers.{i}.{j}.{k}.0.weight",
                               sp + (f"fuse_{i}_{j}_{k}", "kernel"))
    for head in ("rgb_layer", "seg_layer"):
        yield f"{head}.0.weight", (head, "Conv_0", "kernel")
        yield f"{head}.0.bias", (head, "Conv_0", "bias")
        yield f"{head}.2.weight", (head, "Conv_1", "kernel")
        yield f"{head}.2.bias", (head, "Conv_1", "bias")


def from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """``params["coarse_model"]`` of a JAX HRNet/InterNet -> the port's
    HRNet ``state_dict`` (load it with ``model.coarse_model.load_state_dict``
    for an InterNet)."""
    sd = OrderedDict()
    for key, path in key_map(params):
        a = params
        for p in path:
            a = a[p]
        a = np.asarray(a, dtype=np.float32)
        if a.ndim == 4:       # HWIO -> OIHW
            a = np.transpose(a, (3, 2, 0, 1))
        sd[key] = torch.from_numpy(np.array(a, order="C"))   # a writable copy
    return sd


def from_jax_vgg(vgg_params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's frozen VGG19 params (``frozen["vgg"]``: one
    ``conv{b}_{i}`` dict of HWIO kernel and bias per conv) -> the
    ``state_dict`` of the port's ``models/features.VGG19Features``."""
    sd = OrderedDict()
    for name in conv_names():
        kernel = np.asarray(vgg_params[name]["kernel"], dtype=np.float32)
        sd[f"convs.{name}.weight"] = torch.from_numpy(
            np.array(np.transpose(kernel, (3, 2, 0, 1)), order="C"))
        sd[f"convs.{name}.bias"] = torch.from_numpy(np.array(
            vgg_params[name]["bias"], dtype=np.float32))
    return sd
