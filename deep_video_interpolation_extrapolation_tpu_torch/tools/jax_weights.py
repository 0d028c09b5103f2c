"""JAX model (and frozen VGG19) parameters -> the port's ``state_dict``s.

The inverses of the JAX package's ``tools/torch_port`` mappers, which map
the reference's torch state_dicts onto the flax trees: ``port_hrnet``
(``key_map``, ``from_jax_params``), ``port_srn_refine`` (``refine_key_map``,
the same leaves at every ``n_scales``: one core serves every scale),
``port_ms_res_attn_refine`` (``stage3_key_map``) and ``port_pyramid_attn``
(``pyramid_key_map``, V2 / V2Base / V3).  ``RefineUnet`` has no torch_port
mapper: ``refine_unet_key_map`` maps the flax names onto the port's, which
are the same.  Flax HWIO conv
kernels become torch OIHW weights (transpose (3, 2, 0, 1)); a flax
``ConvTranspose`` kernel (kh, kw, in, out), which ``convT_w`` flipped in
both spatial axes (torch_port.py:32-35), is flipped back and becomes torch's
(in, out, kh, kw); biases copy.  Takes the trees as nested dicts of numpy
arrays; imports no jax (callers convert with ``np.asarray``).

The video VAEs have no torch_port mapper: ``vae_key_map`` maps the flax
tree's auto-names (``Conv_k``, ``BatchNorm_k``, ``ConvTranspose_k``, the
named ``Dense`` layers) straight onto the port's module names, and so does
``inpaint_key_map`` for ExtraInpaintNet's ``InpaintUnet`` (``Conv_k``,
``ResnetBlock_k``); an extrapolation HRNet's heads are HRNet's map at
their own widths.  VAEHRNet
is HRNet's map plus its latent modules by the same table
(``from_jax_vaehrnet``); a discriminator's map walks the port module, whose
containers keep their children's flax names (``disc_key_map``: kernels,
biases, BatchNorm scale, bias and statistics, and each spectral norm's
``u`` and ``sigma``).  The legacy models' port modules carry the flax
module names, so ``flax_key_map`` maps their trees generically
(``load_jax_legacy``; the legacy heads' HRNet coarse and refiner by their
own maps); so do the SRN-era refiners (``models/srn_legacy``).  The legacy
attention refiners V2..V4Base carry the reference's names:
``attn_legacy_key_map`` is the inverse of ``port_attn_legacy``
(torch_port.py:590-700).  OpticalUnet and OpticalRefineNet map by
``refine_unet_key_map`` (``optical_key_map``).
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch

from deep_video_interpolation_extrapolation_tpu_torch.models.features import (
    RESNET101_PLAN,
    conv_names,
)


def key_map(params: Mapping) -> Iterator[Tuple[str, Tuple[str, ...]]]:
    """(torch key, path in the flax tree) for every parameter of the port's
    HRNet, in the order and naming of port_hrnet (torch_port.py:42-92).
    A ``--highres_large`` tree (with ``transition3`` and ``stage4``) also
    maps trans_3_0 and the 4-branch stage4 in the reference's torch naming,
    which port_hrnet does not cover."""
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
    stages = [("stage2", 2), ("stage3", 3)]
    if "transition3" in bb:
        yield ("transition3.3.0.0.weight",
               ("backbone", "transition3", "trans_3_0", "kernel"))
        stages.append(("stage4", 4))
    for stage, n_br in stages:
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


def _conv(path, tname):
    """A conv's weight and bias at flax ``path``."""
    yield f"{tname}.weight", path + ("kernel",)
    yield f"{tname}.bias", path + ("bias",)


def refine_key_map(params: Mapping
                   ) -> Iterator[Tuple[str, Tuple[str, ...]]]:
    """(torch key, flax path) for every parameter of ``SRNRefine``, the
    inverse of port_srn_refine (torch_port.py:95-142)."""
    def conv(path, tname):
        yield f"{tname}.weight", ("core",) + path + ("kernel",)
        yield f"{tname}.bias", ("core",) + path + ("bias",)

    def clrelu(i, tname):
        yield from conv((f"ConvLReLU_{i}", "Conv_0"), tname)

    def res(i, tname):
        yield from conv((f"ResnetBlock_{i}", "Conv_0"), f"{tname}.conv.0")
        yield from conv((f"ResnetBlock_{i}", "Conv_1"), f"{tname}.conv.2")

    for i, t in enumerate((0, 2, 4)):
        yield from clrelu(i, f"input_layer.{t}")
    for k, t in enumerate((6, 7, 8)):
        yield from res(k, f"input_layer.{t}")
    for e, (ci, ri) in enumerate(((3, 3), (4, 6)), start=1):
        yield from clrelu(ci, f"encoder_{e}.0")
        for k, t in enumerate((2, 3, 4)):
            yield from res(ri + k, f"encoder_{e}.{t}")
    for k, t in enumerate((0, 2, 4, 6)):
        yield from clrelu(5 + k, f"bottle_dilated.{t}")
    yield from clrelu(9, "hidden_comb.0")
    yield from clrelu(10, "hidden_comb.2")
    for d, (ri, ct) in (("decoder_2", (9, 0)), ("decoder_1", (12, 1))):
        for k in range(3):
            yield from res(ri + k, f"{d}.{k}")
        yield from conv((f"ConvT_{ct}", "ConvTranspose_0"), f"{d}.3")
    for k in range(3):
        yield from res(15 + k, f"output_layer.{k}")
    yield from clrelu(11, "output_layer.3")
    yield from conv(("Conv_0",), "output_layer.5")


# (flax module, reference Sequential entry) of MSResAttnRefine's ConvLReLU
# layers (torch_port.py:145-171)
ATTN_CONV_PAIRS = [
    (f"{name}_{i}", f"{name}.{2 * i}")
    for name, n in (("input_layer", 2), ("attn_input_layer", 2),
                    ("attn_encoder_1", 2), ("attn_encoder_2", 2),
                    ("attn_fuse_layer", 2), ("attn_img_fuse_layer", 2),
                    ("img_input_layer", 2), ("img_encoder_1", 2),
                    ("img_encoder_2", 2), ("img_atrous_layer", 4),
                    ("img_fuse_layer", 2), ("output_layer", 2))
    for i in range(n)]


def stage3_key_map(params: Mapping
                   ) -> Iterator[Tuple[str, Tuple[str, ...]]]:
    """(torch key, flax path) for every parameter of ``MSResAttnRefine``
    that the JAX tree holds, the inverse of port_ms_res_attn_refine
    (torch_port.py:174-193).  At ``n_scales == 1`` the JAX module never
    creates ``attn_fuse_layer``: its two convs are not in the tree, and the
    port's keep their seeded init (``load_jax_params`` returns their
    keys)."""
    for ours, theirs in ATTN_CONV_PAIRS:
        if ours in params:
            yield from _conv((ours, "Conv_0"), theirs)
    yield from _conv(("output_conv",), "output_layer.4")
    for dec in ("decoder_2", "decoder_1"):
        yield from _conv((f"{dec}_t", "ConvTranspose_0"), f"{dec}.0")
        yield from _conv((f"{dec}_r", "Conv_0"), f"{dec}.2.conv.0")
        yield from _conv((f"{dec}_r", "Conv_1"), f"{dec}.2.conv.2")


def pyramid_key_map(params: Mapping, variant: str
                    ) -> Iterator[Tuple[str, Tuple[str, ...]]]:
    """(torch key, flax path) for every parameter of ``PyramidAttnRefine``
    (``variant`` "v2", "v2base" or "v3"), the inverse of port_pyramid_attn
    (torch_port.py:268-335)."""
    res = variant == "v3"

    def group(name, conv_ids, res_ids=()):
        for k, t in enumerate(conv_ids):
            yield from _conv((f"{name}_{k}", "Conv_0"), f"{name}.{t}")
        for k, t in enumerate(res_ids):
            yield from _conv((f"{name}_res{k}", "Conv_0"), f"{name}.{t}.conv.0")
            yield from _conv((f"{name}_res{k}", "Conv_1"), f"{name}.{t}.conv.2")

    if res:
        groups = [("input_layer", (0, 2)), ("encoder_layer_1", (0,)),
                  ("encoder_layer_2", (0, 2)), ("encoder_layer_3", (0, 2)),
                  ("layer_1_neighbor_tf", (0, 2)),
                  ("layer_2_neighbor_tf", (0, 2)), ("layer_3_fuse", (0, 2))]
        for name, ids in groups:
            yield from group(name, ids, (len(ids) * 2, len(ids) * 2 + 1))
    else:
        for name, ids in (("input_layer", (0, 2)), ("encoder_layer_1", (0, 2)),
                          ("encoder_layer_2", (0, 2, 4)),
                          ("encoder_layer_3", (0, 2, 4)),
                          ("layer_1_neighbor_tf", (0, 2)),
                          ("layer_2_neighbor_tf", (0, 2)),
                          ("layer_3_fuse", (0, 2)), ("layer_1_fuse", (0, 2)),
                          ("layer_2_fuse", (0, 2))):
            yield from group(name, ids)
    if variant != "v2base":
        for k in (1, 2, 3):
            yield from group(f"attn_down_layer_{k}", (0, 2, 4))
    for k in (3, 2):
        name = f"decoder_layer_{k}"
        yield from _conv((f"{name}_t", "ConvTranspose_0"), f"{name}.0")
        yield from _conv((f"{name}_c", "Conv_0"), f"{name}.2")
        if res:
            for j, t in ((0, 4), (1, 5)):
                yield from _conv((f"{name}_r{j}", "Conv_0"), f"{name}.{t}.conv.0")
                yield from _conv((f"{name}_r{j}", "Conv_1"), f"{name}.{t}.conv.2")
        else:
            yield from _conv((f"{name}_c2", "Conv_0"), f"{name}.4")
    for k in (3, 2, 1):
        name = f"out_layer_{k}"
        yield from _conv((f"{name}_0", "Conv_0"), f"{name}.0")
        if res:
            for j, t in ((0, 2), (1, 3)):
                yield from _conv((f"{name}_r{j}", "Conv_0"), f"{name}.{t}.conv.0")
                yield from _conv((f"{name}_r{j}", "Conv_1"), f"{name}.{t}.conv.2")
        else:
            yield from _conv((f"{name}_1", "Conv_0"), f"{name}.2")
        yield from _conv((f"{name}_out",), f"{name}.4")


def refine_unet_key_map(params: Mapping
                        ) -> Iterator[Tuple[str, Tuple[str, ...]]]:
    """(torch key, flax path) for every parameter of ``RefineUnet``: its
    ``unet`` children keep their flax names; a ConvLReLU's conv is its
    ``Conv_0``, a ConvT's its ``ConvTranspose_0``."""
    for name in sorted(params["unet"]):
        inner = (() if name == "output_layer" else
                 ("ConvTranspose_0",) if name.startswith("up_") else
                 ("Conv_0",))
        yield from _conv(("unet", name) + inner, f"unet.{name}")


def inpaint_key_map(params: Mapping
                    ) -> Iterator[Tuple[str, Tuple[str, ...]]]:
    """(torch key, flax path) for every parameter of ``InpaintUnet``:
    ``Conv_k`` is ``convs.k``, ``ResnetBlock_k``'s two convs are
    ``res.k.conv.0`` and ``res.k.conv.2``."""
    n_conv = sum(k.startswith("Conv_") for k in params)
    n_res = sum(k.startswith("ResnetBlock_") for k in params)
    for k in range(n_conv):
        yield from _conv((f"Conv_{k}",), f"convs.{k}")
    for k in range(n_res):
        yield from _conv((f"ResnetBlock_{k}", "Conv_0"), f"res.{k}.conv.0")
        yield from _conv((f"ResnetBlock_{k}", "Conv_1"), f"res.{k}.conv.2")


def trackgen_key_map(params: Mapping
                     ) -> Iterator[Tuple[str, Tuple[str, ...]]]:
    """(torch key, flax path) for every parameter of ``TrackGen`` and
    ``TrackGenV2``, the inverse of port_track_gen (torch_port.py:338-370):
    the U-Net's ``<group>_<k>`` ConvLReLUs onto ``<group>.<2k>``, its
    ``up_<k>`` transposed convs onto ``up_<k>.0``, the fusion head's
    auto-named layers onto the reference's Sequentials.  V2's last decoder
    conv is a bare ``Conv``, V1's a ConvLReLU."""
    unet = params["unet"]
    for grp in ("encoder_1", "encoder_2", "encoder_3", "encoder_4",
                "bottom_layer", "decoder_4", "decoder_3", "decoder_2",
                "decoder_1"):
        for k in range(3):
            node = unet[f"{grp}_{k}"]
            yield from _conv(("unet", f"{grp}_{k}") + (
                ("Conv_0",) if "Conv_0" in node else ()), f"{grp}.{2 * k}")
    for up in ("up_4", "up_3", "up_2", "up_1"):
        yield from _conv(("unet", up, "ConvTranspose_0"), f"{up}.0")
    head = ("head",)
    yield from _conv(head + ("ConvLReLU_0", "Conv_0"), "track_fusion_layer.0")
    yield from _conv(head + ("ConvLReLU_1", "Conv_0"), "track_fusion_layer.2")
    yield from _conv(head + ("Conv_0",), "track_fusion_layer.4")
    for k in range(5):
        yield from _conv(head + (f"ConvLReLU_{2 + k}", "Conv_0"),
                         f"fusion_layer.{2 * k}")
    for stem in ("rgb_out", "seg_out"):
        yield from _conv(head + (f"{stem}_0", "Conv_0"), f"{stem}_layer.0")
        yield from _conv(head + (f"{stem}_1",), f"{stem}_layer.2")


def _state_dict(params: Mapping, keys) -> Dict[str, torch.Tensor]:
    sd = OrderedDict()
    for key, path in keys:
        a = params
        for p in path:
            a = a[p]
        a = np.asarray(a, dtype=np.float32)
        if a.ndim == 4 and path[-2] == "ConvTranspose_0":
            a = np.transpose(a[::-1, ::-1], (2, 3, 0, 1))   # -> (I, O, kh, kw)
        elif a.ndim == 4:     # HWIO -> OIHW
            a = np.transpose(a, (3, 2, 0, 1))
        sd[key] = torch.from_numpy(np.array(a, order="C"))   # a writable copy
    return sd


def from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """``params["coarse_model"]`` of a JAX HRNet/InterNet -> the port's
    HRNet ``state_dict`` (load it with ``model.coarse_model.load_state_dict``
    for an InterNet)."""
    return _state_dict(params, key_map(params))


def from_jax_refine(params: Mapping) -> Dict[str, torch.Tensor]:
    """``params["refine_model"]`` of a JAX SRNRefine -> its state_dict."""
    return _state_dict(params, refine_key_map(params))


def from_jax_stage3(params: Mapping) -> Dict[str, torch.Tensor]:
    """``params["stage3_model"]`` of a JAX MSResAttnRefine -> its
    state_dict, without the absent ``attn_fuse_layer``."""
    return _state_dict(params, stage3_key_map(params))


def from_jax_pyramid(params: Mapping, variant: str
                     ) -> Dict[str, torch.Tensor]:
    """``params["stage3_model"]`` of a JAX V2 / V2Base / V3 -> its
    state_dict."""
    return _state_dict(params, pyramid_key_map(params, variant))


def from_jax_refine_unet(params: Mapping) -> Dict[str, torch.Tensor]:
    """``params["refine_model"]`` of a JAX RefineUnet -> its state_dict."""
    return _state_dict(params, refine_unet_key_map(params))


def from_jax_submodel(sub: torch.nn.Module, params: Mapping,
                      batch_stats: Mapping = None
                      ) -> Dict[str, torch.Tensor]:
    """The JAX tree of one submodel (its ``params``, and ``batch_stats``
    where it has BatchNorms or spectral norms) -> the state_dict of the
    port's ``sub``, by its class."""
    from deep_video_interpolation_extrapolation_tpu_torch.models import (
        attn_refine,
        detdisc,
        discriminators,
        hrnet,
        optical,
        refine,
        trackgen,
    )
    if isinstance(sub, (discriminators.Seq, detdisc._DetDisc)):
        return from_jax_disc(sub, params, batch_stats or {})
    if isinstance(sub, hrnet.VAEHRNet):
        return from_jax_vaehrnet(params, batch_stats or {})
    if isinstance(sub, hrnet.HRNet):
        return from_jax_params(params)
    if isinstance(sub, hrnet.InpaintUnet):
        return _state_dict(params, inpaint_key_map(params))
    if isinstance(sub, trackgen._TrackModel):
        return _state_dict(params, trackgen_key_map(params))
    if isinstance(sub, refine.SRNRefine):
        return from_jax_refine(params)
    if isinstance(sub, optical.RefineUnet):
        return from_jax_refine_unet(params)
    if isinstance(sub, attn_refine.MSResAttnRefine):
        return from_jax_stage3(params)
    if isinstance(sub, attn_refine.PyramidAttnRefine):
        return from_jax_pyramid(params, sub.variant)
    raise TypeError(f"no JAX weight map for {type(sub).__name__}")


def load_jax_params(model: torch.nn.Module, params: Mapping,
                    batch_stats: Mapping = None) -> List[str]:
    """Load a JAX composite's ``params`` (the per-submodel tree) and
    ``batch_stats`` into the port's composite of the same ``--model``.
    Returns the keys the JAX tree has no counterpart for, which keep their
    seeded init: only ``stage3_model.attn_fuse_layer.*`` of V1 at one
    scale."""
    left = []
    batch_stats = batch_stats or {}
    for name, sub in model.named_children():
        missing, unexpected = sub.load_state_dict(
            from_jax_submodel(sub, params[name], batch_stats.get(name)),
            strict=False)
        if unexpected or any(not k.startswith("attn_fuse_layer.")
                             for k in missing):
            raise KeyError(f"{name}: missing {missing}, unexpected "
                           f"{unexpected}")
        left += [f"{name}.{k}" for k in missing]
    return left


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


def resnet101_key_map() -> Iterator[Tuple[str, Tuple[str, ...], str]]:
    """(torch key, (collection, *flax path), leaf kind) of every leaf of
    the JAX ``ResNet101Features`` variables: the inverse of
    ``load_torch_resnet101_state`` (features.py:109-153), ``Conv_k`` and
    ``BatchNorm_k`` of the root and of each ``_RNBottleneck_i`` onto
    torchvision's names."""
    def bn(path, tname):
        for leaf, coll, port in _LEAVES["bn"]:
            yield f"{tname}.{port}", (coll,) + path + (leaf,), "bn"

    yield "conv1.weight", ("params", "Conv_0", "kernel"), "conv"
    yield from bn(("BatchNorm_0",), "bn1")
    bi = 0
    for layer, (_, blocks, _) in enumerate(RESNET101_PLAN, start=1):
        for b in range(blocks):
            path, t = (f"_RNBottleneck_{bi}",), f"layer{layer}.{b}"
            for c in range(3):
                yield (f"{t}.conv{c + 1}.weight",
                       ("params",) + path + (f"Conv_{c}", "kernel"), "conv")
                yield from bn(path + (f"BatchNorm_{c}",), f"{t}.bn{c + 1}")
            if b == 0:        # each stage's block 0 projects its input
                yield (f"{t}.downsample.0.weight",
                       ("params",) + path + ("Conv_3", "kernel"), "conv")
                yield from bn(path + ("BatchNorm_3",), f"{t}.downsample.1")
            bi += 1


def _from_trees(keys, trees: Mapping) -> Dict[str, torch.Tensor]:
    """The state_dict of (torch key, (collection, *path), kind) ``keys``
    read from ``trees`` (collection -> nested dict); kernels transformed by
    their kind."""
    sd = OrderedDict()
    for key, (coll, *path), kind in keys:
        a = trees[coll]
        for p in path:
            a = a[p]
        a = np.asarray(a, dtype=np.float32)
        if path[-1] == "kernel" and kind in KERNEL_TRANSFORM:
            a = KERNEL_TRANSFORM[kind](a)
        sd[key] = torch.from_numpy(np.array(a, order="C"))   # a writable copy
    return sd


def from_jax_resnet101(params: Mapping, batch_stats: Mapping
                       ) -> Dict[str, torch.Tensor]:
    """The JAX ``ResNet101Features``' ``params`` and ``batch_stats`` (its
    frozen variables) -> the ``state_dict`` of the port's
    ``models/features.ResNet101Features``: conv kernels HWIO -> OIHW, each
    BatchNorm's scale, bias, mean and var."""
    return _from_trees(resnet101_key_map(),
                       {"params": params, "batch_stats": batch_stats})


# ---- the video VAEs --------------------------------------------------------

def _numbered(flax_cls: str, ports, kind: str):
    return [(f"{flax_cls}_{i}", port, kind) for i, port in enumerate(ports)]


_BLOCK = [("Conv_0", "conv", "conv"), ("BatchNorm_0", "bn", "bn")]
_PAIR = ["block1", "block2"]
# (flax child, port child, kind) of every module of the VAE family, in the
# JAX modules' naming: a kind is a module of this table or a leaf kind
# ("conv", "conv3d", "convT", "dense", "bn")
VAE_TREE = {
    "VideoVAE": [
        ("seg_encoder", "seg_encoder", "SegEncoderBN"),
        ("encoder", "encoder", "FrameEncoder"),
        ("flow_encoder_bg", "flow_encoder_bg", "FlowEncoder"),
        ("flow_encoder_fg", "flow_encoder_fg", "FlowEncoder"),
        ("fc", "fc", "dense"), ("zconv", "zconv", "ConvBase"),
        ("flow_decoder", "flow_decoder", "FlowDecoder"),
        ("flownext", "flownext", "ConvHead"),
        ("flowprev", "flowprev", "ConvHead"),
        ("get_mask", "get_mask", "ConvHead"),
        ("refine_net", "refine_net", "LegacyRefineNet")],
    "SegEncoderBN": (_numbered("Conv", ["conv1", "conv2", "conv3"], "conv")
                     + _numbered("BatchNorm", ["bn1", "bn2"], "bn")),
    "FlowEncoder": (_numbered("Conv", [f"convs.{i}" for i in range(6)], "conv")
                    + _numbered("BatchNorm", [f"bns.{i}" for i in range(4)],
                                "bn")
                    + [("mu_fc", "mu_fc", "dense"),
                       ("logvar_fc", "logvar_fc", "dense")]),
    "ConvBlock": _BLOCK,
    "GateConv3d": [("Conv_0", "conv", "conv3d"), ("BatchNorm_0", "bn", "bn")],
    "ConvBase": [("Conv_0", "conv", "conv")],
    "UpConv": _numbered("ConvBlock", _PAIR, "ConvBlock"),
    "_HeadConvs": _numbered("ConvBlock", _PAIR, "ConvBlock"),
    "ConvHead": [("_HeadConvs_0", "head", "_HeadConvs"),
                 ("Conv_0", "conv", "conv")],
    "FrameEncoder": ([("ConvBase_0", "enco1.0", "ConvBase")]
                     + _numbered("ConvBlock", [
                         "enco1.1", "enco2.0", "enco2.1", "enco2.2",
                         "enco3.0", "enco3.1", "enco3.2", "codex.0",
                         "codex.1"], "ConvBlock")),
    "FlowDecoder": [("ConvBlock_0", "deco1", "ConvBlock"),
                    ("UpConv_0", "deco2", "UpConv"),
                    ("UpConv_1", "deco3", "UpConv"),
                    ("GateConv3d_0", "gate3", "GateConv3d"),
                    ("UpConv_2", "deco4", "UpConv"),
                    ("GateConv3d_1", "gate4", "GateConv3d")],
    "VGGLayer": [("Conv_0", "main.0", "conv"), ("BatchNorm_0", "main.1", "bn")],
    "LegacyEncoder": (_numbered("VGGLayer", [
        f"c{lv}.{k}" for lv, n in ((1, 2), (2, 2), (3, 3), (4, 3), (5, 3))
        for k in range(n)], "VGGLayer")
        + [("Conv_0", "c6.0", "conv"), ("BatchNorm_0", "c6.1", "bn")]),
    "LegacyDecoder": (_numbered("VGGLayer", [
        f"upc{lv}.{k}" for lv, n in ((2, 3), (3, 3), (4, 3), (5, 2))
        for k in range(n)] + ["upc6.0"], "VGGLayer")
        + _numbered("ConvTranspose", ["upc1.0", "upc6.1"], "convT")
        + [("BatchNorm_0", "upc1.1", "bn")]),
    "LegacyRefineNet": [("image_encoder", "image_encoder", "LegacyEncoder"),
                        ("image_decoder", "image_decoder", "LegacyDecoder")],
    "Flow2FrameWarped": [("image_encoder", "image_encoder", "LegacyEncoder"),
                         ("flow_encoder", "flow_encoder", "LegacyEncoder"),
                         ("image_decoder", "image_decoder", "LegacyDecoder")],
    # VAEHRNet's latent path (hrnet.py:1061-1188); HRNet's map covers the
    # rest.  A transposed conv of blocks.ConvT is its ConvTranspose_0.
    "VAEHRNet": [("vae_encoder", "vae_encoder", "VAEEncoder"),
                 ("vae_decoder", "vae_decoder", "VAEDecoder"),
                 ("mu_fc", "mu_fc", "dense"),
                 ("logvar_fc", "logvar_fc", "dense"),
                 ("mu_conv", "mu_conv", "conv"),
                 ("logvar_conv", "logvar_conv", "conv")],
    "VAEEncoder": (_numbered("Conv", [f"convs.{i}" for i in range(12)],
                             "conv")
                   + _numbered("BatchNorm", [f"bns.{i}" for i in range(10)],
                               "bn")),
    "VAEDecoder": (_numbered("ConvT", [f"ups.{i}" for i in range(4)],
                             "ConvT")
                   + _numbered("Conv", [f"convs.{i}" for i in range(4)],
                               "conv")
                   + _numbered("BatchNorm", [f"bns.{i}" for i in range(7)],
                               "bn")),
    "ConvT": [("ConvTranspose_0", "", "convT")],
}
# (flax leaf, collection, port leaf) of each leaf kind; a conv without a
# bias has no bias leaf on either side
_LEAVES = {
    "bn": [("scale", "params", "weight"), ("bias", "params", "bias"),
           ("mean", "batch_stats", "running_mean"),
           ("var", "batch_stats", "running_var")],
}
_KERNEL = [("kernel", "params", "weight"), ("bias", "params", "bias")]
# flax kernel -> torch weight
KERNEL_TRANSFORM = {
    "conv": lambda a: np.transpose(a, (3, 2, 0, 1)),        # HWIO -> OIHW
    "conv3d": lambda a: np.transpose(a, (4, 3, 0, 1, 2)),   # DHWIO -> OIDHW
    "dense": lambda a: np.transpose(a, (1, 0)),             # (in, out)
    # flax correlates unflipped; torch's transposed conv flips
    "convT": lambda a: np.transpose(a[::-1, ::-1], (2, 3, 0, 1)),
}


def vae_key_map(params: Mapping, batch_stats: Mapping, root: str = "VideoVAE"
                ) -> Iterator[Tuple[str, Tuple[str, ...], str]]:
    """(torch key, (collection, *flax path), leaf kind) for every leaf of a
    JAX ``VideoVAE`` tree (or of another module of ``VAE_TREE``, ``root``):
    ``params`` and ``batch_stats`` are the two collections of its
    variables.  A submodule absent from ``params`` (the refine net of
    ``refine=False``, the posterior encoders of a tree initialised in eval
    mode) is skipped."""
    trees = {"params": params, "batch_stats": batch_stats}

    def walk(kind, path, prefix):
        node = params
        for p in path:
            node = node[p]
        if kind in VAE_TREE:
            for flax_name, port_name, child in VAE_TREE[kind]:
                if flax_name in node:
                    yield from walk(child, path + (flax_name,),
                                    f"{prefix}{port_name}." if port_name
                                    else prefix)
            return
        for leaf, coll, port_leaf in _LEAVES.get(kind, _KERNEL):
            tree = trees[coll]
            for p in path:
                tree = tree[p]
            if leaf in tree:
                yield f"{prefix}{port_leaf}", (coll,) + path + (leaf,), kind

    yield from walk(root, (), "")


def from_jax_vae(params: Mapping, batch_stats: Mapping,
                 root: str = "VideoVAE") -> Dict[str, torch.Tensor]:
    """A JAX ``VideoVAE``'s ``params`` and ``batch_stats`` -> the
    ``state_dict`` of the port's ``models/vae_video.VideoVAE`` (or of the
    port's module ``root`` of ``models/subnets``)."""
    return _from_trees(vae_key_map(params, batch_stats, root),
                       {"params": params, "batch_stats": batch_stats})


def from_jax_vaehrnet(params: Mapping, batch_stats: Mapping
                      ) -> Dict[str, torch.Tensor]:
    """A JAX ``VAEHRNet``'s ``params`` and ``batch_stats`` -> the port's
    ``models/hrnet.VAEHRNet`` state_dict: HRNet's map, then the VAE encoder
    and decoder (kernels, BatchNorm scale, bias, mean and var) and the
    latent heads (a Dense kernel (in, out) -> the weight (out, in), or the
    1x1 conv heads)."""
    sd = from_jax_params(params)
    sd.update(from_jax_vae(params, batch_stats, root="VAEHRNet"))
    return sd


# ---- the discriminators -----------------------------------------------------

def disc_key_map(disc: torch.nn.Module
                 ) -> Iterator[Tuple[str, Tuple[str, ...], str]]:
    """(torch key, (collection, *flax path), leaf kind) of every leaf of a
    port discriminator (``models/discriminators``, ``models/detdisc``),
    walking its containers' flax names (and VecSN's ``Dense_k`` and
    ``BatchNorm_k``).  A spectral norm's ``u`` and ``sigma`` sit in
    ``batch_stats`` under ``SpectralNorm_0`` as ``Conv_0/kernel/u`` and
    ``Conv_0/kernel/sigma``."""
    from deep_video_interpolation_extrapolation_tpu_torch.models import (
        detdisc,
        discriminators as dd,
    )

    def conv(path, prefix, kind="conv"):
        yield f"{prefix}weight", ("params",) + path + ("kernel",), kind
        yield f"{prefix}bias", ("params",) + path + ("bias",), "bias"

    def sn(path, prefix):
        yield from conv(path + ("Conv_0",), prefix)
        for leaf in ("u", "sigma"):
            yield (f"{prefix}{leaf}", ("batch_stats",) + path + (
                "SpectralNorm_0", f"Conv_0/kernel/{leaf}"), leaf)

    def out_conv(sn_conv, path, prefix):
        if sn_conv:
            yield from sn(path + ("_SNConv_0",), prefix)
        else:
            yield from conv(path + ("Conv_0",), prefix)

    def block(b, path, prefix):
        yield from out_conv(b.sn, path, f"{prefix}conv.")
        if b.bn is not None:
            for leaf, coll, port in _LEAVES["bn"]:
                yield (f"{prefix}bn.{port}",
                       (coll,) + path + ("BatchNorm_0", leaf), "bn")

    def seq(m, path, prefix):
        for i, (name, layer) in enumerate(zip(m.names, m.layers)):
            walk = block if isinstance(layer, dd.Block) else seq
            yield from walk(layer, path + (name,), f"{prefix}layers.{i}.")
        if isinstance(m, (dd.FrameLocalDiscriminator,
                          dd.VideoLocalDiscriminator)):
            yield from out_conv(m.sn, path, f"{prefix}out.")

    if isinstance(disc, detdisc._DetDisc):
        yield from seq(disc.tower, (disc.tower_name,) if disc.tower_name
                       else (), "tower.")
        # VecSN's head: Dense_k and BatchNorm_k beside its blocks
        for i, _ in enumerate(getattr(disc, "fc", ())):
            yield from conv((f"Dense_{i}",), f"fc.{i}.", "dense")
        for i, _ in enumerate(getattr(disc, "fc_bn", ())):
            for leaf, coll, port in _LEAVES["bn"]:
                yield (f"fc_bn.{i}.{port}", (coll, f"BatchNorm_{i}", leaf),
                       "bn")
    else:
        yield from seq(disc, (), "")


# ---- the legacy models -------------------------------------------------------

# flax leaf -> (port leaf, kind); kernels transform by their rank
_FLAX_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight",
                "mean": "running_mean", "var": "running_var"}
# the port's SegEncoder is a Sequential: flax Conv_k is its child 2k
_SEG_ENCODER = re.compile(r"(^|\.)seg_encoder\.Conv_(\d)\.")
# a ResnetBlock's Conv_k is its Sequential's child conv.2k; a ConvT's
# ConvTranspose_0 is the port ConvT itself
_RESNET_BLOCK = re.compile(r"(^|\.)(ResnetBlock_\d+)\.Conv_(\d)\.")
_CONVT = re.compile(r"(^|\.)(ConvT_\d+)\.ConvTranspose_0\.")


def flax_key_map(params: Mapping, batch_stats: Mapping = None
                 ) -> Iterator[Tuple[str, Tuple[str, ...], str]]:
    """(torch key, (collection, *flax path), leaf kind) of every leaf of a
    JAX legacy model (``models/unet``, ``legacy_gen``, ``gridnet``,
    ``legacy_disc``, the ``GAN`` head and ``srn_legacy``), whose port
    modules carry the flax module names: the path joined by dots,
    ``kernel`` / ``scale`` -> ``weight`` (a 4-D kernel HWIO -> OIHW, a
    ConvTranspose's flipped back, a 2-D one transposed), BatchNorm
    ``mean`` / ``var`` -> ``running_mean`` / ``running_var``, PReLU slopes
    (``a0``, ``a1``) as they are; a ``seg_encoder``'s ``Conv_k`` is the
    port Sequential's child 2k, a ``ResnetBlock_j``'s ``Conv_k`` its
    ``conv.2k``, a ``ConvT_j``'s ``ConvTranspose_0`` the ``ConvT_j``
    itself."""
    def walk(tree, coll, path):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                yield from walk(v, coll, path + (k,))
                continue
            key = ".".join(path + (_FLAX_LEAVES.get(k, k),))
            key = _SEG_ENCODER.sub(
                lambda m: f"{m[1]}seg_encoder.{2 * int(m[2])}.", key)
            key = _RESNET_BLOCK.sub(
                lambda m: f"{m[1]}{m[2]}.conv.{2 * int(m[3])}.", key)
            key = _CONVT.sub(lambda m: f"{m[1]}{m[2]}.", key)
            kind = ("convT" if "ConvTranspose_0" in path else
                    {4: "conv", 2: "dense"}.get(np.ndim(v), "leaf"))
            yield key, (coll,) + path + (k,), kind

    yield from walk(params, "params", ())
    yield from walk(batch_stats or {}, "batch_stats", ())


def from_jax_legacy(params: Mapping, batch_stats: Mapping = None
                    ) -> Dict[str, torch.Tensor]:
    """A JAX legacy model's ``params`` and ``batch_stats`` -> the port
    model's ``state_dict`` (``flax_key_map``)."""
    return _from_trees(flax_key_map(params, batch_stats),
                       {"params": params, "batch_stats": batch_stats or {}})


def attn_legacy_key_map(variant: str
                        ) -> Iterator[Tuple[str, Tuple[str, ...], str]]:
    """(torch key, (collection, *flax path), leaf kind) of every leaf of a
    JAX ``models/attn_legacy`` model (``variant`` v2, v2o, v2base, v3,
    v3base, v4 or v4base) in the reference's naming: the inverse of
    port_attn_legacy (torch_port.py:590-700), V2's ResNet101 under
    ``resnet101.resnet101.`` by ``resnet101_key_map``."""
    def conv(path, tname, kind="conv"):
        yield f"{tname}.weight", ("params",) + path + ("kernel",), kind
        yield f"{tname}.bias", ("params",) + path + ("bias",), kind

    def res(path, tname):
        yield from conv(path + ("Conv_0",), f"{tname}.conv.0")
        yield from conv(path + ("Conv_1",), f"{tname}.conv.2")

    def enc_head(name, blocks=3):
        yield from conv((name, "Conv_0"), f"{name}.0")
        for k in range(blocks):
            yield from res((name, f"ResnetBlock_{k}"), f"{name}.{2 + k}")

    def enc_l3(name):
        yield from conv((name, "Conv_0"), f"{name}.conv.0")
        for k in range(3):
            yield from res((name, f"ResnetBlock_{k}"), f"{name}.conv.{2 + k}")

    def dec(name, last):
        for k in range(3):
            yield from res((name, f"ResnetBlock_{k}"), f"{name}.conv.{k}")
        yield from last

    def dec_l5(name):
        yield from dec(name, conv((name, "ConvT_0", "ConvTranspose_0"),
                                  f"{name}.conv.3", "convT"))

    def mid(rb_at):
        yield from conv(("mid", "Conv_0"), "mid.0")
        if rb_at == 4:
            yield from conv(("mid", "Conv_1"), "mid.2")
        for k in range(2):
            yield from res(("mid", f"ResnetBlock_{k}"), f"mid.{rb_at + k}")

    if variant in ("v2", "v2o", "v2base"):
        yield from enc_head("encoder_1")
        for i in (2, 3, 4):
            yield from enc_l3(f"encoder_{i}")
        yield from mid(2)
        decs = (4, 3, 2)
        if variant == "v2":
            for key, (coll, *path), kind in resnet101_key_map():
                yield (f"resnet101.resnet101.{key}",
                       (coll, "resnet101", *path), kind)
    elif variant in ("v3", "v3base", "v4", "v4base"):
        yield from enc_head("img_encoder_1")
        yield from enc_l3("img_encoder_2")
        yield from enc_l3("img_encoder_3")
        if variant in ("v3", "v4"):
            yield from enc_head("attn_encoder_1",
                                blocks=1 if variant == "v4" else 3)
            yield from enc_l3("attn_encoder_2")
            yield from enc_l3("attn_encoder_3")
        yield from mid(4)
        decs = (3, 2)
    else:
        raise KeyError(variant)
    for i in decs:
        yield from dec_l5(f"decoder_{i}")
    yield from dec("decoder_1", conv(("decoder_1", "Conv_0"),
                                     "decoder_1.conv.3"))


def optical_key_map(params: Mapping
                    ) -> Iterator[Tuple[str, Tuple[str, ...], str]]:
    """(torch key, (collection, *flax path), leaf kind) of every leaf of a
    JAX ``OpticalUnet`` (its ``unet``) or ``OpticalRefineNet`` (its
    ``coarse_model`` and ``refine_model``): ``refine_unet_key_map`` under
    each."""
    if "unet" not in params:
        for name in ("coarse_model", "refine_model"):
            for key, path, kind in optical_key_map(params[name]):
                yield f"{name}.{key}", (path[0], name, *path[1:]), kind
        return
    for key, path in refine_unet_key_map(params):
        yield key, ("params",) + path, (
            "convT" if "ConvTranspose_0" in path else "conv")


def legacy_state_dict(model: torch.nn.Module, params: Mapping,
                      batch_stats: Mapping = None
                      ) -> Dict[str, torch.Tensor]:
    """A JAX legacy model's trees (``params``, or a gradient of the same
    structure; ``batch_stats``) -> the port ``model``'s keys: a generator,
    GridNet, a discriminator, ``GAN`` or an ``srn_legacy`` model by
    ``flax_key_map``; an ``attn_legacy`` model by ``attn_legacy_key_map``;
    ``OpticalUnet`` and ``OpticalRefineNet`` by ``optical_key_map``;
    ``RefineNet`` and ``RefineGAN`` by submodel (an HRNet coarse and the
    refiner by their own maps)."""
    from deep_video_interpolation_extrapolation_tpu_torch.models import (
        attn_legacy,
        hrnet,
        legacy_heads,
        optical,
    )
    batch_stats = batch_stats or {}
    trees = {"params": params, "batch_stats": batch_stats}
    if isinstance(model, (attn_legacy.AttnV2Core, attn_legacy.AttnV3Core)):
        return _from_trees(attn_legacy_key_map(model.variant), trees)
    if isinstance(model, (optical.OpticalUnet, optical.OpticalRefineNet)):
        return _from_trees(optical_key_map(params), trees)
    if not isinstance(model, (legacy_heads.RefineNet,
                              legacy_heads.RefineGAN)):
        return from_jax_legacy(params, batch_stats)
    sd = OrderedDict()
    for name, sub in model.named_children():
        if name not in params:
            continue
        if isinstance(sub, hrnet.HRNet) or name == "refine_model":
            part = from_jax_submodel(sub, params[name], batch_stats.get(name))
        else:
            part = from_jax_legacy(params[name], batch_stats.get(name))
        sd.update((f"{name}.{k}", v) for k, v in part.items())
    return sd


def load_jax_legacy(model: torch.nn.Module, params: Mapping,
                    batch_stats: Mapping = None) -> None:
    """Load a JAX legacy model's variables into the port's ``model``,
    strictly (``legacy_state_dict``)."""
    model.load_state_dict(legacy_state_dict(model, params, batch_stats),
                          strict=True)


def from_jax_disc(disc: torch.nn.Module, params: Mapping,
                  batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX discriminator's ``params`` and ``batch_stats`` -> the
    state_dict of the port's ``disc`` (kernels HWIO -> OIHW)."""
    return _from_trees(disc_key_map(disc),
                       {"params": params, "batch_stats": batch_stats})
