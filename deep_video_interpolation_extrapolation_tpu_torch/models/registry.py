"""Model registry (counterpart of models/registry.py) for the ported slices:
``--model InterNet``, ``InterRefineNet`` and ``InterStage3Net`` with
``--coarse_model HRNet`` in interpolation mode; ``ExtraNet`` and
``ExtraInpaintNet`` (``--inpaint_model InpaintUnet``) with HRNet in
extrapolation mode (``--syn_type extra``); ``InterGANNet`` with
``--coarse_model VAEHRNet``, ``--track_gen`` (``TrackGen``, ``TrackGenV2``)
and every discriminator of ``models/discriminators`` and
``models/detdisc``; the plain VAE (``VAEHRNet`` under ``InterNet`` or
``ExtraNet``, or under a refine composite, whose train step refuses it as
the JAX one does); every ``--refine_model``
(``SRNRefine`` at any ``--n_sc``, ``refineUnet``) and ``--stage3_model``
(``MSResAttnRefine`` at any ``--n_sc`` and ``--stage3_prop``, ``V2``,
``V2Base``, ``V3``) the JAX registry takes; and the video VAEs ``--model
VAE``, ``VAE_S`` and ``VAE_SD`` (``--vid_len``), built for frames of
``(input_h, input_w)``; and the legacy models of ``train/legacy.py``: the
coarse generators ``MyFRRN``, ``PSPNet``, ``PSPNetV2``, ``B2SNet``,
``UNet`` and ``SepUNet`` (as ``--model`` and as ``--coarse_model``),
``GridNet`` and the heads ``GAN``, ``RefineNet`` and ``RefineGAN``.  An
unknown name raises ``KeyError``, as in the JAX registry."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config

def compute_dtype(cfg: Config) -> torch.dtype:
    return {"bfloat16": torch.bfloat16,
            "float32": torch.float32}[cfg.compute_dtype]


def legacy_generators(cfg: Config) -> dict:
    """Name -> constructor of the legacy coarse generators (registry.py:40-51),
    in the compute dtype."""
    from deep_video_interpolation_extrapolation_tpu_torch.models import (
        legacy_gen,
        unet,
    )
    d = compute_dtype(cfg)
    return {"MyFRRN": lambda: legacy_gen.MyFRRN(mode=cfg.mode, dtype=d),
            "PSPNet": lambda: legacy_gen.PSPNet(mode=cfg.mode, dtype=d),
            "PSPNetV2": lambda: legacy_gen.PSPNetV2(mode=cfg.mode, dtype=d),
            "B2SNet": lambda: legacy_gen.B2SNet(dtype=d),
            "UNet": lambda: unet.UNet(dtype=d),
            "SepUNet": lambda: unet.SepUNet(dtype=d)}


def build_coarse(cfg: Config, use_kernels: bool = True) -> nn.Module:
    """``HRNet`` or ``VAEHRNet`` (with its latent heads for the (input_h,
    input_w) it trains at), in extrapolation mode under ``--syn_type
    extra``: the head widths by ``--num_pred_once`` and ``--inpaint_mask``,
    conv1 (and VAEHRNet's posterior encoder) taking three frames under
    ``--fix_init_frames``; or one of the legacy generators."""
    from deep_video_interpolation_extrapolation_tpu_torch.models.hrnet import (
        HRNet,
        VAEHRNet,
    )
    if cfg.coarse_model not in ("HRNet", "VAEHRNet"):
        return legacy_generators(cfg)[cfg.coarse_model]()
    # --remat checkpoints the backbone at stage granularity inside the
    # model (hrnet.HRNet._backbone); remat_internal is the runner side
    kw = dict(dtype=compute_dtype(cfg), use_kernels=use_kernels,
              highres_large=cfg.highres_large, remat=cfg.remat)
    if cfg.syn_type == "extra":
        n_frames = 3 if cfg.fix_init_frames else 2
        kw.update(syn_type="extra", num_pred_once=cfg.num_pred_once,
                  inpaint_mask=cfg.inpaint_mask)
        if cfg.coarse_model == "VAEHRNet":
            kw.update(n_frames=n_frames)
        else:
            kw.update(inpaint=cfg.inpaint, in_ch=(3 + 4) * n_frames)
    if cfg.coarse_model == "VAEHRNet":
        return VAEHRNet(size=(cfg.input_h, cfg.input_w), **kw)
    return HRNet(**kw)


def remat_internal(cfg: Config) -> bool:
    """``registry.remat_internal`` (:54-69): True when the built model
    checkpoints itself at stage granularity under ``--remat`` (an HRNet or
    VAEHRNet coarse under InterNet or ExtraNet, no inpainting), so the
    train step must not wrap its forward in a whole-forward checkpoint on
    top (it would recompute the forward a third time for no memory); every
    other model (the refine and stage-3 composites, InpaintUnet) keeps the
    step's outer checkpoint."""
    return (bool(cfg.remat)
            and cfg.coarse_model in ("HRNet", "VAEHRNet")
            and cfg.model in ("InterNet", "ExtraNet")
            and not getattr(cfg, "inpaint", False))


def build_disc(cfg: Config, name: str) -> nn.Module:
    """A discriminator by its reference name (registry.py:125-140 of the
    JAX package), in the compute dtype, ``--seg_disc`` applied."""
    from deep_video_interpolation_extrapolation_tpu_torch.models import (
        detdisc,
        discriminators,
    )
    d = compute_dtype(cfg)
    if name in discriminators.FACTORIES:
        return discriminators.FACTORIES[name](cfg.seg_disc, d)
    if name in detdisc.CLASSES:
        return detdisc.CLASSES[name](seg_disc=cfg.seg_disc, dtype=d)
    raise KeyError(name)


def build_track_gen(cfg: Config) -> nn.Module:
    """``TrackGen`` or ``TrackGenV2`` (``--track_gen_model``) for
    ``--n_track`` tracks, in the compute dtype (registry.py:117-122)."""
    from deep_video_interpolation_extrapolation_tpu_torch.models import (
        trackgen,
    )
    return trackgen.build(cfg.track_gen_model, cfg.num_track_per_img,
                          compute_dtype(cfg))


def build_refine(cfg: Config) -> nn.Module:
    """``SRNRefine`` at ``--n_sc``; any other name is ``RefineUnet``, as the
    JAX registry maps it (registry.py:25-33: the CLI offers ``refineUnet``,
    the Config's default)."""
    from deep_video_interpolation_extrapolation_tpu_torch.models.optical import (
        RefineUnet,
    )
    from deep_video_interpolation_extrapolation_tpu_torch.models.refine import (
        SRNRefine,
    )
    if cfg.refine_model == "SRNRefine":
        return SRNRefine(n_scales=cfg.n_scales, dtype=compute_dtype(cfg))
    return RefineUnet(dtype=compute_dtype(cfg))


def build_stage3(cfg: Config, use_kernels: bool = True) -> nn.Module:
    from deep_video_interpolation_extrapolation_tpu_torch.models import (
        attn_refine as ar,
    )
    d = compute_dtype(cfg)
    if cfg.stage3_model == "MSResAttnRefine":
        return ar.MSResAttnRefine(n_scales=cfg.n_scales,
                                  stage3_prop=cfg.stage3_prop, dtype=d,
                                  use_kernels=use_kernels)
    variant = {"MSResAttnRefineV2": "v2", "MSResAttnRefineV2Base": "v2base",
               "MSResAttnRefineV3": "v3"}[cfg.stage3_model]
    return ar.PyramidAttnRefine(variant, cfg.stage3_prop, dtype=d)


def build_inpaint(cfg: Config) -> nn.Module:
    """``InpaintUnet`` for ``--num_pred_once`` frames (registry.py:110-113;
    the only ``--inpaint_model``)."""
    from deep_video_interpolation_extrapolation_tpu_torch.models.hrnet import (
        InpaintUnet,
    )
    assert cfg.inpaint_model == "InpaintUnet", cfg.inpaint_model
    return InpaintUnet(num_pred_once=cfg.num_pred_once,
                       dtype=compute_dtype(cfg))


def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter from ``numpy.random.RandomState(seed)``: conv
    weights lecun-normal (std 1/sqrt(fan_in), the JAX ``Conv`` and
    ``ConvTranspose`` inits' scale), biases zero.  Deterministic across
    devices and torch builds."""
    from deep_video_interpolation_extrapolation_tpu_torch.models.blocks import (
        ConvT,
    )
    from deep_video_interpolation_extrapolation_tpu_torch.models.subnets import (
        BatchNorm,
        ConvTranspose,
    )
    from deep_video_interpolation_extrapolation_tpu_torch.models.discriminators import (
        SNConv,
    )
    from deep_video_interpolation_extrapolation_tpu_torch.models.gridnet import (
        PReLUPair,
    )
    # a transposed conv's weight is (Cin, Cout, kh, kw); a BatchNorm scale
    # starts at one (flax's init), a PReLU slope at 0.25
    convt = {id(m.weight) for m in model.modules()
             if isinstance(m, (ConvT, ConvTranspose))}
    scales = {id(m.weight) for m in model.modules()
              if isinstance(m, BatchNorm)}
    slopes = {id(a) for m in model.modules() if isinstance(m, PReLUPair)
              for a in (m.a0, m.a1)}
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            if name.endswith("bias"):
                p.zero_()
            elif id(p) in scales:
                p.fill_(1.0)
            elif id(p) in slopes:
                p.fill_(0.25)
            else:
                fan_in = int(np.prod(p.shape[1:]))
                if id(p) in convt:
                    fan_in = p.shape[0] * p.shape[2] * p.shape[3]
                p.copy_(torch.from_numpy(rng.normal(
                    0.0, 1.0 / np.sqrt(fan_in), p.shape).astype(np.float32)))
        # the spectral norms' power-iteration vectors, N(0, 1) as flax's,
        # after every parameter (the other models' draws are unchanged)
        for name, m in sorted(model.named_modules(), key=lambda t: t[0]):
            if isinstance(m, SNConv):
                m.u.copy_(torch.from_numpy(rng.normal(
                    0.0, 1.0, tuple(m.u.shape)).astype(np.float32)))
    return model


def build_model(cfg: Config, device="cuda", seed: int = 0,
                use_kernels: bool = True) -> nn.Module:
    """Build the model named by ``cfg.model``, weights from ``seed``, in
    eval mode on ``device`` (the card unless the caller asks for the CPU;
    without a card it raises).  An unknown name raises ``KeyError``.
    Under spatial sharding (``--num_spatial_shards`` > 1) the model runs
    on the plain versions of the kernels, as the JAX registry turns every
    Pallas path off under a spatial mesh (registry.py:29-32,
    ``spatial_sharded``): the kernels take whole maps, not halo-padded
    bands (ROADMAP.md queue 2)."""
    from deep_video_interpolation_extrapolation_tpu_torch.models import (
        composite,
        gridnet,
        legacy_heads,
        vae_video,
    )
    d = compute_dtype(cfg)
    use_kernels = use_kernels and cfg.num_spatial_shards <= 1
    heads = {"InterNet": composite.InterNet,
             "InterRefineNet": composite.InterRefineNet,
             "InterStage3Net": composite.InterStage3Net,
             "InterGANNet": composite.InterGANNet,
             "ExtraNet": composite.ExtraNet,
             "ExtraInpaintNet": composite.ExtraInpaintNet,
             "RefineNet": legacy_heads.RefineNet,
             "RefineGAN": legacy_heads.RefineGAN}
    vaes = {"VAE": "vae", "VAE_S": "vae_s", "VAE_SD": "vae_sd"}
    legacy = {**legacy_generators(cfg),
              "GridNet": lambda: gridnet.GridNet(mode=cfg.mode, dtype=d),
              "GAN": lambda: legacy_heads.GAN(mode=cfg.mode, dtype=d)}
    if cfg.model not in heads and cfg.model not in vaes and \
            cfg.model not in legacy:
        raise KeyError(cfg.model)
    device = hw.entry_device(device)
    if cfg.model in vaes:
        model = vae_video.VideoVAE(
            vid_length=cfg.vid_length, variant=vaes[cfg.model], dtype=d,
            size=(cfg.input_h, cfg.input_w), use_kernels=use_kernels)
    elif cfg.model in legacy:
        model = legacy[cfg.model]()
    else:
        model = heads[cfg.model](cfg, use_kernels=use_kernels)
    init_weights(model, seed)
    return model.to(device).eval()
