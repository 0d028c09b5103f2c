"""Legacy sub-networks of the flow-based video VAE (counterpart of the JAX
package's ``models/subnets.py``: reference nets/SubNets.py and the
encoder, decoder, RefineNet and Flow2Frame_warped of nets/vgg.py).

NHWC throughout; the 3-D gated convs keep time as a real depth axis
(B, T, H, W, C), as the reference's ``nn.Conv3d`` does.  Every module takes
``train``, which picks batch statistics (and updates the running ones) or
the running statistics in its BatchNorms, as the JAX modules' ``train``
does; and ``dtype``, the compute dtype of its convs and BatchNorm outputs
(None: f32 BatchNorm outputs and each conv in its input's dtype, the flax
rules).  Submodules are named after the reference's attributes where the
JAX docstrings cite them (``c1``-``c6``, ``upc1``-``upc6`` and
``vgg_layer.main`` of nets/vgg.py); ``tools/jax_weights.vae_key_map`` maps
them to the flax tree's auto-names.  Shapes that the JAX modules take from
their input at init (the FlowEncoder's flatten, the LegacyEncoder's last
kernel) are fixed here by ``size``, the (H, W) of the frames.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from deep_video_interpolation_extrapolation_tpu_torch.models.blocks import (
    Conv,
    lrelu,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.resize import (
    interpolate_bilinear,
    max_pool,
    nchw,
    nhwc,
)
from deep_video_interpolation_extrapolation_tpu_torch.parallel import dist

Size = Tuple[int, int]


# ---- flax primitives ------------------------------------------------------

class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the last axis:
    torch's momentum 0.1.  Computes in f32; ``train`` normalizes by the
    batch's biased statistics (E[x^2] - E[x]^2, clipped at 0, as flax) and
    moves the running ones towards them; else by the running ones.  Returns
    ``dtype``, f32 when None (the flax promotion with its f32 params).
    Under a step on a shard of the batch (``parallel/dist.sharded``) the
    statistics are the global batch's, as JAX's of a sharded batch."""

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        xf = x.float()
        if train:
            mean, var = dist.batch_moments(xf, tuple(range(x.dim() - 1)))
            with torch.no_grad():
                self.running_mean.lerp_(mean.detach(), self.momentum)
                self.running_var.lerp_(var.detach(), self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(dtype or torch.float32)


class Dense(nn.Module):
    """flax ``nn.Dense``; weight (out, in) as torch's ``nn.Linear``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dt = dtype or torch.promote_types(x.dtype, torch.float32)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` at stride 1, as ``F.conv_transpose2d``.
    Flax correlates the zero-padded input with its kernel unflipped; torch's
    transposed conv flips, so the weight (Cin, Cout, kh, kw) holds the flax
    kernel (kh, kw, Cin, Cout) flipped in both spatial axes.  ``VALID`` is a
    full transposed conv (out = in + k - 1, torch padding 0); ``SAME`` (odd
    k) keeps the size (torch padding (k - 1) / 2)."""

    def __init__(self, cin: int, cout: int, kernel: int, padding: str):
        super().__init__()
        if padding not in ("VALID", "SAME") or (padding == "SAME"
                                                 and kernel % 2 == 0):
            raise ValueError(f"padding {padding!r} with kernel {kernel}")
        self.padding = 0 if padding == "VALID" else (kernel - 1) // 2
        self.weight = nn.Parameter(torch.zeros(cin, cout, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dt = dtype or x.dtype
        out = nhwc(F.conv_transpose2d(nchw(x.to(dt)), self.weight.to(dt),
                                      padding=self.padding))
        return out + self.bias.to(dt)


class Conv3d(nn.Module):
    """flax ``nn.Conv(kernel_size=(3, 3, 3), padding="SAME")`` over
    (B, T, H, W, C), as ``F.conv3d`` on the NCDHW view; weight (O, I, 3, 3,
    3) from the flax (kd, kh, kw, I, O)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, 3, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dt = dtype or x.dtype
        out = F.conv3d(x.to(dt).permute(0, 4, 1, 2, 3), self.weight.to(dt),
                       padding=1)
        return out.permute(0, 2, 3, 4, 1).contiguous() + self.bias.to(dt)


def conv_out(n: int, kernel: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - kernel) // stride + 1


# ---- nets/SubNets.py ------------------------------------------------------

class SegEncoderBN(nn.Module):
    """BatchNorm variant of the seg encoder (nets/SubNets.py:14-30):
    20-class one-hot -> ``out_dim`` channels."""

    def __init__(self, out_dim: int = 4, cin: int = 20,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv1, self.bn1 = Conv(cin, 32, 3), BatchNorm(32)
        self.conv2, self.bn2 = Conv(32, 32, 3), BatchNorm(32)
        self.conv3 = Conv(32, out_dim, 3)

    def forward(self, seg: torch.Tensor, train: bool = True) -> torch.Tensor:
        dt = self.dtype
        x = lrelu(self.bn1(self.conv1(seg, dt), train, dt))
        x = lrelu(self.bn2(self.conv2(x, dt), train, dt))
        return self.conv3(x, dt)


class FlowEncoder(nn.Module):
    """VAE posterior encoder -> (mu, logvar) (nets/SubNets.py:38-67).  The
    flatten is in NHWC order, as the JAX module's; its length follows
    ``size`` (3072 at the reference's 128x128)."""

    def __init__(self, cin: int, latent_dim: int = 512, size: Size = (128, 128),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        # (cout, kernel, stride, padding) of the six convs, no biases
        spec = [(64, 5, 2, 2), (64, 5, 2, 2), (64, 3, 1, 1), (128, 5, 2, 1),
                (128, 3, 1, 1), (48, 5, 2, 2)]
        convs, c, (h, w) = [], cin, size
        for cout, k, s, p in spec:
            convs.append(Conv(c, cout, k, s, padding=p, bias=False))
            c, h, w = cout, conv_out(h, k, s, p), conv_out(w, k, s, p)
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(BatchNorm(n) for n, *_ in spec[1:5])
        self.mu_fc = Dense(48 * h * w, latent_dim)
        self.logvar_fc = Dense(48 * h * w, latent_dim)

    def forward(self, x: torch.Tensor, train: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = self.dtype
        h = lrelu(self.convs[0](x, dt))
        for conv, bn in zip(self.convs[1:5], self.bns):
            h = lrelu(bn(conv(h, dt), train, dt))
        flat = self.convs[5](h, dt).reshape(x.shape[0], -1)
        return self.mu_fc(flat, dt), self.logvar_fc(flat, dt)


class GateConv3d(nn.Module):
    """3-D conv + BN + lrelu over (B, T, H, W, C) (nets/SubNets.py:76-84)."""

    def __init__(self, cin: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv, self.bn = Conv3d(cin, features), BatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return lrelu(self.bn(self.conv(x, self.dtype), train, self.dtype))


class ConvBlock(nn.Module):
    """conv (no bias) + BN + lrelu (nets/SubNets.py:89-99)."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv(cin, features, kernel, stride, bias=False)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return lrelu(self.bn(self.conv(x, self.dtype), train, self.dtype))


class ConvBase(nn.Module):
    """conv + lrelu (nets/SubNets.py:105-113)."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv(cin, features, kernel, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lrelu(self.conv(x, self.dtype))


class UpConv(nn.Module):
    """2 x (conv + BN + lrelu), then a 2x bilinear upsample
    (nets/SubNets.py:116-135)."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.block1 = ConvBlock(cin, features * 2, kernel, dtype=dtype)
        self.block2 = ConvBlock(features * 2, features, kernel, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        h = self.block2(self.block1(x, train), train)
        return interpolate_bilinear(h, scale_factor=2.0)


class FrameEncoder(nn.Module):
    """frame + seg -> (enco1, enco2, enco3, codex), at 1, 1/2, 1/4 and 1/8
    of the input size (nets/SubNets.py:143-183)."""

    def __init__(self, cin: int = 7, dtype: Optional[torch.dtype] = None):
        super().__init__()

        def blk(ci, co, k=3, s=1):
            return ConvBlock(ci, co, k, s, dtype=dtype)
        self.enco1 = nn.ModuleList([ConvBase(cin, 32, dtype=dtype),
                                    blk(32, 32)])
        self.enco2 = nn.ModuleList([blk(32, 64, 5, 2), blk(64, 64),
                                    blk(64, 64)])
        self.enco3 = nn.ModuleList([blk(64, 128, 5, 2), blk(128, 128),
                                    blk(128, 128)])
        self.codex = nn.ModuleList([blk(128, 256, 5, 2), blk(256, 256)])

    def forward(self, x: torch.Tensor, train: bool = True
                ) -> Tuple[torch.Tensor, ...]:
        e1 = self.enco1[1](self.enco1[0](x), train)
        outs = [e1]
        for level in (self.enco2, self.enco3, self.codex):
            h = outs[-1]
            for blk in level:
                h = blk(h, train)
            outs.append(h)
        return tuple(outs)


class FlowDecoder(nn.Module):
    """Skip-connected flow decoder over T steps (nets/SubNets.py:186-228):
    z (B, T, h, w, 272) -> (B, T, 8h, 8w, 64), the single-frame skips
    broadcast over T."""

    def __init__(self, vid_length: int, cin: int = 272,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.vid_length = vid_length
        self.deco1 = ConvBlock(cin, 256, dtype=dtype)
        self.deco2 = UpConv(256, 128, dtype=dtype)
        self.deco3 = UpConv(128 + 128, 64, dtype=dtype)
        self.gate3 = GateConv3d(64, 64, dtype=dtype)
        self.deco4 = UpConv(64 + 64, 32, dtype=dtype)
        self.gate4 = GateConv3d(32, 32, dtype=dtype)

    def forward(self, enco1, enco2, enco3, z, train: bool = True
                ) -> torch.Tensor:
        b, t = z.shape[:2]

        def fold(v):
            return v.reshape((b * t,) + v.shape[2:])

        def unfold(v):
            return v.reshape((b, t) + v.shape[1:])

        def skip(v):
            return v[:, None].expand((b, t) + v.shape[1:])

        d1 = unfold(self.deco1(fold(z), train))
        d2 = unfold(self.deco2(fold(d1), train))
        d2 = torch.cat([d2, skip(enco3)], dim=-1)
        d3 = self.gate3(unfold(self.deco3(fold(d2), train)), train)
        d3 = torch.cat([d3, skip(enco2)], dim=-1)
        d4 = self.gate4(unfold(self.deco4(fold(d3), train)), train)
        return torch.cat([d4, skip(enco1)], dim=-1)


class _HeadConvs(nn.Module):
    """The upconv-style conv pair of the mini-heads, without its 2x
    upsample (the JAX module's documented deviation from
    nets/SubNets.py:232)."""

    def __init__(self, cin: int = 64, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.block1 = ConvBlock(cin, 32, 5, dtype=dtype)
        self.block2 = ConvBlock(32, 16, 5, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return self.block2(self.block1(x, train), train)


class _ConvHead(nn.Module):
    """``_HeadConvs`` then a 5x5 conv to ``cout`` channels, optionally
    through a sigmoid."""
    cout = 2
    sigmoid = False

    def __init__(self, cin: int = 64, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.head = _HeadConvs(cin, dtype)
        self.conv = Conv(16, self.cout, 5)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        out = self.conv(self.head(x, train), self.dtype)
        return torch.sigmoid(out) if self.sigmoid else out


class GetFlow(_ConvHead):
    """conv head -> 2-ch flow (nets/SubNets.py:232-241)."""


class GetOcclusionMask(_ConvHead):
    """conv head + sigmoid -> 2-ch mask (nets/SubNets.py:247-256)."""
    sigmoid = True


class GetFrames(_ConvHead):
    """conv head + sigmoid -> rgb (nets/SubNets.py:262-272)."""
    cout = 3
    sigmoid = True


# ---- nets/vgg.py ----------------------------------------------------------

class VGGLayer(nn.Module):
    """conv + BN + lrelu (nets/vgg.py:58-67, ``vgg_layer.main``)."""

    def __init__(self, cin: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.main = nn.ModuleList([Conv(cin, features, 3),
                                   BatchNorm(features)])

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return lrelu(self.main[1](self.main[0](x, self.dtype), train,
                                  self.dtype))


def _vgg_stack(widths: Sequence[Tuple[int, int]], dtype) -> nn.ModuleList:
    return nn.ModuleList(VGGLayer(ci, co, dtype) for ci, co in widths)


class LegacyEncoder(nn.Module):
    """VGG encoder to a 1x1 code + skips (nets/vgg.py:69-113): c1-c5 are
    VGG layers between 2x2 max pools, c6 a VALID conv whose kernel is the
    spatial extent left after the fifth pool (``size`` / 32: 4x4 at
    128x128, 1x1 at 32x32), BN and tanh."""

    def __init__(self, cin: int, dim: int = 1024, size: Size = (128, 128),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.c1 = _vgg_stack([(cin, 64), (64, 64)], dtype)
        self.c2 = _vgg_stack([(64, 128), (128, 128)], dtype)
        self.c3 = _vgg_stack([(128, 256), (256, 256), (256, 256)], dtype)
        self.c4 = _vgg_stack([(256, 512), (512, 512), (512, 512)], dtype)
        self.c5 = _vgg_stack([(512, 512)] * 3, dtype)
        kernel = (size[0] // 32, size[1] // 32)
        if min(kernel) < 1:
            raise ValueError(f"LegacyEncoder takes inputs of 32x32 or more, "
                             f"got {size}")
        self.c6 = nn.ModuleList([Conv(512, dim, kernel, padding=0),
                                 BatchNorm(dim)])

    def forward(self, x: torch.Tensor, train: bool = True
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        skips, h = [], x
        for i, level in enumerate((self.c1, self.c2, self.c3, self.c4,
                                   self.c5)):
            if i:
                h = max_pool(h, (2, 2))
            for layer in level:
                h = layer(h, train)
            skips.append(h)
        code = self.c6[1](self.c6[0](max_pool(h, (2, 2)), self.dtype), train,
                          self.dtype)
        return torch.tanh(code), skips


class LegacyDecoder(nn.Module):
    """Skip decoder from a 1x1 code (nets/vgg.py:120-176): upc1 a 4x4 VALID
    transposed conv + BN + lrelu, then VGG layers on [upsampled, skip]
    concats, upc6 ending in a 3x3 SAME transposed conv and a sigmoid."""

    def __init__(self, nc: int = 3, dim: int = 1024,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.upc1 = nn.ModuleList([ConvTranspose(dim, 512, 4, "VALID"),
                                   BatchNorm(512)])
        self.upc2 = _vgg_stack([(1024, 512), (512, 512), (512, 512)], dtype)
        self.upc3 = _vgg_stack([(1024, 512), (512, 512), (512, 256)], dtype)
        self.upc4 = _vgg_stack([(512, 256), (256, 256), (256, 128)], dtype)
        self.upc5 = _vgg_stack([(256, 128), (128, 64)], dtype)
        self.upc6 = nn.ModuleList([VGGLayer(128, 64, dtype),
                                   ConvTranspose(64, nc, 3, "SAME")])

    def forward(self, code_and_skips, train: bool = True) -> torch.Tensor:
        vec, skips = code_and_skips
        dt = self.dtype
        d = lrelu(self.upc1[1](self.upc1[0](vec, dt), train, dt))
        for level, skip in zip((self.upc2, self.upc3, self.upc4, self.upc5),
                               skips[::-1]):
            d = interpolate_bilinear(d, size=tuple(skip.shape[1:3]))
            d = torch.cat([d, skip], dim=-1)
            for layer in level:
                d = layer(d, train)
        d = interpolate_bilinear(d, size=tuple(skips[0].shape[1:3]))
        d = self.upc6[0](torch.cat([d, skips[0]], dim=-1), train)
        return torch.sigmoid(self.upc6[1](d, dt))


class LegacyRefineNet(nn.Module):
    """Encoder-decoder refinement without the flow encoder
    (nets/vgg.py:190-206); ``flow`` is accepted and unused."""

    def __init__(self, nc: int = 3, size: Size = (128, 128),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.image_encoder = LegacyEncoder(nc, 1024, size, dtype)
        self.image_decoder = LegacyDecoder(nc, 1024, dtype)

    def forward(self, warped_img: torch.Tensor, flow=None,
                train: bool = True) -> torch.Tensor:
        return self.image_decoder(self.image_encoder(warped_img, train), train)


class Flow2FrameWarped(nn.Module):
    """Image + flow dual-encoder decoder (nets/vgg.py:179-188)."""

    def __init__(self, nc: int = 3, size: Size = (128, 128),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.image_encoder = LegacyEncoder(nc, 1024, size, dtype)
        self.flow_encoder = LegacyEncoder(2, 512, size, dtype)
        self.image_decoder = LegacyDecoder(nc, 1536, dtype)

    def forward(self, warped_img: torch.Tensor, flow: torch.Tensor,
                train: bool = True) -> torch.Tensor:
        icode, iskips = self.image_encoder(warped_img, train)
        fcode, _ = self.flow_encoder(flow, train)
        return self.image_decoder((torch.cat([icode, fcode], dim=-1), iskips),
                                  train)
