"""HRNet coarse generator (counterpart of models/hrnet.py), forward and,
through autograd, backward.

seg encoder + stem + 4 Bottleneck layer1 + 2-branch then 3-branch (and,
with ``highres_large``, 4-branch) high-resolution modules +
upsample-concat + rgb/seg heads, at the published widths (branches
64/128/256(/512), 448 -> 448 (960 -> 960) head 1x1s, rgb 3 + seg 20).

The Hopper kernels go in at the sites where the JAX package's TPU build
routes its Pallas kernels, by the JAX package's own shape predicates:

- stem + layer1, by ``_pack_factor`` (hrnet.py:452-460, without its TPU
  test): at W >= 256 and even (serving at 512x1024) K1
  ``conv3x3_bias_res_lrelu`` runs stem conv2 (with bias) and transition1's
  trans_0 (256 -> 64), and K2 ``bottleneck_tail`` the four layer1
  Bottleneck tails; at any other width (the 128x128 train recipe) the
  train-chain kernels run the whole stem (``stem_fwd`` / ``stem_bwd``) and
  the four whole Bottlenecks (``bottleneck_fwd`` / ``bottleneck_bwd``),
  and trans_0 is ``F.conv2d``, as ``_trainchain`` and the unpacked
  transition route them (hrnet.py:557-565, :351-354);
- the four BasicBlocks of a stage2/stage3 branch run through the
  BasicBlock chain kernels (C = 64, 128 or 256; ``ops/bbchain``) where
  ``bb_chain_route`` holds for the branch under ``DVIE_BBCHAIN``
  (hrnet.py:164-201; default ``b0``: branch 0 at the 24x128x128 train
  recipe; ``rest``: branches 1 and 2 where they fit; ``all``: every branch
  that fits; ``0``: none); else a 64-ch branch 0 takes K1 for both convs
  (the second with the residual) where the JAX ``packable`` test holds
  (hrnet.py:146-149: W even and >= 128), and every other branch
  ``F.conv2d``;
- K3 ``fuse_out0``: the out-0 fuse sum of stage2 and stage3 (2-3
  branches, ``_fuse0_gate`` at hrnet.py:124); stage4's out-0 is the plain
  1x1 + bilinear + sum + lrelu (hrnet.py:280-318);
- K4 ``ups_head_taps``: upsample-concat + both heads up to the taps tensor
  (its backward recomputes h through K4's h mode, ``ups_head_1x1``); with
  ``highres_large`` the 4-part head ``ups_head_taps4`` (hrnet.py:796-823).
  The JAX package takes its 4-part kernel only where ``fits4`` holds; the
  Hopper kernel tiles over pixels and takes any pyramid size, so the port
  always runs it, and a pyramid it cannot take raises.

Every other conv (the stem conv1 at W >= 256, the 1x1 and stride-2 fuse
convs, the transitions' stride-2 convs, branches 1-3 off the chain route)
is ``F.conv2d``, as the JAX package leaves it to XLA.  Every kernel is
differentiable.
``use_kernels=False`` builds the same model on the kernels' plain versions
(the reference the card's run is held to), differentiated by autograd.

Submodule names follow the reference's torch HRNet, so ``state_dict`` keys
are exactly those ``tools/torch_port.port_hrnet`` reads.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.models.blocks import (
    BasicBlock,
    Bottleneck,
    Conv,
    SegEncoder,
    conv3x3_site,
    lrelu,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.bbchain import (
    bb_chain,
    bb_chain_plain,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.bottleneck_tail import (
    bottleneck_tail,
    bottleneck_tail_plain,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.fuse0 import (
    fuse_out0,
    fuse_out0_plain,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.resize import (
    interpolate_bilinear,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.shiftadd import (
    shifted_add_bias,
    shifted_add_bias_plain,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.trainchain import (
    stem_layer1,
)
from deep_video_interpolation_extrapolation_tpu_torch.ops.upshead import (
    build_dual_tap_kernel,
    ups_head_taps,
    ups_head_taps4,
    ups_head_taps4_plain,
    ups_head_taps_plain,
)

# stage configs (hrnet.py:45-47)
STAGE2_CFG = dict(num_branches=2, num_blocks=(4, 4), num_channels=(64, 128))
STAGE3_CFG = dict(num_branches=3, num_blocks=(4, 4, 4),
                  num_channels=(64, 128, 256))
STAGE4_CFG = dict(num_branches=4, num_blocks=(4, 4, 4, 4),
                  num_channels=(64, 128, 256, 512))
N_FRAMES, RGB_DIM, SEG_DIM = 2, 3, 20   # interpolation: 2 frames in, 1 out


def packed_route(w: int) -> bool:
    """The JAX package's stem/layer1 route (``_pack_factor`` != 0, without
    its TPU test): W even and >= 256."""
    return w % 2 == 0 and w >= 256


def branch0_kernel(w: int) -> bool:
    """The JAX ``packable`` test for a 64-ch branch: W even and >= 128."""
    return w % 2 == 0 and w >= 128


def bb_chain_mode() -> str:
    """``DVIE_BBCHAIN`` as the JAX package reads it (hrnet.py:175): ``all``
    | ``b0`` (the default) | ``rest`` | ``0``; any other value routes no
    branch through the chain, as there."""
    return os.environ.get("DVIE_BBCHAIN", "b0")


def bb_fits(b: int, h: int, w2: int, c: int, n_blocks: int,
            itemsize: int) -> bool:
    """``pallas_trainchain.bb_fits`` (:652-678) on a (b, h, w2, c) shape:
    its tiling rules and ``_bb_pick_bt``'s 40 MiB budget for some batch
    tile.  The budget is the TPU kernel's VMEM budget, kept so that the
    port takes the JAX package's route at every shape; it is no limit of
    the Hopper chain kernels, whose pixel tiles take any size."""
    if w2 % 8 or h < 8 or c % 128:
        return False
    budget = 40 * 2**20
    plane = h * w2 * c * itemsize
    weights = 2 * n_blocks * 9 * c * c * 4 * 2
    return any(b % bt == 0 and 2 * bt * plane * 3 + bt * plane * (n_blocks + 3)
               + weights < budget for bt in (8, 4, 2, 1))


def bb_chain_route(b: int, h: int, w: int, itemsize: int = 2,
                   n_blocks: int = 4, c: int = 64, mode: str = "b0") -> bool:
    """Whether a branch of ``c`` channels at (b, h, w) takes the BasicBlock
    chain under ``DVIE_BBCHAIN=mode`` (hrnet.py:146-186, without its TPU
    tests): the mode allows the branch (``all``; ``b0`` if ``packable``;
    ``rest`` if not), and ``bb_fits`` holds on the shape the JAX kernel
    sees, width-packed (b, h, w/2, 128) for a ``packable`` 64-ch branch,
    else unpacked (b, h, w, c) with ``itemsize``-byte elements.  Pure shape
    arithmetic.  At the 24x128x128 train recipe: ``b0`` takes branch 0
    (64 ch at 128x128), ``rest`` branch 1 (128 ch at 64x64), ``all`` both;
    branch 2 (256 ch at 32x32) never fits there, but does at 16x32 (a
    64x128 input).  Serving shapes (2x128x256, 2x512x1024) take none."""
    packable = c == 64 and branch0_kernel(w)
    allowed = (mode == "all" or (mode == "b0" and packable)
               or (mode == "rest" and not packable))
    if not allowed:
        return False
    if packable:
        return bb_fits(b, h, w // 2, 128, n_blocks, itemsize)
    return bb_fits(b, h, w, c, n_blocks, itemsize)


class HighResolutionModule(nn.Module):
    """Parallel multi-resolution branches + full fuse (hrnet.py:83-319).

    Each branch's BasicBlocks take the chain (``bb_chain``, or
    ``bb_chain_plain`` in the plain model) where ``bb_chain_route`` holds
    for its shape and the ``DVIE_BBCHAIN`` mode, read at each forward;
    else block by block, on K1 for a packable 64-ch branch 0."""

    def __init__(self, num_branches: int, num_blocks: Sequence[int],
                 num_channels: Sequence[int], use_kernels: bool = True):
        super().__init__()
        self.num_branches = num_branches
        self.use_kernels = use_kernels
        ch = num_channels
        self.branches = nn.ModuleList(
            nn.ModuleList(BasicBlock(ch[i]) for _ in range(num_blocks[i]))
            for i in range(num_branches))
        fuse = nn.ModuleList()
        for i in range(num_branches):
            row = nn.ModuleList()
            for j in range(num_branches):
                if j > i:     # 1x1 conv, then upsample to branch i
                    row.append(nn.Sequential(
                        Conv(ch[j], ch[i], 1, padding=0, bias=False)))
                elif j == i:
                    row.append(None)
                else:         # chain of stride-2 3x3 convs down to branch i
                    row.append(nn.ModuleList(
                        nn.Sequential(Conv(ch[j], ch[i] if k == i - j - 1
                                           else ch[j], 3, stride=2,
                                           bias=False))
                        for k in range(i - j)))
            fuse.append(row)
        self.fuse_layers = fuse

    def forward(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        ys = []
        mode = bb_chain_mode()
        for i, blocks in enumerate(self.branches):
            h = xs[i]
            if bb_chain_route(*h.shape[:3], h.element_size(), len(blocks),
                              h.shape[-1], mode):
                pairs = [(blk.conv1.weight, blk.conv2.weight)
                         for blk in blocks]
                h = (bb_chain if self.use_kernels else bb_chain_plain)(
                    h, pairs)
            else:
                kernel = (self.use_kernels and i == 0
                          and branch0_kernel(h.shape[2]))
                for blk in blocks:
                    h = blk(h, kernel=kernel)
            ys.append(h)

        outs = []
        if self.num_branches <= 3:
            # out-0: the 1x1 fuse convs stay F.conv2d; upsample + sum +
            # lrelu is K3 (hrnet.py:242-278)
            t1 = self.fuse_layers[0][1][0](ys[1])
            t2 = (self.fuse_layers[0][2][0](ys[2])
                  if self.num_branches == 3 else None)
            outs.append((fuse_out0 if self.use_kernels else fuse_out0_plain)(
                ys[0], t1, t2))
        for i in range(len(outs), self.num_branches):
            y = None
            for j in range(self.num_branches):
                if j == i:
                    t = ys[j]
                elif j > i:
                    t = interpolate_bilinear(self.fuse_layers[i][j][0](ys[j]),
                                             size=tuple(ys[i].shape[1:3]))
                else:
                    t = ys[j]
                    chain = self.fuse_layers[i][j]
                    for k, seq in enumerate(chain):
                        t = seq[0](t)
                        if k < len(chain) - 1:
                            t = lrelu(t)
                y = t if y is None else y + t
            outs.append(lrelu(y))
        return outs


class _Transition(nn.ModuleList):
    """Branch-count/channel transition (hrnet.py:322-373).  A same-
    resolution channel change is a 3x3 conv + lrelu (K1 with
    ``kernel=True``); each new branch is a chain of stride-2 3x3 convs +
    lrelu."""

    def __init__(self, pre: Sequence[int], cur: Sequence[int]):
        layers = []
        for i, c in enumerate(cur):
            if i < len(pre):
                layers.append(nn.Sequential(Conv(pre[i], c, 3, bias=False))
                              if pre[i] != c else None)
            else:
                n = i + 1 - len(pre)
                layers.append(nn.Sequential(*(
                    nn.Sequential(Conv(pre[-1], c if j == n - 1 else pre[-1],
                                       3, stride=2, bias=False))
                    for j in range(n))))
        super().__init__(layers)
        self.n_pre = len(pre)

    def forward(self, xs: Sequence[torch.Tensor],
                kernel: bool = False) -> List[torch.Tensor]:
        outs = []
        for i, layer in enumerate(self):
            if i < self.n_pre:
                outs.append(xs[i] if layer is None else conv3x3_site(
                    xs[i], layer[0], kernel=kernel))
            else:
                t = xs[-1]
                for seq in layer:
                    t = lrelu(seq[0](t))
                outs.append(t)
        return outs


class _Head(nn.Sequential):
    """1x1 conv + lrelu + 3x3 conv head (hrnet.py:695-728); indices 0/2
    are the reference's state_dict keys.  ``forward`` is the unfused head
    on the concat feature map; HRNet runs both heads through K4."""

    def __init__(self, cin: int, out_dim: int):
        super().__init__(Conv(cin, cin, 1, padding=0), nn.LeakyReLU(0.2),
                         Conv(cin, out_dim, 3))

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        return self[2](lrelu(self[0](feat)))


def _concat_pyramid(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Bilinear-upsample the pyramid to branch-0 resolution and
    channel-concat (hrnet.py:907-915)."""
    size = tuple(parts[0].shape[1:3])
    return torch.cat([parts[0]] + [interpolate_bilinear(t, size=size)
                                   for t in parts[1:]], dim=-1)


def _encode_inputs(rgb: torch.Tensor, seg: torch.Tensor,
                   seg_encoder: SegEncoder, dtype: torch.dtype,
                   n_classes: int = 20) -> torch.Tensor:
    """Per-frame seg encoding + concat with rgb (hrnet.py:918-927)."""
    n_frames = seg.shape[-1] // n_classes
    encoded = [seg_encoder(seg[..., i * n_classes:(i + 1) * n_classes], dtype)
               for i in range(n_frames)]
    return torch.cat([rgb] + encoded, dim=-1)


class HRNet(nn.Module):
    """Coarse generator, interpolation mode (hrnet.py:956-1010).

    ``forward(rgb, seg)``: rgb (B,H,W,3*n_frames), seg one-hot
    (B,H,W,20*n_frames), NHWC; returns (rgb_out (B,H,W,3),
    seg_out (B,H,W,20)) in ``dtype``.  ``highres_large`` adds transition3
    and the 4-branch stage4 (STAGE4_CFG, the CLI's ``--highres_large``)."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 use_kernels: bool = True, highres_large: bool = False):
        super().__init__()
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.highres_large = highres_large
        k = use_kernels
        self.seg_encoder = SegEncoder()
        self.conv1 = Conv((3 + 4) * N_FRAMES, 64, 3)   # rgb + seg encoding
        self.conv2 = Conv(64, 64, 3)
        self.layer1 = nn.Sequential(*(Bottleneck(64 if i == 0 else 256, 64)
                                      for i in range(4)))
        self.transition1 = _Transition((256,), STAGE2_CFG["num_channels"])
        self.stage2 = nn.ModuleList([HighResolutionModule(**STAGE2_CFG,
                                                          use_kernels=k)])
        self.transition2 = _Transition(STAGE2_CFG["num_channels"],
                                       STAGE3_CFG["num_channels"])
        self.stage3 = nn.ModuleList([HighResolutionModule(**STAGE3_CFG,
                                                          use_kernels=k)])
        last = STAGE3_CFG
        if highres_large:
            self.transition3 = _Transition(STAGE3_CFG["num_channels"],
                                           STAGE4_CFG["num_channels"])
            self.stage4 = nn.ModuleList([HighResolutionModule(
                **STAGE4_CFG, use_kernels=k)])
            last = STAGE4_CFG
        head_cin = sum(last["num_channels"])
        self.rgb_layer = _Head(head_cin, RGB_DIM)
        self.seg_layer = _Head(head_cin, SEG_DIM)

    def _stem_layer1(self, x: torch.Tensor) -> torch.Tensor:
        """Stem conv1/conv2 + the four layer1 Bottlenecks (hrnet.py:486-580),
        by the route of ``packed_route``."""
        if not packed_route(x.shape[2]):
            return self._trainchain(x.to(self.dtype))
        # block 0's h1 = lrelu(conv1x1(x)) outside the fused tails, each
        # tail returns the block output and the next block's h1
        # (hrnet.py:431-448)
        x = lrelu(self.conv1(x, self.dtype))
        x = conv3x3_site(x, self.conv2, kernel=self.use_kernels)
        tail = bottleneck_tail if self.use_kernels else bottleneck_tail_plain
        blocks = self.layer1
        h1 = lrelu(blocks[0].conv1(x))
        for i, blk in enumerate(blocks):
            wres = blk.downsample[0].weight if blk.downsample is not None else None
            w1n = blocks[i + 1].conv1.weight if i + 1 < len(blocks) else None
            x, h1 = tail(h1, x, blk.conv2.weight, blk.conv3.weight, wres, w1n)
        return x

    def _trainchain(self, x: torch.Tensor) -> torch.Tensor:
        """The whole stem, then four whole Bottlenecks (hrnet.py:588-609)."""
        return stem_layer1(
            x, (self.conv1.weight, self.conv1.bias, self.conv2.weight,
                self.conv2.bias),
            [(blk.conv1.weight, blk.conv2.weight, blk.conv3.weight,
              blk.downsample[0].weight if blk.downsample is not None
              else None) for blk in self.layer1],
            kernels=self.use_kernels)

    def _backbone(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Stem + layer1 + stage2/3 (/4); returns the raw pyramid
        (_HRBackbone with return_parts, hrnet.py:463-692)."""
        packed = packed_route(x.shape[2])
        x = self._stem_layer1(x)
        xs = self.transition1([x], kernel=self.use_kernels and packed)
        xs = self.stage2[0](xs)
        xs = self.transition2(xs)
        xs = self.stage3[0](xs)
        if self.highres_large:
            xs = self.stage4[0](self.transition3(xs))
        return xs

    def _head_weights(self, dt: torch.dtype):
        """(w1, b1, w2t) of both heads: the two 1x1s side by side, their
        biases in f32 and the taps matrix of the two 3x3s.  Without grad
        (serving) the three are kept per weight (``hw.derived``): they are
        built once, not once a forward, and so are the 4-part kernel's
        units of them (ops/upshead.taps4_weights)."""
        rgb_fc, seg_fc = self.rgb_layer[0], self.seg_layer[0]
        rgb_k, seg_k = self.rgb_layer[2].weight, self.seg_layer[2].weight

        def build():
            w1 = torch.cat([rgb_fc.weight[:, :, 0, 0].t(),
                            seg_fc.weight[:, :, 0, 0].t()], dim=1)
            b1 = torch.cat([rgb_fc.bias, seg_fc.bias]).float()
            return w1, b1, build_dual_tap_kernel(rgb_k, seg_k, dt)

        if torch.is_grad_enabled():
            return build()

        def kept():   # plain tensors, though built under inference mode
            with torch.inference_mode(False), torch.no_grad():
                return build()
        return hw.derived(f"heads:{dt}", (rgb_fc.weight, rgb_fc.bias,
                                          seg_fc.weight, seg_fc.bias,
                                          rgb_k, seg_k), kept)

    def _apply_heads(self, parts: Sequence[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both heads through K4 (3 parts) or ``ups_head_taps4`` (4 parts),
        then the shifted-add tail (hrnet.py:788-865) on its kernel: the JAX
        package leaves that tail to XLA unless ``DVIE_SHIFTADD=1``, a
        default resting on a TPU measurement."""
        w1, b1, w2t = self._head_weights(parts[0].dtype)
        if len(parts) == 4:
            fused = ups_head_taps4 if self.use_kernels else ups_head_taps4_plain
        else:
            fused = ups_head_taps if self.use_kernels else ups_head_taps_plain
        yt = fused(*parts, w1, b1, w2t)
        tail = shifted_add_bias if self.use_kernels else shifted_add_bias_plain
        out = tail(yt, torch.cat([self.rgb_layer[2].bias,
                                  self.seg_layer[2].bias]))
        return out[..., :RGB_DIM], out[..., RGB_DIM:]

    def forward(self, rgb: torch.Tensor, seg: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = _encode_inputs(rgb, seg, self.seg_encoder, self.dtype)
        return self._apply_heads(self._backbone(x))
