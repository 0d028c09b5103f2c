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
  always runs it (its 208 or 216 instance, ExtraInpaintNet
  ``--inpaint_mask`` the latter), and a pyramid it cannot take raises.
  Its backward is explicit, K4's on four parts (``ups_head_taps4_bwd``: h
  recomputed by the 4-part kernel's h mode).  Where the heads'
  taps do not fit the taps product (the JAX predicate ``rgb * 9 <= 128
  and seg * 9 <= 256``, hrnet.py:829-830: extrapolation at
  ``--num_pred_once`` >= 2, whose seg head is 40 wide) K4's h mode
  ``ups_head_1x1`` makes h, differentiable, and the two 3x3s run on its
  halves as ``F.conv2d`` (hrnet.py:897-900, where JAX runs them outside
  any Pallas kernel).

With ``remat`` (``--remat``) the backbone checkpoints the regions the JAX
``_HRBackbone.remat`` does (hrnet.py:618-625): the stem and layer1, each
transition and each stage module, each recomputed in the backward
(``core/remat.checkpoint``).

Every other conv (the stem conv1 at W >= 256, the 1x1 and stride-2 fuse
convs, the transitions' stride-2 convs, branches 1-3 off the chain route)
is ``F.conv2d``, as the JAX package leaves it to XLA.  Every kernel is
differentiable.
``use_kernels=False`` builds the same model on the kernels' plain versions
(the reference the card's run is held to), differentiated by autograd.

Submodule names follow the reference's torch HRNet, so ``state_dict`` keys
are exactly those ``tools/torch_port.port_hrnet`` reads.

Extrapolation (``syn_type="extra"``, hrnet.py:956-1010) predicts
``num_pred_once`` frames: heads of ``(4 if inpaint_mask else 3) * p`` and
``20 * p`` channels; with ``inpaint_mask`` the fourth channel of each frame
is a sigmoid mask, else with ``inpaint`` the mask comes from the seg
(``extra_mask_from_seg``).  The rgb head of 4 makes the taps 216 wide and
the shifted add 24 wide: the 216 and 24 instances of K4 and of the
shifted-add kernel.  ``InpaintUnet`` (hrnet.py:1013-1058) is plain PyTorch
on cuDNN convolutions, as the JAX module runs no Pallas kernel.

``VAEHRNet`` (hrnet.py:1061-1188) is the same backbone and heads behind a
conditional VAE: a BatchNorm conv encoder of (inputs, ground truth) to a
latent of 16 channels at 1/16 scale, a transposed-conv decoder of the
latent to 32 channels at full scale, concatenated before the 14 input
channels, so the stem takes 46 (on the train chain, the stem kernels at
their 48-channel width).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.core.remat import (
    checkpoint,
)
from deep_video_interpolation_extrapolation_tpu_torch.models.blocks import (
    BasicBlock,
    Bottleneck,
    Conv,
    ConvT,
    ResnetBlock,
    SegEncoder,
    conv3x3_site,
    lrelu,
    lrelu0,
)
from deep_video_interpolation_extrapolation_tpu_torch.models.subnets import (
    BatchNorm,
    Dense,
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
    ups_head_1x1,
    ups_head_1x1_plain,
    ups_head_taps,
    ups_head_taps4,
    ups_head_taps4_plain,
    ups_head_taps_plain,
)
from deep_video_interpolation_extrapolation_tpu_torch.parallel import (
    dist,
    spatial,
)

# stage configs (hrnet.py:45-47)
STAGE2_CFG = dict(num_branches=2, num_blocks=(4, 4), num_channels=(64, 128))
STAGE3_CFG = dict(num_branches=3, num_blocks=(4, 4, 4),
                  num_channels=(64, 128, 256))
STAGE4_CFG = dict(num_branches=4, num_blocks=(4, 4, 4, 4),
                  num_channels=(64, 128, 256, 512))
N_FRAMES, RGB_DIM, SEG_DIM = 2, 3, 20   # interpolation: 2 frames in, 1 out
FG_CLASS = 11    # classes from here on are foreground (hrnet.py:932)


def head_widths(syn_type: str = "inter", num_pred_once: int = 1,
                inpaint_mask: bool = False) -> Tuple[int, int]:
    """(rgb, seg) head widths (hrnet.py:983-989): 3 and 20, or in
    extrapolation ``(4 if inpaint_mask else 3) * p`` and ``20 * p``."""
    if syn_type != "extra":
        return RGB_DIM, SEG_DIM
    p = num_pred_once
    return (4 if inpaint_mask else 3) * p, SEG_DIM * p


def taps_fit(rgb_dim: int, seg_dim: int) -> bool:
    """The JAX predicate of the heads' taps route (hrnet.py:829-830):
    ``rgb * 9 <= 128 and seg * 9 <= 256``."""
    return rgb_dim * 9 <= 128 and seg_dim * 9 <= 256


def extra_mask_from_seg(rgb_out: torch.Tensor, seg_out: torch.Tensor,
                        last_input_seg: torch.Tensor,
                        num_pred_once: int) -> torch.Tensor:
    """The occlusion mask of extrapolation with ``--inpaint`` and without
    ``--inpaint_mask`` (``_extra_mask_from_seg``, hrnet.py:930-953): 0
    (inpaint) where the last input frame's class is foreground (>= 11) and
    the predicted one (argmax of the detached seg) is background, else 1;
    (B,H,W,p) in rgb_out's dtype."""
    fg = (torch.arange(SEG_DIM, device=rgb_out.device) >= FG_CLASS).to(
        rgb_out.dtype)
    fg_input = fg[last_input_seg.argmax(dim=-1)]
    masks = []
    for i in range(num_pred_once):
        ids = seg_out[..., SEG_DIM * i:SEG_DIM * (i + 1)].detach().argmax(-1)
        masks.append(1.0 - fg_input * (1.0 - fg)[ids])
    return torch.stack(masks, dim=-1)


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
    else block by block, on K1 for a packable 64-ch branch 0.  On a band
    (spatial sharding) the route is decided on the global shape."""

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
            if bb_chain_route(h.shape[0], spatial.global_rows(h.shape[1]),
                              h.shape[2], h.element_size(), len(blocks),
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
    """Coarse generator (hrnet.py:956-1010).

    ``forward(rgb, seg)``: rgb (B,H,W,3*n_frames), seg one-hot
    (B,H,W,20*n_frames), NHWC; returns (rgb_out (B,H,W,3),
    seg_out (B,H,W,20)) in ``dtype``.  ``highres_large`` adds transition3
    and the 4-branch stage4 (STAGE4_CFG, the CLI's ``--highres_large``).
    ``in_ch`` is conv1's width: 7 per input frame (rgb and the 4-channel
    seg encoding).

    ``syn_type="extra"`` is extrapolation: rgb_out (B,H,W,3p) and seg_out
    (B,H,W,20p) for ``num_pred_once`` = p frames, and with ``inpaint`` the
    mask (B,H,W,p) too: the sigmoid of the rgb head's mask channels under
    ``inpaint_mask``, else ``extra_mask_from_seg``.

    ``remat`` (``--remat``) checkpoints the backbone at stage granularity
    while a gradient is being taken (``_backbone``)."""

    vae = False     # a VAEHRNet takes the ground truth and draws a latent

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 use_kernels: bool = True, highres_large: bool = False,
                 in_ch: int = (3 + 4) * N_FRAMES, syn_type: str = "inter",
                 num_pred_once: int = 1, inpaint: bool = False,
                 inpaint_mask: bool = False, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.highres_large = highres_large
        self.remat = remat
        self.syn_type = syn_type
        self.num_pred_once = num_pred_once
        self.inpaint, self.inpaint_mask = inpaint, inpaint_mask
        self.rgb_dim, self.seg_dim = head_widths(syn_type, num_pred_once,
                                                 inpaint_mask)
        k = use_kernels
        self.seg_encoder = SegEncoder()
        self.conv1 = Conv(in_ch, 64, 3)   # rgb + seg encoding (+ VAE feature)
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
        self.rgb_layer = _Head(head_cin, self.rgb_dim)
        self.seg_layer = _Head(head_cin, self.seg_dim)

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
        (_HRBackbone with return_parts, hrnet.py:463-692).  Under ``remat``
        with grad, each of stem + layer1, the transitions and the stage
        modules is a checkpoint region (hrnet.py:618-625)."""
        packed = packed_route(x.shape[2])

        def region(fn, arg):     # no region holds a buffer or a generator
            return checkpoint(fn, arg) if self.remat else fn(arg)

        x = region(self._stem_layer1, x)
        xs = region(lambda t: self.transition1(
            [t], kernel=self.use_kernels and packed), x)
        xs = region(self.stage2[0], xs)
        xs = region(self.transition2, xs)
        xs = region(self.stage3[0], xs)
        if self.highres_large:
            xs = region(self.stage4[0], region(self.transition3, xs))
        return xs

    def _head_weights(self, dt: torch.dtype, taps: bool = True):
        """(w1, b1, w2t) of both heads: the two 1x1s side by side, their
        biases in f32 and the taps matrix of the two 3x3s (None unless
        ``taps``).  Without grad (serving) the three are kept per weight
        (``hw.derived``): they are built once, not once a forward, and so
        are the 4-part kernel's units of them (ops/upshead.taps4_weights).
        Under a tracer (``tools/export.py``) they are built as traced ops,
        a graph's own."""
        rgb_fc, seg_fc = self.rgb_layer[0], self.seg_layer[0]
        rgb_k, seg_k = self.rgb_layer[2].weight, self.seg_layer[2].weight

        def build():
            w1 = torch.cat([rgb_fc.weight[:, :, 0, 0].t(),
                            seg_fc.weight[:, :, 0, 0].t()], dim=1)
            b1 = torch.cat([rgb_fc.bias, seg_fc.bias]).float()
            return w1, b1, (build_dual_tap_kernel(rgb_k, seg_k, dt)
                            if taps else None)

        if torch.is_grad_enabled() or hw.tracing():
            return build()

        def kept():   # plain tensors, though built under inference mode
            with torch.inference_mode(False), torch.no_grad():
                return build()
        return hw.derived(f"heads:{dt}:{taps}", (rgb_fc.weight, rgb_fc.bias,
                                                 seg_fc.weight, seg_fc.bias,
                                                 rgb_k, seg_k), kept)

    def _apply_heads(self, parts: Sequence[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both heads, by the JAX package's routes (hrnet.py:762-905).
        Where the taps fit (``taps_fit``): through K4 (3 parts, its 208 or
        216 instance) or ``ups_head_taps4`` (4 parts), then the
        shifted-add tail on its kernel (co 23 or 24): the JAX package
        leaves that tail to XLA unless ``DVIE_SHIFTADD=1``, a default
        resting on a TPU measurement.  Else, 3 parts: h through K4's h
        mode, then each head's 3x3 on its half of h (hrnet.py:897-900);
        4 parts: the unfused heads on the concat (hrnet.py:904-905)."""
        rgb_dim = self.rgb_dim
        if not taps_fit(rgb_dim, self.seg_dim):
            if len(parts) == 4:
                feat = _concat_pyramid(parts)
                return self.rgb_layer(feat), self.seg_layer(feat)
            w1, b1, _ = self._head_weights(parts[0].dtype, taps=False)
            h = (ups_head_1x1 if self.use_kernels else ups_head_1x1_plain)(
                *parts, w1, b1)
            cin = h.shape[-1] // 2
            return self.rgb_layer[2](h[..., :cin]), self.seg_layer[2](
                h[..., cin:])
        w1, b1, w2t = self._head_weights(parts[0].dtype)
        if len(parts) == 4:
            fused = ups_head_taps4 if self.use_kernels else ups_head_taps4_plain
        else:
            fused = ups_head_taps if self.use_kernels else ups_head_taps_plain
        yt = fused(*parts, w1, b1, w2t)
        tail = shifted_add_bias if self.use_kernels else shifted_add_bias_plain
        out = tail(yt, torch.cat([self.rgb_layer[2].bias,
                                  self.seg_layer[2].bias]))
        return out[..., :rgb_dim], out[..., rgb_dim:]

    def _extra_outputs(self, rgb_out: torch.Tensor, seg_out: torch.Tensor,
                       seg: torch.Tensor):
        """The extrapolation outputs of the heads (hrnet.py:1000-1010)."""
        p = self.num_pred_once
        mask = None
        if self.inpaint and self.inpaint_mask:
            mask = torch.sigmoid(rgb_out[..., 3 * p:])
        rgb_out = rgb_out[..., :3 * p]
        if self.inpaint and not self.inpaint_mask:
            mask = extra_mask_from_seg(rgb_out, seg_out, seg[..., -SEG_DIM:],
                                       p)
        if self.inpaint:
            return rgb_out, seg_out, mask
        return rgb_out, seg_out

    def forward(self, rgb: torch.Tensor, seg: torch.Tensor):
        x = _encode_inputs(rgb, seg, self.seg_encoder, self.dtype)
        rgb_out, seg_out = self._apply_heads(self._backbone(x))
        if self.syn_type == "extra":
            return self._extra_outputs(rgb_out, seg_out, seg)
        return rgb_out, seg_out


class InpaintUnet(nn.Module):
    """Mask-region inpainting U-Net + composite (hrnet.py:1013-1058).

    ``forward(rgb, mask, seg)``: rgb (B,H,W,3p), mask (B,H,W,p) with 1 =
    keep the coarse frame, 0 = inpaint, seg (B,H,W,20p); returns (B,H,W,3p)
    ``out * (1 - m) + rgb * m`` per frame.  5x5 convs, two stride-2 3x3s
    with ResnetBlocks, four dilated 3x3s (rates 1, 2, 4, 8), two
    ``align_corners=True`` bilinear x2 upsamplings, in ``dtype``; plain
    PyTorch on cuDNN, as the JAX module runs no Pallas kernel.  ``convs.k``
    and ``res.k`` are the flax ``Conv_k`` and ``ResnetBlock_k``."""

    # (cout, kernel, stride, dilation) of Conv_0 .. Conv_10; Conv_11 is the
    # 3x3 out to 3p channels
    CONVS = ((128, 5, 1, 1), (64, 5, 1, 1), (128, 3, 2, 1), (256, 3, 2, 1),
             (256, 3, 1, 1), (256, 3, 1, 2), (256, 3, 1, 4), (256, 3, 1, 8),
             (128, 3, 1, 1), (64, 3, 1, 1), (64, 3, 1, 1))

    def __init__(self, num_pred_once: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        p = num_pred_once
        self.num_pred_once, self.dtype = p, dtype
        cins = (3 * p + p + SEG_DIM * p, 128, 64, 128, 256, 256, 256, 256,
                256, 128, 64)
        self.convs = nn.ModuleList(
            [Conv(ci, co, k, stride=s, dilation=d)
             for ci, (co, k, s, d) in zip(cins, self.CONVS)]
            + [Conv(64, 3 * p, 3)])
        self.res = nn.ModuleList(ResnetBlock(c) for c in (128, 256, 256, 128))

    def forward(self, rgb: torch.Tensor, mask: torch.Tensor,
                seg: torch.Tensor) -> torch.Tensor:
        c, r, dt = self.convs, self.res, self.dtype
        x = torch.cat([rgb, mask.to(rgb.dtype), seg.to(rgb.dtype)], dim=-1)
        h0 = lrelu(c[1](lrelu(c[0](x, dt))))
        e1 = r[0](lrelu(c[2](h0)))
        e2 = r[1](lrelu(c[3](e1)))
        d = e2
        for k in range(4, 8):      # dilation 1, 2, 4, 8; no lrelu after 8
            d = c[k](d)
            if k != 7:
                d = lrelu(d)
        d2 = interpolate_bilinear(r[2](e2 + d), scale_factor=2.0,
                                  align_corners=True)
        d2 = c[8](lrelu(d2))
        d1 = interpolate_bilinear(r[3](d2 + e1), scale_factor=2.0,
                                  align_corners=True)
        d1 = c[9](lrelu(d1))
        out = lrelu(d1 + h0)
        out = c[11](lrelu(c[10](out)))
        finals = []
        for j in range(self.num_pred_once):
            m = mask[..., j:j + 1]
            finals.append(out[..., 3 * j:3 * j + 3] * (1 - m)
                          + rgb[..., 3 * j:3 * j + 3] * m)
        return torch.cat(finals, dim=-1)


# ---- VAEHRNet ----------------------------------------------------------------

VAE_IN = 2 * (RGB_DIM + SEG_DIM) + RGB_DIM + SEG_DIM   # inputs + ground truth
VAE_FEAT, LATENT_C = 32, 16    # decoder feature, latent channels at 1/16
DENSE_LATENT_MAX = 4096        # above it the latent is spatial (1x1 convs)


class _VAEEncoder(nn.Module):
    """Strided conv encoder with BatchNorm (hrnet.py:1155-1173): 128x128 ->
    8x8x16.  ``convs.k`` / ``bns.k`` are the flax ``Conv_k`` /
    ``BatchNorm_k``."""

    # (cout, stride, BatchNorm) of each conv, in order
    LAYERS = ([(32, 1, False), (32, 1, True)]
              + [(c, s, True) for c in (32, 64, 128) for s in (2, 1)]
              + [(128, 2, True), (64, 1, True), (32, 1, True),
                 (LATENT_C, 1, False)])

    def __init__(self, cin: int = VAE_IN):
        super().__init__()
        convs, bns = [], []
        for cout, stride, bn in self.LAYERS:
            convs.append(Conv(cin, cout, 3, stride=stride))
            if bn:
                bns.append(BatchNorm(cout))
            cin = cout
        self.convs, self.bns = nn.ModuleList(convs), nn.ModuleList(bns)

    def forward(self, x: torch.Tensor, train: bool,
                dtype: torch.dtype) -> torch.Tensor:
        x = x.to(dtype)
        k = 0
        for i, (conv, (_, _, bn)) in enumerate(zip(self.convs, self.LAYERS)):
            x = conv(x)
            if bn:
                x = self.bns[k](x, train, dtype)
                k += 1
            if i < len(self.LAYERS) - 1:
                x = lrelu0(x)
        return x


class _VAEDecoder(nn.Module):
    """ConvTranspose decoder with BatchNorm (hrnet.py:1176-1188): four
    (2x transposed conv, BN, lrelu, 3x3 conv (, BN, lrelu)) steps, 1/16 ->
    full scale, 32 channels.  ``ups.i`` / ``convs.i`` / ``bns.k`` are the
    flax ``ConvT_i`` / ``Conv_i`` / ``BatchNorm_k``."""

    def __init__(self):
        super().__init__()
        self.ups = nn.ModuleList(ConvT(LATENT_C if i == 0 else VAE_FEAT,
                                       VAE_FEAT) for i in range(4))
        self.convs = nn.ModuleList(Conv(VAE_FEAT, VAE_FEAT, 3)
                                   for _ in range(4))
        self.bns = nn.ModuleList(BatchNorm(VAE_FEAT) for _ in range(7))

    def forward(self, z: torch.Tensor, train: bool,
                dtype: torch.dtype) -> torch.Tensor:
        x = z.to(dtype)
        for i in range(4):
            x = lrelu0(self.bns[2 * i](self.ups[i](x), train, dtype))
            x = self.convs[i](x)
            if i != 3:   # the last conv has no BN or activation
                x = lrelu0(self.bns[2 * i + 1](x, train, dtype))
        return x


def dense_latent(h: int, w: int) -> bool:
    """Whether a (h, w) input takes the Dense latent (``mu_fc``,
    ``logvar_fc``: the reference's, up to a latent of 4096, i.e. 256x256)
    or the spatial one (``mu_conv``, ``logvar_conv``)."""
    return LATENT_C * (h // 16) * (w // 16) <= DENSE_LATENT_MAX


class VAEHRNet(HRNet):
    """HRNet behind a conditional VAE latent (hrnet.py:1061-1152).

    ``forward(rgb, seg, gt_rgb=None, gt_seg=None, train=False,
    generator=None, noise=None)`` returns (rgb_out, seg_out, mu, logvar).
    In extrapolation (``syn_type="extra"``; the plain VAE under ExtraNet)
    the heads are ``(4 if inpaint_mask else 3) * p`` and ``20 * p`` wide
    for ``num_pred_once`` = p frames, rgb_out keeps the first ``3 * p``
    channels and no mask is made (hrnet.py:1140-1152); conv1 takes the
    decoder's 32 channels and 7 per input frame (``n_frames``), the
    posterior encoder the input and ground-truth frames' rgb and seg.
    Train: (inputs, ground truth) are encoded to (mu, logvar) and z = mu +
    eps * exp(logvar / 2); eval: z ~ N(0, I) of shape (B, H/16 * W/16 * 16)
    (Dense latent) or (B, H/16, W/16, 16) (spatial), and mu, logvar are
    None.  eps and z are drawn from ``generator`` on the input's device in
    f32, cast to the latent's dtype, where the JAX module draws from its
    ``noise`` rng; ``noise`` hands in the draw instead.  The BatchNorms
    follow ``train``.  The latent heads are built for ``size`` (the train
    size); a loaded ``state_dict`` brings its own (a model trained at
    128x128 serves at 512x1024, where eval needs none), as the JAX tree is
    replaced whole on load."""

    vae = True

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 use_kernels: bool = True, highres_large: bool = False,
                 size: Tuple[int, int] = (128, 128), remat: bool = False,
                 syn_type: str = "inter", num_pred_once: int = 1,
                 inpaint_mask: bool = False, n_frames: int = N_FRAMES):
        super().__init__(dtype, use_kernels, highres_large,
                         in_ch=VAE_FEAT + (3 + 4) * n_frames,
                         syn_type=syn_type, num_pred_once=num_pred_once,
                         inpaint_mask=inpaint_mask, remat=remat)
        n_out = num_pred_once if syn_type == "extra" else 1
        self.vae_encoder = _VAEEncoder(
            (RGB_DIM + SEG_DIM) * (n_frames + n_out))
        self.vae_decoder = _VAEDecoder()
        h, w = size
        self._latent_heads(LATENT_C * (h // 16) * (w // 16)
                           if dense_latent(h, w) else None)
        self.register_load_state_dict_pre_hook(self._heads_of_state)

    def _latent_heads(self, n: Optional[int], device=None) -> None:
        """Dense heads of a latent of ``n``, or the 1x1 conv heads for
        None."""
        for name in ("mu_fc", "logvar_fc", "mu_conv", "logvar_conv"):
            if hasattr(self, name):
                delattr(self, name)
        if n is not None:
            self.mu_fc, self.logvar_fc = Dense(n, n), Dense(n, n)
        else:
            self.mu_conv = Conv(LATENT_C, LATENT_C, 1, padding=0)
            self.logvar_conv = Conv(LATENT_C, LATENT_C, 1, padding=0)
        if device is not None:
            self.to(device)

    def _heads_of_state(self, module, state_dict, prefix, *args) -> None:
        """Rebuild the latent heads as the loaded state holds them."""
        key = f"{prefix}mu_fc.weight"
        n = state_dict[key].shape[0] if key in state_dict else None
        have = self.mu_fc.weight.shape[0] if hasattr(self, "mu_fc") else None
        if n != have:
            self._latent_heads(n, self.conv1.weight.device)

    def forward(self, rgb: torch.Tensor, seg: torch.Tensor,
                gt_rgb: Optional[torch.Tensor] = None,
                gt_seg: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        b, h, w, _ = rgb.shape
        zh, zw = h // 16, w // 16
        dense = dense_latent(h, w)
        dt = self.dtype
        mu = logvar = None
        if train:
            if gt_rgb is None or gt_seg is None:
                raise ValueError("VAEHRNet trains on the ground truth: pass "
                                 "gt_rgb and gt_seg")
            e = self.vae_encoder(torch.cat([rgb, seg, gt_rgb, gt_seg], -1),
                                 True, dt)
            if dense:
                e = e.reshape(b, -1)      # NHWC order, as flax flattens
                mu, logvar = self.mu_fc(e, dt), self.logvar_fc(e, dt)
            else:
                mu, logvar = self.mu_conv(e), self.logvar_conv(e)
            eps = noise if noise is not None else dist.global_draw(
                lambda s: torch.randn(s, generator=generator,
                                      device=mu.device), mu.shape)
            z = mu + eps.reshape(mu.shape).to(mu.dtype) * torch.exp(
                0.5 * logvar)
        else:
            shape = (b, zh, zw, LATENT_C) if not dense else (
                b, LATENT_C * zh * zw)
            z = noise if noise is not None else dist.global_draw(
                lambda s: torch.randn(s, generator=generator,
                                      device=rgb.device), shape)
            z = z.to(dt)
        feat = self.vae_decoder(z.reshape(b, zh, zw, LATENT_C), train, dt)
        x = _encode_inputs(rgb, seg, self.seg_encoder, dt)
        x = torch.cat([feat.to(x.dtype), x], dim=-1)
        rgb_out, seg_out = self._apply_heads(self._backbone(x))
        if self.syn_type == "extra":
            rgb_out = rgb_out[..., :3 * self.num_pred_once]
        return rgb_out, seg_out, mu, logvar
