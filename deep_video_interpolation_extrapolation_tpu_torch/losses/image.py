"""Image losses and metrics, NHWC (counterpart of losses/image.py:21-122).

The reference's value conventions (SSIM window 11, sigma 1.5, C1/C2; PSNR
averaged per sample; IoU as pixel accuracy) and the JAX functions' dtypes:
the gaussian blur runs in its input's dtype, ``log_softmax`` in the
logits' dtype, and the cross-entropy's target term is a one-hot
contraction, not a gather.

On a band of a spatial group (``parallel/spatial.banded``) each loss and
metric is the band's share of its global value (``spatial.mean``: the
band's sum over the global count), the SSIM blur reads 5 rows of each
neighbouring band and GDL the first row of the band below, so the shares
of a group sum to the unsharded value; PSNR completes each image's squared
error over the group first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deep_video_interpolation_extrapolation_tpu_torch.parallel import spatial


def _gaussian_window(window_size: int, sigma: float) -> torch.Tensor:
    xs = torch.arange(window_size, dtype=torch.float32) - window_size // 2
    g = torch.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _depthwise_blur(x: torch.Tensor, window_size: int,
                    sigma: float) -> torch.Tensor:
    """Separable gaussian with zero padding window // 2 (the reference's
    grouped 2-D conv), accumulated tap by tap in x's dtype; on a band the
    rows above and below are the neighbouring bands' (``spatial.halo``)."""
    g = _gaussian_window(window_size, sigma).to(device=x.device,
                                                dtype=x.dtype)
    pad = window_size // 2
    h, w = x.shape[1], x.shape[2]
    xh = spatial.halo(x, pad, pad)
    out = torch.zeros_like(x)
    for i in range(window_size):
        out = out + g[i] * xh[:, i:i + h]
    xw = F.pad(out, (0, 0, pad, pad))
    out2 = torch.zeros_like(x)
    for i in range(window_size):
        out2 = out2 + g[i] * xw[:, :, i:i + w]
    return out2


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, size_average: bool = True) -> torch.Tensor:
    """SSIM with the reference's constants, NHWC in [0, 1]."""
    def blur(t):
        return _depthwise_blur(t, window_size, sigma)
    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blur(img1 * img1) - mu1_sq
    sigma2_sq = blur(img2 * img2) - mu2_sq
    sigma12 = blur(img1 * img2) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    if size_average:
        return spatial.mean(ssim_map)
    if spatial.current() is not None:
        raise NotImplementedError(
            "per-image SSIM on a band is not ported yet (ROADMAP.md queue 1, "
            "item 10)")
    return ssim_map.mean(dim=(1, 2, 3))


def ssim_loss(img1: torch.Tensor, img2: torch.Tensor, **kw) -> torch.Tensor:
    """1 - ssim, the training form; on a band the share of both terms."""
    return spatial.share(1.0) - ssim(img1, img2, **kw)


def psnr(pred: torch.Tensor, gt: torch.Tensor,
         max_level: float = 1.0) -> torch.Tensor:
    """Per-sample PSNR averaged over the batch; on a band each image's
    squared error summed over the group, and the band's share of the
    mean."""
    if pred.shape != gt.shape:
        raise ValueError(f"psnr: shapes {tuple(pred.shape)} and "
                         f"{tuple(gt.shape)} differ")
    dims = tuple(range(1, pred.dim()))
    if spatial.current() is None:
        mse = torch.square(pred - gt).mean(dim=dims)
    else:
        count = pred[0].numel() // pred.shape[1] * spatial.global_rows(
            pred.shape[1])
        mse = spatial.all_sum(torch.square(pred - gt).sum(dim=dims)) / count
    return spatial.share(
        (10.0 * torch.log10(max_level * max_level / mse)).mean())


def iou_accuracy(pred_ids: torch.Tensor, gt_ids: torch.Tensor) -> torch.Tensor:
    """The reference's 'IoU' is plain pixel accuracy."""
    return spatial.mean((pred_ids == gt_ids).float())


def gdl_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Gradient-difference loss: mean of |d/dx| and |d/dy| differences.
    On a band the H differences run into the band below (one fewer on the
    last band), over the global count B (H - 1) W C."""
    pw = pred[:, :, 1:] - pred[:, :, :-1]
    gw = gt[:, :, 1:] - gt[:, :, :-1]
    pe, ge = spatial.rows_below(pred), spatial.rows_below(gt)
    ph = pe[:, 1:] - pe[:, :-1]
    gh = ge[:, 1:] - ge[:, :-1]
    rows = spatial.global_rows(pred.shape[1]) - 1
    return (spatial.mean((pw - gw).abs())
            + spatial.mean((ph - gh).abs(), rows=rows)) / 2.0


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return spatial.mean((pred - gt).abs())


def cross_entropy_loss(logits: torch.Tensor,
                       target_ids: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over pixels; logits NHWC (classes last),
    integer ids NHW.  ``log_softmax`` in the logits' dtype, the target
    term by a one-hot contraction in that dtype."""
    logp = F.log_softmax(logits, dim=-1)
    oh = F.one_hot(target_ids.long(), logits.shape[-1]).to(logp.dtype)
    return spatial.mean(-(logp * oh).sum(dim=-1))
