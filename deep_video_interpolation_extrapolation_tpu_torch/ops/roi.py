"""Fixed-shape crop-resize of box patches (counterpart of ops/roi.py).

``crop_resize`` samples every (y1, x1, y2, x2) box (pixel coordinates,
inclusive, as the reference's ``img[y1:y2+1, x1:x2+1]``) on a fixed
(ph, pw) grid by bilinear interpolation with align_corners=True, the
reference's crop + ``F.interpolate``: one gather over a static (B, N) box
grid.  The JAX package computes it in XLA, not in a Pallas kernel; here it
is plain PyTorch on the CPU and on the card alike.  ``paste_patches``, the
inverse, waits for TrackGen (ROADMAP.md queue 1, item 5).
"""

from __future__ import annotations

import torch


def crop_resize(img: torch.Tensor, boxes: torch.Tensor,
                out_size=(64, 64)) -> torch.Tensor:
    """img (B, H, W, C); boxes (B, N, 4) (y1, x1, y2, x2).  Returns (B, N,
    ph, pw, C) patches in img's dtype.  Rows and columns past the image
    are clamped to its edge, as roi.py:23-50 clamps its gather indices."""
    b, h, w, _ = img.shape
    ph, pw = out_size
    boxes = boxes.float()
    y1, x1, y2, x2 = boxes.unbind(-1)                          # (B, N)
    ys = y1[..., None] + torch.linspace(0.0, 1.0, ph, device=img.device) \
        * (y2 - y1)[..., None]                                   # (B, N, ph)
    xs = x1[..., None] + torch.linspace(0.0, 1.0, pw, device=img.device) \
        * (x2 - x1)[..., None]                                   # (B, N, pw)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    ty = (ys - y0)[..., :, None, None].to(img.dtype)
    tx = (xs - x0)[..., None, :, None].to(img.dtype)
    y0i = y0.long().clamp(0, h - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    x0i = x0.long().clamp(0, w - 1)
    x1i = (x0i + 1).clamp(0, w - 1)
    bi = torch.arange(b, device=img.device)[:, None, None, None]

    def gather(yi, xi):
        return img[bi, yi[..., :, None], xi[..., None, :]]       # (B,N,ph,pw,C)

    return (gather(y0i, x0i) * (1 - ty) * (1 - tx)
            + gather(y0i, x1i) * (1 - ty) * tx
            + gather(y1i, x0i) * ty * (1 - tx)
            + gather(y1i, x1i) * ty * tx)
