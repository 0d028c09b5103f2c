"""Fixed-shape crop-resize and paste-back of box patches (counterpart of
ops/roi.py).

``crop_resize`` samples every (y1, x1, y2, x2) box (pixel coordinates,
inclusive, as the reference's ``img[y1:y2+1, x1:x2+1]``) on a fixed
(ph, pw) grid by bilinear interpolation with align_corners=True, the
reference's crop + ``F.interpolate``: one gather over a static (B, N) box
grid.  ``paste_patches`` is its inverse: each canvas pixel inside a box
samples the box's patch bilinearly, later boxes overwriting earlier ones
(the reference's sequential paste loop, nets/TrackGen.py:128-179).  The
JAX package computes both in XLA, not in a Pallas kernel; here they are
plain PyTorch on the CPU and on the card alike.
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


def paste_patches(canvas: torch.Tensor, patches: torch.Tensor,
                  boxes: torch.Tensor) -> torch.Tensor:
    """canvas (B, H, W, C); patches (B, N, ph, pw, C); boxes (B, N, 4)
    (y1, x1, y2, x2), inclusive.  Returns the canvas with each box's pixels
    replaced by its patch resized bilinearly onto the box (roi.py:79-125),
    box k over boxes before it.  Differentiable in the canvas and the
    patches, not in the boxes; the weights are rounded to the patches'
    dtype, as there."""
    b, h, w, _ = canvas.shape
    n, ph, pw, c = patches.shape[1:]
    dev = canvas.device
    ii = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    jj = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    bi = torch.arange(b, device=dev)[:, None, None]
    boxes = boxes.detach().float()
    out = canvas
    for k in range(n):
        y1, x1, y2, x2 = (t[:, None, None] for t in boxes[:, k].unbind(-1))
        hh = torch.clamp(y2 - y1, min=1e-6)
        ww = torch.clamp(x2 - x1, min=1e-6)
        inside = (ii >= y1) & (ii <= y2) & (jj >= x1) & (jj <= x2)
        u = ((ii - y1) / hh * (ph - 1)).expand(b, h, w).clamp(0, ph - 1)
        v = ((jj - x1) / ww * (pw - 1)).expand(b, h, w).clamp(0, pw - 1)
        u0, v0 = torch.floor(u), torch.floor(v)
        tu = (u - u0)[..., None].to(patches.dtype)
        tv = (v - v0)[..., None].to(patches.dtype)
        u0i = u0.long().clamp(0, ph - 1)
        u1i = (u0i + 1).clamp(0, ph - 1)
        v0i = v0.long().clamp(0, pw - 1)
        v1i = (v0i + 1).clamp(0, pw - 1)
        flat = patches[:, k].reshape(b, ph * pw, c)

        def g(ui, vi):
            return flat[bi, ui * pw + vi]                       # (B,H,W,C)

        val = (g(u0i, v0i) * (1 - tu) * (1 - tv) + g(u0i, v1i) * (1 - tu) * tv
               + g(u1i, v0i) * tu * (1 - tv) + g(u1i, v1i) * tu * tv)
        out = torch.where(inside[..., None], val, out)
    return out
