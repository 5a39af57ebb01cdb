"""Batched luminance histogram equalization and the 5x multimodal offline
augmentation — port of ``cervical_tpu/ops/histeq.py``.

Reference: ``MultiModal Prediction/data_augmentation.py`` — per-image cv2
calls: YCrCb Y-channel ``equalizeHist`` (:11-57), horizontal/vertical flips
(:65-101), rotation (:110-144, with optional expanded canvas), 5x5 Gaussian
blur, resize (:206-279).  Here the family is batched on the images' device:
every image's 256-bin histogram comes from one ``bincount`` over the batch,
the CDF and LUT are (B, 256) tensors, and the rotations are one bilinear
gather (``ops/augment._gather_bilinear``).

Images are (B, H, W, 3) float tensors in [0, 255], as in JAX.  The
products that XLA contracts into fused multiply-adds when the JAX reference
runs on the CPU are ``_fma`` here (an f64 product and sum rounded once to
f32), so the Y channel, its integer bins and every LUT are the reference's
exactly, on the CPU and on the card.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from cervical_tpu_torch.ops.augment import (_const, _fma, _gather_bilinear,
                                            gaussian_blur)
from cervical_tpu_torch.ops.image import resize_bilinear


def rgb_to_ycrcb(rgb):
    """cv2 YCrCb (uint8-range floats): Y=0.299R+0.587G+0.114B,
    Cr=(R-Y)*0.713+128, Cb=(B-Y)*0.564+128."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = _fma(_const(0.114, b), b,
             _fma(_const(0.299, r), r, _const(0.587, g) * g))
    cr = _fma(r - y, _const(0.713, r), _const(128.0, r))
    cb = _fma(b - y, _const(0.564, b), _const(128.0, b))
    return torch.stack([y, cr, cb], dim=-1)


def ycrcb_to_rgb(ycrcb):
    y, cr, cb = ycrcb[..., 0], ycrcb[..., 1], ycrcb[..., 2]
    dr, db = cr - 128.0, cb - 128.0
    r = _fma(_const(1.403, y), dr, y)
    g = _fma(_const(-0.344, y), db, _fma(_const(-0.714, y), dr, y))
    b = _fma(_const(1.773, y), db, y)
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)


def _bins(channels):
    """(B, H, W) uint8-range floats -> (B, H*W) int64 bins."""
    return torch.clamp(torch.round(channels.reshape(channels.shape[0], -1)),
                       0, 255).long()


def equalize_luts(channels):
    """cv2.equalizeHist's LUT for each (H, W) channel of a (B, H, W) batch:
    (histograms (B, 256) int64, LUTs (B, 256) f32).

    ``lut[i] = round((cdf(i) - cdf_min) / (total - cdf_min) * 255)`` in
    f32, ``cdf_min`` the cdf at the first occupied bin; a channel with one
    occupied bin (constant) maps to itself (OpenCV histogram.cpp's early
    ``hist[i] == total`` exit)."""
    flat = _bins(channels)
    b, total = flat.shape
    idx = torch.arange(b, device=flat.device)[:, None]
    hist = torch.bincount((flat + 256 * idx).reshape(-1),
                          minlength=256 * b).reshape(b, 256)
    cdf = torch.cumsum(hist, dim=1)
    cdf_min = torch.where(hist > 0, cdf,
                          torch.full_like(cdf, total + 1)).amin(1, True)
    denom = torch.clamp(total - cdf_min, min=1).to(torch.float32)
    lut = torch.round((cdf - cdf_min).to(torch.float32) / denom * 255.0)
    lut = torch.clamp(lut, 0.0, 255.0)
    ident = torch.arange(256, dtype=torch.float32, device=flat.device)
    lut = torch.where(cdf_min >= total, ident.expand_as(lut), lut)
    return hist, lut


def equalize_hist_channel(channel):
    """cv2.equalizeHist on one (H, W) uint8-range channel."""
    return equalize_hist_batch(channel[None])[0]


def equalize_hist_batch(channels):
    """:func:`equalize_hist_channel` on each (H, W) of a (B, H, W) batch."""
    _, lut = equalize_luts(channels)
    return torch.gather(lut, 1, _bins(channels)).reshape(channels.shape)


def equalize_histogram_batch(images):
    """Y-channel histogram equalization in YCrCb for a batch (B, H, W, 3)
    (``equalize_histogram_image``, data_augmentation.py:11-57).  RGB float
    in and out, in [0, 255].

    The way back to RGB is :func:`ycrcb_to_rgb` of ``(y_eq, Cr, Cb)`` as XLA
    simplifies it in the one jitted program: ``Cr - 128`` is ``(R - Y) *
    0.713``, each chroma product folds into one f32 constant (``1.403 *
    0.713`` ...), and the products fuse onto ``y_eq``."""
    x = images.to(torch.float32)
    y = rgb_to_ycrcb(x)[..., 0]
    y_eq = equalize_hist_batch(y)
    dr, db = x[..., 0] - y, x[..., 2] - y
    k = {name: _const(v, y) for name, v in _FOLDED.items()}
    r = _fma(dr, k["r"], y_eq)
    g = _fma(-db, k["gb"], _fma(-dr, k["gr"], y_eq))
    b = _fma(db, k["b"], y_eq)
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)


# ycrcb_to_rgb's gains times rgb_to_ycrcb's chroma scales, each product
# rounded to f32 (XLA's constant folding)
_FOLDED = {name: float(torch.tensor(a) * torch.tensor(b)) for name, (a, b) in
           {"r": (1.403, 0.713), "gr": (0.714, 0.713), "gb": (0.344, 0.564),
            "b": (1.773, 0.564)}.items()}


def flip_horizontal(images):
    """cv2.flip(img, 1) batched (data_augmentation.py:78)."""
    return torch.flip(images, dims=(-2,))


def flip_vertical(images):
    """cv2.flip(img, 0) batched (data_augmentation.py:81)."""
    return torch.flip(images, dims=(-3,))


def _cos_sin(angles_deg, device):
    """cos and sin of the f32 ``angles_deg * f32(pi / 180)`` (jnp.deg2rad's
    rounding), each rounded once to f32 from f64 on the host."""
    a = torch.as_tensor(angles_deg, dtype=torch.float32).cpu()
    theta = (a * _const(math.pi / 180.0, a)).double()
    return (torch.cos(theta).to(device, torch.float32),
            torch.sin(theta).to(device, torch.float32))


def _grid(h, w, device):
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return yy.expand(h, w), xx.expand(h, w)


def _source(c, s, dx, dy, h, w):
    """Source coords ``(s dx + c dy + h // 2, c dx - s dy + w // 2)``, the
    products fused as XLA:CPU fuses them."""
    return (_fma(s, dx, c * dy) + float(h // 2),
            _fma(c, dx, -(s * dy)) + float(w // 2))


def rotate_coords(h: int, w: int, angles_deg, device=None):
    """(ys, xs), each (B, h, w): the source pixel of every output pixel of
    :func:`rotate_batch` (``_rotate_coords``, data_augmentation.py:117-130).
    getRotationMatrix2D rotates CCW by angle; the inverse map rotates
    output pixels CW by angle."""
    c, s = (t[:, None, None] for t in _cos_sin(angles_deg, device))
    yy, xx = _grid(h, w, device)
    return _source(c, s, xx - float(w // 2), yy - float(h // 2), h, w)


def expand_coords(h: int, w: int, angles_deg, out_hw: Tuple[int, int],
                  device=None):
    """(ys, xs), each (B, oh, ow): the source pixel of every output pixel of
    :func:`rotate_expand_batch` — output pixel -> expanded-canvas pixel
    (XLA multiplies by the reciprocal of the constant divisor) -> source,
    the inverse rotation about the source centre after the expand
    translation."""
    oh, ow = out_hw
    c, s = (t[:, None, None] for t in _cos_sin(angles_deg, device))
    cos_a, sin_a = c.abs(), s.abs()
    nw = _fma(_const(h, c), sin_a, w * cos_a)
    nh = _fma(_const(h, c), cos_a, w * sin_a)
    yy, xx = _grid(oh, ow, device)
    half = _const(-0.5, c)
    ex = _fma(xx + 0.5, nw * _const(1.0 / ow, c), half)
    ey = _fma(yy + 0.5, nh * _const(1.0 / oh, c), half)
    return _source(c, s, ex - nw * 0.5, ey - nh * 0.5, h, w)


def rotate_batch(images, angles_deg):
    """Rotate each image about its integer centre ``(h // 2, w // 2)``, same
    canvas, black border — ``cv2.warpAffine(img, getRotationMatrix2D(
    center, angle, 1.0), (w, h))`` (data_augmentation.py:236-240).
    ``images``: (B, H, W, C) float; ``angles_deg``: (B,)."""
    _, h, w, _ = images.shape
    ys, xs = rotate_coords(h, w, angles_deg, images.device)
    return _gather_bilinear(images.to(torch.float32), ys, xs, 0.0,
                            fused=True)


def rotate_expand_batch(images, angles_deg, out_hw: Tuple[int, int]):
    """Expanded-canvas rotation resampled onto ``out_hw`` in one warp.

    The reference's ``rotate_image`` (data_augmentation.py:110-130) grows
    the canvas to ``(h sin + w cos, h cos + w sin)`` and the multimodal
    images are resized to a fixed square right after
    (Graph_Structure:151-161): both in one gather, as in JAX."""
    _, h, w, _ = images.shape
    ys, xs = expand_coords(h, w, angles_deg, out_hw, images.device)
    return _gather_bilinear(images.to(torch.float32), ys, xs, 0.0,
                            fused=True)


def resize_batch(images, out_hw: Tuple[int, int]):
    """Batched bilinear resize (cv2.resize's INTER_LINEAR, half-pixel)."""
    return resize_bilinear(images.to(torch.float32), out_hw,
                           align_corners=False)


def fivefold_augment(images, angles_deg: Optional[torch.Tensor] = None):
    """The 5x multimodal augmentation set: [equalized original, h-flip,
    v-flip, blur, rotate] (data_augmentation.py:206-279; the 5x factor of
    README.md:10).  ``images``: (B, H, W, 3) RGB in [0, 255]; rotates by
    45 degrees where ``angles_deg`` is None.  Returns (5, B, H, W, 3)."""
    eq = equalize_histogram_batch(images)
    if angles_deg is None:
        angles_deg = torch.full((images.shape[0],), 45.0)
    return torch.stack([eq, flip_horizontal(eq), flip_vertical(eq),
                        gaussian_blur(eq), rotate_batch(eq, angles_deg)])
