r"""Batched train-time augmentation: the gather oracle — port of
``cervical_tpu/ops/augment.py``.

The reference's per-image PIL/cv2 chain
(``Segmentation/deeplabv3+/utils/dataloader.py:55-154``) as one inverse
warp per output pixel (aspect-jitter resize, flip, paste on gray, rotation;
bilinear image, nearest label), then the 5x5 Gaussian blur (REFLECT_101)
and the cv2-uint8-convention HSV gain jitter.  This is the semantics the
kernels of ``ops/warp.py`` implement another way; it is a reference, not
the train step's path.  Images are NHWC, as in JAX.

Parameters are a dict of (B,) tensors from :func:`sample_augment_params`,
drawn from an explicit ``torch.Generator`` with the JAX sampler's
distributions (the two frameworks' streams differ, so parity tests feed
both sides the same dict).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

GRAY_FILL = 128.0  # reference canvas/border fill (dataloader.py:106,130)


def _const(v: float, like):
    """``v`` as a 0-dim f32 tensor on ``like``'s device: ``_const(a, t) / t``
    is an IEEE division, where ``a / t`` multiplies by ``t``'s reciprocal."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _fma(a, b, c):
    """f32 ``a*b + c`` rounded once, as a fused multiply-add: the product
    of two f32 values is exact in f64."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


# ---------------------------------------------------------------------------
# Parameter sampling
# ---------------------------------------------------------------------------

def sample_augment_params(generator: torch.Generator, batch_size: int,
                          jitter=0.3, scale_range=(0.25, 2.0), hue=0.1,
                          sat=0.7, val=0.3, flip_p=0.5, blur_p=0.25,
                          rotate_p=0.25, max_rotation=10,
                          rotate_prefix: int | None = None,
                          blur_suffix: int | None = None):
    """Per-image augmentation parameters (dataloader.py:82-137), on the
    generator's device.

    ``rotate_prefix``: exactly the first K samples rotate instead of a
    Bernoulli(rotate_p) draw each; ``blur_suffix``: exactly the last K
    blur.  The loader shuffles batch contents, so each image's marginal
    rates stay K/B.  Returns a dict of (B,)-shaped tensors ((B, 3) gains).
    """
    g = generator
    dev = g.device
    b = batch_size

    def u(lo, hi, shape=(b,)):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    ar_jitter = u(1 - jitter, 1 + jitter) / u(1 - jitter, 1 + jitter)
    scale = u(*scale_range)
    flip = torch.rand(b, generator=g, device=dev) < flip_p
    dx_frac = u(0.0, 1.0)
    dy_frac = u(0.0, 1.0)
    ar = torch.arange(b, device=dev)
    if blur_suffix is None:
        blur = torch.rand(b, generator=g, device=dev) < blur_p
    else:
        blur = ar >= b - blur_suffix
    if rotate_prefix is None:
        rot_draw = torch.rand(b, generator=g, device=dev) < rotate_p
    else:
        rot_draw = ar < rotate_prefix
    angle = torch.randint(-max_rotation, max_rotation + 1, (b,), generator=g,
                          device=dev).to(torch.float32)
    angle = torch.where(rot_draw, angle, torch.zeros_like(angle))
    gains = u(-1.0, 1.0, (b, 3)) * torch.tensor([hue, sat, val],
                                                device=dev) + 1.0
    return {
        "ar_jitter": ar_jitter, "scale": scale, "flip": flip,
        "dx_frac": dx_frac, "dy_frac": dy_frac, "blur": blur,
        "angle": angle, "gains": gains,
    }


# the columns of a parameter row (params_to_rows): one f32 per image each,
# the gains last
PARAM_COLUMNS = ("ar_jitter", "scale", "flip", "dx_frac", "dy_frac", "blur",
                 "angle")
NUM_PARAM_COLUMNS = len(PARAM_COLUMNS) + 3


def params_to_rows(params) -> torch.Tensor:
    """A parameter dict of (..., B) tensors ((..., B, 3) gains) -> one
    (..., B, 10) float32 tensor, so a step's (or K steps') parameters
    upload in one copy.  Exact: every value is an f32 or a 0/1 flag."""
    cols = [params[k].to(torch.float32)[..., None] for k in PARAM_COLUMNS]
    return torch.cat(cols + [params["gains"].to(torch.float32)], dim=-1)


def rows_to_params(rows) -> dict:
    """The inverse of :func:`params_to_rows` (views and two compares, on
    the rows' device)."""
    p = {k: rows[..., i] for i, k in enumerate(PARAM_COLUMNS)}
    p["flip"] = p["flip"] > 0
    p["blur"] = p["blur"] > 0
    p["gains"] = rows[..., len(PARAM_COLUMNS):]
    return p


def letterbox_params_like(batch_size: int, src_hw, dst_hw, device=None):
    """Deterministic parameters reproducing the eval letterbox path."""
    ih, iw = src_hw
    h, w = dst_hw
    scale = min(w / iw, h / ih)
    b = batch_size
    return {
        "ar_jitter": torch.full((b,), iw / ih, device=device),
        "scale": torch.full((b,), scale, device=device),
        "flip": torch.zeros(b, dtype=torch.bool, device=device),
        "dx_frac": torch.full((b,), 0.5, device=device),
        "dy_frac": torch.full((b,), 0.5, device=device),
        "blur": torch.zeros(b, dtype=torch.bool, device=device),
        "angle": torch.zeros(b, device=device),
        "gains": torch.ones(b, 3, device=device),
        "letterbox": True,
    }


# ---------------------------------------------------------------------------
# Geometric warp
# ---------------------------------------------------------------------------

def _resized_dims(params, src_hw, dst_hw, letterbox: bool):
    """Resized (nh, nw) f32 (B,) following dataloader.py:82-89 (train) /
    :65-68 (eval)."""
    ih, iw = src_hw
    h, w = dst_hw
    if letterbox:
        scale = min(w / iw, h / ih) * torch.ones_like(params["scale"])
        return torch.floor(ih * scale), torch.floor(iw * scale)
    new_ar = (iw / ih) * params["ar_jitter"]
    scale = params["scale"]
    # if new_ar < 1: nh = scale*h; nw = nh*new_ar  else nw = scale*w; nh = nw/new_ar
    nh_a = torch.floor(scale * h)
    nw_a = torch.floor(nh_a * new_ar)
    nw_b = torch.floor(scale * w)
    nh_b = torch.floor(nw_b / new_ar)
    nh = torch.where(new_ar < 1, nh_a, nh_b)
    nw = torch.where(new_ar < 1, nw_a, nw_b)
    return torch.clamp(nh, min=1.0), torch.clamp(nw, min=1.0)


def _paste_offsets(params, nh, nw, dst_hw, letterbox: bool):
    h, w = dst_hw
    if letterbox:
        return torch.floor((h - nh) / 2.0), torch.floor((w - nw) / 2.0)
    # reference: dx = int(rand(0, w - nw)); w - nw < 0 for scale > 1 gives a
    # negative offset
    return (torch.floor(params["dy_frac"] * (h - nh)),
            torch.floor(params["dx_frac"] * (w - nw)))


def _source_coords(params, src_hw, dst_hw, letterbox: bool):
    """Source coordinates (ys, xs), each (B, h, w) f32, of every output
    pixel: undo the rotation about the canvas center, the paste offset, the
    horizontal flip and the resize, in that order."""
    ih, iw = src_hw
    h, w = dst_hw
    nh, nw = _resized_dims(params, src_hw, dst_hw, letterbox)
    dy, dx = _paste_offsets(params, nh, nw, dst_hw, letterbox)
    dev = nh.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]

    def col(t):
        return t[:, None, None]

    # cv2.getRotationMatrix2D(center, -rotation) rotates the image by
    # -rotation; inverse-map output pixels by +rotation
    theta = params["angle"] * (math.pi / 180.0)
    cx, cy = w // 2, h // 2
    cos_t, sin_t = col(torch.cos(theta)), col(torch.sin(theta))
    xr = cos_t * (xx - cx) - sin_t * (yy - cy) + cx
    yr = sin_t * (xx - cx) + cos_t * (yy - cy) + cy
    xp = xr - col(dx)
    yp = yr - col(dy)
    xp = torch.where(col(params["flip"]), (col(nw) - 1.0) - xp, xp)
    xs = (xp + 0.5) * (_const(iw, nw) / col(nw)) - 0.5
    ys = (yp + 0.5) * (_const(ih, nh) / col(nh)) - 0.5
    return ys, xs


def _in_bounds(ys, xs, ih, iw):
    return (xs >= -0.5) & (xs <= iw - 0.5) & (ys >= -0.5) & (ys <= ih - 0.5)


def _take(img, yi, xi):
    """img (B, H, W, C) at integer (B, h, w) coords -> (B, h, w, C)."""
    b = torch.arange(img.shape[0], device=img.device)[:, None, None]
    return img[b, yi, xi]


def _gather_bilinear(img, ys, xs, fill, fused: bool = False):
    """Bilinear sample of (B, H, W, C) at float coords; out of bounds ->
    ``fill``; edge taps clamp.  ``fused``: the four-term sum as XLA:CPU
    contracts it when the whole gather is one jitted program (the last
    three terms fused multiply-adds onto the second)."""
    _, ih, iw, _ = img.shape
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = (xs - x0)[..., None]
    fy = (ys - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()

    def tap(yi, xi):
        return _take(img, yi.clamp(0, ih - 1), xi.clamp(0, iw - 1))

    if fused:
        gx, gy = 1 - fx, 1 - fy
        out = _fma(tap(y0i + 1, x0i + 1) * fx, fy,
                   _fma(tap(y0i + 1, x0i) * gx, fy,
                        _fma(tap(y0i, x0i) * gx, gy,
                             tap(y0i, x0i + 1) * fx * gy)))
    else:
        out = (tap(y0i, x0i) * (1 - fx) * (1 - fy) + tap(y0i, x0i + 1) * fx * (1 - fy)
               + tap(y0i + 1, x0i) * (1 - fx) * fy + tap(y0i + 1, x0i + 1) * fx * fy)
    inb = _in_bounds(ys, xs, ih, iw)[..., None]
    return torch.where(inb, out, torch.full_like(out, fill))


def _gather_nearest(label, ys, xs, fill):
    """Nearest sample of (B, H, W) labels (round half to even)."""
    _, ih, iw = label.shape
    xi = torch.round(xs).long().clamp(0, iw - 1)
    yi = torch.round(ys).long().clamp(0, ih - 1)
    out = _take(label[..., None], yi, xi)[..., 0]
    return torch.where(_in_bounds(ys, xs, ih, iw), out,
                       torch.full_like(out, fill))


# ---------------------------------------------------------------------------
# Photometric ops
# ---------------------------------------------------------------------------

def _mod(x, m: float):
    """``jnp.mod``: the remainder takes the divisor's sign."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


def _select6(i, a0, a1, a2, a3, a4, a5):
    out = a5
    for k, a in ((4, a4), (3, a3), (2, a2), (1, a1), (0, a0)):
        out = torch.where(i == k, a, out)
    return out


def _rgb_to_hsv(r, g, b):
    """Three f32 planes in [0, 255] -> cv2 uint8-range (h, s, v)."""
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    delta = v - mn
    pos = delta > 0
    safe = torch.where(pos, delta, torch.ones_like(delta))
    h = torch.where(v == r, 60.0 * (g - b) / safe,
                    torch.where(v == g, 120.0 + 60.0 * (b - r) / safe,
                                240.0 + 60.0 * (r - g) / safe))
    h = torch.where(pos, h, torch.zeros_like(h))
    h = torch.where(h < 0, h + 360.0, h) * 0.5  # cv2 packs H/2 into uint8
    vpos = v > 0
    s = torch.where(vpos, 255.0 * delta / torch.where(vpos, v, torch.ones_like(v)),
                    torch.zeros_like(v))
    return h, s, v


def _hsv_to_rgb(h, s, v):
    """cv2 uint8-range (h, s, v) -> three planes, the sextant chosen by
    ``floor(h*2/60) % 6``.  ``s/255`` and ``h*2/60`` are products with the
    f32 reciprocals, as XLA rewrites a division by a constant."""
    hd = h * 2.0
    sf = s * _const(1.0 / 255.0, s)
    c = v * sf
    hp = hd * _const(1.0 / 60.0, hd)
    x = c * (1.0 - torch.abs(_mod(hp, 2.0) - 1.0))
    m = v - c
    z = torch.zeros_like(c)
    i = torch.floor(hp).to(torch.int32) % 6
    return (_select6(i, c, x, z, z, x, c) + m,
            _select6(i, x, c, c, x, z, z) + m,
            _select6(i, z, z, x, c, c, x) + m)


def _lut_gains(h, s, v, gh, gs, gv):
    """cv2-LUT gains on integer channel values; uint8 storage truncates."""
    h = torch.floor(_mod(torch.round(h) * gh, 180.0))
    s = torch.floor(torch.clamp(torch.round(s) * gs, 0.0, 255.0))
    v = torch.floor(torch.clamp(torch.round(v) * gv, 0.0, 255.0))
    return h, s, v


def rgb_to_hsv_cv2(rgb):
    """RGB [0,255] float (..., 3) -> cv2 uint8-range HSV (H in [0,180))."""
    return torch.stack(_rgb_to_hsv(rgb[..., 0], rgb[..., 1], rgb[..., 2]), -1)


def hsv_to_rgb_cv2(hsv):
    """Inverse of :func:`rgb_to_hsv_cv2` (cv2 uint8-range conventions)."""
    return torch.stack(_hsv_to_rgb(hsv[..., 0], hsv[..., 1], hsv[..., 2]), -1)


def hsv_jitter(rgb, gains):
    """cv2-LUT hue/sat/val gain jitter of one (..., 3) image with (3,)
    gains (dataloader.py:137-152), clipped to [0, 255]."""
    h, s, v = _rgb_to_hsv(rgb[..., 0], rgb[..., 1], rgb[..., 2])
    h, s, v = _lut_gains(h, s, v, gains[0], gains[1], gains[2])
    return torch.clamp(torch.stack(_hsv_to_rgb(h, s, v), -1), 0.0, 255.0)


def hsv_jitter_batched(rgb, gains):
    """:func:`hsv_jitter` over (B, H, W, 3) with (B, 3) gains."""
    x = rgb.to(torch.float32)
    h, s, v = _rgb_to_hsv(x[..., 0], x[..., 1], x[..., 2])
    gs = [gains[:, k][:, None, None] for k in range(3)]
    h, s, v = _lut_gains(h, s, v, *gs)
    return torch.clamp(torch.stack(_hsv_to_rgb(h, s, v), -1), 0.0, 255.0)


# cv2.getGaussianKernel's fixed binomial kernel for ksize 5, sigma <= 0
_GAUSS5 = (0.0625, 0.25, 0.375, 0.25, 0.0625)


def gaussian_blur(images):
    """Separable 5x5 Gaussian blur with true REFLECT_101 borders
    (cv2.GaussianBlur defaults; dataloader.py:118-120).  (B, H, W, C)."""
    b, h, w, c = images.shape
    k = torch.tensor(_GAUSS5, dtype=images.dtype, device=images.device)
    x = images.permute(0, 3, 1, 2).reshape(b * c, 1, h, w)
    x = F.pad(x, (2, 2, 2, 2), mode="reflect")
    x = F.conv2d(x, k.view(1, 1, 5, 1))
    x = F.conv2d(x, k.view(1, 1, 1, 5))
    return x.reshape(b, c, h, w).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------

def augment_batch(images, labels, params, dst_hw: Tuple[int, int],
                  letterbox: bool = False):
    """Apply the full augmentation to a batch.

    ``images`` (B, H, W, 3) uint8/float, ``labels`` (B, H, W) integer,
    ``params`` from :func:`sample_augment_params` (or the letterbox
    variant).  Returns (images (B, h, w, 3) f32 in [0, 255], labels
    (B, h, w)).  Blur comes before the HSV jitter, as in the reference
    (dataloader.py:118 then :137); the eval path has no jitter.
    """
    ys, xs = _source_coords(params, images.shape[1:3], dst_hw, letterbox)
    img = _gather_bilinear(images.to(torch.float32), ys, xs, GRAY_FILL)
    lbl = _gather_nearest(labels, ys, xs, 0)
    img = torch.where(params["blur"][:, None, None, None], gaussian_blur(img),
                      img)
    if not letterbox:
        img = hsv_jitter_batched(img, params["gains"])
    return img, lbl


# ---------------------------------------------------------------------------
# The einsum backend's photometric pieces (ops/warp_xla.py)
# ---------------------------------------------------------------------------

def hsv_jitter_batched_fast(rgb, gains, scale: float = 1.0):
    """The closed form of :func:`hsv_jitter_batched` that the einsum backend
    runs: the same cv2-LUT quantization, the RGB reconstruction as
    ``ch(n) = v' - c * clip(min(k, 4 - k), 0, 1)`` with ``k = (n + h'/30)
    mod 6`` and n = 5/3/1 for R/G/B, each channel scaled by ``scale`` and
    cast to bf16 before the stack.  (B, H, W, 3) with (B, 3) gains -> bf16
    in ``[0, 255*scale]``.

    The hue keeps the division order ``60*(x)/safe``: a hoisted reciprocal
    rounds differently in f32, and the integer hue quantization turns a
    half-count flip into a 2-degree hue step.  The products with 1/30 and
    1/255 are the f32 reciprocals, as in the JAX function; ``n + h'/30``
    and ``v - c*t`` are fused multiply-adds, as XLA compiles them (each
    unfused form differs from the JAX function on ~1e-3 of the elements)."""
    x = rgb.to(torch.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    h, s, v = _rgb_to_hsv(r, g, b)
    gs = [gains[:, k][:, None, None].to(torch.float32) for k in range(3)]
    h, s, v = _lut_gains(h, s, v, *gs)
    inv30 = _const(1.0 / 30.0, h)  # h/30 == (2h)/60, the sector coordinate
    c = v * (s * _const(1.0 / 255.0, s))
    sc = _const(scale, v)

    def ch(n):
        k = _mod(_fma(h, inv30, torch.full_like(h, n)), 6.0)
        t = torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)
        out = torch.clamp(_fma(-c, t, v), 0.0, 255.0)
        return (out * sc).to(torch.bfloat16)

    return torch.stack([ch(5.0), ch(3.0), ch(1.0)], dim=-1)


def _blur_matrix_np(size: int):
    """(size, size) banded matrix of the 5-tap binomial with REFLECT_101
    borders: ``m @ x`` blurs along ``x``'s first axis."""
    import numpy as np
    m = np.zeros((size, size), np.float32)
    for o in range(size):
        for t, k in enumerate(_GAUSS5):
            i = o + t - 2
            if i < 0:
                i = -i
            if i >= size:
                i = 2 * size - 2 - i
            m[o, i] += k
    return m


_BLUR_MATRICES: dict = {}


def _blur_matrix(size: int, dtype, device):
    """:func:`_blur_matrix_np` as a tensor on ``device``, uploaded once per
    (size, dtype, device): a train step captured in a CUDA graph may make
    no host-to-card copy, so the first (warm-up) call fills the cache."""
    key = (size, dtype, str(torch.device(device)))
    m = _BLUR_MATRICES.get(key)
    if m is None:
        m = torch.from_numpy(_blur_matrix_np(size)).to(device, dtype)
        _BLUR_MATRICES[key] = m
    return m


def gaussian_blur_einsum(images):
    """The separable 5x5 binomial blur (REFLECT_101) as two einsums against
    banded matrices, in ``images``' dtype (B, H, W, C): each output is a
    5-tap convex combination, so bf16 keeps it within one count."""
    h, w = images.shape[1], images.shape[2]
    mh = _blur_matrix(h, images.dtype, images.device)
    mw = _blur_matrix(w, images.dtype, images.device)
    x = torch.einsum("oi,biwc->bowc", mh, images)
    return torch.einsum("pw,bhwc->bhpc", mw, x)
