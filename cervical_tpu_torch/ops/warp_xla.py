"""The einsum formulation of the augmentation warp — port of
``cervical_tpu/ops/warp_xla.py``, the JAX package's default train-time
augmentation backend (``SegDataConfig.aug_backend="einsum"``) and the eval
step's letterbox.

* The separable resample (scale, flip, paste, gray fill) is two batched
  products against per-image (B, out, in) interpolation matrices: bf16
  matrices and outputs, or with ``int8_resample`` 127-scaled integer taps,
  the images quantised to uint8 between the two passes, labels exact.
* The rotation is the Paeth 3-shear (or with ``two_shear`` the 2-shear
  approximation) on four uint8 planes, RGB and the label, per image and row
  (or column) with the float shift ``s``: ``u = clip(floor(s), -m, m-1)``,
  the cyclic take ``y[i] = x[(i - u) mod size]``, ``y_next[i] = y[i-1]``,
  ``w = round((s - floor(s)) * 256)``, then ``(y*(256-w) + y_next*w + 128)
  >> 8`` on the image bytes and ``w >= 128 ? y_next : y`` on the label byte,
  with the fill ``(128, 128, 128, 0)`` where ``-0.5 <= i - s <= size - 0.5``
  fails.  This is what the JAX package's packed uint32 barrel ladders
  (``_rotate_packed``, ``_barrel_shift_packed``, ``_barrel_shift_u8``)
  compute; the port takes each shear with one ``torch.gather`` per shear
  instead, bit-exact.  Their ``radix4`` option is another lowering of the
  same output and has no counterpart here.
* The 5x5 blur on a suffix of the batch (two banded-matrix einsums) comes
  before the closed-form cv2 HSV jitter, as in the reference chain.

These are batched products, gathers and elementwise passes outside any TPU
kernel, so they go to ``torch.einsum`` and tensor ops.  Rounding follows
XLA as the JAX reference runs on the CPU: ``a*o + b`` fused (``_fma``),
divisions by constants as products with the f32 reciprocal.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from cervical_tpu_torch.ops.augment import (_const, _fma,
                                            gaussian_blur_einsum,
                                            hsv_jitter_batched_fast)
from cervical_tpu_torch.ops.warp import (P_AX, P_AY, P_BX, P_BY, P_FILL,
                                         P_SINT, P_TANH, make_warp_params)

MAX_ANGLE_DEG = 10.0


def _interp_matrices(a, b, out_size: int, in_size: int, nearest: bool):
    """Batched (B, out, in) bf16 2-tap interpolation weights and the (B,
    out) f32 in-bounds mask, built as the kernels' taps: the weights are
    rounded to bf16 after the two taps are combined."""
    o = torch.arange(out_size, dtype=torch.float32, device=a.device)
    i = torch.arange(in_size, device=a.device)[None, None, :]
    src = _fma(a[:, None], o, b[:, None])[..., None]              # (B,O,1)
    inb = ((src >= -0.5) & (src <= in_size - 0.5)).to(torch.float32)
    if nearest:
        idx = torch.clamp(torch.round(src), 0, in_size - 1).long()
        w = (i == idx).to(torch.float32)
    else:
        y0 = torch.floor(src)
        f = src - y0
        i0 = torch.clamp(y0, 0, in_size - 1).long()
        i1 = torch.clamp(y0 + 1.0, 0, in_size - 1).long()
        w = (i == i0).to(torch.float32) * (1.0 - f) \
            + (i == i1).to(torch.float32) * f
    return (w * inb).to(torch.bfloat16), inb[..., 0]


def _interp_matrices_i8(a, b, out_size: int, in_size: int, nearest: bool):
    """The integer taps of ``int8_resample``, as f32 (B, out, in): bilinear
    ``127 - w1`` and ``w1 = round(f * 127)`` (a clamped pair collides onto
    one entry and still sums to 127), nearest a one-hot row; 0 out of
    bounds.  And the (B, out) f32 in-bounds mask."""
    o = torch.arange(out_size, dtype=torch.float32, device=a.device)
    i = torch.arange(in_size, device=a.device)[None, None, :]
    src = _fma(a[:, None], o, b[:, None])[..., None]              # (B,O,1)
    inb = (src >= -0.5) & (src <= in_size - 0.5)
    if nearest:
        idx = torch.clamp(torch.round(src), 0, in_size - 1).long()
        w = ((i == idx) & inb).to(torch.float32)
    else:
        y0 = torch.floor(src)
        f = src - y0
        i0 = torch.clamp(y0, 0, in_size - 1).long()
        i1 = torch.clamp(y0 + 1.0, 0, in_size - 1).long()
        w1 = torch.round(f * 127.0)
        w = (i == i0) * (127.0 - w1) + (i == i1) * w1
        w = torch.where(inb, w, torch.zeros_like(w))
    return w, inb[..., 0].to(torch.float32)


def _resample(images, wp, out_size: int, nearest: bool, fill):
    """(B, H, W, C) -> (B, S, S, C) bf16 via two batched products with
    bf16 outputs, each plus its fill."""
    _, ih, iw, _ = images.shape
    wy, inb_y = _interp_matrices(wp[:, P_AY], wp[:, P_BY], out_size, ih,
                                 nearest)
    wx, inb_x = _interp_matrices(wp[:, P_AX], wp[:, P_BX], out_size, iw,
                                 nearest)
    x = images.to(torch.bfloat16)
    v = torch.einsum("boi,biwc->bowc", wy, x)
    v = v + (fill[:, None] * (1.0 - inb_y))[:, :, None, None].to(torch.bfloat16)
    h = torch.einsum("bpw,bhwc->bhpc", wx, v)
    return h + (fill[:, None] * (1.0 - inb_x))[:, None, :, None].to(
        torch.bfloat16)


def _centered(u8):
    """uint8 -> its value - 128 as f32 (the int8 zero-point shift)."""
    return u8.to(torch.float32) - 128.0


def _resample_int8(images, wp, out_size: int, fill):
    """(B, H, W, C) uint8 -> (B, S, S, C) uint8 on 127-scaled integer taps.

    Each pass sums at most two products of a tap (<= 127) and a centred
    value (|v| <= 128), below 2^15, so its f32 einsum equals the JAX
    package's int32 one exactly; it then dequantizes as ``v * (1/127) +
    128*inb + fill*(1 - inb)`` (the f32 reciprocal, a fused multiply-add)
    and rounds to uint8 before the next pass, as the reference chain
    materializes uint8 between its PIL/cv2 steps."""
    _, ih, iw, _ = images.shape
    wy, inb_y = _interp_matrices_i8(wp[:, P_AY], wp[:, P_BY], out_size, ih,
                                    nearest=False)
    wx, inb_x = _interp_matrices_i8(wp[:, P_AX], wp[:, P_BX], out_size, iw,
                                    nearest=False)
    inv = _const(1.0 / 127.0, wp)

    def dequant(acc, inb, shape):
        off = (128.0 * inb + fill[:, None] * (1.0 - inb)).reshape(shape)
        return torch.clamp(torch.round(_fma(acc, inv, off)), 0.0, 255.0
                           ).to(torch.uint8)

    v = torch.einsum("boi,biwc->bowc", wy, _centered(images))
    v8 = dequant(v, inb_y, (-1, out_size, 1, 1))
    h = torch.einsum("bpw,bhwc->bhpc", wx, _centered(v8))
    return dequant(h, inb_x, (-1, 1, out_size, 1))


def _resample_labels_int8(labels, wp, out_size: int):
    """(B, H, W, 1) uint8 labels -> (B, S, S, 1) uint8, the exact nearest
    pick: a one-hot row selects ``label - 128`` and ``128 * inb`` restores
    it; out-of-bounds rows give the fill 0."""
    _, ih, iw, _ = labels.shape
    wy, inb_y = _interp_matrices_i8(wp[:, P_AY], wp[:, P_BY], out_size, ih,
                                    nearest=True)
    wx, inb_x = _interp_matrices_i8(wp[:, P_AX], wp[:, P_BX], out_size, iw,
                                    nearest=True)
    v = torch.einsum("boi,biwc->bowc", wy, _centered(labels))
    v8 = (v + 128.0 * inb_y[:, :, None, None]).to(torch.uint8)
    h = torch.einsum("bpw,bhwc->bhpc", wx, _centered(v8))
    return (h + 128.0 * inb_x[:, None, :, None]).to(torch.uint8)


def _shear(planes, shift, axis: int, max_shift: int):
    """One shear of (B, S, S, 4) uint8 planes (R, G, B, label) by the (B, S)
    f32 ``shift`` per row (``axis=2``: along W) or per column (``axis=1``:
    along H); see the module docstring for the arithmetic."""
    b, s = planes.shape[0], planes.shape[axis]
    s_int = torch.floor(shift)
    w = torch.round((shift - s_int) * 256.0).to(torch.int32)
    u = torch.clamp(s_int, -max_shift, max_shift - 1).long()
    coord = torch.arange(s, device=planes.device)
    # (B, S, S) source index along ``axis``: u varies along the other axis
    if axis == 2:
        idx = torch.remainder(coord[None, None, :] - u[:, :, None], s)
        wsh, cs = w[:, :, None, None], coord[None, None, :] - shift[:, :, None]
    else:
        idx = torch.remainder(coord[None, :, None] - u[:, None, :], s)
        wsh, cs = w[:, None, :, None], coord[None, :, None] - shift[:, None, :]
    # the four bytes of a pixel move as one int32 word
    words = planes.contiguous().view(torch.int32)[..., 0]
    y = torch.gather(words, axis, idx)
    y_next = torch.roll(y, 1, dims=axis)
    yb = y[..., None].view(torch.uint8).to(torch.int32)
    nb = y_next[..., None].view(torch.uint8).to(torch.int32)
    lerp = (yb * (256 - wsh) + nb * wsh + 128) >> 8
    near = torch.where(wsh >= 128, nb, yb)
    out = torch.cat([lerp[..., :3], near[..., 3:]], dim=-1)
    valid = ((cs >= -0.5) & (cs <= s - 0.5))[..., None]
    # (128, 128, 128, 0), made on the device: no host copy in a captured step
    fill = (torch.arange(4, device=planes.device) < 3).to(torch.int32) * 128
    return torch.where(valid, out, fill).to(torch.uint8)


def _shear_plan(s: int, two_shear: bool):
    """``max_shift`` of the x and y shears on an ``s`` canvas, sized from
    the worst-case angle (the JAX package's formulas)."""
    c = float(s // 2)
    rad = np.deg2rad(MAX_ANGLE_DEG)
    if two_shear:
        return (int(np.ceil(np.tan(rad) * (s - c))) + 2,
                int(np.ceil(np.sin(rad) * np.cos(rad) * (s - c))) + 2)
    return (int(np.ceil(np.tan(rad / 2) * (s - c))) + 2,
            int(np.ceil(np.sin(rad) * (s - c))) + 2)


def rotate_planes(planes, wp, two_shear: bool = False):
    """Rotate (B, S, S, 4) uint8 planes (RGB + label) about the canvas
    center by each row of ``wp``: the Paeth 3-shear X(-tan(t/2)) .
    Y(sin t) . X(-tan(t/2)), or with ``two_shear`` the approximation X(-tan
    t) . Y(sin t cos t) (determinant 1, ~1.5% shape error at 10 degrees,
    one shear fewer).  Bit-exact with the JAX package's ``_rotate_packed``
    (and ``_rotate_u8`` with ``nearest_tail=1``)."""
    s = planes.shape[1]
    grid = torch.arange(s, dtype=torch.float32, device=planes.device) \
        - float(s // 2)
    ms_x, ms_y = _shear_plan(s, two_shear)
    sint = wp[:, P_SINT][:, None]
    if two_shear:
        cost = torch.sqrt(torch.clamp(1.0 - sint * sint, min=1e-6))
        sh_x = -(sint / cost) * grid[None, :]
        sh_y = (sint * cost) * grid[None, :]
        y = _shear(planes, sh_x, 2, ms_x)
        return _shear(y, sh_y, 1, ms_y)
    sh_x = -wp[:, P_TANH][:, None] * grid[None, :]
    sh_y = sint * grid[None, :]
    y = _shear(planes, sh_x, 2, ms_x)
    y = _shear(y, sh_y, 1, ms_y)
    return _shear(y, sh_x, 2, ms_x)


def rotation_first_order(angles) -> np.ndarray:
    """Host permutation putting the rotating samples first: a loader that
    applies it to (images, labels, params) can pass ``rotate_capacity`` =
    the number of non-zero angles."""
    return np.argsort(np.asarray(angles) == 0, kind="stable")


def augment_batch_einsum(images, labels, params, dst_hw: Tuple[int, int],
                         letterbox: bool = False, normalized: bool = True,
                         rotate: bool = True, rotate_capacity: int = 0,
                         blur: bool = True, blur_capacity: int = 0,
                         two_shear: bool = False,
                         int8_resample: bool = False):
    """``images`` (B, H, W, 3) uint8 and ``labels`` (B, H, W) uint8 ->
    (images (B, S, S, 3) bf16, in [0, 1] if ``normalized`` else [0, 255],
    labels (B, S, S) uint8), the JAX package's einsum backend.

    ``params`` (a :func:`~cervical_tpu_torch.ops.augment.
    sample_augment_params` dict) must lie on the images' device.
    ``letterbox`` resamples only.  Otherwise: ``rotate_capacity`` K > 0
    rotates only the first K samples (``rotate_prefix=K``), 0 all of them,
    ``rotate=False`` none; ``blur_capacity`` K > 0 blurs (where flagged)
    only the last K (``blur_suffix=K``), 0 any flagged sample, ``blur=False``
    none (a data-parallel rank that holds none of the blurred rows);
    ``two_shear`` the 2-shear rotation; ``int8_resample`` the integer-tap
    resample (images quantised to uint8 between passes, labels exact)."""
    if params["scale"].device != images.device:
        raise ValueError(f"augmentation params on {params['scale'].device}, "
                         f"images on {images.device}: upload the params "
                         "first")
    s = dst_hw[0]
    b = images.shape[0]
    wp = make_warp_params(params, images.shape[1:3], dst_hw,
                          letterbox=letterbox)
    fill = wp[:, P_FILL]
    if int8_resample:
        img = _resample_int8(images, wp, s, fill=fill)
        lbl = _resample_labels_int8(labels[..., None], wp, s)
    else:
        img = _resample(images, wp, s, nearest=False, fill=fill)
        lbl = _resample(labels[..., None], wp, s, nearest=True,
                        fill=torch.zeros_like(fill))
        lbl = torch.round(lbl.to(torch.float32)).to(torch.uint8)

    if letterbox:
        if normalized:
            # x / 255 as XLA computes it: times the f32 reciprocal
            img = (img.to(torch.float32) * _const(1.0 / 255.0, wp)).to(
                torch.bfloat16)
        return img.to(torch.bfloat16), lbl[..., 0]

    # the /255 folds into the HSV pass; the blur, linear, runs before it
    scale = (1.0 / 255.0) if normalized else 1.0
    gains, flags = params["gains"], params["blur"]

    def hsv(x, g):
        return hsv_jitter_batched_fast(x, g, scale)

    def rotate_head(k):
        img_u8 = img[:k] if img.dtype == torch.uint8 else torch.clamp(
            torch.round(img[:k].to(torch.float32)), 0, 255).to(torch.uint8)
        # the label plane rides the image's shears as a fourth byte
        return rotate_planes(torch.cat([img_u8, lbl[:k]], dim=-1), wp[:k],
                             two_shear)

    def blurred_where(x, on):
        return torch.where(on[:, None, None, None],
                           gaussian_blur_einsum(x), x)

    k = (rotate_capacity if rotate_capacity > 0 else b) if rotate else 0
    m = blur_capacity if blur else 0
    if 0 < k and 0 < m and k + m <= b:
        # the rotated head, the untouched middle and the blurred tail meet
        # in one concatenation (the JAX package's piecewise fast path)
        rot = rotate_head(k)
        lbl = torch.cat([rot[..., 3:], lbl[k:]])
        tail = img[b - m:]
        if tail.dtype == torch.uint8:
            tail = tail.to(torch.bfloat16)
        pieces = [hsv(rot[..., :3].to(torch.bfloat16), gains[:k])]
        if k < b - m:
            pieces.append(hsv(img[k:b - m], gains[k:b - m]))
        pieces.append(hsv(blurred_where(tail, flags[b - m:]),
                          gains[b - m:]))
        return torch.cat(pieces), lbl[..., 0]

    if img.dtype == torch.uint8:
        img = img.to(torch.bfloat16)
    if k > 0:
        rot = rotate_head(k)
        img = torch.cat([rot[..., :3].to(torch.bfloat16), img[k:]])
        lbl = torch.cat([rot[..., 3:], lbl[k:]])
    if m > 0:
        img = torch.cat([img[:-m], blurred_where(img[-m:], flags[-m:])])
    elif blur:
        img = blurred_where(img, flags)
    return hsv(img, gains), lbl[..., 0]
