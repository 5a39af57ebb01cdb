"""Train-time augmentation kernels K1 ``warp_images``, K2 ``warp_labels``,
K3 ``photometric`` and K5 ``warp_photo_images`` (K1 then K3 in one kernel):
their warp parameters, their plain PyTorch versions, the wrappers of their
Hopper kernels, and :func:`augment_batch_kernels`, which chains them.

Port of ``cervical_tpu/ops/pallas_warp.py``.  Each image
is warped by the inverse map ``src = a*dst + b`` per axis (scale, flip,
paste; flip folded into the sign of ``ax``) with gray fill outside the
source, then, only where its angle is not 0, rotated about the canvas
center by the Paeth 3-shear (lanes, rows, lanes).  Labels take the same
geometry in nearest mode with fill 0.  The photometric pass blurs (5x5
binomial, optional per image), jitters HSV with cv2's uint8-LUT rules and
scales by 1/255.

The plain versions reproduce the TPU kernels' arithmetic, not the gather
oracle of ``ops/augment.py``:

* bilinear weights are ``bf16((1-f)*inb)`` and ``bf16(f*inb)``, merged
  before rounding where both taps clamp onto one source index; each 1-D
  pass sums its two exact bf16 products in f32, adds the fill and rounds
  to bf16;
* the shears wrap around (``x[(c - clip(s, -64, 63)) mod S]``, its lerp
  partner one further), validity tests the unclipped float shift, and the
  fill is applied after each shear; bilinear mode lerps in f32 by
  ``shift - floor(shift)``, nearest mode rounds half to even;
* the blur's border rule is the TPU kernel's (the +d tap of the last d rows
  reads ``x[i-d]``, the -d tap of the first d rows ``x[i+d]``), not true
  REFLECT_101: they differ on the second row and column from each edge;
* rounding follows the JAX kernels as XLA compiles them: ``a*o + b`` and
  the shear lerp ``y*(1-f) + y_next*f`` are fused multiply-adds (one
  rounding), every other product and sum rounds on its own, the HSV map's
  divisions by a variable are IEEE divisions and its divisions by the
  constants 255 and 60 are products with their f32 reciprocals.

A wrapper takes its plain version only for a tensor on the CPU.  For a
CUDA tensor it launches its kernel from ``csrc/warp.cu`` (design notes and
bounds are in that file's header) or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from cervical_tpu_torch.ops import _build
from cervical_tpu_torch.ops.augment import (_const, _fma, _hsv_to_rgb,
                                            _lut_gains, _mod, _paste_offsets,
                                            _resized_dims, _rgb_to_hsv)

SOURCE = _build.CSRC_DIR / "warp.cu"

# warp-parameter row layout (float32, one row per image)
P_AY, P_BY, P_AX, P_BX, P_TANH, P_SINT, P_ANGLE, P_FILL = range(8)
NPARAMS = 8
# K5's full row: the warp columns, then the HSV gains and the blur flag
P_GH, P_GS, P_GV, P_BLUR = 8, 9, 10, 11
NPARAMS_FULL = 12
MAX_SHIFT = 64  # shear shifts clip to [-64, 63]: +-10 deg on 512 stays inside
BLUR_MODES = ("select", "all", "none")
# K1's output tile (rows, cols) and the shear slopes |tan(theta/2)|,
# |sin(theta)| its window buffers are sized for, in 1/10000: 10 degrees
# rounded up (csrc/warp.cu K1_ROWS/K1_COLS, kTanHalfMax/kSinMax); K5 stages
# the same tile grown by the blur's reach on each side (K5_HALO)
K1_TILE = (32, 32)
ROTATION_SLOPES = (875, 1737)
K5_HALO = 2
# K3's per-image gain tables: entries for every integer rintf(h) in
# [0, 180], rintf(s) and rintf(v) in [0, 255] (csrc/warp.cu kHueEntries,
# kSatEntries, kValEntries)
GAIN_TABLE_SIZES = (181, 256, 256)

# kernel launches, counted by the wrappers where they launch
LAUNCHES = {"warp_images": 0, "warp_labels": 0, "photometric": 0,
            "warp_photo_images": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def make_warp_params(params, src_hw, dst_hw, letterbox: bool = False,
                     fill: float = 128.0):
    """(B, NPARAMS) float32 warp-parameter rows from a
    :func:`~cervical_tpu_torch.ops.augment.sample_augment_params` dict, on
    its device: the inverse resize+flip+paste map as ``src = a*dst + b`` per
    axis, the shear coefficients ``tan(theta/2)`` and ``sin(theta)`` with
    ``theta = -angle`` (the shear pipeline rotates output space), the angle
    and the fill."""
    ih, iw = src_hw
    nh, nw = _resized_dims(params, src_hw, dst_hw, letterbox)
    dy, dx = _paste_offsets(params, nh, nw, dst_hw, letterbox)
    ay = _const(ih, nh) / nh
    by = (0.5 - dy) * ay - 0.5
    sx = _const(iw, nw) / nw
    flip = params["flip"]
    # no flip: xs = sx*(x - dx + 0.5) - 0.5; flip: sx*((nw-1) - (x-dx) + 0.5) - 0.5
    ax = torch.where(flip, -sx, sx)
    bx = torch.where(flip, (nw - 1.0 + dx + 0.5) * sx - 0.5,
                     (0.5 - dx) * sx - 0.5)
    theta = -params["angle"] * (math.pi / 180.0)
    out = torch.stack([ay, by, ax, bx, torch.tan(theta / 2.0),
                       torch.sin(theta), params["angle"],
                       torch.full_like(ay, fill)], dim=-1)
    return out.to(torch.float32)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _taps(a, b, out_size: int, in_size: int, nearest: bool):
    """Per-output taps of ``src = a*o + b`` for (B,) coefficients: (B, out)
    (i0, i1, w0, w1, inb), weights f32 holding bf16 values; nearest mode
    has ``w0 = inb`` and ``w1 = 0``."""
    o = torch.arange(out_size, dtype=torch.float32, device=a.device)
    src = _fma(a[:, None], o, b[:, None])
    inb = ((src >= -0.5) & (src <= in_size - 0.5)).to(torch.float32)
    if nearest:
        i0 = torch.clamp(torch.round(src), 0, in_size - 1).long()
        return i0, i0, inb, torch.zeros_like(inb), inb
    y0 = torch.floor(src)
    f = src - y0
    i0 = torch.clamp(y0, 0, in_size - 1).long()
    i1 = torch.clamp(y0 + 1.0, 0, in_size - 1).long()
    one_f = 1.0 - f
    same = i0 == i1
    w0 = _bf16(torch.where(same, one_f + f, one_f) * inb)
    w1 = _bf16(torch.where(same, torch.zeros_like(f), f * inb))
    return i0, i1, w0, w1, inb


def _resample(x, wp, out_size: int, nearest: bool):
    """Separable 1-D resamples of (B, C, Hs, Ws) f32 -> (B, C, S, S) f32
    holding bf16 values (nearest: the picked values, fill 0)."""
    b, c, hs, ws = x.shape
    fill = torch.zeros_like(wp[:, P_FILL]) if nearest else wp[:, P_FILL]
    y0, y1, wy0, wy1, inby = _taps(wp[:, P_AY], wp[:, P_BY], out_size, hs,
                                   nearest)
    x0, x1, wx0, wx1, inbx = _taps(wp[:, P_AX], wp[:, P_BX], out_size, ws,
                                   nearest)

    def rows(t, idx):  # (B, C, Hs, W) at (B, S) row indices
        return torch.gather(t, 2, idx[:, None, :, None].expand(
            b, c, out_size, t.shape[3]))

    def cols(t, idx):  # (B, C, H, Ws) at (B, S) column indices
        return torch.gather(t, 3, idx[:, None, None, :].expand(
            b, c, t.shape[2], out_size))

    fill_y = ((1.0 - inby) * fill[:, None])[:, None, :, None]
    v = (wy0[:, None, :, None] * rows(x, y0)
         + wy1[:, None, :, None] * rows(x, y1)) + fill_y
    v = _bf16(v)
    fill_x = ((1.0 - inbx) * fill[:, None])[:, None, None, :]
    h = (wx0[:, None, None, :] * cols(v, x0)
         + wx1[:, None, None, :] * cols(v, x1)) + fill_x
    return _bf16(h)


def _shear(x, shift, fill, nearest: bool, lanes: bool):
    """One shear of (N, C, S, S) f32 planes.  ``lanes``: ``out[r, c] =
    x[r, c - shift[r]]``; else ``out[r, c] = x[r - shift[c], c]``.
    ``shift`` (N, S) f32, ``fill`` (N,)."""
    n, ch, s, _ = x.shape
    if nearest:
        s_int = torch.round(shift)
    else:
        s_int = torch.floor(shift)
        frac = shift - s_int
    sc = torch.clamp(s_int, -MAX_SHIFT, MAX_SHIFT - 1).long()
    coord = torch.arange(s, device=x.device)
    coordf = coord.to(torch.float32)
    if lanes:   # shift per row r, moving along columns
        idx = (coord[None, None, :] - sc[:, :, None]) % s
        cs = coordf[None, None, :] - shift[:, :, None]
        dim = 3
    else:       # shift per column c, moving along rows
        idx = (coord[None, :, None] - sc[:, None, :]) % s
        cs = coordf[None, :, None] - shift[:, None, :]
        dim = 2

    def take(i):
        return torch.gather(x, dim, i[:, None].expand(n, ch, s, s))

    y = take(idx)
    if not nearest:
        f = frac[:, None, :, None] if lanes else frac[:, None, None, :]
        y = _fma(y, 1.0 - f, take((idx - 1) % s) * f)
    valid = ((cs >= -0.5) & (cs <= s - 0.5))[:, None]
    return torch.where(valid, y, fill[:, None, None, None])


def _rotate(x, wp, nearest: bool, fill):
    """Paeth 3-shear rotation of (N, C, S, S) f32 about (S//2, S//2):
    lanes by ``-tan(theta/2)*(r - c0)``, rows by ``sin(theta)*(c - c0)``,
    lanes again, in f32."""
    s = x.shape[-1]
    grid = torch.arange(s, dtype=torch.float32, device=x.device) - float(s // 2)
    sh_lanes = (-wp[:, P_TANH])[:, None] * grid[None, :]
    sh_rows = wp[:, P_SINT][:, None] * grid[None, :]
    x = _shear(x, sh_lanes, fill, nearest, lanes=True)
    x = _shear(x, sh_rows, fill, nearest, lanes=False)
    return _shear(x, sh_lanes, fill, nearest, lanes=True)


def _rotate_where(h, wp, nearest: bool, fill):
    """Rotate the images whose angle is not 0; the others pass."""
    rot = wp[:, P_ANGLE] != 0
    if bool(rot.any()):
        h = h.clone()
        h[rot] = _bf16(_rotate(h[rot], wp[rot], nearest, fill[rot]))
    return h


def k1_buffers(halo: int = 0):
    """(L2 columns, L1 rows, L0 columns): the window sides of the shared
    memory in which ``csrc/warp.cu`` stages a rotation (``Windows``), for
    K1's output tile grown by ``halo`` on each side (0: K1; 2: K5, whose
    blur reads 2 pixels past its tile).  A shift ``floor(k * lever)`` takes
    at most ``floor(k * (n - 1)) + 1`` values over n consecutive levers;
    the lerp partner adds one."""
    rows, cols = (n + 2 * halo for n in K1_TILE)
    tan_k, sin_k = ROTATION_SLOPES

    def grow(k, n):
        return k * (n - 1) // 10000 + 2
    w2 = cols + grow(tan_k, rows)
    h1 = rows + grow(sin_k, w2)
    return w2, h1, w2 + grow(tan_k, h1)


def _tap_span(coef, la, lb, c0: float, pa, pb, s: int):
    """``csrc/warp.cu`` ``tap_span``: [a, b], clipped to [0, s), of the taps
    a shear reads at positions [pa, pb] for levers [la, lb] (int64
    tensors); the clipped shift is monotone in the lever."""
    def shift(i):
        return torch.clamp(torch.floor(coef * (i.to(torch.float32) - c0)),
                           -MAX_SHIFT, MAX_SHIFT - 1).long()
    u, v = shift(la), shift(lb)
    return (torch.clamp(pa - torch.maximum(u, v) - 1, min=0),
            torch.clamp(pb - torch.minimum(u, v), max=s - 1))


def rotation_windows(tan_half, sint, s: int, halo: int = 0):
    """The window rule of ``csrc/warp.cu`` ``rotate_region`` for a rotated
    S x S image, per output tile: a dict of (tile rows, tile columns) int64
    tensors.  ``ra``..``rb`` and ``ca``..``cb`` are the region staged: the
    tile grown by ``halo`` on each side (0: K1; 2: K5 on an image that
    blurs), clipped to the image.  The kernel stages L2 (after shear 2) at
    the region's rows and columns ``a2``..``b2``, L1 (after shear 1) at rows
    ``a1``..``b1`` and L2's columns, L0 (the resample) at L1's rows and
    columns ``a0``..``b0``.  ``fits``: all three fit the buffers of
    :func:`k1_buffers` for that halo, else the region takes the recursive
    path.  ``tan_half`` and ``sint`` are the row's f32 values (``P_TANH``,
    ``P_SINT``)."""
    rows, cols = K1_TILE
    c0 = float(s // 2)
    tanc = -torch.as_tensor(tan_half, dtype=torch.float32)
    sinc = torch.as_tensor(sint, dtype=torch.float32)
    ta, tb = torch.meshgrid(torch.arange(0, s, rows),
                            torch.arange(0, s, cols), indexing="ij")
    ra = torch.clamp(ta - halo, min=0)
    ca = torch.clamp(tb - halo, min=0)
    rb = torch.clamp(ta + rows + halo, max=s) - 1
    cb = torch.clamp(tb + cols + halo, max=s) - 1
    a2, b2 = _tap_span(tanc, ra, rb, c0, ca, cb, s)
    a1, b1 = _tap_span(sinc, a2, b2, c0, ra, rb, s)
    a0, b0 = _tap_span(tanc, a1, b1, c0, a2, b2, s)
    w2, h1, w0 = k1_buffers(halo)

    def side(a, b):
        return torch.clamp(b - a + 1, min=0)
    fits = (side(a2, b2) <= w2) & (side(a1, b1) <= h1) & (side(a0, b0) <= w0)
    return {"ra": ra, "rb": rb, "ca": ca, "cb": cb, "a2": a2, "b2": b2,
            "a1": a1, "b1": b1, "a0": a0, "b0": b0, "fits": fits}


def warp_images_reference(images_planar, warp_params, out_size: int = None,
                          out_dtype=torch.bfloat16):
    """Plain version of K1: (B, C, Hs, Ws) uint8 (any strides) and (B, 8)
    rows -> (B, C, S, S) ``out_dtype`` in [0, 255]; uint8 is
    ``clip(round(bf16 result), 0, 255)``."""
    s = out_size or images_planar.shape[2]
    wp = warp_params.to(torch.float32)
    h = _resample(images_planar.to(torch.float32), wp, s, nearest=False)
    h = _rotate_where(h, wp, False, wp[:, P_FILL])
    if out_dtype == torch.uint8:
        return torch.clamp(torch.round(h), 0.0, 255.0).to(torch.uint8)
    return h.to(out_dtype)


def warp_labels_reference(labels, warp_params, out_size: int = None):
    """Plain version of K2: (B, Hs, Ws) uint8 class ids -> (B, S, S) uint8,
    the K1 geometry in nearest mode with fill 0."""
    s = out_size or labels.shape[1]
    wp = warp_params.to(torch.float32)
    h = _resample(labels[:, None].to(torch.float32), wp, s, nearest=True)
    h = _rotate_where(h, wp, True, torch.zeros_like(wp[:, P_FILL]))
    return torch.round(h[:, 0]).to(torch.uint8)


def _blur1d(x, dim: int):
    """The TPU kernel's 5-tap binomial along ``dim`` (its border rule)."""
    n = x.shape[dim]
    i = torch.arange(n, device=x.device)
    acc = x * 0.375
    for dist, wgt in ((1, 0.25), (2, 0.0625)):
        plus = torch.where(i >= n - dist, i - dist, i + dist)
        minus = torch.where(i < dist, i + dist, i - dist)
        acc = acc + wgt * (x.index_select(dim, plus)
                           + x.index_select(dim, minus))
    return acc


def gain_entries(hr, sr, vr, gh, gs, gv):
    """What the HSV map needs of each channel's integer value ``rint(h)``,
    ``rint(s)``, ``rint(v)`` under the image's gains, as cv2's uint8 LUTs
    give it (``csrc/warp.cu`` ``hue_entry``, ``sat_entry``, ``val_entry``):
    (the hue's x factor ``1 - |mod(hp, 2) - 1|``, its sextant ``floor(hp) %
    6`` as int32, ``s / 255``, ``v``), ``hp`` the gained hue times 2/60.
    :func:`photometric_reference`'s operations (``_lut_gains``, then the
    start of ``_hsv_to_rgb``) up to the values that depend on one channel
    alone; each channel broadcasts with its own gain."""
    h, s, v = _lut_gains(hr, sr, vr, gh, gs, gv)
    hp = (h * 2.0) * _const(1.0 / 60.0, h)
    return (1.0 - torch.abs(_mod(hp, 2.0) - 1.0),
            torch.floor(hp).to(torch.int32) % 6, s * _const(1.0 / 255.0, s),
            v)


def photometric_tables(gains):
    """K3's per-image gain tables for (B, 3) gains, as the kernel fills
    them in shared memory: :func:`gain_entries` at every integer index,
    ``hue_factor`` and ``hue_sextant`` (B, 181), ``sat`` and ``val`` (B,
    256).  A pixel whose index falls outside a table (input outside
    [0, 255]) takes :func:`gain_entries` directly."""
    g = gains.to(torch.float32)

    def idx(n):
        return torch.arange(n, dtype=torch.float32, device=g.device)[None]
    factor, sextant, sat, val = gain_entries(
        *(idx(n) for n in GAIN_TABLE_SIZES), *(g[:, k:k + 1] for k in range(3)))
    return {"hue_factor": factor, "hue_sextant": sextant, "sat": sat,
            "val": val}


def photometric_reference(images_planar, gains, blur_flags,
                          out_dtype=torch.bfloat16, blur_mode: str = "select"):
    """Plain version of K3: (B, 3, H, W) uint8/bf16/f32 in [0, 255], (B, 3)
    gains, (B,) blur flags -> (B, 3, H, W) ``out_dtype`` in [0, 1]: the
    optional blur (rows, then columns), cv2-LUT HSV gains, x f32(1/255).
    ``blur_mode`` "select" blurs where the flag is set; "all"/"none"
    ignore the flags.  Input outside [0, 255] (f32) is not clipped: the
    same operations run on it, the result outside [0, 1] where they give
    that."""
    if blur_mode not in BLUR_MODES:
        raise ValueError(f"blur_mode must be one of {BLUR_MODES}, got "
                         f"{blur_mode!r}")
    x = images_planar.to(torch.float32)
    if blur_mode != "none":
        blurred = _blur1d(_blur1d(x, 2), 3)
        if blur_mode == "all":
            x = blurred
        else:
            x = torch.where(blur_flags.to(torch.bool)[:, None, None, None],
                            blurred, x)
    g = gains.to(torch.float32)
    hsv = _rgb_to_hsv(x[:, 0], x[:, 1], x[:, 2])
    hsv = _lut_gains(*hsv, *(g[:, k][:, None, None] for k in range(3)))
    inv255 = torch.tensor(1.0 / 255.0, dtype=torch.float32)
    return (torch.stack(_hsv_to_rgb(*hsv), 1) * inv255).to(out_dtype)


def warp_photo_images_reference(images_planar, full_params,
                                out_size: int = None,
                                out_dtype=torch.bfloat16):
    """Plain version of K5: (B, 3, Hs, Ws) uint8 and (B, 12) full rows ->
    (B, 3, S, S) ``out_dtype`` in [0, 1].  The JAX kernel stages the warp
    in bf16 and blurs in f32 on those values, so it is K3 in "select" mode
    on K1's bf16 output (equal to JAX's K5 in interpret mode)."""
    fp = full_params.to(torch.float32)
    warped = warp_images_reference(images_planar, fp[:, :NPARAMS], out_size)
    return photometric_reference(warped, fp[:, P_GH:P_GV + 1],
                                 fp[:, P_BLUR] > 0, out_dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_lib_handle = None
_OUT_KIND = {torch.bfloat16: 0, torch.uint8: 1, torch.float32: 2}
_IN_KIND = {torch.uint8: 0, torch.bfloat16: 1, torch.float32: 2}


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load(SOURCE)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.warp_images.argtypes = [vp, i64, i64, i64, i64, i32, i32, i32, i32,
                                    vp, vp, i32, i32, vp]
        lib.warp_labels.argtypes = [vp, i64, i64, i64, i32, i32, i32, vp, vp,
                                    i32, vp]
        lib.photometric.argtypes = [vp, i32, vp, vp, vp, i32, i32, i32, i32,
                                    i32, vp]
        lib.warp_photo_images.argtypes = [vp, i64, i64, i64, i64, i32, i32,
                                          i32, vp, vp, i32, i32, vp]
        for fn in (lib.warp_images, lib.warp_labels, lib.photometric,
                   lib.warp_photo_images):
            fn.restype = i32
        _lib_handle = lib
    return _lib_handle


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_card(name, t):
    """True for a CUDA tensor, False for a CPU one (plain version); raises
    for any other device."""
    if t.device.type == "cpu":
        return False
    if not t.is_cuda:
        raise ValueError(f"{name} runs on cpu or cuda, got {t.device}")
    return True


def _params_on(wp, like, b, ncols=NPARAMS):
    if tuple(wp.shape) != (b, ncols):
        raise ValueError(f"warp_params must be ({b}, {ncols}), got "
                         f"{tuple(wp.shape)}")
    return wp.to(like.device, torch.float32).contiguous()


def _raise_if(rc, name):
    if rc:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def warp_images(images_planar, warp_params, out_size: int = None,
                out_dtype=torch.bfloat16):
    """K1: (B, 3, Hs, Ws) uint8, any strides (an NHWC batch's permuted view
    is read in place), and (B, 8) rows -> (B, 3, S, S) bf16 in [0, 255],
    or uint8 rounded as ``clip(round(bf16), 0, 255)``."""
    if not _on_card("warp_images", images_planar):
        return warp_images_reference(images_planar, warp_params, out_size,
                                     out_dtype)
    if images_planar.dtype != torch.uint8 or images_planar.ndim != 4 \
            or images_planar.shape[1] != 3:
        raise TypeError("warp_images takes (B, 3, H, W) uint8, got "
                        f"{tuple(images_planar.shape)} {images_planar.dtype}")
    if out_dtype not in (torch.bfloat16, torch.uint8):
        raise TypeError(f"warp_images writes bf16 or uint8, not {out_dtype}")
    b, c, hs, ws = images_planar.shape
    s = out_size or hs
    wp = _params_on(warp_params, images_planar, b)
    out = torch.empty(b, c, s, s, dtype=out_dtype, device=images_planar.device)
    if b:
        st = images_planar.stride()
        _raise_if(_lib().warp_images(
            images_planar.data_ptr(), *st, b, c, hs, ws, wp.data_ptr(),
            out.data_ptr(), _OUT_KIND[out_dtype], s, _stream(out)),
            "warp_images")
        LAUNCHES["warp_images"] += 1
    return out


def warp_labels(labels, warp_params, out_size: int = None):
    """K2: (B, Hs, Ws) uint8 class ids, any strides, -> (B, S, S) uint8."""
    if not _on_card("warp_labels", labels):
        return warp_labels_reference(labels, warp_params, out_size)
    if labels.dtype != torch.uint8 or labels.ndim != 3:
        raise TypeError("warp_labels takes (B, H, W) uint8, got "
                        f"{tuple(labels.shape)} {labels.dtype}")
    b, hs, ws = labels.shape
    s = out_size or hs
    wp = _params_on(warp_params, labels, b)
    out = torch.empty(b, s, s, dtype=torch.uint8, device=labels.device)
    if b:
        _raise_if(_lib().warp_labels(
            labels.data_ptr(), *labels.stride(), b, hs, ws, wp.data_ptr(),
            out.data_ptr(), s, _stream(out)), "warp_labels")
        LAUNCHES["warp_labels"] += 1
    return out


def photometric(images_planar, gains, blur_flags, out_dtype=torch.bfloat16,
                blur_mode: str = "select"):
    """K3: (B, 3, H, W) uint8/bf16/f32 in [0, 255], (B, 3) gains, (B,)
    blur flags -> (B, 3, H, W) bf16 (or f32) in [0, 1].  Input outside
    [0, 255] (possible in f32) is neither clipped nor refused: the kernel
    computes :func:`photometric_reference`'s operations on it, the gain of
    a channel value outside the kernel's tables computed per pixel, so the
    result equals the plain version's there too."""
    if blur_mode not in BLUR_MODES:
        raise ValueError(f"blur_mode must be one of {BLUR_MODES}, got "
                         f"{blur_mode!r}")
    if not _on_card("photometric", images_planar):
        return photometric_reference(images_planar, gains, blur_flags,
                                     out_dtype, blur_mode)
    x = images_planar
    if x.dtype not in _IN_KIND or x.ndim != 4 or x.shape[1] != 3:
        raise TypeError("photometric takes (B, 3, H, W) uint8, bf16 or f32, "
                        f"got {tuple(x.shape)} {x.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"photometric writes bf16 or f32, not {out_dtype}")
    b, _, h, w = x.shape
    x = x.contiguous()
    g = gains.to(x.device, torch.float32).contiguous()
    fl = blur_flags.to(x.device)
    # bool is one byte of 0 or 1: read in place, no cast kernel
    fl = (fl.view(torch.uint8) if fl.dtype == torch.bool
          else fl.to(torch.uint8)).contiguous()
    if tuple(g.shape) != (b, 3) or tuple(fl.shape) != (b,):
        raise ValueError(f"gains must be ({b}, 3) and blur_flags ({b},), got "
                         f"{tuple(g.shape)}, {tuple(fl.shape)}")
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if b:
        _raise_if(_lib().photometric(
            x.data_ptr(), _IN_KIND[x.dtype], g.data_ptr(), fl.data_ptr(),
            out.data_ptr(), _OUT_KIND[out_dtype], BLUR_MODES.index(blur_mode),
            b, h, w, _stream(out)), "photometric")
        LAUNCHES["photometric"] += 1
    return out


def warp_photo_images(images_planar, full_params, out_size: int = None,
                      out_dtype=torch.bfloat16):
    """K5: (B, 3, Hs, Ws) uint8, any strides, and (B, 12) full rows (the
    warp columns, HSV gains, blur flag) -> (B, 3, S, S) bf16 (or f32) in
    [0, 1]: K1 then K3 in one kernel, rotation and blur only where the
    image's angle or flag is set."""
    if not _on_card("warp_photo_images", images_planar):
        return warp_photo_images_reference(images_planar, full_params,
                                           out_size, out_dtype)
    if images_planar.dtype != torch.uint8 or images_planar.ndim != 4 \
            or images_planar.shape[1] != 3:
        raise TypeError("warp_photo_images takes (B, 3, H, W) uint8, got "
                        f"{tuple(images_planar.shape)} {images_planar.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"warp_photo_images writes bf16 or f32, not "
                        f"{out_dtype}")
    b, c, hs, ws = images_planar.shape
    s = out_size or hs
    fp = _params_on(full_params, images_planar, b, NPARAMS_FULL)
    out = torch.empty(b, c, s, s, dtype=out_dtype, device=images_planar.device)
    if b:
        _raise_if(_lib().warp_photo_images(
            images_planar.data_ptr(), *images_planar.stride(), b, hs, ws,
            fp.data_ptr(), out.data_ptr(), _OUT_KIND[out_dtype], s,
            _stream(out)), "warp_photo_images")
        LAUNCHES["warp_photo_images"] += 1
    return out


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------

def augment_batch_kernels(images, labels, params, dst_hw: Tuple[int, int],
                          letterbox: bool = False, normalized: bool = True,
                          fused: bool = False,
                          blur_capacity: int | None = None,
                          carry_u8: bool = False, planar: bool = False):
    """The counterpart of ``augment_batch_pallas``: (B, H, W, 3) uint8 — or,
    with ``planar``, (B, 3, H, W) uint8 as the native loader emits it
    (``native.load_batch(planar=True)``) — and (B, H, W) uint8 labels ->
    (images
    (B, h, w, 3) bf16, a view of planar storage, in [0, 1] if
    ``normalized`` else [0, 255]; labels (B, h, w) uint8).

    ``params`` may live on the CPU; the rows, gains and flags move to the
    images' device.  ``fused=True`` runs K5 (warp and photometric pass in
    one kernel) instead of K1 and K3; ``letterbox`` takes precedence over
    it, and it ignores ``blur_capacity`` and ``carry_u8``.
    ``blur_capacity=K`` promises that exactly the last K samples blur and
    splits the photometric pass into a "none" and an "all" call;
    ``carry_u8`` rounds the warp's output to uint8 before the photometric
    pass.
    """
    src_hw = tuple(images.shape[2:4] if planar else images.shape[1:3])
    dev = images.device
    wp = make_warp_params(params, src_hw, dst_hw, letterbox)
    # the (B, NPARAMS_FULL) rows in the JAX package's column order
    full = torch.cat([wp, params["gains"].to(wp.device, torch.float32),
                      params["blur"].to(wp.device, torch.float32)[:, None]], 1)
    if dev.type == "cuda" and full.device.type == "cpu":
        if torch.cuda.is_current_stream_capturing():
            # a graph would replay the copy from a host buffer long freed
            raise RuntimeError("augment_batch_kernels: parameters on the "
                               "host while a CUDA graph captures; stage "
                               "them on the card before the capture")
        # one pinned, non-blocking upload: a pageable copy would make the
        # host wait for the card to drain before every step
        full = full.pin_memory().to(dev, non_blocking=True)
    else:
        full = full.to(dev)
    wp, gains = full[:, :NPARAMS], full[:, P_GH:P_GV + 1]
    blur = full[:, P_BLUR] > 0
    # K1 and K5 read either layout in place, by its strides
    x = images if planar else images.permute(0, 3, 1, 2)
    s = dst_hw[0]
    lbl = warp_labels(labels, wp, out_size=s)
    if letterbox:
        out = warp_images(x, wp, out_size=s).to(torch.bfloat16)
        if normalized:  # x / 255 as XLA computes it: times the f32 reciprocal
            out = (out.float() * _const(1.0 / 255.0, wp)).to(torch.bfloat16)
        return out.permute(0, 2, 3, 1), lbl
    if fused:
        out = warp_photo_images(x, full, out_size=s)
        if not normalized:
            out = out * 255.0
        return out.permute(0, 2, 3, 1), lbl
    warped = warp_images(x, wp, out_size=s,
                         out_dtype=torch.uint8 if carry_u8 else torch.bfloat16)
    b = warped.shape[0]
    bcap = blur_capacity
    if bcap is None or bcap <= 0 or bcap >= b:
        mode = "select" if bcap is None else ("none" if bcap <= 0 else "all")
        out = photometric(warped, gains, blur, blur_mode=mode)
    else:
        nb = b - bcap
        out = torch.cat([
            photometric(warped[:nb], gains[:nb], blur[:nb], blur_mode="none"),
            photometric(warped[nb:], gains[nb:], blur[nb:], blur_mode="all")])
    if not normalized:
        out = out * 255.0
    return out.permute(0, 2, 3, 1), lbl
