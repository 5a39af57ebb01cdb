"""The train-time augmentation of the reference data loader
(``utils/dataloader.py:55-154`` of bubbliiiing ``deeplabv3-plus-pytorch``),
batched, in float32: one inverse warp per output pixel (aspect-jitter
resize, flip, paste on gray; bilinear image, nearest label), the rotation,
then the 5x5 Gaussian blur (REFLECT_101) and cv2's uint8 HSV gain jitter.

The rotation is the one the system defines (the JAX package's default
augmentation backend, which the port keeps): the resampled canvas rounded
to uint8, then the exact Paeth 3-shear X(-tan(t/2)) . Y(sin t) .
X(-tan(t/2)) on its four byte planes (RGB and the label), each shear a
cyclic take with a 256-step linear blend of the image bytes and a nearest
pick of the label byte, gray fill outside.  Where the reference rotates
with ``cv2.warpAffine``, the two differ by a few levels at the rotated
edges.

``sample_params`` draws the per-image parameters as the system under test
documents its draw: one host ``torch.Generator`` seeded ``seed + 1``, per
step in step order, rotation on the first and blur on the last ``max(1,
B // 4)`` images of the batch.  The parameters are inputs both sides derive
from the seed; this module derives them itself.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

GRAY = 128.0
_GAUSS5 = (0.0625, 0.25, 0.375, 0.25, 0.0625)


def sample_params(generator: torch.Generator, b: int, jitter=0.3,
                  scale_range=(0.25, 2.0), hue=0.1, sat=0.7, val=0.3,
                  flip_p=0.5, max_rotation=10):
    """One step's parameters, each a (B,) float32 tensor ((B, 3) gains)."""
    g = generator
    cap = max(1, b // 4)

    def u(lo, hi, shape=(b,)):
        return torch.rand(shape, generator=g) * (hi - lo) + lo

    ar_jitter = u(1 - jitter, 1 + jitter) / u(1 - jitter, 1 + jitter)
    scale = u(*scale_range)
    flip = torch.rand(b, generator=g) < flip_p
    dx_frac = u(0.0, 1.0)
    dy_frac = u(0.0, 1.0)
    idx = torch.arange(b)
    blur = idx >= b - cap
    angle = torch.randint(-max_rotation, max_rotation + 1, (b,),
                          generator=g).to(torch.float32)
    angle = torch.where(idx < cap, angle, torch.zeros_like(angle))
    gains = u(-1.0, 1.0, (b, 3)) * torch.tensor([hue, sat, val]) + 1.0
    return {"ar_jitter": ar_jitter, "scale": scale, "flip": flip,
            "dx_frac": dx_frac, "dy_frac": dy_frac, "blur": blur,
            "angle": angle, "gains": gains}


def _source_coords(p, src_hw, dst_hw):
    """Source (ys, xs) of every output pixel: undo the rotation about the
    canvas centre, the paste offset, the flip and the resize."""
    ih, iw = src_hw
    h, w = dst_hw
    new_ar = (iw / ih) * p["ar_jitter"]
    nh_a = torch.floor(p["scale"] * h)
    nw_a = torch.floor(nh_a * new_ar)
    nw_b = torch.floor(p["scale"] * w)
    nh_b = torch.floor(nw_b / new_ar)
    nh = torch.clamp(torch.where(new_ar < 1, nh_a, nh_b), min=1.0)
    nw = torch.clamp(torch.where(new_ar < 1, nw_a, nw_b), min=1.0)
    dy = torch.floor(p["dy_frac"] * (h - nh))
    dx = torch.floor(p["dx_frac"] * (w - nw))
    dev = nh.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]

    def col(t):
        return t[:, None, None]

    theta = p["angle"] * (math.pi / 180.0)
    cx, cy = w // 2, h // 2
    cos_t, sin_t = col(torch.cos(theta)), col(torch.sin(theta))
    xr = cos_t * (xx - cx) - sin_t * (yy - cy) + cx
    yr = sin_t * (xx - cx) + cos_t * (yy - cy) + cy
    xp = xr - col(dx)
    yp = yr - col(dy)
    xp = torch.where(col(p["flip"]), (col(nw) - 1.0) - xp, xp)
    xs = (xp + 0.5) * (iw / col(nw)) - 0.5
    ys = (yp + 0.5) * (ih / col(nh)) - 0.5
    return ys, xs


def _inside(ys, xs, ih, iw):
    return (xs >= -0.5) & (xs <= iw - 0.5) & (ys >= -0.5) & (ys <= ih - 0.5)


def _take(img, yi, xi):
    b = torch.arange(img.shape[0], device=img.device)[:, None, None]
    return img[b, yi, xi]


def _bilinear(img, ys, xs, fill):
    _, ih, iw, _ = img.shape
    x0, y0 = torch.floor(xs), torch.floor(ys)
    fx, fy = (xs - x0)[..., None], (ys - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()

    def tap(yi, xi):
        return _take(img, yi.clamp(0, ih - 1), xi.clamp(0, iw - 1))

    out = (tap(y0i, x0i) * (1 - fx) * (1 - fy)
           + tap(y0i, x0i + 1) * fx * (1 - fy)
           + tap(y0i + 1, x0i) * (1 - fx) * fy
           + tap(y0i + 1, x0i + 1) * fx * fy)
    return torch.where(_inside(ys, xs, ih, iw)[..., None], out,
                       torch.full_like(out, fill))


def _nearest(label, ys, xs, fill):
    _, ih, iw = label.shape
    xi = torch.round(xs).long().clamp(0, iw - 1)
    yi = torch.round(ys).long().clamp(0, ih - 1)
    out = _take(label[..., None], yi, xi)[..., 0]
    return torch.where(_inside(ys, xs, ih, iw), out, torch.full_like(out, fill))


def gaussian_blur(images):
    """cv2.GaussianBlur(5x5, sigma 0) with REFLECT_101 borders, (B, H, W, C)."""
    b, h, w, c = images.shape
    k = torch.tensor(_GAUSS5, dtype=images.dtype, device=images.device)
    x = images.permute(0, 3, 1, 2).reshape(b * c, 1, h, w)
    x = F.pad(x, (2, 2, 2, 2), mode="reflect")
    x = F.conv2d(x, k.view(1, 1, 5, 1))
    x = F.conv2d(x, k.view(1, 1, 1, 5))
    return x.reshape(b, c, h, w).permute(0, 2, 3, 1)


def _fmod(x, m: float):
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


def hsv_jitter(rgb, gains):
    """cv2's uint8 HSV round trip with LUT gains (dataloader.py:137-152):
    (B, H, W, 3) in [0, 255] with (B, 3) gains -> [0, 255]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    delta = v - mn
    pos = delta > 0
    safe = torch.where(pos, delta, torch.ones_like(delta))
    h = torch.where(v == r, 60.0 * (g - b) / safe,
                    torch.where(v == g, 120.0 + 60.0 * (b - r) / safe,
                                240.0 + 60.0 * (r - g) / safe))
    h = torch.where(pos, h, torch.zeros_like(h))
    h = torch.where(h < 0, h + 360.0, h) * 0.5
    s = torch.where(v > 0, 255.0 * delta / torch.where(v > 0, v,
                                                       torch.ones_like(v)),
                    torch.zeros_like(v))
    gh, gs, gv = (gains[:, k][:, None, None] for k in range(3))
    h = torch.floor(_fmod(torch.round(h) * gh, 180.0))
    s = torch.floor(torch.clamp(torch.round(s) * gs, 0.0, 255.0))
    v = torch.floor(torch.clamp(torch.round(v) * gv, 0.0, 255.0))
    c = v * (s / 255.0)
    hp = h * 2.0 / 60.0
    x = c * (1.0 - torch.abs(_fmod(hp, 2.0) - 1.0))
    m = v - c
    z = torch.zeros_like(c)
    i = torch.floor(hp).to(torch.int64) % 6

    def pick(a0, a1, a2, a3, a4, a5):
        out = a5
        for k, a in ((4, a4), (3, a3), (2, a2), (1, a1), (0, a0)):
            out = torch.where(i == k, a, out)
        return out + m

    out = torch.stack([pick(c, x, z, z, x, c), pick(x, c, c, x, z, z),
                       pick(z, z, x, c, c, x)], -1)
    return torch.clamp(out, 0.0, 255.0)


def _shear(planes, shift, axis: int, max_shift: int):
    """One shear of (B, S, S, 4) uint8 planes by the (B, S) float
    ``shift`` per row (``axis=2``) or per column (``axis=1``)."""
    s = planes.shape[axis]
    s_int = torch.floor(shift)
    w = torch.round((shift - s_int) * 256.0).to(torch.int32)
    u = torch.clamp(s_int, -max_shift, max_shift - 1).long()
    coord = torch.arange(s, device=planes.device)
    if axis == 2:
        idx = torch.remainder(coord[None, None, :] - u[:, :, None], s)
        wsh, cs = w[:, :, None, None], coord[None, None, :] - shift[:, :, None]
    else:
        idx = torch.remainder(coord[None, :, None] - u[:, None, :], s)
        wsh, cs = w[:, None, :, None], coord[None, :, None] - shift[:, None, :]
    idx = idx.expand(planes.shape[:3])
    y = torch.gather(planes.to(torch.int32), axis,
                     idx[..., None].expand(planes.shape))
    y_next = torch.roll(y, 1, dims=axis)
    lerp = (y * (256 - wsh) + y_next * wsh + 128) >> 8
    near = torch.where(wsh >= 128, y_next, y)
    out = torch.cat([lerp[..., :3], near[..., 3:]], dim=-1)
    valid = ((cs >= -0.5) & (cs <= s - 0.5))[..., None]
    fill = torch.tensor([128, 128, 128, 0], dtype=torch.int32,
                        device=planes.device)
    return torch.where(valid, out, fill).to(torch.uint8)


def rotate(planes, angle_deg):
    """The 3-shear rotation of (B, S, S, 4) uint8 planes about the canvas
    centre by ``angle_deg`` (B,), the shears' reach sized for 10 degrees."""
    s = planes.shape[1]
    c = float(s // 2)
    rad = math.radians(10.0)
    ms_x = int(math.ceil(math.tan(rad / 2) * (s - c))) + 2
    ms_y = int(math.ceil(math.sin(rad) * (s - c))) + 2
    theta = -angle_deg * (math.pi / 180.0)
    grid = torch.arange(s, dtype=torch.float32, device=planes.device) - c
    sh_x = -torch.tan(theta / 2.0)[:, None] * grid[None, :]
    sh_y = torch.sin(theta)[:, None] * grid[None, :]
    y = _shear(planes, sh_x, 2, ms_x)
    y = _shear(y, sh_y, 1, ms_y)
    return _shear(y, sh_x, 2, ms_x)


def augment(images, labels, p, dst_hw):
    """(B, H, W, 3) uint8 images and (B, H, W) uint8 labels -> (float32
    images in [0, 1], uint8 labels) at ``dst_hw``."""
    p = {k: v.to(images.device) for k, v in p.items()}
    flat = dict(p, angle=torch.zeros_like(p["angle"]))
    ys, xs = _source_coords(flat, images.shape[1:3], dst_hw)
    img = _bilinear(images.to(torch.float32), ys, xs, GRAY)
    lbl = _nearest(labels, ys, xs, 0)
    turn = torch.nonzero(p["angle"] != 0)[:, 0]
    if len(turn):
        planes = torch.cat([img[turn].round().clamp(0, 255).to(torch.uint8),
                            lbl[turn, ..., None].to(torch.uint8)], dim=-1)
        out = rotate(planes, p["angle"][turn])
        img[turn] = out[..., :3].to(torch.float32)
        lbl[turn] = out[..., 3].to(lbl.dtype)
    img = torch.where(p["blur"][:, None, None, None], gaussian_blur(img), img)
    return hsv_jitter(img, p["gains"]) / 255.0, lbl
