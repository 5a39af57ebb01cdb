"""The einsum formulation of the warp, letterbox path only — port of the
part of ``cervical_tpu/ops/warp_xla.py`` that the eval step runs.

The eval step letterboxes each batch to the model's input with the
deterministic parameters of ``ops.augment.letterbox_params_like``: a
separable resample as two batched products against per-image (B, out, in)
bf16 interpolation matrices, bf16 outputs, gray fill from the in-bounds
masks; labels the same in nearest mode.  These are plain batched matrix
products outside any TPU kernel, so they go to ``torch.einsum``.

The train-time branch (shear rotation, blur and HSV on batch
prefixes/suffixes, ``two_shear``, ``int8_resample``) is not ported yet:
``augment_batch_einsum(letterbox=False)`` raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cervical_tpu_torch.ops.augment import _const
from cervical_tpu_torch.ops.warp import (P_AX, P_AY, P_BX, P_BY, P_FILL, _fma,
                                         make_warp_params)


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


def augment_batch_einsum(images, labels, params, dst_hw: Tuple[int, int],
                         letterbox: bool = False, normalized: bool = True):
    """Letterbox ``images`` (B, H, W, 3) uint8 and ``labels`` (B, H, W) to
    ``dst_hw``: (images (B, S, S, 3) bf16, in [0, 1] if ``normalized``,
    labels (B, S, S) uint8).  ``letterbox=False`` is not ported yet."""
    if not letterbox:
        raise NotImplementedError(
            "the einsum backend's train-time warp is not ported yet; the "
            "train step uses ops.warp.augment_batch_kernels")
    s = dst_hw[0]
    wp = make_warp_params(params, images.shape[1:3], dst_hw,
                          letterbox=True).to(images.device)
    img = _resample(images, wp, s, nearest=False, fill=wp[:, P_FILL])
    lbl = _resample(labels[..., None], wp, s, nearest=True,
                    fill=torch.zeros_like(wp[:, P_FILL]))
    lbl = torch.round(lbl.to(torch.float32)).to(torch.uint8)[..., 0]
    if normalized:
        # x / 255 as XLA computes it: times the f32 reciprocal
        img = (img.to(torch.float32) * _const(1.0 / 255.0, wp)).to(
            torch.bfloat16)
    return img, lbl
