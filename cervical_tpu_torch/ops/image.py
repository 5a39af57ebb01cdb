"""Image ops: bilinear resize, letterboxing, normalization (NHWC tensors).

Port of ``cervical_tpu/ops/image.py``.  Resizes keep the JAX package's
form — separable 1-D interpolation matrices applied as two matmuls — since
the matrices pin both ``align_corners`` conventions exactly.  Public
functions take NHWC (or HWC) tensors, as in JAX.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _interp_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """(out, in) bilinear interpolation weight matrix."""
    w = np.zeros((out_size, in_size), np.float32)
    if out_size == 1:
        # torch align_corners=True with a single output sample takes index 0.
        w[0, 0] = 1.0
        return w
    if align_corners:
        coords = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    else:
        coords = (np.arange(out_size) + 0.5) * in_size / out_size - 0.5
        coords = np.clip(coords, 0, in_size - 1)
    lo = np.floor(coords).astype(int)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = coords - lo
    w[np.arange(out_size), lo] += 1 - frac
    w[np.arange(out_size), hi] += frac
    return w


@functools.lru_cache(maxsize=64)
def _resident_interp(in_size: int, out_size: int, align_corners: bool,
                     device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(_interp_matrix(
            in_size, out_size, align_corners)).to(device=device, dtype=dtype)


# the resident matrices a CUDA graph captured: the graph reads them by
# address for its whole life, so they outlive the lru cache's evictions
_CAPTURED: set = set()


def _interp_tensor(in_size: int, out_size: int, align_corners: bool,
                   device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """:func:`_interp_matrix` resident on ``device`` (uploaded once).  Made
    outside inference mode, so a matrix first cached by an inference call
    can still be saved for a backward pass.  Under a trace
    (``torch.export``) a new one each call: a cached one would keep the
    trace's fake tensor for every later call."""
    if torch.compiler.is_compiling():
        return torch.tensor(_interp_matrix(in_size, out_size, align_corners),
                            device=device, dtype=dtype)
    m = _resident_interp(in_size, out_size, align_corners, device, dtype)
    if m.is_cuda and torch.cuda.is_current_stream_capturing():
        _CAPTURED.add(m)
    return m


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool = True):
    """Bilinear resize of NHWC (or HWC) tensors via two matmuls.

    Matches ``F.interpolate(mode='bilinear', align_corners=...)``; the
    matrices take ``x``'s dtype, as in JAX.
    """
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    _, h, w, _ = x.shape
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x[0] if squeeze else x
    wh = _interp_tensor(h, oh, align_corners, x.device, x.dtype)
    ww = _interp_tensor(w, ow, align_corners, x.device, x.dtype)
    y = torch.einsum("oh,bhwc->bowc", wh, x)
    y = torch.einsum("pw,bowc->bopc", ww, y)
    return y[0] if squeeze else y


def preprocess_input(x):
    """Pixel scaling: /255 only (utils/utils.py:63-65)."""
    return x / 255.0


def letterbox_params(src_hw, dst_hw):
    """Aspect-preserving resize-and-center geometry (utils/utils.py:21-33).

    Returns (new_h, new_w, pad_top, pad_left).
    """
    ih, iw = src_hw
    h, w = dst_hw
    scale = min(w / iw, h / ih)
    nw, nh = int(iw * scale), int(ih * scale)
    return nh, nw, (h - nh) // 2, (w - nw) // 2


def letterbox_image(image: torch.Tensor, dst_hw, fill=128,
                    align_corners: bool = False):
    """Resize with unchanged aspect ratio, pad with gray (``resize_image``,
    utils/utils.py:21-33).

    ``image``: (H, W, C) or (N, H, W, C), float or uint8.  Returns float32.
    Bilinear resampling (the reference uses PIL BICUBIC; docs/PARITY.md).
    """
    ih, iw, c = image.shape[-3:]
    h, w = dst_hw
    nh, nw, top, left = letterbox_params((ih, iw), (h, w))
    resized = resize_bilinear(image.to(torch.float32), (nh, nw),
                              align_corners=align_corners)
    canvas = torch.full(tuple(image.shape[:-3]) + (h, w, c), float(fill),
                        dtype=torch.float32, device=image.device)
    canvas[..., top:top + nh, left:left + nw, :] = resized
    return canvas


def unletterbox_logits(logits_hwc: torch.Tensor, src_hw, dst_hw):
    """Crop letterbox padding and resize per-class scores back to the original
    image size (deeplab.py:137-150,322-334).  (H, W, C) or (N, H, W, C)."""
    nh, nw, top, left = letterbox_params(src_hw, dst_hw)
    cropped = logits_hwc[..., top:top + nh, left:left + nw, :]
    return resize_bilinear(cropped, src_hw, align_corners=False)


def letterbox_label(label: torch.Tensor, dst_hw, fill=0):
    """Nearest-neighbor letterbox for (H, W) integer masks
    (dataloader.py:74-77)."""
    ih, iw = label.shape[:2]
    h, w = dst_hw
    nh, nw, top, left = letterbox_params((ih, iw), (h, w))
    dev = label.device
    rows = torch.clamp((torch.arange(nh, device=dev) + 0.5) * ih / nh, 0,
                       ih - 1).long()
    cols = torch.clamp((torch.arange(nw, device=dev) + 0.5) * iw / nw, 0,
                       iw - 1).long()
    canvas = torch.full((h, w), fill, dtype=label.dtype, device=dev)
    canvas[top:top + nh, left:left + nw] = label[rows][:, cols]
    return canvas


def one_hot_with_ignore(labels: torch.Tensor, num_classes: int):
    """Labels -> f32 one-hot with an extra trailing ignore channel: values
    >= num_classes land in it (dataloader.py:41-48)."""
    clamped = torch.clamp(labels.long(), max=num_classes)
    return torch.nn.functional.one_hot(clamped, num_classes + 1).to(
        torch.float32)
