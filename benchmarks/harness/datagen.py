"""Synthetic colposcopy-like scenes, made on the device from a seed.

Each image is a smooth tinted background with a few elliptical lesions;
the label map gives each lesion's class (1 .. num_classes-1, the later
ellipse on top) over background 0, and a thin ring at each lesion's edge
is 255, the VOC border that the loss ignores.  Every seed gives the same
sizes and counts; only the content differs.
"""

from __future__ import annotations

import math

import torch


def scenes(seed: int, n: int, hw, num_classes: int, device,
           lesions=(2, 6), ring: float = 0.06, chunk: int = 32,
           labels: bool = True):
    """(images (n, H, W, 3) uint8, labels (n, H, W) uint8 or None) on
    ``device``, made in chunks of ``chunk`` images by one generator."""
    h, w = hw
    g = torch.Generator(device).manual_seed(seed)
    images = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    label = torch.empty((n, h, w), dtype=torch.uint8, device=device) \
        if labels else None
    yy = torch.linspace(0.0, 1.0, h, device=device)[None, :, None]
    xx = torch.linspace(0.0, 1.0, w, device=device)[None, None, :]
    k_max = lesions[1]

    def u(*shape):
        return torch.rand(shape, generator=g, device=device)

    for start in range(0, n, chunk):
        b = min(chunk, n - start)
        base = 60.0 + 140.0 * u(b, 1, 1, 3)
        slope = 40.0 * (u(b, 1, 1, 3) - 0.5)
        img = base + slope * (yy + xx)[..., None]
        lab = torch.zeros((b, h, w), device=device)
        edge = torch.zeros((b, h, w), dtype=torch.bool, device=device)
        count = lesions[0] + (u(b) * (k_max - lesions[0] + 1)).floor()
        cls = 1 + (u(b, k_max) * (num_classes - 1)).floor()
        tint = 80.0 * (u(b, k_max, 3) - 0.5)
        cy, cx = u(b, k_max), u(b, k_max)
        ay, ax = 0.05 + 0.2 * u(b, k_max), 0.05 + 0.2 * u(b, k_max)
        th = math.pi * u(b, k_max)
        for k in range(k_max):
            on = (count > k)[:, None, None]
            c, s = torch.cos(th[:, k])[:, None, None], \
                torch.sin(th[:, k])[:, None, None]
            dy, dx = yy - cy[:, k, None, None], xx - cx[:, k, None, None]
            r = ((c * dy + s * dx) / ay[:, k, None, None]) ** 2 \
                + ((c * dx - s * dy) / ax[:, k, None, None]) ** 2
            inside = (r <= 1.0) & on
            lab = torch.where(inside, cls[:, k, None, None], lab)
            edge = (edge & ~inside) | (on & (r > 1.0) & (r <= (1 + ring) ** 2))
            img = img + inside[..., None] * tint[:, k, None, None, :]
        img = img + 24.0 * (u(b, h, w, 3) - 0.5)
        images[start:start + b] = img.clamp(0, 255).round().to(torch.uint8)
        if labels:
            label[start:start + b] = torch.where(
                edge, torch.full_like(lab, 255.0), lab).to(torch.uint8)
    return images, label
