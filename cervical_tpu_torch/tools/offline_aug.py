"""Offline dataset augmentation writers — the port's copy of
``cervical_tpu/tools/offline_aug.py``.

* Segmentation 8x augmentation (reference ``labelbox(aug).py:240-335,
  417-520``): per source image writes 8 variants — original, random left
  rotation 1-45 deg, random right rotation, Gaussian blur (radius 5),
  brighten +15%, darken -15%, X shift +-(20-30)px, Y shift — with paired
  masks replaying the recorded angles/shifts.  Outputs are renumbered
  ``00001.jpg...`` exactly like the reference.

  Deviation from the reference, as in the JAX package: masks are
  rotated/shifted with the *same* transform as their image — the reference
  rotates masks the opposite direction (``img.rotate(-left_angle)``,
  labelbox(aug).py:478) and mangles negative shifts, which de-aligns
  image/mask pairs; we treat that as a bug, not behavior to replicate.
  Photometric slots (blur/brightness) correctly keep unmodified masks, as
  in the reference (:493).

* Multimodal 5x augmentation (reference ``data_augmentation.py:206-279``):
  equalized original + h-flip + v-flip + blur + rotation, batched on the
  card by :mod:`cervical_tpu_torch.ops.histeq`.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter


def _pil_rotate(img: Image.Image, angle: float, resample) -> Image.Image:
    return img.rotate(angle, expand=False, fillcolor=0, resample=resample)


def _shift(img: Image.Image, dx: int, dy: int, fill=0) -> Image.Image:
    canvas = Image.new(img.mode, img.size, fill)
    canvas.paste(img, (dx, dy))
    return canvas


def augment_seg_8x(image: Image.Image, rng: np.random.Generator,
                   size: Tuple[int, int] = (512, 512)):
    """8 augmented images + the transform record (labelbox(aug).py:240-335)."""
    img = image.resize(size)
    left = int(rng.integers(1, 46))
    right = int(rng.integers(-45, 0))
    x_move = int(rng.integers(20, 31)) * (1 if rng.random() > 0.5 else -1)
    y_move = int(rng.integers(20, 31)) * (1 if rng.random() > 0.5 else -1)
    variants = [
        img,
        _pil_rotate(img, left, Image.BICUBIC),
        _pil_rotate(img, right, Image.BICUBIC),
        img.filter(ImageFilter.GaussianBlur(5)),
        ImageEnhance.Brightness(img).enhance(1.15),
        ImageEnhance.Brightness(img).enhance(0.85),
        _shift(img, x_move, 0),
        _shift(img, 0, y_move),
    ]
    record = {"left": left, "right": right, "x": x_move, "y": y_move}
    return variants, record


def replay_mask_8x(mask: Image.Image, record,
                   size: Tuple[int, int] = (512, 512)):
    """Paired mask variants replaying the recorded geometric transforms with
    nearest-neighbor resampling; photometric slots keep the original mask."""
    m = mask.resize(size, Image.NEAREST)
    return [
        m,
        _pil_rotate(m, record["left"], Image.NEAREST),
        _pil_rotate(m, record["right"], Image.NEAREST),
        m, m, m,  # blur / brighten / darken leave the mask untouched
        _shift(m, record["x"], 0),
        _shift(m, 0, record["y"]),
    ]


def write_seg_augmented(voc_root: str, out_root: str, ids: Sequence[str],
                        seed: int = 0, size=(512, 512), log=print):
    """Expand ``ids`` 8x into a new VOC layout with sequential numbering
    (labelbox(aug).py:417-520).  Returns the list of new ids."""
    rng = np.random.default_rng(seed)
    jdir = os.path.join(voc_root, "VOC2007", "JPEGImages")
    sdir = os.path.join(voc_root, "VOC2007", "SegmentationClass")
    out_j = os.path.join(out_root, "VOC2007", "JPEGImages")
    out_s = os.path.join(out_root, "VOC2007", "SegmentationClass")
    os.makedirs(out_j, exist_ok=True)
    os.makedirs(out_s, exist_ok=True)
    new_ids = []
    num = 1
    for image_id in ids:
        jpath = os.path.join(jdir, f"{image_id}.jpg")
        spath = os.path.join(sdir, f"{image_id}.png")
        if not (os.path.exists(jpath) and os.path.exists(spath)):
            log(f"missing pair for id {image_id}, skipping")
            continue
        img = Image.open(jpath).convert("RGB")
        mask = Image.open(spath)
        variants, record = augment_seg_8x(img, rng, size)
        mask_variants = replay_mask_8x(mask, record, size)
        for v, mv in zip(variants, mask_variants):
            name = f"{num:05d}"
            v.save(os.path.join(out_j, name + ".jpg"))
            mv.save(os.path.join(out_s, name + ".png"))
            new_ids.append(name)
            num += 1
    return new_ids


def write_split_ids(ids: Sequence, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for i in ids:
            f.write(f"{i}\n")


def augment_multimodal_5x(images_u8: np.ndarray,
                          angles: Optional[np.ndarray] = None,
                          device="cuda") -> np.ndarray:
    """Batched 5x multimodal augmentation on ``device``
    (data_augmentation.py:206-279): returns (5, B, H, W, 3) float32 RGB."""
    import torch
    from cervical_tpu_torch.ops.histeq import fivefold_augment
    x = torch.as_tensor(np.asarray(images_u8), dtype=torch.float32,
                        device=device)
    out = fivefold_augment(
        x, None if angles is None else torch.as_tensor(
            np.asarray(angles), dtype=torch.float32))
    return out.cpu().numpy()


def write_multimodal_augmented(src_dir: str, out_dir: str, seed: int = 0,
                               batch: int = 16, log=print, device="cuda"):
    """Expand a folder of modality images 5x (equalize/flip/flip/blur/rotate),
    writing ``<stem>_aug{k}.png``."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    files = [f for f in sorted(os.listdir(src_dir))
             if f.lower().endswith((".png", ".jpg", ".tif", ".tiff"))]
    written = []
    for start in range(0, len(files), batch):
        chunk = files[start:start + batch]
        imgs = []
        for f in chunk:
            img = Image.open(os.path.join(src_dir, f)).convert("RGB")
            imgs.append(np.asarray(img.resize((512, 512)), np.uint8))
        angles = rng.integers(1, 46, len(chunk)).astype(np.float32)
        out = augment_multimodal_5x(np.stack(imgs), angles, device=device)
        for k in range(5):
            for j, f in enumerate(chunk):
                stem = os.path.splitext(f)[0]
                name = f"{stem}_aug{k}.png"
                Image.fromarray(np.clip(out[k, j], 0, 255).astype(np.uint8)
                                ).save(os.path.join(out_dir, name))
                written.append(name)
    return written
