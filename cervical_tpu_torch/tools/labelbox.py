"""Labelbox NDJSON -> class masks pipeline — the port's copy of
``cervical_tpu/tools/labelbox.py``.

Reference: ``Segmentation/deeplabv3+/labelbox(aug).py:19-229`` — parse the
NDJSON export for per-annotation mask URLs, download the white-on-black
masks, recolor by class, merge per image by summation, then map colors to
gray class ids {0..4} and copy the matching JPEGs.

Network download is isolated behind ``fetch_fn`` so the pipeline works on
pre-downloaded mask files (and in tests) without Labelbox credentials.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
from PIL import Image

# class -> mask color (labelbox(aug).py:71-77)
COLOR_MAP = {
    "AWE": (255, 255, 0),
    "Punctation": (255, 0, 0),
    "Mosaic": (0, 255, 0),
    "Atypical": (0, 0, 255),
}

# color -> gray class id (labelbox(aug).py:166-172)
COLOR_TO_GRAY = {
    (0, 0, 0): 0,
    (255, 255, 0): 1,
    (255, 0, 0): 2,
    (0, 255, 0): 3,
    (0, 0, 255): 4,
}


def parse_ndjson(path: str):
    """Extract per-annotation mask URLs + image ids (labelbox(aug).py:19-46).

    Returns (class_mask_urls, composite_mask_urls, id_urls, id_counts).
    """
    class_mask_urls: List[Dict] = []
    composite_mask_urls: List[Dict] = []
    id_urls: List[str] = []
    id_counts = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            data = json.loads(line)
            id_url = data.get("data_row", {}).get("external_id", "").split(".")[0]
            id_urls.append(id_url)
            projects = data.get("projects", {})
            annotations = []
            if projects:
                first = projects[next(iter(projects))]
                labels = first.get("labels", [])
                if labels:
                    annotations = labels[0].get("annotations", {}).get("objects", [])
            id_counts.append((id_url, len(annotations)))
            for obj in annotations:
                name = obj.get("name", "Unknown")
                if obj.get("mask", {}).get("url"):
                    class_mask_urls.append({"image_name": id_url, "name": name,
                                            "url": obj["mask"]["url"]})
                if obj.get("composite_mask", {}).get("url"):
                    composite_mask_urls.append(
                        {"image_name": id_url, "name": name,
                         "url": obj["composite_mask"]["url"]})
    return class_mask_urls, composite_mask_urls, id_urls, id_counts


def default_fetch_fn(api_key: str) -> Callable[[str], np.ndarray]:
    """HTTP fetcher for Labelbox mask URLs (requires network + API key)."""
    def fetch(url: str) -> np.ndarray:
        import io
        import requests
        r = requests.get(url, headers={"Authorization": f"Bearer {api_key}"})
        r.raise_for_status()
        return np.array(Image.open(io.BytesIO(r.content)).convert("RGBA"))
    return fetch


def recolor_mask(mask_rgba: np.ndarray, classification: str) -> np.ndarray:
    """White annotation pixels -> class color (labelbox(aug).py:79-86)."""
    data = mask_rgba.copy()
    white = (data[..., 0] == 255) & (data[..., 1] == 255) & (data[..., 2] == 255)
    data[..., :3][white] = COLOR_MAP[classification]
    return data


def merge_masks(masks: List[np.ndarray]) -> Image.Image:
    """Merge per-class colored masks by summation (labelbox(aug).py:89-95)."""
    merged = np.sum(np.stack(masks, 0).astype(np.int64), axis=0)
    return Image.fromarray(np.clip(merged, 0, 255).astype(np.uint8))


def build_color_masks(class_mask_urls, fetch_fn, save_dir: str):
    """Download, recolor, merge per image, save ``<image_name>.png``
    (labelbox(aug).py:96-133)."""
    os.makedirs(save_dir, exist_ok=True)
    by_image: Dict[str, List[np.ndarray]] = {}
    for rec in class_mask_urls:
        rgba = fetch_fn(rec["url"])
        by_image.setdefault(rec["image_name"], []).append(
            recolor_mask(rgba, rec["name"]))
    out_paths = []
    for image_name, masks in by_image.items():
        img = merge_masks(masks).convert("RGB")
        p = os.path.join(save_dir, f"{image_name}.png")
        img.save(p)
        out_paths.append(p)
    return out_paths


def colors_to_gray(input_dir: str, output_dir: str,
                   color_to_gray: Optional[Dict] = None):
    """Color masks -> 8-bit class-id masks (labelbox(aug).py:166-199)."""
    mapping = color_to_gray or COLOR_TO_GRAY
    os.makedirs(output_dir, exist_ok=True)
    converted = []
    for filename in sorted(os.listdir(input_dir)):
        if not filename.endswith(".png"):
            continue
        arr = np.array(Image.open(os.path.join(input_dir, filename)).convert("RGB"))
        gray = np.zeros(arr.shape[:2], np.uint8)
        for rgb, gid in mapping.items():
            gray[(arr == rgb).all(axis=-1)] = gid
        out = os.path.join(output_dir, filename)
        Image.fromarray(gray).save(out)
        converted.append(out)
    return converted


def copy_images_by_id(id_urls, source_folder: str, target_folder: str,
                      ext: str = ".jpg"):
    """Copy the JPEGs whose ids appear in the NDJSON
    (labelbox(aug).py:205-229)."""
    target = Path(target_folder)
    target.mkdir(parents=True, exist_ok=True)
    copied, missing = [], []
    for image_id in id_urls:
        src = Path(source_folder) / f"{image_id}{ext}"
        if src.exists():
            shutil.copy(src, target / src.name)
            copied.append(str(src))
        else:
            missing.append(str(src))
    return copied, missing
