"""labelme JSON -> (JPEG, 8-bit class-index PNG) converter — the port's
copy of ``cervical_tpu/tools/labelme.py``.

Reference: ``Segmentation/deeplabv3+/json_to_dataset.py:19-69`` — iterates a
folder of labelme JSONs, rasterizes the polygon shapes into a paletted
class-index PNG and copies the embedded/source image.  Implemented without
the labelme package: base64 image decode + PIL polygon rasterization.
"""

from __future__ import annotations

import base64
import io
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw

# VOC-20 default class list (json_to_dataset.py:22)
VOC_CLASSES = [
    "_background_", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


def shapes_to_label(img_shape, shapes: Sequence[Dict],
                    label_name_to_value: Dict[str, int]) -> np.ndarray:
    """Rasterize labelme shapes (polygons/rectangles) into a class-id mask."""
    mask = Image.fromarray(np.zeros(img_shape[:2], np.uint8))
    draw = ImageDraw.Draw(mask)
    for shape in shapes:
        label = shape.get("label", "")
        if label not in label_name_to_value:
            continue
        value = label_name_to_value[label]
        pts = [tuple(p) for p in shape.get("points", [])]
        stype = shape.get("shape_type", "polygon")
        if stype == "rectangle" and len(pts) == 2:
            draw.rectangle(pts, fill=value)
        elif stype == "circle" and len(pts) == 2:
            (cx, cy), (px, py) = pts
            r = ((cx - px) ** 2 + (cy - py) ** 2) ** 0.5
            draw.ellipse([cx - r, cy - r, cx + r, cy + r], fill=value)
        elif len(pts) >= 3:
            draw.polygon(pts, fill=value)
    return np.asarray(mask)


def decode_image(record: Dict, json_dir: str) -> np.ndarray:
    if record.get("imageData"):
        raw = base64.b64decode(record["imageData"])
        return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
    path = os.path.join(json_dir, record["imagePath"])
    return np.asarray(Image.open(path).convert("RGB"))


def convert_folder(jsons_path: str, out_jpgs: str, out_pngs: str,
                   classes: Optional[List[str]] = None):
    """Convert every ``*.json`` under ``jsons_path``
    (json_to_dataset.py:19-69)."""
    classes = classes or VOC_CLASSES
    name_to_value = {name: i for i, name in enumerate(classes)}
    os.makedirs(out_jpgs, exist_ok=True)
    os.makedirs(out_pngs, exist_ok=True)
    converted = []
    for fn in sorted(os.listdir(jsons_path)):
        if not fn.endswith(".json"):
            continue
        with open(os.path.join(jsons_path, fn)) as f:
            record = json.load(f)
        img = decode_image(record, jsons_path)
        mask = shapes_to_label(img.shape, record.get("shapes", []),
                               name_to_value)
        stem = os.path.splitext(fn)[0]
        Image.fromarray(img).save(os.path.join(out_jpgs, stem + ".jpg"))
        png = Image.fromarray(mask, mode="P")
        palette = np.zeros((256, 3), np.uint8)
        base = np.array([[0, 0, 0], [128, 0, 0], [0, 128, 0], [128, 128, 0],
                         [0, 0, 128], [128, 0, 128], [0, 128, 128]], np.uint8)
        palette[:len(base)] = base
        png.putpalette(palette.reshape(-1).tolist())
        png.save(os.path.join(out_pngs, stem + ".png"))
        converted.append(stem)
    return converted
