"""Offline multimodal feature extraction: images + ages -> cohort.npz — the
port's counterpart of ``scripts/build_graphs.py`` (replaces ``MultiModal
Prediction/Graph_Structure(data_augmentation).py``).

Expects per-modality image folders with files named ``<patient_id>*.{png,
jpg,tif}`` and a CSV/XLSX table with columns (id, age, diagnosis); the
diagnosis is a class index or one of ``DIAGNOSIS_MAPPING``'s names.

Usage:
    python -m cervical_tpu_torch.build_graphs --table patients.xlsx \
        --imgN path/N --imgA path/A --imgL path/L --out cohort.npz \
        [--resnet_depth 101] [--resnet_ckpt resnet101.pth] [--device cuda]

``--resnet_ckpt``: a torchvision ResNet ``state_dict``, loaded by name
(its 1000-class ``fc`` is left out, as the JAX CLI's ``with_fc=False``
leaves it); without it the featurizer takes a seeded random init.  Each
image is one forward of its 16 patches on ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import math
import os
import sys
from typing import Dict, Mapping, Sequence

import numpy as np

IMAGE_SUFFIXES = (".png", ".jpg", ".tif", ".tiff")
MODALITY_FLAGS = ("imgN", "imgA", "imgL")


def read_table(path):
    """(ids, {id: age}, {id: class index}) of a CSV/XLSX table whose first
    three columns are id, age and diagnosis; pandas infers the ids' type
    (so an id column of numbers gives ints) and keeps the table's order."""
    import pandas as pd
    from cervical_tpu_torch.data.graphs import DIAGNOSIS_MAPPING
    df = (pd.read_excel(path) if path.endswith((".xlsx", ".xls"))
          else pd.read_csv(path))
    id_col, age_col, diag_col = list(df.columns)[:3]
    ids = df[id_col].tolist()
    ages = dict(zip(ids, df[age_col].tolist()))
    diagnosis = {}
    for i, d in zip(ids, df[diag_col].tolist()):
        if d in DIAGNOSIS_MAPPING:
            d = DIAGNOSIS_MAPPING[d]
        elif (not isinstance(d, (int, float)) or isinstance(d, bool)
              or not math.isfinite(d) or int(d) != d):
            raise SystemExit(
                f"patient {i!r}: diagnosis {d!r} is neither a class index "
                f"nor one of {sorted(DIAGNOSIS_MAPPING)} "
                "(Graph_Structure:42-47)")
        diagnosis[i] = int(d)
    return ids, ages, diagnosis


def featurize_folders(featurizer, ids: Sequence, folders: Mapping[str, str],
                      log=print) -> Dict[str, Dict]:
    """{modality: {pid: (16, D)}} of the first file in each modality's
    folder whose name starts with the patient's id (a patient without one
    is left out of that modality), one :meth:`featurize_image` each."""
    from PIL import Image
    image_feats = {}
    for mod, folder in folders.items():
        names = os.listdir(folder)
        per_patient = {}
        for pid in ids:
            matches = [f for f in names if f.startswith(str(pid))
                       and f.lower().endswith(IMAGE_SUFFIXES)]
            if not matches:
                continue
            with Image.open(os.path.join(folder, matches[0])) as im:
                img = np.asarray(im.convert("RGB"))
            per_patient[pid] = featurizer.featurize_image(img)
            log(f"{mod} {pid}: {per_patient[pid].shape}")
        image_feats[mod] = per_patient
    return image_feats


def main(argv):
    from cervical_tpu_torch.config import parse_cli_overrides
    from cervical_tpu_torch.data.fusion_data import save_npz
    from cervical_tpu_torch.data.graphs import (PatchFeaturizer,
                                                assemble_cohort,
                                                build_cli_features)

    args = parse_cli_overrides(argv)
    ids, ages, diagnosis = read_table(args["table"])
    depth = int(args.get("resnet_depth", 101))
    feat = PatchFeaturizer(depth=depth, device=args.get("device", "cuda"))
    if "resnet_ckpt" in args:
        from cervical_tpu_torch.train import torch_import as TI
        sd = {k: v for k, v in TI.load_state_dict(args["resnet_ckpt"]).items()
              if not k.startswith("fc.")}
        loaded, _ = TI.load_into(feat.model, sd)
        print(f"loaded {len(loaded)} tensors from {args['resnet_ckpt']}")

    image_feats = featurize_folders(
        feat, ids, {m: args[m] for m in MODALITY_FLAGS if m in args})
    cli = build_cli_features(ages)
    ds = assemble_cohort(image_feats, cli, diagnosis)
    out = args.get("out", "cohort.npz")
    save_npz(out, ds)
    print(f"wrote {out}: {len(ds['ids'])} patients, modalities "
          f"{list(ds['feats'])}")
    return ds


if __name__ == "__main__":
    main(sys.argv[1:])
