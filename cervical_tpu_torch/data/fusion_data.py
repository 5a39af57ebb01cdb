"""Fusion cohort container + synthetic generator — the port's copy of
``cervical_tpu/data/fusion_data.py``.

A cohort is a dict of stacked, static-shape arrays (the reference keeps one
``torch_geometric.data.Data`` per patient in a joblib pickle,
``Graph_Structure(data_augmentation).py:379-399``)::

    {
      'feats':   {modality: (N, nodes_m, 1024) float32},
      'labels':  (N,) int32 diagnosis class (CIS/mild/moderate/severe),
      'present': (N, T) bool modality availability,
      'ids':     list[str] patient ids,
    }

saved as ``.npz`` in the JAX package's layout, so either package reads the
other's files.  ``feats``, ``labels`` and ``present`` may also be torch
tensors (the trainer keeps its cohort on the card); :func:`subset` takes
either.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from cervical_tpu_torch.models.fusion import ALL_MODALITIES


def node_count(modality: str, image_patches: int = 16, cli_nodes: int = 4):
    return cli_nodes if modality == "cli" else image_patches


def make_dataset(feats: Dict[str, np.ndarray], labels, present=None, ids=None):
    n = len(labels)
    mods = tuple(feats.keys())
    if present is None:
        present = np.ones((n, len(mods)), bool)
    if ids is None:
        ids = [str(i) for i in range(n)]
    return {"feats": {m: np.asarray(v, np.float32) for m, v in feats.items()},
            "labels": np.asarray(labels, np.int32),
            "present": np.asarray(present, bool),
            "ids": list(ids)}


def _take(v, idx):
    if torch.is_tensor(v):
        return v.index_select(0, torch.as_tensor(idx, device=v.device))
    return v[idx]


def subset(ds, idx):
    idx = np.asarray(idx)
    return {"feats": {m: _take(v, idx) for m, v in ds["feats"].items()},
            "labels": _take(ds["labels"], idx),
            "present": _take(ds["present"], idx),
            "ids": [ds["ids"][i] for i in idx]}


def save_npz(path: str, ds):
    arrays = {f"feat_{m}": np.asarray(v) for m, v in ds["feats"].items()}
    # the modality order, explicitly: 'present' columns follow it
    arrays["modalities"] = np.asarray(list(ds["feats"].keys()))
    if ds.get("labels") is not None:
        arrays["labels"] = np.asarray(ds["labels"])
    arrays["present"] = np.asarray(ds["present"])
    arrays["ids"] = np.asarray(ds["ids"])
    np.savez_compressed(path, **arrays)


def load_npz(path: str):
    """Load a cohort npz.  ``labels`` is optional (deployment cohorts have
    none); ``present``/``ids`` default to all-present / positional ids;
    ``modalities`` keeps the column order of ``present`` (npz key order for
    archives written before it was recorded)."""
    z = np.load(path, allow_pickle=False)
    mods = ([str(m) for m in z["modalities"]] if "modalities" in z.files
            else [k[len("feat_"):] for k in z.files
                  if k.startswith("feat_")])
    feats = {m: z[f"feat_{m}"] for m in mods}
    n = len(next(iter(feats.values()))) if feats else 0
    return {"feats": feats,
            "modalities": mods,
            "labels": z["labels"] if "labels" in z.files else None,
            "present": (z["present"] if "present" in z.files
                        else np.ones((n, len(mods)), bool)),
            "ids": ([str(s) for s in z["ids"]] if "ids" in z.files
                    else [str(i) for i in range(n)])}


def align_to_modalities(ds, modalities: Sequence[str]):
    """Restrict a cohort to ``modalities``: ``feats`` AND the matching
    ``present`` columns, by name in the cohort's recorded modality order."""
    missing = [m for m in modalities if m not in ds["feats"]]
    if missing:
        raise ValueError(
            f"cohort lacks modalities {missing}; has "
            f"{sorted(ds['feats'].keys())}")
    cohort_order = list(ds.get("modalities") or ds["feats"].keys())
    cols = [cohort_order.index(m) for m in modalities]
    out = dict(ds)
    out["feats"] = {m: ds["feats"][m] for m in modalities}
    out["modalities"] = list(modalities)
    out["present"] = np.asarray(ds["present"])[:, cols]
    return out


def make_synthetic_fusion(num_patients: int = 64,
                          modalities: Sequence[str] = ALL_MODALITIES,
                          num_classes: int = 4, feature_dim: int = 1024,
                          seed: int = 0, noise: float = 0.5):
    """Synthetic cohort whose class signal is embedded in every modality's
    node features, so a few epochs must lift accuracy above chance; the
    JAX package's generator, draw for draw."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, num_patients)
    protos = rng.normal(size=(num_classes, feature_dim)).astype(np.float32)
    feats = {}
    for m in modalities:
        nodes = node_count(m)
        base = protos[labels][:, None, :]  # (N, 1, D)
        feats[m] = (base + noise * rng.normal(
            size=(num_patients, nodes, feature_dim))).astype(np.float32)
    return make_dataset(feats, labels)
