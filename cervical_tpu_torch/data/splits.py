"""Patient-level splits — the port's copy of ``cervical_tpu/data/splits.py``
(reference: ``StratifiedKFold(n_splits).split`` + the inner
``train_test_split``, my_train(full).py:486-517).  numpy with explicit
seeds: the same seed gives the JAX package's index sets exactly.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def stratified_kfold(labels: Sequence[int], n_splits: int, seed: int = 0,
                     shuffle: bool = True):
    """Yield (train_idx, test_idx) preserving label proportions per fold."""
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)
    folds: List[List[int]] = [[] for _ in range(n_splits)]
    for cls in np.unique(labels):
        idx = np.nonzero(labels == cls)[0]
        if shuffle:
            rng.shuffle(idx)
        for i, j in enumerate(idx):
            folds[i % n_splits].append(int(j))
    for k in range(n_splits):
        test = np.sort(np.asarray(folds[k], int))
        train = np.sort(np.asarray(
            [j for f in range(n_splits) if f != k for j in folds[f]], int))
        yield train, test


def train_test_split(indices: Sequence[int], test_size: float, seed: int = 0,
                     stratify: Sequence[int] | None = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Shuffled (train, test) split; optional stratification (>= 2 members
    per class, as sklearn requires)."""
    indices = np.asarray(indices)
    rng = np.random.default_rng(seed)
    if stratify is None:
        perm = rng.permutation(len(indices))
        n_test = max(1, int(round(len(indices) * test_size)))
        return indices[perm[n_test:]], indices[perm[:n_test]]
    stratify = np.asarray(stratify)
    train_parts, test_parts = [], []
    for cls in np.unique(stratify):
        sub = indices[stratify == cls]
        if len(sub) < 2:
            raise ValueError(
                f"stratified split needs >= 2 members per class; class "
                f"{cls!r} has {len(sub)}")
        perm = rng.permutation(len(sub))
        n_test = max(1, int(round(len(sub) * test_size)))
        test_parts.append(sub[perm[:n_test]])
        train_parts.append(sub[perm[n_test:]])
    return (np.sort(np.concatenate(train_parts)),
            np.sort(np.concatenate(test_parts)))


def ratio_split(ids: Sequence, ratios=(0.6, 0.2, 0.2), seed: int = 0):
    """3:1:1-style shuffled id split (data_augmentation.py:148-197)."""
    ids = list(ids)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(ids))
    n = len(ids)
    n_train = int(n * ratios[0])
    n_val = int(n * ratios[1])
    pick = lambda sl: [ids[i] for i in order[sl]]  # noqa: E731
    return (pick(slice(0, n_train)),
            pick(slice(n_train, n_train + n_val)),
            pick(slice(n_train + n_val, n)))
