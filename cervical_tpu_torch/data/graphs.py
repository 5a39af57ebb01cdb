"""Offline multimodal feature pipeline: age features, patch featurization,
cohort assembly — port of ``cervical_tpu/data/graphs.py``.

Reference: ``MultiModal Prediction/Graph_Structure(data_augmentation).py``
— (L1) ResNet-101 features of each 256x256 patch of the N/A/L colposcopy
images (:131-283) and the 4-row age ("cli") feature stack (:58-127);
(L2) per-patient graphs pickled with joblib (:325-399), which become the
dense static-topology cohort arrays of :mod:`cervical_tpu_torch.data.
fusion_data` (the grid and cli adjacencies live in the model).

A :class:`PatchFeaturizer` runs one batched forward per call on its device
(the reference loops patch by patch at batch 1); the CLI calls it per
image.  The age embedding tables are N(0, 1) draws from a seeded torch
generator, where the JAX package draws them with ``jax.random.normal``:
same distribution, other values (ROADMAP §3).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

DIAGNOSIS_MAPPING = {  # Graph_Structure:42-47
    "CIS": 0,
    "Mild dysplasia": 1,
    "Moderate dysplasia": 2,
    "Severe dysplasia": 3,
}


# ---------------------------------------------------------------------------
# Age ("cli") features — Graph_Structure:58-127
# ---------------------------------------------------------------------------

def normalize_ages(ages: Dict, min_age=None, max_age=None) -> Dict:
    """Center/scale to [-1, 1]: ``(age - (max+min)/2) / (max-min) * 2``."""
    vals = list(ages.values())
    mx = max_age if max_age is not None else max(vals)
    mn = min_age if min_age is not None else min(vals)
    span = max(mx - mn, 1e-12)
    return {k: (v - (mx + mn) / 2) / span * 2 for k, v in ages.items()}


def age_to_one_hot(age, num_categories=20, vector_length=1024) -> np.ndarray:
    """5-year-bin one-hot tiled to ``vector_length`` dims
    (Graph_Structure:79-85).

    Quirk kept: the reference applies the same function to *normalized*
    ages in [-1, 1], where ``int(age // 5)`` is -1 for negatives and
    python's negative indexing sets the *last* bin; the wrap reproduces
    that."""
    category = int(np.floor(age / 5)) % num_categories
    one_hot = np.zeros(num_categories, np.float32)
    one_hot[category] = 1.0
    repeated = np.tile(one_hot, vector_length // num_categories + 1)
    return repeated[:vector_length]


def make_embedding_table(num_embeddings: int, dim: int = 1024,
                         seed: int = 0) -> np.ndarray:
    """Random N(0, 1) embedding table from a torch generator seeded with
    ``seed``.  The reference's ``nn.Embedding`` layers are never trained:
    the age embedding rows are fixed random vectors
    (Graph_Structure:100-115)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((num_embeddings, dim), generator=g).numpy()


def build_cli_features(ages: Dict, dim: int = 1024, seed: int = 0) -> Dict:
    """Per-patient (4, dim) age feature stack (Graph_Structure:117-127):
    [one_hot(age), one_hot(normalized age), embed(age), embed(normalized)]."""
    norm = normalize_ages(ages)
    max_age = int(max(ages.values()))
    table_raw = make_embedding_table(max_age + 1, dim, seed)
    table_std = make_embedding_table(101, dim, seed + 1)
    out = {}
    for pid, age in ages.items():
        rows = [
            age_to_one_hot(age, vector_length=dim),
            age_to_one_hot(norm[pid], vector_length=dim),
            table_raw[int(age)],
            table_std[int((norm[pid] + 1) / 2 * 100)],
        ]
        out[pid] = np.stack(rows).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# Image patch featurization — Graph_Structure:131-283
# ---------------------------------------------------------------------------

def resize_and_split(image: np.ndarray, target_size=1024,
                     split_size=256) -> np.ndarray:
    """Upscale to ``target_size`` (bilinear, ``align_corners=False``) then
    cut into a grid of ``split_size`` patches (Graph_Structure:151-161).
    Returns (n_patches, s, s, 3) float32 in the reference's PIL-crop order
    (x-major), which the symmetric grid adjacency is invariant to."""
    from cervical_tpu_torch.ops.image import resize_bilinear
    resized = resize_bilinear(
        torch.from_numpy(np.asarray(image, np.float32)),
        (target_size, target_size), align_corners=False).numpy()
    patches = []
    for i in range(0, target_size, split_size):      # x (PIL crop left)
        for j in range(0, target_size, split_size):  # y (PIL crop upper)
            patches.append(resized[j:j + split_size, i:i + split_size])
    return np.stack(patches)


class PatchFeaturizer:
    """ResNet patch featurizer on ``device`` (``cuda`` by default): the
    model in eval mode, fp32, under ``torch.inference_mode``.  Weights: a
    ``state_dict`` (``state``), else the seeded flax-style init of
    ``resnet.init_weights`` (``seed``)."""

    def __init__(self, depth: int = 101, out_features: int = 1024,
                 state: Optional[Mapping[str, torch.Tensor]] = None,
                 seed: int = 0, device: str = "cuda"):
        from cervical_tpu_torch.models.backbones.resnet import (
            ResNetFeaturizer, init_weights)
        self.device = torch.device(device)
        self.model = ResNetFeaturizer(depth=depth, out_features=out_features)
        if state is None:
            init_weights(self.model, torch.Generator().manual_seed(seed))
        else:
            self.model.load_state_dict(state)
        self.model.to(self.device, memory_format=torch.channels_last).eval()

    @torch.inference_mode()
    def __call__(self, patches_u8: np.ndarray) -> np.ndarray:
        """(N, s, s, 3) uint8 -> (N, out_features) float32, one forward."""
        from cervical_tpu_torch.models.backbones.resnet import \
            preprocess_imagenet
        x = torch.from_numpy(np.ascontiguousarray(patches_u8)).to(self.device)
        y = self.model(preprocess_imagenet(x).permute(0, 3, 1, 2))
        return y.float().cpu().numpy()

    def featurize_image(self, image: np.ndarray) -> np.ndarray:
        """The reference's flow: a 512² image -> 1024² -> 16 patches ->
        (16, 1024) node features (the uint8 cast truncates, as in JAX)."""
        return self(resize_and_split(image).astype(np.uint8))


def assemble_cohort(image_feats: Dict[str, Dict], cli_feats: Dict,
                    diagnosis: Dict, modalities=("imgN", "imgA", "imgL", "cli")):
    """Stack per-patient features into the cohort dict of
    :mod:`cervical_tpu_torch.data.fusion_data` (replaces the per-patient
    pyg.Data pickle at Graph_Structure:379-399).

    ``image_feats``: {"imgN": {pid: (16, D)}, ...}; ``cli_feats``:
    {pid: (4, D)}; patients missing a modality get zeros + present=False.
    """
    from cervical_tpu_torch.data.fusion_data import make_dataset

    pids = sorted(diagnosis.keys())
    feats = {}
    present = np.ones((len(pids), len(modalities)), bool)
    for mi, m in enumerate(modalities):
        source = cli_feats if m == "cli" else image_feats.get(m, {})
        if not source:
            raise ValueError(
                f"modality {m!r} has no features for any patient — "
                "remove it from `modalities` or provide its feature dict")
        sample = next(iter(source.values()))
        arr = np.zeros((len(pids),) + sample.shape, np.float32)
        for pi, pid in enumerate(pids):
            if pid in source:
                arr[pi] = source[pid]
            else:
                present[pi, mi] = False
        feats[m] = arr
    labels = np.asarray([diagnosis[p] for p in pids], np.int32)
    return make_dataset(feats, labels, present, [str(p) for p in pids])
