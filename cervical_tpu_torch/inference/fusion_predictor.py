"""Inference for the multimodal fusion classifier — port of
``cervical_tpu/inference/fusion_predictor.py``.

The reference's only inference path is the ``prediction`` loop inside each
training script (``MultiModal Prediction/Four_Modal/my_train(full).py:
47-171``).  :class:`FusionPredictor` loads a fold's best weights (the
``best_seed{S}_fold{F}.npz`` artifact of ``cross_validate``, in the JAX
package's flat ``/``-keyed flax layout, so either package serves the
other's) and runs batched forwards with the missing-modality imputation
path (my_mae_model.py:608-622).

Inputs follow the cohort convention (``data/fusion_data.py``): ``feats`` a
dict ``modality -> (N, n_nodes, in_features)``, ``present`` an optional
``(N, T)`` bool of the slots that carry data.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from cervical_tpu_torch.config import FusionTrainConfig
from cervical_tpu_torch.data.fusion_data import node_count
from cervical_tpu_torch.data.masks import imputation_masks
from cervical_tpu_torch.train.flax_import import (flatten_params,
                                                  fusion_from_flax,
                                                  fusion_to_flax, unflatten)


def save_params_npz(path: str, state_dict: Mapping[str, torch.Tensor]) -> str:
    """Write a ``FusionMAE`` ``state_dict`` as the JAX package's flat npz
    (flax param paths joined by ``/``)."""
    np.savez(path, **flatten_params(fusion_to_flax(state_dict)))
    return path


def load_params_npz(path: str) -> Dict[str, torch.Tensor]:
    """A flat ``/``-keyed fusion npz (written by either package) -> a port
    ``state_dict``."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return fusion_from_flax(unflatten(flat))


class FusionPredictor:
    """Batched inference over trained fusion weights on ``device``
    (``cuda`` by default).

    * ``predict_proba`` — per-head softmax probabilities ("all" + one per
      modality) for any cohort size: batches padded to ``batch_size`` by
      repeating the last row, the padding sliced off;
    * ``predict`` — argmax classes + the fused head's confidence;
    * ``get_throughput`` — patients/s of the forward on the card.

    Absent slots (``present`` False) are zeroed before the encoders (so no
    filler, NaN included, reaches them), hidden from the MAE encoder and
    rebuilt from the mask token, so a 4-modal model serves 1-3-modal
    patients.
    """

    def __init__(self, cfg: FusionTrainConfig,
                 params: Mapping[str, torch.Tensor], batch_size: int = 512,
                 device: str = "cuda"):
        from cervical_tpu_torch.train.fusion_trainer import build_model
        self.cfg = cfg
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.model = build_model(cfg)
        self.model.load_state_dict(params)
        self.model.to(self.device).eval()

    @classmethod
    def from_npz(cls, cfg: FusionTrainConfig, path: str,
                 batch_size: int = 512, device: str = "cuda"
                 ) -> "FusionPredictor":
        return cls(cfg, load_params_npz(path), batch_size=batch_size,
                   device=device)

    # -- forward -------------------------------------------------------------
    @torch.no_grad()
    def _forward(self, feats: Dict[str, torch.Tensor],
                 present: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = {m: torch.where(present[:, i, None, None], feats[m],
                                torch.zeros_like(feats[m]))
                 for i, m in enumerate(self.cfg.modalities)}
        out = self.model(feats, present=present,
                         mae_mask=imputation_masks(present))
        return {k: torch.softmax(v.to(torch.float32), dim=-1)
                for k, v in out["logits"].items()}

    def predict_proba(self, feats, present=None) -> Dict[str, np.ndarray]:
        """dict head -> (N, num_classes) float32 softmax probabilities."""
        mods = self.cfg.modalities
        n = len(feats[mods[0]])
        if n == 0:
            empty = np.zeros((0, self.cfg.num_classes), np.float32)
            return {k: empty for k in ("all", *mods)}
        if present is None:
            present = np.ones((n, len(mods)), bool)
        feats = {m: np.asarray(feats[m], np.float32) for m in mods}
        present = np.asarray(present, bool)
        bs = self.batch_size
        heads: Dict[str, list] = {}
        for start in range(0, n, bs):
            real = min(start + bs, n) - start
            idx = np.minimum(np.arange(start, start + bs), n - 1)
            probs = self._forward(
                {m: torch.from_numpy(v[idx]).to(self.device)
                 for m, v in feats.items()},
                torch.from_numpy(present[idx]).to(self.device))
            for k, v in probs.items():
                heads.setdefault(k, []).append(v[:real].cpu().numpy())
        return {k: np.concatenate(v) for k, v in heads.items()}

    def predict(self, feats, present=None) -> Dict[str, np.ndarray]:
        """``{"classes": (N,), "confidence": (N,), "classes_<modality>":
        (N,), ...}`` — the per-head argmaxes the reference's ``prediction``
        reports (my_train(full).py:115-143)."""
        probs = self.predict_proba(feats, present)
        out = {"classes": probs["all"].argmax(-1),
               "confidence": probs["all"].max(-1)}
        for m in self.cfg.modalities:
            out[f"classes_{m}"] = probs[m].argmax(-1)
        return out

    # -- serving utilities ---------------------------------------------------
    def get_throughput(self, batch_size: int = 512, iters: int = 10,
                       seed: int = 0) -> float:
        """Steady-state patients/s of the forward at ``batch_size`` on the
        card: CUDA events around ``iters`` forwards, each on its own input
        drawn on the card beforehand (one warm-up forward first).  A device
        metric: on another device it raises."""
        if self.device.type != "cuda":
            raise RuntimeError("get_throughput measures the card: the "
                               f"predictor is on {self.device}")
        t = len(self.cfg.modalities)
        g = torch.Generator(self.device).manual_seed(seed)
        present = torch.ones((batch_size, t), dtype=torch.bool,
                             device=self.device)
        streams = [{m: torch.randn((batch_size, node_count(m),
                                    self.cfg.in_features), generator=g,
                                   device=self.device)
                    for m in self.cfg.modalities} for _ in range(1 + iters)]
        self._forward(streams[0], present)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(self.device)
        start.record()
        for i in range(iters):
            self._forward(streams[1 + i], present)
        end.record()
        end.synchronize()
        return batch_size * iters / (start.elapsed_time(end) / 1e3)

    def export_stablehlo(self, path: str, batch_size: int = 1) -> str:
        raise NotImplementedError(
            "export_stablehlo is the JAX package's StableHLO export; its "
            "port, torch.export, is not done yet (ROADMAP §1, the rest of "
            "serving)")
