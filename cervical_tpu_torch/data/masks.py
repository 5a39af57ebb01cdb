"""Modality masks of the MAE — port of ``cervical_tpu/data/masks.py``
(reference: ``generate_mask``, MultiModal Prediction/Four_Modal/
mae_utils.py:11-21, and the imputation path, my_mae_model.py:608-622).

The training masks are drawn on the generator's device (no host round
trip, so a CUDA graph or an epoch's upload needs none); their stream is
torch's, not JAX's (ROADMAP §3).
"""

from __future__ import annotations

from typing import Optional

import torch


def generate_modal_masks(generator: torch.Generator, batch_size: int,
                         num_types: int, mask_num: Optional[int] = None
                         ) -> torch.Tensor:
    """(B, T) bool masks on ``generator``'s device with exactly
    ``mask_num`` True per row (default ``num_types - 1``: one modality
    stays visible to the MAE encoder), the True slots a uniformly random
    subset: each row ranks T uniform draws and masks the lowest
    ``mask_num`` ranks."""
    if mask_num is None:
        mask_num = num_types - 1
    if not 0 <= mask_num < num_types:
        raise ValueError(f"mask_num={mask_num} must be in [0, {num_types})")
    u = torch.rand((batch_size, num_types), generator=generator,
                   device=generator.device)
    ranks = u.argsort(dim=1).argsort(dim=1)
    return ranks < mask_num


def imputation_masks(present: torch.Tensor) -> torch.Tensor:
    """Masks of the missing-modality path: the absent slots, or none where
    nothing is present (my_mae_model.py:608-622).  ``present`` (B, T)."""
    any_present = present.any(dim=-1, keepdim=True)
    return torch.where(any_present, ~present, torch.zeros_like(present))
