"""Seeding — the port's copy of ``cervical_tpu/utils/seeding.py``.

The trainer draws its weights, augmentation parameters and dropout masks
from its own ``torch.Generator``s (``train/seg_trainer.py``); this seeds the
process-wide generators that anything else may draw from.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int = 11) -> None:
    """Seed Python's, numpy's and torch's global generators, the CUDA ones
    included (``seed_everything``, utils/utils.py:45-52)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
