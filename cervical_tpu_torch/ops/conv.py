"""Conv layer with the JAX package's dtype policy.

``cervical_tpu/ops/conv.py`` switches between ``lax`` and ``einsum`` conv
lowerings; that is a TPU lowering choice with identical semantics and is
not ported — the port calls ``nn.Conv2d``'s own conv.  What it keeps is
flax's dtype promotion: parameters are stored in fp32 and a conv computes
in ``compute_dtype`` (bf16 under the default config).  BatchNorm needs no
wrapper: ``nn.BatchNorm2d`` takes a bf16 input with its fp32 parameters
and statistics, normalizes in fp32 and returns bf16.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` (None = the input's)."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype or x.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)
