"""Conv and BatchNorm layers with the JAX package's dtype and statistics
policy.

``cervical_tpu/ops/conv.py`` switches between ``lax`` and ``einsum`` conv
lowerings; that is a TPU lowering choice with identical semantics and is
not ported — the port calls ``nn.Conv2d``'s own conv.  What it keeps is
flax's dtype promotion: parameters are stored in fp32 and a conv computes
in ``compute_dtype`` (bf16 under the default config).  ``nn.BatchNorm2d``
takes a bf16 input with its fp32 parameters and statistics, normalizes in
fp32 and returns bf16; :class:`BatchNorm2d` changes only its train-mode
running-variance update, to flax's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


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


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode running variance takes the
    *biased* batch variance, as flax's ``BatchNorm`` does (torch takes the
    unbiased one, x n/(n-1): 14% at ASPP's pooled branch, where n = B = 8).
    Normalization and the running mean are torch's own.

    The batch statistics are not computed twice: torch's update
    ``rv' = (1-m) rv + m var n/(n-1)``, made on a copy of ``rv`` (autograd
    may keep the tensor it was given), is turned into flax's
    ``(1-m) rv + m var`` from the old value.
    """

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            keep = self.running_var * (1.0 - self.momentum)
            rv = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, rv, self.weight, self.bias,
                         True, self.momentum, self.eps)
        with torch.no_grad():
            torch.lerp(keep, rv, (n - 1) / n, out=self.running_var)
            self.num_batches_tracked.add_(1)
        return y
