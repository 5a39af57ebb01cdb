"""Conv and BatchNorm layers with the JAX package's dtype and statistics
policy.

``cervical_tpu/ops/conv.py`` switches between ``lax`` and ``einsum`` conv
lowerings; that is a TPU lowering choice with identical semantics and is
not ported — the port calls ``nn.Conv2d``'s own conv.  What it keeps is
flax's dtype promotion: parameters are stored in fp32 and a conv computes
in ``compute_dtype`` (bf16 under the default config).  ``nn.BatchNorm2d``
takes a bf16 input with its fp32 parameters and statistics, normalizes in
fp32 and returns bf16; :class:`BatchNorm2d` changes its train-mode
running-variance update to flax's and, given a data axis of more than one
rank (``data_axis``, set by ``parallel.mesh.set_data_axis``), takes its
statistics over the global batch, as JAX computes them over the sharded
global array.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from cervical_tpu_torch.parallel.mesh import all_sum


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

    data_axis = None  # parallel.mesh.Axis: statistics of the global batch

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.data_axis is not None and self.data_axis.size > 1:
            return self._global_forward(x, self.data_axis.group)
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

    def _global_forward(self, x, group):
        """Train mode over the global batch: the per-channel sum and count,
        then the sum of squared deviations from the global mean, each
        all-reduced with autograd (its backward sums the ranks' gradients);
        normalised with the global mean and biased variance in f32 (f64
        for f64 input), the running stats updated by flax's rule."""
        dims = (0, 2, 3)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        c = x.shape[1]
        count = torch.full((1,), x.numel() // c, dtype=xf.dtype,
                           device=x.device)
        s = all_sum(torch.cat([xf.sum(dims), count]), group)
        n = s[c:]
        mean = s[:c] / n
        d = xf - mean.view(1, c, 1, 1)
        var = all_sum((d * d).sum(dims), group) / n
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = d * scale.view(1, c, 1, 1) + self.bias.view(1, c, 1, 1)
        with torch.no_grad():
            m = self.momentum
            rm, rv = self.running_mean, self.running_var
            rm.lerp_(mean.detach().to(rm.dtype), m)
            rv.lerp_(var.detach().to(rv.dtype), m)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)
