"""The least time of the fused middle flow (K4: 16 Xception blocks of
three separable convs, eval mode, BatchNorm folded) on one batch, from
shapes alone: each separable conv reads its input and the block writes its
output once in bf16, the folded weights are read once, the pointwise
products run at the bf16 tensor-core peak and the depthwise taps, scales
and shifts (20 operations per element) at the float32 peak."""

from __future__ import annotations

from benchmarks.rooflines import peaks

BLOCKS, CONVS = 16, 3


def bound_s(batch: int, h: int, w: int, c: int = 728) -> tuple:
    """(seconds, "bytes" or "operations") for a (batch, h, w, c) input."""
    p = peaks()
    m = batch * h * w
    weights = (BLOCKS * 27 * c * 2             # depthwise taps, bf16
               + 2 * BLOCKS * CONVS * c * 4    # folded scale, shift 1
               + BLOCKS * CONVS * c * c * 2    # pointwise, bf16
               + BLOCKS * CONVS * c * 4)       # folded shift 2
    nbytes = 2 * m * c * 2 + weights
    t_bytes = nbytes / p["hbm_bytes"]
    t_ops = (2.0 * m * c * c * CONVS * BLOCKS / p["bf16_flops"]
             + 20.0 * m * c * CONVS * BLOCKS / p["fp32_flops"])
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
