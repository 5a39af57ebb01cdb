"""The program's own spans (``cervical_tpu_torch.utils.profiling``) over the
traced window, for the per-layer metrics that read them.

The profiler is on only over the window, so the program's records hold
the window.  A program without spans, or a window in which the named spans
recorded nothing, reads ``None``."""

from __future__ import annotations

from typing import Optional, Sequence


def totals() -> dict:
    """``span_totals()`` of the program, or nothing where it has none."""
    try:
        from cervical_tpu_torch.utils import profiling
    except ImportError:
        return {}
    read = getattr(profiling, "span_totals", None)
    return read() if read is not None else {}


def device_ms_per(names: Sequence[str], per: str) -> Optional[float]:
    """The card-clock ms of the spans ``names`` together, per ``per`` span."""
    t = totals()
    parts = [t.get(n) for n in names]
    if per not in t or any(p is None or p.device_s is None for p in parts):
        return None
    return 1e3 * sum(p.device_s for p in parts) / t[per].count


def host_ms_each(name: str) -> Optional[float]:
    """The host ms of one ``name`` span, on average."""
    t = totals().get(name)
    return None if t is None else 1e3 * t.host_s / t.count
