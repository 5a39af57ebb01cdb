"""k4_roofline: the fused middle flow's least time per forward
(``benchmarks/rooflines/k4.py``, from shapes) over the device time of
everything launched inside the ``bench.k4`` span around the port's
``middle_flow_eval``, per forward, in %.  Nothing when the span saw no
launch (the path is off or gone)."""


def read(summary, facts):
    span, bound = facts.get("k4_span"), facts.get("k4_bound_s")
    if not span or bound is None:
        return None
    count = summary.span_count.get(span, 0)
    device_s = summary.span_device_s.get(span, 0.0)
    if count == 0 or device_s <= 0:
        return None
    return 100.0 * bound / (device_s / count)
