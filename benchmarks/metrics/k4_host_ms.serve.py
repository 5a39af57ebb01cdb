"""k4_host_ms.serve: the host ms of one ``mf.eval`` span, the fused middle
flow's 96 wrapper calls of a forward, in the traced window.  Nothing where
the program records no such span (no fused middle flow, or no span)."""

from benchmarks.harness import spans


def read(summary, facts):
    return spans.host_ms_each("mf.eval")
