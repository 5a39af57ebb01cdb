"""dispatch_ms.train: the host ms of one ``seg.call.train`` span in the
traced epoch: a K-step call's index and parameter rows, their pinning and
the graph replay's enqueue.  Nothing where the program records no such
span."""

from benchmarks.harness import spans


def read(summary, facts):
    return spans.host_ms_each("seg.call.train")
