#!/usr/bin/env python3
"""The card's idle time in one traced window of a benchmark cell, by the
port's own spans.

    python scripts/torch_span_idle.py --workload mobilenet-serve \\
        [--seed 7] [--out chiprun_out/idle.json]

Runs ``benchmarks/run.py --trace 1`` for the cell in this process (its
result line is printed as usual), keeps the profiler's events of the
window, and prints one JSON object: the window and busy seconds; the
program's span totals; the idle time (the window less the union of kernel,
copy and set intervals) by the innermost program span open when each gap
began, and by that span with the innermost host event of any kind; and the
host seconds of the window outside the root spans (``predict.request``,
``seg.epoch``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ROOTS = ("predict.request", "seg.epoch")


def _innermost(opened, starts, t):
    """The latest-starting of the nested ``(start, end, name)`` intervals
    open at ``t``, or None."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if opened[i][1] >= t:
            return opened[i][2]
    return None


def _open_at(events):
    opened = sorted((e.start_ns(), e.end_ns(), e.name()) for e in events)
    return opened, [a for a, _, _ in opened]


def analyse(events, program_names) -> dict:
    from benchmarks.harness import stats
    from benchmarks.harness.trace import WINDOW, _is_annotation, _is_device

    host = [e for e in events if not _is_device(e)]
    window = [e for e in host if e.name() == WINDOW][0]
    lo, hi = window.start_ns(), window.end_ns()
    marks = {e.name() for e in host if _is_annotation(e)} | {WINDOW}
    busy = stats.union(stats.clip(
        [(e.start_ns(), e.end_ns()) for e in events
         if _is_device(e) and e.name() not in marks], lo, hi))
    program = [e for e in host if e.name() in program_names]
    anyhost = [e for e in host if e.name() != WINDOW]
    p_open, p_starts = _open_at(program)
    h_open, h_starts = _open_at(anyhost)
    by_span = collections.Counter()
    by_pair = collections.Counter()
    for a, b in stats.gaps(busy, lo, hi):
        s = _innermost(p_open, p_starts, a) or "outside program spans"
        h = _innermost(h_open, h_starts, a) or "no host event"
        by_span[s] += (b - a) * 1e-9
        by_pair[f"{s} / {h}"] += (b - a) * 1e-9
    roots = stats.union(stats.clip(
        [(e.start_ns(), e.end_ns()) for e in program
         if e.name() in ROOTS], lo, hi))
    window_s = (hi - lo) * 1e-9
    return {"window_s": window_s,
            "busy_s": stats.covered(busy) * 1e-9,
            "idle_by_span": dict(by_span.most_common()),
            "idle_by_span_and_host_event": dict(by_pair.most_common(12)),
            "outside_roots_s": window_s - stats.covered(roots) * 1e-9}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--seconds", type=float, default=20)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from benchmarks import run
    from benchmarks.harness import trace as T

    kept = []
    summary = T.Tracer.summary

    def keep(self, spans=()):
        kept.append(self.prof)
        return summary(self, spans)
    T.Tracer.summary = keep
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc != 0:
        raise SystemExit(rc)
    from cervical_tpu_torch.utils import profiling
    totals = profiling.span_totals()
    out = {"workload": args.workload, "seed": args.seed,
           "spans": {k: t._asdict() for k, t in totals.items()}}
    out.update(analyse(kept[0].profiler.kineto_results.events(),
                       set(totals)))
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return out


if __name__ == "__main__":
    main()
