#!/usr/bin/env python3
"""What one of the port's spans (``utils.profiling.span``) costs the host.

    python scripts/torch_span_cost.py [--n 20000]

Times ``n`` enters and exits of an empty span, best of 5 rounds, in µs
each: off (no profiler: the profiler check alone), and on under a
``torch.profiler`` session (CPU activity, and CUDA activity where a card
is present) host only and, on a card, timed by an event pair on the
current stream.  Beside them: the bare profiler check and an empty
``record_function`` with no profiler.  The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _best_us(fn, n: int, rounds: int = 5) -> float:
    best = float("inf")
    for _ in range(rounds):
        t = time.perf_counter()
        fn(n)
        best = min(best, time.perf_counter() - t)
    return 1e6 * best / n


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=20000)
    args = p.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cervical_tpu_torch.utils import profiling as P

    card = torch.cuda.is_available()
    dev = torch.device("cuda", 0) if card else torch.device("cpu")
    if card:
        torch.ones(1, device=dev)  # initialise the card

    def spans(device):
        def run(n):
            for _ in range(n):
                with P.span("cost.span", device):
                    pass
        return run

    def check(n):
        for _ in range(n):
            P._profiler_enabled()

    def record_function(n):
        for _ in range(n):
            with torch.profiler.record_function("cost.rf"):
                pass

    out = {"card": torch.cuda.get_device_name(dev) if card else "cpu",
           "n": args.n,
           "check_us": _best_us(check, args.n),
           "off_us": _best_us(spans(False), args.n),
           "off_device_us": _best_us(spans(dev), args.n),
           "record_function_off_us": _best_us(record_function, args.n)}
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if card else [])
    n_on = max(1, args.n // 10)  # the profiler keeps every event
    for key, device in (("on_host_us", False), ("on_device_us", dev)):
        if device is not False and not card:
            continue
        before = P.span_totals().get("cost.span")
        with profile(activities=activities):
            out[key] = _best_us(spans(device), n_on, rounds=3)
        after = P.span_totals()["cost.span"]
        out[key + "_recorded"] = after.count - (before.count if before
                                                else 0)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
