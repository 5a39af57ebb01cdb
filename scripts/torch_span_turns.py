#!/usr/bin/env python3
"""What the port's spans cost a traced window, in one process: a benchmark
cell's traced window with the program's spans on, on without their card
events, and held off, in turns, beside the same window untraced.

    python scripts/torch_span_turns.py --workload xception-serve \\
        [--seed 7] [--rounds 6]

Builds the cell's program as ``benchmarks/run.py`` does (its set-up,
warm-up included), then runs ``--rounds`` rounds of four windows in a
rotating order: ``on`` (``torch.profiler`` running, spans recording),
``host`` (the same without the spans' card events), ``held`` (the
profiler running, every span held off as if no profiler ran) and
``untraced``.  A window is the cell's traced window: its
``traced_requests`` requests, or one epoch.  Prints each window's host
seconds and, last, one JSON object with the medians per mode and the
ratios ``on / held``, ``host / held`` and ``held / untraced``.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MODES = ("on", "host", "held", "untraced")


def turns(window, rounds: int, sync) -> dict:
    """Host seconds of ``window()`` per mode over ``rounds`` rounds, the
    order of the modes rotating by round."""
    import torch

    from cervical_tpu_torch.utils import profiling

    enabled, timing = profiling._profiler_enabled, profiling._timing_stream
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    seconds = {m: [] for m in MODES}
    for r in range(rounds):
        for m in MODES[r % 4:] + MODES[:r % 4]:
            sync()
            if m == "held":
                profiling._profiler_enabled = lambda: False
            if m == "host":
                profiling._timing_stream = lambda device: None
            try:
                if m == "untraced":
                    t = time.perf_counter()
                    window()
                    dt = time.perf_counter() - t
                else:
                    with torch.profiler.profile(activities=acts):
                        t = time.perf_counter()
                        window()
                        dt = time.perf_counter() - t
            finally:
                profiling._profiler_enabled = enabled
                profiling._timing_stream = timing
            seconds[m].append(dt)
            print(f"round {r} {m}: {dt!r} s", flush=True)
    return seconds


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--rounds", type=int, default=6)
    args = p.parse_args(argv)
    import torch

    from benchmarks.harness import spec as S
    from benchmarks.harness.common import Ctx

    spec = S.load()
    cell = S.cell(spec, args.workload)
    traffic = S.traffic(cell["traffic"])
    device = torch.device("cuda", 0)
    ctx = Ctx(cell=cell, config=S.config(spec, cell["config"]),
              traffic=traffic, limits=S.limits(cell["name"]),
              seed=args.seed, seconds=0.0, trace=True, device=device,
              t0=time.perf_counter())
    runner = S.runner(traffic["runner"])
    setup = runner.Setup(ctx)
    if traffic["runner"] == "serve_masks":
        n = traffic["traced_requests"]

        def window():
            for i in range(n):
                setup.request(i)
    else:
        def window():
            setup.run_epoch()
            torch.cuda.synchronize()

    seconds = turns(window, args.rounds, torch.cuda.synchronize)
    med = {m: statistics.median(v) for m, v in seconds.items()}
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(device), "seconds": seconds,
           "median_s": med, "on_over_held": med["on"] / med["held"],
           "host_over_held": med["host"] / med["held"],
           "held_over_untraced": med["held"] / med["untraced"]}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
