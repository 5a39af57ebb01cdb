#!/usr/bin/env python3
"""Readings behind the limits of ``correct``: per seed, the numbers the
comparison gives for the program, for the control (the reference in
float8, put in the program's place) and for the planted faults.

    python3 benchmarks/control.py --workload xception-train --seeds 1 2 3

The readings are the ``control_readings(ctx)`` of the runner that the
cell's traffic mix names (``benchmarks/harness/<runner>.py``; their
docstrings say what each reads).  Training cells read the probe only (the
window's first K-step call and its val passes; no window); a witness, the
reference with its convolutions in bfloat16 held against itself in
float32, shows what rounding alone does to the numbers.  Serving cells
serve ``check_requests`` requests through the program and judge every one.
One JSON line per seed, and the readings' maxima and minima last.  The
benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(spec: dict, cell_name: str, root: str = ROOT):
    """``control_readings(ctx)`` of the runner that the cell's traffic mix
    names; a runner without one is refused by name."""
    from benchmarks.harness import spec as S
    name = S.traffic(S.cell(spec, cell_name)["traffic"], root)["runner"]
    read = getattr(S.runner(name, root), "control_readings", None)
    if not callable(read):
        raise LookupError(f"runner {name!r} (benchmarks/harness/{name}.py) "
                          f"has no control_readings(ctx)")
    return read


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from benchmarks.harness import spec as S
    from benchmarks.harness.common import Ctx
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    spec = S.load()
    cell = S.cell(spec, args.workload)
    traffic = S.traffic(cell["traffic"])
    try:
        read = readings(spec, args.workload)
    except LookupError as e:
        print(e, file=sys.stderr)
        return 2
    rows = []
    for seed in args.seeds:
        ctx = Ctx(cell=cell, config=S.config(spec, cell["config"]),
                  traffic=traffic, limits=S.limits(cell["name"]), seed=seed,
                  seconds=0.0, trace=False, device=torch.device("cuda", 0),
                  t0=time.perf_counter())
        r = read(ctx)
        rows.append(r)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - ctx.t0, **r}),
              flush=True)
    summary = {}
    for kind in rows[0]:
        for name in rows[0][kind]:
            vals = [r[kind][name] for r in rows]
            summary[f"{kind}.{name}"] = {"max": max(vals), "min": min(vals)}
    print(json.dumps({"workload": args.workload, "seeds": args.seeds,
                      "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
