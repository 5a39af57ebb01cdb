#!/usr/bin/env python3
"""Readings behind the limits of ``correct``: per seed, the numbers the
comparison gives for the program, for the control (the reference in
float8, put in the program's place) and for the planted faults.

    python3 benchmarks/control.py --workload xception-train --seeds 1 2 3

Training cells read the probe only (the window's first K-step call and
its val passes; no window).  Faults: the reference on half of each batch
(the mean over the rest); a state left unchanged (the program's readings
with no change).  A witness: the reference with its convolutions in
bfloat16, held against itself in float32, shows what rounding alone does
to the numbers.  Serving cells serve ``check_requests`` requests through
the program and judge every one; faults: the masks of half of each
request's images replaced by class 0, and each class of a request's masks
changed to the next.  One JSON line per seed, and the readings' maxima and
minima last.  The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def train_readings(ctx):
    from benchmarks.harness import train_epochs as T
    from benchmarks.reference import compare
    s = T.Setup(ctx, warm=False)
    s.free()
    ref = s.reference()
    out = {"program": compare.train_numbers(s.readings, ref),
           "control": compare.train_numbers(s.reference("float8"), ref),
           "half_batch": compare.train_numbers(
               s.reference(fault="half_batch"), ref),
           "witness_bf16": compare.train_numbers(s.reference("bfloat16"),
                                                 ref)}
    still = dict(s.readings, changes={n: 0.0 * t for n, t in
                                      s.readings["changes"].items()})
    out["unchanged"] = compare.train_numbers(still, ref)
    return out


def serve_readings(ctx):
    import torch
    from benchmarks.harness import serve_masks as SV, weights
    from benchmarks.reference import compare, serve as R
    s = SV.Setup(ctx)
    kept = [(i, s.request(i)) for i in range(ctx.traffic["check_requests"])]
    s.free()
    dev = ctx.device
    sd = weights.make(s.backbone, s.nc, 2 * ctx.seed + 1,
                      ctx.config["weights"], dev, s.hw)
    model = R.build(s.backbone, sd, s.nc, dev)
    gaps = {"program": [], "control": [], "half_batch": [], "altered": []}
    for i, masks in kept:
        x = torch.from_numpy(s.images(i)).to(dev)
        p = R.probs(model, x, s.hw)
        m = torch.from_numpy(masks).to(dev)
        gaps["program"].append(R.mask_gaps(p, m))
        low = R.probs(model, x, s.hw, "float8").argmax(1)
        gaps["control"].append(R.mask_gaps(p, low))
        half = m.clone()
        half[: len(half) // 2] = 0
        gaps["half_batch"].append(R.mask_gaps(p, half))
        alt = (m + 1) % s.nc
        gaps["altered"].append(R.mask_gaps(p, alt))
    return {k: compare.serve_numbers(v) for k, v in gaps.items()}


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
    read = train_readings if traffic["runner"] == "train_epochs" \
        else serve_readings
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
