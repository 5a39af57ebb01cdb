#!/usr/bin/env python3
"""Where ``parallel.middle_flow_pipeline``'s time goes on one card.

    python scripts/torch_pipeline_probe.py [--batch 8] [--microbatches 4]
        [--stages 4] [--iters 10]

Times, in one process and in turns, the Xception middle flow (16 eval-mode
``XceptionBlock(728)``, bf16, channels_last, seeded random weights) at
(batch, 728, 32, 32): the sequential blocks on the whole batch; the same
blocks on each microbatch in turn; the pipeline on a stream per stage;
and the pipeline with every stage on the current stream (its schedule
alone).  Each reading: host wall ms per call after a warm-up, ending in a
synchronize, and the device-busy ms per call from ``torch.profiler``.
Prints the card's name and power limit first and one JSON line last.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile
    from cervical_tpu_torch import parallel as PP
    from cervical_tpu_torch.models.backbones.xception import XceptionBackbone
    import chip_smoke as CS

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    g = torch.Generator().manual_seed(41)
    bb = XceptionBackbone(compute_dtype=torch.bfloat16)
    bb.load_state_dict(CS.random_state(torch, bb, g))
    bb = bb.to(dev).eval()
    x = (torch.randn(args.batch, 728, 32, 32, generator=g)
         .to(dev, torch.bfloat16).contiguous(memory_format=torch.channels_last))
    m, stages = args.microbatches, [dev] * args.stages

    def sequential(z):
        for i in range(4, 20):
            z = getattr(bb, f"block{i}")(z)[0]
        return z

    def per_microbatch():
        return torch.cat([sequential(c) for c in x.chunk(m)])

    def pipeline():
        return PP.middle_flow_pipeline(bb, x, stages, microbatches=m)

    def one_stream():
        real, cur = torch.cuda.Stream, torch.cuda.current_stream(dev)
        torch.cuda.Stream = lambda *a, **k: cur
        try:
            return pipeline()
        finally:
            torch.cuda.Stream = real

    runs = {"sequential": lambda: sequential(x),
            "per_microbatch": per_microbatch, "pipeline_streams": pipeline,
            "pipeline_one_stream": one_stream}
    out = {}
    with torch.no_grad():
        ref = per_microbatch()
        for name, fn in runs.items():
            assert name == "sequential" or torch.equal(fn(), ref), name
        for _ in range(2):  # in turns, twice
            for name, fn in runs.items():
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    fn()
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0) / args.iters
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(args.iters):
                        fn()
                    torch.cuda.synchronize()
                busy = CS.device_busy_ms(prof, torch.autograd.DeviceType) \
                    / args.iters
                out.setdefault(name, []).append({"wall_ms": wall,
                                                 "busy_ms": busy})
                print(f"{name}: {wall:.3f} ms wall, {busy:.3f} ms busy")
    print(json.dumps({"card": smi.stdout.strip(), "batch": args.batch,
                      "microbatches": m, "stages": args.stages,
                      "runs": out}))


if __name__ == "__main__":
    main()
