#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card this process finds.

    python3 benchmarks/run.py --workload xception-train --seed 7 \\
        --seconds 30 --trace 0

The cell, its configuration, its traffic mix, the limits of its
comparison and its per-layer metrics' readers are found by name from
``BENCHMARK.json``.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (``--trace 0``: the
cell's end-to-end metrics; ``--trace 1``: its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number the comparison judged beside its limit (also the last lines of
standard error).  Without a card, with fewer cards than the cell asks for,
or with JAX or the JAX package loaded once the window has closed, it exits
non-zero and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "cervical_tpu")


def _cache_env():
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = os.path.join(ROOT, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def power_limit():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def result_line(spec, cell, out, trace: bool, torch, device) -> dict:
    from benchmarks.harness import spec as S
    from benchmarks.reference import compare
    metrics = {}
    if trace:
        for m in S.per_layer(spec, cell["name"]):
            v = S.reader(m["name"])(out.summary, out.facts)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(out.e2e, setup_s=out.setup_s)
        for m in S.end_to_end(spec, cell["name"]):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1, "memory_peak_bytes": out.memory_peak}
    line = {"correct": compare.correct(out.checks),
            "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = out.summary.busy_s
        dev["window_s"] = out.summary.window_s
        line["breakdown"] = out.summary.breakdown()
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in out.checks}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_env()
    sys.path.insert(0, ROOT)
    from benchmarks.harness import spec as S
    from benchmarks.harness.common import Ctx

    spec = S.load()
    cell = S.cell(spec, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    traffic = S.traffic(cell["traffic"])
    ctx = Ctx(cell=cell, config=S.config(spec, cell["config"]),
              traffic=traffic, limits=S.limits(cell["name"]),
              seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
              device=device, t0=T0)
    out = S.runner(traffic["runner"]).run(ctx)
    bad = forbidden_modules()
    if bad:
        print("loaded in the measuring process: " + ", ".join(bad),
              file=sys.stderr)
        return 4
    line = result_line(spec, cell, out, bool(args.trace), torch, device)
    if out.summary is not None:
        sm = out.summary
        print(f"trace: {sm.device_events} device records, busy "
              f"{sm.busy_s!r} s of {sm.window_s!r} s; spans "
              f"{sm.span_count} -> {sm.span_device_s} s on the card; "
              f"copies {sm.copy_s}", file=sys.stderr)
    print(f"card: {power_limit()}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
