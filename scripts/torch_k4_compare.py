#!/usr/bin/env python3
"""Time K4 (the middle flow) and the serving path of two checkouts of the
port on one card, in turns, so that a before/after is read on one card.

    python scripts/torch_k4_compare.py --roots OLD NEW [--order 0110]

For each digit of ``--order`` (default parent, change, change, parent) it
starts one process with that root's ``cervical_tpu_torch`` first on the
path, builds that root's kernels, and runs that root's own
``chip_smoke.kernel_phase`` (the middle flow at (8, 32, 32, 728) x 16
blocks in bf16, each kernel alone), ``chip_smoke.predictor_phase``
(``predict_masks`` on 16 synthetic 960x1280 images at batch 8, fused and
unfused), and, where the root has them, ``kernel_phase_f32`` and
``predictor_f32_phase`` (the same in f32, TF32 off: K4 f32 whole, its
two kernels, the f32 forward images/s fused and unfused).  Both roots'
timings go through this checkout's ``chip_smoke.cuda_ms`` (calls queued
behind a spin of the card, so the events time device work, not host
gaps).  Each run prints one line ``k4compare {...}``: the card's name and
power limit, K4 whole, each kernel's ms and library ms, and the
predictors' images/s, in bf16 and f32.  Needs a CUDA card; imports no
JAX.
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import time


def one(root):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        raise SystemExit("torch_k4_compare.py: no CUDA device")
    import chip_smoke as CS
    from cervical_tpu_torch.ops import _build
    from cervical_tpu_torch.ops import middle_flow as MF
    assert os.path.dirname(os.path.abspath(CS.__file__)) == root
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(here, "chip_smoke.py"))
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    CS.cuda_ms = timing.cuda_ms
    assert os.path.abspath(MF.__file__).startswith(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    buf = io.StringIO()
    f32 = hasattr(CS, "kernel_phase_f32")
    with contextlib.redirect_stdout(buf):
        res = CS.kernel_phase(torch, F, MF, torch.device("cuda"),
                              torch.Generator().manual_seed(0))
        CS.predictor_phase(torch, MF, torch.Generator().manual_seed(1))
        if f32:
            res32 = CS.kernel_phase_f32(torch, F, MF, torch.device("cuda"),
                                        torch.Generator().manual_seed(2))
            CS.predictor_f32_phase(torch, MF,
                                   torch.Generator().manual_seed(3))
    recs, k4 = res

    def line(tag):
        return next(json.loads(ln[len(tag) + 1:])
                    for ln in buf.getvalue().splitlines()
                    if ln.startswith(tag + " {"))
    pred = line("predictor")
    keys = ("ms", "library_ms", "library_bf16_out_ms", "ms_os8", "bound_ms")
    out32 = {}
    if f32:
        recs32, k4_32 = res32
        p32 = line("predictor_f32")
        out32 = {"k4_f32_ms": k4_32["ms"],
                 "k4_f32_library_ms": k4_32["library_ms"],
                 "kernels_f32": {r["name"]: {k: r.get(k) for k in keys}
                                 for r in recs32},
                 "f32_predict_masks_img_s": p32["predict_masks_img_s"],
                 "f32_throughput_fused_img_s": p32["throughput_fused_img_s"],
                 "f32_throughput_unfused_img_s":
                     p32["throughput_unfused_img_s"]}
    print("k4compare " + json.dumps({
        "root": root, "card": card, "build_s": build_s,
        "k4_ms": k4["ms"], "k4_host_gaps_ms": k4.get("host_gaps_ms"),
        "k4_library_ms": k4["library_ms"],
        "kernels": {r["name"]: {k: r.get(k) for k in keys} for r in recs},
        "predict_masks_img_s": pred["predict_masks_img_s"],
        "predict_masks_unfused_img_s": pred["predict_masks_unfused_img_s"],
        "throughput_fused_img_s": pred["throughput_fused_img_s"], **out32}),
        flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs=2, metavar=("OLD", "NEW"))
    ap.add_argument("--order", default="0110")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        return one(a.one)
    rc = 0
    for i in a.order:
        root = os.path.abspath(a.roots[int(i)])
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", root], cwd=root, timeout=1200)
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
