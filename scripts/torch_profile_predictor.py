#!/usr/bin/env python3
"""Where the PyTorch port's predictor spends device time.

    python scripts/torch_profile_predictor.py [--fused_middle true] \
        [--images 16] [--batch 8] [--hw 960 1280] [--trace path.json]

Runs ``SegPredictor.predict_masks`` (xception, os16, 512², 5 classes, bf16,
seeded random init) under ``torch.profiler`` on the GPU after one warm-up
call, and prints: the wall time, the device busy time (the sum of kernel
and copy times on the one stream), the idle share, and device time grouped
by kernel family and by kernel name.  The last line is one JSON object.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FAMILIES = (  # first match wins; matched against the lower-cased name
    ("middle_flow.dw_stencil", ("dw_stencil_kernel",)),
    ("middle_flow.pw_gemm", ("pw_gemm_kernel",)),
    ("memcpy", ("memcpy", "memset")),
    ("batch_norm", ("batch_norm", "batchnorm", "bn_fw")),
    ("conv (cudnn)", ("conv", "cudnn", "xmma", "implicit", "sm90_", "dgrad",
                      "wgrad", "fprop", "depthwise")),
    ("gemm (resize einsum)", ("gemm", "cutlass", "ampere", "sm80")),
    ("softmax/argmax/reduce", ("softmax", "reduce", "argmax", "max_")),
    ("elementwise/copy/cast", ("elementwise", "vectorized", "copy", "fill",
                               "cat", "index")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--fused_middle", default="true")
    ap.add_argument("--images", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--hw", type=int, nargs=2, default=(960, 1280))
    ap.add_argument("--trace", default="")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from cervical_tpu_torch.config import SegTrainConfig
    from cervical_tpu_torch.inference.predictor import SegPredictor
    from cervical_tpu_torch.predict import load_state

    fused = args.fused_middle.lower() in ("1", "true", "yes")
    cfg = SegTrainConfig()
    pred = SegPredictor(cfg, load_state(cfg), fused_middle=fused)
    g = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (args.images, *args.hw, 3), generator=g,
                           dtype=torch.uint8).numpy()
    pred.predict_masks(images, args.batch)  # warm-up: builds, autotunes
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict_masks(images, args.batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    if args.trace:
        prof.export_chrome_trace(args.trace)

    # device-side events only (kernels, copies): a CPU op's entry repeats
    # the device time of the kernels it launched
    by_name, by_family = defaultdict(float), defaultdict(float)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or \
                e.key.startswith("Activity Buffer"):  # profiler's own
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        by_name[e.key] += dev_us / 1e3
        by_family[family(e.key)] += dev_us / 1e3
    busy_ms = sum(by_name.values())
    card = torch.cuda.get_device_name(0)
    print(f"{card}; fused_middle={fused}; {args.images} images "
          f"{args.hw[0]}x{args.hw[1]} at batch {args.batch}")
    print(f"wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.4f}")
    print("device ms by family:")
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:10.3f}  {100 * ms / busy_ms:6.2f}%  {fam}")
    print("top kernels by device ms:")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:20]:
        print(f"  {ms:10.3f}  {name[:110]}")
    print(json.dumps({"device": card, "fused_middle": fused,
                      "images": args.images, "batch": args.batch,
                      "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                      "idle_share": 1 - busy_ms / wall_ms,
                      "images_per_s": args.images / wall_ms * 1e3,
                      "device_ms_by_family": dict(by_family)}))


if __name__ == "__main__":
    main()
