#!/usr/bin/env python3
"""Where the PyTorch port's segmentation train step spends device time.

    python scripts/torch_profile_train_step.py [--batch 8] [--frozen false] \
        [--steps 5] [--hw 512 512] [--aug_backend pallas] [--aug_only false] \
        [--trace path.json]

Runs ``SegTrainer.train_step`` (xception, os16, 5 classes, bf16, Adam,
focal + dice, seeded random init; ``--aug_backend pallas``, the default
here, the K1-K3 kernels, or ``einsum``) on one synthetic uint8 batch already
on the GPU, under ``torch.profiler`` after three warm-up steps, and prints:
the wall time per step, the device busy time (kernel and copy times summed
over the one stream), the idle share, and device time grouped by kernel
family and by kernel name.  ``--aug_only true`` profiles the step's
augmentation call alone (``make_train_aug_fn``, the step's parameters).
The last line is one JSON object.  Needs a CUDA device.
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
    ("K1 warp_images", ("warp_images_kernel",)),
    ("K2 warp_labels", ("warp_labels_kernel",)),
    ("K3 photometric", ("photometric_kernel",)),
    ("memcpy/memset", ("memcpy", "memset")),
    ("batch_norm fwd/bwd", ("batch_norm", "batchnorm", "bn_fw", "bn_bw",
                            "welford")),
    ("conv wgrad", ("wgrad",)),
    ("conv dgrad", ("dgrad",)),
    ("conv fprop (cudnn)", ("conv", "cudnn", "xmma", "implicit", "sm90_",
                            "fprop", "depthwise")),
    ("gemm (loss/resize einsums)", ("gemm", "cutlass", "ampere", "sm80")),
    ("optimizer (Adam)", ("adam", "multi_tensor", "foreach")),
    ("softmax/log_softmax/reduce", ("softmax", "reduce", "argmax", "max_",
                                    "sum")),
    ("dropout/rng", ("bernoulli", "philox", "random", "distribution")),
    ("elementwise/copy/cast", ("elementwise", "vectorized", "copy", "fill",
                               "cat", "index", "where", "clamp")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frozen", default="false")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--hw", type=int, nargs=2, default=(512, 512))
    ap.add_argument("--aug_backend", default="pallas",
                    choices=("pallas", "einsum"))
    ap.add_argument("--aug_only", default="false")
    ap.add_argument("--trace", default="")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from cervical_tpu_torch.config import SegTrainConfig
    from cervical_tpu_torch.train.seg_trainer import (
        SegTrainer, _sample_step_aug_params, make_train_aug_fn)

    frozen = args.frozen.lower() in ("1", "true", "yes")
    cfg = SegTrainConfig()
    cfg.data.aug_backend = args.aug_backend
    cfg.data.input_shape = tuple(args.hw)
    trainer = SegTrainer(cfg)
    rng = np.random.default_rng(0)
    b, (h, w) = args.batch, args.hw
    images = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3),
                                           dtype=np.uint8)).cuda()
    labels = torch.from_numpy(rng.integers(0, 5, (b, h, w),
                                           dtype=np.uint8)).cuda()
    aug_only = args.aug_only.lower() in ("1", "true", "yes")
    aug = make_train_aug_fn(cfg)
    params = {k: v.cuda() for k, v in _sample_step_aug_params(
        cfg, torch.Generator().manual_seed(0), b).items()}

    def step():
        if aug_only:
            return aug(images, labels, params)
        return trainer.train_step(images, labels, frozen, 1e-4)
    for _ in range(3):  # warm-up: kernel builds, cuDNN heuristics
        step()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    if args.trace:
        prof.export_chrome_trace(args.trace)

    by_name, by_family = defaultdict(float), defaultdict(float)
    for e in prof.key_averages():
        # the profiler's own buffers; user annotations (Optimizer.step#...)
        # repeat the time of the kernels they enclose
        if e.device_type != DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False) or \
                e.key.startswith("Activity Buffer"):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        by_name[e.key] += dev_us / 1e3 / args.steps
        by_family[family(e.key)] += dev_us / 1e3 / args.steps
    busy_ms = sum(by_name.values())
    card = torch.cuda.get_device_name(0)
    print(f"{card}; train step ({args.aug_backend} augmentation"
          f"{', the augmentation alone' if aug_only else ''}), "
          f"batch {b}, {h}x{w}, frozen={frozen}, {args.steps} profiled steps")
    print(f"per step: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.4f}")
    print("device ms per step by family:")
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:10.3f}  {100 * ms / busy_ms:6.2f}%  {fam}")
    print("top kernels by device ms per step:")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {ms:10.3f}  {name[:110]}")
    print(json.dumps({"device": card, "aug_backend": args.aug_backend,
                      "aug_only": args.aug_only, "batch": b, "hw": [h, w],
                      "frozen": frozen, "steps": args.steps,
                      "wall_ms_per_step": wall_ms,
                      "device_busy_ms_per_step": busy_ms,
                      "idle_share": 1 - busy_ms / wall_ms,
                      "images_per_s": b / wall_ms * 1e3,
                      "device_ms_by_family": dict(by_family)}))


if __name__ == "__main__":
    main()
