#!/usr/bin/env python3
"""The two forms a K-step train call can take as CUDA graphs, timed in turns
on one card.

    python scripts/torch_graph_shapes.py [--steps 8] [--runs 3]

``SegTrainer`` on an unmodified ``SegTrainConfig()`` (xception, os16, 512²,
5 classes, bf16, Adam, the einsum augmentation, batch 8 unfrozen, seeded
random init) and K synthetic uint8 batches already on the card:

* "unrolled": ``SegTrainer.train_steps``, one graph of the K steps (what the
  trainer runs);
* "step": one captured step (``make_train_step_scan`` with K = 1) replayed
  K times per call, the K steps' parameter rows uploaded in one copy.

The forms run in the order unrolled, step, step, unrolled on one trainer
state, each timed as ``chip_smoke.timed_steps`` times the defaults phase:
ms per step on the host clock after a warm-up call, device-busy ms per step
from ``torch.profiler``, and the idle share.  Prints the card's name and
power limit, one line per reading, and a JSON object as the last line.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile

    from chip_smoke import timed_steps
    from cervical_tpu_torch.config import SegTrainConfig
    from cervical_tpu_torch.train.graphs import GraphedCall
    from cervical_tpu_torch.train.seg_trainer import (SegTrainer,
                                                      make_train_step_scan)

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    cfg = SegTrainConfig()
    k, b = args.steps, cfg.unfreeze_batch_size
    h, w = cfg.data.input_shape
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (k, b, h, w, 3),
                                      dtype=np.uint8)).cuda()
    y = torch.from_numpy(rng.integers(0, cfg.data.num_classes, (k, b, h, w),
                                      dtype=np.uint8)).cuda()
    tr = SegTrainer(cfg, device="cuda")
    lr = tr.lr_schedule(b, cfg.unfreeze_epoch)(0)
    one = make_train_step_scan(cfg, False, 1)
    state = tr.state
    g1 = GraphedCall(lambda *xs: one(state, *xs), state,
                     [x[:1], y[:1], tr._param_rows(1, b), tr._lr_arg(lr)],
                     "cuda")

    def unrolled():
        tr.train_steps(x, y, False, lr)

    def step():
        rows, lr_t = tr._param_rows(k, b), tr._lr_arg(lr)
        for i in range(k):
            g1(x[i:i + 1], y[i:i + 1], rows[i:i + 1], lr_t)

    out = {"card": card, "steps": k, "batch": b, "runs": args.runs}
    for name, run in (("unrolled", unrolled), ("step", step),
                      ("step", step), ("unrolled", unrolled)):
        ms, busy, idle = timed_steps(torch, profile, DeviceType, run, k,
                                     runs=args.runs)
        out.setdefault(name, []).append({"step_ms": ms,
                                         "images_per_s": b * 1e3 / ms,
                                         "device_busy_ms_per_step": busy,
                                         "idle_share": idle})
        print(f"{name}: {ms} ms/step = {b * 1e3 / ms} images/s, busy {busy}"
              f" ms, idle {idle} ({card})")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
