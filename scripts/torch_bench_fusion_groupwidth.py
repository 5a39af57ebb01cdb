#!/usr/bin/env python3
"""The port's vmapped-folds CV engine against its group width on one card —
the counterpart of ``scripts/bench_fusion_groupwidth.py`` and
``bench_fusion_cv.py``.

    python scripts/torch_bench_fusion_groupwidth.py [--widths 1,5,25,50]

``FusionTrainConfig()`` (four modalities, in_features 1024, hidden 512,
batch 8, kfold 5, float32) on a synthetic 1,758-patient cohort drawn on
the card from a seed.  For each width w, ``chip_smoke.vmap_width``: the
stacked train step of w pairs replayed from its CUDA graph (ms per group
step, ms per pair-step, device busy ms, idle share), then
``_cross_validate_vmapped(group=w)`` with ``ceil(w / 5)`` seed repeats cut
to 3 epochs and stopped after its first group (pair-epochs/s of its third
epoch, peak memory).  Before them the sequential step's graph, timed the
same way and its kernels counted, is the width-1 yardstick (``--widths
""``: it alone; the script then runs on any checkout whose
``chip_smoke.py`` has ``timed_steps``, ``top_kernels`` and
``synthetic_cohort``, so an older tree's step can be read beside this
one's).  A width that runs out of device memory is reported as such and
the rest go on.  Prints the card's name and power limit, one line per
width and a JSON object as the last line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PATIENTS = 1758


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", default="1,5,25,50")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile

    import chip_smoke as CS
    from cervical_tpu_torch.config import FusionTrainConfig
    from cervical_tpu_torch.data.masks import generate_modal_masks
    from cervical_tpu_torch.train.fusion_trainer import FusionTrainer

    if not torch.cuda.is_available():
        raise SystemExit("torch_bench_fusion_groupwidth.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    cfg = FusionTrainConfig()
    ds = CS.synthetic_cohort(torch, PATIENTS, cfg.in_features, 7, dev)
    g = torch.Generator(dev).manual_seed(5)

    # the sequential step's graph, the yardstick
    tr = FusionTrainer(cfg, device="cuda")
    st = tr.init_state()
    dv = tr._device_cohort(ds)
    bs = cfg.batch_size
    idx = torch.randint(0, PATIENTS, (8, bs), generator=g, device=dev)
    masks = generate_modal_masks(g, 8 * bs, 4).view(8, bs, 4)
    w, lr = torch.ones(bs, device=dev), tr._lr_arg(cfg.lr)
    call = tr._batch_step(st, dv["feats"], dv["labels"], bs, True)

    def run():
        for i in range(8):
            call(idx[i], masks[i], w, lr)
    ms, busy, idle = CS.timed_steps(torch, profile, DeviceType, run, 8)
    kernels = CS.top_kernels(torch, profile, DeviceType, run, 8, top=6)
    out = {"card": card,
           "sequential_step": {"step_ms": ms, "device_busy_ms_per_step": busy,
                               "idle_share": idle, "top_kernels": kernels},
           "widths": {}}
    print(f"sequential graph step: {ms:.3f} ms, device busy {busy:.3f} ms, "
          f"idle {idle:.4f}, {kernels[0]:.0f} kernels ({card})")
    del tr, st, call
    torch.cuda.empty_cache()

    for width in (int(x) for x in args.widths.split(",") if x):
        try:
            out["widths"][width] = CS.vmap_width(torch, cfg, ds, dev, width,
                                                 g, card)
        except torch.cuda.OutOfMemoryError as e:
            out["widths"][width] = {"out_of_memory": str(e).splitlines()[0]}
            print(f"width {width}: out of device memory ({card})")
            torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
