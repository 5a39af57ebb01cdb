#!/usr/bin/env python3
"""Time the augmentation kernels of two checkouts of the port on one card,
in turns, so that a before/after is read on one card.

    python scripts/torch_warp_compare.py --roots OLD NEW [--order 0110]

For each digit of ``--order`` (default parent, change, change, parent) it
starts one process with that root's ``cervical_tpu_torch`` first on the
path, builds that root's ``csrc/warp.cu`` and, at the train step's shapes
(batch 8, 512², the uint8 NHWC batch read through its permuted view),
reads on the same parameter rows:

* K5 ``warp_photo_images``, bf16 out, at three mixes of the rows: "none"
  (no image rotated or blurred), "smoke" (the smoke's draw: the first 2 of
  8 rotated by ``sample_augment_params(rotate_prefix=2)``, the last 2
  blurred) and "all" (all 8 rotated at +-10 degrees and blurred), and
  beside each the K1 -> K3 kernel chain on the same rows;
* as controls, K3 ``photometric`` on K1's bf16 and uint8 outputs, bf16 out,
  in each blur mode ("select" with the smoke's flags, "all", "none"), K2
  ``warp_labels`` and K1 ``warp_images`` (bf16 and uint8 out) at the same
  three mixes of the angles.

Each launch is first compared with that root's plain version (the count of
differing elements is printed), then timed with this checkout's
``chip_smoke.cuda_ms`` (calls queued behind a spin of the card, so the
events time device work).  Each run prints one line ``warpcompare {...}``
with the card's name and power limit and ptxas's register lines for the
warp kernels.  Needs a CUDA card; imports no JAX.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

MIXES = ("none", "smoke", "all")


def mix_rows(torch, W, A, b, s):
    """({mix: (B, 8) warp rows}, {mix: (B,) blur flags}) on the CPU, the
    smoke's draw for every mix: angle 0 and no blur everywhere, the smoke's
    angles and flags, or +-10 degrees and blur everywhere."""
    params = A.sample_augment_params(torch.Generator().manual_seed(2), b,
                                     rotate_prefix=b // 4, blur_suffix=b // 4)
    rows, flags = {}, {}
    for mix in MIXES:
        p = dict(params)
        if mix == "none":
            p["angle"] = torch.zeros(b)
            p["blur"] = torch.zeros(b, dtype=torch.bool)
        elif mix == "all":
            p["angle"] = torch.tensor([10.0, -10.0] * (b // 2))
            p["blur"] = torch.ones(b, dtype=torch.bool)
        rows[mix] = W.make_warp_params(p, (s, s), (s, s))
        flags[mix] = p["blur"]
    return params, rows, flags


def one(root):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_warp_compare.py: no CUDA device")
    from cervical_tpu_torch.ops import _build
    from cervical_tpu_torch.ops import augment as A
    from cervical_tpu_torch.ops import warp as W
    assert os.path.abspath(W.__file__).startswith(root)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(here, "chip_smoke.py"))
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    cuda_ms = timing.cuda_ms
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    log = _build.build([W.SOURCE]).get(W.SOURCE.name, "")
    build_s = time.perf_counter() - t0

    dev = torch.device("cuda")
    b, s = 8, 512
    g = torch.Generator().manual_seed(2)
    params, rows, flags = mix_rows(torch, W, A, b, s)
    # the smoke's image and label draws follow its params draw
    A.sample_augment_params(g, b, rotate_prefix=b // 4, blur_suffix=b // 4)
    images = torch.randint(0, 256, (b, s, s, 3), generator=g,
                           dtype=torch.uint8).to(dev)
    labels = torch.randint(0, 5, (b, s, s), generator=g,
                           dtype=torch.uint8).to(dev)
    x = images.permute(0, 3, 1, 2)
    rows = {m: r.to(dev) for m, r in rows.items()}
    flags = {m: f.to(dev) for m, f in flags.items()}
    res = {"root": root, "card": card, "build_s": build_s,
           "ptxas": [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln],
           "rotated": {m: int((r[:, W.P_ANGLE] != 0).sum())
                       for m, r in rows.items()},
           "k5_ms": {}, "k5_differing": {}, "chain_ms": {},
           "chain_differing": {}, "k3_ms": {}, "k3_differing": {},
           "k2_ms": {}, "k2_differing": {}, "k1_ms": {}, "k1_differing": {}}

    def read(kernel, key, fn, ref):
        got = fn()
        torch.cuda.synchronize()
        res[f"{kernel}_differing"][key] = int((got != ref()).sum())
        res[f"{kernel}_ms"][key] = cuda_ms(torch, fn, 50)

    gains = params["gains"].to(dev)
    for mix, r in rows.items():
        fl = flags[mix]
        full = torch.cat([r, gains.float(), fl.float()[:, None]], 1)
        read("k5", mix, lambda: W.warp_photo_images(x, full, s),
             lambda: W.warp_photo_images_reference(x, full, s))
        read("chain", mix,
             lambda: W.photometric(W.warp_images(x, r, s), gains, fl),
             lambda: W.warp_photo_images_reference(x, full, s))
    wp, fl = rows["smoke"], flags["smoke"]
    for dt in (torch.bfloat16, torch.uint8):
        warped = W.warp_images(x, wp, s, dt)
        for mode in W.BLUR_MODES:
            read("k3", f"{str(dt).split('.')[-1]}_{mode}",
                 lambda: W.photometric(warped, gains, fl, blur_mode=mode),
                 lambda: W.photometric_reference(warped, gains, fl,
                                                 blur_mode=mode))
    for mix, r in rows.items():
        read("k2", mix, lambda: W.warp_labels(labels, r, s),
             lambda: W.warp_labels_reference(labels, r, s))
        for dt in (torch.bfloat16, torch.uint8):
            read("k1", f"{mix}_{str(dt).split('.')[-1]}",
                 lambda: W.warp_images(x, r, s, dt),
                 lambda: W.warp_images_reference(x, r, s, dt))
    print("warpcompare " + json.dumps(res), flush=True)


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
