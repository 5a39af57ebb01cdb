#!/usr/bin/env python3
"""Time the middle flow's stencil kernel (``mf_dw_stencil``) at each number
of output rows a thread walks, on one card.

    python scripts/torch_stencil_rows.py [--rows 1 2 4 8 16]
        [--against OTHER/middle_flow.cu ...]

At the serving path's shapes, batch 8 at 512² input: (8, 32, 32, 728) at
dilation 1 (output stride 16), f32 z between convs and the bf16 block
input, and (8, 64, 64, 728) f32 at dilation 2 (output stride 8).  Each
launch is first held bit for bit against ``dw_stencil_reference``; then
CUDA-event means over 50 calls, beside ``F.conv2d(groups=C)`` on the same
input in bf16 (the library yardstick).  ``--against`` builds other
versions of ``csrc/middle_flow.cu`` with the same C interface and times
their ``mf_dw_stencil`` on the same inputs in the same process, each
also held bit for bit.  Prints the card's name and power limit and one
``stencil_rows {...}`` line.  Needs a CUDA card.
"""

import argparse
import functools
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[1, 2, 4, 8, 16])
    ap.add_argument("--against", nargs="*", default=[])
    a = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        raise SystemExit("torch_stencil_rows.py: no CUDA device")
    import chip_smoke as CS
    from pathlib import Path
    from cervical_tpu_torch.ops import _build
    from cervical_tpu_torch.ops import middle_flow as MF
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    c = 728
    wdw9 = (torch.randn(9, c, generator=g) * 0.2).to(dev, torch.bfloat16)
    s1 = (torch.rand(c, generator=g) + 0.5).to(dev)
    c1 = (torch.randn(c, generator=g) * 0.1).to(dev)
    cases = {"os16_f32_d1": (torch.randn(8, 32, 32, c, generator=g).to(dev), 1),
             "os16_bf16_d1": (torch.randn(8, 32, 32, c, generator=g).to(
                 dev, torch.bfloat16), 1),
             "os8_f32_d2": (torch.randn(8, 64, 64, c, generator=g).to(dev), 2)}
    plan = MF.dw_stencil_plan
    others = {}
    for src in a.against:
        lib = _build.load(Path(src).resolve())
        lib.mf_dw_stencil.argtypes = MF._lib().mf_dw_stencil.argtypes
        others[src] = lib
    out = {"card": card, "default_rows": MF.STENCIL_ROWS, "ms": {},
           "library_ms": {}, "against_ms": {src: {} for src in others}}
    for name, (z, d) in cases.items():
        ref = MF.dw_stencil_reference(z, wdw9, s1, c1, d, torch.bfloat16)
        zr = torch.relu(z).to(torch.bfloat16).permute(0, 3, 1, 2)
        wconv = (wdw9.float() * s1).t().reshape(c, 1, 3, 3).to(torch.bfloat16)
        out["library_ms"][name] = CS.cuda_ms(torch, lambda: F.conv2d(
            zr, wconv, padding=d, dilation=d, groups=c), 50)
        out["ms"][name] = {}
        for rows in a.rows:
            MF.dw_stencil_plan = functools.partial(plan, rows=rows)
            got = MF.dw_stencil(z, wdw9, s1, c1, d)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise SystemExit(f"dw_stencil differs from its plain version "
                                 f"({name}, rows {rows})")
            out["ms"][name][rows] = CS.cuda_ms(
                torch, lambda: MF.dw_stencil(z, wdw9, s1, c1, d), 50)
        MF.dw_stencil_plan = plan
        for src, lib in others.items():
            zb = torch.empty(z.shape, device=dev, dtype=torch.bfloat16)
            b, h, w, _ = z.shape

            def run():
                rc = lib.mf_dw_stencil(
                    z.data_ptr(), int(z.dtype == torch.float32),
                    wdw9.data_ptr(), s1.data_ptr(), c1.data_ptr(),
                    zb.data_ptr(), b, h, w, c, d, MF.STENCIL_ROWS,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f"{src}: mf_dw_stencil failed ({rc})")
            run()
            torch.cuda.synchronize()
            if not torch.equal(zb, ref):
                raise SystemExit(f"{src}: mf_dw_stencil differs ({name})")
            out["against_ms"][src][name] = CS.cuda_ms(torch, run, 50)
    print("stencil_rows " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
