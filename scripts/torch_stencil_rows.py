#!/usr/bin/env python3
"""Time the middle flow's stencil kernel at each number of output rows in
its plan, on one card.

    python scripts/torch_stencil_rows.py [--rows 1 2 4 8 16] [--f32]
        [--against OTHER/middle_flow.cu ...]

bf16 (``mf_dw_stencil``; rows: output rows a thread walks): at the serving
path's shapes, batch 8 at 512² input: (8, 32, 32, 728) at dilation 1
(output stride 16), f32 z between convs and the bf16 block input, and
(8, 64, 64, 728) f32 at dilation 2 (output stride 8).  ``--f32``
(``mf_dw_stencil_f32``; rows: output rows a block walks, the plan's
``STENCIL_F32_ROWS`` per dilation): the f32 z at those two shapes, f32
taps and zb, TF32 off.  Each launch is first held bit for bit against
``dw_stencil_reference``; then CUDA-event means over 50 calls, beside
``F.conv2d(groups=C)`` on the same input in the same type (the library
yardstick).  ``--against`` builds other versions of ``csrc/middle_flow.cu``
with the same C interface and times their kernel on the same inputs in
the same process, each also held bit for bit.  Prints the card's name and
power limit and one ``stencil_rows {...}`` line.  Needs a CUDA card.
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
    ap.add_argument("--f32", action="store_true")
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
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    c = 728
    dtype = torch.float32 if a.f32 else torch.bfloat16
    wdw9 = (torch.randn(9, c, generator=g) * 0.2).to(dev, dtype)
    s1 = (torch.rand(c, generator=g) + 0.5).to(dev)
    c1 = (torch.randn(c, generator=g) * 0.1).to(dev)
    cases = {"os16_f32_d1": (torch.randn(8, 32, 32, c, generator=g).to(dev), 1),
             "os8_f32_d2": (torch.randn(8, 64, 64, c, generator=g).to(dev), 2)}
    if not a.f32:
        cases["os16_bf16_d1"] = (torch.randn(8, 32, 32, c, generator=g).to(
            dev, torch.bfloat16), 1)
    plan_name = "dw_stencil_f32_plan" if a.f32 else "dw_stencil_plan"
    plan = getattr(MF, plan_name)
    entry = "mf_dw_stencil_f32" if a.f32 else "mf_dw_stencil"
    others = {}
    for src in a.against:
        lib = _build.load(Path(src).resolve())
        getattr(lib, entry).argtypes = getattr(MF._lib(), entry).argtypes
        others[src] = getattr(lib, entry)
    out = {"card": card, "dtype": str(dtype),
           "default_rows": MF.STENCIL_F32_ROWS if a.f32 else MF.STENCIL_ROWS,
           "ms": {}, "library_ms": {}, "against_ms": {s: {} for s in others}}
    for name, (z, d) in cases.items():
        ref = MF.dw_stencil_reference(z, wdw9, s1, c1, d, dtype)
        zr = torch.relu(z).to(dtype).permute(0, 3, 1, 2)
        wconv = (wdw9.float() * s1).t().reshape(c, 1, 3, 3).to(dtype)
        out["library_ms"][name] = CS.cuda_ms(torch, lambda: F.conv2d(
            zr, wconv, padding=d, dilation=d, groups=c), 50)
        out["ms"][name] = {}
        for rows in a.rows:
            setattr(MF, plan_name, functools.partial(plan, rows=rows))
            got = MF.dw_stencil(z, wdw9, s1, c1, d, dtype)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise SystemExit(f"{entry} differs from its plain version "
                                 f"({name}, rows {rows})")
            out["ms"][name][rows] = CS.cuda_ms(
                torch, lambda: MF.dw_stencil(z, wdw9, s1, c1, d, dtype), 50)
        setattr(MF, plan_name, plan)
        rows = plan(*z.shape, d)["rows"]
        for src, fn in others.items():
            zb = torch.empty(z.shape, device=dev, dtype=dtype)
            b, h, w, _ = z.shape
            lead = () if a.f32 else (int(z.dtype == torch.float32),)

            def run():
                rc = fn(z.data_ptr(), *lead, wdw9.data_ptr(), s1.data_ptr(),
                        c1.data_ptr(), zb.data_ptr(), b, h, w, c, d, rows,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f"{src}: {entry} failed ({rc})")
            run()
            torch.cuda.synchronize()
            if not torch.equal(zb, ref):
                raise SystemExit(f"{src}: {entry} differs ({name})")
            out["against_ms"][src][name] = CS.cuda_ms(torch, run, 50)
    print("stencil_rows " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
