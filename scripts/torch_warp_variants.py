#!/usr/bin/env python3
"""Time variants of K5 ``warp_photo_images`` (``csrc/warp.cu``) against each
other on one card, in one process, in turns, without the wrapper.

    python scripts/torch_warp_variants.py \\
        --variant 'halo4:K5_HALO_RUN = 6=>K5_HALO_RUN = 4' \\
        --variant 'other:@path/to/warp_variant.cu' [--rounds 2]

A variant is this checkout's ``warp.cu`` with its ``OLD=>NEW`` text
replacements applied (several joined by ``;;``; each OLD must occur), or,
given as ``NAME:@PATH``, another source file with the same C interface;
the first variant, ``base``, is the file as it is.  Each is built with the
package's ``nvcc`` flags into a temporary directory, all builds started
together, and its C function ``warp_photo_images`` called through ctypes
on the same inputs: the smoke's batch (8, 3, 512, 512) uint8 read through
its NHWC view, bf16 out, at the three mixes of
``scripts/torch_warp_compare.py`` (none / smoke / all rotated and
blurred).  Every variant's output must equal the plain version's; then
the variants are timed in turns (base first, then each variant, then
back in reverse, ``--rounds`` times) with ``chip_smoke.cuda_ms``.  Prints
one line ``warpvariants {...}`` with the card's name and power limit,
each variant's ms per mix and its ptxas lines.  Needs a CUDA card;
imports no JAX.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def variant_sources(base, specs):
    """{name: source text}: ``base`` first, then each ``NAME:OLD=>NEW`` or
    ``NAME:@PATH``."""
    out = {"base": base}
    for spec in specs:
        name, _, edits = spec.partition(":")
        if edits.startswith("@"):
            with open(edits[1:]) as f:
                out[name] = f.read()
            continue
        text = base
        for edit in edits.split(";;"):
            old, sep, new = edit.partition("=>")
            if not sep or old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in warp.cu")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_all(sources, workdir, nvcc, flags):
    """Compile every source at once; {name: (library path, ptxas lines)}."""
    procs = {}
    for name, text in sources.items():
        src = os.path.join(workdir, f"warp_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(workdir, f"warp_{name}.so")
        procs[name] = (subprocess.Popen([nvcc, *flags, "-o", lib, src],
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{log}")
        built[name] = (lib, [ln.strip() for ln in log.splitlines()
                             if "warp_photo" in ln or "registers" in ln
                             or "spill" in ln])
    return built


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME:OLD=>NEW")
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_warp_variants.py: no CUDA device")
    from cervical_tpu_torch.ops import _build
    from cervical_tpu_torch.ops import augment as A
    from cervical_tpu_torch.ops import warp as W
    cuda_ms = _module("chip_smoke_timing",
                      os.path.join(ROOT, "chip_smoke.py")).cuda_ms
    mix_rows = _module("warp_compare", os.path.join(
        HERE, "torch_warp_compare.py")).mix_rows
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    sources = variant_sources(W.SOURCE.read_text(), a.variant)
    workdir = tempfile.mkdtemp(prefix="warp_variants_")
    built = build_all(sources, workdir, _build.nvcc_path(),
                      _build.NVCC_FLAGS)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fns = {}
    for name, (lib, _) in built.items():
        fn = ctypes.CDLL(lib).warp_photo_images
        fn.argtypes = [vp, i64, i64, i64, i64, i32, i32, i32, vp, vp, i32,
                       i32, vp]
        fn.restype = i32
        fns[name] = fn

    dev = torch.device("cuda")
    b, s = 8, 512
    g = torch.Generator().manual_seed(2)
    params, rows, flags = mix_rows(torch, W, A, b, s)
    A.sample_augment_params(g, b, rotate_prefix=b // 4, blur_suffix=b // 4)
    x = torch.randint(0, 256, (b, s, s, 3), generator=g,
                      dtype=torch.uint8).to(dev).permute(0, 3, 1, 2)
    gains = params["gains"].to(dev)
    full = {m: torch.cat([rows[m].to(dev), gains.float(),
                          flags[m].to(dev).float()[:, None]], 1)
            for m in rows}
    out = torch.empty(b, 3, s, s, dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def call(name, mix):
        rc = fns[name](x.data_ptr(), *x.stride(), b, s, s,
                       full[mix].data_ptr(), out.data_ptr(), 0, s, stream)
        if rc:
            raise RuntimeError(f"variant {name}: CUDA error {rc}")
        return out

    res = {"card": card, "ptxas": {n: v[1] for n, v in built.items()},
           "differing": {}, "ms": {n: {m: [] for m in full} for n in fns}}
    for mix in full:
        ref = W.warp_photo_images_reference(x, full[mix], s)
        for name in fns:
            got = call(name, mix)
            torch.cuda.synchronize()
            res["differing"][f"{name}_{mix}"] = int((got != ref).sum())
    order = list(fns)
    for _ in range(a.rounds):
        for name in order + order[::-1]:
            for mix in full:
                res["ms"][name][mix].append(
                    cuda_ms(torch, lambda: call(name, mix), 50))
    print("warpvariants " + json.dumps(res), flush=True)
    return 1 if any(res["differing"].values()) else 0


if __name__ == "__main__":
    sys.exit(main())
