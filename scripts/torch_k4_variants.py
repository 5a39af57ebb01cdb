#!/usr/bin/env python3
"""Time variants of K4's f32 kernels (``mf_dw_stencil_f32``,
``mf_pw_gemm_f32`` in ``csrc/middle_flow.cu``) against each other on one
card, in one process, in turns, without the wrappers.

    python scripts/torch_k4_variants.py \\
        --variant 'out6:constexpr int S_OUT = 4;=>constexpr int S_OUT = 6;' \\
        --variant 'parent:@archive_check/parent/cervical_tpu_torch/csrc/middle_flow.cu' \\
        [--stencil-rows 4 8] [--rounds 2] [--only stencil|gemm]

A variant is this checkout's ``middle_flow.cu`` with its ``OLD=>NEW``
text replacements applied (several joined by ``@@``; each OLD must
occur), or, given as ``NAME:@PATH``, another source with the same C
entries; the first variant, ``base``, is the file as it is.  A source
may hold either kernel or both.  Each is built with the package's
``nvcc`` flags into a temporary directory, all builds started together,
and its C functions called through ctypes on the same inputs, at the
serving path's shapes (batch 8, 512² input): the stencil on (8, 32, 32,
728) f32 at dilation 1 (os16) and (8, 64, 64, 728) at dilation 2 (os8),
each at every ``--stencil-rows``; the product at M 8192, K = N 728, on
the weight's TF32 parts where the source splits its weights
(``mf_tf32_split`` present), else on the f32 weight as it is.  Every
stencil output must equal ``dw_stencil_reference`` bit for bit and every
product lie within ``chip_smoke.F32_GEMM_RTOL`` of |zb| @ |W| from
``torch.mm`` (TF32 off; each product's and ``torch.mm``'s largest error
from an f64-accumulated product are printed beside); then the variants
are timed in turns (base
first, each variant, then back in reverse, ``--rounds`` times) with
``chip_smoke.cuda_ms``.  Prints one line ``k4variants {...}`` with the
card's name and power limit, each variant's ms per case and its ptxas
lines.  Needs a CUDA card; imports no JAX.
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
        for edit in edits.split("@@"):
            old, sep, new = edit.partition("=>")
            if not sep or old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in "
                                 "middle_flow.cu")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_all(sources, workdir, nvcc, flags):
    """Compile every source at once; {name: (library path, ptxas lines of
    the f32 kernels)}."""
    procs = {}
    for name, text in sources.items():
        src = os.path.join(workdir, f"mf_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(workdir, f"mf_{name}.so")
        procs[name] = (subprocess.Popen([nvcc, *flags, "-o", lib, src],
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{log}")
        lines, keep = [], False
        for ln in log.splitlines():
            if "Compiling entry function" in ln:  # f32 kernels only
                keep = "f32" in ln or "dw_stencil_kernelIffE" in ln
            if keep:
                lines.append(ln.strip())
        built[name] = (lib, lines)
    return built


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME:OLD=>NEW")
    ap.add_argument("--stencil-rows", type=int, nargs="+", default=[8])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", choices=("stencil", "gemm"))
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_k4_variants.py: no CUDA device")
    from cervical_tpu_torch.ops import _build
    from cervical_tpu_torch.ops import middle_flow as MF
    smoke = _module("chip_smoke_timing", os.path.join(ROOT, "chip_smoke.py"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    sources = variant_sources(MF.SOURCE.read_text(), a.variant)
    workdir = tempfile.mkdtemp(prefix="k4_variants_")
    built = build_all(sources, workdir, _build.nvcc_path(),
                      _build.NVCC_FLAGS)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    stencils, gemms = {}, {}
    for name, (path, _) in built.items():
        lib = ctypes.CDLL(path)
        if a.only != "gemm" and hasattr(lib, "mf_dw_stencil_f32"):
            fn = lib.mf_dw_stencil_f32
            fn.argtypes = [vp] * 5 + [i32] * 6 + [vp]
            fn.restype = i32
            stencils[name] = fn
        if a.only != "stencil" and hasattr(lib, "mf_pw_gemm_f32"):
            fn = lib.mf_pw_gemm_f32
            fn.argtypes = [vp] * 5 + [i32] * 4 + [vp]
            fn.restype = i32
            gemms[name] = (fn, hasattr(lib, "mf_tf32_split"))

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(3)
    c = 728
    stream = torch.cuda.current_stream().cuda_stream
    wdw9 = (torch.randn(9, c, generator=g) * 0.2).to(dev)
    s1 = (torch.rand(c, generator=g) + 0.5).to(dev)
    c1 = (torch.randn(c, generator=g) * 0.1).to(dev)
    cases = {"os16_d1": (torch.randn(8, 32, 32, c, generator=g).to(dev), 1),
             "os8_d2": (torch.randn(8, 64, 64, c, generator=g).to(dev), 2)}
    zb = torch.randn(8, 32, 32, c, generator=g).to(dev)
    w = (torch.randn(c, c, generator=g) * (1.5 / c ** 0.5)).to(dev)
    w_t = w.t().contiguous()
    w_split = torch.stack(MF.tf32_split(w_t), 0)
    c2 = (torch.randn(c, generator=g) * 0.1).to(dev)
    out_g = torch.empty(8, 32, 32, c, device=dev)
    smem = MF.pw_gemm_f32_plan(8192, c, c)["smem_bytes"]
    outs = {k: torch.empty_like(z) for k, (z, _) in cases.items()}

    def stencil(name, case, rows):
        z, d = cases[case]
        b, h, w_, _ = z.shape
        rc = stencils[name](z.data_ptr(), wdw9.data_ptr(), s1.data_ptr(),
                            c1.data_ptr(), outs[case].data_ptr(), b, h, w_,
                            c, d, rows, stream)
        if rc:
            raise RuntimeError(f"variant {name}: stencil error {rc}")
        return outs[case]

    def gemm(name):
        fn, split = gemms[name]
        # an older source's smem check may want its own plan's bytes
        rc = fn(zb.data_ptr(), (w_split if split else w_t).data_ptr(),
                c2.data_ptr(), None, out_g.data_ptr(), 8192, c, c,
                smem if split else 16896, stream)
        if rc:
            raise RuntimeError(f"variant {name}: gemm error {rc}")
        return out_g

    res = {"card": card, "ptxas": {n: v[1] for n, v in built.items()},
           "stencil_equal": {}, "gemm_ratio": {}, "ms": {}}
    for case, (z, d) in cases.items():
        ref = MF.dw_stencil_reference(z, wdw9, s1, c1, d, torch.float32)
        for name in stencils:
            for rows in a.stencil_rows:
                got = stencil(name, case, rows)
                torch.cuda.synchronize()
                res["stencil_equal"][f"{name}_{case}_r{rows}"] = \
                    torch.equal(got, ref)
    ref = MF.pw_gemm_reference(zb, w, c2)
    exact = (zb.double().view(-1, c) @ w.double()).view(ref.shape) \
        + c2.double()
    res["gemm_f64_err"] = {"torch.mm": (ref.double() - exact).abs().max()
                           .item()}
    for name in gemms:
        got = gemm(name)
        torch.cuda.synchronize()
        res["gemm_ratio"][name] = smoke.f32_gemm_ratio(got, ref, zb, w)
        res["gemm_f64_err"][name] = (got.double() - exact).abs().max().item()
    timed = [(f"stencil_{case}_r{rows}", name,
              lambda name=name, case=case, rows=rows: stencil(name, case,
                                                               rows))
             for name in stencils for case in cases
             for rows in a.stencil_rows]
    timed += [("gemm_os16", name, lambda name=name: gemm(name))
              for name in gemms]
    order = list(built)
    for _ in range(a.rounds):
        for name in order + order[::-1]:
            for what, who, fn in timed:
                if who == name:
                    res["ms"].setdefault(name, {}).setdefault(
                        what, []).append(smoke.cuda_ms(torch, fn, 50))
    print("k4variants " + json.dumps(res), flush=True)
    ok = all(res["stencil_equal"].values()) and all(
        r <= smoke.F32_GEMM_RTOL for r in res["gemm_ratio"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
