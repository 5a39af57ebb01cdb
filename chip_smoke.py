#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, the torch and CUDA versions, and
   builds every kernel of the port from ``cervical_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together).
2. Holds each kernel against its plain PyTorch version at the shapes of the
   main path: the Xception middle flow at 512² input, batch 8, 16 blocks in
   bf16 — (8, 32, 32, 728) at dilation 1 (output stride 16) and
   (8, 64, 64, 728) at dilation 2 (output stride 8) — and each of its two
   kernels alone.  Times the kernels, the plain
   versions and a library yardstick with CUDA events, beside the least time
   the card could take (the larger of bytes over 3.35 TB/s and operations
   over 989 TFLOP/s bf16 tensor / 67 TFLOP/s fp32, H100 SXM data sheet).
3. Drives the main path: ``SegPredictor(fused_middle=True)`` at xception,
   os16, 512², 5 classes, bf16, seeded random weights, ``predict_masks`` on
   16 synthetic 960x1280 images at batch 8.  The launch counts are zeroed
   just before and read just after; every kernel must have launched.  The
   masks must agree with the unfused predictor on >= 99% of pixels.
4. Prints one ``{"kernels": [...]}`` line, then as the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, before the last line, if any check fails, if there is no
CUDA device, or if the ``cervical_tpu_torch`` package is not beside it.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES = 3.35e12      # H100 SXM HBM3, bytes/s
PEAK_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
PEAK_FP32 = 67e12         # fp32 FLOP/s outside the tensor cores
TPU_K4 = "cervical_tpu/ops/pallas_xception.py:161"


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(torch, fn, iters, warmup=2):
    """Mean ms per call of ``fn`` over ``iters`` calls, CUDA events, after
    ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, bf16_ops=0.0, fp32_ops=0.0):
    t_bytes = nbytes / PEAK_BYTES
    t_ops = bf16_ops / PEAK_BF16 + fp32_ops / PEAK_FP32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def random_folded(torch, g, nblk, c, device):
    """Folded middle-flow weights scaled as tests/test_pallas_xception.py."""
    def n(*s):
        return torch.randn(*s, generator=g)
    f = {"wdw": (n(nblk, 27, c) * 0.2).to(torch.bfloat16),
         "s1": torch.rand(nblk, 3, c, generator=g) + 0.5,
         "c1": n(nblk, 3, c) * 0.1,
         "wpw": (n(nblk, 3, c, c) * (1.5 / c ** 0.5)).to(torch.bfloat16),
         "c2": n(nblk, 3, c) * 0.1}
    return {k: v.to(device).contiguous() for k, v in f.items()}


def library_middle_flow(torch, F, folded, dilation):
    """Yardstick the port never calls: per separable conv one
    ``F.conv2d(groups=C)`` and one ``torch.matmul`` in bf16 (cuDNN and
    cuBLAS), elementwise ops between them."""
    nblk, _, c = folded["wdw"].shape
    bf = torch.bfloat16
    wd = folded["wdw"].view(nblk, 3, 3, 3, c).permute(0, 1, 4, 2, 3) \
        .unsqueeze(3).contiguous()                      # (nblk,3,C,1,3,3)
    s1, c1, c2 = (folded[k].to(bf) for k in ("s1", "c1", "c2"))

    def run(x):
        d = dilation
        for k in range(nblk):
            skip = torch.relu(x)
            z = skip
            for i in range(3):
                if i:
                    z = torch.relu(z)
                z = F.conv2d(z.permute(0, 3, 1, 2), wd[k, i], padding=d,
                             dilation=d, groups=c).permute(0, 2, 3, 1)
                z = torch.matmul(z * s1[k, i] + c1[k, i], folded["wpw"][k, i])
                z = z + c2[k, i]
            x = z + skip
        return x
    return run


def kernel_phase(torch, F, MF, dev, g, shape=(8, 32, 32, 728, 16)):
    """K4 and its two kernels vs the plain version at the main path's shape
    (B, H, W, C, blocks); times and bounds.  Returns (per-kernel records,
    whole-K4 record)."""
    b, h, w, c, nblk = shape
    m = b * h * w
    folded = random_folded(torch, g, nblk, c, dev)
    x = torch.randn(b, h, w, c, generator=g).to(dev, torch.bfloat16)
    k4 = {"name": "middle_flow_eval", "shape": [b, h, w, c], "blocks": nblk,
          "launches_per_forward": 6 * nblk}

    def gemm_f64(zb, w, c2, skip_src=None):
        z = (torch.matmul(zb.double(), w.double()) + c2).float()
        return z if skip_src is None else \
            (z + torch.relu(skip_src.float())).to(skip_src.dtype)

    # dilation 1 at os16's (B, H, W); dilation 2 at os8's (B, 2H, 2W)
    x_os8 = torch.randn(b, 2 * h, 2 * w, c, generator=g).to(dev, torch.bfloat16)
    for d, xin in ((1, x), (2, x_os8)):
        # each block against the plain version on the same input: f32 sums
        # in another order flip bf16 roundings of zb and of the block output
        # (2^-8 relative each) -> JAX's own bf16 tolerance, rtol=atol=1e-2
        xk, errs, bad = xin, [], 0
        for k in range(nblk):
            part = {n: v[k:k + 1] for n, v in folded.items()}
            out = MF.middle_flow_eval(xk, part, d)
            torch.cuda.synchronize()
            ref = MF.middle_flow_reference(xk, part, d).float()
            err = (out.float() - ref).abs()
            bad += int((err > 1e-2 + 1e-2 * ref.abs()).sum())
            errs.append(err.max().item())
            check(torch.isfinite(out.float()).all().item(),
                  f"K4 block {k} output not finite")
            xk = out
        chained = MF.middle_flow_eval(xin, folded, d)
        check(torch.equal(chained, xk), "the 16-block call differs from the "
              "blocks run one by one")
        print(f"K4 dilation {d} {tuple(xin.shape)}, per block: max_abs_err "
              f"{max(errs):.6g}, {bad} of {nblk * xin.numel()} outside "
              "rtol=atol=1e-2")
        check(bad == 0, f"K4 disagrees with its plain version at dilation {d}")
        k4[f"max_abs_err_d{d}"] = max(errs)
        # whole chain: rounding flips compound over 16 blocks; the plain
        # version drifts as far from an f64-accumulated product
        ref = MF.middle_flow_reference(xin, folded, d).float()
        ref64 = MF._middle_flow(xin, folded, d, MF.dw_stencil_reference,
                                gemm_f64).float()
        for name, got, want in (("kernel vs plain", chained.float(), ref),
                                ("plain vs f64-accumulated plain", ref, ref64)):
            e = (got - want).abs()
            frac = float((e > 1e-2 + 1e-2 * want.abs()).float().mean())
            k4[f"chain_d{d}_{name}"] = {"max_abs_err": e.max().item(),
                                        "frac_outside_1e-2": frac}
            print(f"K4 dilation {d}, 16-block chain, {name}: max abs "
                  f"{e.max().item():.4g} (max |ref| "
                  f"{want.abs().max().item():.4g}), "
                  f"{frac:.4%} outside rtol=atol=1e-2")
    k4["max_abs_err"] = max(k4["max_abs_err_d1"], k4["max_abs_err_d2"])

    lib = library_middle_flow(torch, F, folded, 1)
    k4["ms"] = cuda_ms(torch, lambda: MF.middle_flow_eval(x, folded, 1), 20)
    k4["plain_ms"] = cuda_ms(torch, lambda: MF.middle_flow_reference(x, folded, 1), 5)
    k4["library_ms"] = cuda_ms(torch, lambda: lib(x), 20)
    wbytes = sum(v.numel() * v.element_size() for v in folded.values())
    k4["bound_ms"], k4["bound_by"] = bound_ms(
        2 * x.numel() * 2 + wbytes, bf16_ops=2.0 * m * c * c * 3 * nblk,
        fp32_ops=20.0 * m * c * 3 * nblk)

    # each kernel alone, at the shapes the main path gives it
    wdw9, s1, c1 = folded["wdw"][0, :9], folded["s1"][0, 0], folded["c1"][0, 0]
    wpw, c2 = folded["wpw"][0, 0], folded["c2"][0, 0]
    zf = torch.randn(b, h, w, c, generator=g).to(dev)
    zb = torch.randn(b, h, w, c, generator=g).to(dev, torch.bfloat16)
    st = {"name": "middle_flow.dw_stencil", "source": "csrc/middle_flow.cu",
          "function": "mf_dw_stencil"}
    errs = []
    for z in (x, zf):  # block input (bf16) and f32 z between convs
        for d in (1, 2):
            got = MF.dw_stencil(z, wdw9, s1, c1, d)
            torch.cuda.synchronize()
            ref = MF.dw_stencil_reference(z, wdw9, s1, c1, d, torch.bfloat16)
            e = (got.float() - ref.float()).abs()
            # same f32 ops in the same order, no FMA: bit-exact expected;
            # allowed one bf16 rounding step (2^-8 relative)
            check(bool((e <= 2.0 ** -8 * ref.float().abs()).all()),
                  f"dw_stencil disagrees ({z.dtype}, dilation {d})")
            errs.append(e.max().item())
    st["max_abs_err"] = max(errs)
    st["ms"] = cuda_ms(torch, lambda: MF.dw_stencil(zf, wdw9, s1, c1, 1), 50)
    st["plain_ms"] = cuda_ms(torch, lambda: MF.dw_stencil_reference(
        zf, wdw9, s1, c1, 1, torch.bfloat16), 20)
    zr = torch.relu(zf).to(torch.bfloat16).permute(0, 3, 1, 2)
    wconv = (wdw9.float() * s1).t().reshape(c, 1, 3, 3).to(torch.bfloat16)
    st["library_ms"] = cuda_ms(torch, lambda: F.conv2d(
        zr, wconv, padding=1, groups=c), 50)
    st["library"] = "F.conv2d(groups=C), bf16, BN scale folded into taps"
    st["bound_ms"], st["bound_by"] = bound_ms(
        zf.numel() * 4 + zb.numel() * 2 + 9 * c * 2 + 2 * c * 4,
        fp32_ops=20.0 * m * c)
    st["timed_shape"] = f"({b},{h},{w},{c}) f32 in, bf16 out, dilation 1"

    gm = {"name": "middle_flow.pw_gemm", "source": "csrc/middle_flow.cu",
          "function": "mf_pw_gemm"}
    got = MF.pw_gemm(zb, wpw, c2)
    torch.cuda.synchronize()
    ref = MF.pw_gemm_reference(zb, wpw, c2)
    e1 = (got - ref).abs()
    # f32 sums of 728 exact bf16 products in another order: ~1e-6 relative
    check(bool((e1 <= 1e-3 + 1e-3 * ref.abs()).all()), "pw_gemm disagrees")
    got = MF.pw_gemm(zb, wpw, c2, skip_src=x)
    torch.cuda.synchronize()
    ref = MF.pw_gemm_reference(zb, wpw, c2, skip_src=x)
    e2 = (got.float() - ref.float()).abs()
    # bf16 output: the same sums rounded once (one bf16 step, 2^-7
    # relative), plus the f32 sum's own error where the skip cancels it
    check(bool((e2 <= 2.0 ** -7 * ref.float().abs() + 1e-3).all()),
          "pw_gemm (final, bf16 out) disagrees")
    gm["max_abs_err"] = max(e1.max().item(), e2.max().item())
    gm["ms"] = cuda_ms(torch, lambda: MF.pw_gemm(zb, wpw, c2), 50)
    gm["plain_ms"] = cuda_ms(torch, lambda: MF.pw_gemm_reference(zb, wpw, c2), 20)
    a2 = zb.view(m, c)
    gm["library_ms"] = cuda_ms(torch, lambda: torch.matmul(a2, wpw), 50)
    gm["library"] = "torch.matmul bf16 (cuBLAS), shift not included"
    gm["bound_ms"], gm["bound_by"] = bound_ms(
        zb.numel() * 2 + wpw.numel() * 2 + c * 4 + m * c * 4,
        bf16_ops=2.0 * m * c * c)
    gm["timed_shape"] = f"M={m} K=N={c}, f32 out"
    for r in (st, gm):
        r["kernel_ms"] = r["ms"]
        print(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
              f"library {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"by {r['bound_by']}), max_abs_err {r['max_abs_err']:.3g}")
    print(f"K4 middle_flow_eval {k4['shape']} x {nblk} blocks: "
          f"{k4['ms']:.4f} ms (plain {k4['plain_ms']:.4f}, library "
          f"{k4['library_ms']:.4f}, bound {k4['bound_ms']:.4f} by "
          f"{k4['bound_by']})")
    return [st, gm], k4


def random_state(torch, model, g):
    """Seeded weights that keep a 20-block chain tame while the logits still
    depend on every block: kaiming-scaled kernels, BN scale ~1 except ~0.1
    where a residual branch closes, randomized running stats."""
    out = {}
    for k, v in model.state_dict().items():
        if not v.dtype.is_floating_point:
            out[k] = v.clone()
        elif k.endswith("running_var"):
            out[k] = 0.8 + 0.4 * torch.rand(v.shape, generator=g)
        elif k.endswith("running_mean"):
            out[k] = 0.05 * torch.randn(v.shape, generator=g)
        elif v.ndim == 1 and k.endswith(".weight"):
            loc = 0.1 if "sepconv3.bn2" in k else 1.0
            out[k] = loc + 0.02 * torch.randn(v.shape, generator=g)
        elif v.ndim == 1:
            out[k] = 0.05 * torch.randn(v.shape, generator=g)
        else:
            fan_in = v[0].numel()
            out[k] = (2.0 / fan_in) ** 0.5 * torch.randn(v.shape, generator=g)
    return out


def predictor_phase(torch, MF, g, input_shape=(512, 512),
                    image_hw=(960, 1280)):
    from cervical_tpu_torch.config import SegTrainConfig
    from cervical_tpu_torch.inference.predictor import SegPredictor
    from cervical_tpu_torch.train.seg_trainer import build_model

    cfg = SegTrainConfig()  # xception, os16, 512², 5 classes, bf16
    check((cfg.backbone, cfg.downsample_factor, cfg.data.num_classes,
           cfg.dtype) == ("xception", 16, 5, "bfloat16"), "config defaults")
    cfg.data.input_shape = input_shape
    state = random_state(torch, build_model(cfg), g)
    fused = SegPredictor(cfg, state, fused_middle=True)
    plain = SegPredictor(cfg, state)
    n, batch = 16, 8
    images = torch.randint(0, 256, (n,) + tuple(image_hw) + (3,), generator=g,
                           dtype=torch.uint8).numpy()
    fused.predict_masks(images[:batch], batch)  # warm-up
    torch.cuda.synchronize()

    MF.reset_launches()
    t0 = time.perf_counter()
    masks = fused.predict_masks(images, batch)
    dt = time.perf_counter() - t0
    launches = dict(MF.LAUNCHES)
    per_forward = 3 * 16  # 16 blocks x 3 separable convs, each kernel once
    forwards = -(-n // batch)
    print(f"main path predict_masks: {n} images {image_hw} at batch {batch} in "
          f"{dt:.3f} s = {n / dt:.2f} images/s; launches {launches}")
    for name in ("dw_stencil", "pw_gemm"):
        check(launches[name] == per_forward * forwards,
              f"{name} launched {launches[name]} times on the main path, "
              f"expected {per_forward * forwards}")

    check(masks.shape == (n,) + tuple(image_hw) and str(masks.dtype) == "uint8",
          f"masks {masks.shape} {masks.dtype}")
    check(int(masks.max()) < cfg.data.num_classes, "class id out of range")
    ref = plain.predict_masks(images, batch)
    agree = float((masks == ref).mean())
    hist = [int(v) for v in (torch.bincount(torch.from_numpy(masks).flatten().long(),
                                            minlength=5))]
    print(f"fused vs unfused masks agree on {agree:.6f} of pixels; "
          f"class histogram {hist}")
    # argmax ties on an untrained net flip between equally right programs
    check(agree >= 0.99, f"fused/unfused masks agree on only {agree:.4f}")
    probs = fused.predict_probs(images[0])
    check(probs.shape == tuple(image_hw) + (5,) and bool((abs(probs.sum(-1) - 1)
                                                  < 1e-3).all()),
          "probs are not a distribution")
    ref_probs = plain.predict_probs(images[0])
    pdiff = float(abs(probs - ref_probs).max())
    # where the unfused top-2 gap exceeds twice the largest prob drift, no
    # drift can flip the argmax: there the two paths must agree exactly
    top2 = torch.from_numpy(ref_probs).topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1] > 2 * pdiff).numpy()
    flips = int((probs.argmax(-1) != ref_probs.argmax(-1))[decided].sum())
    print(f"fused vs unfused probs: max abs diff {pdiff:.4g}; argmax flips "
          f"{flips} on the {decided.mean():.4%} of pixels whose top-2 gap "
          f"exceeds {2 * pdiff:.3g}")
    check(flips == 0, f"{flips} argmax flips beyond the probs drift")

    t0 = time.perf_counter()
    plain.predict_masks(images, batch)
    dt_plain = time.perf_counter() - t0
    res = {"predict_masks_img_s": n / dt,
           "predict_masks_unfused_img_s": n / dt_plain,
           "throughput_fused_img_s": fused.get_throughput(batch),
           "throughput_unfused_img_s": plain.get_throughput(batch),
           "mask_agreement": agree, "probs_max_abs_diff": pdiff,
           "decided_share": float(decided.mean()), "decided_flips": flips,
           "class_histogram": hist}
    print("predictor " + json.dumps(res))
    return launches


def main():
    if not os.path.isdir(os.path.join(HERE, "cervical_tpu_torch")):
        print("chip_smoke.py: the cervical_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import torch.nn.functional as F
    from cervical_tpu_torch.ops import _build
    from cervical_tpu_torch.ops import middle_flow as MF

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"kernels built in {build_s:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {name}: {line.strip()}")

    dev = torch.device("cuda")
    records, k4 = kernel_phase(torch, F, MF, dev,
                               torch.Generator().manual_seed(0))
    launches = predictor_phase(torch, MF, torch.Generator().manual_seed(1))

    kernels = []
    for r in records:
        short = r["name"].split(".")[-1]
        kernels.append({
            "name": r["name"], "route": "cuda",
            "source": "cervical_tpu_torch/" + r["source"],
            "replaces": TPU_K4, "launches": launches[short],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "kernel_ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "timed_shape": r["timed_shape"]})
    print(json.dumps({"k4_middle_flow_eval": k4}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke.py FAILED: {e}", file=sys.stderr)
        sys.exit(3)
