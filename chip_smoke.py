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
3. Drives the serving path: ``SegPredictor(fused_middle=True)`` at
   xception, os16, 512², 5 classes, bf16, seeded random weights,
   ``predict_masks`` on 16 synthetic 960x1280 images at batch 8.  The launch
   counts are zeroed just before and read just after; every kernel must
   have launched.  The masks must agree with the unfused predictor on >= 99%
   of pixels.
4. Holds the augmentation kernels K1 ``warp_images`` (bf16 and uint8 out),
   K2 ``warp_labels``, K3 ``photometric`` (select/all/none, bf16 and
   uint8 in) and K5 ``warp_photo_images`` against their plain versions at
   batch 8, 512², on parameter rows sampled as the train step samples them
   (rotation on 2 images, blur on 2): K2 exact, K1, K3 and K5 within one
   bf16 step on at most 1e-4 of the elements.  K5 is also held against the
   K1 -> K3 kernel chain (the count of differing elements printed), and
   ``augment_batch_kernels(fused=True)``, K5's one caller, against
   ``fused=False`` (labels exact), with its launch counts zeroed before and
   read after.  Times each kernel beside its plain version and its bound,
   and K5 beside K1 + K3.
5. Drives the training path: ``SegTrainer`` at the default config (xception,
   os16, 512², 5 classes, bf16, Adam 1e-4, focal + dice, class weights
   (1,1,5,3,4)) with ``data.aug_backend="pallas"`` on 32 synthetic 512²
   images: ``run_epoch`` at batch 8 unfrozen, then at batch 16 frozen, each
   followed by the eval pass over 12 images at batch 8 (one ragged batch,
   padded with weight-0 rows).  Counts are zeroed before each epoch and read
   after: K1-K3 launch once per train step.  Losses must be finite, the
   frozen epoch must leave the backbone's params and Adam state bit-
   identical, the eval confusion matrix must count every val pixel once.
   Then times the train step (ms/step, images/s, after warm-up) and reads
   the card's idle share over profiled steps.
6. Drives the fit path at the same width on a synthetic VOC of 24 train and
   8 val 512² images written to a temporary directory: ``SegTrainer.fit``
   with one frozen epoch of 3, a checkpoint every epoch, the eval step's
   and the predictor's mIoU at epoch 2 (K4 in the eval passes).  Counts are
   zeroed before and read after: K1-K3 once per train step of each epoch,
   K4 48 times per eval forward.  The three checkpoint kinds exist after
   each epoch, the callbacks' files have their lines, every loss is finite,
   and ``last_epoch_weights`` restores the model and both Adam states bit
   for bit into a fresh state.  Then ``python -m
   cervical_tpu_torch.train_seg`` on the same data, sent SIGTERM once
   epoch 1 is logged, must finish epoch 2, checkpoint it and exit 0.
   Prints seconds per epoch and the peak memory.
7. Prints one ``{"kernels": [...]}`` line (six kernels), then as the last
   line ``{"ok": true, "device": {...}}``.

Exits non-zero, before the last line, if any check fails, if there is no
CUDA device, or if the ``cervical_tpu_torch`` package is not beside it.
"""

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES = 3.35e12      # H100 SXM HBM3, bytes/s
PEAK_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
PEAK_FP32 = 67e12         # fp32 FLOP/s outside the tensor cores
TPU_K4 = "cervical_tpu/ops/pallas_xception.py:161"
TPU_WARP = {"warp_images": "cervical_tpu/ops/pallas_warp.py:298",
            "warp_labels": "cervical_tpu/ops/pallas_warp.py:325",
            "photometric": "cervical_tpu/ops/pallas_warp.py:554",
            "warp_photo_images": "cervical_tpu/ops/pallas_warp.py:412"}
TRAIN_KERNELS = ("warp_images", "warp_labels", "photometric")  # per step
NO_LIBRARY = ("no single PyTorch call computes it: F.grid_sample is a direct "
              "bilinear warp, not the 3-shear with bf16 staging, and there is "
              "no fused blur + cv2-HSV op")


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


def one_step_ok(torch, got, ref, step_rel=2.0 ** -7, step_abs=0.0,
                max_share=1e-4):
    """(max abs err, share of differing elements, within?) — every element
    within one bf16 step (``step_rel`` of the value; ``step_abs`` for uint8
    counts), at most ``max_share`` differing at all: the CPU tests' bound
    against JAX."""
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    share = float((d > 0).float().mean())
    ok = bool((d <= step_rel * ref.abs() + step_abs).all()) and \
        share <= max_share
    return float(d.max()), share, ok


def warp_phase(torch, W, A, dev, g, b=8, s=512):
    """K1-K3 against their plain versions at the train step's shapes; times
    and bounds.  Returns {kernel: record}."""
    params = A.sample_augment_params(g, b, rotate_prefix=b // 4,
                                     blur_suffix=b // 4)
    wp = W.make_warp_params(params, (s, s), (s, s)).to(dev)
    images = torch.randint(0, 256, (b, s, s, 3), generator=g,
                           dtype=torch.uint8).to(dev)
    labels = torch.randint(0, 5, (b, s, s), generator=g,
                           dtype=torch.uint8).to(dev)
    x = images.permute(0, 3, 1, 2)  # NHWC read through its permuted view
    gains, flags = params["gains"].to(dev), params["blur"].to(dev)
    n_rot = int((params["angle"] != 0).sum())
    n_blur = int(params["blur"].sum())
    px = b * s * s
    recs = {}

    errs, shares = [], []
    for out_dtype, step_abs, step_rel in ((torch.bfloat16, 0.0, 2.0 ** -7),
                                          (torch.uint8, 1.0, 0.0)):
        got = W.warp_images(x, wp, s, out_dtype)
        torch.cuda.synchronize()
        ref = W.warp_images_reference(x, wp, s, out_dtype)
        err, share, ok = one_step_ok(torch, got, ref, step_rel, step_abs)
        check(ok, f"warp_images ({out_dtype}) disagrees: max {err}, "
              f"{share:.3g} of elements differ")
        errs.append(err)
        shares.append(share)
    # the function's f32 operations per output pixel, not the kernel's
    # recomputation: one bilinear resample, 3 channels x 3 two-tap passes
    # of 2 products, 2 sums and a bf16 rounding (45; the taps and weights
    # are per row or column); a rotated pixel adds 3 shears, each a shifted
    # index, its validity test and a 2-op lerp per channel (3 x 9)
    k1_ops = s * s * (b * 45 + n_rot * 3 * 9)
    recs["warp_images"] = {
        "max_abs_err": max(errs), "mismatch_share": max(shares),
        "ms": cuda_ms(torch, lambda: W.warp_images(x, wp, s), 50),
        "plain_ms": cuda_ms(torch, lambda: W.warp_images_reference(x, wp, s), 5),
        "timed": f"({b},3,{s},{s}) uint8 NHWC view -> bf16, {n_rot} rotated",
        "bounds": (images.numel() + px * 3 * 2 + wp.numel() * 4, k1_ops)}

    got = W.warp_labels(labels, wp, s)
    torch.cuda.synchronize()
    ref = W.warp_labels_reference(labels, wp, s)
    check(torch.equal(got, ref), "warp_labels disagrees with its plain "
          f"version on {int((got != ref).sum())} pixels")
    # one nearest resample (a gather and its in-bounds select, 2 ops) per
    # pixel; a rotated pixel adds 3 shear shifts (index, validity: 4 each)
    k2_ops = s * s * (b * 2 + n_rot * 3 * 4)
    recs["warp_labels"] = {
        "max_abs_err": 0.0, "mismatch_share": 0.0,
        "ms": cuda_ms(torch, lambda: W.warp_labels(labels, wp, s), 50),
        "plain_ms": cuda_ms(torch, lambda: W.warp_labels_reference(
            labels, wp, s), 5),
        "timed": f"({b},{s},{s}) uint8, {n_rot} rotated",
        "bounds": (2 * px + wp.numel() * 4, k2_ops)}

    warped = W.warp_images(x, wp, s)
    warped_u8 = W.warp_images(x, wp, s, torch.uint8)
    errs, shares = [], []
    for inp in (warped, warped_u8):
        for mode in W.BLUR_MODES:
            got = W.photometric(inp, gains, flags, blur_mode=mode)
            torch.cuda.synchronize()
            ref = W.photometric_reference(inp, gains, flags, blur_mode=mode)
            err, share, ok = one_step_ok(torch, got, ref)
            check(ok, f"photometric ({inp.dtype}, {mode}) disagrees: max "
                  f"{err}, {share:.3g} of elements differ")
            errs.append(err)
            shares.append(share)
    # ~40 f32 ops of HSV per pixel, plus 2 x 8 per channel where it blurs
    k3_ops = s * s * (b * 40 + n_blur * 48)
    recs["photometric"] = {
        "max_abs_err": max(errs), "mismatch_share": max(shares),
        "ms": cuda_ms(torch, lambda: W.photometric(warped, gains, flags), 50),
        "plain_ms": cuda_ms(torch, lambda: W.photometric_reference(
            warped, gains, flags), 5),
        "timed": f"({b},3,{s},{s}) bf16 -> bf16, select, {n_blur} blurred",
        "bounds": (2 * warped.numel() * 2 + gains.numel() * 4 + b, k3_ops)}
    recs["warp_photo_images"] = k5_check(torch, W, A, x, labels, params, wp,
                                         gains, flags, s, k1_ops + k3_ops)
    for name, r in recs.items():
        nbytes, ops = r.pop("bounds")
        r["bound_ms"], r["bound_by"] = bound_ms(nbytes, fp32_ops=ops)
        r["library_ms"] = None
        print(f"{name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} by {r['bound_by']}), max_abs_err "
              f"{r['max_abs_err']:.3g}, {r['mismatch_share']:.3g} of elements "
              f"differ; {r['timed']}")
    return recs


def k5_check(torch, W, A, x, labels, params, wp, gains, flags, s, ops):
    """K5 ``warp_photo_images`` on the train step's rows: against its plain
    version and against the K1 -> K3 kernel chain (expected equal: the same
    f32 operations with the same roundings), ``augment_batch_kernels``
    with ``fused=True`` against ``fused=False`` (labels exact), then K5's
    time beside K1 + K3's and the plain version's.  The fused path is
    driven once with the counts zeroed before and read after."""
    b = x.shape[0]
    full = torch.cat([wp, gains.float(), flags.float()[:, None]], 1)
    got = W.warp_photo_images(x, full, s)
    torch.cuda.synchronize()
    ref = W.warp_photo_images_reference(x, full, s)
    err, share, ok = one_step_ok(torch, got, ref)
    check(ok, f"warp_photo_images disagrees with its plain version: max "
          f"{err}, {share:.3g} of elements differ")

    def chain():
        return W.photometric(W.warp_images(x, wp, s), gains, flags)
    want = chain()
    d = got.float() - want.float()
    n_diff = int((d != 0).sum())
    c_err, c_share, c_ok = one_step_ok(torch, got, want)
    print(f"warp_photo_images vs the K1 -> K3 kernels: {n_diff} of "
          f"{got.numel()} elements differ, largest difference "
          f"{float(d.max()):.3g} / {float(d.min()):.3g}")
    check(c_ok, f"warp_photo_images disagrees with K1 -> K3: max {c_err}, "
          f"{c_share:.3g} of elements differ")

    images = x.permute(0, 2, 3, 1)  # the NHWC batch
    W.reset_launches()
    fi, fl = W.augment_batch_kernels(images, labels, params, (s, s),
                                     fused=True)
    torch.cuda.synchronize()
    launches = dict(W.LAUNCHES)
    check(launches == {"warp_images": 0, "warp_labels": 1, "photometric": 0,
                       "warp_photo_images": 1},
          f"augment_batch_kernels(fused=True) launched {launches}")
    ui, ul = W.augment_batch_kernels(images, labels, params, (s, s))
    check(torch.equal(fl, ul), "fused and two-kernel labels differ")
    p_err, p_share, p_ok = one_step_ok(torch, fi, ui)
    check(p_ok, f"augment_batch_kernels fused=True vs False: max {p_err}, "
          f"{p_share:.3g} of elements differ")
    print(f"augment_batch_kernels fused=True vs False: labels equal, images "
          f"max {p_err:.3g}, {p_share:.3g} of elements differ")

    n_rot = int((params["angle"] != 0).sum())
    n_blur = int(params["blur"].sum())
    ms = cuda_ms(torch, lambda: W.warp_photo_images(x, full, s), 50)
    pair_ms = cuda_ms(torch, chain, 50)
    print(f"warp_photo_images {ms:.4f} ms vs K1 + K3 {pair_ms:.4f} ms on the "
          "same rows (one call)")
    return {"max_abs_err": err, "mismatch_share": share, "ms": ms,
            "k1_k3_ms": pair_ms, "chain_differing": n_diff,
            "plain_ms": cuda_ms(torch, lambda: W.warp_photo_images_reference(
                x, full, s), 5),
            "launches": launches["warp_photo_images"],
            "timed": f"({b},3,{s},{s}) uint8 NHWC view -> bf16, {n_rot} "
                     f"rotated, {n_blur} blurred",
            # K1's uint8 read and K3's bf16 write; the operations of both
            "bounds": (x.numel() + got.numel() * 2 + full.numel() * 4, ops)}


def device_busy_ms(prof, DeviceType):
    """Sum of the device-side events (kernels, copies) of a profile."""
    busy = 0.0
    for e in prof.key_averages():
        # user annotations (Optimizer.step#...) repeat their kernels' time
        if e.device_type != DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False) or \
                e.key.startswith("Activity Buffer"):
            continue
        us = getattr(e, "self_device_time_total", None)
        busy += (e.self_cuda_time_total if us is None else us) / 1e3
    return busy


def train_phase(torch, W, g, input_shape=(512, 512), n_train=32, n_val=12,
                timed_steps=8, device="cuda"):
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from cervical_tpu_torch.config import SegTrainConfig
    from cervical_tpu_torch.data.voc import ArraySegDataset, BatchLoader
    from cervical_tpu_torch.train.seg_trainer import SegTrainer

    cfg = SegTrainConfig()
    check((cfg.backbone, cfg.downsample_factor, cfg.data.num_classes,
           cfg.dtype, cfg.optimizer_type, cfg.init_lr, cfg.focal_loss,
           cfg.dice_loss, cfg.cls_weights, cfg.unfreeze_batch_size,
           cfg.freeze_batch_size) == ("xception", 16, 5, "bfloat16", "adam",
                                      1e-4, True, True, (1.0, 1.0, 5.0, 3.0,
                                                         4.0), 8, 16),
          "SegTrainConfig defaults")
    cfg.data.aug_backend = "pallas"
    cfg.data.input_shape = input_shape
    h, w = input_shape
    rng = np.random.default_rng(int(torch.randint(0, 2 ** 31, (1,),
                                                  generator=g)))
    train = ArraySegDataset(rng.integers(0, 256, (n_train, h, w, 3)),
                            rng.integers(0, 5, (n_train, h, w)))
    val = ArraySegDataset(rng.integers(0, 256, (n_val, h, w, 3)),
                          rng.integers(0, 5, (n_val, h, w)))
    trainer = SegTrainer(cfg, device=device)
    dev = trainer.device
    xb = torch.from_numpy(train.images[:cfg.unfreeze_batch_size]).to(dev)
    lb = torch.from_numpy(train.labels[:cfg.unfreeze_batch_size]).to(dev)
    lr = trainer.lr_schedule(cfg.unfreeze_batch_size, cfg.unfreeze_epoch)(0)
    trainer.train_step(xb, lb, False, lr)  # warm-up: cuDNN heuristics
    torch.cuda.synchronize()
    val_loader = BatchLoader(val, cfg.eval_batch_size, shuffle=False,
                             drop_last=False)
    res = {"config": f"xception os16 {h}x{w} 5 classes bf16 adam focal+dice"}

    epochs = []
    for frozen in (False, True):
        bs = cfg.freeze_batch_size if frozen else cfg.unfreeze_batch_size
        loader = BatchLoader(train, bs, seed=3 + frozen)
        model = trainer.state.model
        snap = {n: p.detach().clone()
                for n, p in model.backbone.named_parameters()}
        adam = {id(p): {k: v.clone() for k, v in st.items()} for p, st in
                trainer.state.opt_state["backbone"].state.items()}
        W.reset_launches()
        t0 = time.perf_counter()
        r = trainer.run_epoch(loader, val_loader, int(frozen), frozen, lr)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(W.LAUNCHES)
        steps = len(loader)
        print(f"run_epoch (frozen={frozen}, batch {bs}): {steps} steps + "
              f"eval of {n_val} images in {dt:.3f} s; loss "
              f"{r.train_loss:.5f} val {r.val_loss:.5f} f_score "
              f"{r.train_f_score:.4f}/{r.val_f_score:.4f}; launches {launches}")
        for name in TRAIN_KERNELS:
            check(launches[name] == steps, f"{name} launched "
                  f"{launches[name]} times in {steps} train steps")
        check(all(math.isfinite(v) for v in (r.train_loss, r.val_loss,
                                             r.train_f_score)),
              f"non-finite epoch metrics {r}")
        if frozen:
            same = all(torch.equal(p, snap[n])
                       for n, p in model.backbone.named_parameters())
            same_adam = all(
                torch.equal(v, adam[id(p)][k]) for p, st in
                trainer.state.opt_state["backbone"].state.items()
                for k, v in st.items())
            check(same and same_adam, "the frozen epoch moved the backbone's "
                  "params or its Adam state")
        epochs.append({"frozen": frozen, "batch": bs, "steps": steps,
                       "seconds": dt, "train_loss": r.train_loss,
                       "val_loss": r.val_loss, "launches": launches})
    res["epochs"] = epochs
    hist = trainer.evaluate_miou(val_loader)["hist"]
    check(int(hist.sum()) == n_val * h * w, f"eval confusion matrix counts "
          f"{int(hist.sum())} pixels, expected {n_val * h * w}")

    for _ in range(2):
        trainer.train_step(xb, lb, False, lr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        m = trainer.train_step(xb, lb, False, lr)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / timed_steps
    check(math.isfinite(m["loss"].item()), "non-finite train loss")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            trainer.train_step(xb, lb, False, lr)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy = device_busy_ms(prof, DeviceType) / timed_steps
    # the profiler's own host cost stretches its wall time, so the idle
    # share divides its device-busy time by the unprofiled step time; no
    # device events means the profiler could not trace the card
    idle = 1 - busy / step_ms if busy > 0 else None
    b = cfg.unfreeze_batch_size
    res.update({"step_ms": step_ms, "images_per_s": b * 1e3 / step_ms,
                "profiled_wall_ms_per_step": wall_ms / timed_steps,
                "device_busy_ms_per_step": busy,
                "idle_share": idle,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    print(f"train step (batch {b}, unfrozen, batch on the card): "
          f"{step_ms:.3f} ms/step = {b * 1e3 / step_ms:.1f} images/s; "
          f"profiled: {wall_ms / timed_steps:.3f} ms wall, "
          f"{busy:.3f} ms device busy per step; idle share "
          + ("not measured (no device events)" if idle is None
             else f"{idle:.4f}"))
    print("train " + json.dumps(res))


def fit_config(root, save_dir, input_shape, **kw):
    """The fit phase's config: the defaults (xception, os16, 5 classes,
    bf16, Adam) with the kernel augmentation, K4 in the eval passes, one
    frozen epoch of 3, a checkpoint every epoch, the mIoU passes at epoch
    2; ``kw`` overrides more.  Returned with the same settings as CLI
    overrides."""
    from cervical_tpu_torch.config import SegTrainConfig, load_config
    over = {"data": {"dataset_path": root, "input_shape": list(input_shape),
                     "aug_backend": "pallas"},
            "fused_middle_eval": True, "freeze_train": True,
            "freeze_epoch": 1, "unfreeze_epoch": 3, "save_period": 1,
            "eval_period": 2, "predictor_eval": True, "save_dir": save_dir,
            **kw}
    argv = []
    for k, v in over.items():
        for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)]):
            argv += [f"--{k}.{kk}" if kk else f"--{k}", json.dumps(vv)
                     if not isinstance(vv, str) else vv]
    return load_config(SegTrainConfig, None, over), argv


def fit_phase(torch, W, MF, input_shape=(512, 512), n_train=24, n_val=8,
              device="cuda"):
    """``SegTrainer.fit`` in this process, then the ``train_seg`` CLI in a
    subprocess stopped by SIGTERM, on a synthetic VOC written to a
    temporary directory.  Returns the fit run's launch counts."""
    import shutil
    import signal
    import tempfile
    import threading
    from cervical_tpu_torch.data.voc import (VOCSegDataset, make_synthetic_voc,
                                             read_split)
    from cervical_tpu_torch.train.checkpoints import CheckpointManager
    from cervical_tpu_torch.train.seg_trainer import SegTrainer, create_state

    h, w = input_shape
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    proc = None
    try:
        n = n_train + n_val
        root = make_synthetic_voc(os.path.join(tmp, "voc"), num_images=n,
                                  size=h, splits=(n_train / n, n_val / n, 0))
        cfg, _ = fit_config(root, os.path.join(tmp, "logs"), input_shape)
        train = VOCSegDataset(root, read_split(root, "train"), (h, w))
        val = VOCSegDataset(root, read_split(root, "val"), (h, w))
        check((len(train), len(val)) == (n_train, n_val), "synthetic VOC split")
        trainer = SegTrainer(cfg, device=device)
        ckpt = CheckpointManager(cfg.save_dir)
        steps = [n_train // cfg.freeze_batch_size] + \
            [n_train // cfg.unfreeze_batch_size] * (cfg.unfreeze_epoch - 1)
        epochs, marks = [], [time.perf_counter()]
        before = {}

        def log(msg):
            print(f"  fit: {msg}")
            if not msg.startswith("Epoch "):
                return
            e = len(epochs)
            now = {**W.LAUNCHES, **MF.LAUNCHES}
            marks.append(time.perf_counter())
            epochs.append({"epoch": e + 1, "seconds": marks[-1] - marks[-2],
                           "launches": {k: v - before.get(k, 0)
                                        for k, v in now.items()}})
            before.update(now)
            names = os.listdir(cfg.save_dir)
            check(any(f.startswith(f"ep{e + 1:03d}-") for f in names) and
                  {"best_epoch_weights", "last_epoch_weights"} <= set(names),
                  f"checkpoints after epoch {e + 1}: {sorted(names)}")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        W.reset_launches()
        MF.reset_launches()
        t0 = time.perf_counter()
        hist = trainer.fit(train, val, log=log)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {**W.LAUNCHES, **MF.LAUNCHES}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(len(epochs) == cfg.unfreeze_epoch, f"{len(epochs)} epochs ran")
        for e, n_steps in zip(epochs, steps):
            for name in TRAIN_KERNELS:
                check(e["launches"][name] == n_steps,
                      f"{name} launched {e['launches'][name]} times in "
                      f"epoch {e['epoch']}'s {n_steps} train steps")
        # K4 on every eval forward: one val batch per epoch, the mIoU pass
        # and the predictor pass at epoch 2
        forwards = cfg.unfreeze_epoch + 2
        for name in MF.LAUNCHES:
            check(launches[name] == 48 * forwards, f"{name} launched "
                  f"{launches[name]} times, expected {48 * forwards}")
        check(launches["warp_photo_images"] == 0, "fit launched K5")
        losses = hist["train_loss"] + hist["val_loss"]
        check(len(hist["train_loss"]) == cfg.unfreeze_epoch and
              all(math.isfinite(v) for v in losses), f"losses {losses}")
        check(sorted(hist) == ["miou", "predictor_miou", "train_loss",
                               "val_loss"], f"history keys {sorted(hist)}")

        def lines(name):
            with open(os.path.join(cfg.save_dir, name)) as f:
                return len(f.read().splitlines())
        for name, want in (("epoch_loss.txt", 3), ("epoch_val_loss.txt", 3),
                           ("epoch_miou.txt", 1),
                           ("epoch_miou_predictor.txt", 1)):
            check(lines(name) == want, f"{name}: {lines(name)} lines")
        check(os.path.getsize(os.path.join(cfg.save_dir,
                                           "model_graph.txt")) > 1000,
              "model_graph.txt")

        fresh = create_state(cfg, seed=cfg.seed + 100, device=device)
        fresh, extra = ckpt.restore("last_epoch_weights", fresh)
        mine = trainer.state
        theirs = fresh.model.state_dict()
        same_model = all(torch.equal(v, theirs[k]) for k, v
                         in mine.model.state_dict().items())

        def adam_equal(a, b):
            sa, sb = a.state_dict()["state"], b.state_dict()["state"]
            return sa.keys() == sb.keys() and all(
                torch.equal(torch.as_tensor(sa[i][k]), torch.as_tensor(
                    sb[i][k])) for i in sa for k in sa[i])
        same_adam = all(adam_equal(mine.opt_state[g], fresh.opt_state[g])
                        for g in ("backbone", "head"))
        check(same_model and same_adam and fresh.step == mine.step and
              extra["epoch"] == cfg.unfreeze_epoch - 1,
              f"restore: model {same_model}, Adam {same_adam}, step "
              f"{fresh.step}/{mine.step}, extra {extra}")
        del fresh
        res = {"seconds": fit_s, "peak_mem_gib": peak,
               "epochs": [{"epoch": e["epoch"], "seconds": e["seconds"],
                           "steps": s} for e, s in zip(epochs, steps)],
               "history": hist, "launches": launches}
        print(f"fit: {cfg.unfreeze_epoch} epochs in {fit_s:.2f} s ("
              + ", ".join(f"{e['seconds']:.2f}" for e in epochs)
              + f" s each), peak memory {peak:.2f} GiB; restored "
              "last_epoch_weights bit for bit")
        shutil.rmtree(cfg.save_dir)

        # the CLI, stopped by SIGTERM while epoch 2 runs: it finishes, is
        # checkpointed, and the process exits 0 (no mIoU passes: the run
        # above covered them).  The signal goes out 1 s after epoch 1's
        # line: the loop tests the stop flag just after printing that line,
        # so a signal sent at once can land before the test (the child
        # descheduled as its pipe write wakes this reader) and stop after
        # epoch 1, while epoch 2 takes seconds at 512².
        _, argv = fit_config(root, cfg.save_dir, input_shape, eval_period=10,
                             predictor_eval=False)
        cmd = [sys.executable, "-u", "-m", "cervical_tpu_torch.train_seg",
               "--device", device] + argv
        env = dict(os.environ, PYTHONPATH=HERE)
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=HERE, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        watchdog = threading.Timer(600, proc.kill)
        watchdog.start()
        out, sent = [], None
        for line in proc.stdout:
            out.append(line)
            if sent is None and line.startswith("Epoch 1/3"):
                time.sleep(1.0)
                proc.send_signal(signal.SIGTERM)
                sent = time.perf_counter() - t0
        rc = proc.wait()
        watchdog.cancel()
        text = "".join(out)
        cli_s = time.perf_counter() - t0
        check(rc == 0 and sent is not None and "stopped after epoch 2" in text
              and "Epoch 3/3" not in text,
              f"CLI exit {rc}, SIGTERM at {sent}; output tail:\n{text[-3000:]}")
        cli_extra = ckpt.restore("last_epoch_weights")["extra"]
        check(cli_extra["epoch"] == 1 and lines("epoch_loss.txt") == 2,
              f"CLI checkpoint {cli_extra}, "
              f"{lines('epoch_loss.txt')} loss lines")
        print(f"train_seg CLI: SIGTERM {sent:.1f} s after start, stopped after "
              f"epoch 2, exit 0, {cli_s:.1f} s in all; last_epoch_weights "
              f"holds epoch index {cli_extra['epoch']}")
        res["cli_seconds"] = cli_s
        res["cli_sigterm_at_s"] = sent
        print("fit " + json.dumps(res))
        return launches
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


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
    from cervical_tpu_torch.ops import augment as A
    from cervical_tpu_torch.ops import middle_flow as MF
    from cervical_tpu_torch.ops import warp as W

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
    seconds = {"build": build_s}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out
    records, k4 = timed("kernels", kernel_phase, torch, F, MF, dev,
                        torch.Generator().manual_seed(0))
    launches = timed("predictor", predictor_phase, torch, MF,
                     torch.Generator().manual_seed(1))
    warp = timed("warp", warp_phase, torch, W, A, dev,
                 torch.Generator().manual_seed(2))
    timed("train", train_phase, torch, W, torch.Generator().manual_seed(3))
    # the slice's main path: K1-K3 as launched by fit; K5 by
    # augment_batch_kernels(fused=True), its one caller (warp phase)
    path_launches = timed("fit", fit_phase, torch, W, MF)
    path_launches["warp_photo_images"] = warp["warp_photo_images"]["launches"]
    print("seconds per phase " + json.dumps(seconds))

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
    for name, r in warp.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "cervical_tpu_torch/csrc/warp.cu",
            "replaces": TPU_WARP[name], "launches": path_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "library": NO_LIBRARY, "timed_shape": r["timed"],
            **({"k1_k3_ms": r["k1_k3_ms"],
                "chain_differing": r["chain_differing"]}
               if "k1_k3_ms" in r else {})})
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
