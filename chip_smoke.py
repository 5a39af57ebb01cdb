#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, the torch and CUDA versions, and
   builds every kernel of the port from ``cervical_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together).
2. Holds each kernel against its plain PyTorch version at the shapes of the
   main path: the Xception middle flow at 512² input, batch 8, 16 blocks in
   bf16 — (8, 32, 32, 728) at dilation 1 (output stride 16) and
   (8, 64, 64, 728) at dilation 2 (output stride 8), block by block — and
   each of its two kernels alone: the stencil bit-exact, the product to
   1e-4.  Times the kernels, the plain versions and library yardsticks
   (``F.conv2d(groups=C)`` for the stencil; ``torch.mm(out_dtype=f32)``
   like for like for the product, and bf16-out ``torch.matmul``) with CUDA
   events, beside the least time the card could take (the larger of bytes
   over 3.35 TB/s and operations over 989 TFLOP/s bf16 tensor / 67 TFLOP/s
   fp32, H100 SXM data sheet).
2b. The same at ``compute_dtype=float32`` (TF32 off for cuBLAS and
   cuDNN): the f32 kernels ``mf_dw_stencil_f32`` (rows staged in shared
   memory by TMA; bit-exact at dilations 1 and 2) and ``mf_pw_gemm_f32``
   (3xTF32 on ``wgmma``: within 1e-6 x (|zb| @ |W|) + 1e-6 of
   ``torch.matmul`` in f32, and its largest error from an f64-accumulated
   product at most twice ``torch.mm``'s), the 16 f32 blocks one by one
   (1e-5 of the block output's largest magnitude) and whole (1e-4 of it),
   beside the plain version's own drift from an f64-accumulated plain
   version; times against ``torch.mm`` f32, ``F.conv2d(groups=C)`` f32 and
   the f32 cuDNN + cuBLAS chain, and bounds (the split product's three
   passes at 495 TFLOP/s TF32, the old FFMA bound at 67 TFLOP/s beside).
3. Drives the serving path: ``SegPredictor(fused_middle=True)`` at
   xception, os16, 512², 5 classes, bf16, seeded random weights,
   ``predict_masks`` on 16 synthetic 960x1280 images at batch 8.  The launch
   counts are zeroed just before and read just after: the stencil and the
   product launched 48 times each per forward.  The masks must agree with
   the unfused predictor on >= 99% of pixels.
3b. The f32 serving and eval paths (``predictor_f32``): an f32
   ``SegPredictor(fused_middle=True)`` and an unfused f32 one on the same
   weights and 16 images: 96 f32 launches per forward and no bf16 one,
   masks equal on >= 99.9% of pixels, ``predict_probs`` and
   ``predict_probs_tiled`` within 1e-4, forward images/s of both; then an
   f32 ``SegTrainer(fused_middle_eval=True)``'s ``evaluate_miou`` over 12
   512² images, host-fed and resident (a CUDA graph) equal, against an
   unfused f32 trainer (<= 0.1% of pixels in another cell).
4. Holds the augmentation kernels K1 ``warp_images`` (bf16 and uint8 out),
   K2 ``warp_labels``, K3 ``photometric`` (select/all/none, bf16 and
   uint8 in) and K5 ``warp_photo_images`` against their plain versions at
   batch 8, 512², on parameter rows sampled as the train step samples them
   (rotation on 2 images, blur on 2): K1, K2 and K3 bit-exact (K1 and K2
   also with none and all 8 of the rows rotated, at +-10 degrees, and
   timed at both; K3 timed in each blur mode; the counts of differing
   elements printed), K5 bit-exact against its plain version and the K1 ->
   K3 kernel chain at three mixes (none rotated or blurred, the step's,
   all 8 rotated at +-10 degrees and blurred), bf16 and f32 out.
   ``augment_batch_kernels(fused=True)``, K5's one caller, must equal
   ``fused=False``, with its launch counts zeroed before and read after.
   Times each kernel beside its plain version and its bound, and K5 beside
   K1 -> K3 at each of the three mixes.
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
6. Drives the training path on the JAX package's defaults
   (``defaults`` phase): ``SegTrainer`` on an unmodified ``SegTrainConfig()``
   (the einsum augmentation, ``steps_per_call=8``, batch 8 unfrozen and 16
   frozen, 512²) on 136 synthetic train and 16 val images: an unfrozen
   epoch (two 8-step calls replayed as CUDA graphs and one single step),
   a frozen one (one 8-step call); each batch runs once, the frozen epoch
   leaves the backbone's params and Adam state bit-identical.  The einsum
   augmentation at (8, 512, 512, 3) on the card against the CPU (labels
   equal, images within one bf16 step on <= 1e-3 of elements), timed
   beside ``augment_batch_kernels``.  8 replayed steps against 8 eager
   steps from a trainer of the same seed: losses and states bit for bit
   (else the JAX package's scan-test limits, with a second eager run to
   tell nondeterminism from a fault).  The kernel backend with
   ``aug_pre_batch``: one 8-step call against 8 per-step eager steps, bit
   for bit, K1-K3 counted once per call there and once per step here.  A
   resident ``"gather"`` epoch: each train image read once, the resident
   ``evaluate_miou`` matrix equal to the host-fed one and summing to 16 x
   512².  Readings beside the card's name and power limit: the 8-step
   graph call, the resident call, and the train phase's eager step:
   ms/step, images/s and the idle share.
7. Drives the fit path at the same width on a synthetic VOC of 24 train and
   8 val 512² images written to a temporary directory: ``SegTrainer.fit``
   with one frozen epoch of 3, a checkpoint every epoch, the eval step's
   and the predictor's mIoU at epoch 2 (K4 in the eval passes).  Counts are
   zeroed before and read after: K1-K3 once per train step of each epoch,
   K4's two kernels 48 times each per eval forward.  The three checkpoint
   kinds exist after each epoch, the callbacks' files have their lines,
   every loss is finite,
   and ``last_epoch_weights`` restores the model and both Adam states bit
   for bit into a fresh state.  Then ``python -m
   cervical_tpu_torch.train_seg`` on the same data, sent SIGTERM once
   epoch 1 is logged, must finish epoch 2, checkpoint it and exit 0.
   Prints seconds per epoch and the peak memory.
7b. Runs the reference segmentation protocol (``protocol`` phase, the
   JAX package's defaults: the einsum augmentation, no kernel): (a)
   ``run_seg_protocol.main`` in this process at its full 6,720 / 840
   synthetic 512² images, resident on the card, for one frozen epoch at
   batch 16 and one unfrozen at batch 8: finite losses, no kernel
   launched, each epoch's calls reading every train image once, 8-step
   calls captured at both batch sizes; prints the upload's GB and
   seconds, ``data_prep_s``, each epoch's train and val seconds, images/s
   and steady ms/step beside the SM clock and power draw
   (``nvidia-smi``), the card's peak memory and the host's resident set
   (sampled every 0.1 s, and ``getrusage``); then, on that trainer, the
   card memory each resident shuffle mode (gather, images, chunks, none)
   adds through its shuffle and one 8-step call, and the predictor
   callback's seconds over 840 JPEG/PNG pairs written to disk.  (b)
   ``python -m cervical_tpu_torch.run_seg_protocol`` at 64 / 16 512²
   images for 10 epochs (5 frozen), sent SIGTERM while epoch 6 runs:
   it must stop after epoch 6, checkpointed, and exit 0; then
   ``--resume`` runs epochs 7-10 and writes the epoch-10 mIoU and
   predictor-mIoU lines, ``ep010-*`` and ``protocol_summary.json``.
8. Drives the fusion classifier (``fusion`` phase) at
   ``FusionTrainConfig()``'s width (four modalities, in_features 1024,
   hidden 512, 4 classes, batch 8) on a synthetic 1,758-patient cohort
   drawn on the card (374 MB of features): ``FusionPredictor`` on the card
   against the same weights on the CPU (96 patients, some slots absent, to
   1e-4) and its patients/s at batch 512; 8 train steps replayed from the
   step's CUDA graph against 8 eager steps on a twin state, dropout on,
   bit for bit (losses, predictions, params, Adam state); ms/step and the
   idle share of both, and the graph step's top kernels; an epoch over the
   whole cohort; ``cross_validate`` stopped after folds 0 and 1 of 5, 3
   epochs each, whose fused train accuracy must exceed 0.7 (the JAX
   package's threshold, tests/test_fusion_training.py:83).  Then the
   vmapped-folds engine (``fusion_vmap``): (a) 4 stacked steps of 3 pairs
   replayed from their CUDA graphs against the same steps run eagerly, bit
   for bit, dropout on, epoch 0's no-step and a pair on a padding batch;
   (a2) 3 stacked pairs at that width against the sequential train step on
   each pair's own model, dropout shared, to the CPU tests' limits;
   (b) ``cross_validate(vmap_folds=True)`` against the sequential engine,
   2 pairs x 2 epochs at the CPU test's size and tolerances; (c) group
   widths 1, 5 and 25: the stacked step's ms per group step and per
   pair-step, idle share, and the engine cut to 3 epochs (pair-epochs/s,
   peak memory); (d) bf16: a sequential and a stacked step, graph against
   eager bit for bit, finite losses.  No kernel of the port runs here: the
   fusion path has none.
9. Drives the MobileNetV2 DeepLab (``mobilenet`` phase) at 512², os16, 5
   classes, bf16, seeded weights: ``SegPredictor.predict_masks`` on 16
   synthetic 960x1280 images at batch 8 against the same weights in f32
   (no argmax flip where the f32 top-2 gap exceeds twice the probs'
   drift, >= 99% of pixels equal), its batched images/s beside
   Xception's, a ``fused_middle=True`` predictor refused;
   ``SegTrainer(SegTrainConfig(backbone="mobilenet"))`` for an unfrozen
   and a frozen epoch on 136 / 16 synthetic images (each batch once, the
   frozen epoch leaving the backbone and its Adam state bit-identical),
   its 8-step graph call's ms/step and idle share, 8 replayed steps
   against 8 eager ones bit for bit; ``export_program`` at batch 1, the
   loaded ``.pt2`` within 1e-2 of the eager forward.  No kernel runs.
10. Drives the patch featurizer and the cohort builder (``featurize``
   phase): ``PatchFeaturizer(depth=101)`` at 256² patches on the card
   against the CPU (4 patches, relative 1e-3), its patches/s at 16 and
   128 and the seconds for the protocol's 84,384 patches; 24 synthetic
   patients x 3 modalities of 512² PNGs (one without ``imgL``) through
   the ``build_graphs`` CLI's folder walk, ``build_cli_features``,
   ``assemble_cohort`` and ``save_npz``; ``python -m
   cervical_tpu_torch.train_fusion`` on that cohort for 2 epochs (5
   folds, every loss finite) and ``predict_fusion`` on its best params;
   beside them ``python -m cervical_tpu_torch.eval_miou`` in dirs mode,
   its matrix summing to the pixel count.  No kernel runs.
11. Drives the data-preparation path (``prepare`` phase): (a) a synthetic
   VOC of 64 512² JPEG/PNG pairs decoded by the native loader
   (``cervical_tpu_torch.native``, built with ``g++`` at first use; its
   availability printed beside ``g++ --version``, and the phase fails if
   libjpeg's and libpng's headers are installed but it does not build)
   against PIL — labels equal, images within 3 counts mean, the planar
   batch equal to the NHWC one transposed —, both decoders' images/s at
   batch 16 beside the defaults phase's graph call, and
   ``augment_batch_kernels(planar=True)`` on the native planar batch (where
   the library is missing, PIL's made planar on the host) equal to the
   NHWC call bit for bit, K1-K3 launched once each; (b) ``python
   -m cervical_tpu_torch.prepare_dataset`` on 12 colour-coded 512² masks
   (colours to ids equal to the masks' ids, splits 8,1,1, the 8x
   augmentation, an audit with no warning), then an unfrozen
   ``run_epoch`` (``aug_backend="pallas"``) over its output read through
   ``VOCSegDataset(use_native=True)``: every batch decoded natively, K1-K3
   once per step, losses finite; (d) ``utils.profiling.trace`` around two
   train steps, the Chrome trace naming K1-K3, and its table of the
   program's spans (two ``seg.call.train``); (c) ``ops.histeq.fivefold_augment`` at
   (16, 512, 512, 3) on the card against the CPU (each slot's max
   difference and count printed, held to 1e-3), its images/s, and
   ``write_multimodal_augmented`` over 32 PNGs: 160 files.
12. Drives the parallel layouts (``parallel`` phase, last): (a) NCCL at
   world 1 — the 8-step seg graph call (xception 512², batch 8, the kernel
   augmentation) through the data-parallel path, bit for bit against the
   same call without a process group, K1-K3 counted, ms/step of both in
   turns; (b) two gloo ranks sharing the card (this script as two child
   processes): one eager data-parallel step in f32 on 4 of the 8 images
   each, the ranks' params equal and the step within a stated tolerance of
   the one-process eager step on the 8 — loss, Adam's first moments,
   update signs, running stats — (run twice, for the card's own spread),
   a ragged eval counting every pixel; (c) in the same children, two
   ``FusionTrainer.train_epoch`` epochs of one step over 8 patients at
   1,024 / 512 with the model split over both ranks, against the
   replicated epochs (loss rtol 1e-5, then 1e-3); (d) ``middle_flow_pipeline`` at (8, 728, 32, 32) bf16,
   16 blocks, 4 stages on 4 streams, 4 microbatches, equal to the
   sequential blocks per microbatch, both timed.
13. Prints the seconds per phase, one ``{"kernels": [...]}`` line (eight
   kernels: K4's two in bf16 and in f32, K1-K3, K5), then as the last line
   ``{"ok": true, "device": {...}}``.

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
PEAK_TF32 = 495e12        # dense TF32 tensor-core FLOP/s
SPIN_CYCLES_PER_MS = 1.98e6  # torch.cuda._sleep cycles, at the top SM clock
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


def cuda_ms(torch, fn, iters, warmup=2, queued=True):
    """Mean ms per call of ``fn`` over ``iters`` calls, CUDA events, after
    ``warmup`` calls.  ``queued``: the timed calls wait behind a spin of
    the card that outlasts their host time (twice the warm-up's), so the
    events time the card's work and not the gaps where it waited for the
    host (a wrapper's Python and ctypes cost ~20-50 µs per call, as long
    as a middle-flow kernel); not queued, host gaps count, as a caller
    sees them."""
    t = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t) / warmup
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        spin_ms = min(5.0 + 2.0 * host_ms * iters, 2000.0)
        torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, bf16_ops=0.0, fp32_ops=0.0, tf32_ops=0.0):
    t_bytes = nbytes / PEAK_BYTES
    t_ops = (bf16_ops / PEAK_BF16 + fp32_ops / PEAK_FP32
             + tf32_ops / PEAK_TF32)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def random_folded(torch, g, nblk, c, device, dtype=None):
    """Folded middle-flow weights scaled as tests/test_pallas_xception.py;
    taps and pointwise weights in ``dtype`` (the compute type, bf16 by
    default)."""
    dtype = dtype or torch.bfloat16

    def n(*s):
        return torch.randn(*s, generator=g)
    f = {"wdw": (n(nblk, 27, c) * 0.2).to(dtype),
         "s1": torch.rand(nblk, 3, c, generator=g) + 0.5,
         "c1": n(nblk, 3, c) * 0.1,
         "wpw": (n(nblk, 3, c, c) * (1.5 / c ** 0.5)).to(dtype),
         "c2": n(nblk, 3, c) * 0.1}
    f["wpw_t"] = f["wpw"].transpose(-1, -2)  # K-major, as fold_middle_flow
    if dtype == torch.float32:  # the f32 product's TF32 parts, as the fold
        from cervical_tpu_torch.ops.middle_flow import tf32_split
        f["wpw_t_split"] = torch.stack(tf32_split(f["wpw_t"]), 2)
    return {k: v.to(device).contiguous() for k, v in f.items()}


def gemm_f64(zb, w, c2, skip_src=None):
    """``pw_gemm_reference`` with the product accumulated in f64: the
    yardstick of the plain version's own drift."""
    z = ((zb.double() @ w.double()) + c2).float()
    return z if skip_src is None else \
        (z + skip_src.float().clamp_min(0)).to(skip_src.dtype)


def library_middle_flow(torch, F, folded, dilation):
    """Yardstick the port never calls: per separable conv one
    ``F.conv2d(groups=C)`` and one ``torch.matmul`` in the fold's compute
    type (cuDNN and cuBLAS), elementwise ops between them."""
    nblk, _, c = folded["wdw"].shape
    bf = folded["wdw"].dtype
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
    # as a caller sees it: 96 wrapper calls, host gaps included
    k4["host_gaps_ms"] = cuda_ms(
        torch, lambda: MF.middle_flow_eval(x, folded, 1), 20, queued=False)
    k4["plain_ms"] = cuda_ms(torch, lambda: MF.middle_flow_reference(x, folded, 1), 5)
    k4["library_ms"] = cuda_ms(torch, lambda: lib(x), 20)
    wbytes = sum(v.numel() * v.element_size() for n, v in folded.items()
                 if n != "wpw_t")
    k4["bound_ms"], k4["bound_by"] = bound_ms(
        2 * x.numel() * 2 + wbytes, bf16_ops=2.0 * m * c * c * 3 * nblk,
        fp32_ops=20.0 * m * c * 3 * nblk)

    # each kernel alone, at the shapes the main path gives it
    wdw9, s1, c1 = folded["wdw"][0, :9], folded["s1"][0, 0], folded["c1"][0, 0]
    wpw, c2 = folded["wpw"][0, 0], folded["c2"][0, 0]
    wpw_t = folded["wpw_t"][0, 0]
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
            # same f32 ops in the same order, no FMA: bit-exact
            check(torch.equal(got, ref),
                  f"dw_stencil disagrees ({z.dtype}, dilation {d})")
            errs.append((got.float() - ref.float()).abs().max().item())
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
    st["timed_shape"] = f"({b},{h},{w},{c}) f32 in, bf16 out, dilation 1 " \
        f"(ms_os8: ({b},{2 * h},{2 * w},{c}), dilation 2)"
    zo = torch.randn(b, 2 * h, 2 * w, c, generator=g).to(dev)
    st["ms_os8"] = cuda_ms(torch, lambda: MF.dw_stencil(zo, wdw9, s1, c1, 2), 20)

    gm = {"name": "middle_flow.pw_gemm", "source": "csrc/middle_flow.cu",
          "function": "mf_pw_gemm"}
    got = MF.pw_gemm(zb, wpw_t, c2)
    torch.cuda.synchronize()
    ref = MF.pw_gemm_reference(zb, wpw, c2)
    e1 = (got - ref).abs()
    # f32 sums of 728 exact bf16 products in another order: ~1e-6 relative
    check(bool((e1 <= 1e-4 + 1e-4 * ref.abs()).all()), "pw_gemm disagrees")
    got = MF.pw_gemm(zb, wpw_t, c2, skip_src=x)
    torch.cuda.synchronize()
    ref = MF.pw_gemm_reference(zb, wpw, c2, skip_src=x)
    e2 = (got.float() - ref.float()).abs()
    # bf16 output: the same sums rounded once (one bf16 step, 2^-7
    # relative), plus the f32 sum's own error where the skip cancels it
    check(bool((e2 <= 2.0 ** -7 * ref.float().abs() + 1e-4).all()),
          "pw_gemm (final, bf16 out) disagrees")
    gm["max_abs_err"] = max(e1.max().item(), e2.max().item())
    gm["ms"] = cuda_ms(torch, lambda: MF.pw_gemm(zb, wpw_t, c2), 50)
    gm["plain_ms"] = cuda_ms(torch, lambda: MF.pw_gemm_reference(zb, wpw, c2), 20)
    a2 = zb.view(m, c)
    # like for like: bf16 in, f32 out (aten::mm.dtype), shift not included
    gm["library_ms"] = cuda_ms(torch, lambda: torch.mm(
        a2, wpw, out_dtype=torch.float32), 50)
    gm["library"] = "torch.mm(out_dtype=torch.float32) (cuBLAS), bf16 in, " \
        "f32 out, shift not included"
    gm["library_bf16_out_ms"] = cuda_ms(torch, lambda: torch.matmul(a2, wpw), 50)
    gm["library_bf16_out"] = "torch.matmul bf16 out (cuBLAS): writes " \
        f"{m * c * 2} bytes where the kernel writes {m * c * 4}"
    gm["bound_ms"], gm["bound_by"] = bound_ms(
        zb.numel() * 2 + wpw.numel() * 2 + c * 4 + m * c * 4,
        bf16_ops=2.0 * m * c * c)
    gm["timed_shape"] = f"M={m} K=N={c}, f32 out"
    for r in (st, gm):
        r["kernel_ms"] = r["ms"]
        print(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
              f"library {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"by {r['bound_by']}), max_abs_err {r['max_abs_err']:.3g}")
    print(f"pw_gemm vs torch.matmul bf16 out: {gm['library_bf16_out_ms']:.4f}"
          f" ms; dw_stencil at os8 (dilation 2): {st['ms_os8']:.4f} ms")
    print(f"K4 middle_flow_eval {k4['shape']} x {nblk} blocks: "
          f"{k4['ms']:.4f} ms ({k4['host_gaps_ms']:.4f} with host gaps; "
          f"plain {k4['plain_ms']:.4f}, library "
          f"{k4['library_ms']:.4f}, bound {k4['bound_ms']:.4f} by "
          f"{k4['bound_by']})")
    return [st, gm], k4


# of |zb| @ |W|: K 2^-24 = 4.3e-5 is the worst case of a sum-order
# difference and ~2^-24 of it the expected one; the 3xTF32 kernel adds
# ~2^-22 per term from its split, random in sign, and each k-tile's
# truncated tensor-core sums (PERF.md; tests/test_torch_port_tf32_split.py
# models them: ~2e-7)
F32_GEMM_RTOL = 1e-6
F32_BLOCK_RTOL = 1e-5  # of a block output's largest magnitude
F32_CHAIN_RTOL = 1e-4  # of the 16-block chain's


def f32_gemm_ratio(got, ref, zb, w, skip=None):
    """The f32 product's error over its bound's scale: max of |got - ref| /
    (|zb| @ |W| + 1e-6 / F32_GEMM_RTOL [+ 2^-24 |ref| / F32_GEMM_RTOL where
    the skip is added after the sum]); within the bound when <= F32_GEMM_RTOL.
    Both sides sum K products in f32, each in its own order."""
    m, k = zb.numel() // zb.shape[-1], zb.shape[-1]
    scale = (zb.abs().reshape(m, k) @ w.abs()).view(ref.shape) \
        + 1e-6 / F32_GEMM_RTOL
    if skip is not None:
        scale = scale + 2.0 ** -24 * ref.abs() / F32_GEMM_RTOL
    return ((got - ref).abs() / scale).max().item()


def kernel_phase_f32(torch, F, MF, dev, g, shape=(8, 32, 32, 728, 16)):
    """K4 at compute_dtype=float32 (``mf_dw_stencil_f32``,
    ``mf_pw_gemm_f32``) against the plain version at the main path's
    shape, with TF32 off for cuBLAS and cuDNN; times and bounds.  Returns
    (per-kernel records, whole-K4 record)."""
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32,
          "TF32 must be off: the f32 references are full f32")
    f32 = torch.float32
    b, h, w, c, nblk = shape
    m = b * h * w
    folded = random_folded(torch, g, nblk, c, dev, f32)
    x = torch.randn(b, h, w, c, generator=g).to(dev)
    x_os8 = torch.randn(b, 2 * h, 2 * w, c, generator=g).to(dev)
    k4 = {"name": "middle_flow_eval_f32", "shape": [b, h, w, c],
          "blocks": nblk, "launches_per_forward": 6 * nblk}
    for d, xin in ((1, x), (2, x_os8)):
        # each block against the plain version on the same input: nothing
        # rounds between the ops, the stencils are bit-exact, and the
        # products differ from cuBLAS's by their sum order
        xk, errs = xin, []
        MF.reset_launches()
        for k in range(nblk):
            part = {n: v[k:k + 1] for n, v in folded.items()}
            out = MF.middle_flow_eval(xk, part, d)
            torch.cuda.synchronize()
            ref = MF.middle_flow_reference(xk, part, d)
            check(out.dtype == f32 and torch.isfinite(out).all().item(),
                  f"K4 f32 block {k} output not finite f32")
            errs.append((out - ref).abs().max().item()
                        / ref.abs().max().item())
            xk = out
        per = {"dw_stencil": 3 * nblk, "pw_gemm": 3 * nblk}
        check(dict(MF.LAUNCHES) == dict(MF.F32_LAUNCHES) == per,
              f"K4 f32 blocks launched {MF.LAUNCHES} ({MF.F32_LAUNCHES} "
              f"f32), expected {per} f32")
        chained = MF.middle_flow_eval(xin, folded, d)
        check(torch.equal(chained, xk), "the f32 16-block call differs from "
              "the blocks run one by one")
        print(f"K4 f32 dilation {d} {tuple(xin.shape)}, per block: max abs "
              f"err / max |out| {max(errs):.4g} (limit {F32_BLOCK_RTOL:g})")
        check(max(errs) <= F32_BLOCK_RTOL, f"K4 f32 disagrees with its plain "
              f"version at dilation {d}: {max(errs):.4g}")
        k4[f"max_rel_err_block_d{d}"] = max(errs)
        ref = MF.middle_flow_reference(xin, folded, d)
        ref64 = MF._middle_flow(xin, folded, d, MF.dw_stencil_reference,
                                gemm_f64)
        scale = ref.abs().max().item()
        for name, got, want in (("kernel vs plain", chained, ref),
                                ("plain vs f64-accumulated plain", ref,
                                 ref64)):
            e = (got - want).abs().max().item()
            k4[f"chain_d{d}_{name}"] = {"max_abs_err": e,
                                        "over_max_abs_out": e / scale}
            print(f"K4 f32 dilation {d}, 16-block chain, {name}: max abs "
                  f"{e:.4g} (max |ref| {scale:.4g}, ratio {e / scale:.3g})")
        e = k4[f"chain_d{d}_kernel vs plain"]["over_max_abs_out"]
        check(e <= F32_CHAIN_RTOL, f"the f32 16-block chain is {e:.3g} of "
              f"max |out| from the plain version (limit {F32_CHAIN_RTOL})")
        k4[f"max_abs_err_d{d}"] = k4[f"chain_d{d}_kernel vs plain"][
            "max_abs_err"]
    k4["max_abs_err"] = max(k4["max_abs_err_d1"], k4["max_abs_err_d2"])

    lib = library_middle_flow(torch, F, folded, 1)
    k4["ms"] = cuda_ms(torch, lambda: MF.middle_flow_eval(x, folded, 1), 10)
    k4["host_gaps_ms"] = cuda_ms(
        torch, lambda: MF.middle_flow_eval(x, folded, 1), 10, queued=False)
    k4["plain_ms"] = cuda_ms(
        torch, lambda: MF.middle_flow_reference(x, folded, 1), 3)
    k4["library_ms"] = cuda_ms(torch, lambda: lib(x), 10)
    k4["library"] = "F.conv2d(groups=C) + torch.matmul per separable conv, " \
        "f32 (cuDNN + cuBLAS, TF32 off), elementwise ops between"
    wbytes = sum(v.numel() * v.element_size() for n, v in folded.items()
                 if n not in ("wpw_t", "wpw_t_split"))
    # the products' three TF32 passes on the tensor cores, the stencils'
    # f32 operations outside them
    k4["bound_ms"], k4["bound_by"] = bound_ms(
        2 * x.numel() * 4 + wbytes, tf32_ops=3 * 2.0 * m * c * c * 3 * nblk,
        fp32_ops=20.0 * m * c * 3 * nblk)
    k4["bound_fp32_ffma_ms"] = bound_ms(
        2 * x.numel() * 4 + wbytes,
        fp32_ops=(2.0 * c + 20.0) * m * c * 3 * nblk)[0]

    # each kernel alone, at the shapes the main path gives it
    wdw9, s1, c1 = folded["wdw"][0, :9], folded["s1"][0, 0], folded["c1"][0, 0]
    wpw, c2 = folded["wpw"][0, 0], folded["c2"][0, 0]
    wpw_s = folded["wpw_t_split"][0, 0]
    zf = torch.randn(b, h, w, c, generator=g).to(dev)
    zo = torch.randn(b, 2 * h, 2 * w, c, generator=g).to(dev)
    st = {"name": "middle_flow.dw_stencil_f32",
          "source": "csrc/middle_flow.cu", "function": "mf_dw_stencil_f32",
          "wrapper": "dw_stencil"}
    errs = []
    for d, z in ((1, zf), (2, zf), (2, zo)):
        got = MF.dw_stencil(z, wdw9, s1, c1, d, f32)
        torch.cuda.synchronize()
        ref = MF.dw_stencil_reference(z, wdw9, s1, c1, d, f32)
        # same f32 ops in the same order, no FMA, no rounding: bit-exact
        check(torch.equal(got, ref),
              f"dw_stencil f32 disagrees (dilation {d}, {tuple(z.shape)})")
        errs.append((got - ref).abs().max().item())
    st["max_abs_err"] = max(errs)
    st["ms"] = cuda_ms(torch, lambda: MF.dw_stencil(zf, wdw9, s1, c1, 1, f32),
                       50)
    st["plain_ms"] = cuda_ms(torch, lambda: MF.dw_stencil_reference(
        zf, wdw9, s1, c1, 1, f32), 20)
    zr = torch.relu(zf).permute(0, 3, 1, 2)
    wconv = (wdw9 * s1).t().reshape(c, 1, 3, 3)
    st["library_ms"] = cuda_ms(torch, lambda: F.conv2d(
        zr, wconv, padding=1, groups=c), 50)
    st["library"] = "F.conv2d(groups=C), f32 (cuDNN, TF32 off), BN scale " \
        "folded into taps"
    st["bound_ms"], st["bound_by"] = bound_ms(
        zf.numel() * 4 * 2 + 9 * c * 4 + 2 * c * 4, fp32_ops=20.0 * m * c)
    st["timed_shape"] = f"({b},{h},{w},{c}) f32 in, f32 out, dilation 1 " \
        f"(ms_os8: ({b},{2 * h},{2 * w},{c}), dilation 2)"
    st["ms_os8"] = cuda_ms(torch, lambda: MF.dw_stencil(zo, wdw9, s1, c1, 2,
                                                        f32), 20)

    gm = {"name": "middle_flow.pw_gemm_f32", "source": "csrc/middle_flow.cu",
          "function": "mf_pw_gemm_f32", "wrapper": "pw_gemm"}
    zb = torch.randn(b, h, w, c, generator=g).to(dev)
    got = MF.pw_gemm(zb, wpw_s, c2)
    torch.cuda.synchronize()
    ref = MF.pw_gemm_reference(zb, wpw, c2)
    r1 = f32_gemm_ratio(got, ref, zb, wpw)
    e1 = (got - ref).abs().max().item()
    # against an f64-accumulated product: the kernel's largest error, at
    # most twice torch.mm's own (TF32 off)
    exact = (zb.double().reshape(m, c) @ wpw.double()).view(got.shape) \
        + c2.double()
    e64 = (got.double() - exact).abs().max().item()
    e64_mm = (ref.double() - exact).abs().max().item()
    got = MF.pw_gemm(zb, wpw_s, c2, skip_src=x)
    torch.cuda.synchronize()
    ref = MF.pw_gemm_reference(zb, wpw, c2, skip_src=x)
    check(got.dtype == f32, f"pw_gemm f32 (final) returned {got.dtype}")
    r2 = f32_gemm_ratio(got, ref, zb, wpw, skip=x)
    e2 = (got - ref).abs().max().item()
    print(f"pw_gemm f32 vs torch.matmul (TF32 off): max |err| / (|zb| @ |W|"
          f" + ...) {r1:.4g} (final, skip added: {r2:.4g}); limit "
          f"{F32_GEMM_RTOL:g}; max |err| from an f64-accumulated product "
          f"{e64:.4g} against torch.mm's {e64_mm:.4g} (limit 2x)")
    check(max(r1, r2) <= F32_GEMM_RTOL, "pw_gemm f32 disagrees: "
          f"{max(r1, r2):.4g} of |zb| @ |W|")
    check(e64 <= 2 * e64_mm, f"pw_gemm f32 is {e64:.4g} from an f64 "
          f"product, more than twice torch.mm's {e64_mm:.4g}")
    gm["max_abs_err"] = max(e1, e2)
    gm["max_err_over_abs_product"] = max(r1, r2)
    gm["max_abs_err_f64"] = e64
    gm["torch_mm_max_abs_err_f64"] = e64_mm
    gm["ms"] = cuda_ms(torch, lambda: MF.pw_gemm(zb, wpw_s, c2), 20)
    gm["plain_ms"] = cuda_ms(torch, lambda: MF.pw_gemm_reference(zb, wpw, c2),
                             20)
    a2 = zb.view(m, c)
    gm["library_ms"] = cuda_ms(torch, lambda: torch.mm(a2, wpw), 20)
    gm["library"] = "torch.mm f32 (cuBLAS SGEMM, TF32 off), shift not " \
        "included"
    gm_bytes = zb.numel() * 4 + wpw.numel() * 4 + c * 4 + m * c * 4
    # three TF32 passes on the tensor cores; one f32 FFMA product beside
    gm["bound_ms"], gm["bound_by"] = bound_ms(
        gm_bytes, tf32_ops=3 * 2.0 * m * c * c)
    gm["bound_fp32_ffma_ms"] = bound_ms(gm_bytes,
                                        fp32_ops=2.0 * m * c * c)[0]
    gm["ms_os8"] = cuda_ms(torch, lambda: MF.pw_gemm(zo, wpw_s, c2), 10)
    gm["timed_shape"] = f"M={m} K=N={c}, f32 in and out"
    for r in (st, gm):
        r["kernel_ms"] = r["ms"]
        print(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
              f"library {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"by {r['bound_by']}), max_abs_err {r['max_abs_err']:.3g}")
    print(f"dw_stencil f32 at os8 (dilation 2): {st['ms_os8']:.4f} ms; "
          f"pw_gemm f32 at os8 (M {4 * m}): {gm['ms_os8']:.4f} ms; bound of "
          f"one FFMA product {gm['bound_fp32_ffma_ms']:.4f} ms, of K4 f32 "
          f"by FFMA {k4['bound_fp32_ffma_ms']:.4f} ms")
    print(f"K4 f32 middle_flow_eval {k4['shape']} x {nblk} blocks: "
          f"{k4['ms']:.4f} ms ({k4['host_gaps_ms']:.4f} with host gaps; "
          f"plain {k4['plain_ms']:.4f}, library "
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
            # Xception's and MobileNetV2's (an expanding block's
            # projection) closing BatchNorms
            loc = 0.1 if "sepconv3.bn2" in k or ".conv.7." in k else 1.0
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
    want = {"dw_stencil": per_forward * forwards,
            "pw_gemm": per_forward * forwards}
    check(launches == want, f"the main path launched {launches}, expected "
          f"{want}")

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
    return launches, res


def predictor_f32_phase(torch, MF, g, input_shape=(512, 512),
                        image_hw=(960, 1280), n_val=12, device="cuda"):
    """The f32 serving and eval paths with the fused middle flow: an f32
    ``SegPredictor(fused_middle=True)`` against an unfused f32 one on the
    same weights and images (``predict_masks``, ``predict_probs``,
    ``predict_probs_tiled``, ``get_throughput``), then an f32 ``SegTrainer``
    with ``fused_middle_eval=True``: ``evaluate_miou`` host-fed and
    resident (a CUDA graph) against an unfused f32 trainer.  The counts are
    zeroed before each run and read after: every forward runs the f32
    kernels, 48 launches of each, and no other."""
    from cervical_tpu_torch.config import SegTrainConfig
    from cervical_tpu_torch.data.resident import ResidentSegData
    from cervical_tpu_torch.data.voc import ArraySegDataset, BatchLoader
    from cervical_tpu_torch.inference.predictor import SegPredictor
    from cervical_tpu_torch.train.seg_trainer import SegTrainer, build_model

    cfg = dataclass_replace(SegTrainConfig(), dtype="float32",
                            input_shape=tuple(input_shape))
    state = random_state(torch, build_model(cfg), g)
    fused = SegPredictor(cfg, state, fused_middle=True, device=device)
    plain = SegPredictor(cfg, state, device=device)
    n, batch = 16, 8
    images = torch.randint(0, 256, (n,) + tuple(image_hw) + (3,), generator=g,
                           dtype=torch.uint8).numpy()
    fused.predict_masks(images[:batch], batch)  # warm-up
    torch.cuda.synchronize()

    def counted(fn, forwards, what):
        MF.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        want = {"dw_stencil": 48 * forwards, "pw_gemm": 48 * forwards}
        got = (dict(MF.LAUNCHES), dict(MF.F32_LAUNCHES))
        check(got == (want, want), f"{what} launched {got[0]} ({got[1]} "
              f"f32), expected {want}, all f32")
        return out, got[1]

    t0 = time.perf_counter()
    masks, launches = counted(lambda: fused.predict_masks(images, batch),
                              -(-n // batch), "f32 predict_masks")
    dt = time.perf_counter() - t0
    ref = plain.predict_masks(images, batch)
    agree = float((masks == ref).mean())
    probs, _ = counted(lambda: fused.predict_probs(images[0]), 1,
                       "f32 predict_probs")
    pdiff = float(abs(probs - plain.predict_probs(images[0])).max())
    tiled, _ = counted(lambda: fused.predict_probs_tiled(images[0],
                                                         batch_size=batch),
                       2, "f32 predict_probs_tiled")  # 9 tiles: 2 batches
    tdiff = float(abs(tiled - plain.predict_probs_tiled(
        images[0], batch_size=batch)).max())
    print(f"f32 predict_masks: {n} images {image_hw} at batch {batch} in "
          f"{dt:.3f} s = {n / dt:.2f} images/s; f32 launches {launches}; "
          f"masks agree with the unfused f32 predictor on {agree:.6f} of "
          f"pixels; probs max abs diff {pdiff:.4g}, tiled {tdiff:.4g}")
    check(agree >= 0.999, f"f32 fused/unfused masks agree on only {agree}")
    check(max(pdiff, tdiff) <= 1e-4, f"f32 fused/unfused probs differ by "
          f"{max(pdiff, tdiff):.4g}")
    res = {"config": f"xception os16 {input_shape[0]}x{input_shape[1]} 5 "
                     "classes float32, TF32 off",
           "predict_masks_img_s": n / dt, "launches_f32": launches,
           "mask_agreement": agree, "probs_max_abs_diff": pdiff,
           "tiled_probs_max_abs_diff": tdiff,
           "throughput_fused_img_s": fused.get_throughput(batch),
           "throughput_unfused_img_s": plain.get_throughput(batch)}
    del fused, plain

    rng = torch.Generator().manual_seed(16)
    h, w = input_shape
    imgs = torch.randint(0, 256, (n_val, h, w, 3), generator=rng,
                         dtype=torch.uint8).numpy()
    lbls = torch.randint(0, 5, (n_val, h, w), generator=rng,
                         dtype=torch.uint8).numpy()
    hists = {}
    for fused_eval in (True, False):
        tr = SegTrainer(dataclass_replace(cfg, fused_middle_eval=fused_eval),
                        device=device)
        tr.state.model.load_state_dict(state)
        loader = BatchLoader(ArraySegDataset(imgs, lbls), batch,
                             shuffle=False, drop_last=False)
        forwards = -(-n_val // batch)
        if fused_eval:
            host, _ = counted(lambda: tr.evaluate_miou(loader), forwards,
                              "f32 fused evaluate_miou")
            resident = ResidentSegData.from_arrays(imgs, lbls, batch, device,
                                                   train=False)
            # the resident eval is a CUDA graph: replays count the capture's
            rs, _ = counted(lambda: tr.evaluate_miou(resident), forwards,
                            "f32 fused resident evaluate_miou")
            check((rs["hist"] == host["hist"]).all(), "the resident f32 "
                  "fused confusion matrix differs from the host-fed one")
            hists["fused"] = host["hist"]
        else:
            hists["unfused"] = tr.evaluate_miou(loader)["hist"]
        del tr
    diff = int(abs(hists["fused"] - hists["unfused"]).sum()) // 2
    total = int(hists["fused"].sum())
    print(f"f32 SegTrainer(fused_middle_eval=True).evaluate_miou: host = "
          f"resident; {diff} of {total} pixels counted in another cell than "
          "the unfused f32 trainer's")
    check(total == n_val * h * w, f"f32 eval counted {total} pixels")
    check(diff <= 1e-3 * total, f"f32 fused eval moved {diff} pixels")
    res["eval_pixels_moved"] = diff
    print("predictor_f32 " + json.dumps(res))
    return launches, res


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

    # K1 at the train step's mix and at none / all 8 rotated (+-10 deg) on
    # the same rows: the same f32 operations as the plain version, equal
    # bit for bit
    mixes = {"": wp}
    for mix, angle in (("none_rotated", [0.0] * b),
                       ("all_rotated", [10.0, -10.0] * (b // 2))):
        mixes[mix] = W.make_warp_params(
            dict(params, angle=torch.tensor(angle)), (s, s), (s, s)).to(dev)
    errs, shares = [], []
    for mix, rows in mixes.items():
        for out_dtype in (torch.bfloat16, torch.uint8):
            got = W.warp_images(x, rows, s, out_dtype)
            torch.cuda.synchronize()
            ref = W.warp_images_reference(x, rows, s, out_dtype)
            err, share, _ = one_step_ok(torch, got, ref)
            check(torch.equal(got, ref), f"warp_images ({out_dtype}, "
                  f"{mix or 'main path mix'}) differs from its plain version: "
                  f"max {err}, {share:.3g} of elements differ")
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
        **{f"ms_{mix}": cuda_ms(torch, lambda: W.warp_images(x, rows, s), 50)
           for mix, rows in mixes.items() if mix},
        "plain_ms": cuda_ms(torch, lambda: W.warp_images_reference(x, wp, s), 5),
        "timed": f"({b},3,{s},{s}) uint8 NHWC view -> bf16, {n_rot} rotated "
                 "(ms_none_rotated, ms_all_rotated: 0 and 8 at +-10 deg)",
        "bounds": (images.numel() + px * 3 * 2 + wp.numel() * 4, k1_ops)}

    # K2 at the same three mixes: exact
    k2_diff = {}
    for mix, rows in mixes.items():
        got = W.warp_labels(labels, rows, s)
        torch.cuda.synchronize()
        ref = W.warp_labels_reference(labels, rows, s)
        k2_diff[mix or "main"] = int((got != ref).sum())
        check(torch.equal(got, ref), "warp_labels disagrees with its plain "
              f"version ({mix or 'main path mix'}) on {k2_diff[mix or 'main']}"
              " pixels")
    # one nearest resample (a gather and its in-bounds select, 2 ops) per
    # pixel; a rotated pixel adds 3 shear shifts (index, validity: 4 each)
    k2_ops = s * s * (b * 2 + n_rot * 3 * 4)
    recs["warp_labels"] = {
        "max_abs_err": 0.0, "mismatch_share": 0.0, "differing": k2_diff,
        "ms": cuda_ms(torch, lambda: W.warp_labels(labels, wp, s), 50),
        **{f"ms_{mix}": cuda_ms(torch, lambda: W.warp_labels(labels, rows, s),
                                50)
           for mix, rows in mixes.items() if mix},
        "plain_ms": cuda_ms(torch, lambda: W.warp_labels_reference(
            labels, wp, s), 5),
        "timed": f"({b},{s},{s}) uint8, {n_rot} rotated (ms_none_rotated, "
                 "ms_all_rotated: 0 and 8 at +-10 deg)",
        "bounds": (2 * px + wp.numel() * 4, k2_ops)}

    # K3 in each blur mode on K1's bf16 and uint8 outputs: the same f32
    # operations as the plain version, equal bit for bit
    warped = W.warp_images(x, wp, s)
    warped_u8 = W.warp_images(x, wp, s, torch.uint8)
    k3_diff = {}
    for inp in (warped, warped_u8):
        for mode in W.BLUR_MODES:
            got = W.photometric(inp, gains, flags, blur_mode=mode)
            torch.cuda.synchronize()
            ref = W.photometric_reference(inp, gains, flags, blur_mode=mode)
            key = f"{str(inp.dtype).split('.')[-1]}_{mode}"
            k3_diff[key] = int((got != ref).sum())
            err, share, _ = one_step_ok(torch, got, ref)
            check(torch.equal(got, ref), f"photometric ({inp.dtype}, {mode}) "
                  f"differs from its plain version on {k3_diff[key]} "
                  f"elements: max {err}")
    # ~40 f32 ops of HSV per pixel, plus 2 x 8 per channel where it blurs
    k3_ops = s * s * (b * 40 + n_blur * 48)
    recs["photometric"] = {
        "max_abs_err": 0.0, "mismatch_share": 0.0, "differing": k3_diff,
        "ms": cuda_ms(torch, lambda: W.photometric(warped, gains, flags), 50),
        **{f"ms_blur_{mode}": cuda_ms(torch, lambda: W.photometric(
            warped, gains, flags, blur_mode=mode), 50)
           for mode in ("all", "none")},
        "plain_ms": cuda_ms(torch, lambda: W.photometric_reference(
            warped, gains, flags), 5),
        "timed": f"({b},3,{s},{s}) bf16 -> bf16, select, {n_blur} blurred "
                 f"(ms_blur_all, ms_blur_none: all {b}, none)",
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
    for name in ("warp_images", "warp_labels"):
        k = recs[name]
        print(f"{name} at 0 / {n_rot} / {b} of {b} rotated: "
              f"{k['ms_none_rotated']:.4f} / {k['ms']:.4f} / "
              f"{k['ms_all_rotated']:.4f} ms")
    k3 = recs["photometric"]
    print(f"photometric blurring none / {n_blur} / {b} of {b}: "
          f"{k3['ms_blur_none']:.4f} / {k3['ms']:.4f} / "
          f"{k3['ms_blur_all']:.4f} ms; differing elements "
          f"{json.dumps(k3['differing'])}; warp_labels differing "
          f"{json.dumps(recs['warp_labels']['differing'])}")
    return recs


def k5_check(torch, W, A, x, labels, params, wp, gains, flags, s, ops):
    """K5 ``warp_photo_images`` at three mixes of the train step's rows:
    "none" (no image rotated or blurred), the step's own (the first B/4
    rotated, the last B/4 blurred) and "all" (every image rotated at +-10
    degrees and blurred).  At each, in bf16 and f32 out, K5 must equal its
    plain version and the K1 -> K3 kernel chain bit for bit (the same f32
    operations with the same roundings); then K5 and the chain are timed
    in turns.  ``augment_batch_kernels(fused=True)``, driven once with the
    counts zeroed before and read after, must equal ``fused=False``."""
    b, dev = x.shape[0], x.device
    mixes = {"none": (torch.zeros(b), torch.zeros(b, dtype=torch.bool)),
             "": (params["angle"], params["blur"]),
             "all": (torch.tensor([10.0, -10.0] * (b // 2)),
                     torch.ones(b, dtype=torch.bool))}
    rows, differing, errs = {}, {}, []
    for mix, (angle, blur) in mixes.items():
        wpm = wp if mix == "" else W.make_warp_params(
            dict(params, angle=angle), (s, s), (s, s)).to(dev)
        bl = blur.to(dev)
        full = torch.cat([wpm, gains.float(), bl.float()[:, None]], 1)
        rows[mix] = (wpm, bl, full)
        key = mix or "main"
        for out_dtype in (torch.bfloat16, torch.float32):
            got = W.warp_photo_images(x, full, s, out_dtype)
            torch.cuda.synchronize()
            ref = W.warp_photo_images_reference(x, full, s, out_dtype)
            chain = W.photometric(W.warp_images(x, wpm, s), gains, bl,
                                  out_dtype)
            dk = f"{key}_{str(out_dtype).split('.')[-1]}"
            differing[dk] = {"plain": int((got != ref).sum()),
                             "chain": int((got != chain).sum())}
            errs.append(float((got.float() - ref.float()).abs().max()))
            check(torch.equal(got, ref) and torch.equal(got, chain),
                  f"warp_photo_images ({dk}) differs from its plain version "
                  f"on {differing[dk]['plain']} and from K1 -> K3 on "
                  f"{differing[dk]['chain']} elements: the same f32 "
                  "operations, expected equal")
    print(f"warp_photo_images differing elements (plain, K1 -> K3 chain): "
          f"{json.dumps(differing)}")

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
    check(torch.equal(fi, ui), "augment_batch_kernels fused=True differs "
          f"from fused=False on {int((fi != ui).sum())} elements")
    print("augment_batch_kernels fused=True vs False: images and labels "
          "equal")

    times = {}
    for mix, (wpm, bl, full) in rows.items():
        times[mix] = (
            cuda_ms(torch, lambda: W.warp_photo_images(x, full, s), 50),
            cuda_ms(torch, lambda: W.photometric(W.warp_images(x, wpm, s),
                                                 gains, bl), 50))
    print("warp_photo_images / K1 -> K3 at none / main / all: " + " / ".join(
        f"{times[m][0]:.4f} / {times[m][1]:.4f}" for m in ("none", "", "all"))
        + " ms (one call)")
    full = rows[""][2]
    n_rot = int((params["angle"] != 0).sum())
    n_blur = int(params["blur"].sum())
    return {"max_abs_err": max(errs), "mismatch_share": 0.0,
            "ms": times[""][0], "ms_none": times["none"][0],
            "ms_all": times["all"][0], "k1_k3_ms": times[""][1],
            "k1_k3_ms_none": times["none"][1], "k1_k3_ms_all": times["all"][1],
            "chain_differing": differing,
            "plain_ms": cuda_ms(torch, lambda: W.warp_photo_images_reference(
                x, full, s), 5),
            "launches": launches["warp_photo_images"],
            "timed": f"({b},3,{s},{s}) uint8 NHWC view -> bf16, {n_rot} "
                     f"rotated, {n_blur} blurred (ms_none: none; ms_all: all "
                     f"{b} rotated at +-10 deg and blurred; k1_k3_ms*: the "
                     "chain on the same rows)",
            # K1's uint8 read and K3's bf16 write; the operations of both
            "bounds": (x.numel() + b * 3 * s * s * 2 + full.numel() * 4, ops)}


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
    return res


def states_equal(torch, a, b):
    """(model params and buffers equal, both Adam states equal) of two
    trainers' states, bit for bit."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    model = all(torch.equal(v, sb[k]) for k, v in sa.items())

    def adam(x, y):
        xs, ys = x.state_dict()["state"], y.state_dict()["state"]
        return xs.keys() == ys.keys() and all(
            torch.equal(torch.as_tensor(xs[i][k]), torch.as_tensor(ys[i][k]))
            for i in xs for k in xs[i])
    return model, all(adam(a.opt_state[g], b.opt_state[g])
                      for g in ("backbone", "head"))


def jax_scan_limits(torch, losses_a, losses_b, a, b):
    """The limits of the JAX package's test_train_step_scan_matches_sequential
    (tests/test_seg_training.py:325): the first loss to rtol 1e-4, later
    ones to 1e-2; params within 5e-5 on > 99% of elements, all within
    5e-3.  Returns (within, readings)."""
    la = torch.as_tensor(losses_a).double()
    lb = torch.as_tensor(losses_b).double()
    rel = ((la - lb).abs() / lb.abs().clamp_min(1e-12)).tolist()
    sb = b.model.state_dict()
    d = torch.cat([(v.float() - sb[k].float()).abs().flatten() for k, v in
                   a.model.state_dict().items() if v.is_floating_point()])
    share = float((d < 5e-5).float().mean())
    ok = rel[0] <= 1e-4 and max(rel) <= 1e-2 and share > 0.99 and \
        float(d.max()) < 5e-3
    return ok, {"loss_rel": rel, "param_share_within_5e-5": share,
                "param_max_abs": float(d.max())}


def timed_steps(torch, prof_cls, DeviceType, run, steps_per_run, runs=3):
    """(ms per step, images/s factor 1e3/ms, device-busy ms per step, idle
    share) of ``run()`` (``steps_per_run`` steps each), after one warm-up
    run: host clock over ``runs`` runs ending in a synchronize, then
    device-busy time over profiled runs (train_phase's method)."""
    from torch.profiler import ProfilerActivity
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        run()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / (runs * steps_per_run)
    with prof_cls(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            run()
        torch.cuda.synchronize()
    busy = device_busy_ms(prof, DeviceType) / (runs * steps_per_run)
    return step_ms, busy, (1 - busy / step_ms if busy > 0 else None)


def defaults_phase(torch, W, g, card, eager_step=None, input_shape=None,
                   n_train=136, n_val=16, device="cuda"):
    """``SegTrainer`` on an unmodified ``SegTrainConfig()`` (the einsum
    augmentation, 8-step calls as CUDA graphs, batch 8 unfrozen and 16
    frozen, 512²) on seeded synthetic data, with its checks; see the module
    docstring.  ``input_shape`` shrinks the images for a rehearsal."""
    import gc
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import profile
    from cervical_tpu_torch.config import SegTrainConfig
    from cervical_tpu_torch.data.resident import ResidentSegData
    from cervical_tpu_torch.data.voc import ArraySegDataset, BatchLoader
    from cervical_tpu_torch.ops import augment as A
    from cervical_tpu_torch.ops.warp_xla import augment_batch_einsum
    from cervical_tpu_torch.train.seg_trainer import (SegTrainer,
                                                      _sample_step_aug_params)

    cfg = SegTrainConfig()
    check((cfg.data.aug_backend, cfg.steps_per_call, cfg.unfreeze_batch_size,
           cfg.freeze_batch_size, tuple(cfg.data.input_shape),
           cfg.device_resident, cfg.resident_shuffle, cfg.data.aug_pre_batch,
           cfg.data.two_shear) == ("einsum", 8, 8, 16, (512, 512), False,
                                   "gather", False, False),
          "SegTrainConfig defaults")
    if input_shape is not None:
        cfg.data.input_shape = input_shape
    h, w = cfg.data.input_shape
    k, bs = cfg.steps_per_call, cfg.unfreeze_batch_size
    dev = torch.device(device)
    rng = np.random.default_rng(int(torch.randint(0, 2 ** 31, (1,),
                                                  generator=g)))
    tr_im = rng.integers(0, 256, (n_train, h, w, 3), dtype=np.uint8)
    tr_lb = rng.integers(0, 5, (n_train, h, w), dtype=np.uint8)
    va_im = rng.integers(0, 256, (n_val, h, w, 3), dtype=np.uint8)
    va_lb = rng.integers(0, 5, (n_val, h, w), dtype=np.uint8)
    train, val = ArraySegDataset(tr_im, tr_lb), ArraySegDataset(va_im, va_lb)
    val_loader = BatchLoader(val, cfg.eval_batch_size, shuffle=False,
                             drop_last=False)
    res = {"config": f"SegTrainConfig() xception os16 {h}x{w} 5 classes "
                     f"bf16 adam einsum aug, steps_per_call {k}",
           "card": card}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # the einsum augmentation on the card against the CPU, and timed beside
    # the kernel chain (K1 -> K3 plus K2) on the same inputs and parameters
    gen = torch.Generator().manual_seed(5)
    params = _sample_step_aug_params(cfg, gen, bs)
    xs, ls = torch.from_numpy(tr_im[:bs]), torch.from_numpy(tr_lb[:bs])
    cap = max(1, bs // 4)
    kw = dict(rotate_capacity=cap, blur_capacity=cap)
    ci, cl = augment_batch_einsum(xs, ls, params, (h, w), **kw)
    dp = {n: v.to(dev) for n, v in params.items()}
    xd, ld = xs.to(dev), ls.to(dev)
    gi, gl = augment_batch_einsum(xd, ld, dp, (h, w), **kw)
    err, share, ok = one_step_ok(torch, gi.cpu(), ci, max_share=1e-3)
    check(torch.equal(gl.cpu(), cl), "einsum labels differ card/CPU")
    check(ok, f"einsum images on the card against the CPU: max {err}, "
          f"share {share} (limit one bf16 step on 1e-3)")
    def einsum():
        return augment_batch_einsum(xd, ld, dp, (h, w), **kw)

    def kernels():
        return W.augment_batch_kernels(xd, ld, dp, (h, w))

    def graphed(fn):
        """``fn`` captured in a CUDA graph: its replays time the card's
        work alone (the einsum call's host time, ~100 small launches,
        outlasts cuda_ms's spin).  A CPU rehearsal times ``fn`` itself."""
        if dev.type != "cuda":
            return fn
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return graph.replay

    def host_ms(fn, n=10):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    launches = dict(W.LAUNCHES)
    einsum_ms = cuda_ms(torch, graphed(einsum), 20)
    kernels_ms = cuda_ms(torch, graphed(kernels), 20)
    W.LAUNCHES.update(launches)  # the captures counted the chain's calls
    einsum_eager, kernels_eager = host_ms(einsum), host_ms(kernels)
    res["einsum_aug"] = {"card_vs_cpu_max_abs": err,
                         "card_vs_cpu_share": share, "ms": einsum_ms,
                         "kernels_ms": kernels_ms, "eager_ms": einsum_eager,
                         "kernels_eager_ms": kernels_eager, "batch": bs}
    print(f"einsum augmentation ({bs},{h},{w},3), caps {cap}: card vs CPU "
          f"max {err:.3g} on {share:.2e} of elements, labels equal; device "
          f"{einsum_ms:.4f} ms per call (graph replays) against K1 -> K3 + "
          f"K2 {kernels_ms:.4f} ms; eager, host clock {einsum_eager:.3f} "
          f"against {kernels_eager:.3f} ms ({card})")
    del gi, gl
    free()

    # the defaults' epochs: 17 batches unfrozen (two 8-step graph calls and
    # one single step), 8 frozen (one 8-step call)
    trainer = SegTrainer(cfg, device=device)
    lr = trainer.lr_schedule(bs, cfg.unfreeze_epoch)(0)
    epochs = []
    for frozen in (False, True):
        b = cfg.freeze_batch_size if frozen else bs
        loader = BatchLoader(train, b, seed=7 + frozen)
        model = trainer.state.model
        snap = {n: p.detach().clone()
                for n, p in model.backbone.named_parameters()}
        adam = {id(p): {q: v.clone() for q, v in st.items()} for p, st in
                trainer.state.opt_state["backbone"].state.items()}
        step0 = trainer.state.step
        W.reset_launches()
        t0 = time.perf_counter()
        r = trainer.run_epoch(loader, val_loader, int(frozen), frozen, lr)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps = trainer.state.step - step0
        print(f"defaults run_epoch (frozen={frozen}, batch {b}): {steps} "
              f"steps in {len(loader) // k} {k}-step calls + "
              f"{len(loader) % k} single, eval of {n_val}, {dt:.3f} s; loss "
              f"{r.train_loss:.5f} val {r.val_loss:.5f}")
        check(steps == len(loader) == n_train // b,
              f"{steps} steps for {len(loader)} batches")
        check(all(math.isfinite(v) for v in (r.train_loss, r.val_loss,
                                             r.train_f_score)),
              f"non-finite epoch metrics {r}")
        check(sum(W.LAUNCHES.values()) == 0, f"the einsum epoch launched "
              f"augmentation kernels {W.LAUNCHES}")
        if frozen:
            same = all(torch.equal(p, snap[n])
                       for n, p in model.backbone.named_parameters())
            same_adam = all(
                torch.equal(v, adam[id(p)][q]) for p, st in
                trainer.state.opt_state["backbone"].state.items()
                for q, v in st.items())
            check(same and same_adam, "the frozen epoch moved the backbone's "
                  "params or its Adam state")
        epochs.append({"frozen": frozen, "batch": b, "steps": steps,
                       "seconds": dt, "train_loss": r.train_loss,
                       "val_loss": r.val_loss})
    res["epochs"] = epochs

    # readings: the 8-step graph call
    xk = torch.from_numpy(tr_im[:k * bs].reshape(k, bs, h, w, 3)).to(dev)
    lk = torch.from_numpy(tr_lb[:k * bs].reshape(k, bs, h, w)).to(dev)
    m, bz, i = timed_steps(torch, profile, DeviceType,
                           lambda: trainer.train_steps(xk, lk, False, lr), k)
    res["graph_call"] = {"step_ms": m, "images_per_s": bs * 1e3 / m,
                         "device_busy_ms_per_step": bz, "idle_share": i}
    print(f"{k}-step graph call: {m:.3f} ms/step = {bs * 1e3 / m:.1f} "
          f"images/s, busy {bz:.3f} ms, idle "
          + ("not measured" if i is None else f"{i:.4f}") + f" ({card})")
    del trainer
    free()

    # graph against eager: two trainers from one seed, the same 8 batches
    # and (through the same generator stream) the same parameters
    tg, te = SegTrainer(cfg, device=device), SegTrainer(cfg, device=device)
    mg = tg.train_steps(xk, lk, False, lr)["loss"]
    me = torch.stack([te.train_step(xk[i], lk[i], False, lr)["loss"]
                      for i in range(k)])
    torch.cuda.synchronize()
    same_model, same_adam = states_equal(torch, tg.state, te.state)
    bitwise = torch.equal(mg, me) and same_model and same_adam
    cmp = {"bitwise": bitwise, "steps": (tg.state.step, te.state.step)}
    if not bitwise:
        # tell nondeterminism from a graph fault: a second eager run
        te2 = SegTrainer(cfg, device=device)
        me2 = torch.stack([te2.train_step(xk[i], lk[i], False, lr)["loss"]
                           for i in range(k)])
        cmp["eager_repeats_bitwise"] = bool(torch.equal(me, me2)) and all(
            states_equal(torch, te.state, te2.state))
        ok, rd = jax_scan_limits(torch, mg.cpu(), me.cpu(), tg.state,
                                 te.state)
        cmp.update(rd)
        check(ok, f"graph against eager beyond the JAX scan limits: {cmp}")
        del te2
    check(tg.state.step == te.state.step == k, f"steps {cmp['steps']}")
    res["graph_vs_eager"] = cmp
    print(f"graph against eager, {k} steps: bitwise {bitwise} "
          + json.dumps({q: v for q, v in cmp.items() if q != "bitwise"}))
    del tg, te
    free()

    # pallas with aug_pre_batch: one 8-step call against 8 per-step steps
    pcfg = SegTrainConfig()
    pcfg.data.input_shape = (h, w)
    pcfg.data.aug_backend = "pallas"
    pre = SegTrainer(dataclass_replace(pcfg, aug_pre_batch=True),
                     device=device)
    per = SegTrainer(pcfg, device=device)
    W.reset_launches()
    mp = pre.train_steps(xk, lk, False, lr)["loss"]
    torch.cuda.synchronize()
    pre_launches = dict(W.LAUNCHES)
    W.reset_launches()
    ms_ = torch.stack([per.train_step(xk[i], lk[i], False, lr)["loss"]
                       for i in range(k)])
    torch.cuda.synchronize()
    per_launches = dict(W.LAUNCHES)
    same_model, same_adam = states_equal(torch, pre.state, per.state)
    pre_ok = torch.equal(mp, ms_) and same_model and same_adam
    pcmp = {"bitwise": pre_ok, "launches_pre_batch": pre_launches,
            "launches_per_step": per_launches}
    if not pre_ok:
        ok, rd = jax_scan_limits(torch, mp.cpu(), ms_.cpu(), pre.state,
                                 per.state)
        pcmp.update(rd)
        # bit for bit unless the graph itself differed from eager steps
        check(ok and not bitwise, f"pre-batched pallas call against the "
              f"per-step steps (graph against eager bitwise: {bitwise}): "
              f"{pcmp}")
    for name in TRAIN_KERNELS:
        check(pre_launches[name] == 1 and per_launches[name] == k,
              f"{name}: {pre_launches[name]} launches in the pre-batched "
              f"call, {per_launches[name]} in {k} steps")
    res["pallas_pre_batch"] = pcmp
    print(f"pallas aug_pre_batch {k}-step call against {k} per-step steps: "
          f"bitwise {pre_ok}; launches {pre_launches} / {per_launches}")
    del pre, per
    free()

    # a resident gather epoch: every train image read once; the resident
    # mIoU matrix equal to the host-fed one
    rcfg = dataclass_replace(cfg, device_resident=True)
    rt = SegTrainer(rcfg, device=device)
    trs = ResidentSegData.from_arrays(tr_im, tr_lb, bs, dev, train=True)
    vrs = ResidentSegData.from_arrays(va_im, va_lb, cfg.eval_batch_size, dev,
                                      train=False)
    seen = []
    call = rt._resident_train

    def recording(data, frozen, idx, lr_, gather):
        seen.append(np.asarray(idx).ravel())
        return call(data, frozen, idx, lr_, gather)
    rt._resident_train = recording
    t0 = time.perf_counter()
    r = rt.run_epoch(trs, vrs, 0, False, lr)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rt._resident_train = call
    epoch_steps = rt.state.step
    rows = np.sort(np.concatenate(seen))
    check(np.array_equal(rows, np.arange(n_train // bs * bs)),
          "the gather epoch did not read each train image once")
    check(epoch_steps == n_train // bs and math.isfinite(r.train_loss),
          f"resident epoch: {epoch_steps} steps, {r}")
    hist_r = rt.evaluate_miou(vrs)["hist"]
    hist_h = rt.evaluate_miou(val_loader)["hist"]
    check(np.array_equal(hist_r, hist_h) and
          int(hist_r.sum()) == n_val * h * w,
          f"resident mIoU matrix (sum {int(hist_r.sum())}) differs from the "
          f"host-fed one (sum {int(hist_h.sum())})")
    perm = np.random.default_rng(0).permutation(n_train // bs * bs)
    res_ms = timed_steps(torch, profile, DeviceType,
                         lambda: rt._resident_train(
                             trs, False, perm[:k * bs].reshape(k, bs), lr,
                             True), k)
    res["resident_gather"] = {"epoch_seconds": dt, "steps": epoch_steps,
                              "step_ms": res_ms[0],
                              "images_per_s": bs * 1e3 / res_ms[0],
                              "device_busy_ms_per_step": res_ms[1],
                              "idle_share": res_ms[2]}
    print(f"resident gather epoch: {n_train // bs} steps + eval in {dt:.3f} s;"
          f" each image read once; mIoU matrix equal to the host-fed one; "
          f"{k}-step call {res_ms[0]:.3f} ms/step = "
          f"{bs * 1e3 / res_ms[0]:.1f} images/s, idle "
          + ("not measured" if res_ms[2] is None else f"{res_ms[2]:.4f}")
          + f" ({card})")
    if eager_step is not None:
        res["eager_pallas_step"] = eager_step
        print(f"eager pallas step (train phase): {eager_step['step_ms']:.3f} "
              f"ms/step = {eager_step['images_per_s']:.1f} images/s, idle "
              + ("not measured" if eager_step["idle_share"] is None
                 else f"{eager_step['idle_share']:.4f}") + f" ({card})")
    del rt, trs, vrs
    free()
    print("defaults " + json.dumps(res))
    return res


def dataclass_replace(cfg, **kw):
    """A copy of a ``SegTrainConfig`` with top-level or ``data`` fields
    replaced."""
    import dataclasses
    data_kw = {q: kw.pop(q) for q in list(kw) if hasattr(cfg.data, q)}
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, **data_kw), **kw)


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
        # K4 on every eval forward (48 stencils, 48 products): one val
        # batch per epoch, the mIoU pass and the predictor pass at epoch 2
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


def sampler(read, period):
    """A thread calling ``read()`` every ``period`` seconds; returns
    ``(stop, samples)``: ``samples`` the (perf_counter, value) pairs so
    far, the first taken at once, and ``stop()`` ends the thread after one
    last sample."""
    import threading
    samples = [(time.perf_counter(), read())]
    done = threading.Event()

    def run():
        while not done.wait(period):
            samples.append((time.perf_counter(), read()))
    t = threading.Thread(target=run, daemon=True)
    t.start()

    def stop():
        done.set()
        t.join()
        samples.append((time.perf_counter(), read()))
    return stop, samples


def rss_bytes():
    """This process's resident set."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def sm_clock_power():
    """The card's SM clock (MHz) and power draw (W), or None."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=30).stdout
    try:
        return tuple(float(v) for v in out.splitlines()[0].split(","))
    except (IndexError, ValueError):
        return None


def in_window(samples, t0, t1):
    return [v for t, v in samples if t0 <= t <= t1 and v is not None]


def protocol_lines(save_dir):
    with open(os.path.join(save_dir, "protocol.log")) as f:
        return f.read().splitlines()


def protocol_phase(torch, W, MF, card, train_n=6720, val_n=840, size=512,
                   small_n=(64, 16), device="cuda"):
    """The reference segmentation protocol (``python -m
    cervical_tpu_torch.run_seg_protocol``, the JAX package's defaults: the
    einsum augmentation, no kernel).  (a) ``main`` in this process at
    ``train_n`` / ``val_n`` x ``size``² for one frozen and one unfrozen
    epoch: finite losses, the upload's GB and seconds, each epoch's train
    and val seconds, train images/s, every train image read once per
    epoch at both batch sizes, the 8-step calls captured at both, the
    card's and the host's peak memory; then on its trainer the peak card
    memory of each resident shuffle mode (the set made on the card), and
    the predictor callback over ``val_n`` files on disk.  (b) the CLI at
    ``small_n`` images in a subprocess, sent SIGTERM while epoch 6 of 10
    runs, then ``--resume`` to epoch 10."""
    import gc
    import resource
    import shutil
    import signal
    import tempfile
    import threading
    import numpy as np
    from cervical_tpu_torch import run_seg_protocol as RP
    from cervical_tpu_torch.data.resident import ResidentSegData
    from cervical_tpu_torch.data.voc import VOCSegDataset
    from cervical_tpu_torch.train.callbacks import PredictorMiouCallback
    from cervical_tpu_torch.train.checkpoints import CheckpointManager
    from cervical_tpu_torch.train.seg_trainer import SegTrainer

    cuda = device != "cpu"
    dev = torch.device(device)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_protocol_")
    proc = None
    res = {"card": card}
    try:
        # (a) full scale in this process
        calls, evals, epochs, trainers, fit_at = [], [], [], [], []
        originals = {k: getattr(SegTrainer, k) for k in
                     ("_resident_train", "_resident_eval", "run_epoch", "fit")}

        def train_call(self, data, frozen, idx, lr, gather):
            calls.append((frozen, data.batch_size, gather,
                          np.array(idx, np.int64), time.perf_counter()))
            return originals["_resident_train"](self, data, frozen, idx, lr,
                                                gather)

        def eval_call(self, data, pos, k):
            evals.append(time.perf_counter())
            return originals["_resident_eval"](self, data, pos, k)

        def run_epoch(self, train, val, epoch, frozen, lr):
            evals.clear()
            t0 = time.perf_counter()
            r = originals["run_epoch"](self, train, val, epoch, frozen, lr)
            t1 = time.perf_counter()
            epochs.append({"frozen": frozen, "batch": train.batch_size,
                           "t": (t0, evals[0], t1),
                           "seconds": t1 - t0, "train_s": evals[0] - t0,
                           "val_s": t1 - evals[0],
                           "images": train.num_chunks * train.batch_size,
                           "train_loss": r.train_loss,
                           "val_loss": r.val_loss})
            return r

        def fit(self, *a, **kw):
            trainers.append(self)
            fit_at.append(time.perf_counter())
            return originals["fit"](self, *a, **kw)
        for name, fn in (("_resident_train", train_call),
                         ("_resident_eval", eval_call),
                         ("run_epoch", run_epoch), ("fit", fit)):
            setattr(SegTrainer, name, fn)
        save = os.path.join(tmp, "full")
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        W.reset_launches()
        MF.reset_launches()
        stop_rss, rss = sampler(rss_bytes, 0.1)
        stop_smi, smi = sampler(sm_clock_power if cuda else lambda: None,
                                1.0)
        t0 = time.perf_counter()
        try:
            summary = RP.main(["--save_dir", save, "--epochs", "2",
                               "--freeze_epoch", "1", "--no_predictor",
                               "--train_n", str(train_n), "--val_n",
                               str(val_n), "--size", str(size),
                               "--device", device])
        finally:
            for name, fn in originals.items():
                setattr(SegTrainer, name, fn)
            stop_rss()
            stop_smi()
        sync()
        main_s = time.perf_counter() - t0
        launched = {**W.LAUNCHES, **MF.LAUNCHES}
        card_peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
        log = protocol_lines(save)
        upload = [m.split("] ", 1)[1] for m in log if "resident upload" in m]
        check(summary["epochs_run"] == 2 and
              summary["n_unfrozen_epochs"] == 1 and len(epochs) == 2 and
              [e["frozen"] for e in epochs] == [True, False] and
              all(math.isfinite(e[k]) for e in epochs
                  for k in ("train_loss", "val_loss")),
              f"protocol epochs {epochs}, summary {summary}")
        check(len(upload) == 2 and upload[0].startswith(
            f"resident upload: {train_n} images"), f"upload lines {upload}")
        check(not any(launched.values()),
              f"the protocol launched kernels: {launched}")
        for e, (frozen, b) in zip(epochs, ((True, 16), (False, 8))):
            mine = [c for c in calls if c[0] == frozen]
            rows = np.sort(np.concatenate([c[3].ravel() for c in mine]))
            check(all(c[1:3] == (b, True) for c in mine) and
                  np.array_equal(rows, np.arange(train_n // b * b)),
                  f"epoch at batch {b}: {len(mine)} calls did not read "
                  "every train image once")
            # the steady rate: dispatches of the epoch's second half, where
            # the host waits on the card (pipeline_depth calls in flight)
            at = [c[4] for c in mine]
            gaps = np.diff(at[len(at) // 2:])
            ta, tb, tc = e.pop("t")
            clocks = in_window(smi, ta, tb)
            e.update({
                "calls": len(mine),
                "images_per_s": e["images"] / e["train_s"],
                "steady_ms_per_step": float(np.median(gaps)) * 1e3 / 8
                if len(gaps) else None,
                "sm_mhz_median_min": [float(np.median([v[0] for v in clocks])),
                                      min(v[0] for v in clocks)]
                if clocks else None,
                "power_w_median_max": [
                    float(np.median([v[1] for v in clocks])),
                    max(v[1] for v in clocks)] if clocks else None,
                "host_rss_peak_gb": max(in_window(rss, ta, tc)) / 1e9})
        rss_peak = max(v for _, v in rss)
        rss_at_fit = max(in_window(rss, t0, fit_at[0]))
        tr = trainers[0]
        graphs = sorted({k[:4] for k in tr._graphs if k[0] == "res"})
        check(not cuda or all(any(g[1] == f and g[3] == b for g in graphs)
                              for f, b in ((True, 16), (False, 8))),
              f"captured resident calls {graphs}")
        res["a"] = {"summary": summary, "main_s": main_s, "epochs": epochs,
                    "upload": upload, "graphs": [list(g) for g in graphs],
                    "card_peak_gb": card_peak,
                    "host_rss_before_gb": rss[0][1] / 1e9,
                    "host_rss_data_gb": rss_at_fit / 1e9,
                    "host_rss_peak_gb": rss_peak / 1e9,
                    "host_ru_maxrss_gb": resource.getrusage(
                        resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9}
        print(f"protocol (a) on {card}: {train_n} / {val_n} x {size}^2, "
              f"2 epochs in {main_s:.1f} s, data_prep_s "
              f"{summary['data_prep_s']}; {upload[0]}; "
              + "; ".join(f"{'frozen' if e['frozen'] else 'unfrozen'} "
                          f"epoch {e['seconds']:.2f} s (train "
                          f"{e['train_s']:.2f} s in {e['calls']} calls, "
                          f"{e['images_per_s']:.1f} images/s, steady "
                          f"{e['steady_ms_per_step']} ms/step, SM "
                          f"{e['sm_mhz_median_min']} MHz, "
                          f"{e['power_w_median_max']} W; val "
                          f"{e['val_s']:.2f} s), losses "
                          f"{e['train_loss']:.4f} / {e['val_loss']:.4f}"
                          for e in epochs)
              + f"; peak card memory {card_peak} GB, host RSS peak "
              f"{rss_peak / 1e9:.2f} GB (at the start "
              f"{rss[0][1] / 1e9:.2f}, with the data made "
              f"{rss_at_fit / 1e9:.2f})")
        tr._graphs.clear()
        gc.collect()

        # the resident shuffle modes: the set's peak on the card through
        # each mode's shuffle and one 8-step call (both calls captured first)
        g = torch.Generator(device=dev).manual_seed(17)
        rs = ResidentSegData(
            torch.randint(0, 256, (train_n, size, size, 3),
                          dtype=torch.uint8, device=dev, generator=g),
            torch.randint(0, 5, (train_n, size, size), dtype=torch.uint8,
                          device=dev, generator=g), None, 8, train_n)
        c = rs.num_chunks
        rng = np.random.default_rng(3)
        modes = {}

        def peak_of(fn):
            """(peak GB allocated above the start, seconds, fn's result)."""
            sync()
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            t = time.perf_counter()
            out = fn()
            sync()
            s = time.perf_counter() - t
            return ((torch.cuda.max_memory_allocated() - base) / 1e9
                    if cuda else None), s, out

        def call(idx, gather):
            return lambda: tr._resident_train(rs, False, idx, 1e-6, gather)
        k = min(8, c)
        modes["capture_gather"] = peak_of(call(
            np.arange(k * 8).reshape(k, 8), True))[:2]
        modes["capture_batches"] = peak_of(call(np.arange(k), False))[:2]
        # each mode's per-epoch shuffle, then its first call's indices
        shuffles = {
            "gather": lambda: rng.permutation(c * 8).reshape(c, 8),
            "images": lambda: rs.shuffle_(tr.shuffle_generator) and
            np.arange(c),
            "chunks": lambda: rng.permutation(c),
            "none": lambda: np.arange(c)}
        for mode, shuffle in shuffles.items():
            gb, s, order = peak_of(shuffle)
            modes[mode] = {"shuffle": (gb, s), "call": peak_of(call(
                order[:k], mode == "gather"))[:2]}
        set_gb = (rs.images.nbytes + rs.labels.nbytes) / 1e9
        tr._graphs.clear()  # they hold the set
        del rs
        gc.collect()
        res["shuffle_modes"] = {"set_gb": set_gb, **modes}
        print(f"resident shuffle modes ({train_n} x {size}^2 on the card, "
              f"{set_gb:.2f} GB): "
              + "; ".join(f"{m}: shuffle +{v['shuffle'][0]} GB in "
                          f"{v['shuffle'][1]:.3f} s, 8-step call +"
                          f"{v['call'][0]} GB in {v['call'][1]:.3f} s"
                          for m, v in modes.items() if "shuffle" in v)
              + "; captures " + ", ".join(
                  f"{m} +{modes[m][0]} GB" for m in modes
                  if m.startswith("capture")))

        # the predictor callback over val_n JPEG/PNG pairs on disk, as
        # every eval epoch (10, 20, ...) of the protocol runs it
        val_dir = os.path.join(tmp, "val_voc")
        vi, vl = RP.synth_seg_arrays(val_n, size, seed=77, log=None)
        t = time.perf_counter()
        RP.write_val_to_disk(val_dir, vi, vl, log=lambda *m: None)
        write_s = time.perf_counter() - t
        del vi, vl
        ds = VOCSegDataset(val_dir, [f"{i:06d}" for i in range(val_n)],
                           stage_hw=(size, size))
        cb = PredictorMiouCallback(os.path.join(tmp, "cb"), ds, 10,
                                   device=dev)
        runs = []
        for epoch in (9, 19):
            t = time.perf_counter()
            miou = cb.run(tr.cfg, tr.state, epoch, log=lambda *m: None)
            sync()
            runs.append(time.perf_counter() - t)
            check(0.0 <= miou <= 1.0, f"predictor mIoU {miou}")
        res["predictor_callback"] = {"images": val_n, "write_s": write_s,
                                     "first_s": runs[0], "next_s": runs[1],
                                     "miou": miou}
        print(f"predictor callback over {val_n} files: {runs[0]:.2f} s "
              f"first, {runs[1]:.2f} s next (val set written in "
              f"{write_s:.2f} s), mIoU {miou:.4f}")
        del cb, tr, trainers
        shutil.rmtree(save, ignore_errors=True)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # (b) the CLI at small n: SIGTERM while epoch 6 runs (1 s after
        # epoch 5's line: the loop tests its stop flag just after printing
        # that line), then --resume to epoch 10
        sdir = os.path.join(tmp, "small")
        cmd = [sys.executable, "-u", "-m",
               "cervical_tpu_torch.run_seg_protocol", "--device", device,
               "--save_dir", sdir, "--train_n", str(small_n[0]),
               "--val_n", str(small_n[1]), "--size", str(size),
               "--epochs", "10", "--freeze_epoch", "5"]
        env = dict(os.environ, PYTHONPATH=HERE)
        runs = []
        for extra in ([], ["--resume"]):
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmd + extra, cwd=HERE, env=env,
                                    text=True, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT)
            watchdog = threading.Timer(600, proc.kill)
            watchdog.start()
            out, sent = [], None
            for line in proc.stdout:
                out.append(line)
                if not extra and sent is None and "] Epoch 5/10" in line:
                    time.sleep(1.0)
                    proc.send_signal(signal.SIGTERM)
                    sent = time.perf_counter() - t0
            rc = proc.wait()
            watchdog.cancel()
            proc = None
            runs.append({"rc": rc, "seconds": time.perf_counter() - t0,
                         "sigterm_at_s": sent, "text": "".join(out)})
        first, second = runs
        with open(os.path.join(sdir, "protocol_summary.json")) as f:
            summary = json.load(f)
        ep = [m.split("] ")[1].split()[1] for m in protocol_lines(sdir)
              if "] Epoch " in m]
        check(first["rc"] == 0 and first["sigterm_at_s"] is not None and
              "stopped after epoch 6" in first["text"] and
              "Epoch 7/10" not in first["text"],
              f"protocol CLI exit {first['rc']}, SIGTERM at "
              f"{first['sigterm_at_s']}; tail:\n{first['text'][-3000:]}")
        check(second["rc"] == 0 and "resumed from epoch 6" in second["text"]
              and ep == [f"{i}/10" for i in range(1, 11)],
              f"resumed CLI exit {second['rc']}, epochs {ep}; tail:\n"
              f"{second['text'][-3000:]}")

        def lines(name):
            with open(os.path.join(sdir, name)) as f:
                return f.read().splitlines()
        losses = [float(v) for v in lines("epoch_loss.txt")]
        names = os.listdir(sdir)
        extra = CheckpointManager(sdir).restore("last_epoch_weights")["extra"]
        check(len(losses) == 10 and all(map(math.isfinite, losses)) and
              len(lines("epoch_miou.txt")) == 1 and
              len(lines("epoch_miou_predictor.txt")) == 1 and
              any(n.startswith("ep010-") for n in names) and
              extra["epoch"] == 9 and summary["epochs_run"] == 4 and
              len(summary["predictor_miou"]) == 1,
              f"resumed run: losses {losses}, files {sorted(names)}, "
              f"checkpoint {extra}, summary {summary}")
        res["b"] = {"first_s": first["seconds"],
                    "sigterm_at_s": first["sigterm_at_s"],
                    "resume_s": second["seconds"], "summary": summary}
        print(f"protocol CLI ({small_n[0]} / {small_n[1]} x {size}^2): "
              f"SIGTERM {first['sigterm_at_s']:.1f} s after start, stopped "
              f"after epoch 6, exit 0 in {first['seconds']:.1f} s; --resume "
              f"ran epochs 7-10 in {second['seconds']:.1f} s, mIoU "
              f"{summary['miou_trajectory']}, predictor "
              f"{summary['predictor_miou']}")
        print("protocol " + json.dumps(res))
        return res
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def synthetic_cohort(torch, n, dim, seed, device, noise=0.5):
    """``make_synthetic_fusion``'s cohort (a class prototype per label plus
    noise on every node), drawn on ``device``: labels from numpy (the
    splits stratify them on the host), features by a seeded generator."""
    import numpy as np
    from cervical_tpu_torch.data.fusion_data import node_count
    from cervical_tpu_torch.models.fusion import ALL_MODALITIES
    labels = np.random.default_rng(seed).integers(0, 4, n).astype(np.int32)
    g = torch.Generator(device).manual_seed(seed)
    protos = torch.randn((4, dim), generator=g, device=device)
    lab = torch.from_numpy(labels).long().to(device)
    feats = {m: protos[lab][:, None, :] + noise * torch.randn(
        (n, node_count(m), dim), generator=g, device=device)
        for m in ALL_MODALITIES}
    return {"feats": feats, "labels": labels,
            "present": np.ones((n, len(ALL_MODALITIES)), bool),
            "ids": [str(i) for i in range(n)]}


def top_kernels(torch, prof_cls, DeviceType, run, steps, top=8):
    """Device kernels of one profiled ``run()`` (``steps`` steps): the
    launches per step of all of them, then the ``top`` by self device
    time as (name, ms per step, launches per step)."""
    from torch.profiler import ProfilerActivity
    run()
    torch.cuda.synchronize()
    with prof_cls(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        rows.append((e.key[:90], us / 1e3 / steps, e.count / steps))
    return [sum(r[2] for r in rows)] + sorted(rows, key=lambda r: -r[1])[:top]


def stacked_twins(torch, cfg, f, dev, copies=2, seed=21):
    """``copies`` identical fold stacks of ``f`` pairs (``cfg``'s model,
    pair i drawn from seed ``seed + i``, dropout seed ``100 + i``), each
    with its ``StackedAdam`` and stacked step: ``[(state, step), ...]``."""
    from cervical_tpu_torch.train import fold_stack as FS
    from cervical_tpu_torch.train.fusion_trainer import build_model, make_loss
    from cervical_tpu_torch.train.seg_trainer import TrainState
    sds = [build_model(cfg).init_weights(
        torch.Generator().manual_seed(seed + i)).state_dict()
        for i in range(f)]
    out = []
    for _ in range(copies):
        stack = FS.FoldStack(build_model(cfg).to(dev), sds,
                             [100 + i for i in range(f)])
        opt = FS.StackedAdam(stack.flat, lr=cfg.lr,
                             weight_decay=cfg.weight_decay)
        out.append((TrainState(stack, {"params": opt}),
                    FS.make_stacked_step(stack, opt, make_loss(cfg))))
    return out


def stacked_states_equal(torch, a, b):
    sa, sb = a.model, b.model
    oa, ob = (s.opt_state["params"].state[s.model.flat] for s in (a, b))
    return (torch.equal(sa.flat, sb.flat) and torch.equal(sa.rng, sb.rng)
            and all(torch.equal(oa[k], ob[k]) for k in oa))


def stacked_graph_vs_eager(torch, cfg, ds, f, dev, g):
    """Four stacked steps of ``f`` pairs replayed from their CUDA graphs (one
    per ``do_step``) against the same steps run eagerly on a twin stack, bit
    for bit (outputs, params, dropout counts, Adam's counts and moments),
    dropout on: steps 0-1 with ``do_step`` False (epoch 0), 2-3 True, pair 1
    on an all-weight-0 batch at step 3 (its state must not move)."""
    from cervical_tpu_torch.data.masks import generate_modal_masks
    from cervical_tpu_torch.train.graphs import GraphedCall
    (sa, step_a), (sb, step_b) = stacked_twins(torch, cfg, f, dev)
    bs, t = cfg.batch_size, len(cfg.modalities)
    feats, labels = ds["feats"], torch.as_tensor(ds["labels"],
                                                 dtype=torch.int64,
                                                 device=dev)
    n = labels.shape[0]
    idx = torch.randint(0, n, (4, f, bs), generator=g, device=dev)
    masks = generate_modal_masks(g, 4 * f * bs, t).view(4, f, bs, t)
    w = torch.ones((4, f, bs), device=dev)
    w[3, 1] = 0
    w[3, 0, 5:] = 0
    lr = torch.full((), cfg.lr, device=dev)
    calls = {d: GraphedCall(
        lambda i, m, ww, l, d=d: step_a(feats, labels, i, m, ww, l, d), sa,
        (idx[0], masks[0], w[0], lr), dev) for d in (False, True)}
    same = True
    for k in range(4):
        d = k >= 2
        if k == 3:
            held = sa.model.flat[1].clone()
        ma = calls[d](idx[k], masks[k], w[k], lr)
        mb = step_b(feats, labels, idx[k], masks[k], w[k], lr, d)
        same &= all(torch.equal(ma[key], mb[key]) for key in ma)
        same &= bool(torch.isfinite(ma["loss"]).all())
    same &= stacked_states_equal(torch, sa, sb)
    same &= torch.equal(sa.model.flat[1], held)
    counts = sa.opt_state["params"].state[sa.model.flat]["step"]
    same &= counts.tolist() == [2.0, 1.0] + [2.0] * (f - 2)
    same &= sa.model.rng[:, 1].tolist() == [4, 3] + [4] * (f - 2)
    return same


def stacked_vs_sequential(torch, cfg, ds, f, dev, g):
    """Pair by pair, ``f`` stacked pairs at ``cfg``'s width against the
    sequential ``FusionTrainer.train_step_fn`` on a model loaded with that
    pair's params and dropout ``rng`` (so the same dropout masks): 3 steps,
    dropout on, step 0 without Adam (epoch 0), pair 1 on an all-weight-0
    batch at step 2 (the sequential side skips it; the stacked pair must not
    move) and pair 2 on a ragged one.  A batched product rounds otherwise
    than a single one, so the limits are the CPU tests' against JAX: loss
    to 1e-4 relative; the first Adam step's gradients, at equal params, to
    1e-4 of each tensor's largest entry (floored at 1e-3 of the largest of
    all); params within ``_adam_bounds``'s per-entry bound (1e-5 plus, per
    Adam step, lr * min(2, 2 d / sqrt(v)), d the entry's largest gradient
    difference so far, v the sequential side's bias-corrected second
    moment); moments to 1e-3 (floored as the gradients); Adam's and the
    dropout counts exact.  Returns (ok, readings)."""
    from cervical_tpu_torch.data.masks import generate_modal_masks
    from cervical_tpu_torch.train.fusion_trainer import FusionTrainer
    [(st, step)] = stacked_twins(torch, cfg, f, dev, copies=1)
    stack, opt = st.model, st.opt_state["params"]
    tr = FusionTrainer(cfg, device=dev.type)
    seq_step = tr.train_step_fn()
    seqs = []
    for i in range(f):
        s = tr.init_state()
        s.model.load_state_dict(stack.pair_state_dict(i))
        s.model.rng.copy_(stack.rng[i])
        seqs.append(s)
    bs, t = cfg.batch_size, len(cfg.modalities)
    feats = ds["feats"]
    labels = torch.as_tensor(ds["labels"], dtype=torch.int64, device=dev)
    idx = torch.randint(0, labels.shape[0], (3, f, bs), generator=g,
                        device=dev)
    masks = generate_modal_masks(g, 3 * f * bs, t).view(3, f, bs, t)
    w = torch.ones((3, f, bs), device=dev)
    w[2, 1] = 0
    w[2, 2, 5:] = 0
    lr = tr._lr_arg(cfg.lr)
    beta2 = 0.999

    def rel(ref, got):
        floor = 1e-3 * max(float(v.abs().max()) for v in ref.values())
        return max(float((ref[n].double() - got[n].double()).abs().max())
                   / max(float(ref[n].abs().max()), floor) for n in ref)

    bound = [{} for _ in range(f)]
    dmax = [{} for _ in range(f)]
    r = {"loss_rel": 0.0, "grad_rel": 0.0}
    ok = True
    for k, do in enumerate((False, True, True)):
        held = stack.flat[1].clone()
        out = step(feats, labels, idx[k], masks[k], w[k], lr, do)
        for i in range(f):
            if not bool((w[k, i] > 0).any()):
                ok &= torch.equal(stack.flat[i], held)
                continue
            rows = idx[k, i]
            o = seq_step(seqs[i], {m: v.index_select(0, rows)
                                   for m, v in feats.items()},
                         labels.index_select(0, rows), masks[k, i], w[k, i],
                         lr, do)
            a = float(o["loss"])
            r["loss_rel"] = max(r["loss_rel"],
                                abs(a - float(out["loss"][i])) / abs(a))
            if not do:
                continue
            params = dict(seqs[i].model.named_parameters())
            gs = {n: p.grad for n, p in params.items()}
            gk = stack.pair_state_dict(i, stack.grad)
            if not dmax[i]:
                r["grad_rel"] = max(r["grad_rel"], rel(gs, gk))
            sopt = seqs[i].opt_state["params"]
            for n, p in params.items():
                d = (gs[n].double() - gk[n].double()).abs()
                dmax[i][n] = torch.maximum(dmax[i][n], d) \
                    if n in dmax[i] else d
                ps = sopt.state[p]
                root = (ps["exp_avg_sq"].double()
                        / (1.0 - beta2 ** float(ps["step"]))).sqrt()
                bound[i][n] = bound[i].get(n, 1e-5) + cfg.lr * torch.clamp(
                    2.0 * dmax[i][n] / root.clamp(min=1e-30), max=2.0)
    sk = opt.state[stack.flat]
    r["param_excess"] = r["moment_rel"] = 0.0
    for i in range(f):
        params = dict(seqs[i].model.named_parameters())
        sopt = seqs[i].opt_state["params"]
        got = stack.pair_state_dict(i)
        r["param_excess"] = max(r["param_excess"], max(
            float(((params[n].double() - got[n].double()).abs()
                   / bound[i][n]).max()) for n in params))
        for key in ("exp_avg", "exp_avg_sq"):
            r["moment_rel"] = max(r["moment_rel"], rel(
                {n: sopt.state[p][key] for n, p in params.items()},
                stack.pair_state_dict(i, sk[key])))
        first = sopt.state[next(iter(params.values()))]
        ok &= float(sk["step"][i]) == float(first["step"])
        ok &= int(stack.rng[i, 1]) == int(seqs[i].model.rng[1])
    ok &= (r["loss_rel"] <= 1e-4 and r["grad_rel"] < 1e-4
           and r["param_excess"] <= 1.0 and r["moment_rel"] < 1e-3)
    return ok, r


def vmap_width(torch, cfg, ds, dev, width, g, card, timing=True):
    """Readings of the vmapped engine at group width ``width`` on the device
    cohort ``ds`` at ``cfg``'s width: the stacked train step's CUDA graph
    replayed (ms per group step and per pair-step, device busy ms, idle
    share, top kernels; its Adam alone), then ``_cross_validate_vmapped``
    cut to 3 epochs with ``ceil(width / kfold)`` seed repeats, stopped
    after its first group (its third epoch's wall time as pair-epochs/s,
    peak memory)."""
    import dataclasses
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import profile
    from cervical_tpu_torch.data.masks import generate_modal_masks
    from cervical_tpu_torch.train.fusion_trainer import FusionTrainer
    from cervical_tpu_torch.train.graphs import GraphedCall

    labels = np.asarray(ds["labels"])
    n, bs, r = len(labels), cfg.batch_size, {"width": width}
    idle = None
    if timing:
        [(st, step)] = stacked_twins(torch, cfg, width, dev, copies=1)
        idx = torch.randint(0, n, (8, width, bs), generator=g, device=dev)
        masks = generate_modal_masks(g, 8 * width * bs, 4).view(
            8, width, bs, 4)
        w = torch.ones((width, bs), device=dev)
        lr = torch.full((), cfg.lr, device=dev)
        lbl = torch.as_tensor(labels, dtype=torch.int64, device=dev)
        call = GraphedCall(
            lambda i, m, ww, l: step(ds["feats"], lbl, i, m, ww, l, True),
            st, (idx[0], masks[0], w, lr), dev)

        def run():
            for i in range(8):
                call(idx[i], masks[i], w, lr)
        ms, busy, idle = timed_steps(torch, profile, DeviceType, run, 8)
        opt, every = st.opt_state["params"], torch.ones(
            width, dtype=torch.bool, device=dev)
        r.update({"group_step_ms": ms, "pair_step_ms": ms / width,
                  "device_busy_ms_per_step": busy, "idle_share": idle,
                  "top_kernels": top_kernels(torch, profile, DeviceType,
                                             run, 8, top=6),
                  # the step's Adam alone, on the card (CUDA events)
                  "adam_ms": cuda_ms(torch, lambda: opt.step(
                      st.model.grad, every, lr), 8)})
        del st, step, call, opt
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    vcfg = dataclasses.replace(cfg, repeat_num=-(-width // cfg.kfold))
    tr = FusionTrainer(vcfg, device=dev.type)
    stamps = []

    def log(msg):
        stamps.append((time.perf_counter(), msg))
        if msg == "group 0: epochs 3/3":
            tr.request_stop()
    e0 = time.perf_counter()
    out = tr._cross_validate_vmapped(ds, 3, labels, log, None,
                                     epoch_chunk=1, group=width)
    r["engine_s"] = time.perf_counter() - e0
    ends = {m: t for t, m in stamps if m.startswith("group 0: epochs")}
    r["epoch3_s"] = ends["group 0: epochs 3/3"] - ends["group 0: epochs 2/3"]
    r["pair_epochs_per_s"] = width / r["epoch3_s"]
    r["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    accs = [f["test"]["acc_all"] for f in out["folds"]]
    check(len(accs) == width and all(0.0 <= x <= 1.0 for x in accs),
          f"(c) width {width}: {len(accs)} folds, test acc {accs}")
    r["test_acc_mean"] = float(np.mean(accs))
    del tr, out
    torch.cuda.empty_cache()
    msg = (f"fusion vmapped width {width}: engine epoch 3 "
           f"{r['epoch3_s']:.3f} s = {r['pair_epochs_per_s']:.3f} "
           f"pair-epochs/s, peak {r['peak_gib']:.2f} GiB")
    if timing:
        msg += (f"; stacked step {r['group_step_ms']:.3f} ms = "
                f"{r['pair_step_ms']:.4f} ms per pair-step (its Adam "
                f"{r['adam_ms']:.3f} ms), idle "
                + ("not measured" if idle is None else f"{idle:.4f}"))
    print(msg + f" ({card})")
    return r


def fusion_vmap(torch, cfg, ds, dev, card, timing=True, widths=(1, 5, 25)):
    """The vmapped-folds engine on the card (``fusion`` phase, part 2):

    (a) ``stacked_graph_vs_eager`` at ``cfg``'s width, 3 pairs;
    (a2) ``stacked_vs_sequential`` at ``cfg``'s width, 3 pairs;
    (b) 2 pairs x 2 epochs of ``cross_validate(vmap_folds=True)`` against
        the sequential engine on the same pairs (48 synthetic patients, in
        32, hidden 64: the CPU test's size), at the CPU test's tolerances;
    (c) ``vmap_width`` per group width: 1 and 5 (one seed, a group of 1 or
        of its 5 folds) and 25 (5 seeds x 5 folds);
    (d) bf16: one sequential train step's graph against its eager twin,
        and ``stacked_graph_vs_eager`` in bf16, finite losses."""
    import dataclasses
    import numpy as np
    from cervical_tpu_torch.config import FusionTrainConfig
    from cervical_tpu_torch.data.fusion_data import make_synthetic_fusion
    from cervical_tpu_torch.data.masks import generate_modal_masks
    from cervical_tpu_torch.train.fusion_trainer import FusionTrainer

    res, seconds = {}, {}
    g = torch.Generator(dev).manual_seed(5)
    t0 = time.perf_counter()
    check(stacked_graph_vs_eager(torch, cfg, ds, 3, dev, g),
          "(a) stacked graph replays differ from the eager stacked steps")
    res["stacked_graph_equals_eager"] = True
    seconds["a"] = time.perf_counter() - t0

    # (a2) pair by pair against the sequential step, at full width
    t0 = time.perf_counter()
    ok, r = stacked_vs_sequential(torch, cfg, ds, 3, dev, g)
    check(ok, f"(a2) stacked pairs differ from the sequential step: {r}")
    res["stacked_vs_sequential"] = r
    print(f"fusion (a2) 3 stacked pairs against the sequential step at "
          f"in {cfg.in_features} hidden {cfg.hidden}: {json.dumps(r)}")
    seconds["a2"] = time.perf_counter() - t0

    # (b) the engine against the sequential one, on the card
    t0 = time.perf_counter()
    scfg = FusionTrainConfig(in_features=32, hidden=64, epochs=2, kfold=2)
    sds = make_synthetic_fusion(num_patients=48, feature_dim=32, seed=5)
    seq = FusionTrainer(scfg, device=dev.type).cross_validate(
        sds, log=lambda *a: None)
    vm = FusionTrainer(scfg, device=dev.type).cross_validate(
        sds, log=lambda *a: None, vmap_folds=True)
    worst = {"val_acc": 0.0, "acc_all": 0.0, "epoch_acc": 0.0,
             "epoch_loss": 0.0}
    ok = len(seq["folds"]) == len(vm["folds"]) == 2
    for a, b in zip(seq["folds"], vm["folds"]):
        ok &= a["best_epoch"] == b["best_epoch"]
        ok &= bool(np.array_equal(a["test"]["confusion"],
                                  b["test"]["confusion"]))
        worst["val_acc"] = max(worst["val_acc"],
                               abs(a["val_acc"] - b["val_acc"]))
        worst["acc_all"] = max(worst["acc_all"], abs(
            a["test"]["acc_all"] - b["test"]["acc_all"]))
        for ea, eb in zip(a["epoch_test"], b["epoch_test"]):
            worst["epoch_acc"] = max(worst["epoch_acc"],
                                     abs(ea["acc_all"] - eb["acc_all"]))
            worst["epoch_loss"] = max(worst["epoch_loss"],
                                      abs(ea["loss"] - eb["loss"]))
    ok &= (worst["val_acc"] <= 1e-5 and worst["acc_all"] <= 1e-6
           and worst["epoch_acc"] <= 1e-6 and worst["epoch_loss"] <= 1e-4)
    check(ok, f"(b) vmapped CV differs from the sequential CV: {worst}")
    res["vmap_vs_sequential_worst"] = worst
    seconds["b"] = time.perf_counter() - t0

    # (d) bf16 steps: graph against eager, finite
    t0 = time.perf_counter()
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    a, b = FusionTrainer(bcfg, device=dev.type), FusionTrainer(
        bcfg, device=dev.type)
    sa, sb = a.init_state(), b.init_state()
    dv = a._device_cohort(ds)
    bs = cfg.batch_size
    idx = torch.randint(0, len(ds["labels"]), (2, bs), generator=g,
                        device=dev)
    masks = generate_modal_masks(g, 2 * bs, 4).view(2, bs, 4)
    call = a._batch_step(sa, dv["feats"], dv["labels"], bs, True)
    same = True
    for i in range(2):
        ma = call(idx[i], masks[i], torch.ones(bs, device=dev),
                  a._lr_arg(cfg.lr))
        mb = b.train_step_fn()(
            sb, {m: v.index_select(0, idx[i]) for m, v in dv["feats"].items()},
            dv["labels"].index_select(0, idx[i]), masks[i],
            torch.ones(bs, device=dev), b._lr_arg(cfg.lr), True)
        same &= all(torch.equal(ma[k], mb[k]) for k in ma)
        same &= math.isfinite(float(ma["loss"]))
    same &= all(torch.equal(v, sb.model.state_dict()[k])
                for k, v in sa.model.state_dict().items())
    check(same, "(d) the bf16 sequential step's graph differs from eager "
          "or its loss is not finite")
    check(stacked_graph_vs_eager(torch, bcfg, ds, 3, dev, g),
          "(d) bf16 stacked graph replays differ from the eager steps")
    res["bf16_graph_equals_eager"] = {"sequential": True, "stacked": True,
                                      "loss": float(ma["loss"])}
    del a, b, sa, sb, call
    seconds["d"] = time.perf_counter() - t0

    # (c) group widths: the stacked step and the engine
    widths_out = {}
    for width in widths:
        t0 = time.perf_counter()
        widths_out[width] = vmap_width(torch, cfg, ds, dev, width, g, card,
                                       timing)
        seconds[f"c{width}"] = time.perf_counter() - t0
    res["widths"] = widths_out
    res["seconds"] = seconds
    return res


def fusion_phase(torch, card, n=1758, dim=None, hidden=None, device="cuda",
                 timing=True):
    """The fusion classifier (``FusionTrainConfig()``: four modalities,
    in_features 1024, hidden 512, 4 classes, batch 8) on a synthetic
    1,758-patient cohort on the card: ``FusionPredictor`` against the same
    weights on the CPU, 8 graph-replayed train steps against 8 eager ones
    bit for bit, the steps' readings, ``cross_validate`` for 2 folds x 3
    epochs.  ``dim``/``hidden``/``timing`` shrink it for a CPU
    rehearsal."""
    import dataclasses
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import profile
    from cervical_tpu_torch.config import FusionTrainConfig
    from cervical_tpu_torch.data.masks import generate_modal_masks
    from cervical_tpu_torch.inference.fusion_predictor import FusionPredictor
    from cervical_tpu_torch.train.fusion_trainer import FusionTrainer

    cfg = FusionTrainConfig(epochs=3)
    check((cfg.modalities, cfg.in_features, cfg.hidden, cfg.num_classes,
           cfg.batch_size, cfg.kfold, cfg.dtype) ==
          (("imgN", "imgA", "imgL", "cli"), 1024, 512, 4, 8, 5, "float32"),
          "FusionTrainConfig defaults")
    if dim is not None:
        cfg = dataclasses.replace(cfg, in_features=dim, hidden=hidden)
    dev = torch.device(device)
    ds = synthetic_cohort(torch, n, cfg.in_features, 7, dev)
    res = {"config": "FusionTrainConfig() 4-modal in 1024 hidden 512, "
                     f"{n} synthetic patients", "card": card}

    # serving: the card against the CPU on the same weights (96 patients at
    # batch 64: the CPU forward is the slow side), then patients/s at 512
    seconds = {}
    t0 = time.perf_counter()
    tr = FusionTrainer(cfg, device=device)
    sd = tr.init_state(torch.Generator().manual_seed(11)).model.state_dict()
    sd_cpu = {k: v.cpu() for k, v in sd.items()}
    n_srv = 96
    feats = {m: v[:n_srv].cpu().numpy() for m, v in ds["feats"].items()}
    present = np.ones((n_srv, 4), bool)
    present[::3, 2] = False
    present[1::7, 0] = False
    got = FusionPredictor(cfg, sd, batch_size=64, device=device
                          ).predict_proba(feats, present)
    ref = FusionPredictor(cfg, sd_cpu, batch_size=64, device="cpu"
                          ).predict_proba(feats, present)
    err = max(float(np.abs(got[k] - ref[k]).max()) for k in ref)
    check(err < 1e-4, f"FusionPredictor card against CPU: {err} >= 1e-4")
    res["predictor_card_vs_cpu_max_abs"] = err
    if timing:
        res["predictor_patients_per_s"] = FusionPredictor(
            cfg, sd, device=device).get_throughput(512, 20)
    seconds["serve"] = time.perf_counter() - t0

    # 8 graph replays against 8 eager steps, twin states, dropout on
    a, b = FusionTrainer(cfg, device=device), FusionTrainer(cfg, device=device)
    sa, sb = a.init_state(), b.init_state()
    dv = a._device_cohort(ds)
    bs = cfg.batch_size
    g = torch.Generator(dev).manual_seed(3)
    idx = torch.randint(0, n, (8, bs), generator=g, device=dev)
    masks = generate_modal_masks(g, 8 * bs, 4).reshape(8, bs, 4)
    w = torch.ones((8, bs), device=dev)
    w[7, 5:] = 0
    t0 = time.perf_counter()
    call = a._batch_step(sa, dv["feats"], dv["labels"], bs, True)
    step = b.train_step_fn()

    def eager(i):
        return step(sb, {m: v.index_select(0, idx[i])
                         for m, v in dv["feats"].items()},
                    dv["labels"].index_select(0, idx[i]), masks[i], w[i],
                    b._lr_arg(cfg.lr), True)
    same = True
    for i in range(8):
        ma = call(idx[i], masks[i], w[i], a._lr_arg(cfg.lr))
        mb = eager(i)
        same &= all(torch.equal(ma[k], mb[k]) for k in ma)
    ma_sd, mb_sd = sa.model.state_dict(), sb.model.state_dict()
    same &= all(torch.equal(v, mb_sd[k]) for k, v in ma_sd.items())
    xa = sa.opt_state["params"].state_dict()["state"]
    xb = sb.opt_state["params"].state_dict()["state"]
    same &= all(torch.equal(torch.as_tensor(xa[i][k]),
                            torch.as_tensor(xb[i][k]))
                for i in xa for k in xa[i])
    check(same and sa.step == sb.step == 8,
          "8 graph-replayed fusion steps differ from 8 eager steps")
    res["graph_equals_eager_8_steps"] = True
    seconds["graph_vs_eager"] = time.perf_counter() - t0

    if timing:
        t0 = time.perf_counter()

        def run(n_steps, one):
            def go():
                for i in range(n_steps):
                    one(i % 8)
            return go
        graph_run = run(16, lambda i: call(idx[i], masks[i], w[0],
                                           a._lr_arg(cfg.lr)))
        for name, steps, go in (("graph", 16, graph_run),
                                ("eager", 8, run(8, eager))):
            ms, busy, idle = timed_steps(torch, profile, DeviceType, go,
                                         steps)
            res[f"{name}_step"] = {"step_ms": ms, "patients_per_s":
                                   bs * 1e3 / ms,
                                   "device_busy_ms_per_step": busy,
                                   "idle_share": idle}
        res["graph_step_top_kernels"] = top_kernels(torch, profile,
                                                    DeviceType, graph_run, 16)
        seconds["step_timing"] = time.perf_counter() - t0
        # one epoch over the whole cohort, graph replays, after a warm one
        t0 = time.perf_counter()
        tr2 = FusionTrainer(cfg, device=device)
        st2 = tr2.init_state()
        tr2.train_epoch(st2, dv, 1, cfg.lr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = tr2.train_epoch(st2, dv, 2, cfg.lr)
        res["cohort_epoch_s"] = time.perf_counter() - t0
        res["cohort_epoch_steps"] = -(-n // bs)
        check(math.isfinite(rep["loss"]), f"cohort epoch loss {rep['loss']}")
        del tr2, st2
        seconds["cohort_epochs"] = time.perf_counter() - t0
    del a, b, sa, sb, call

    # cross-validation: folds 0 and 1 of the 5, 3 epochs each
    cv = FusionTrainer(cfg, device=device)
    logged = []

    def log(msg):
        logged.append((time.perf_counter(), msg))
        if msg.startswith("seed 0 fold 1: test acc"):
            cv.request_stop()
    t0 = time.perf_counter()
    out = cv.cross_validate(ds, log=log)
    res["cv_seconds"] = time.perf_counter() - t0
    train_acc = [float(m.split("train acc ")[1].split()[0])
                 for _, m in logged if " epoch 3: train acc" in m]
    check(out["stopped_early"] and len(out["folds"]) == 2 and
          len(train_acc) == 2, f"CV did not stop after 2 folds: {logged}")
    check(min(train_acc) > 0.7,
          f"fused train accuracy {train_acc} not above 0.7")
    res["cv_train_acc"] = train_acc
    res["cv_test_acc"] = [f["test"]["acc_all"] for f in out["folds"]]
    ends = [t for t, m in logged if ": test acc" in m]
    res["cv_fold_seconds"] = [e - s for s, e in zip([t0] + ends, ends)]
    seconds["cv"] = res["cv_seconds"]
    res["seconds"] = seconds
    res["vmap"] = fusion_vmap(torch, cfg, ds, dev, card, timing=timing)
    for key in ("graph_step", "eager_step"):
        if key in res:
            r = res[key]
            print(f"fusion {key.split('_')[0]} step: {r['step_ms']:.3f} "
                  f"ms/step = {r['patients_per_s']:.1f} patients/s, idle "
                  + ("not measured" if r["idle_share"] is None
                     else f"{r['idle_share']:.4f}") + f" ({card})")
    if timing:
        print(f"fusion predictor: {res['predictor_patients_per_s']:.1f} "
              f"patients/s at batch 512; cohort epoch ({n} patients, "
              f"{res['cohort_epoch_steps']} steps) "
              f"{res['cohort_epoch_s']:.3f} s ({card})")
    print(f"fusion CV: 2 folds x 3 epochs in {res['cv_seconds']:.1f} s, "
          f"train acc {train_acc}, test acc {res['cv_test_acc']}")
    print("fusion " + json.dumps(res))
    return res


def mobilenet_phase(torch, g, card, xception=None, input_shape=(512, 512),
                    image_hw=(960, 1280), n_train=136, n_val=16,
                    device="cuda", timing=True):
    """The MobileNetV2 DeepLab (os16, 5 classes, bf16, seeded weights):
    ``SegPredictor.predict_masks`` against the same weights in f32, its
    images/s beside Xception's (``xception``: the predictor phase's
    readings), the fused path refused; ``SegTrainer`` on
    ``SegTrainConfig(backbone="mobilenet")`` for an unfrozen and a frozen
    epoch, 8 graph-replayed steps against 8 eager ones, ms/step and the
    idle share; ``export_program`` at batch 1 against the eager forward.
    ``input_shape``/``image_hw``/``n_train``/``timing`` shrink it for a CPU
    rehearsal."""
    import dataclasses
    import gc
    import tempfile
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import profile
    from cervical_tpu_torch.config import SegTrainConfig
    from cervical_tpu_torch.data.voc import ArraySegDataset, BatchLoader
    from cervical_tpu_torch.inference.predictor import SegPredictor
    from cervical_tpu_torch.ops import middle_flow as MF
    from cervical_tpu_torch.ops import warp as W
    from cervical_tpu_torch.train.seg_trainer import SegTrainer, build_model

    cfg = SegTrainConfig(backbone="mobilenet")
    check((cfg.downsample_factor, cfg.data.num_classes, cfg.dtype,
           cfg.data.aug_backend, cfg.steps_per_call) ==
          (16, 5, "bfloat16", "einsum", 8), "SegTrainConfig defaults")
    cfg.data.input_shape = input_shape
    h, w = input_shape
    dev = torch.device(device)
    res = {"config": f"mobilenet os16 {h}x{w} 5 classes bf16", "card": card}
    state = random_state(torch, build_model(cfg), g)
    MF.reset_launches()
    W.reset_launches()

    # serving: bf16 masks against the same weights in f32
    f32 = dataclasses.replace(cfg, dtype="float32")
    bf, fp = (SegPredictor(c, state, device=device) for c in (cfg, f32))
    n, batch = 16, 8
    images = torch.randint(0, 256, (n,) + tuple(image_hw) + (3,),
                           generator=g, dtype=torch.uint8).numpy()
    bf.predict_masks(images[:batch], batch)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    masks = bf.predict_masks(images, batch)
    dt = time.perf_counter() - t0
    ref = fp.predict_masks(images, batch)
    check(masks.shape == (n,) + tuple(image_hw) and
          int(masks.max()) < cfg.data.num_classes, f"masks {masks.shape}")
    agree = float((masks == ref).mean())
    probs, ref_probs = bf.predict_probs(images[0]), fp.predict_probs(images[0])
    pdiff = float(abs(probs - ref_probs).max())
    top2 = torch.from_numpy(ref_probs).topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1] > 2 * pdiff).numpy()
    flips = int((probs.argmax(-1) != ref_probs.argmax(-1))[decided].sum())
    print(f"mobilenet predict_masks: {n} images {image_hw} at batch {batch} "
          f"in {dt:.3f} s = {n / dt:.2f} images/s; bf16 vs f32 masks agree "
          f"on {agree:.6f} of pixels; probs max abs diff {pdiff:.4g}, "
          f"argmax flips {flips} on the {decided.mean():.4%} of pixels "
          f"whose f32 top-2 gap exceeds {2 * pdiff:.3g}")
    # random weights leave some pixels within the bf16 drift of a tie:
    # there the argmax may go either way; nowhere else
    check(flips == 0, f"{flips} bf16 argmax flips beyond the probs drift")
    check(agree >= 0.99, f"bf16/f32 masks agree on only {agree:.4f}")
    res.update({"predict_masks_img_s": n / dt, "mask_agreement_bf16_f32":
                agree, "probs_max_abs_diff": pdiff,
                "decided_share": float(decided.mean()),
                "decided_flips": flips})
    if timing:
        res["throughput_img_s"] = bf.get_throughput(batch)
        print(f"batched forward, batch {batch}: mobilenet "
              f"{res['throughput_img_s']:.1f} images/s ({card})")
        if xception is not None:
            res["xception_throughput_img_s"] = \
                xception["throughput_unfused_img_s"]
            print(f"  xception in this call: "
                  f"{xception['throughput_unfused_img_s']:.1f} images/s, "
                  f"with the K4 kernels "
                  f"{xception['throughput_fused_img_s']:.1f}")
    try:
        SegPredictor(cfg, state, fused_middle=True, device=device)
        refused = False
    except ValueError:
        refused = True
    check(refused, "a mobilenet SegPredictor took fused_middle=True")

    # export at batch 1: the loaded program against the eager forward
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as tmp:
        t0 = time.perf_counter()
        path = bf.export_program(os.path.join(tmp, "seg.pt2"))
        export_s = time.perf_counter() - t0
        program = torch.export.load(path).module()
        x = bf._stage(images[:1])
        with torch.no_grad():
            got = program(x)
        want = bf._run(x)
        err = float((got.float() - want.float()).abs().max())
        size = os.path.getsize(path)
    check(tuple(got.shape) == (1, h, w, 5) and err <= 1e-2,
          f"exported program against the eager forward: {err}")
    res["export"] = {"seconds": export_s, "bytes": size, "max_abs_err": err}
    print(f"export_program: {size / 2 ** 20:.1f} MiB in {export_s:.1f} s; "
          f"loaded program vs eager forward max abs {err:.3g}")
    del bf, fp, program
    gc.collect()
    torch.cuda.empty_cache()

    # training: an unfrozen and a frozen epoch, each batch once
    rng = np.random.default_rng(int(torch.randint(0, 2 ** 31, (1,),
                                                  generator=g)))
    tr_im = rng.integers(0, 256, (n_train, h, w, 3), dtype=np.uint8)
    tr_lb = rng.integers(0, 5, (n_train, h, w), dtype=np.uint8)
    va_im = rng.integers(0, 256, (n_val, h, w, 3), dtype=np.uint8)
    va_lb = rng.integers(0, 5, (n_val, h, w), dtype=np.uint8)
    train = ArraySegDataset(tr_im, tr_lb)
    val_loader = BatchLoader(ArraySegDataset(va_im, va_lb),
                             cfg.eval_batch_size, shuffle=False,
                             drop_last=False)
    k, bs = cfg.steps_per_call, cfg.unfreeze_batch_size
    trainer = SegTrainer(cfg, device=device)
    lr = trainer.lr_schedule(bs, cfg.unfreeze_epoch)(0)
    epochs = []
    for frozen in (False, True):
        b = cfg.freeze_batch_size if frozen else bs
        loader = BatchLoader(train, b, seed=9 + frozen)
        model = trainer.state.model
        snap = {q: p.detach().clone()
                for q, p in model.backbone.named_parameters()}
        adam = {id(p): {q: v.clone() for q, v in st.items()} for p, st in
                trainer.state.opt_state["backbone"].state.items()}
        step0 = trainer.state.step
        t0 = time.perf_counter()
        r = trainer.run_epoch(loader, val_loader, int(frozen), frozen, lr)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps = trainer.state.step - step0
        check(steps == len(loader) == n_train // b,
              f"{steps} steps for {len(loader)} batches")
        check(all(math.isfinite(v) for v in (r.train_loss, r.val_loss,
                                             r.train_f_score)),
              f"non-finite epoch metrics {r}")
        if frozen:
            same = all(torch.equal(p, snap[q])
                       for q, p in model.backbone.named_parameters())
            same_adam = all(
                torch.equal(v, adam[id(p)][q]) for p, st in
                trainer.state.opt_state["backbone"].state.items()
                for q, v in st.items())
            check(same and same_adam, "the frozen mobilenet epoch moved the "
                  "backbone's params or its Adam state")
        print(f"mobilenet run_epoch (frozen={frozen}, batch {b}): {steps} "
              f"steps, eval of {n_val}, {dt:.3f} s; loss {r.train_loss:.5f} "
              f"val {r.val_loss:.5f}")
        epochs.append({"frozen": frozen, "batch": b, "steps": steps,
                       "seconds": dt, "train_loss": r.train_loss,
                       "val_loss": r.val_loss})
    res["epochs"] = epochs
    hist = trainer.evaluate_miou(val_loader)["hist"]
    check(int(hist.sum()) == n_val * h * w, f"mIoU matrix counts "
          f"{int(hist.sum())} pixels, expected {n_val * h * w}")
    xk = torch.from_numpy(tr_im[:k * bs].reshape(k, bs, h, w, 3)).to(dev)
    lk = torch.from_numpy(tr_lb[:k * bs].reshape(k, bs, h, w)).to(dev)
    if timing:
        m, bz, i = timed_steps(torch, profile, DeviceType,
                               lambda: trainer.train_steps(xk, lk, False, lr),
                               k)
        res["graph_call"] = {"step_ms": m, "images_per_s": bs * 1e3 / m,
                             "device_busy_ms_per_step": bz, "idle_share": i}
        print(f"mobilenet {k}-step graph call: {m:.3f} ms/step = "
              f"{bs * 1e3 / m:.1f} images/s, busy {bz:.3f} ms, idle "
              + ("not measured" if i is None else f"{i:.4f}") + f" ({card})")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # 8 graph replays against 8 eager steps from one seed
    tg, te = SegTrainer(cfg, device=device), SegTrainer(cfg, device=device)
    mg = tg.train_steps(xk, lk, False, lr)["loss"]
    me = torch.stack([te.train_step(xk[i], lk[i], False, lr)["loss"]
                      for i in range(k)])
    torch.cuda.synchronize()
    same_model, same_adam = states_equal(torch, tg.state, te.state)
    bitwise = bool(torch.equal(mg, me)) and same_model and same_adam
    check(bitwise and tg.state.step == te.state.step == k,
          f"mobilenet: {k} graph-replayed steps differ from {k} eager steps "
          f"(losses {torch.equal(mg, me)}, model {same_model}, Adam "
          f"{same_adam})")
    res["graph_vs_eager_bitwise"] = bitwise
    launches = {**W.LAUNCHES, **MF.LAUNCHES}
    check(sum(launches.values()) == 0, f"the mobilenet path launched "
          f"kernels {launches}")
    print(f"mobilenet graph against eager, {k} steps: bitwise {bitwise}; "
          f"kernel launches {launches}")
    del tg, te
    gc.collect()
    torch.cuda.empty_cache()
    print("mobilenet " + json.dumps(res))
    return res


def featurize_phase(torch, card, depth=101, n_patients=24, image_size=512,
                    device="cuda", timing=True):
    """The patch featurizer and the cohort builder: ``PatchFeaturizer``
    (ResNet-``depth``, 256² patches, 1024-d, fp32, seeded weights) on the
    card against the CPU, its patches/s at 16 and 128; then
    ``n_patients`` synthetic patients x 3 modalities of ``image_size``²
    PNGs (one patient without ``imgL``) through the ``build_graphs``
    CLI's folder walk, ``build_cli_features``, ``assemble_cohort`` and
    ``save_npz``; the ``train_fusion`` CLI on that cohort for 2 epochs and
    ``predict_fusion`` on its best params; ``eval_miou`` in dirs mode."""
    import shutil
    import tempfile
    import numpy as np
    from PIL import Image
    from cervical_tpu_torch.build_graphs import featurize_folders
    from cervical_tpu_torch.data.fusion_data import load_npz, save_npz
    from cervical_tpu_torch.data.graphs import (PatchFeaturizer,
                                                assemble_cohort,
                                                build_cli_features)
    from cervical_tpu_torch.ops import middle_flow as MF
    from cervical_tpu_torch.ops import warp as W

    res = {"config": f"ResNet-{depth} 256x256 patches -> 1024, fp32",
           "card": card}
    seconds = {}
    MF.reset_launches()
    W.reset_launches()
    t0 = time.perf_counter()
    feat = PatchFeaturizer(depth=depth, seed=0, device=device)
    cpu = PatchFeaturizer(depth=depth, state={
        q: v.cpu() for q, v in feat.model.state_dict().items()}, device="cpu")
    g = torch.Generator().manual_seed(12)
    patches = torch.randint(0, 256, (4, 256, 256, 3), generator=g,
                            dtype=torch.uint8).numpy()
    got, ref = feat(patches), cpu(patches)
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    check(got.shape == (4, 1024) and got.dtype == np.float32 and
          np.isfinite(got).all() and rel <= 1e-3,
          f"featurizer card against CPU: relative {rel}")
    res["card_vs_cpu_rel"] = rel
    print(f"PatchFeaturizer(depth={depth}) card vs CPU on 4 patches: max abs "
          f"diff {rel:.3g} of the largest feature")
    del cpu
    seconds["card_vs_cpu"] = time.perf_counter() - t0

    if timing:
        protocol = 1758 * 3 * 16
        for b in (16, 128):
            xs = torch.randint(0, 256, (b, 256, 256, 3), generator=g,
                               dtype=torch.uint8).numpy()
            feat(xs)  # warm-up: cuDNN picks its algorithms per shape
            runs = max(2, 256 // b)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(runs):
                feat(xs)
            rate = b * runs / (time.perf_counter() - t1)
            res[f"patches_per_s_batch{b}"] = rate
            res[f"protocol_seconds_batch{b}"] = protocol / rate
            print(f"featurizer batch {b}: {rate:.1f} patches/s (upload, "
                  f"forward and download, host clock) -> "
                  f"{protocol / rate:.1f} s for the protocol's {protocol} "
                  f"patches ({card})")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_featurize_")
    evaluator = None
    try:
        # a cohort from images: the CLI's folder walk, ages, save_npz
        t0 = time.perf_counter()
        rng = np.random.default_rng(13)
        ids = [f"P{i:03d}" for i in range(n_patients)]
        folders = {}
        for mod in ("imgN", "imgA", "imgL"):
            folders[mod] = os.path.join(tmp, mod)
            os.makedirs(folders[mod])
            for pid in ids:
                if mod == "imgL" and pid == ids[-1]:
                    continue
                low = rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)
                Image.fromarray(low).resize((image_size, image_size)).save(
                    os.path.join(folders[mod], f"{pid}_{mod}.png"),
                    compress_level=1)
        seconds["write_pngs"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lines = []
        image_feats = featurize_folders(feat, ids, folders, log=lines.append)
        torch.cuda.synchronize()
        seconds["featurize_images"] = time.perf_counter() - t0
        check(len(lines) == 3 * n_patients - 1, f"{len(lines)} images")
        ages = {pid: int(a) for pid, a in
                zip(ids, rng.integers(20, 70, n_patients))}
        diagnosis = {pid: i % 4 for i, pid in enumerate(ids)}
        ds = assemble_cohort(image_feats, build_cli_features(ages), diagnosis)
        cohort = os.path.join(tmp, "cohort.npz")
        save_npz(cohort, ds)
        back = load_npz(cohort)
        check(back["ids"] == sorted(ids) and
              int((~back["present"]).sum()) == 1 and
              not back["present"][-1, 2] and
              all(v.shape == (n_patients, 4 if m == "cli" else 16, 1024)
                  and np.isfinite(v).all() for m, v in back["feats"].items()),
              "the cohort npz")
        print(f"cohort: {n_patients} patients, {len(lines)} images "
              f"featurized in {seconds['featurize_images']:.1f} s; present "
              f"{back['present'].sum(0).tolist()}")

        env = dict(os.environ, PYTHONPATH=HERE)
        dev_args = ["--device", device]

        # eval_miou in dirs mode on two PNG folders, on the host, in a
        # process of its own beside the fusion CLIs
        names = [f"m{i}" for i in range(6)]
        for d in ("gt", "pred"):
            os.makedirs(os.path.join(tmp, d))
            for name in names:
                Image.fromarray(rng.integers(0, 5, (96, 128)).astype(
                    np.uint8)).save(os.path.join(tmp, d, name + ".png"))
        with open(os.path.join(tmp, "ids.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
        t_eval = time.perf_counter()
        evaluator = subprocess.Popen(
            [sys.executable, "-m", "cervical_tpu_torch.eval_miou",
             "--gt_dir", os.path.join(tmp, "gt"), "--pred_dir",
             os.path.join(tmp, "pred"), "--ids", os.path.join(tmp, "ids.txt"),
             "--miou_out", os.path.join(tmp, "miou")], cwd=HERE, env=env,
            text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

        # train_fusion on it for 2 epochs, then predict_fusion
        out_dir = os.path.join(tmp, "fusion")

        def run(args, timeout):
            t = time.perf_counter()
            r = subprocess.run([sys.executable, "-m"] + args, cwd=HERE,
                               env=env, capture_output=True, text=True,
                               timeout=timeout)
            return r, time.perf_counter() - t
        r, seconds["train_fusion"] = run(
            ["cervical_tpu_torch.train_fusion", "--cohort", cohort,
             "--epochs", "2", "--save_dir", out_dir] + dev_args, 600)
        losses = []  # train and val loss of each epoch of each fold
        for name in sorted(os.listdir(out_dir) if r.returncode == 0 else []):
            if name.endswith("_metrics.txt"):
                with open(os.path.join(out_dir, name)) as f:
                    losses += [float(v) for line in f
                               for v in line.split("\t")[1:3]]
        check(r.returncode == 0 and len(losses) == 2 * 2 * 5 and
              all(math.isfinite(v) for v in losses),
              f"train_fusion exit {r.returncode}; losses {losses}; tail:\n"
              f"{(r.stdout + r.stderr)[-3000:]}")
        r2, seconds["predict_fusion"] = run(
            ["cervical_tpu_torch.predict_fusion", "--cohort", cohort,
             "--params", os.path.join(out_dir, "best_seed0_fold0.npz"),
             "--out", os.path.join(tmp, "preds.json")] + dev_args, 300)
        check(r2.returncode == 0, f"predict_fusion exit {r2.returncode}: "
              f"{(r2.stdout + r2.stderr)[-3000:]}")
        with open(os.path.join(tmp, "preds.json")) as f:
            preds = json.load(f)
        check(len(preds["classes"]) == n_patients and
              all(math.isfinite(p) for row in preds["probs"] for p in row),
              "predict_fusion's report")
        res["train_fusion_losses"] = [min(losses), max(losses)]
        res["predict_fusion_accuracy"] = preds.get("accuracy")
        print(f"train_fusion (5 folds x 2 epochs, {len(losses)} losses, all "
              f"finite) in {seconds['train_fusion']:.1f} s; predict_fusion "
              f"in {seconds['predict_fusion']:.1f} s, accuracy "
              f"{preds.get('accuracy')}")

        text, _ = evaluator.communicate(timeout=300)
        seconds["eval_miou"] = time.perf_counter() - t_eval
        with open(os.path.join(tmp, "miou", "confusion_matrix.csv")) as f:
            rows = [row.split(",")[1:] for row in f.read().splitlines()[1:]]
        total = sum(int(v) for row in rows for v in row)
        check(evaluator.returncode == 0 and total == 6 * 96 * 128 and
              "===> mIoU" in text, f"eval_miou exit {evaluator.returncode}, "
              f"matrix sum {total}: {text[-2000:]}")
        print(f"eval_miou dirs mode: the matrix counts {total} pixels")
    finally:
        if evaluator is not None and evaluator.poll() is None:
            evaluator.kill()
            evaluator.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {**W.LAUNCHES, **MF.LAUNCHES}
    check(sum(launches.values()) == 0, f"the featurize path launched kernels "
          f"{launches}")
    res["seconds"] = seconds
    print("featurize " + json.dumps(res))
    return res


def codec_headers():
    """Whether ``g++`` compiles a file that includes libjpeg's and libpng's
    headers (the native loader's build needs both, and their libraries)."""
    try:
        r = subprocess.run(["g++", "-fsyntax-only", "-x", "c++", "-"],
                           input="#include <cstdio>\n#include <jpeglib.h>\n"
                           "#include <png.h>\n", capture_output=True,
                           text=True, timeout=60)
    except OSError:
        return False
    return r.returncode == 0


def prepare_phase(torch, W, card, defaults=None, n_pairs=64, size=512,
                  n_prep=12, n_5x=32, batch=16, device="cuda", timing=True):
    """The data-preparation path; see the module docstring.  (a) the native
    loader against PIL, its images/s, its planar batch through K1-K3;
    (b) the ``prepare_dataset`` CLI and an unfrozen epoch read natively
    from its output; (c) ``fivefold_augment`` card against CPU, its
    images/s, ``write_multimodal_augmented``; (d) a ``utils.profiling``
    trace of two train steps and its span table.  ``defaults``: the
    defaults phase's readings, printed beside the decode rates."""
    import shutil
    import tempfile
    import numpy as np
    from PIL import Image
    from cervical_tpu_torch import native
    from cervical_tpu_torch.config import SegTrainConfig
    from cervical_tpu_torch.data.voc import (BatchLoader, VOCSegDataset,
                                             make_synthetic_voc, read_split)
    from cervical_tpu_torch.ops.augment import sample_augment_params
    from cervical_tpu_torch.ops.histeq import fivefold_augment
    from cervical_tpu_torch.tools.offline_aug import write_multimodal_augmented
    from cervical_tpu_torch.train.seg_trainer import SegTrainer
    from cervical_tpu_torch.utils.profiling import trace

    res = {"card": card}
    seconds = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_prepare_")

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()
    try:
        # (a) the loader
        t0 = time.perf_counter()
        root = make_synthetic_voc(os.path.join(tmp, "voc"),
                                  num_images=n_pairs, size=size)
        seconds["write_voc"] = time.perf_counter() - t0
        ids = sorted(f[:-4] for f in os.listdir(
            os.path.join(root, "VOC2007", "JPEGImages")))
        gxx = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True).stdout.splitlines()[:1] \
            if shutil.which("g++") else ["g++ not found"]
        headers = codec_headers()
        have = native.available()
        res["native"] = {"available": have, "codec_headers": headers,
                         "reason": native.unavailable_reason(),
                         "gxx": gxx[0] if gxx else ""}
        print(f"native loader: available {have}"
              + ("" if have else f" ({native.unavailable_reason()})")
              + f"; codec headers {'found' if headers else 'missing'}; "
              f"{gxx[0] if gxx else ''}")
        check(have or not headers, "the codecs' headers are installed but "
              f"the native loader did not build: "
              f"{native.unavailable_reason()}")
        pil = VOCSegDataset(root, ids, (size, size), use_native=False)
        nat = VOCSegDataset(root, ids, (size, size), use_native=True)
        every = np.arange(len(ids))
        ref_i, ref_l = pil.load_batch(every)
        if have:
            jpgs, pngs = zip(*(nat.paths(i) for i in every))
            imgs, lbls, fails = native.load_batch(list(jpgs), list(pngs),
                                                  (size, size))
            pimgs, plbls, pfails = native.load_batch(
                list(jpgs), list(pngs), (size, size), planar=True)
            mad = np.abs(imgs.astype(np.int16) - ref_i).mean(axis=(1, 2, 3))
            check(fails == 0 and pfails == 0 and np.array_equal(lbls, ref_l)
                  and np.array_equal(plbls, ref_l) and bool((mad < 3).all())
                  and np.array_equal(pimgs, imgs.transpose(0, 3, 1, 2)),
                  f"native against PIL: failures {fails}/{pfails}, labels "
                  f"equal {np.array_equal(lbls, ref_l)}, image mean abs "
                  f"diff max {mad.max()}")
            res["native"]["max_image_mean_abs_diff"] = float(mad.max())
            print(f"native decode of {len(ids)} {size}² pairs against PIL: "
                  f"labels equal, images mean |diff| <= {mad.max():.4f} "
                  f"counts, planar = NHWC transposed")

        def rate(fn, reps=2):
            fn()  # first pass: sidecars written, files in the page cache
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            return reps * len(ids) / (time.perf_counter() - t)
        chunks = [every[i:i + batch] for i in range(0, len(ids), batch)]
        decode = {"batch": batch, "threads": native.default_threads(),
                  "pil_images_per_s": rate(lambda: [pil.load_batch(c)
                                                    for c in chunks])}
        if have:
            decode["native_images_per_s"] = rate(
                lambda: [nat.load_batch(c) for c in chunks])
            decode["native_loader_4_workers_images_per_s"] = rate(
                lambda: list(BatchLoader(nat, batch, shuffle=False)))
        decode["pil_loader_4_workers_images_per_s"] = rate(
            lambda: list(BatchLoader(pil, batch, shuffle=False)))
        if defaults and "graph_call" in defaults:
            decode["defaults_graph_call_images_per_s"] = \
                defaults["graph_call"]["images_per_s"]
        res["decode"] = decode
        print(f"decode at batch {batch}, {size}²: " + ", ".join(
            f"{k} {v:.1f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in decode.items()) + f" ({card})")

        # the planar batch as the native loader emits it (without the
        # library: PIL's batch made planar on the host)
        src = "native" if have else "PIL, transposed on the host"
        if not have:
            imgs, lbls = ref_i, ref_l
            pimgs = np.ascontiguousarray(imgs.transpose(0, 3, 1, 2))
        x = torch.from_numpy(pimgs[:batch]).to(device)
        lab = torch.from_numpy(lbls[:batch]).to(device)
        p = sample_augment_params(torch.Generator().manual_seed(5), batch)
        W.reset_launches()
        gi, gl = W.augment_batch_kernels(x, lab, p, (size, size),
                                         planar=True)
        sync()
        planar_launches = dict(W.LAUNCHES)
        ri, rl = W.augment_batch_kernels(
            torch.from_numpy(imgs[:batch]).to(device), lab, p, (size, size))
        check(torch.equal(gi, ri) and torch.equal(gl, rl),
              "augment_batch_kernels(planar=True) differs from the NHWC call")
        if device != "cpu":
            check(all(planar_launches[k] == 1 for k in TRAIN_KERNELS)
                  and planar_launches["warp_photo_images"] == 0,
                  f"the planar call launched {planar_launches}")
        res["planar"] = {"source": src, "launches": planar_launches}
        print(f"augment_batch_kernels(planar=True) on the {src} planar "
              f"batch = the NHWC call bit for bit; launches "
              f"{planar_launches}")

        # (b) dataset preparation: colour masks -> ids, splits, 8x, audit
        t0 = time.perf_counter()
        src = make_synthetic_voc(os.path.join(tmp, "prep"), num_images=n_prep,
                                 size=size)
        seg = os.path.join(src, "VOC2007", "SegmentationClass")
        colors = os.path.join(tmp, "colors")
        os.makedirs(colors)
        palette = np.array([[0, 0, 0], [255, 255, 0], [255, 0, 0],
                            [0, 255, 0], [0, 0, 255]], np.uint8)
        gray = {}
        for name in sorted(os.listdir(seg)):
            gray[name] = np.asarray(Image.open(os.path.join(seg, name)))
            Image.fromarray(palette[gray[name]]).save(
                os.path.join(colors, name))
        shutil.rmtree(seg)
        shutil.rmtree(os.path.join(src, "VOC2007", "ImageSets"))
        aug = os.path.join(tmp, "prep_aug")
        r = subprocess.run(
            [sys.executable, "-m", "cervical_tpu_torch.prepare_dataset",
             "--colors_dir", colors, "--gray_dir", seg, "--split_root", src,
             "--ratios", "8,1,1", "--augment_root", src, "--augment_out", aug,
             "--audit", aug], cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
            capture_output=True, text=True, timeout=600)
        seconds["prepare_dataset"] = time.perf_counter() - t0
        out = r.stdout + r.stderr
        check(r.returncode == 0 and "WARNING" not in out,
              f"prepare_dataset exit {r.returncode}:\n{out[-3000:]}")
        ids_back = {n: np.asarray(Image.open(os.path.join(seg, n)))
                    for n in gray}
        check(all(np.array_equal(ids_back[n], g) for n, g in gray.items()),
              "the class-id masks differ from the colours' ids")
        n_tv = len(read_split(src, "train")) + len(read_split(src, "val"))
        a_train, a_val = read_split(aug, "train"), read_split(aug, "val")
        on_disk = [os.path.exists(os.path.join(aug, "VOC2007", d, i + e))
                   for i in a_train + a_val
                   for d, e in (("JPEGImages", ".jpg"),
                                ("SegmentationClass", ".png"))]
        check(len(a_train) + len(a_val) == 8 * n_tv and all(on_disk),
              f"augmented layout: {len(a_train)} + {len(a_val)} ids for "
              f"{n_tv} train+val ids")
        hist = {}
        for i in a_train + a_val:
            m = np.asarray(Image.open(os.path.join(
                aug, "VOC2007", "SegmentationClass", i + ".png")))
            for v in np.unique(m).tolist():
                hist[v] = hist.get(v, 0) + 1
        check(set(hist) <= set(range(5)), f"augmented class ids {hist}")
        res["prepare_dataset"] = {"seconds": seconds["prepare_dataset"],
                                  "train_val_ids": n_tv,
                                  "augmented": len(a_train) + len(a_val)}
        print(f"prepare_dataset CLI ({n_prep} colour masks -> ids, splits "
              f"8,1,1, 8x of {n_tv} train+val ids, audit): "
              f"{seconds['prepare_dataset']:.1f} s ({card}), no warning; "
              + " | ".join(line for line in out.splitlines()
                           if line.startswith(("splits", "augmented"))))

        cfg = SegTrainConfig()
        cfg.data.aug_backend = "pallas"
        cfg.data.input_shape = (size, size)
        train = VOCSegDataset(aug, a_train, (size, size), use_native=True)
        val = VOCSegDataset(aug, a_val, (size, size), use_native=True)
        bs = cfg.unfreeze_batch_size
        loader = BatchLoader(train, bs, seed=5)
        trainer = SegTrainer(cfg, device=device)
        lr = trainer.lr_schedule(bs, cfg.unfreeze_epoch)(0)
        W.reset_launches()
        t0 = time.perf_counter()
        ep = trainer.run_epoch(loader, BatchLoader(val, cfg.eval_batch_size,
                                                   shuffle=False,
                                                   drop_last=False),
                               0, False, lr)
        sync()
        seconds["epoch"] = time.perf_counter() - t0
        epoch_launches = dict(W.LAUNCHES)
        steps = len(loader)
        check(math.isfinite(ep.train_loss) and math.isfinite(ep.val_loss),
              f"non-finite epoch losses {ep}")
        if device != "cpu":
            check(all(epoch_launches[k] == steps for k in TRAIN_KERNELS),
                  f"{steps} steps launched {epoch_launches}")
        if have:
            check(train.batches == {"native": steps, "pil": 0} and
                  val.batches["pil"] == 0,
                  f"decoders: train {train.batches}, val {val.batches}")
        res["epoch"] = {"steps": steps, "seconds": seconds["epoch"],
                        "train_loss": ep.train_loss, "val_loss": ep.val_loss,
                        "train_batches": dict(train.batches),
                        "val_batches": dict(val.batches),
                        "launches": epoch_launches}
        print(f"unfrozen epoch on the augmented VOC ({steps} steps, batch "
              f"{bs}, pallas): {seconds['epoch']:.2f} s ({card}), loss "
              f"{ep.train_loss:.5f} val {ep.val_loss:.5f}; decoders train "
              f"{train.batches} val {val.batches}; launches {epoch_launches}")

        # (d) profiling: a trace of two train steps and its spans
        xb, lb = train.load_batch(np.arange(bs))
        xb, lb = torch.from_numpy(xb).to(device), torch.from_numpy(lb).to(
            device)
        with trace(os.path.join(tmp, "trace")) as tr:
            for _ in range(2):
                m = trainer.train_step(xb, lb, False, lr)
                sync()
        with open(tr.path) as f:
            text = f.read()
        named = {k: k in text for k in TRAIN_KERNELS}
        check(math.isfinite(float(m["loss"])), "non-finite traced step")
        if device != "cpu":
            check(all(named.values()), f"the trace names {named}")
        calls = tr.spans.get("seg.call.train")
        check(calls is not None and calls.count == 2
              and "seg.call.train" in text, f"the trace's spans {tr.spans}")
        spans = {k: t._asdict() for k, t in tr.spans.items()}
        res["trace"] = {"mib": os.path.getsize(tr.path) / 2 ** 20,
                        "names": named, "spans": spans}
        print(f"profiling.trace of 2 train steps: {res['trace']['mib']:.2f} "
              f"MiB Chrome trace naming {named}; spans "
              f"{json.dumps(spans)} ({card})")
        del trainer

        # (c) the 5x multimodal augmentation, card against CPU
        rng = np.random.default_rng(6)
        yy, xx = np.mgrid[:size, :size]
        base = np.stack([xx, yy, (xx + yy) // 2], -1) * 255 // (2 * size)
        imgs5 = np.clip(base[None] + rng.integers(0, 128, (batch, 1, 1, 3))
                        + rng.integers(-12, 12, (batch, size, size, 3)),
                        0, 255).astype(np.uint8)
        angles = rng.integers(1, 46, batch).astype(np.float32)
        host = fivefold_augment(torch.from_numpy(imgs5).float(),
                                torch.from_numpy(angles))
        x5 = torch.from_numpy(imgs5).to(device).float()
        on_card = fivefold_augment(x5, torch.from_numpy(angles)).cpu()
        slots = ("equalized", "h-flip", "v-flip", "blur", "rotate")
        diff = {}
        for k, name in enumerate(slots):
            d = (on_card[k] - host[k]).abs()
            diff[name] = {"max_abs": float(d.max()),
                          "differing": int((d > 0).sum())}
        check(all(v["max_abs"] <= 1e-3 for v in diff.values()),
              f"fivefold_augment card against CPU: {diff}")
        res["fivefold_card_vs_cpu"] = diff
        print(f"fivefold_augment {tuple(imgs5.shape)} card against CPU "
              f"(of {on_card[0].numel()} values a slot): {json.dumps(diff)}")
        if timing:
            ms = cuda_ms(torch, lambda: fivefold_augment(
                x5, torch.from_numpy(angles)), 5, queued=False)
            res["fivefold_ms"] = ms
            res["fivefold_images_per_s"] = batch * 1e3 / ms
            print(f"fivefold_augment at batch {batch}, {size}²: {ms:.3f} ms "
                  f"= {batch * 1e3 / ms:.1f} images/s ({card})")
        mm = os.path.join(tmp, "mm")
        os.makedirs(mm)
        for i in range(n_5x):
            Image.fromarray(imgs5[i % batch]).save(
                os.path.join(mm, f"p{i:03d}.png"), compress_level=1)
        t0 = time.perf_counter()
        written = write_multimodal_augmented(mm, os.path.join(tmp, "mm5"),
                                             batch=batch, device=device)
        seconds["write_multimodal"] = time.perf_counter() - t0
        check(len(written) == 5 * n_5x and
              len(os.listdir(os.path.join(tmp, "mm5"))) == 5 * n_5x,
              f"write_multimodal_augmented wrote {len(written)} files")
        print(f"write_multimodal_augmented: {n_5x} PNGs -> {len(written)} "
              f"files in {seconds['write_multimodal']:.1f} s ({card})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["seconds"] = seconds
    print("prepare " + json.dumps(res))
    return res


def _file_store(tmp, name):
    """A ``file://`` rendezvous in ``tmp``: no TCP port to collide on."""
    return "file://" + os.path.join(tmp, name)


def adam_moments(tr):
    """A seg trainer's Adam first moments by param name, on the host."""
    names = {id(p): n for n, p in tr.state.model.named_parameters()}
    return {names[id(p)]: st["exp_avg"].detach().cpu()
            for opt in tr.state.opt_state.values()
            for p, st in opt.state.items()}


def fusion_cohort(spec):
    """The (c) cohort from the phase's ``spec.npz``."""
    return {"feats": {k[6:]: spec[k] for k in spec
                      if k.startswith("feats_")},
            "labels": spec["f_labels"], "present": spec["f_present"]}


def parallel_rank(rank, workdir):
    """One of the two gloo ranks of the ``parallel`` phase, both on the
    phase's device (``python3 chip_smoke.py --parallel-rank R --workdir
    D``): (b) one eager data-parallel step of the default seg config with
    the kernel augmentation on this rank's half of the batch, and a ragged
    eval pass; (c) two ``FusionTrainer.train_epoch`` epochs over a cohort
    of one batch at the reference widths, the model split over both ranks.
    Writes ``out{rank}.pt`` to ``workdir``."""
    import numpy as np
    import torch
    sys.path.insert(0, HERE)
    from cervical_tpu_torch import parallel as PP
    from cervical_tpu_torch.config import FusionTrainConfig, SegTrainConfig
    from cervical_tpu_torch.data.voc import ArraySegDataset, BatchLoader
    from cervical_tpu_torch.ops import warp as W
    from cervical_tpu_torch.train.fusion_trainer import FusionTrainer
    from cervical_tpu_torch.train.seg_trainer import SegTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = dict(np.load(os.path.join(workdir, "spec.npz")))
    dev = torch.device(str(spec["device"]))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    PP.initialize_multihost(_file_store(workdir, "store"), 2, rank,
                            backend="gloo", device=dev)
    out = {}
    cfg = SegTrainConfig()
    cfg.data.aug_backend = "pallas"
    cfg.data.input_shape = tuple(int(v) for v in spec["hw"])
    cfg.dtype = str(spec["seg_dtype"])
    tr = SegTrainer(cfg, device=dev, mesh=PP.make_mesh())
    xl, yl = PP.shard_batch((spec["images"], spec["labels"]), tr.mesh,
                            device=dev)
    W.reset_launches()
    sync()
    t0 = time.perf_counter()
    out["seg_loss"] = float(tr.train_step(xl, yl, False,
                                          float(spec["lr"]))["loss"])
    sync()
    out["seg_step_s"] = time.perf_counter() - t0
    out["seg_launches"] = dict(W.LAUNCHES)
    out["seg_state"] = {k: v.cpu() for k, v in
                        tr.state.model.state_dict().items()}
    out["seg_exp_avg"] = adam_moments(tr)
    val = ArraySegDataset(spec["val_images"], spec["val_labels"])
    loader = BatchLoader(val, 8, shuffle=False, drop_last=False)
    out["eval_pixels"] = int(tr.evaluate_miou(loader)["hist"].sum())
    del tr

    fcfg = FusionTrainConfig(dtype="float32", epoch0_no_step=False,
                             in_features=int(spec["f_in"]),
                             hidden=int(spec["f_hidden"]))
    ftr = FusionTrainer(fcfg, device=dev, mesh=PP.make_mesh(model_parallel=2))
    st = ftr.init_state()
    out["tp_sharded"] = len(st.model.tp_shards)
    out["tp_losses"], out["tp_step_s"] = [], []
    for e in range(2):
        sync()
        t0 = time.perf_counter()
        rep = ftr.train_epoch(st, fusion_cohort(spec), e, 1e-3)
        out["tp_losses"].append(rep["loss"])
        out["tp_step_s"].append(time.perf_counter() - t0)
    torch.save(out, os.path.join(workdir, f"out{rank}.pt"))
    PP.barrier("done")
    torch.distributed.destroy_process_group()
    return 0


def nccl_world1(torch, W, cfg, images, labels, lr, tmp, dev):
    """(a): the K-step seg call through the data-parallel path of a
    one-rank NCCL group, against the same call without a process group:
    bit for bit, K1-K3 counted, both timed in turns."""
    import gc
    import torch.distributed as dist
    from cervical_tpu_torch import parallel as PP
    from cervical_tpu_torch.train.seg_trainer import SegTrainer

    k = images.shape[0]
    xs = torch.from_numpy(images).to(dev)
    ys = torch.from_numpy(labels).to(dev)
    plain = SegTrainer(cfg, device=dev)
    PP.initialize_multihost(_file_store(tmp, "nccl"), 1, 0, backend="nccl",
                            device=dev)
    try:
        ddp = SegTrainer(cfg, device=dev, mesh=PP.make_mesh())
        check(ddp.graphed and dist.get_backend() == "nccl",
              "the NCCL trainer is not graphed")
        la = plain.train_steps(xs, ys, False, lr)["loss"]
        W.reset_launches()
        lb = ddp.train_steps(xs, ys, False, lr)["loss"]
        torch.cuda.synchronize()
        launches = dict(W.LAUNCHES)
        model_eq, adam_eq = states_equal(torch, plain.state, ddp.state)
        check(model_eq and adam_eq and torch.equal(la, lb),
              f"NCCL world-1 K-step call differs from the one-process call "
              f"(model {model_eq}, adam {adam_eq}, losses {la.tolist()} vs "
              f"{lb.tolist()})")
        for name in TRAIN_KERNELS:
            check(launches[name] == k, f"{name} launched {launches[name]} "
                  f"times in the {k}-step data-parallel call")
        ms = {"plain": [], "nccl": []}
        for tr, key in ((plain, "plain"), (ddp, "nccl"), (ddp, "nccl"),
                        (plain, "plain")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                m = tr.train_steps(xs, ys, False, lr)
            torch.cuda.synchronize()
            ms[key].append(1e3 * (time.perf_counter() - t0) / (3 * k))
        check(math.isfinite(float(m["loss"][-1])), "non-finite loss")
    finally:
        dist.destroy_process_group()
    h, w = images.shape[2:4]
    print(f"parallel (a) NCCL world 1, xception {h}x{w} batch "
          f"{images.shape[1]}, {k}-step graph calls: bit-identical to the "
          f"one-process call; ms/step one-process {ms['plain']}, "
          f"data-parallel {ms['nccl']}; launches {launches}")
    del plain, ddp, xs, ys
    gc.collect()
    torch.cuda.empty_cache()
    return {"equal": True, "launches": launches,
            "ms_per_step_plain": ms["plain"], "ms_per_step_nccl": ms["nccl"]}


def gloo_ranks(torch, cfg, fcfg, images, labels, val, lr, tmp, dev):
    """(b) and (c): two gloo ranks sharing the device, as child processes;
    their results held against the one-process seg step and the replicated
    fusion epochs."""
    import numpy as np
    from cervical_tpu_torch.data.fusion_data import make_synthetic_fusion
    from cervical_tpu_torch.train.fusion_trainer import FusionTrainer
    from cervical_tpu_torch.train.seg_trainer import SegTrainer

    fds = make_synthetic_fusion(num_patients=8, feature_dim=fcfg.in_features,
                                seed=5)
    feats = {m: np.asarray(v, np.float32) for m, v in fds["feats"].items()}
    np.savez(os.path.join(tmp, "spec.npz"), images=images, labels=labels,
             val_images=val[0], val_labels=val[1], lr=lr, device=str(dev),
             seg_dtype=cfg.dtype,
             hw=np.asarray(cfg.data.input_shape),
             f_in=fcfg.in_features, f_hidden=fcfg.hidden,
             f_labels=np.asarray(fds["labels"]),
             f_present=np.asarray(fds["present"]),
             **{f"feats_{m}": v for m, v in feats.items()})
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                 "--parallel-rank", str(r), "--workdir", tmp], cwd=HERE,
                text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks_s = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"gloo rank {r} exited {p.returncode}:\n"
              f"{log[-3000:]}")
    outs = [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(2)]
    s0, s1 = outs[0]["seg_state"], outs[1]["seg_state"]
    check(all(torch.equal(v, s1[n]) for n, v in s0.items()),
          "the two gloo ranks hold different params after the step")
    check(outs[0]["seg_loss"] == outs[1]["seg_loss"],
          "the two gloo ranks report different losses")

    # (b) against the one-process eager step on the whole batch, in f32
    # (in bf16 the two BatchNorm formulations' roundings flip the sign of
    # Adam's first step on 13-38% of elements, measured on the CPU): loss
    # to 1e-4 relative; Adam's first moments (0.1 x the gradients) to 5%
    # global relative L2 and their global norm to 1% of the one-process
    # step's; at most 1% of the updated elements moving the other way; the
    # running stats' updates to 1% global relative L2.  A gradient off by a
    # constant factor c (a missing or doubled divide by the rank count)
    # scales the moments' norm by c and moves them by |c - 1|: 0.5 and
    # more.  Rounding alone (two BatchNorm formulations, reduction orders)
    # moved them by 1.2% on the CPU at 64² and their norm by far less;
    # the one-process step run twice, printed beside, shows the card's own
    # spread.  (Adam's first step moves every element by about lr whatever
    # the gradient's scale, so the params alone cannot see the scale.)
    def one_process():
        ref = SegTrainer(cfg, device=dev)
        before = {n: v.detach().cpu().clone()
                  for n, v in ref.state.model.state_dict().items()}
        loss = float(ref.train_step(torch.from_numpy(images).to(dev),
                                    torch.from_numpy(labels).to(dev), False,
                                    lr)["loss"])
        names = [n for n, _ in ref.state.model.named_parameters()]
        return loss, before, {n: v.cpu() for n, v in
                              ref.state.model.state_dict().items()}, names, \
            adam_moments(ref)

    def compare(sa, sb, ma, mb, before, names):
        """(share of updated elements moving the other way, running-stat
        updates' relative L2, first moments' relative L2, the ratio of the
        first moments' norms) of two steps."""
        dg = torch.cat([(sa[n] - before[n]).double().flatten()
                        for n in names])
        dw = torch.cat([(sb[n] - before[n]).double().flatten()
                        for n in names])
        moved = dw != 0
        flips = float(((torch.sign(dg) != torch.sign(dw)) & moved).sum()
                      / moved.sum().clamp_min(1))
        run = [n for n in sb if "running" in n]
        ua = torch.cat([(sa[n] - before[n]).double().flatten() for n in run])
        ub = torch.cat([(sb[n] - before[n]).double().flatten() for n in run])
        xa = torch.cat([ma[n].double().flatten() for n in names])
        xb = torch.cat([mb[n].double().flatten() for n in names])
        return (flips, float((ua - ub).norm() / ub.norm().clamp_min(1e-30)),
                float((xa - xb).norm() / xb.norm().clamp_min(1e-30)),
                float(xa.norm() / xb.norm().clamp_min(1e-30)))

    rl, before, rsd, names, rm = one_process()
    rl2, _, rsd2, _, rm2 = one_process()
    floor = compare(rsd2, rsd, rm2, rm, before, names)
    flips, stat, mom, scale = compare(s0, rsd, outs[0]["seg_exp_avg"], rm,
                                      before, names)
    loss_rel = abs(outs[0]["seg_loss"] - rl) / abs(rl)
    print(f"  one-process step twice: losses {rl} / {rl2}; signs flipped "
          f"{floor[0]:.4f}, running stats {floor[1]:.3g}, first moments "
          f"{floor[2]:.3g}, their norms' ratio {floor[3]!r}")
    check(loss_rel <= 1e-4 and mom <= 0.05 and abs(scale - 1) <= 0.01
          and flips <= 0.01 and stat <= 0.01,
          f"gloo 2-rank step against the one-process step: loss rel "
          f"{loss_rel:.3g}, first moments {mom:.3g}, their norms' ratio "
          f"{scale!r}, update signs flipped {flips:.4f}, running-stat "
          f"updates {stat:.3g}")
    h, w = cfg.data.input_shape
    pixels = len(val[0]) * h * w
    for o in outs:
        check(o["eval_pixels"] == pixels, f"ragged eval counted "
              f"{o['eval_pixels']} pixels, expected {pixels}")
        for name in TRAIN_KERNELS:  # (the CPU takes the plain versions)
            check(dev.type != "cuda" or o["seg_launches"][name] == 1,
                  f"{name} launched {o['seg_launches'][name]} times in a "
                  "rank's step")
    b = {"loss_rel": loss_rel, "exp_avg_rel_l2": mom,
         "exp_avg_norm_ratio": scale, "update_sign_flips": flips,
         "one_process_twice": floor, "running_stat_updates_rel_l2": stat,
         "step_s": [o["seg_step_s"] for o in outs],
         "ranks_seconds": ranks_s, "eval_pixels": pixels}
    print(f"parallel (b) gloo, 2 ranks on one device: params equal across "
          f"ranks; against the one-process step loss rel {loss_rel:.3g}, "
          f"first moments {mom:.3g} (norms' ratio {scale!r}), update signs "
          f"flipped {flips:.4f}, "
          f"running-stat updates {stat:.3g}; eager step "
          f"{[round(o['seg_step_s'], 3) for o in outs]} s; ragged eval "
          f"{pixels} pixels; both ranks in {ranks_s:.1f} s")

    # (c) the tensor-parallel epochs (one step each) against the replicated
    # ones: the same seeds, so the same weights, rows, MAE and dropout masks
    ftr = FusionTrainer(fcfg, device=dev)
    st = ftr.init_state()
    cohort = {"feats": feats, "labels": np.asarray(fds["labels"]),
              "present": np.asarray(fds["present"])}
    rep = [ftr.train_epoch(st, cohort, e, 1e-3)["loss"] for e in range(2)]
    tp = outs[0]["tp_losses"]
    rel = [abs(x - y) / abs(y) for x, y in zip(tp, rep)]
    check(tp == outs[1]["tp_losses"],
          "the two tensor-parallel ranks report different losses")
    check(rel[0] <= 1e-5 and rel[1] <= 1e-3 and outs[0]["tp_sharded"] >= 40,
          f"tensor-parallel losses {tp} against replicated {rep} (rel {rel});"
          f" {outs[0]['tp_sharded']} params sharded")
    c = {"tp_losses": tp, "replicated_losses": rep, "rel": rel,
         "sharded_params": outs[0]["tp_sharded"],
         "tp_step_s": outs[0]["tp_step_s"]}
    print(f"parallel (c) FusionMAE {fcfg.in_features}/{fcfg.hidden}, model=2 "
          f"under gloo, train_epoch over 8 patients: losses {tp} against "
          f"replicated {rep} (rel {rel}); {outs[0]['tp_sharded']} params "
          f"sharded; epochs "
          f"{[round(x, 3) for x in outs[0]['tp_step_s']]} s")
    return b, c


def pipeline_check(torch, dev, shape=(8, 728, 32, 32), timing=True):
    """(d): ``middle_flow_pipeline`` at 4 stages on 4 streams of ``dev``,
    4 microbatches, against the sequential blocks."""
    from cervical_tpu_torch import parallel as PP
    from cervical_tpu_torch.models.backbones.xception import XceptionBackbone

    g = torch.Generator().manual_seed(41)
    bb = XceptionBackbone(compute_dtype=torch.bfloat16)
    bb.load_state_dict(random_state(torch, bb, g))
    bb = bb.to(dev).eval()
    x = (torch.randn(*shape, generator=g).to(dev, torch.bfloat16)
         .contiguous(memory_format=torch.channels_last))
    stages = [dev] * 4

    def sequential(z):
        for i in range(4, 20):
            z = getattr(bb, f"block{i}")(z)[0]
        return z

    with torch.no_grad():
        out = PP.middle_flow_pipeline(bb, x, stages, microbatches=4)
        per_mb = torch.cat([sequential(c) for c in x.chunk(4)])
        full = sequential(x)
        check(torch.equal(out, per_mb), "the pipeline differs from the "
              "sequential blocks on the same microbatches")
        full_diff = float((out.float() - full.float()).abs().max())
        pipe_ms = seq_ms = None
        if timing:
            pipe_ms = cuda_ms(torch, lambda: PP.middle_flow_pipeline(
                bb, x, stages, microbatches=4), 5, queued=False)
            seq_ms = cuda_ms(torch, lambda: sequential(x), 5, queued=False)
    print(f"parallel (d) middle_flow_pipeline {tuple(shape)} bf16 x 16 "
          f"blocks, S=4 streams, M=4: equal to the sequential blocks per "
          f"microbatch, max |diff| {full_diff:.3g} against the full batch; "
          f"{pipe_ms} ms against sequential {seq_ms} ms")
    return {"equal_per_microbatch": True, "max_abs_vs_full_batch": full_diff,
            "pipeline_ms": pipe_ms, "sequential_ms": seq_ms}


def parallel_phase(torch, W, card, input_shape=(512, 512), k=8,
                   device="cuda", parts="abcd", fusion_widths=None,
                   pipe_shape=(8, 728, 32, 32), timing=True):
    """The parallel layouts; see the module docstring.  (``device="cpu"``,
    ``parts="bcd"``, small shapes and ``timing=False`` rehearse (b)-(d) on
    the CPU.)"""
    import shutil
    import tempfile
    import numpy as np
    from cervical_tpu_torch.config import FusionTrainConfig, SegTrainConfig
    from cervical_tpu_torch.train import schedules

    res = {"card": card}
    dev = torch.device("cuda:0" if device == "cuda" else device)
    h, w = input_shape
    rng = np.random.default_rng(31)
    images = rng.integers(0, 256, (k, 8, h, w, 3)).astype(np.uint8)
    labels = rng.integers(0, 5, (k, 8, h, w)).astype(np.uint8)
    val = (rng.integers(0, 256, (12, h, w, 3)).astype(np.uint8),
           rng.integers(0, 5, (12, h, w)).astype(np.uint8))
    cfg = SegTrainConfig()
    cfg.data.aug_backend = "pallas"
    cfg.data.input_shape = input_shape
    init, low = schedules.adaptive_seg_lr(
        cfg.init_lr, cfg.init_lr * cfg.min_lr_ratio, 8,
        backbone=cfg.backbone, optimizer_type=cfg.optimizer_type)
    lr = schedules.get_lr_scheduler(cfg.lr_decay_type, init, low,
                                    cfg.unfreeze_epoch)(0)
    fcfg = FusionTrainConfig(dtype="float32", epoch0_no_step=False,
                             **(fusion_widths or {}))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        if "a" in parts:
            res["a"] = nccl_world1(torch, W, cfg, images, labels, lr, tmp,
                                   dev)
        if "b" in parts or "c" in parts:
            f32 = dataclass_replace(cfg, dtype="float32")
            res["b"], res["c"] = gloo_ranks(torch, f32, fcfg, images[0],
                                            labels[0], val, lr, tmp, dev)
        if "d" in parts:
            res["d"] = pipeline_check(torch, dev, pipe_shape, timing)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("parallel " + json.dumps(res))
    return res


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
    records32, k4_32 = timed("kernels_f32", kernel_phase_f32, torch, F, MF,
                             dev, torch.Generator().manual_seed(15))
    launches, served = timed("predictor", predictor_phase, torch, MF,
                             torch.Generator().manual_seed(1))
    launches32, _ = timed("predictor_f32", predictor_f32_phase, torch, MF,
                          torch.Generator().manual_seed(1))
    warp = timed("warp", warp_phase, torch, W, A, dev,
                 torch.Generator().manual_seed(2))
    eager = timed("train", train_phase, torch, W,
                  torch.Generator().manual_seed(3))
    defaults = timed("defaults", defaults_phase, torch, W,
                     torch.Generator().manual_seed(4), card, eager)
    # the slice's main path: K1-K3 as launched by fit; K5 by
    # augment_batch_kernels(fused=True), its one caller (warp phase)
    path_launches = timed("fit", fit_phase, torch, W, MF)
    timed("protocol", protocol_phase, torch, W, MF, card)
    timed("fusion", fusion_phase, torch, card)
    timed("mobilenet", mobilenet_phase, torch,
          torch.Generator().manual_seed(14), card, served)
    timed("featurize", featurize_phase, torch, card)
    prepare = timed("prepare", prepare_phase, torch, W, card, defaults)
    par = timed("parallel", parallel_phase, torch, W, card)
    path_launches["warp_photo_images"] = warp["warp_photo_images"]["launches"]
    print("seconds per phase " + json.dumps(seconds))

    kernels = []
    for r, n in [(r, launches[r["name"].split(".")[-1]]) for r in records] + \
            [(r, launches32[r["wrapper"]]) for r in records32]:
        extra = {k: r[k] for k in ("library", "library_bf16_out_ms", "ms_os8",
                                   "function", "max_err_over_abs_product",
                                   "bound_fp32_ffma_ms", "max_abs_err_f64",
                                   "torch_mm_max_abs_err_f64")
                 if k in r}
        kernels.append({
            "name": r["name"], "route": "cuda",
            "source": "cervical_tpu_torch/" + r["source"],
            "replaces": TPU_K4, "launches": n,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "kernel_ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "timed_shape": r["timed_shape"],
            **extra})
    for name, r in warp.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "cervical_tpu_torch/csrc/warp.cu",
            "replaces": TPU_WARP[name], "launches": path_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "library": NO_LIBRARY, "timed_shape": r["timed"],
            **({"launches_prepare": {
                "planar_call": prepare["planar"]["launches"][name],
                "epoch": prepare["epoch"]["launches"][name]},
                "launches_parallel": par["a"]["launches"][name]}
               if name in TRAIN_KERNELS else {}),
            **{k: r[k] for k in ("ms_none_rotated", "ms_all_rotated",
                                 "ms_blur_all", "ms_blur_none", "differing",
                                 "ms_none", "ms_all", "k1_k3_ms",
                                 "k1_k3_ms_none", "k1_k3_ms_all",
                                 "chain_differing") if k in r}})
    print(json.dumps({"k4_middle_flow_eval": k4}))
    print(json.dumps({"k4_middle_flow_eval_f32": k4_32}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if "--parallel-rank" in sys.argv:  # a child of the parallel phase
        a = sys.argv
        sys.exit(parallel_rank(int(a[a.index("--parallel-rank") + 1]),
                               a[a.index("--workdir") + 1]))
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke.py FAILED: {e}", file=sys.stderr)
        sys.exit(3)
