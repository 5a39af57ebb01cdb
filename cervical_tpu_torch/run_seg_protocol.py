"""The complete reference segmentation protocol, end to end on the card —
the port's counterpart of ``scripts/run_seg_protocol.py``.

The two-phase schedule of ``Segmentation/deeplabv3+/train.py:176-192,
526-581``: 20 frozen epochs at batch 16, then unfrozen epochs at batch 8
(220 in all), over 6,720 train / 840 val images at 512² (structured
synthetic data in lieu of the private dataset: the color-coded blobs of
``make_synthetic_voc``, generated in memory), an eval and a checkpoint
every 10 epochs, and the predictor-path mIoU callback, on the
device-resident pipeline (the 7 GB train set uploads once; each epoch's
K-step calls read their batches from device memory).

Artifacts land in ``--save_dir`` (default logs_protocol/): protocol.log,
epoch_loss.txt, epoch_val_loss.txt, epoch_miou.txt,
epoch_miou_predictor.txt, model_graph.txt, the checkpoints, and a final
``protocol_summary.json`` with wall-clock seconds and throughput.

Usage:
    python -m cervical_tpu_torch.run_seg_protocol [--save_dir DIR]
        [--epochs N] [--freeze_epoch N] [--train_n N] [--val_n N]
        [--size S] [--resume] [--backbone xception] [--no_predictor]
        [--resident_shuffle gather|images|chunks|none] [--val_dir DIR]
        [--device cuda]

``--device`` defaults to ``cuda``, and the run refuses to start without a
card; ``--device cpu`` runs on the CPU (the kernels' plain versions), e.g.
a tiny run: ``--device cpu --size 64 --train_n 32 --val_n 8 --epochs 10
--freeze_epoch 5``.  SIGTERM or SIGINT stops after the epoch in flight,
which is checkpointed; ``--resume`` continues from ``last_epoch_weights``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def synth_seg_arrays(n, size=512, num_classes=5, seed=0, log=print):
    """Structured synthetic cohort: color-coded class blobs, each pixel's
    class recoverable from the image (the content model of
    ``data/voc.py::make_synthetic_voc``, generated in memory at scale).
    The same ``default_rng`` draws in the same order as the JAX package's
    runner, so the arrays are equal bit for bit; each disc is tested on
    its bounding box only and the image is made in place, which halves
    the time an image."""
    rng = np.random.default_rng(seed)
    palette = np.array([[0, 0, 0], [255, 255, 0], [255, 0, 0],
                        [0, 255, 0], [0, 0, 255]], np.int16)[:num_classes]
    images = np.empty((n, size, size, 3), np.uint8)
    labels = np.zeros((n, size, size), np.uint8)
    coord = np.arange(size)
    t0 = time.time()
    for i in range(n):
        mask = labels[i]
        for c in range(1, num_classes):
            if rng.random() < 0.7:
                cy, cx = rng.integers(size // 8, size - size // 8, 2)
                r = int(rng.integers(size // 12, size // 4))
                # the disc (y - cy)^2 + (x - cx)^2 < r^2 lies in these rows
                # and columns
                y0, y1 = max(cy - r + 1, 0), min(cy + r, size)
                x0, x1 = max(cx - r + 1, 0), min(cx + r, size)
                d2 = (coord[y0:y1, None] - cy) ** 2 + \
                    (coord[None, x0:x1] - cx) ** 2
                mask[y0:y1, x0:x1][d2 < r * r] = c
        img = np.take(palette, mask, axis=0)
        img += rng.integers(-20, 20, (size, size, 3), dtype=np.int16)
        images[i] = np.clip(img, 0, 255, out=img)
        if log and (i + 1) % 1000 == 0:
            log(f"  synth {i + 1}/{n} ({time.time() - t0:.0f}s)")
    return images, labels


def write_val_to_disk(root, images, labels, log=print):
    """The VOC2007 layout the predictor callback reads (it needs file
    paths): JPEGs at quality 95, PNG labels, every split file listing all
    ids."""
    from PIL import Image
    jdir = os.path.join(root, "VOC2007", "JPEGImages")
    sdir = os.path.join(root, "VOC2007", "SegmentationClass")
    idir = os.path.join(root, "VOC2007", "ImageSets", "Segmentation")
    for d in (jdir, sdir, idir):
        os.makedirs(d, exist_ok=True)
    ids = []
    t0 = time.time()
    for i in range(len(images)):
        name = f"{i:06d}"
        Image.fromarray(images[i]).save(os.path.join(jdir, name + ".jpg"),
                                        quality=95)
        Image.fromarray(labels[i]).save(os.path.join(sdir, name + ".png"))
        ids.append(name)
    for split in ("train", "val", "test", "trainval"):
        with open(os.path.join(idir, split + ".txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
    log(f"val set written to {root} ({len(ids)} images, "
        f"{time.time() - t0:.0f}s)")
    return root


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m cervical_tpu_torch.run_seg_protocol")
    ap.add_argument("--save_dir", default="logs_protocol")
    ap.add_argument("--epochs", type=int, default=220,
                    help="total epochs (20 frozen + the rest unfrozen)")
    ap.add_argument("--freeze_epoch", type=int, default=20)
    ap.add_argument("--train_n", type=int, default=6720)
    ap.add_argument("--val_n", type=int, default=840)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--backbone", default="xception")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--no_predictor", action="store_true")
    ap.add_argument("--resident_shuffle", default="gather",
                    help="gather|images|chunks|none")
    ap.add_argument("--val_dir", default=None,
                    help="reuse an existing on-disk val set")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; no fallback) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the protocol with the flags in ``argv``; returns the summary
    written to ``protocol_summary.json``."""
    args = parse_args(argv)
    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_seg_protocol: no CUDA device; pass --device "
                         "cpu to run on the CPU")

    from cervical_tpu_torch.config import SegDataConfig, SegTrainConfig
    from cervical_tpu_torch.data.voc import ArraySegDataset, VOCSegDataset
    from cervical_tpu_torch.train.seg_trainer import SegTrainer

    os.makedirs(args.save_dir, exist_ok=True)
    with open(os.path.join(args.save_dir, "protocol.log"), "a") as logf:
        def log(*msg):
            line = " ".join(str(m) for m in msg)
            stamp = time.strftime("%H:%M:%S")
            print(f"[{stamp}] {line}", flush=True)
            logf.write(f"[{stamp}] {line}\n")
            logf.flush()

        log(f"=== seg protocol: {args.epochs} epochs "
            f"({args.train_n} train / {args.val_n} val @ {args.size}^2, "
            f"backbone={args.backbone}) ===")
        wall0 = time.time()

        # --- data ---
        train_imgs, train_lbls = synth_seg_arrays(args.train_n, args.size,
                                                  seed=0, log=log)
        train_ds = ArraySegDataset(train_imgs, train_lbls)
        val_imgs, val_lbls = synth_seg_arrays(args.val_n, args.size,
                                              seed=77, log=log)
        val_dir = args.val_dir or os.path.join(args.save_dir, "val_voc")
        if args.no_predictor:
            val_ds = ArraySegDataset(val_imgs, val_lbls)
        else:
            if not os.path.isdir(os.path.join(val_dir, "VOC2007")):
                write_val_to_disk(val_dir, val_imgs, val_lbls, log=log)
            ids = [f"{i:06d}" for i in range(args.val_n)]
            val_ds = VOCSegDataset(val_dir, ids,
                                   stage_hw=(args.size, args.size))
        t_data = time.time() - wall0
        log(f"data ready in {t_data:.0f}s")

        # --- config: the reference literals (train.py:50-281) and the
        # device-resident pipeline ---
        cfg = SegTrainConfig(
            data=SegDataConfig(input_shape=(args.size, args.size),
                               num_classes=5),
            backbone=args.backbone,
            freeze_train=True, freeze_epoch=args.freeze_epoch,
            unfreeze_epoch=args.epochs,
            freeze_batch_size=16, unfreeze_batch_size=8,
            eval_period=10, save_period=10,
            predictor_eval=not args.no_predictor,
            save_dir=args.save_dir,
            device_resident=True, resident_shuffle=args.resident_shuffle,
        )

        trainer = SegTrainer(cfg, device=args.device)
        log("device: " + (torch.cuda.get_device_name(trainer.device)
                          if trainer.device.type == "cuda" else "cpu"))
        if args.resume:
            from cervical_tpu_torch.train.checkpoints import (
                CheckpointManager)
            mgr = CheckpointManager(cfg.save_dir, cfg.save_period)
            trainer.state, extra = mgr.restore("last_epoch_weights",
                                               trainer.state)
            cfg.init_epoch = int(extra.get("epoch", -1)) + 1
            log(f"resumed from epoch {cfg.init_epoch}")

        t_fit0 = time.time()
        history = trainer.fit(train_ds, val_ds, total_epochs=args.epochs,
                              log=log)
        t_fit = time.time() - t_fit0

        done = len(history["train_loss"])
        n_unfrozen = max(0, done - max(0, cfg.freeze_epoch - cfg.init_epoch))
        summary = {
            "epochs_run": done, "total_epochs": args.epochs,
            "train_n": args.train_n, "val_n": args.val_n, "size": args.size,
            "backbone": args.backbone,
            "fit_wall_s": round(t_fit, 1),
            "data_prep_s": round(t_data, 1),
            "s_per_epoch_mean": round(t_fit / max(done, 1), 2),
            "train_img_per_s_mean": round(args.train_n * done / t_fit, 1),
            "final_train_loss": history["train_loss"][-1] if done else None,
            "final_val_loss": history["val_loss"][-1] if done else None,
            "miou_trajectory": history.get("miou", []),
            "predictor_miou": history.get("predictor_miou", []),
            "resident_shuffle": args.resident_shuffle,
            "n_unfrozen_epochs": n_unfrozen,
        }
        with open(os.path.join(args.save_dir, "protocol_summary.json"),
                  "w") as f:
            json.dump(summary, f, indent=1)
        log("SUMMARY " + json.dumps(summary))
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
