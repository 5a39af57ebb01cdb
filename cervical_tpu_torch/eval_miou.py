"""Standalone mIoU / Recall / Precision evaluation — the port's counterpart
of ``scripts/eval_miou.py`` (replaces the reference's ``get_miou.py``).

Modes:
  1. checkpoint: restore a ``SegTrainer`` checkpoint, predict a split of a
     VOC dataset, accumulate the confusion matrix on the device, report
     per-class IoU / Recall / Precision;
  2. dirs: compare two folders of class-index PNGs (``compute_mIoU``,
     utils_metrics.py:120-193), writing ``confusion_matrix.csv`` and the
     per-class bar charts to ``--miou_out`` (default ``miou_out``).

Usage:
    python -m cervical_tpu_torch.eval_miou --dataset VOCdevkit \
        --ckpt logs/best_epoch_weights [--split test] [--device cuda]
    python -m cervical_tpu_torch.eval_miou --gt_dir gt/ --pred_dir pred/ \
        --ids test.txt [--num_classes 5] [--miou_out miou_out]

Other ``--key value`` pairs override the ``SegTrainConfig``
(``--backbone mobilenet``, ``--data.input_shape '[512,512]'``).
``--device`` defaults to ``cuda``.
"""

from __future__ import annotations

import os
import sys

_CLI_KEYS = ("ckpt", "split", "device")


def main(argv):
    """Run the CLI on ``argv``: print the summary lines and return the
    ``summarize_hist`` dict."""
    from cervical_tpu_torch.config import (SegTrainConfig, load_config,
                                           parse_cli_overrides)
    from cervical_tpu_torch.inference.evaluator import print_summary
    args = parse_cli_overrides(argv)

    if "gt_dir" in args:
        from cervical_tpu_torch.inference.predictor import evaluate_miou_dir
        with open(args["ids"]) as f:
            ids = [line.strip() for line in f if line.strip()]
        s = evaluate_miou_dir(args["gt_dir"], args["pred_dir"], ids,
                              int(args.get("num_classes", 5)),
                              miou_out_path=args.get("miou_out", "miou_out"))
    else:
        from cervical_tpu_torch.data.voc import (BatchLoader, VOCSegDataset,
                                                 read_split)
        from cervical_tpu_torch.train.checkpoints import CheckpointManager
        from cervical_tpu_torch.train.seg_trainer import SegTrainer

        if "dataset" in args:  # the alias of --data.dataset_path
            # an explicit --data.dataset_path wins over the alias
            args.setdefault("data", {}).setdefault("dataset_path",
                                                   args.pop("dataset"))
        cfg = load_config(SegTrainConfig, args.pop("config", None),
                          {k: v for k, v in args.items()
                           if k not in _CLI_KEYS})
        trainer = SegTrainer(cfg, device=args.get("device", "cuda"))
        ckpt_path = args.get("ckpt", os.path.join(cfg.save_dir,
                                                  "best_epoch_weights"))
        mgr = CheckpointManager(os.path.dirname(ckpt_path) or ".", 10)
        trainer.state, _ = mgr.restore(os.path.basename(ckpt_path),
                                       trainer.state)
        ids = read_split(cfg.data.dataset_path, args.get("split", "test"))
        ds = VOCSegDataset(cfg.data.dataset_path, ids,
                           stage_hw=tuple(cfg.data.input_shape))
        loader = BatchLoader(ds, cfg.eval_batch_size, shuffle=False,
                             drop_last=False)
        s = trainer.evaluate_miou(loader)
    print_summary(s)
    return s


if __name__ == "__main__":
    main(sys.argv[1:])
