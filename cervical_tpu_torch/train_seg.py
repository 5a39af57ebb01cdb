"""Train DeepLabV3+ segmentation — the port's counterpart of
``scripts/train_seg.py`` (replaces ``Segmentation/deeplabv3+/train.py``).

Usage:
    python -m cervical_tpu_torch.train_seg [--config cfg.yaml] [--device cuda]
        [--key value ...]
e.g.
    python -m cervical_tpu_torch.train_seg --data.dataset_path VOCdevkit \
        --unfreeze_epoch 50 --save_dir logs

``--key value`` pairs override the config (``--data.input_shape '[64,64]'``).
``--device`` defaults to ``cuda``; ``--device cpu`` runs the kernels' plain
versions.  SIGTERM or SIGINT stops after the epoch in flight, which is
checkpointed; resume with ``--init_epoch``.

Data parallelism, one process per device (``parallel/mesh.py``; each rank
trains on its rows of every global batch, only rank 0 writes files):

    # two processes on the CPU (gloo), in two shells or with &
    python -m cervical_tpu_torch.train_seg --device cpu \
        --coordinator localhost:29500 --num_processes 2 --process_id 0 ...
    python -m cervical_tpu_torch.train_seg --device cpu \
        --coordinator localhost:29500 --num_processes 2 --process_id 1 ...
    # one process per card (NCCL), through torchrun
    torchrun --nproc_per_node 2 -m cervical_tpu_torch.train_seg \
        --multihost true ...

``--coordinator`` also takes a ``file://`` or ``tcp://`` URL.  Each flag
takes ``--flag v`` or ``--flag=v``; an incomplete explicit set is refused.
"""

from __future__ import annotations

import sys


def _pop(argv, flag):
    """Remove ``flag value`` (or ``flag=value``) from ``argv``; its value or
    None."""
    for i, a in enumerate(argv):
        if a == flag:
            if i + 1 >= len(argv):
                raise SystemExit(f"{flag} requires a value")
            v = argv[i + 1]
            del argv[i:i + 2]
            return v
        if a.startswith(flag + "="):
            del argv[i]
            return a[len(flag) + 1:]
    return None


def main(argv):
    argv = list(argv)
    device = _pop(argv, "--device") or "cuda"
    from cervical_tpu_torch.parallel import initialize_from_cli
    argv = initialize_from_cli(argv, device=device)  # before any CUDA use
    cfg_path = _pop(argv, "--config")

    from cervical_tpu_torch.config import (SegTrainConfig, load_config,
                                           parse_cli_overrides)
    from cervical_tpu_torch.data.voc import VOCSegDataset, read_split
    from cervical_tpu_torch.train.seg_trainer import SegTrainer
    from cervical_tpu_torch.utils import seed_everything, show_config

    cfg = load_config(SegTrainConfig, cfg_path, parse_cli_overrides(argv))
    show_config(**{k: getattr(cfg, k) for k in
                   ("backbone", "pretrained", "downsample_factor", "init_lr",
                    "lr_decay_type", "freeze_train", "unfreeze_epoch",
                    "cls_weights", "dtype", "save_dir")}, device=device)
    seed_everything(cfg.seed)

    train_ids = read_split(cfg.data.dataset_path, "train")
    val_ids = read_split(cfg.data.dataset_path, "val")
    train_ds = VOCSegDataset(cfg.data.dataset_path, train_ids,
                             stage_hw=tuple(cfg.data.input_shape))
    val_ds = VOCSegDataset(cfg.data.dataset_path, val_ids,
                           stage_hw=tuple(cfg.data.input_shape))
    print(f"num_train {len(train_ds)} / num_val {len(val_ds)}")

    trainer = SegTrainer(cfg, device=device)
    trainer.fit(train_ds, val_ds)


if __name__ == "__main__":
    main(sys.argv[1:])
