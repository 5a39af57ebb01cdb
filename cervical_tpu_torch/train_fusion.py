"""Train the multimodal fusion classifier with stratified-K-fold CV — the
port's counterpart of ``scripts/train_fusion.py`` (replaces the 11
reference training scripts, Four_Modal/my_train(full).py,
Three_Modal/train(NAL|NAC|NLC|ALC).py, Two_Modal/train(..).py: the
modality subset is a flag).

Usage:
    python -m cervical_tpu_torch.train_fusion --cohort cohort.npz \
        --modalities '["imgN","imgA","imgL","cli"]' [--epochs 180] \
        [--vmap_folds true] [--vmap_group 25] [--dtype bfloat16] \
        [--log_dir log] [--device cuda] [--key value ...]

The per-arity deltas (``FusionTrainConfig.arity_defaults``) apply after the
file and CLI values, never over a key set explicitly.  ``--device``
defaults to ``cuda``.  ``--vmap_folds true`` trains the (seed, fold) pairs
fold-stacked, ``--vmap_group`` of them at a time (default 25): the same
per-fold results and files, fold-level resume.  SIGTERM or SIGINT
finalises the fold in flight and stops (with ``--vmap_folds``, at the next
epoch chunk, checkpointing the group in flight); a rerun with the same
``--save_dir`` resumes.

One process per device, as ``train_seg``: ``--coordinator host:port
--num_processes N --process_id I`` (or ``--multihost true`` under
torchrun) trains data-parallel over the N ranks, each on its rows of every
micro-batch; only rank 0 writes.  (The tensor-parallel layout is
``FusionTrainer(mesh=parallel.make_mesh(model_parallel=M))``.)
"""

from __future__ import annotations

import sys


def build_config(argv):
    """Parse CLI args into (cfg, cohort_path, log_dir, vmap_folds,
    vmap_group, device)."""
    from cervical_tpu_torch.config import (FusionTrainConfig, load_config,
                                           parse_cli_overrides)
    overrides = parse_cli_overrides(argv)
    cohort_path = overrides.pop("cohort", None)
    cfg_path = overrides.pop("config", None)
    log_dir = overrides.pop("log_dir", None)
    vmap_folds = bool(overrides.pop("vmap_folds", False))
    vmap_group = int(overrides.pop("vmap_group", 25))
    device = overrides.pop("device", "cuda")
    explicit = set()
    cfg = load_config(FusionTrainConfig, cfg_path, overrides,
                      explicit_out=explicit)
    cfg.arity_defaults(explicit=explicit)
    return cfg, cohort_path, log_dir, vmap_folds, vmap_group, device


def main(argv):
    import torch.distributed as dist
    from cervical_tpu_torch import parallel
    argv = list(argv)
    device = "cuda"
    for i, a in enumerate(argv):  # the backend follows --device
        if a == "--device" and i + 1 < len(argv):
            device = argv[i + 1]
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
    argv = parallel.initialize_from_cli(argv, device=device)
    from cervical_tpu_torch.data.fusion_data import (align_to_modalities,
                                                     load_npz)
    from cervical_tpu_torch.train.fusion_trainer import FusionTrainer
    from cervical_tpu_torch.utils import Logger, show_config

    cfg, cohort_path, log_dir, vmap_folds, vmap_group, device = \
        build_config(argv)
    if log_dir and parallel.is_primary():
        # tee stdout to log_dir/<timestamp>.log (util.py:50-67)
        sys.stdout = Logger(log_dir, stream=sys.stdout)
    show_config(**{k: getattr(cfg, k) for k in
                   ("modalities", "epochs", "lr", "batch_size", "kfold",
                    "inner_test_size", "weight_decay", "lr_step", "mix",
                    "add_mse_loss_of_mae", "dtype")}, device=device,
                vmap_folds=vmap_folds, vmap_group=vmap_group)
    if cohort_path is None:
        raise SystemExit("--cohort path/to/cohort.npz is required")
    ds = load_npz(cohort_path)
    if ds["labels"] is None:
        raise SystemExit(f"{cohort_path} carries no 'labels' array — "
                         "training needs diagnosis labels")
    ds = align_to_modalities(ds, cfg.modalities)

    mesh = parallel.make_mesh() if dist.is_initialized() else None
    trainer = FusionTrainer(cfg, device=device, mesh=mesh)
    result = trainer.cross_validate(ds, save_dir=cfg.save_dir,
                                    vmap_folds=vmap_folds,
                                    vmap_group=vmap_group)
    print(f"mean test accuracy over folds: {result['mean_test_acc']:.4f}")


if __name__ == "__main__":
    main(sys.argv[1:])
