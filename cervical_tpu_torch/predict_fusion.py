"""Batched inference with a trained fusion classifier — the port's
counterpart of ``scripts/predict_fusion.py``.

Usage:
    python -m cervical_tpu_torch.predict_fusion --cohort cohort.npz \
        --params logs_fusion/best_seed0_fold0.npz \
        [--modalities '["imgN","imgA","imgL","cli"]'] [--in_features 1024] \
        [--out preds.json] [--export fusion.pt2] [--throughput 512] \
        [--device cuda]

``--params``: a ``best_seed{S}_fold{F}.npz`` written by either package's
``cross_validate``.  Writes per-patient fused + per-modality classes and
probabilities (and the accuracy where the cohort has labels);
``--export PATH`` writes the forward as a ``torch.export`` program
(``FusionPredictor.export_program``; StableHLO in the JAX CLI);
``--throughput N`` measures patients/s at batch N on the card.
``--device`` defaults to ``cuda``.
"""

from __future__ import annotations

import json
import sys

import numpy as np

_CLI_KEYS = ("params", "cohort", "out", "export", "throughput", "config",
             "device")


def main(argv):
    from cervical_tpu_torch.config import (FusionTrainConfig, load_config,
                                           parse_cli_overrides)
    from cervical_tpu_torch.data.fusion_data import (align_to_modalities,
                                                     load_npz)
    from cervical_tpu_torch.inference.fusion_predictor import FusionPredictor

    args = parse_cli_overrides(argv)
    cli = {k: args.pop(k) for k in _CLI_KEYS if k in args}
    cfg = load_config(FusionTrainConfig, cli.get("config"), args)
    if "params" not in cli:
        raise SystemExit("--params path/to/best_seed0_fold0.npz is required")
    predictor = FusionPredictor.from_npz(cfg, cli["params"],
                                         device=cli.get("device", "cuda"))

    if "export" in cli:
        print(f"exported {predictor.export_program(cli['export'])}")
    if "throughput" in cli:
        bs = int(cli["throughput"])
        tput = predictor.get_throughput(batch_size=bs)
        print(f"throughput: {tput:.1f} patients/sec at batch {bs}")
    if "cohort" not in cli:
        if "throughput" not in cli and "export" not in cli:
            raise SystemExit("--cohort path/to/cohort.npz is required "
                             "(or use --export / --throughput)")
        return

    # feats AND present columns aligned to the model's modalities (a
    # 2-modal model serves a 4-modal cohort npz)
    ds = align_to_modalities(load_npz(cli["cohort"]), cfg.modalities)
    probs = predictor.predict_proba(ds["feats"], ds["present"])
    classes = probs["all"].argmax(-1)
    report = {
        "ids": [str(i) for i in ds.get("ids", range(len(classes)))],
        "classes": classes.tolist(),
        "confidence": probs["all"].max(-1).round(4).tolist(),
        "probs": probs["all"].round(4).tolist(),
    }
    for m in cfg.modalities:
        report[f"classes_{m}"] = probs[m].argmax(-1).tolist()
    if ds.get("labels") is not None:
        labels = np.asarray(ds["labels"])
        report["accuracy"] = float((classes == labels).mean())
        print(f"fused-head accuracy: {report['accuracy']:.4f} "
              f"({len(labels)} patients)")
    out_path = cli.get("out")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {out_path}")
    else:
        for i in range(min(10, len(classes))):
            print(f"{report['ids'][i]}: class {report['classes'][i]} "
                  f"(p={report['confidence'][i]:.3f})")


if __name__ == "__main__":
    main(sys.argv[1:])
