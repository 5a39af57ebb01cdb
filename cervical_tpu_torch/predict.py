"""Single-image prediction / FPS benchmark — the port's counterpart of
``scripts/predict.py``.

Usage:
    python -m cervical_tpu_torch.predict --ckpt weights.pt --image x.jpg \
        [--mix_type 0] [--out out.png] [--fps 100] [--count true] \
        [--fused_middle true] [--tiled true] [--export model.pt2] \
        [--backbone mobilenet] [--device cuda]

``--ckpt``: a port ``state_dict`` saved with ``torch.save`` (``.pt``), or
flax-layout weights in an ``.npz`` keyed ``params/<path>`` and
``batch_stats/<path>`` (read through ``train/flax_import.py``).  Without
``--ckpt`` the model takes a random init seeded by ``--seed``.
``--fused_middle``: run the Xception backbone's blocks 4-19 through the
middle-flow kernels.  ``--export PATH`` writes the serving forward as a
``torch.export`` program (``SegPredictor.export_program``; StableHLO in the
JAX CLI) and exits; the program always traces the unfused model.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from cervical_tpu_torch.config import (SegTrainConfig, load_config,
                                       parse_cli_overrides)
from cervical_tpu_torch.inference.predictor import SegPredictor
from cervical_tpu_torch.train.flax_import import deeplab_from_flax, load_flax_npz
from cervical_tpu_torch.train.seg_trainer import (build_model,
                                                  reference_weights_init)

_CLI_KEYS = ("ckpt", "image", "mix_type", "out", "fps", "export", "count",
             "fused_middle", "tiled", "device")


def load_state(cfg: SegTrainConfig, ckpt=None):
    """The ``state_dict`` the CLI predicts with: from ``ckpt`` (.pt or
    flax-layout .npz), else a random init seeded by ``cfg.seed``."""
    if ckpt is None:
        model = build_model(cfg)
        reference_weights_init(model, torch.Generator().manual_seed(cfg.seed))
        return model.state_dict()
    if str(ckpt).endswith(".npz"):
        params, stats = load_flax_npz(ckpt)
        return deeplab_from_flax(params, stats, cfg.backbone)
    return torch.load(ckpt, map_location="cpu", weights_only=True)


def main(argv):
    args = parse_cli_overrides(argv)
    cfg = load_config(SegTrainConfig, args.pop("config", None),
                      {k: v for k, v in args.items() if k not in _CLI_KEYS})
    predictor = SegPredictor(cfg, load_state(cfg, args.get("ckpt")),
                             fused_middle=bool(args.get("fused_middle", False)),
                             device=args.get("device", "cuda"))
    if "export" in args:
        path = predictor.export_program(args["export"])
        print(f"exported a torch.export program to {path}")
        return

    from PIL import Image
    image = np.asarray(Image.open(args["image"]).convert("RGB"))
    if "fps" in args:
        sec = predictor.get_fps(image, int(args["fps"]))
        print(f"{sec:.4f} seconds/image, {1 / sec:.2f} FPS (batch-1)")
        print(f"batched throughput: {predictor.get_throughput():.1f} images/s")
        return

    rendered = predictor.detect_image(image, mix_type=int(args.get("mix_type", 0)),
                                      count=bool(args.get("count", False)),
                                      tiled=bool(args.get("tiled", False)))
    out = args.get("out", "prediction.png")
    Image.fromarray(rendered).save(out)
    print(f"saved {out}")


if __name__ == "__main__":
    main(sys.argv[1:])
