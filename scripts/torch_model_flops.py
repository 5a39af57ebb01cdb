#!/usr/bin/env python3
"""Forward operations per image of the port's models, counted from shapes.

    python scripts/torch_model_flops.py

Counts, with ``torch.utils.flop_counter.FlopCounterMode`` on the ``meta``
device (nothing is computed, any machine), the floating-point operations
(2 per multiply-add) of one forward of: DeepLabV3+ at 512², os16, 5
classes with the Xception and the MobileNetV2 backbone (split into the
backbone and the head: ASPP, shortcut, decoder), and the ResNet-101 patch
featurizer at 256², 1024-d.  Divide by a time measured on the card to get
a rate.  The last line is one JSON object.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def count(module, x):
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        module(x)
    return fc.get_total_flops()


def main():
    import torch
    from cervical_tpu_torch.models.backbones.resnet import ResNetFeaturizer
    from cervical_tpu_torch.models.deeplab import DeepLab

    out = {}
    with torch.device("meta"):
        for backbone in ("xception", "mobilenet"):
            model = DeepLab(num_classes=5, backbone=backbone).eval()
            x = torch.zeros(1, 3, 512, 512)
            total = count(model, x)
            body = count(model.backbone, x)
            out[f"deeplab_{backbone}_512"] = {"total": total,
                                              "backbone": body,
                                              "head": total - body}
        out["resnet101_256"] = {"total": count(
            ResNetFeaturizer(101, 1024).eval(), torch.zeros(1, 3, 256, 256))}
    for name, v in out.items():
        print(f"{name}: " + ", ".join(f"{k} {n / 1e9:.2f} GFLOP"
                                      for k, n in v.items()) + " per image")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
