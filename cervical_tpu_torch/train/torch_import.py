"""Loading torch checkpoints into the port's DeepLab and FusionMAE — the
counterpart of ``cervical_tpu/train/torch_import.py`` (``load_state_dict``,
``is_full_deeplab_sd``, ``merge_into``, ``convert_fusion``).

The reference bootstraps from ImageNet backbone weights and from the
shape-matched partial load of a whole-model checkpoint such as
``deeplab_xception.pth`` (``train.py:304-339``: mismatching shapes are
skipped, not fatal).  The port's modules carry the reference model's names
(``nets/deeplabv3_plus.py``, ``nets/xception.py``), so no conversion is
needed: a whole-model checkpoint maps key for key, a backbone-only one maps
under ``backbone.``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth``/``.pt`` file's state dict on the CPU: a plain dict, one
    nested under ``"state_dict"``, or a pickled module."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    return {k: torch.as_tensor(v).detach() for k, v in sd.items()}


def is_full_deeplab_sd(sd: Dict[str, torch.Tensor]) -> bool:
    """Whole-model checkpoint vs backbone-only (decides the load scope)."""
    return any(k.startswith(("aspp.", "cat_conv.", "cls_conv.",
                             "shortcut_conv.")) for k in sd)


@torch.no_grad()
def load_into(model: nn.Module, sd: Dict[str, torch.Tensor],
              scope: str = "") -> Tuple[List[str], List[str]]:
    """Copy the floating-point tensors of ``sd`` into ``model`` where a
    tensor of the same name (under ``scope``) and shape exists; returns
    (loaded names, skipped names).  Integer entries such as BatchNorm's
    ``num_batches_tracked`` are left alone, as the JAX package has no such
    counters."""
    prefix = f"{scope}." if scope else ""
    own = model.state_dict()
    loaded, skipped = [], []
    for k, v in sd.items():
        if not v.dtype.is_floating_point:
            continue
        dst = own.get(prefix + k)
        if dst is not None and tuple(dst.shape) == tuple(v.shape):
            dst.copy_(v.to(dst.dtype))
            loaded.append(prefix + k)
        else:
            skipped.append(prefix + k)
    return loaded, skipped


# the reference's fc_cli_1/fc_cli_2 are built and never called
# (my_mae_model.py:421-422); the JAX package's convert_fusion skips them too
_FUSION_DEAD = ("fc_cli_1.", "fc_cli_2.")


def load_fusion(model: nn.Module, sd: Dict[str, torch.Tensor]) -> List[str]:
    """Load the reference ``fusion_model_mae_2`` ``state_dict`` into the
    port's ``FusionMAE``, whose names are the reference's: strictly, but
    for the dead ``fc_cli_1``/``fc_cli_2`` layers, whose names it returns."""
    dead = [k for k in sd if k.startswith(_FUSION_DEAD)]
    model.load_state_dict({k: v for k, v in sd.items() if k not in dead},
                          strict=True)
    return dead
