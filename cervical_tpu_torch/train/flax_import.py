"""Flax parameter trees -> port ``state_dict``: the inverse of the JAX
package's ``train/torch_import.convert_deeplab``, and the same mapping for
an optax Adam state.

Conventions, inverted: HWIO conv kernels -> OIHW; depthwise (3,3,1,C) ->
(C,1,3,3) (the same transpose); BatchNorm scale/bias/mean/var ->
weight/bias/running_mean/running_var.  Inputs are nested dicts of numpy
arrays (``params`` and ``batch_stats`` of ``cervical_tpu.models.deeplab.
DeepLab``), so JAX-trained weights run in the port without JAX installed.
A JAX ``TrainState`` carries over whole: its params and batch stats
through :func:`deeplab_from_flax`, each param group's Adam moments and
count through :func:`load_adam_state`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _conv(w):
    return np.transpose(np.asarray(w), (3, 2, 0, 1))


class _InverseMapper:
    def __init__(self, params: Dict, stats: Dict):
        self.params, self.stats = params, stats
        self.sd: Dict[str, torch.Tensor] = {}

    @staticmethod
    def _get(tree, path):
        node = tree
        for p in path:
            node = node[p]
        return node

    def _put(self, key, value):
        self.sd[key] = torch.from_numpy(np.array(value, np.float32))

    def conv(self, flax_path, torch_name, bias=False):
        node = self._get(self.params, flax_path)
        self._put(torch_name + ".weight", _conv(node["kernel"]))
        if bias:
            self._put(torch_name + ".bias", node["bias"])

    def bn(self, flax_path, torch_name):
        p = self._get(self.params, flax_path)
        self._put(torch_name + ".weight", p["scale"])
        self._put(torch_name + ".bias", p["bias"])
        if self.stats is None:  # a params-shaped tree only (Adam moments)
            return
        s = self._get(self.stats, flax_path)
        self._put(torch_name + ".running_mean", s["mean"])
        self._put(torch_name + ".running_var", s["var"])
        self.sd[torch_name + ".num_batches_tracked"] = torch.tensor(0)


def _xception(m: _InverseMapper, fx: Tuple[str, ...], tp: str):
    def sepconv(flax_prefix, torch_prefix):
        m.conv(flax_prefix + ("depthwise",), torch_prefix + ".depthwise")
        m.bn(flax_prefix + ("bn1",), torch_prefix + ".bn1")
        m.conv(flax_prefix + ("pointwise",), torch_prefix + ".pointwise")
        m.bn(flax_prefix + ("bn2",), torch_prefix + ".bn2")

    m.conv(fx + ("conv1",), tp + "conv1")
    m.bn(fx + ("bn1",), tp + "bn1")
    m.conv(fx + ("conv2",), tp + "conv2")
    m.bn(fx + ("bn2",), tp + "bn2")
    backbone = m._get(m.params, fx)
    for i in range(1, 21):
        bx, bt = fx + (f"block{i}",), f"{tp}block{i}"
        if "skip" in backbone[f"block{i}"]:
            m.conv(bx + ("skip",), bt + ".skip")
            m.bn(bx + ("skip_bn",), bt + ".skipbn")
        for k in (1, 2, 3):
            sepconv(bx + (f"sepconv{k}",), f"{bt}.sepconv{k}")
    for k in (3, 4, 5):
        sepconv(fx + (f"conv{k}",), f"{tp}conv{k}")


def deeplab_from_flax(params: Dict, batch_stats: Optional[Dict],
                      backbone: str = "xception") -> Dict[str, torch.Tensor]:
    """Flax ``DeepLab`` params/batch_stats -> a ``state_dict`` for
    :class:`cervical_tpu_torch.models.deeplab.DeepLab` (fp32 tensors;
    ``num_batches_tracked`` set to 0).  With ``batch_stats=None`` any
    params-shaped tree maps to parameter names only, and the top-level
    parts it lacks (``backbone``, or the head's) are skipped."""
    if backbone == "mobilenet":
        raise NotImplementedError(
            "the MobileNetV2 backbone is not ported yet (its own slice)")
    if backbone != "xception":
        raise ValueError(f"unknown backbone {backbone!r}")
    m = _InverseMapper(params, batch_stats)
    if "backbone" in params:
        _xception(m, ("backbone",), "backbone.")
    if "cls_conv" not in params:
        return m.sd

    def cbr(flax_prefix, conv_name, bn_name):
        m.conv(flax_prefix + ("conv",), conv_name, bias=True)
        m.bn(flax_prefix + ("bn",), bn_name)

    for i in (1, 2, 3, 4):
        cbr(("aspp", f"branch{i}"), f"aspp.branch{i}.0", f"aspp.branch{i}.1")
    cbr(("aspp", "branch5"), "aspp.branch5_conv", "aspp.branch5_bn")
    cbr(("aspp", "fuse"), "aspp.conv_cat.0", "aspp.conv_cat.1")
    cbr(("shortcut",), "shortcut_conv.0", "shortcut_conv.1")
    cbr(("cat_conv1",), "cat_conv.0", "cat_conv.1")
    cbr(("cat_conv2",), "cat_conv.4", "cat_conv.5")
    m.conv(("cls_conv",), "cls_conv", bias=True)
    return m.sd


def load_adam_state(model: torch.nn.Module,
                    optimizers: Dict[str, torch.optim.Optimizer],
                    groups: Dict[str, Tuple[int, Dict, Dict]],
                    backbone: str = "xception") -> None:
    """Set each Adam optimizer's per-param state from optax's
    ``scale_by_adam`` state: ``groups[name] = (count, mu, nu)`` with ``mu``
    and ``nu`` params-shaped numpy trees of that group (``{"backbone":
    ...}`` or the head's parts).  A group with count 0 is left empty, as
    torch creates its state at the first step."""
    names = {id(p): n for n, p in model.named_parameters()}
    for group, (count, mu, nu) in groups.items():
        opt = optimizers[group]
        if int(count) == 0:
            continue
        mu_sd = deeplab_from_flax(mu, None, backbone)
        nu_sd = deeplab_from_flax(nu, None, backbone)
        for pg in opt.param_groups:
            for p in pg["params"]:
                n = names[id(p)]
                opt.state[p] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": mu_sd[n].to(p.device, p.dtype).reshape(p.shape),
                    "exp_avg_sq": nu_sd[n].to(p.device, p.dtype).reshape(p.shape)}


def load_flax_npz(path: str) -> Tuple[Dict, Dict]:
    """Read flax-layout weights from an ``.npz`` whose keys are
    ``params/<path>`` and ``batch_stats/<path>`` ('/'-joined tree paths).
    Returns (params, batch_stats) as nested dicts of numpy arrays."""
    trees = {"params": {}, "batch_stats": {}}
    with np.load(path) as data:
        for key in data.files:
            root, *parts = key.split("/")
            if root not in trees or not parts:
                raise KeyError(f"unexpected key {key!r} in {path}")
            node = trees[root]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return trees["params"], trees["batch_stats"]
