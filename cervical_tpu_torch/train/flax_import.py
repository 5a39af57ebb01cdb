"""Flax parameter trees <-> port ``state_dict``: the inverse of the JAX
package's ``train/torch_import.convert_deeplab`` and ``convert_fusion``,
the same mapping for an optax Adam state, and the ``/``-joined flat npz
layout of the JAX package's fusion artifacts (``best_seed*_fold*.npz``,
``inference/fusion_predictor.py:33-54``).

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

from typing import Callable, Dict, Optional, Tuple

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
                    backbone: str = "xception",
                    from_flax: Optional[Callable[[Dict], Dict]] = None
                    ) -> None:
    """Set each Adam optimizer's per-param state from optax's
    ``scale_by_adam`` state: ``groups[name] = (count, mu, nu)`` with ``mu``
    and ``nu`` params-shaped numpy trees of that group (``{"backbone":
    ...}`` or the head's parts of DeepLab; the whole tree of the fusion
    model, whose one optimizer is ``{"params": adam}``).  ``from_flax``
    maps such a tree to parameter names: DeepLab's
    (:func:`deeplab_from_flax`) by default, :func:`fusion_from_flax` for
    the fusion model.  A group with count 0 is left empty, as torch creates
    its state at the first step; the step count sits where torch's own
    init puts it (on the param's device for a capturable optimizer)."""
    if from_flax is None:
        def from_flax(tree):
            return deeplab_from_flax(tree, None, backbone)
    names = {id(p): n for n, p in model.named_parameters()}
    for group, (count, mu, nu) in groups.items():
        opt = optimizers[group]
        if int(count) == 0:
            continue
        mu_sd, nu_sd = from_flax(mu), from_flax(nu)
        for pg in opt.param_groups:
            on_param = pg.get("capturable", False) or pg.get("fused", False)
            for p in pg["params"]:
                n = names[id(p)]
                opt.state[p] = {
                    "step": torch.tensor(float(count), dtype=torch.float32,
                                         device=p.device if on_param
                                         else "cpu"),
                    "exp_avg": mu_sd[n].to(p.device, p.dtype).reshape(p.shape),
                    "exp_avg_sq": nu_sd[n].to(p.device, p.dtype).reshape(p.shape)}


def _fusion_pairs(modalities, mix: bool):
    """(flax path, port name, kind) of every FusionMAE parameter, the
    table of ``convert_fusion`` (``cervical_tpu/train/torch_import.py:
    239-302``).  Kinds: ``linear`` (kernel (in, out) <-> weight (out, in),
    bias), ``linear_nb`` (no bias), ``norm`` (scale <-> weight, bias),
    ``token`` (the mask token, (D,) <-> (1, 1, D))."""
    pairs = []

    def lin(fp, tn, kind="linear"):
        pairs.append((fp, tn, kind))

    def gate(fp, tn):
        lin(fp + ("gate_fc1",), tn + ".gate_nn.0")
        lin(fp + ("gate_fc2",), tn + ".gate_nn.2")

    for m in modalities:
        lin((f"{m}_gnn", "lin_l"), f"{m}_gnn_2.lin_l")
        lin((f"{m}_gnn", "lin_r"), f"{m}_gnn_2.lin_r", "linear_nb")
        lin((f"{m}_norm",), f"{m}_relu_2.1", "norm")
        gate((f"mpool_{m}",), f"mpool_{m}")
        gate((f"mpool_{m}_2",), f"mpool_{m}_2")
        for k in (1, 2, 3):
            lin((f"lin{k}_{m}",), f"lin{k}_{m}")
        for k in (1, 2):
            lin((f"norm{k}_{m}",), f"norm{k}_{m}", "norm")
        lin((f"classifier_{m}",), f"classifier_{m}")
    lin(("classifier",), "classifier")
    if len(modalities) > 1:
        def vit_block(fp, tn):
            lin(fp + ("norm1",), tn + ".norm1", "norm")
            lin(fp + ("attn", "qkv"), tn + ".attn.qkv", "linear_nb")
            lin(fp + ("attn", "proj"), tn + ".attn.proj")
            lin(fp + ("norm2",), tn + ".norm2", "norm")
            lin(fp + ("mlp", "fc1"), tn + ".mlp.fc1")
            lin(fp + ("mlp", "fc2"), tn + ".mlp.fc2")

        lin(("mae", "encoder", "patch_embed"), "mae.encoder.patch_embed")
        vit_block(("mae", "encoder", "block0"), "mae.encoder.blocks.0")
        lin(("mae", "encoder", "norm"), "mae.encoder.norm", "norm")
        lin(("mae", "encoder_to_decoder"), "mae.encoder_to_decoder",
            "linear_nb")
        lin(("mae", "mask_token"), "mae.mask_token", "token")
        vit_block(("mae", "decoder", "block0"), "mae.decoder.blocks.0")
        lin(("mae", "decoder", "norm"), "mae.decoder.norm", "norm")
        lin(("mae", "decoder", "head"), "mae.decoder.head")
        if mix:
            lin(("mixer", "norm"), "mix.norm", "norm")
            lin(("mixer", "token_mix_fc1"), "mix.mix_mip_1.0")
            lin(("mixer", "token_mix_fc2"), "mix.mix_mip_1.2")
            lin(("mixer", "channel_mix_fc1"), "mix.mix_mip_2.0")
            lin(("mixer", "channel_mix_fc2"), "mix.mix_mip_2.2")
    return pairs


_MODALITY_ORDER = ("imgN", "imgA", "imgL", "cli")


def fusion_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """Flax ``FusionMAE`` params (or a params-shaped Adam moment tree) ->
    a ``state_dict`` for :class:`cervical_tpu_torch.models.fusion.
    FusionMAE`, fp32 tensors: the inverse of ``convert_fusion``.  The
    modality subset and the mixer are read from the tree."""
    mods = [m for m in _MODALITY_ORDER if f"{m}_gnn" in params]
    m = _InverseMapper(params, None)
    for fp, tn, kind in _fusion_pairs(mods, "mixer" in params):
        node = m._get(params, fp)
        if kind == "token":
            m._put(tn, np.asarray(node).reshape(1, 1, -1))
        elif kind == "norm":
            m._put(tn + ".weight", node["scale"])
            m._put(tn + ".bias", node["bias"])
        else:
            m._put(tn + ".weight", np.transpose(np.asarray(node["kernel"])))
            if kind == "linear":
                m._put(tn + ".bias", node["bias"])
    return m.sd


def fusion_to_flax(sd: Dict[str, torch.Tensor]) -> Dict:
    """A port ``FusionMAE`` ``state_dict`` -> the flax params tree of the
    JAX package's ``FusionMAE`` (numpy f32), what ``convert_fusion`` makes
    of the reference's ``state_dict``.  The port writes its fusion
    artifacts in this layout, so the JAX package serves them."""
    mods = [m for m in _MODALITY_ORDER if f"{m}_gnn_2.lin_l.weight" in sd]
    tree: Dict = {}

    def arr(name):
        return np.asarray(sd[name].detach().cpu().numpy(), np.float32)

    def put(path, value):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value

    for fp, tn, kind in _fusion_pairs(mods, "mix.norm.weight" in sd):
        if kind == "token":
            put(fp, arr(tn).reshape(-1))
        elif kind == "norm":
            put(fp + ("scale",), arr(tn + ".weight"))
            put(fp + ("bias",), arr(tn + ".bias"))
        else:
            put(fp + ("kernel",), np.ascontiguousarray(arr(tn + ".weight").T))
            if kind == "linear":
                put(fp + ("bias",), arr(tn + ".bias"))
    return tree


def flatten_params(tree: Dict, sep: str = "/") -> Dict[str, np.ndarray]:
    """Nested params tree -> flat dict keyed by ``sep``-joined paths (the
    npz layout of ``flax.traverse_util.flatten_dict(params, sep="/")``)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            for kk, vv in flatten_params(v, sep).items():
                out[f"{k}{sep}{kk}"] = vv
        else:
            out[k] = np.asarray(v)
    return out


def unflatten(flat: Dict[str, np.ndarray], sep: str = "/") -> Dict:
    """The inverse of :func:`flatten_params`."""
    tree: Dict = {}
    for key, v in flat.items():
        *parts, last = key.split(sep)
        node = tree
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


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
