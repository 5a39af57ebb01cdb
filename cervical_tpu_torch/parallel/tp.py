"""Tensor-parallel layout of the fusion model — port of
``cervical_tpu/parallel/tp.py``.

The JAX package writes the Megatron split as GSPMD sharding annotations on
``FusionMAE``'s params and lets XLA insert the collectives.  The port
splits the layers over the mesh's ``model`` axis itself, with hand-written
collectives that use ``all_reduce`` only (gloo on CUDA tensors has no
``all_gather``):

* a **column-parallel** ``Linear`` (``place_params``) keeps its output
  shard: its weight's rows and its bias.  Its input is replicated, and its
  backward all-reduces the input's gradient (Megatron's ``f``).  Where no
  row-parallel layer follows (the SAGE convs, ``patch_embed``,
  ``encoder_to_decoder``) the shards are gathered by a zero-padded
  ``all_reduce`` whose backward takes the rank's slice.
* a **row-parallel** ``Linear`` keeps its input shard: its weight's
  columns.  It all-reduces its partial product (backward: identity,
  Megatron's ``g``), then adds the replicated bias.  ``decoder.head`` takes
  a replicated input, so it first takes its slice (backward: the gather).
* between a pair, per-shard work stays on the shard: the attention's heads
  (``qkv`` is split head-aligned, each rank holding q, k and v of its own
  heads), the tower's ``norm1_{m}`` (a ``GraphNorm`` whose sample
  statistics are all-reduced and whose replicated affine is sliced) and
  ``drop1_{m}`` and ``attn_drop`` (each takes its slice of the global
  dropout mask, ``KeyedDropout.shard``).
* everything else — norms, pools' softmax, the 4-wide token mix, the
  towers' small layers and heads — is replicated, as in JAX.

A layer pair whose split dimension does not divide the ``model`` axis is
replicated instead and logged (GSPMD pads it; the numbers are the same).
Replicated params get the same gradient on every rank of the model axis;
a checkpoint holds full tensors (:func:`full_state_dict`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from cervical_tpu_torch.parallel.mesh import Axis, all_sum, axis

# JAX's module names -> the port's (models/fusion.py, models/layers.py)
_COLUMN = ("lin_l", "lin_r", "gate_nn.0", "qkv", "fc1", "patch_embed",
           "encoder_to_decoder", "mix_mip_2.0")
_ROW = ("gate_nn.2", "proj", "fc2", "head", "mix_mip_2.2")


def _split_for(module: str) -> Optional[str]:
    """'column' / 'row' / None for a module path of the port's FusionMAE
    (``qkv``, ``fc1``, SAGE ``lin_l``/``lin_r``, ``gate_fc1`` =
    ``gate_nn.0``, ``channel_mix_fc1`` = ``mix_mip_2.0``, ``lin1_*``
    column; ``proj``, ``fc2``, ``head``, ``gate_fc2`` = ``gate_nn.2``,
    ``channel_mix_fc2`` = ``mix_mip_2.2``, ``lin2_*`` row)."""
    parts = module.split(".")
    last, two = parts[-1], ".".join(parts[-2:])
    if last in _COLUMN or two in _COLUMN or last.startswith("lin1_"):
        return "column"
    if last in _ROW or two in _ROW or last.startswith("lin2_"):
        return "row"
    return None


def fusion_param_specs(model: nn.Module, axis_name: str = "model"):
    """A spec per param of a ``FusionMAE``, in torch's (out, in) order:
    ``(axis, None)`` on column weights, ``(axis,)`` on column biases,
    ``(None, axis)`` on row weights, ``()`` elsewhere (a row bias is added
    after the reduction: replicated)."""
    out = {}
    for name, p in model.named_parameters():
        module, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        split = _split_for(module)
        spec = ()
        if split == "column":
            if leaf == "weight" and p.ndim == 2:
                spec = (axis_name, None)
            elif leaf == "bias" and p.ndim == 1:
                spec = (axis_name,)
        elif split == "row" and leaf == "weight" and p.ndim == 2:
            spec = (None, axis_name)
        out[name] = spec
    return out


# -- collectives over the model axis --------------------------------------------

class _Copy(torch.autograd.Function):
    """Identity forward; backward sums the ranks' input gradients."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return None, grad


class _Reduce(torch.autograd.Function):
    """All-reduce SUM forward; identity backward (the output is used
    replicated, so each rank's upstream gradient is already the whole)."""

    @staticmethod
    def forward(ctx, group, x):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return None, grad


def _gather_last(x, a: Axis):
    shape = list(x.shape)
    n = shape[-1]
    shape[-1] = n * a.size
    out = x.new_zeros(shape)
    out.narrow(-1, a.rank * n, n).copy_(x)
    dist.all_reduce(out, group=a.group)
    return out


class _Gather(torch.autograd.Function):
    """The ranks' last-axis shards concatenated (a zero-padded
    ``all_reduce``); backward takes the rank's slice."""

    @staticmethod
    def forward(ctx, a, x):
        ctx.a, ctx.n = a, x.shape[-1]
        return _gather_last(x, a)

    @staticmethod
    def backward(ctx, grad):
        return None, grad.narrow(-1, ctx.a.rank * ctx.n, ctx.n).contiguous()


class _Scatter(torch.autograd.Function):
    """The rank's slice of a replicated last axis; backward gathers."""

    @staticmethod
    def forward(ctx, a, x):
        ctx.a = a
        n = x.shape[-1] // a.size
        return x.narrow(-1, a.rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return None, _gather_last(grad.contiguous(), ctx.a)


def _linear(x, weight, bias, dtype):
    """``models.layers.Linear``'s product on a 2-D input (flax's dtype
    rule)."""
    if dtype is None:
        return F.linear(x, weight, bias)
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


class LinearShard:
    """A ``Linear``'s tensor-parallel forward (``Linear.tp``): ``kind``
    "column" (``gather``: concatenate the shards after) or "row"
    (``scatter``: its input arrives replicated)."""

    def __init__(self, kind: str, a: Axis, gather: bool = False,
                 scatter: bool = False):
        self.kind, self.axis = kind, a
        self.gather, self.scatter = gather, scatter

    def forward(self, lin, x):
        a = self.axis
        lead = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1])
        if self.kind == "column":
            y = _linear(_Copy.apply(a.group, x), lin.weight, lin.bias,
                        lin.dtype)
            if self.gather:
                y = _Gather.apply(a, y)
        else:
            if self.scatter:
                x = _Scatter.apply(a, x)
            y = _Reduce.apply(a.group, _linear(x, lin.weight, None,
                                               lin.dtype))
            if lin.bias is not None:
                y = y + lin.bias.to(y.dtype)
        return y.reshape(*lead, y.shape[-1])


class GraphNormShard:
    """``GraphNorm`` on a channel shard (``GraphNorm.tp``): each sample's
    mean and variance over the global channels, their sums all-reduced
    (backward sums: the statistics feed each rank's own shard); the
    replicated affine sliced, its gradient summed over the ranks."""

    def __init__(self, a: Axis):
        self.axis = a

    def forward(self, norm, x):
        a = self.axis
        dims = tuple(range(1, x.ndim))
        xf = x.to(torch.float32)
        count = xf[0].numel() * a.size
        mean = all_sum(xf.sum(dims, keepdim=True), a.group) / count
        d = xf - mean
        var = all_sum((d * d).sum(dims, keepdim=True), a.group) / count
        y = d / (torch.sqrt(var) + norm.eps)
        n = x.shape[-1]
        w = _Copy.apply(a.group, norm.weight).narrow(0, a.rank * n, n)
        b = _Copy.apply(a.group, norm.bias).narrow(0, a.rank * n, n)
        return (y * w + b).to(norm.dtype or x.dtype)


# -- placement ----------------------------------------------------------------------

def _take(full, dim: int, a: Axis, view=None):
    """Rank ``a.rank``'s slice of ``full`` along ``dim`` (of ``view``, a
    shape exposing the split axis, if given), as a tensor of the local
    shape."""
    t = full.view(view) if view is not None else full
    n = t.shape[dim] // a.size
    local = t.narrow(dim, a.rank * n, n)
    if view is not None:
        local = local.reshape((-1,) + tuple(full.shape[1:]))
    return local.contiguous()


def _shard(module: nn.Module, pname: str, dim: int, a: Axis, registry,
           prefix: str, view=None):
    full = getattr(module, pname)
    local = _take(full.detach(), dim, a, view)
    setattr(module, pname, nn.Parameter(local, requires_grad=full.requires_grad))
    registry[f"{prefix}.{pname}" if prefix else pname] = (
        dim, view, tuple(full.shape), a)


def _unshard(local, dim: int, view, full_shape, a: Axis):
    """The full tensor from each rank's ``local`` slice: a zero-padded
    ``all_reduce`` over the model axis."""
    vshape = list(view if view is not None else full_shape)
    n = vshape[dim] // a.size
    out = local.new_zeros(vshape)
    lshape = list(vshape)
    lshape[dim] = n
    out.narrow(dim, a.rank * n, n).copy_(local.reshape(lshape))
    dist.all_reduce(out, group=a.group)
    return out.reshape(full_shape)


def place_params(model: nn.Module, mesh, log=print) -> Dict[str, tuple]:
    """Split a ``FusionMAE`` in place over ``mesh``'s ``model`` axis (see
    the module docstring); returns the sharded params by name ->
    ``(dim, view, full shape, axis)``, also kept as ``model.tp_shards``.
    With a ``model`` axis of 1 nothing changes.  A pair whose split
    dimension does not divide the axis stays replicated; ``log`` says so.
    Create the optimizer after this call: it must see the shards."""
    a = axis(mesh, "model")
    registry: Dict[str, tuple] = {}
    model.tp_shards = registry
    if a.size == 1:
        return registry
    names = {m: n for n, m in model.named_modules()}

    def divides(what, width):
        if width % a.size:
            log(f"tensor parallel: {what} ({width}) does not divide "
                f"model={a.size}; replicated")
            return False
        return True

    def column(lin, gather=False, view=None):
        _shard(lin, "weight", 0 if view is None else 1, a, registry,
               names[lin], view)
        if lin.bias is not None:
            _shard(lin, "bias", 0, a, registry, names[lin])
        lin.tp = LinearShard("column", a, gather=gather)

    def row(lin, scatter=False):
        _shard(lin, "weight", 1, a, registry, names[lin])
        lin.tp = LinearShard("row", a, scatter=scatter)

    for m in model.modalities:
        gnn = getattr(model, f"{m}_gnn_2")
        if divides(f"{m}_gnn_2", gnn.lin_l.out_features):
            column(gnn.lin_l, gather=True)
            column(gnn.lin_r, gather=True)
        for pool in (getattr(model, f"mpool_{m}"),
                     getattr(model, f"mpool_{m}_2")):
            fc1, fc2 = pool.gate_nn[0], pool.gate_nn[2]
            if divides(f"{names[pool]}.gate_nn", fc1.out_features):
                column(fc1)
                row(fc2)
        lin1, lin2 = getattr(model, f"lin1_{m}"), getattr(model, f"lin2_{m}")
        if divides(f"lin1_{m}/lin2_{m}", lin1.out_features):
            column(lin1)
            row(lin2)
            getattr(model, f"norm1_{m}").tp = GraphNormShard(a)
            getattr(model, f"drop1_{m}").shard = (1, a.rank, a.size)
    mae = getattr(model, "mae", None)
    if mae is not None:
        d = mae.encoder.patch_embed.out_features
        if divides("mae.encoder.patch_embed", d):
            column(mae.encoder.patch_embed, gather=True)
        for blk in (*mae.encoder.blocks, *mae.decoder.blocks):
            att = blk.attn
            if divides(f"{names[att]} heads", att.num_heads):
                hd = att.head_dim
                column(att.qkv, view=(3, att.num_heads, hd,
                                      att.qkv.in_features))
                row(att.proj)
                att.attn_drop.shard = (1, a.rank, a.size)
            if divides(f"{names[blk.mlp]}", blk.mlp.fc1.out_features):
                column(blk.mlp.fc1)
                row(blk.mlp.fc2)
        if divides("mae.encoder_to_decoder",
                   mae.encoder_to_decoder.out_features):
            column(mae.encoder_to_decoder, gather=True)
        if divides("mae.decoder.head", mae.decoder.head.in_features):
            row(mae.decoder.head, scatter=True)
        mix = getattr(model, "mix", None)
        if mix is not None and divides("mix.mix_mip_2",
                                       mix.mix_mip_2[0].out_features):
            column(mix.mix_mip_2[0])
            row(mix.mix_mip_2[2])
    if hasattr(model, "_masks"):
        model._masks.clear()  # the dropout index plans see the shards
    return registry


@torch.no_grad()
def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every tensor-parallel shard gathered to
    the full tensor (a collective: every rank of the model axis calls
    it)."""
    sd = model.state_dict()
    for name, (dim, view, shape, a) in getattr(model, "tp_shards",
                                               {}).items():
        sd[name] = _unshard(sd[name], dim, view, shape, a)
    return sd
