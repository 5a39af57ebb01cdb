"""Process groups, the ('data', 'model') mesh and the collectives of the
parallel layouts — port of ``cervical_tpu/parallel/mesh.py``.

The JAX package runs one SPMD program over a device mesh and lets XLA
insert the collectives.  The port runs one process per device, joined by
``torch.distributed``:

| the JAX package                          | the port                          |
|------------------------------------------|-----------------------------------|
| ``jax.distributed.initialize``           | ``dist.init_process_group``       |
| a ('data', 'model') ``Mesh``             | a 2-D ``DeviceMesh`` of ranks     |
| the batch sharded over 'data'; XLA's     | each rank feeds its rows; one     |
| gradient psum                            | flat ``all_reduce`` per param     |
|                                          | group after backward              |
| loss and BatchNorm statistics of the     | their batch sums all-reduced with |
| global array                             | autograd (:func:`global_sums`)    |
| ``multihost_utils.sync_global_devices``  | ``dist.barrier``                  |

Backends: ``nccl`` for CUDA devices, ``gloo`` on the CPU and for two ranks
that share one card.  Gloo on CUDA tensors has only ``all_reduce``,
``broadcast`` and ``barrier``, so every collective of the port is one of
those three: a gather is a zero-padded ``all_reduce``.

The trainers hand their data axis down: to the step and loss factories as
an argument, to BatchNorm and the dropouts by :func:`set_data_axis` when
they place the model.  A data group of one rank sums nothing.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_TRUE = ("1", "true", "yes")
_DEVICE: Optional[torch.device] = None  # this rank's device, once initialised


def _init_method(coordinator: str) -> str:
    """``host:port`` -> ``tcp://host:port``; a ``tcp://``, ``file://`` or
    ``env://`` URL as given."""
    if "://" in coordinator:
        return coordinator
    return f"tcp://{coordinator}"


def default_backend(device=None) -> str:
    """``nccl`` for a CUDA device (the default where a card is present),
    ``gloo`` otherwise."""
    if device is None:
        return "nccl" if torch.cuda.is_available() else "gloo"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None, device=None):
    """Join the process group (train.py:288-294): ``coordinator``
    ``host:port`` (or an ``init_method`` URL), ``num_processes`` ranks, this
    one ``process_id``.  ``backend`` defaults to :func:`default_backend` of
    ``device``; under ``nccl`` the rank's card (``device``, by default
    ``cuda:{LOCAL_RANK}``) becomes the current one.  A no-op without
    ``num_processes``."""
    global _DEVICE
    if not num_processes:
        return
    backend = backend or default_backend(device)
    if device is None:
        device = (f"cuda:{local_rank(process_id)}" if backend == "nccl"
                  else "cpu")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=_init_method(coordinator),
                            world_size=int(num_processes),
                            rank=int(process_id))
    _DEVICE = device


def local_rank(process_id: Optional[int] = None) -> int:
    """``LOCAL_RANK`` (torchrun's), else the process id modulo the cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    n = max(1, torch.cuda.device_count())
    return int(process_id or 0) % n


def rank_device(device=None) -> torch.device:
    """The device a rank computes on: ``device`` if given, a bare ``cuda``
    made this rank's card; else the card chosen at initialisation."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None \
                and dist.is_initialized():
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if _DEVICE is not None:
        return _DEVICE
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def initialize_from_cli(argv, device=None):
    """Consume the launch flags from a CLI argv and join the process group
    BEFORE any CUDA use; returns the remaining argv.

    ``--multihost true``           torchrun's ``env://`` variables (RANK,
                                   WORLD_SIZE, MASTER_ADDR, MASTER_PORT,
                                   LOCAL_RANK)
    ``--coordinator host:port --num_processes N --process_id I``
                                   explicit; ``host:port`` or a
                                   ``file://`` / ``tcp://`` URL

    Each flag takes ``--flag v`` or ``--flag=v``.  ``device`` (the CLI's
    ``--device``) picks the backend."""
    argv = list(argv)

    def pop(flag):
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

    coord = pop("--coordinator")
    nproc = pop("--num_processes")
    pid = pop("--process_id")
    auto = pop("--multihost")
    if auto and auto.lower() in _TRUE:
        env = os.environ
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in env]
        if missing:
            raise SystemExit("--multihost true reads torchrun's environment; "
                             f"missing {', '.join(missing)}")
        initialize_multihost("env://", int(env["WORLD_SIZE"]),
                             int(env["RANK"]), device=_cli_device(
                                 device, local_rank()))
    elif coord or nproc is not None or pid is not None:
        if not (coord and nproc is not None and pid is not None):
            raise SystemExit(
                "explicit multihost launch needs ALL of --coordinator "
                "host:port, --num_processes N and --process_id I "
                "(got coordinator={}, num_processes={}, process_id={})"
                .format(coord, nproc, pid))
        initialize_multihost(coord, int(nproc), int(pid),
                             device=_cli_device(device,
                                                local_rank(int(pid))))
    return argv


def _cli_device(device, index: int):
    """A CLI's ``--device`` (default: a card where there is one): a bare
    ``cuda`` means this rank's card."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return f"cuda:{index}" if device == "cuda" else device


def is_primary() -> bool:
    """True on the rank that writes files (the reference's ``local_rank ==
    0`` guards, train.py:353-359, utils_fit.py:185-198)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier(name: str = "barrier"):
    """Every rank waits for the others (``dist.barrier``, train.py:308,
    581); a no-op in one process.  ``name`` labels the call site."""
    del name
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def make_mesh(num_devices: Optional[int] = None, model_parallel: int = 1):
    """The ('data', 'model') ``DeviceMesh`` over the process group's ranks,
    ``num_devices`` of them (default: the world, which it must equal — one
    process per device).  Ranks fill it row-major: ``model`` is the fast
    axis."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: launch with "
                           "--coordinator/--num_processes/--process_id or "
                           "torchrun (initialize_from_cli)")
    world = dist.get_world_size()
    n = world if num_devices is None else int(num_devices)
    if n != world:
        raise ValueError(f"num_devices={n} differs from the world size "
                         f"{world} (one process per device)")
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model={model_parallel}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(n).reshape(n // model_parallel, model_parallel)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))


def data_sharding(mesh, ndim: int = 1) -> tuple:
    """The placement of a batch-leading array of rank ``ndim``: rows over
    'data', the other axes whole (JAX's ``P('data', None, ...)``); the
    rows themselves come from :func:`shard_batch`."""
    del mesh
    return ("data",) + (None,) * (ndim - 1)


def replicated_sharding(mesh) -> tuple:
    """The placement of a replicated array (JAX's ``P()``): every rank holds
    all of it."""
    del mesh
    return ()


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its process ``group``, this
    rank's index on it and its size."""
    group: object
    rank: int
    size: int


def axis(mesh, name: str) -> Axis:
    return Axis(mesh.get_group(name), mesh.get_local_rank(name),
                mesh.size(mesh.mesh_dim_names.index(name)))


def rank_rows(a, data: Optional[Axis], dim: int = 0):
    """This rank's share of the global batch axis ``dim`` of ``a`` (an
    array, a tensor, or a ``range`` of row indices): all of it without a
    data axis; a share that does not divide raises."""
    if data is None:
        return a
    n = len(a) if dim == 0 else a.shape[dim]
    if n % data.size:
        raise ValueError(f"batch {n} does not divide over {data.size} "
                         "data-parallel ranks")
    b = n // data.size
    mine = slice(data.rank * b, (data.rank + 1) * b)
    return a[mine] if dim == 0 else a[(slice(None),) * dim + (mine,)]


def any_rank(flag: bool, device) -> bool:
    """Whether ``flag`` is set on any rank (a stop request: all ranks stop
    together); ``flag`` itself in one process."""
    if not dist.is_initialized():
        return flag
    t = torch.tensor([float(flag)], device=device)
    dist.all_reduce(t)
    return bool(t.item() > 0)


def local_batch_slice(global_batch: int, mesh=None) -> slice:
    """This rank's rows of a global batch on the data axis
    (DistributedSampler's share, train.py:496-499)."""
    if mesh is None:
        return slice(0, global_batch)
    a = axis(mesh, "data")
    per = global_batch // a.size
    return slice(a.rank * per, (a.rank + 1) * per)


def shard_batch(batch, mesh, batch_axis: int = 0, device=None):
    """This rank's rows of each array of a global ``batch`` (a tensor, an
    array or a tuple/list/dict of them), as tensors on ``device`` (the
    rank's).  A batch axis that does not divide the data axis raises: each
    rank would hold a different share and silently diverge — pad with
    ``data.pipeline.host_local_batches(with_weights=True)``."""
    device = rank_device(device)
    a = axis(mesh, "data")

    def put(x):
        t = torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) else x
        n = t.shape[batch_axis] if t.ndim > batch_axis else None
        if n is None or n % a.size:
            raise ValueError(
                f"multi-process shard_batch: batch dim {n} is not divisible "
                f"by the {a.size} ranks of the data axis; pad via "
                "host_local_batches(with_weights=True) or size the global "
                "batch divisibly")
        per = n // a.size
        return t.narrow(batch_axis, a.rank * per, per).to(device)

    if isinstance(batch, dict):
        return {k: put(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(put(v) for v in batch)
    return put(batch)


# -- the data axis's collectives ----------------------------------------------

def set_data_axis(model, data: Optional[Axis]) -> None:
    """Hand the data axis to every module of ``model`` that takes one (its
    class declares ``data_axis``: ``ops.conv.BatchNorm2d``, the dropouts,
    ``FusionMAE``), as ``SyncBatchNorm`` takes a process group: their
    train-mode statistics and masks then span the global batch."""
    for m in model.modules():
        if hasattr(type(m), "data_axis"):
            m.data_axis = data


class _AllSum(torch.autograd.Function):
    """``all_reduce`` SUM with autograd: its backward sums the ranks'
    upstream gradients (``torch.distributed.nn.functional.all_reduce``'s
    rule, written out: that function is deprecated)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return None, _AllSum.apply(ctx.group, grad)


def all_sum(x, group):
    """Sum of ``x`` over ``group``'s ranks; autograd sums the gradients."""
    return _AllSum.apply(group, x)


def global_sums(data: Optional[Axis], *tensors):
    """Each tensor summed over the ranks of the data axis ``data``, in one
    packed ``all_reduce`` with autograd; unchanged without one, or at one
    rank.  Every rank then holds the global batch's sums, so a ratio of
    them is the global loss, and backward leaves each rank ``n`` times its
    share of the global gradient (the trainer divides the gradient
    all-reduce by ``n``)."""
    if data is None or data.size == 1:
        return tensors
    dt = torch.float32
    for t in tensors:
        dt = torch.promote_types(dt, t.dtype)
    flat = torch.cat([t.reshape(-1).to(dt) for t in tensors])
    flat = all_sum(flat, data.group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return tuple(out)


def allreduce_mean_(tensors, group, size: int) -> None:
    """In place: each tensor's mean over ``group`` (``size`` ranks), one
    flat ``all_reduce`` for the list."""
    tensors = [t for t in tensors if t is not None]
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(size)
    torch._foreach_copy_(tensors, [v.view(t.shape) for v, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)])


@torch.no_grad()
def broadcast_(tensors, src: int = 0, group=None) -> None:
    """In place: every rank takes rank ``src``'s values (a flat
    ``broadcast`` per dtype)."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src, group=group)
        torch._foreach_copy_(ts, [v.view(t.shape) for v, t in zip(
            flat.split([t.numel() for t in ts]), ts)])


def gather_rows(x, group, rank: int, size: int, dim: int = 0):
    """The ranks' ``x`` concatenated along ``dim`` in rank order, on every
    rank: a zero-padded ``all_reduce`` (no autograd)."""
    if size == 1:
        return x
    shape = list(x.shape)
    n = shape[dim]
    shape[dim] = n * size
    out = x.new_zeros(shape)
    out.narrow(dim, rank * n, n).copy_(x)
    dist.all_reduce(out, group=group)
    return out
