"""Segmentation trainer: model construction, optimizers, the train and eval
steps, the host-fed epoch and the two-phase ``fit`` loop with checkpoints,
callbacks and a graceful stop — port of ``cervical_tpu/train/seg_trainer.py``
(reference: ``Segmentation/deeplabv3+/train.py`` + ``utils/utils_fit.py``).

One train step: uint8 batch -> augmentation on the card (the einsum
backend of ``ops/warp_xla.py``, the default, or the K1-K3 kernels of
``ops/warp.py``) -> DeepLab forward in train mode (bf16 convs, fp32
BatchNorm on batch statistics) -> the class-major loss bundle (focal or CE
+ dice, f-score, the x4 logits upsample inside) -> backward -> Adam (or
Nesterov SGD) with coupled L2 on separate backbone and head optimizers.
In the freeze phase the backbone runs without autograd and its optimizer
does not step: its params and its Adam state stay bit-identical, while its
BatchNorm running stats still update (train.py:447-452).

``steps_per_call`` K > 1 groups K batches into one K-step call (the JAX
package's ``lax.scan`` program); on the card that call is a replayed CUDA
graph (``train/graphs.py``), on the CPU the same steps run eagerly.  With
``device_resident`` the epoch reads its batches from a copy of the dataset
on the card (``data/resident.py``) and only index vectors, parameter rows
and the LR cross the host link.

Data parallelism (``mesh``, ``parallel/mesh.py``): one process per device;
each rank feeds its rows of every global batch and draws the global
batch's augmentation rows and dropout masks from the shared seeded streams,
keeping its own rows.  The loss and the BatchNorm statistics are the global
batch's (their sums all-reduced with autograd), and one flat ``all_reduce``
per param group after backward, divided by the rank count, leaves every
rank the global gradient: the step of ``n`` ranks is the one-process step
on the global batch.  The model is not wrapped in
``DistributedDataParallel``: the step holds its collectives, so under NCCL
the K-step CUDA graph captures them.
"""

from __future__ import annotations

import dataclasses
import functools
import signal
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from cervical_tpu_torch import losses
from cervical_tpu_torch.config import SegTrainConfig
from cervical_tpu_torch.data.pipeline import device_prefetch
from cervical_tpu_torch.metrics import confusion_matrix, summarize_hist
from cervical_tpu_torch.models.deeplab import DeepLab
from cervical_tpu_torch.ops import augment as aug_ops
from cervical_tpu_torch.parallel import mesh as P
from cervical_tpu_torch.train import schedules
from cervical_tpu_torch.train.graphs import GraphedCall
from cervical_tpu_torch.utils.profiling import span


def _dtype(cfg: SegTrainConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def build_model(cfg: SegTrainConfig, fused_middle: bool = False) -> DeepLab:
    """DeepLab per ``cfg``; its dropouts are seeded from ``cfg.seed``."""
    return DeepLab(num_classes=cfg.data.num_classes, backbone=cfg.backbone,
                   downsample_factor=cfg.downsample_factor, dtype=_dtype(cfg),
                   fused_middle=fused_middle, dropout_seed=cfg.seed + 2)


@torch.no_grad()
def reference_weights_init(model: nn.Module, generator: torch.Generator,
                           init_gain: float = 0.02) -> nn.Module:
    """``weights_init`` (deeplabv3_training.py:58-76), as the JAX package's
    ``reference_weights_init``: every conv kernel ~ N(0, 0.02), every
    BatchNorm scale ~ N(1, 0.02), BN biases 0, running stats reset.  Conv
    biases are redrawn from torch's default U(±1/sqrt(fan_in)) with the
    same ``generator``, so the whole state is a function of its seed."""
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.weight.copy_(1.0 + init_gain * torch.randn(
                m.weight.shape, generator=generator))
            m.bias.zero_()
            m.reset_running_stats()
        elif hasattr(m, "weight") and isinstance(m.weight, nn.Parameter) \
                and m.weight.ndim == 4:
            m.weight.copy_(init_gain * torch.randn(m.weight.shape,
                                                   generator=generator))
            bias = getattr(m, "bias", None)
            if isinstance(bias, nn.Parameter):
                bound = 1.0 / (m.weight[0].numel() ** 0.5)
                bias.copy_((torch.rand(bias.shape, generator=generator) * 2
                            - 1) * bound)
    return model


@dataclasses.dataclass
class TrainState:
    """The model (params and BatchNorm running stats) and one optimizer per
    param group, ``{"backbone": ..., "head": ...}`` (the fusion model's
    one group: ``{"params": ...}``)."""

    model: DeepLab
    opt_state: Dict[str, torch.optim.Optimizer]
    step: int = 0


def _split_params(model: nn.Module):
    """(backbone params, every other param), in ``named_parameters`` order."""
    backbone, head = [], []
    for name, p in model.named_parameters():
        (backbone if name.startswith("backbone.") else head).append(p)
    return backbone, head


class NesterovSGD(torch.optim.SGD):
    """torch's Nesterov SGD that also takes its LR as a 0-dim device
    tensor: then it runs torch's own foreach update with the LR as a
    tensor operand (the form ``torch.optim.SGD`` takes under
    ``torch.compile``), which reads the LR on the card and so can be
    captured in a CUDA graph.  A float LR takes torch's path unchanged."""

    @torch.no_grad()
    def step(self, closure=None):
        if not any(torch.is_tensor(g["lr"]) for g in self.param_groups):
            return super().step(closure)
        for g in self.param_groups:
            params = [p for p in g["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if g["weight_decay"]:
                grads = torch._foreach_add(grads, params,
                                           alpha=g["weight_decay"])
            else:
                grads = [d.clone() for d in grads]
            m = g["momentum"]
            bufs = []
            for p, d in zip(params, grads):
                st = self.state[p]
                if st.get("momentum_buffer") is None:
                    st["momentum_buffer"] = d.clone()
                else:
                    st["momentum_buffer"].mul_(m).add_(d)
                bufs.append(st["momentum_buffer"])
            torch._foreach_add_(grads, bufs, alpha=m)
            torch._foreach_add_(params, torch._foreach_mul(grads, -g["lr"]))


def make_optimizer(cfg: SegTrainConfig, params,
                   capturable: bool = False) -> torch.optim.Optimizer:
    """Adam or Nesterov SGD; the LR is set per step.  torch's
    ``weight_decay`` is coupled L2 (added to the gradient before the
    moments), which is what the JAX package's ``add_decayed_weights``
    chain computes.  On the card the trainer gives the LR as a 0-dim
    device tensor, so a step can be captured in a CUDA graph: Adam with
    ``capturable`` (CUDA params) keeps its step count on the card too, and
    :class:`NesterovSGD` reads the tensor LR there.  Eager steps on the card
    take the same path, so a replayed step equals an eager one."""
    if cfg.optimizer_type == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(cfg.momentum, 0.999),
                                eps=1e-8, weight_decay=cfg.weight_decay,
                                capturable=capturable)
    return NesterovSGD(params, lr=0.0, momentum=cfg.momentum, nesterov=True,
                       weight_decay=cfg.weight_decay)


def load_pretrained(cfg: SegTrainConfig, model: nn.Module, log=print):
    """Load ``cfg.pretrained`` into ``model`` in place: a whole-model or a
    backbone-only torch checkpoint (told apart by its keys), tensors of
    another shape skipped (train.py:304-339)."""
    from cervical_tpu_torch.train import torch_import as TI

    sd = TI.load_state_dict(cfg.pretrained)
    scope = "" if TI.is_full_deeplab_sd(sd) else "backbone"
    loaded, skipped = TI.load_into(model, sd, scope)
    log(f"pretrained {cfg.pretrained!r}: loaded {len(loaded)} arrays"
        + (f", skipped {len(skipped)} shape mismatches" if skipped else ""))


def create_state(cfg: SegTrainConfig, seed: Optional[int] = None,
                 device="cuda") -> TrainState:
    """A fresh :class:`TrainState` on ``device``: ``cfg.pretrained`` loaded
    over torch's default init, else the seeded reference init
    (``weights_init="normal"``) or torch's defaults (``"none"``)."""
    model = build_model(cfg, fused_middle=cfg.fused_middle_eval)
    if cfg.pretrained:
        load_pretrained(cfg, model)
    elif cfg.weights_init == "normal":
        seed = cfg.seed if seed is None else seed
        reference_weights_init(model, torch.Generator().manual_seed(seed))
    device = torch.device(device)
    model.to(device)
    if device.type == "cuda":
        model.to(memory_format=torch.channels_last)
    backbone, head = _split_params(model)
    cap = device.type == "cuda"
    return TrainState(model, {"backbone": make_optimizer(cfg, backbone, cap),
                              "head": make_optimizer(cfg, head, cap)})


@functools.lru_cache(maxsize=8)
def _class_weights(weights: tuple, device: torch.device) -> torch.Tensor:
    """The class weights on ``device``, uploaded once (a list turned into a
    CUDA tensor per step is a blocking copy)."""
    return torch.tensor(weights, dtype=torch.float32).to(device)


def seg_loss_fn(cfg: SegTrainConfig, logits, labels, one_hot,
                sample_weights=None):
    """The reference-shaped loss ``(total, main)``: focal or CE
    (``cfg.focal_loss``) with the config's class weights, plus dice
    (``cfg.dice_loss``) over ``one_hot`` (num_classes + 1 channels);
    ``logits`` NHWC at the labels' resolution.  The train and eval steps
    use :func:`seg_loss_bundle_fn`, which computes the same in one pass."""
    cls_w = _class_weights(tuple(cfg.cls_weights), logits.device)
    nc = cfg.data.num_classes
    loss = losses.focal_loss if cfg.focal_loss else losses.cross_entropy_loss
    main = loss(logits, labels, cls_w, nc, sample_weights=sample_weights)
    total = main
    if cfg.dice_loss:
        total = total + losses.dice_loss(logits, one_hot,
                                         sample_weights=sample_weights)
    return total, main


def seg_loss_bundle_fn(cfg: SegTrainConfig, logits, labels,
                       sample_weights=None, resize_to=None,
                       return_preds: bool = False, data=None):
    """:func:`losses.seg_loss_bundle` with the config's classes, class
    weights and loss choice; ``logits`` NHWC; ``data`` the data axis."""
    return losses.seg_loss_bundle(
        logits, labels, _class_weights(tuple(cfg.cls_weights), logits.device),
        cfg.data.num_classes,
        focal=cfg.focal_loss, dice=cfg.dice_loss,
        sample_weights=sample_weights, resize_to=resize_to,
        return_preds=return_preds, data=data)


def make_train_aug_fn(cfg: SegTrainConfig, data=None):
    """The train-time augmentation ``(images_u8, labels_u8, params) ->
    (images (B, H, W, 3) bf16 in [0, 1], labels uint8)`` of
    ``cfg.data.aug_backend``:

    * "einsum" (the default): ``ops.warp_xla.augment_batch_einsum``,
      rotation on the first and blur on the last ``max(1, B // 4)`` images
      (the step's sampler draws them there; a rank of the data axis
      ``data`` holds its share of those rows), ``cfg.data.two_shear``;
    * "pallas": the K1-K3 kernel path (``ops.warp.augment_batch_kernels``,
      the JAX package's name), exact 3-shear, rotation and blur per
      image."""
    hw = tuple(cfg.data.input_shape)
    backend = cfg.data.aug_backend
    if backend == "einsum":
        from cervical_tpu_torch.ops.warp_xla import augment_batch_einsum
        rows = (0, 1) if data is None else (data.rank, data.size)

        def aug(images, labels, params):
            rot, blur = einsum_capacities(images.shape[0], *rows)
            return augment_batch_einsum(images, labels, params, hw,
                                        rotate=rot > 0,
                                        rotate_capacity=rot,
                                        blur=blur > 0, blur_capacity=blur,
                                        two_shear=cfg.data.two_shear)
    elif backend == "pallas":
        from cervical_tpu_torch.ops.warp import augment_batch_kernels

        def aug(images, labels, params):
            return augment_batch_kernels(images, labels, params, hw)
    else:
        raise ValueError(f"unknown aug_backend {backend!r} "
                         "(expected 'einsum' or 'pallas')")
    return aug


def einsum_capacities(b: int, rank: int = 0, ranks: int = 1):
    """(rotated, blurred) row counts of a rank's ``b`` rows for the einsum
    backend: the global batch of ``ranks * b`` rotates its first and blurs
    its last ``max(1, B // 4)`` rows, so a rank holds a prefix of the
    rotated rows and a suffix of the blurred ones (possibly none)."""
    big = b * ranks
    cap = max(1, big // 4)
    rot = min(b, max(0, cap - rank * b))
    blur = min(b, max(0, (rank + 1) * b - (big - cap)))
    return rot, blur


def _sample_step_aug_params(cfg: SegTrainConfig, generator: torch.Generator,
                            batch: int):
    """One step's parameters: rotation on the first ``max(1, B//4)``
    images, blur on the last as many (the loader shuffles, so each image's
    rates stay the reference's 25%)."""
    cap = max(1, batch // 4)
    return aug_ops.sample_augment_params(
        generator, batch, jitter=cfg.data.jitter,
        scale_range=(cfg.data.scale_min, cfg.data.scale_max),
        hue=cfg.data.hue, sat=cfg.data.sat, val=cfg.data.val,
        rotate_prefix=cap, blur_suffix=cap)


def _check_aug_cfg(cfg: SegTrainConfig):
    """``aug_pre_batch`` needs the pallas backend: its per-image rotation
    and blur make the merged batch equal the per-step path, where the
    einsum backend's prefix and suffix cannot describe K stacked
    sub-batches.  Every train-step factory checks, so a wrong config fails
    when the step is built."""
    if cfg.data.aug_pre_batch and cfg.data.aug_backend != "pallas":
        raise ValueError("aug_pre_batch requires aug_backend='pallas'")


def _make_train_body(cfg: SegTrainConfig, frozen: bool,
                     pre_augmented: bool = False, data=None):
    """``step(state, images, labels, aug_params, lr) -> metrics``: one
    optimizer step in place on ``state``.  The metrics are unsynced 0-dim
    tensors ``loss``, ``main_loss``, ``f_score``.  ``lr`` is a float, or on
    the card a 0-dim device tensor (:func:`make_optimizer`).  ``pre_augmented``:
    the batch arrives augmented (bf16 [0, 1] images, uint8 labels) and
    ``aug_params`` is ignored.  ``data`` (a ``parallel.mesh.Axis``): the
    batch is this rank's rows of the global batch; the loss is the global
    batch's, and the gradient all-reduced to the global one."""
    aug_fn = None if pre_augmented else make_train_aug_fn(cfg, data)
    nc = cfg.data.num_classes
    dt = _dtype(cfg)

    def step(state: TrainState, images, labels, aug_params, lr):
        if not pre_augmented:
            images, labels = aug_fn(images, labels, aug_params)
        images = images.to(dt)
        labels = torch.clamp(labels, max=nc)
        model = state.model
        model.train()
        for opt in state.opt_state.values():
            opt.zero_grad(set_to_none=True)
        logits = model(images.permute(0, 3, 1, 2), resize_logits=False,
                       freeze_backbone=frozen)
        total, main, fs = seg_loss_bundle_fn(
            cfg, logits.permute(0, 2, 3, 1), labels,
            resize_to=tuple(images.shape[1:3]), data=data)
        total.backward()
        # a frozen backbone gets no optimizer step at all: params and Adam
        # state (moments and count) untouched
        groups = ("head",) if frozen else ("head", "backbone")
        if data is not None:  # the global gradient, one flat all_reduce each
            for g in groups:
                P.allreduce_mean_(
                    [p.grad for pg in state.opt_state[g].param_groups
                     for p in pg["params"]], data.group, data.size)
        for g in groups:
            opt = state.opt_state[g]
            for pg in opt.param_groups:
                pg["lr"] = lr
            opt.step()
        state.step += 1
        return {"loss": total.detach(), "main_loss": main.detach(),
                "f_score": fs.detach()}

    return step


def make_train_step(cfg: SegTrainConfig, frozen: bool, data=None):
    """``step(state, images_u8 (B,H,W,3), labels_u8 (B,H,W), aug_params,
    lr) -> metrics``: one optimizer step in place on ``state``
    (:func:`_make_train_body`)."""
    _check_aug_cfg(cfg)
    return _make_train_body(cfg, frozen, data=data)


def _stack(metrics):
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def make_train_step_scan(cfg: SegTrainConfig, frozen: bool, k: int,
                         data=None):
    """``scan(state, images (K,B,H,W,3) u8, labels (K,B,H,W) u8, rows
    (K,B,10), lr) -> metrics`` of shape (K,): K optimizer steps, the
    port's counterpart of the JAX package's ``make_train_step_scan``.
    ``rows`` are K steps' augmentation parameters
    (``ops.augment.params_to_rows``).

    ``cfg.data.aug_pre_batch`` (pallas only): augment the K sub-batches as
    one (K*B) batch first, then run the K steps; equal to the per-step
    path bit for bit, since the kernels rotate and blur per image."""
    _check_aug_cfg(cfg)
    if cfg.data.aug_pre_batch and k > 1:
        body = _make_train_body(cfg, frozen, pre_augmented=True, data=data)
        aug_fn = make_train_aug_fn(cfg, data)

        def scan(state, images, labels, rows, lr):
            b = images.shape[1]

            def flat(a):
                return a.reshape((k * b,) + a.shape[2:])

            ia, la = aug_fn(flat(images), flat(labels),
                            aug_ops.rows_to_params(flat(rows)))
            ia = ia.reshape((k, b) + ia.shape[1:])
            la = la.reshape((k, b) + la.shape[1:])
            return _stack([body(state, ia[i], la[i], None, lr)
                           for i in range(k)])
        return scan

    body = _make_train_body(cfg, frozen, data=data)

    def scan(state, images, labels, rows, lr):
        return _stack([body(state, images[i], labels[i],
                            aug_ops.rows_to_params(rows[i]), lr)
                       for i in range(k)])
    return scan


def _rows_of(idx, i: int, batch: int, gather: bool, offset: int = 0,
             count: Optional[int] = None):
    """Call ``i``'s image rows of a resident set: ``idx`` (K, B) row
    indices (``gather``), or (K,) batch indices read as ``[j*B, (j+1)*B)``
    (of which a rank reads ``count`` rows from ``offset``)."""
    if gather:
        return idx[i]
    return idx[i] * batch + offset + torch.arange(
        batch if count is None else count, device=idx.device)


def make_train_step_scan_resident(cfg: SegTrainConfig, frozen: bool, k: int,
                                  batch: int, gather: bool = False,
                                  data=None):
    """``scan(state, images (N,H,W,3), labels (N,H,W), idx, rows, lr) ->
    metrics (K,)``: K steps reading their batches from a device-resident
    set (``data.resident.ResidentSegData``).  ``gather=False``: ``idx`` is
    (K,) batch indices; ``gather=True`` (``resident_shuffle="gather"``):
    (K, B) image row indices, a per-epoch reshuffle with no data motion."""
    _check_aug_cfg(cfg)
    if cfg.data.aug_pre_batch:
        raise ValueError("aug_pre_batch is not supported on the resident "
                         "path")
    body = _make_train_body(cfg, frozen, data=data)

    def scan(state, images, labels, idx, rows, lr):
        out = []
        for i in range(k):
            r = _rows_of(idx, i, batch, gather)
            out.append(body(state, images.index_select(0, r),
                            labels.index_select(0, r),
                            aug_ops.rows_to_params(rows[i]), lr))
        return _stack(out)
    return scan


def make_eval_step(cfg: SegTrainConfig, data=None):
    """``step(state, images_u8, labels_u8, weights=None) -> {"loss",
    "f_score", "hist"}``: letterbox to the input shape, eval-mode forward,
    the loss bundle and the (nc, nc) confusion matrix of the argmax.
    Weight-0 rows become all-ignore: no loss, no confusion cell.  ``data``:
    the loss sums and the matrix span that data axis's ranks."""
    from cervical_tpu_torch.ops.warp_xla import augment_batch_einsum
    hw = tuple(cfg.data.input_shape)
    nc = cfg.data.num_classes
    dt = _dtype(cfg)

    @torch.no_grad()
    def step(state: TrainState, images, labels, weights=None):
        out = _eval_body(state, images, labels, weights)
        if data is not None:  # every real pixel of every rank, once
            out["hist"] = P.all_sum(out["hist"], data.group)
        return out

    def _eval_body(state, images, labels, weights):
        lp = aug_ops.letterbox_params_like(images.shape[0],
                                           tuple(images.shape[1:3]), hw,
                                           device=images.device)
        images, labels = augment_batch_einsum(images, labels, lp, hw,
                                              letterbox=True)
        images = images.to(dt)
        labels = torch.clamp(labels, max=nc)
        if weights is not None:
            labels = torch.where(weights[:, None, None] > 0, labels,
                                 torch.full_like(labels, nc))
        model = state.model
        model.eval()
        logits = model(images.permute(0, 3, 1, 2), resize_logits=False)
        total, _, fs, preds = seg_loss_bundle_fn(
            cfg, logits.permute(0, 2, 3, 1), labels, sample_weights=weights,
            resize_to=hw, return_preds=True, data=data)
        return {"loss": total, "f_score": fs,
                "hist": confusion_matrix(labels, preds, nc)}

    return step


def make_eval_step_scan_resident(cfg: SegTrainConfig, k: int, batch: int,
                                 offset: int = 0,
                                 count: Optional[int] = None, data=None):
    """``scan(state, images, labels, weights, idx (K,)) -> {"loss",
    "f_score", "hist"}``: K eval batches of a device-resident set, their
    loss, f-score and (nc, nc) confusion matrix summed on the card.  A
    data-parallel rank reads ``count`` rows of each batch from ``offset``."""
    step = make_eval_step(cfg, data)

    def scan(state, images, labels, weights, idx):
        loss = fs = hist = 0
        for i in range(k):
            r = _rows_of(idx, i, batch, False, offset, count)
            m = step(state, images.index_select(0, r),
                     labels.index_select(0, r), weights.index_select(0, r))
            loss, fs, hist = loss + m["loss"], fs + m["f_score"], \
                hist + m["hist"]
        return {"loss": loss, "f_score": fs, "hist": hist}
    return scan


class _Drain:
    """A window of unsynced metrics: :meth:`add` queues a call's metrics
    (0-dim, or (K,) from a K-step call) and syncs the oldest once more than
    ``depth - 1`` wait; the sums count every step (or ``count`` batches
    for a summed eval call)."""

    def __init__(self, depth: int):
        self.depth = depth
        self.pending = []
        self.sums = {"loss": 0.0, "f_score": 0.0}
        self.n = 0

    def add(self, m, count: Optional[int] = None):
        self.pending.append((m, count))
        self.drain(self.depth - 1)

    def drain(self, limit: int):
        while len(self.pending) > limit:
            m, count = self.pending.pop(0)
            for key in self.sums:
                self.sums[key] += float(m[key].sum())
            self.n += m["loss"].numel() if count is None else count

    def mean(self, key: str) -> float:
        return self.sums[key] / max(self.n, 1)


@dataclasses.dataclass
class EpochResult:
    train_loss: float
    val_loss: float
    train_f_score: float
    val_f_score: float
    seconds: float


def _default_mesh(cfg: SegTrainConfig):
    """``make_mesh(cfg.num_devices)`` under a process group; None in one
    process, where ``num_devices`` may only be 1 (or unset)."""
    if dist.is_initialized():
        return P.make_mesh(cfg.num_devices)
    if cfg.num_devices not in (None, 1):
        raise ValueError(f"num_devices={cfg.num_devices} differs from the "
                         "world size 1 (one process, no process group)")
    return None


def graph_rule(device: torch.device, mesh) -> bool:
    """Whether the trainers capture their calls as CUDA graphs: on a card,
    in one process or under NCCL (whose collectives a graph captures);
    eager under gloo, whose collectives stage through the host."""
    if device.type != "cuda":
        return False
    return mesh is None or dist.get_backend(
        P.axis(mesh, "data").group) == "nccl"


class SegTrainer:
    """The epoch driver (utils_fit.py:31-198) on one device, or one rank of
    a data-parallel ``mesh`` (``parallel.make_mesh``; by default the
    process group's, when there is one).

    ``device`` defaults to ``cuda``.  Seeds: ``cfg.seed`` (or ``seed``)
    draws the initial weights; the per-step augmentation parameters come
    from a host generator seeded ``seed + 1``, the ``"images"`` resident
    shuffle from one seeded ``seed + 3``; the dropouts from their own
    generators (``build_model``).  Under a mesh every rank draws the global
    batch's rows from these streams and keeps its own, and starts from rank
    0's weights.

    On the card each K-step call (``steps_per_call``) and each resident
    eval call is a CUDA graph, captured at its first call per (phase, K,
    batch, data) and replayed after: one graph of the K steps, as a scan
    compiles them.  Under a mesh the rule is the backend's
    (:func:`graph_rule`): NCCL graphed, gloo eager.
    """

    def __init__(self, cfg: SegTrainConfig, seed: Optional[int] = None,
                 device: str = "cuda", mesh=None):
        self.cfg = cfg
        self.device = P.rank_device(device)
        self.mesh = mesh if mesh is not None else _default_mesh(cfg)
        if self.mesh is not None and cfg.fused_middle_eval \
                and self.mesh.size() > 1:
            # the fused kernels run one card's whole batch
            raise ValueError(
                "fused_middle_eval requires a single-device mesh "
                f"(have {self.mesh.size()}); drop the flag or set "
                "num_devices=1")
        seed = cfg.seed if seed is None else seed
        self.generator = torch.Generator().manual_seed(seed + 1)
        self.shuffle_generator = torch.Generator().manual_seed(seed + 3)
        self.state = create_state(cfg, seed, self.device)
        self._steps: dict = {}
        self._graphs: dict = {}
        self.graphed = graph_rule(self.device, self.mesh)
        self.data = None
        if self.mesh is not None:
            self.data = P.axis(self.mesh, "data")
            P.set_data_axis(self.state.model, self.data)
            P.broadcast_([t.detach() for t in (*self.state.model.parameters(),
                                               *self.state.model.buffers())])
            if P.is_primary():
                print(f"data parallel: {self.data.size} ranks x "
                      f"{self.mesh.size() // self.data.size} on the model "
                      f"axis, {dist.get_backend(self.data.group)}: K-step "
                      "calls " + ("captured as CUDA graphs" if self.graphed
                                  else "eager"))

    def _step_fn(self, key, make):
        if key not in self._steps:
            self._steps[key] = make()
        return self._steps[key]

    def _train_step(self, frozen: bool):
        return self._step_fn(frozen, lambda: make_train_step(
            self.cfg, frozen, self.data))

    def _eval_step(self):
        return self._step_fn("eval", lambda: make_eval_step(self.cfg,
                                                            self.data))

    def lr_schedule(self, batch_size: int, total_epochs: int):
        init_fit, min_fit = schedules.adaptive_seg_lr(
            self.cfg.init_lr, self.cfg.init_lr * self.cfg.min_lr_ratio,
            batch_size, backbone=self.cfg.backbone,
            optimizer_type=self.cfg.optimizer_type)
        return schedules.get_lr_scheduler(self.cfg.lr_decay_type, init_fit,
                                          min_fit, total_epochs)

    def _lr_arg(self, lr: float):
        """The LR as the step takes it: on the card a 0-dim device tensor
        (made by a fill, no host copy) that both optimizers read there,
        elsewhere a float."""
        if self.device.type == "cuda":
            return torch.full((), float(lr), device=self.device)
        return float(lr)

    def _param_rows(self, k: Optional[int], batch: int):
        """Fresh augmentation parameters for one step (``k=None``, (B, 10))
        or K steps ((K, B, 10)), drawn in step order from the host
        generator, pinned for one non-blocking upload on the card.  Under a
        mesh ``batch`` is the rank's: it draws the global batch's rows and
        keeps its own."""
        ranks = 1 if self.data is None else self.data.size
        rows = torch.stack([aug_ops.params_to_rows(_sample_step_aug_params(
            self.cfg, self.generator, batch * ranks))
            for _ in range(k or 1)])
        rows = P.rank_rows(rows, self.data, 1).contiguous()
        rows = rows if k else rows[0]
        return rows.pin_memory() if self.device.type == "cuda" else rows

    def train_step(self, images, labels, frozen: bool, lr: float):
        """One step on a batch already on the card, with freshly sampled
        augmentation parameters (one upload); returns the unsynced
        metrics."""
        with span("seg.call.train"):
            rows = self._param_rows(None, images.shape[0])
            params = aug_ops.rows_to_params(rows.to(self.device,
                                                    non_blocking=True))
            return self._train_step(frozen)(self.state, images, labels,
                                            params, self._lr_arg(lr))

    def _call_k(self, key, fn, inputs, lr=None):
        """Run ``fn(state, *inputs, [lr])``, a K-step call over ``inputs``.
        On the CPU it runs eagerly; on the card it replays the graph of
        ``key`` (captured now if new)."""
        extra = () if lr is None else (self._lr_arg(lr),)
        if not self.graphed:
            return fn(self.state, *inputs, *extra)
        g = self._graphs.get(key)
        if g is None or g.state is not self.state:
            state = self.state
            g = GraphedCall(lambda *xs: fn(state, *xs), state,
                            list(inputs) + list(extra), self.device)
            self._graphs[key] = g
        return g(*inputs, *extra)

    def train_steps(self, images, labels, frozen: bool, lr: float):
        """K steps on (K, B, ...) batches already on the card, in one call
        (:func:`make_train_step_scan`); returns unsynced (K,) metrics."""
        with span("seg.call.train"):
            k, b = images.shape[0], images.shape[1]
            fn = self._step_fn(("scan", frozen, k),
                               lambda: make_train_step_scan(self.cfg, frozen,
                                                            k, self.data))
            return self._call_k(("scan", frozen, k, b), fn,
                                (images, labels, self._param_rows(k, b)), lr)

    def _resident_train(self, data, frozen: bool, idx, lr: float, gather):
        """One K-step call on the resident set ``data``; ``idx`` a host
        int64 array, (K,) batch or (K, B) row indices.  Under a mesh the
        rank reads its rows of each global batch, by row index."""
        with span("seg.call.train"):
            k, b = len(idx), data.batch_size
            if self.data is not None:
                idx = np.asarray(idx, np.int64)
                if not gather:
                    idx = idx[:, None] * b + np.arange(b)
                idx, gather = P.rank_rows(idx, self.data, 1), True
                b = idx.shape[1]
            idx = torch.as_tensor(np.ascontiguousarray(idx, np.int64))
            if self.device.type == "cuda":
                idx = idx.pin_memory()
            scan = self._step_fn(("scanres", frozen, k, b, gather),
                                 lambda: make_train_step_scan_resident(
                                     self.cfg, frozen, k, b, gather=gather,
                                     data=self.data))

            def fn(st, i, r, lr_):
                return scan(st, data.images, data.labels, i, r, lr_)
            key = ("res", frozen, k, b, gather, data.images.data_ptr(),
                   tuple(data.images.shape))
            return self._call_k(key, fn, (idx, self._param_rows(k, b)), lr)

    def _resident_eval(self, data, pos: int, k: int):
        """The summed metrics of resident eval batches ``pos .. pos+k-1``."""
        b = data.batch_size
        off, cnt = 0, None
        if self.data is not None:
            rows = P.rank_rows(range(b), self.data)
            off, cnt = rows.start, len(rows)
        idx = torch.arange(pos, pos + k, device=self.device)
        scan = self._step_fn(("evalres", k, b, off, cnt), lambda:
                             make_eval_step_scan_resident(self.cfg, k, b,
                                                          off, cnt,
                                                          self.data))

        def fn(st, i):
            return scan(st, data.images, data.labels, data.weights, i)
        key = ("evalres", k, b, off, data.images.data_ptr(),
               tuple(data.images.shape))
        return self._call_k(key, fn, (idx,))

    def run_epoch(self, train_loader, val_loader, epoch: int, frozen: bool,
                  lr: float) -> EpochResult:
        """One training pass over ``train_loader`` and one validation pass
        over ``val_loader``.  ``steps_per_call`` K > 1 groups K batches into
        one K-step call (:meth:`train_steps`); a ragged tail of fewer than
        K batches runs as single steps.  Calls are dispatched ahead of
        reading their metrics: at most ``cfg.pipeline_depth`` calls' metrics
        stay unsynced (the reference's per-step ``.item()`` would stall the
        card).  Ragged validation batches are padded with weight-0 rows to
        the loader's batch size, so every eval batch has one shape and
        counts exactly.  Under a mesh the loaders yield global batches and
        each rank takes its rows.  Resident loaders (``fit`` with
        ``device_resident``) go to :meth:`run_epoch_resident`.  Spans:
        ``seg.epoch`` over the epoch, ``seg.epoch.train`` and
        ``seg.epoch.val`` over each pass up to its last drain, and
        ``seg.call.train`` per train call."""
        from cervical_tpu_torch.data.resident import ResidentSegData
        if isinstance(train_loader, ResidentSegData):
            if not isinstance(val_loader, ResidentSegData):
                raise ValueError("a resident train set needs a resident "
                                 "val set (fit's device_resident loaders)")
            return self.run_epoch_resident(train_loader, val_loader, epoch,
                                           frozen, lr)
        del epoch  # the loaders shuffle per epoch themselves
        t0 = time.time()
        depth = max(1, self.cfg.pipeline_depth)
        k = max(1, self.cfg.steps_per_call)
        with span("seg.epoch", self.device):
            train = _Drain(depth)
            with span("seg.epoch.train", self.device):
                for images, labels in device_prefetch(
                        train_loader, self.device, group=k, mesh=self.mesh):
                    if images.ndim == 5:
                        train.add(self.train_steps(images, labels, frozen,
                                                   lr))
                    else:
                        train.add(self.train_step(images, labels, frozen,
                                                  lr))
            train.drain(0)

            val = _Drain(depth)
            eval_fn = self._eval_step()
            divisor = getattr(val_loader, "batch_size", 1)
            with span("seg.epoch.val", self.device):
                for images, labels, w in device_prefetch(
                        val_loader, self.device, with_weights=True,
                        divisor=divisor, mesh=self.mesh):
                    val.add(eval_fn(self.state, images, labels, w))
            val.drain(0)
        return EpochResult(train.mean("loss"), val.mean("loss"),
                           train.mean("f_score"), val.mean("f_score"),
                           time.time() - t0)

    def run_epoch_resident(self, train_rs, val_rs, epoch: int, frozen: bool,
                           lr: float) -> EpochResult:
        """One epoch fed from device-resident sets: the per-epoch shuffle of
        ``cfg.resident_shuffle``, then K-step calls whose host inputs are an
        index vector, K steps' parameter rows and the LR; the val pass
        sums K eval batches per call.  A ragged tail runs as a shorter
        call.

        Shuffles: "gather" (default) draws a permutation of every train
        image from ``default_rng(seed * 1_000_003 + epoch)`` and each step
        gathers its rows; "images" permutes the set on the card from
        :attr:`shuffle_generator`; "chunks" permutes the batch order from
        ``default_rng(seed * 100_003 + epoch)``; "none" keeps the order.
        The host permutations are the JAX package's, row for row.  Under a
        mesh every rank holds the whole set and draws the same shuffles,
        then reads its rows of each global batch.  Spans as
        :meth:`run_epoch`'s."""
        t0 = time.time()
        with span("seg.epoch", self.device):
            cfg = self.cfg
            k = max(1, cfg.steps_per_call)
            c, b = train_rs.num_chunks, train_rs.batch_size
            mode = cfg.resident_shuffle
            order = np.arange(c)
            rows = None
            if mode == "gather":
                rows = np.random.default_rng(
                    cfg.seed * 1_000_003 + epoch).permutation(
                        c * b).reshape(c, b)
            elif mode == "images":
                train_rs.shuffle_(self.shuffle_generator)
            elif mode == "chunks":
                order = np.random.default_rng(
                    cfg.seed * 100_003 + epoch).permutation(c)
            elif mode != "none":
                raise ValueError(f"unknown resident_shuffle {mode!r}")

            depth = max(1, cfg.pipeline_depth)
            train = _Drain(depth)
            with span("seg.epoch.train", self.device):
                for pos in range(0, c, k):
                    idx = (rows if rows is not None else order)[pos:pos + k]
                    train.add(self._resident_train(train_rs, frozen, idx, lr,
                                                   rows is not None))
            train.drain(0)

            val = _Drain(depth)
            cv = val_rs.num_chunks
            with span("seg.epoch.val", self.device):
                for pos in range(0, cv, k):
                    kk = min(k, cv - pos)
                    val.add(self._resident_eval(val_rs, pos, kk), count=kk)
            val.drain(0)
        return EpochResult(train.mean("loss"), val.mean("loss"),
                           train.mean("f_score"), val.mean("f_score"),
                           time.time() - t0)

    def fit(self, train_ds, val_ds, total_epochs: Optional[int] = None,
            loader_factory=None, log=print) -> Dict:
        """The two-phase training loop (train.py:526-581) from
        ``cfg.init_epoch`` to ``total_epochs`` (default
        ``cfg.unfreeze_epoch``).  ``train_ds``/``val_ds`` are
        :class:`~cervical_tpu_torch.data.voc.VOCSegDataset`-like;
        ``loader_factory(ds, batch_size, shuffle)`` defaults to a
        ``BatchLoader`` that drops the ragged tail of a shuffled (train)
        set; with ``cfg.device_resident`` it uploads each dataset to the
        card once (``ResidentSegData``, train tail dropped, eval tail
        padded) and rechunks it at the freeze -> unfreeze switch.  Returns
        the history ``{"train_loss", "val_loss", "miou"}`` (+
        ``"predictor_miou"`` with ``cfg.predictor_eval``).

        SIGTERM and SIGINT (handlers installed only from the main thread,
        restored on return) and :meth:`request_stop` ask for a graceful
        stop: the epoch in flight finishes and is checkpointed as usual,
        then the loop returns.  Resume with ``cfg.init_epoch`` and
        :meth:`CheckpointManager.restore`."""
        from cervical_tpu_torch.data.voc import BatchLoader
        from cervical_tpu_torch.train.callbacks import (LossHistory,
                                                        MiouHistory,
                                                        PredictorMiouCallback)
        from cervical_tpu_torch.train.checkpoints import CheckpointManager

        cfg = self.cfg
        total_epochs = total_epochs or cfg.unfreeze_epoch
        if loader_factory is None and cfg.device_resident:
            from cervical_tpu_torch.data.resident import ResidentSegData
            uploaded = {}

            def loader_factory(ds, bs, shuffle):
                cur = uploaded.get(id(ds))
                if cur is None:
                    cur = ResidentSegData.from_dataset(
                        ds, bs, self.device, train=shuffle, log=log)
                elif cur.batch_size != bs:
                    cur = cur.rechunk(bs)
                uploaded[id(ds)] = cur
                return cur
        elif loader_factory is None:
            def loader_factory(ds, bs, shuffle):
                return BatchLoader(ds, bs, shuffle=shuffle, seed=cfg.seed,
                                   drop_last=shuffle)

        loss_hist = LossHistory(cfg.save_dir)
        # the model-graph dump at callback init (utils/callbacks.py:29-34)
        loss_hist.add_model_graph(self._graph_model(),
                                  torch.zeros(1, 3, *cfg.data.input_shape))
        miou_hist = MiouHistory(cfg.save_dir, cfg.eval_period)
        pred_cb = (PredictorMiouCallback(cfg.save_dir, val_ds,
                                         cfg.eval_period, device=self.device)
                   if cfg.predictor_eval else None)
        ckpt = CheckpointManager(cfg.save_dir, cfg.save_period)

        self._stop_requested = False
        prev_handlers = {}

        def _request_stop(signum, frame):
            self._stop_requested = True
            log(f"signal {signum}: finishing the current epoch, "
                "checkpointing, and stopping")

        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(sig, _request_stop)
        history = {"train_loss": [], "val_loss": [], "miou": []}
        try:
            self._fit_loop(total_epochs, loader_factory, train_ds, val_ds,
                           history, loss_hist, miou_hist, pred_cb, ckpt, log)
        finally:
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)
        return history

    def _graph_model(self) -> nn.Module:
        """An eval-mode CPU copy of the model, unfused (the kernels launch
        only on CUDA tensors), for the graph dump."""
        model = build_model(self.cfg)
        model.load_state_dict(self.state.model.state_dict())
        return model.eval()

    def _fit_loop(self, total_epochs, loader_factory, train_ds, val_ds,
                  history, loss_hist, miou_hist, pred_cb, ckpt, log):
        cfg = self.cfg
        frozen = cfg.freeze_train
        batch_size = cfg.freeze_batch_size if frozen else \
            cfg.unfreeze_batch_size
        schedule = self.lr_schedule(batch_size, total_epochs)
        train_loader = loader_factory(train_ds, batch_size, True)
        val_loader = loader_factory(val_ds, cfg.eval_batch_size, False)
        for epoch in range(cfg.init_epoch, total_epochs):
            if frozen and epoch >= cfg.freeze_epoch:
                # unfreeze: batch size and schedule rebuilt (train.py:531-570)
                frozen = False
                batch_size = cfg.unfreeze_batch_size
                schedule = self.lr_schedule(batch_size, total_epochs)
                train_loader = loader_factory(train_ds, batch_size, True)
            lr = schedule(epoch)
            res = self.run_epoch(train_loader, val_loader, epoch, frozen, lr)
            history["train_loss"].append(res.train_loss)
            history["val_loss"].append(res.val_loss)
            loss_hist.append_loss(epoch, res.train_loss, res.val_loss)
            if miou_hist.should_eval(epoch):
                miou = self.evaluate_miou(val_loader)["miou"]
                miou_hist.append(epoch, miou)
                history["miou"].append((epoch, miou))
            if pred_cb is not None and pred_cb.should_eval(epoch):
                history.setdefault("predictor_miou", []).append(
                    (epoch, pred_cb.run(cfg, self.state, epoch, log=log)))
            ckpt.on_epoch_end(epoch, self.state, res.train_loss, res.val_loss,
                              total_epochs)
            log(f"Epoch {epoch + 1}/{total_epochs} lr={lr:.2e} "
                f"loss={res.train_loss:.4f} val_loss={res.val_loss:.4f} "
                f"f={res.train_f_score:.3f}/{res.val_f_score:.3f} "
                f"({res.seconds:.1f}s)")
            self._stop_requested = P.any_rank(self._stop_requested,
                                              self.device)
            if self._stop_requested:
                log(f"stopped after epoch {epoch + 1} (preemption); "
                    f"resume with init_epoch={epoch + 1} from "
                    "last_epoch_weights")
                break

    def request_stop(self):
        """Ask ``fit`` to stop gracefully at the next epoch boundary
        (checkpointed as usual) — the programmatic preemption hook."""
        self._stop_requested = True


    def evaluate_miou(self, loader, num_classes: Optional[int] = None) -> Dict:
        """Accumulate the confusion matrix over ``loader`` on the card and
        summarize (EvalCallback, utils/callbacks.py:153-200).  Ragged
        batches are padded with weight-0 rows, so each real pixel counts
        once.  A resident set is read by K-batch calls that sum the matrix
        on the card.  Under a mesh each rank counts its rows and the
        matrices are summed over the ranks."""
        from cervical_tpu_torch.data.resident import ResidentSegData
        nc = num_classes or self.cfg.data.num_classes
        if nc != self.cfg.data.num_classes:
            raise ValueError(f"the eval step counts "
                             f"{self.cfg.data.num_classes} classes, not {nc}")
        if isinstance(loader, ResidentSegData):
            k = max(1, self.cfg.steps_per_call)
            cv = loader.num_chunks
            hist = sum(self._resident_eval(loader, pos, min(k, cv - pos))
                       ["hist"] for pos in range(0, cv, k))
            return summarize_hist(hist.cpu().numpy().astype(np.int64))
        eval_fn = self._eval_step()
        hist = torch.zeros((nc, nc), dtype=torch.int64, device=self.device)
        divisor = getattr(loader, "batch_size", 1)
        for images, labels, w in device_prefetch(
                loader, self.device, with_weights=True, divisor=divisor,
                mesh=self.mesh):
            hist += eval_fn(self.state, images, labels, w)["hist"]
        return summarize_hist(hist.cpu().numpy().astype(np.int64))
