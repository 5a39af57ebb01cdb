"""Segmentation trainer: model construction, optimizers, the train and eval
steps, the host-fed epoch and the two-phase ``fit`` loop with checkpoints,
callbacks and a graceful stop — port of ``cervical_tpu/train/seg_trainer.py``
(reference: ``Segmentation/deeplabv3+/train.py`` + ``utils/utils_fit.py``).

One train step: uint8 batch -> augmentation on the card (the K1-K3 kernels
of ``ops/warp.py``) -> DeepLab forward in train mode (bf16 convs, fp32
BatchNorm on batch statistics) -> the class-major loss bundle (focal or CE
+ dice, f-score, the x4 logits upsample inside) -> backward -> Adam (or
Nesterov SGD) with coupled L2 on separate backbone and head optimizers.
In the freeze phase the backbone runs without autograd and its optimizer
does not step: its params and its Adam state stay bit-identical, while its
BatchNorm running stats still update (train.py:447-452).

Not ported yet: the device-resident and scanned epochs (``fit`` feeds a
:class:`~cervical_tpu_torch.data.voc.BatchLoader`) and the einsum
augmentation backend.
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
import torch.nn as nn

from cervical_tpu_torch import losses
from cervical_tpu_torch.config import SegTrainConfig
from cervical_tpu_torch.data.pipeline import device_prefetch
from cervical_tpu_torch.metrics import confusion_matrix, summarize_hist
from cervical_tpu_torch.models.deeplab import DeepLab
from cervical_tpu_torch.ops import augment as aug_ops
from cervical_tpu_torch.train import schedules


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
    param group, ``{"backbone": ..., "head": ...}``."""

    model: DeepLab
    opt_state: Dict[str, torch.optim.Optimizer]
    step: int = 0


def _split_params(model: nn.Module):
    """(backbone params, every other param), in ``named_parameters`` order."""
    backbone, head = [], []
    for name, p in model.named_parameters():
        (backbone if name.startswith("backbone.") else head).append(p)
    return backbone, head


def make_optimizer(cfg: SegTrainConfig, params) -> torch.optim.Optimizer:
    """Adam or Nesterov SGD; the LR is set per step.  torch's
    ``weight_decay`` is coupled L2 (added to the gradient before the
    moments), which is what the JAX package's ``add_decayed_weights``
    chain computes."""
    if cfg.optimizer_type == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(cfg.momentum, 0.999),
                                eps=1e-8, weight_decay=cfg.weight_decay)
    return torch.optim.SGD(params, lr=0.0, momentum=cfg.momentum,
                           nesterov=True, weight_decay=cfg.weight_decay)


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
    return TrainState(model, {"backbone": make_optimizer(cfg, backbone),
                              "head": make_optimizer(cfg, head)})


@functools.lru_cache(maxsize=8)
def _class_weights(weights: tuple, device: torch.device) -> torch.Tensor:
    """The class weights on ``device``, uploaded once (a list turned into a
    CUDA tensor per step is a blocking copy)."""
    return torch.tensor(weights, dtype=torch.float32).to(device)


def seg_loss_bundle_fn(cfg: SegTrainConfig, logits, labels,
                       sample_weights=None, resize_to=None,
                       return_preds: bool = False):
    """:func:`losses.seg_loss_bundle` with the config's classes, class
    weights and loss choice; ``logits`` NHWC."""
    return losses.seg_loss_bundle(
        logits, labels, _class_weights(tuple(cfg.cls_weights), logits.device),
        cfg.data.num_classes,
        focal=cfg.focal_loss, dice=cfg.dice_loss,
        sample_weights=sample_weights, resize_to=resize_to,
        return_preds=return_preds)


def make_train_aug_fn(cfg: SegTrainConfig):
    """The train-time augmentation ``(images_u8, labels_u8, params) ->
    (images (B, H, W, 3) bf16 in [0, 1], labels uint8)`` of
    ``cfg.data.aug_backend``: "pallas" is the K1-K3 kernel path
    (``ops.warp.augment_batch_kernels``, exact 3-shear, per-image rotation
    and blur)."""
    from cervical_tpu_torch.ops.warp import augment_batch_kernels
    hw = tuple(cfg.data.input_shape)
    backend = cfg.data.aug_backend
    if backend == "einsum":
        raise NotImplementedError(
            "aug_backend='einsum' is not ported yet (ROADMAP: the einsum "
            "backend's slice); set data.aug_backend='pallas' for the K1-K3 "
            "kernels")
    if backend != "pallas":
        raise ValueError(f"unknown aug_backend {backend!r} "
                         "(expected 'einsum' or 'pallas')")

    def aug(images, labels, params):
        return augment_batch_kernels(images, labels, params, hw)
    return aug


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


def make_train_step(cfg: SegTrainConfig, frozen: bool):
    """``step(state, images_u8 (B,H,W,3), labels_u8 (B,H,W), aug_params,
    lr) -> metrics``: one optimizer step in place on ``state``.  The
    metrics are unsynced 0-dim tensors ``loss``, ``main_loss``,
    ``f_score``."""
    aug_fn = make_train_aug_fn(cfg)
    nc = cfg.data.num_classes
    dt = _dtype(cfg)

    def step(state: TrainState, images, labels, aug_params, lr: float):
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
            resize_to=tuple(images.shape[1:3]))
        total.backward()
        # a frozen backbone gets no optimizer step at all: params and Adam
        # state (moments and count) untouched
        groups = ("head",) if frozen else ("head", "backbone")
        for g in groups:
            opt = state.opt_state[g]
            for pg in opt.param_groups:
                pg["lr"] = lr
            opt.step()
        state.step += 1
        return {"loss": total.detach(), "main_loss": main.detach(),
                "f_score": fs.detach()}

    return step


def make_eval_step(cfg: SegTrainConfig):
    """``step(state, images_u8, labels_u8, weights=None) -> {"loss",
    "f_score", "hist"}``: letterbox to the input shape, eval-mode forward,
    the loss bundle and the (nc, nc) confusion matrix of the argmax.
    Weight-0 rows become all-ignore: no loss, no confusion cell."""
    from cervical_tpu_torch.ops.warp_xla import augment_batch_einsum
    hw = tuple(cfg.data.input_shape)
    nc = cfg.data.num_classes
    dt = _dtype(cfg)

    @torch.no_grad()
    def step(state: TrainState, images, labels, weights=None):
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
            resize_to=hw, return_preds=True)
        return {"loss": total, "f_score": fs,
                "hist": confusion_matrix(labels, preds, nc)}

    return step


@dataclasses.dataclass
class EpochResult:
    train_loss: float
    val_loss: float
    train_f_score: float
    val_f_score: float
    seconds: float


class SegTrainer:
    """The epoch driver (utils_fit.py:31-198) on one card.

    ``device`` defaults to ``cuda``.  Seeds: ``cfg.seed`` (or ``seed``)
    draws the initial weights; the per-step augmentation parameters come
    from a host generator seeded ``seed + 1``; the dropouts from their own
    generators (``build_model``).
    """

    def __init__(self, cfg: SegTrainConfig, seed: Optional[int] = None,
                 device: str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        seed = cfg.seed if seed is None else seed
        self.generator = torch.Generator().manual_seed(seed + 1)
        self.state = create_state(cfg, seed, self.device)
        self._steps: dict = {}

    def _train_step(self, frozen: bool):
        if frozen not in self._steps:
            self._steps[frozen] = make_train_step(self.cfg, frozen)
        return self._steps[frozen]

    def _eval_step(self):
        if "eval" not in self._steps:
            self._steps["eval"] = make_eval_step(self.cfg)
        return self._steps["eval"]

    def lr_schedule(self, batch_size: int, total_epochs: int):
        init_fit, min_fit = schedules.adaptive_seg_lr(
            self.cfg.init_lr, self.cfg.init_lr * self.cfg.min_lr_ratio,
            batch_size, backbone=self.cfg.backbone,
            optimizer_type=self.cfg.optimizer_type)
        return schedules.get_lr_scheduler(self.cfg.lr_decay_type, init_fit,
                                          min_fit, total_epochs)

    def train_step(self, images, labels, frozen: bool, lr: float):
        """One step on a batch already on the card, with freshly sampled
        augmentation parameters; returns the unsynced metrics."""
        params = _sample_step_aug_params(self.cfg, self.generator,
                                         images.shape[0])
        return self._train_step(frozen)(self.state, images, labels, params,
                                        lr)

    def run_epoch(self, train_loader, val_loader, epoch: int, frozen: bool,
                  lr: float) -> EpochResult:
        """One training pass over ``train_loader`` and one validation pass
        over ``val_loader``.  Steps are dispatched ahead of reading their
        metrics: at most ``cfg.pipeline_depth`` steps' metrics stay unsynced
        (the reference's per-step ``.item()`` would stall the card).  Ragged
        validation batches are padded with weight-0 rows to the loader's
        batch size, so every eval batch has one shape and counts exactly."""
        del epoch  # the loaders shuffle per epoch themselves
        t0 = time.time()
        depth = max(1, self.cfg.pipeline_depth)
        tl, tf, n = 0.0, 0.0, 0
        pending = []
        for images, labels in device_prefetch(train_loader, self.device):
            pending.append(self.train_step(images, labels, frozen, lr))
            while len(pending) >= depth:
                m = pending.pop(0)
                tl += m["loss"].item()
                tf += m["f_score"].item()
                n += 1
        for m in pending:
            tl += m["loss"].item()
            tf += m["f_score"].item()
            n += 1

        vl, vf, vn = 0.0, 0.0, 0
        eval_fn = self._eval_step()
        epending = []
        divisor = getattr(val_loader, "batch_size", 1)
        for images, labels, w in device_prefetch(
                val_loader, self.device, with_weights=True, divisor=divisor):
            epending.append(eval_fn(self.state, images, labels, w))
            while len(epending) >= depth:
                m = epending.pop(0)
                vl += m["loss"].item()
                vf += m["f_score"].item()
                vn += 1
        for m in epending:
            vl += m["loss"].item()
            vf += m["f_score"].item()
            vn += 1
        return EpochResult(tl / max(n, 1), vl / max(vn, 1), tf / max(n, 1),
                           vf / max(vn, 1), time.time() - t0)

    def fit(self, train_ds, val_ds, total_epochs: Optional[int] = None,
            loader_factory=None, log=print) -> Dict:
        """The two-phase training loop (train.py:526-581) from
        ``cfg.init_epoch`` to ``total_epochs`` (default
        ``cfg.unfreeze_epoch``).  ``train_ds``/``val_ds`` are
        :class:`~cervical_tpu_torch.data.voc.VOCSegDataset`-like;
        ``loader_factory(ds, batch_size, shuffle)`` defaults to a
        ``BatchLoader`` that drops the ragged tail of a shuffled (train)
        set.  Returns the history ``{"train_loss", "val_loss", "miou"}``
        (+ ``"predictor_miou"`` with ``cfg.predictor_eval``).

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
        if loader_factory is None:
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
        once."""
        nc = num_classes or self.cfg.data.num_classes
        if nc != self.cfg.data.num_classes:
            raise ValueError(f"the eval step counts "
                             f"{self.cfg.data.num_classes} classes, not {nc}")
        eval_fn = self._eval_step()
        hist = torch.zeros((nc, nc), dtype=torch.int64, device=self.device)
        divisor = getattr(loader, "batch_size", 1)
        for images, labels, w in device_prefetch(
                loader, self.device, with_weights=True, divisor=divisor):
            hist += eval_fn(self.state, images, labels, w)["hist"]
        return summarize_hist(hist.cpu().numpy().astype(np.int64))
