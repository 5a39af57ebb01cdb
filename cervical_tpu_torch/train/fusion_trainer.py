"""Multimodal fusion trainer: the train step, the epoch and the stratified
cross-validation — port of ``cervical_tpu/train/fusion_trainer.py`` (reference:
``MultiModal Prediction/Four_Modal/my_train(full).py`` and its Two/Three
variants).

* The reference's per-patient loop accumulating logits over ``batch_size``
  patients is CE over a batched forward: one step per micro-batch.
* Adam with ``weight_decay`` is torch's coupled L2, what the JAX package
  builds as ``add_decayed_weights -> scale_by_adam -> scale(-lr)``.  On the
  card it is ``capturable`` and reads its LR as a 0-dim device tensor, in
  eager steps too, so a replayed step equals an eager one bit for bit.
* The epoch-0 quirk (``epoch0_no_step``, my_train(full).py:350-353): the
  step computes everything and calls no ``optimizer.step()``: params, both
  moments and the step count stay untouched.
* The MAE-MSE term is divided by the LITERAL 5 (my_train(full).py:339), so
  ``mse_loss_of_mae_factor`` scales it.
* ``train_epoch`` (``use_scan=True``, the default) is the counterpart of the
  JAX epoch scan: the epoch's micro-batches, a ragged tail padded with
  weight-0 rows, run as replays of one CUDA graph of the train step
  (``train/graphs.py``), captured per (batch, do_step, train set); each
  replay gathers its rows from the cohort on the card by an index buffer.
  On the CPU the same steps run eagerly.  ``use_scan=False``: the same
  loop of eager steps, the tail unpadded.
* Each fold's streams (weights, dropouts, shuffles, MAE masks) come from
  seeds keyed by (start_seed, seed, fold), so a resumed CV repeats an
  uninterrupted one exactly.  They are torch's streams, not JAX's
  (ROADMAP §3).  A dropout mask is a hash of the fold's dropout seed, its
  count of train steps, the layer and the element (``models/layers.py``).
* ``cross_validate(vmap_folds=True)`` trains up to ``vmap_group`` (seed,
  fold) pairs at once, fold-stacked under ``torch.func.vmap``
  (``train/fold_stack.py``), each pair on its own streams: per pair the
  same results as the sequential engine.
* ``dtype="bfloat16"`` computes in bf16 by flax's rule (params, Adam and
  the loss stay f32).
* ``mesh`` (``parallel.make_mesh``): data parallelism over ``data`` — each
  rank takes its rows of every global micro-batch, draws the global
  batch's MAE masks and dropout masks and keeps its rows, the loss sums are
  the global batch's and the gradient all-reduce divides by the rank count
  — and the tensor-parallel layout of ``parallel/tp.py`` over ``model``.
  Evaluation runs replicated on every rank with the full weights.
"""

from __future__ import annotations

import json
import os
import signal
import threading
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from cervical_tpu_torch import losses, metrics
from cervical_tpu_torch.config import FusionTrainConfig
from cervical_tpu_torch.data import splits as split_lib
from cervical_tpu_torch.data.fusion_data import subset
from cervical_tpu_torch.data.masks import (generate_modal_masks,
                                           imputation_masks)
from cervical_tpu_torch.models.fusion import IMAGE_MODALITIES, FusionMAE
from cervical_tpu_torch.parallel import mesh as P
from cervical_tpu_torch.parallel import tp as TP
from cervical_tpu_torch.train import fold_stack as FS
from cervical_tpu_torch.train.graphs import GraphedCall
from cervical_tpu_torch.train.schedules import fusion_step_decay
from cervical_tpu_torch.train.seg_trainer import TrainState, graph_rule


def _to_jsonable(x):
    """Recursively convert numpy containers to plain JSON types."""
    if isinstance(x, dict):
        return {k: _to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    return x


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: FusionTrainConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {cfg.dtype!r}")
    return _DTYPES[cfg.dtype]


def build_model(cfg: FusionTrainConfig, dropout_seed: int = 0) -> FusionMAE:
    return FusionMAE(modalities=tuple(cfg.modalities),
                     in_features=cfg.in_features, hidden=cfg.hidden,
                     num_classes=cfg.num_classes, dropout=cfg.dropout,
                     mix=cfg.mix, dropout_seed=dropout_seed,
                     dtype=compute_dtype(cfg))


def head_weights(cfg: FusionTrainConfig) -> Dict[str, float]:
    w = {"all": cfg.head_weight_all, "cli": cfg.head_weight_cli}
    for m in IMAGE_MODALITIES:
        w[m] = cfg.head_weight_img
    return w


def stream_seeds(*key: int) -> np.ndarray:
    """Four independent seeds (weights, dropouts, shuffles, masks) from a
    key: ``(start_seed,)`` for a trainer, ``(start_seed, seed * 1000 +
    fold)`` for a CV fold (the JAX package's ``fold_in`` key)."""
    return np.random.SeedSequence(list(key)).generate_state(4)


def make_loss(cfg: FusionTrainConfig, data=None):
    """``loss(out, labels, mae_mask, weights) -> (total, ce_all, preds)``:
    the weighted multi-head CE + MAE-MSE of a train-mode forward's outputs,
    in f32.  ``weights`` (B,): weight-0 rows count as absent.  ``preds``
    (1 + T, B): the argmax of the heads ``["all", *modalities]``.
    ``data`` (a ``parallel.mesh.Axis``): the means span its ranks' rows."""
    hw = head_weights(cfg)
    mods = tuple(cfg.modalities)
    heads = ("all",) + mods

    def loss(out, labels, mae_mask, weights):
        mae_mse = None
        if cfg.add_mse_loss_of_mae and len(mods) > 1:
            # factor * per-sample masked mse (losses.masked_mae_mse of
            # each row), weighted mean over samples
            m = mae_mask[..., None].to(torch.float32)
            d = (out["mae_out"].to(torch.float32)
                 - out["mae_labels"].to(torch.float32))
            se = torch.sum(d ** 2 * m, dim=(-2, -1))
            per = se / torch.clamp(torch.sum(m, dim=(-2, -1))
                                   * out["mae_out"].shape[-1], min=1.0)
            w = weights.to(torch.float32)
            num, den = P.global_sums(data, torch.sum(per * w),
                                     torch.sum(w))
            mae_mse = (cfg.mse_loss_of_mae_factor * num
                       / torch.clamp(den, min=1.0))
        total, parts = losses.fusion_multihead_loss(
            out["logits"], labels, hw, mae_mse, mse_factor=5.0,
            num_micro_batches=1, sample_weights=weights, data=data)
        preds = torch.stack([out["logits"][k].argmax(dim=-1) for k in heads])
        return total, parts["all"], preds

    return loss


def make_train_step(cfg: FusionTrainConfig, data=None):
    """``step(state, feats, labels, mae_mask, weights, lr, do_step) ->
    {"loss", "ce_all", "preds"}``: one train step in place on ``state``
    (forward in train mode, :func:`make_loss`, backward, and with
    ``do_step`` Adam).  Metrics are unsynced tensors.  ``data``: the batch
    is this rank's rows of the global batch on that data axis; the loss
    and the gradient are the global batch's."""
    loss = make_loss(cfg, data)

    def step(state: TrainState, feats, labels, mae_mask, weights, lr,
             do_step: bool):
        model = state.model
        model.train()
        opt = state.opt_state["params"]
        opt.zero_grad(set_to_none=True)
        total, ce_all, preds = loss(model(feats, mae_mask=mae_mask), labels,
                                    mae_mask, weights)
        total.backward()
        if data is not None:  # the global gradient, one flat all_reduce
            P.allreduce_mean_([p.grad for pg in opt.param_groups
                               for p in pg["params"]], data.group, data.size)
        if do_step:
            for pg in opt.param_groups:
                pg["lr"] = lr
            opt.step()
            state.step += 1
        return {"loss": total.detach(), "ce_all": ce_all.detach(),
                "preds": preds}

    return step


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _group_ckpt_path(save_dir: Optional[str]) -> Optional[str]:
    """The vmapped engine's mid-group snapshot in ``save_dir`` (None
    without one)."""
    return os.path.join(save_dir, "vmap_group_ckpt.npz") if save_dir \
        else None


class FusionTrainer:
    """The fusion train step, epoch, evaluation and CV loop on one device
    (``device``, ``cuda`` by default), or one rank of a ``mesh``
    (``parallel.make_mesh``): data parallel over its ``data`` axis, the
    model tensor-parallel over its ``model`` axis (``parallel.tp``).  Under
    a mesh the train step is a CUDA graph under NCCL and eager under gloo
    (``seg_trainer.graph_rule``); every rank starts from rank 0's weights."""

    def __init__(self, cfg: FusionTrainConfig, device: str = "cuda",
                 mesh=None):
        from torch.distributed.device_mesh import DeviceMesh
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a DeviceMesh (parallel.make_mesh)"
                            f", not {type(mesh).__name__}")
        compute_dtype(cfg)
        self.cfg = cfg
        self.device = P.rank_device(device)
        self.mesh = mesh
        self.data = P.axis(mesh, "data") if mesh is not None else None
        self.graphed = graph_rule(self.device, mesh)
        self._stop_requested = False
        self._step = None
        self._graphs: dict = {}
        self._eval_model: Optional[FusionMAE] = None
        self.reseed(cfg.start_seed)

    def reseed(self, *key: int) -> None:
        """Reset the trainer's streams from ``key`` (:func:`stream_seeds`):
        the init generator, the dropouts' base seed, the shuffle generator
        (host) and the MAE-mask generator (on the device)."""
        s_init, s_drop, s_shuf, s_mask = (int(s) for s in stream_seeds(*key))
        self.init_generator = torch.Generator().manual_seed(s_init)
        self.dropout_seed = s_drop % (1 << 31)
        self.shuffle_generator = torch.Generator().manual_seed(s_shuf)
        self.mask_generator = torch.Generator(self.device).manual_seed(s_mask)

    # -- state --------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> TrainState:
        """A fresh model (the JAX package's initialisers, drawn from
        ``generator``, by default the trainer's init stream) and its Adam
        (``{"params": adam}``) on the device."""
        cfg = self.cfg
        model = build_model(cfg, self.dropout_seed).init_weights(
            generator or self.init_generator).to(self.device)
        if self.mesh is not None:
            P.broadcast_([t.detach() for t in (*model.parameters(),
                                               *model.buffers())])
            TP.place_params(model, self.mesh, log=print if P.is_primary()
                            else (lambda msg: None))
            P.set_data_axis(model, self.data)
        adam = torch.optim.Adam(model.parameters(), lr=cfg.lr,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=cfg.weight_decay,
                                capturable=self.device.type == "cuda")
        return TrainState(model, {"params": adam})

    def train_step_fn(self):
        if self._step is None:
            self._step = make_train_step(self.cfg, self.data)
        return self._step

    def weights(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """The model's full ``state_dict`` (tensor-parallel shards gathered:
        a collective under a mesh)."""
        return TP.full_state_dict(state.model)

    def _lr_arg(self, lr: float):
        """On the card a 0-dim device tensor that Adam reads there,
        elsewhere a float."""
        if self.device.type == "cuda":
            return torch.full((), float(lr), device=self.device)
        return float(lr)

    def _device_cohort(self, ds):
        """``ds`` with feats, labels and present as tensors on the device
        (tensors already there are kept as they are)."""
        out = dict(ds)
        out["feats"] = {m: torch.as_tensor(v, dtype=torch.float32,
                                           device=self.device)
                        for m, v in ds["feats"].items()}
        out["labels"] = torch.as_tensor(ds["labels"], dtype=torch.int64,
                                        device=self.device)
        out["present"] = torch.as_tensor(ds["present"], dtype=torch.bool,
                                         device=self.device)
        return out

    def _batch_step(self, state: TrainState, feats, labels, bs: int,
                    do_step: bool, graph: bool = True):
        """``call(idx (B,), mask (B, T), weights (B,), lr)``: one train
        step on the rows ``idx`` of the device cohort ``feats``/``labels``.
        With ``graph``, on the card a replay of the step's CUDA graph,
        captured at the first call per (batch, do_step, state, cohort);
        otherwise, and off the card, the eager step."""
        step = self.train_step_fn()

        def fn(idx, mask, w, lr):
            return step(state, {m: v.index_select(0, idx)
                                for m, v in feats.items()},
                        labels.index_select(0, idx), mask, w, lr, do_step)

        if not graph or not self.graphed:
            return fn
        data = tuple(v.data_ptr() for v in feats.values()) + (
            labels.data_ptr(), labels.shape[0])
        entry = self._graphs.get((bs, do_step))
        if entry is None or entry[0] is not state or entry[1] != data:
            t = len(self.cfg.modalities)
            example = (torch.zeros(bs, dtype=torch.int64, device=self.device),
                       torch.zeros((bs, t), dtype=torch.bool,
                                   device=self.device),
                       torch.ones(bs, device=self.device),
                       self._lr_arg(self.cfg.lr))
            entry = (state, data, GraphedCall(fn, state, example,
                                              self.device))
            self._graphs[(bs, do_step)] = entry
        return entry[2]

    # -- epoch --------------------------------------------------------------
    def train_epoch(self, state: TrainState, ds, epoch: int, lr: float,
                    batch_size: Optional[int] = None, use_scan: bool = True):
        """One epoch over the cohort ``ds`` in shuffled micro-batches
        (train_a_epoch, my_train(full).py:188-410), ``state`` trained in
        place; returns the report: mean CE of the fused head, per-head
        accuracies and the fused head's classification block.

        ``use_scan``: the ragged tail is padded with weight-0 rows (whose
        weighted CE equals the reference's smaller final micro-batch), and
        every micro-batch replays the step's CUDA graph on the card.
        Without it the steps are eager and the tail is unpadded.  A cohort
        already on the device (``cross_validate`` puts it there) is read in
        place; numpy is uploaded.  Under a mesh every rank draws the same
        shuffle and masks, steps on its rows of each micro-batch (the tail
        padded always) and the predictions are gathered."""
        cfg = self.cfg
        bs = batch_size or cfg.batch_size
        dev = self._device_cohort(ds)
        labels_np = _host(ds["labels"])
        n = len(labels_np)
        t = len(cfg.modalities)
        heads = ["all", *cfg.modalities]
        order = torch.randperm(n, generator=self.shuffle_generator).numpy()
        do_step = not (cfg.epoch0_no_step and epoch == 0)
        lr_arg = self._lr_arg(lr)

        rows = (n + bs - 1) // bs * bs if use_scan or self.mesh else n
        idx = torch.from_numpy(np.concatenate(
            [order, np.zeros(rows - n, order.dtype)])).to(self.device)
        w = torch.from_numpy(np.concatenate(
            [np.ones(n, np.float32), np.zeros(rows - n, np.float32)])
        ).to(self.device)
        masks = (generate_modal_masks(self.mask_generator, rows, t) if t > 1
                 else torch.zeros((rows, 1), dtype=torch.bool,
                                  device=self.device))
        mine = P.rank_rows(range(bs), self.data)  # this rank's rows of each
        call = self._batch_step(state, dev["feats"], dev["labels"],
                                len(mine), do_step, graph=use_scan)
        outs = [call(idx[s + mine.start:s + mine.stop],
                     masks[s + mine.start:s + mine.stop],
                     w[s + mine.start:s + mine.stop], lr_arg)
                for s in range(0, rows, bs)]
        total_ce = float(torch.stack([o["ce_all"] for o in outs]).sum())
        nb = len(outs)
        preds = [o["preds"] for o in outs]                     # (H, b) each
        if self.data is None:
            preds = torch.cat(preds, dim=1)
        else:  # each micro-batch's ranks' rows, in order
            preds = P.gather_rows(torch.stack(preds, dim=1), self.data.group,
                                  self.data.rank, self.data.size,
                                  dim=2).flatten(1)
        preds = preds[:, :n].cpu().numpy()

        true = labels_np[order]
        report = {"loss": total_ce / max(nb, 1)}
        for i, k in enumerate(heads):
            report[f"acc_{k}"] = metrics.accuracy(true, preds[i])
        # the epoch metric block the reference prints (my_train(full).py:
        # 386-408)
        cls = metrics.classification_report(true, preds[0], cfg.num_classes)
        for k in ("confusion", "precision", "recall", "f1", "fp", "fn",
                  "tp", "tn", "sensitivity", "specificity"):
            report[k] = cls[k]
        return report

    # -- evaluation -----------------------------------------------------------
    def _eval(self, params: Mapping[str, torch.Tensor]) -> FusionMAE:
        if self._eval_model is None:
            self._eval_model = build_model(self.cfg).to(self.device).eval()
        self._eval_model.load_state_dict(params)
        return self._eval_model

    @torch.no_grad()
    def predict(self, params: Mapping[str, torch.Tensor], ds,
                batch_size: int = 512, use_present: bool = True,
                use_type=None):
        """Full-cohort evaluation with the weights ``params`` (a
        ``state_dict``; ``prediction``, my_train(full).py:47-171): per-head
        accuracies, the fused head's CE and its classification block.
        Batches are padded to ``batch_size`` (the last row repeated) and the
        padding sliced off.  ``use_type``: a modality subset to evaluate
        with; the others are zeroed and imputed by the MAE
        (my_mae_model.py:608-622)."""
        cfg = self.cfg
        model = self._eval(params)
        dev = self._device_cohort(ds)
        t = len(cfg.modalities)
        true = _host(ds["labels"])
        n = len(true)
        heads = ["all", *cfg.modalities]
        subset_mask = None
        if use_type is not None:
            subset_mask = torch.tensor([m in use_type for m in cfg.modalities],
                                       device=self.device)
        fused, preds = [], []
        for start in range(0, n, batch_size):
            real = min(start + batch_size, n) - start
            idx = torch.as_tensor(np.minimum(
                np.arange(start, start + batch_size), n - 1),
                device=self.device)
            feats = {m: v.index_select(0, idx)
                     for m, v in dev["feats"].items()}
            present = (dev["present"].index_select(0, idx) if use_present
                       else torch.ones((batch_size, t), dtype=torch.bool,
                                       device=self.device))
            if subset_mask is not None:
                present = present & subset_mask[None, :]
                feats = {m: torch.where(subset_mask[i], feats[m],
                                        torch.zeros_like(feats[m]))
                         for i, m in enumerate(cfg.modalities)}
            out = model(feats, present=present,
                        mae_mask=imputation_masks(present))
            fused.append(out["logits"]["all"][:real].float())
            preds.append(torch.stack([out["logits"][k].argmax(dim=-1)
                                      for k in heads])[:, :real])
        fused = torch.cat(fused).cpu().numpy()
        preds = torch.cat(preds, dim=1).cpu().numpy()
        # host-side CE of the fused head, as the JAX package computes it
        lse = fused - fused.max(axis=-1, keepdims=True)
        lse = lse - np.log(np.exp(lse).sum(axis=-1, keepdims=True))
        out = {"loss": float(-lse[np.arange(n), true].mean())}
        for i, k in enumerate(heads):
            out[f"acc_{k}"] = metrics.accuracy(true, preds[i])
        out.update(metrics.classification_report(true, preds[0],
                                                 cfg.num_classes))
        return out

    # -- cross-validation ------------------------------------------------------
    def cross_validate(self, ds, epochs: Optional[int] = None, log=print,
                       save_dir: Optional[str] = None, resume: bool = True,
                       vmap_folds: bool = False, vmap_group: int = 25):
        """Seed-repeat x stratified-K-fold CV with an inner train/val split
        and best-by-val-accuracy selection (main, my_train(full).py:
        417-623).  Returns ``{"folds", "mean_test_acc", "stopped_early"}``.

        ``save_dir``: per-fold curves and metric logs (``FusionHistory``),
        the best weights as ``best_seed{S}_fold{F}.npz`` in the JAX
        package's flat layout, ``cv_progress.json`` after every fold (with
        ``resume``, a rerun skips the folds it lists; the fold-keyed
        streams make the rest equal to an uninterrupted run),
        ``cv_results.json`` and the fold-summed classification report.

        SIGTERM/SIGINT (or :meth:`request_stop`) stop the epoch loop,
        finalise the current fold from its best-by-val weights and return
        the completed folds with ``stopped_early`` set.

        ``vmap_folds``: train the (seed, fold) pairs, across seeds, in
        groups of at most ``vmap_group`` at once, fold-stacked
        (:meth:`_cross_validate_vmapped`): per pair the sequential engine's
        streams and results, the same files and fold-level resume; a stop
        between epoch chunks checkpoints the group in flight."""
        epochs = epochs or self.cfg.epochs
        labels = np.asarray(ds["labels"])
        self._stop_requested = False
        prev_handlers = {}

        def _request_stop(signum, frame):  # pragma: no cover - signal path
            self._stop_requested = True
            log(f"signal {signum}: finalizing the current fold and stopping")

        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(sig, _request_stop)
        if vmap_folds and self.mesh is not None:
            raise ValueError("vmap_folds is incompatible with a TP mesh — "
                             "fold-stacked params cannot also be "
                             "tensor-sharded")
        try:
            if vmap_folds:
                return self._cross_validate_vmapped(
                    ds, epochs, labels, log, save_dir, resume,
                    group=vmap_group)
            return self._cross_validate(ds, epochs, labels, log, save_dir,
                                        resume)
        finally:
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)

    def request_stop(self):
        """Ask ``cross_validate`` to stop gracefully (finalise the current
        fold from its best-by-val weights, return the completed folds)."""
        self._stop_requested = True

    def _load_progress(self, save_dir, resume, log) -> dict:
        """The folds ``cv_progress.json`` lists, by (seed, fold)."""
        path = os.path.join(save_dir, "cv_progress.json") if save_dir else None
        if not (resume and path and os.path.exists(path)):
            return {}
        with open(path) as f:
            done = {(r["seed"], r["fold"]): r for r in json.load(f)["folds"]}
        if done:
            log(f"resuming: {len(done)} completed folds loaded from {path}")
        return done

    @staticmethod
    def _write_progress(save_dir, folds) -> None:
        """Durable fold-level progress (atomic rename): the resume source
        after a stop or a crash.  The primary rank writes, all wait."""
        if save_dir and P.is_primary():
            path = os.path.join(save_dir, "cv_progress.json")
            with open(path + ".tmp", "w") as f:
                json.dump(_to_jsonable({"folds": folds}), f)
            os.replace(path + ".tmp", path)
        P.barrier("cv_progress")

    def _finish_fold(self, ds, seed, fold, test_idx, best_params, history,
                     save_dir):
        """The test evaluation with a fold's best weights; its curves and
        npz under ``save_dir``."""
        final = self.predict(best_params, subset(ds, test_idx))
        if history is not None:
            history.plot()
        if save_dir and P.is_primary():
            from cervical_tpu_torch.inference.fusion_predictor import (
                save_params_npz)
            save_params_npz(os.path.join(
                save_dir, f"best_seed{seed}_fold{fold}.npz"), best_params)
        return final

    def _results(self, results, save_dir):
        mean_acc = float(np.mean([r["test"]["acc_all"] for r in results]))
        if save_dir and P.is_primary():
            with open(os.path.join(save_dir, "cv_results.json"), "w") as f:
                json.dump(_to_jsonable(
                    {"folds": results,
                     "mean_test_acc": mean_acc,
                     "stopped_early": self._stop_requested,
                     "modalities": list(self.cfg.modalities)}), f, indent=1)
            if results:
                total_cm = np.sum([np.asarray(r["test"]["confusion"])
                                   for r in results], axis=0)
                metrics.write_classification_report(
                    metrics.report_from_confusion(total_cm),
                    os.path.join(save_dir, "classification_out"))
        return {"folds": results, "mean_test_acc": mean_acc,
                "stopped_early": self._stop_requested}

    def _history(self, save_dir, seed, fold):
        if not save_dir:
            return None
        from cervical_tpu_torch.train.callbacks import FusionHistory
        return FusionHistory(save_dir, seed, fold)

    def _cross_validate(self, ds, epochs, labels, log, save_dir, resume):
        cfg = self.cfg
        # the cohort goes to the card once; folds and epochs gather there
        ds = self._device_cohort(ds)
        done = self._load_progress(save_dir, resume, log)
        results = []
        fold = -1
        for seed in range(cfg.start_seed, cfg.start_seed + cfg.repeat_num):
            fold_results = []
            for fold, (train_idx, test_idx) in enumerate(
                    split_lib.stratified_kfold(labels, cfg.kfold, seed=seed)):
                if (seed, fold) in done:
                    fold_results.append(done[(seed, fold)])
                    continue
                tr_idx, val_idx = split_lib.train_test_split(
                    train_idx, cfg.inner_test_size, seed=seed,
                    stratify=labels[train_idx])
                self.reseed(cfg.start_seed, seed * 1000 + fold)
                state = self.init_state()
                schedule = fusion_step_decay(cfg.lr, cfg.lr_gamma, cfg.lr_step)
                history = self._history(save_dir, seed, fold)

                best = {"val_acc": -1.0, "params": None, "epoch": -1}
                train_ds = subset(ds, tr_idx)
                val_ds = subset(ds, val_idx)
                test_ds = subset(ds, test_idx)
                epoch_test = [] if cfg.per_epoch_test else None
                for epoch in range(epochs):
                    self._stop_requested = P.any_rank(
                        self._stop_requested, self.device)
                    if self._stop_requested:
                        break
                    rep = self.train_epoch(state, train_ds, epoch,
                                           schedule(epoch))
                    weights = self.weights(state)
                    # the reference evaluates test and val every epoch
                    # (my_train(full).py:538-539); selection is val-based
                    if cfg.per_epoch_test:
                        te = self.predict(weights, test_ds)
                        epoch_test.append({"epoch": epoch,
                                           "loss": te["loss"],
                                           "acc_all": te["acc_all"]})
                    val = self.predict(weights, val_ds)
                    if history is not None:
                        history.append(epoch, rep["loss"], val["loss"],
                                       rep["acc_all"], val["acc_all"])
                    if val["acc_all"] > best["val_acc"]:
                        best = {"val_acc": val["acc_all"],
                                "params": {k: v.detach().clone()
                                           for k, v in weights.items()},
                                "epoch": epoch}
                    if (epoch + 1) % 20 == 0 or epoch == epochs - 1:
                        msg = (f"seed {seed} fold {fold} epoch {epoch + 1}: "
                               f"train acc {rep['acc_all']:.3f} "
                               f"val acc {val['acc_all']:.3f}")
                        if cfg.per_epoch_test:
                            msg += f" test acc {epoch_test[-1]['acc_all']:.3f}"
                        log(msg)
                final = self._finish_fold(
                    ds, seed, fold, test_idx,
                    best["params"] or self.weights(state), history,
                    save_dir)
                fold_results.append({"seed": seed, "fold": fold,
                                     "best_epoch": best["epoch"],
                                     "val_acc": best["val_acc"],
                                     "test": final,
                                     "epoch_test": epoch_test})
                log(f"seed {seed} fold {fold}: test acc {final['acc_all']:.3f}")
                self._write_progress(save_dir, results + fold_results)
                if self._stop_requested:
                    break
            results.extend(fold_results)
            if self._stop_requested:
                log(f"stopped early after seed {seed} fold {fold} "
                    f"({len(results)} folds completed)")
                break
        self._graphs.clear()
        return self._results(results, save_dir)

    # -- the vmapped-folds engine ------------------------------------------------
    def _cross_validate_vmapped(self, ds, epochs, labels, log, save_dir,
                                resume=True, epoch_chunk=20, group=25):
        """(seed, fold) pairs trained at once (see :meth:`cross_validate`).

        Pairs already in ``cv_progress.json`` are skipped one by one; the
        rest, across seeds, are packed into groups of at most ``group``.  A
        group is a :class:`~cervical_tpu_torch.train.fold_stack.FoldStack`
        of its pairs, each initialised and streamed as the sequential
        engine would (``stream_seeds(start_seed, seed * 1000 + fold)``):
        per epoch and pair a shuffle and the MAE masks for ``nb * bs``
        rows, the pair's ``nb`` batches padded with all-weight-0 batches to
        the group's longest.  Per epoch: ``nb_max`` stacked train steps (on
        the card a CUDA graph per ``do_step``), one stacked evaluation of
        the val sets and one of the test sets (each padded with weight-0
        rows to the group's longest; a CUDA graph each), best-by-val
        tracking on the device.  ``group`` bounds device memory (~6
        param-sized f32 copies per pair: params, gradients, Adam's moments,
        the best snapshot, the update's temporaries).

        A stop is taken between epoch chunks of ``epoch_chunk`` epochs:
        with ``save_dir`` the group in flight is written to
        ``vmap_group_ckpt.npz`` and a rerun restores it when its pairs
        match, continuing bit for bit; without one the group in flight is
        dropped."""
        cfg = self.cfg
        ds = self._device_cohort(ds)
        ckpt_path = _group_ckpt_path(save_dir)
        done = self._load_progress(save_dir, resume, log)
        pairs = []
        for seed in range(cfg.start_seed, cfg.start_seed + cfg.repeat_num):
            for fold, (train_idx, test_idx) in enumerate(
                    split_lib.stratified_kfold(labels, cfg.kfold, seed=seed)):
                if (seed, fold) in done:
                    continue
                tr, va = split_lib.train_test_split(
                    train_idx, cfg.inner_test_size, seed=seed,
                    stratify=labels[train_idx])
                pairs.append((seed, fold, tr, va, np.asarray(test_idx)))
        results = list(done.values())
        for g0 in range(0, len(pairs), group):
            if self._stop_requested:
                break
            gpairs = pairs[g0:g0 + group]
            folds = self._train_group(ds, gpairs, epochs, g0 // group, log,
                                      save_dir, resume, epoch_chunk)
            if folds is None:  # stopped between chunks
                log(f"stopped early after {len(results)} folds"
                    + (" (mid-group snapshot saved)" if ckpt_path else ""))
                break
            for (seed, fold, _tr, _va, test_idx), r in zip(gpairs, folds):
                r["test"] = self._finish_fold(
                    ds, seed, fold, test_idx, r.pop("params"),
                    r.pop("history"), save_dir)
                log(f"seed {seed} fold {fold}: test acc "
                    f"{r['test']['acc_all']:.3f}")
            results.extend(folds)
            self._write_progress(save_dir, results)
            if ckpt_path and os.path.exists(ckpt_path):
                os.remove(ckpt_path)  # the group is finalised
            if self._stop_requested:
                log(f"stopped early after {len(results)} folds")
                break
        results.sort(key=lambda r: (r["seed"], r["fold"]))
        return self._results(results, save_dir)

    def _train_group(self, ds, gpairs, epochs, gi, log, save_dir, resume,
                     epoch_chunk):
        """Train one group of (seed, fold, train, val, test) pairs on the
        device cohort ``ds``, first restoring ``save_dir``'s group snapshot
        if ``resume`` and it holds this group.  Returns per pair ``{"seed",
        "fold", "best_epoch", "val_acc", "epoch_test", "params",
        "history"}``, or None if a stop came between epoch chunks (with
        ``save_dir``, after writing the snapshot)."""
        cfg = self.cfg
        ckpt_path = _group_ckpt_path(save_dir)
        dev, bs, t = self.device, cfg.batch_size, len(cfg.modalities)
        n_fs = [len(p[2]) for p in gpairs]
        nb_fs = [-(-n // bs) for n in n_fs]
        nb_max = max(nb_fs)
        sds, drop_seeds, gens = [], [], {"shuffle": [], "mask": []}
        for seed, fold, *_ in gpairs:
            self.reseed(cfg.start_seed, seed * 1000 + fold)
            sds.append(build_model(cfg).init_weights(self.init_generator)
                       .state_dict())
            drop_seeds.append(self.dropout_seed)
            gens["shuffle"].append(self.shuffle_generator)
            gens["mask"].append(self.mask_generator)
        stack = FS.FoldStack(build_model(cfg).to(dev), sds, drop_seeds)
        opt = FS.StackedAdam(stack.flat, lr=cfg.lr,
                             weight_decay=cfg.weight_decay)
        state = TrainState(stack, {"params": opt})
        step, evaluate = (FS.make_stacked_step(stack, opt, make_loss(cfg)),
                          FS.make_stacked_eval(stack))
        feats, lbl = ds["feats"], ds["labels"]
        present = ds["present"]

        def eval_set(sets):
            vmax = max(len(x) for x in sets)
            idx = torch.from_numpy(np.stack([np.concatenate(
                [x, np.full(vmax - len(x), x[0], x.dtype)]) for x in sets]
            )).to(dev)
            w = torch.from_numpy(np.stack([np.concatenate(
                [np.ones(len(x), np.float32),
                 np.zeros(vmax - len(x), np.float32)]) for x in sets])
            ).to(dev)
            pres = present.index_select(0, idx.reshape(-1)).view(
                len(sets), vmax, t)
            fn = lambda: evaluate(feats, lbl, idx, w, pres)  # noqa: E731
            return (GraphedCall(fn, state, (), dev) if dev.type == "cuda"
                    else fn)

        calls = {}

        def train_call(do_step):
            if do_step not in calls:
                fn = lambda i, m, w, lr: step(  # noqa: E731
                    feats, lbl, i, m, w, lr, do_step)
                f = len(gpairs)
                calls[do_step] = fn if dev.type != "cuda" else GraphedCall(
                    fn, state, (torch.zeros((f, bs), dtype=torch.int64,
                                            device=dev),
                                torch.zeros((f, bs, t), dtype=torch.bool,
                                            device=dev),
                                torch.ones((f, bs), device=dev),
                                self._lr_arg(cfg.lr)), dev)
            return calls[do_step]

        val_call = eval_set([p[3] for p in gpairs])
        test_call = eval_set([p[4] for p in gpairs]) if cfg.per_epoch_test \
            else None
        f = len(gpairs)
        best = {"flat": stack.flat.detach().clone(),
                "acc": torch.full((f,), -1.0, device=dev),
                "epoch": torch.full((f,), -1, dtype=torch.int64, device=dev)}
        start, hists = 0, []
        if resume and ckpt_path and os.path.exists(ckpt_path):
            got = FS.load_group_ckpt(ckpt_path, gpairs, stack, opt, best,
                                     gens)
            if got is None:
                log("vmap group checkpoint does not match the pending "
                    "group; ignoring it")
            else:
                start, restored = got
                hists = [tuple(torch.from_numpy(h[e]).to(dev)
                               for h in restored) for e in range(start)]
                log(f"resuming group mid-training at epoch {start}/{epochs}")
        schedule = fusion_step_decay(cfg.lr, cfg.lr_gamma, cfg.lr_step)
        for c0 in range(start, epochs, epoch_chunk):
            c1 = min(c0 + epoch_chunk, epochs)
            for epoch in range(c0, c1):
                idx, masks, w = self._group_epoch(gpairs, gens, nb_max)
                call = train_call(not (cfg.epoch0_no_step and epoch == 0))
                lr = self._lr_arg(schedule(epoch))
                outs = [call(idx[b], masks[b], w[b], lr)
                        for b in range(nb_max)]
                val = val_call()
                te = test_call() if test_call else {
                    k: torch.zeros_like(v) for k, v in val.items()}
                with torch.no_grad():
                    better = val["acc"] > best["acc"]
                    best["acc"] = torch.where(better, val["acc"], best["acc"])
                    best["epoch"] = torch.where(better, epoch, best["epoch"])
                    best["flat"] = torch.where(better[:, None], stack.flat,
                                               best["flat"])
                hists.append(tuple(torch.stack([o[k] for o in outs]).sum(0)
                                   for k in ("ce_all", "corr"))
                             + (val["ce"], val["acc"], te["ce"], te["acc"]))
            log(f"group {gi}: epochs {c1}/{epochs}")
            if self._stop_requested and c1 < epochs:
                if ckpt_path:
                    FS.save_group_ckpt(
                        ckpt_path, gpairs, c1, stack, opt, best,
                        [torch.stack([h[i] for h in hists]).cpu().numpy()
                         for i in range(6)], gens)
                    log(f"stop requested: group checkpointed at epoch "
                        f"{c1}/{epochs} ({ckpt_path})")
                return None
        tr_ce, tr_corr, vce, vacc, tce, tacc = (
            torch.stack([h[i] for h in hists]).cpu().numpy()
            for i in range(6))
        best_epoch = best["epoch"].cpu().numpy()
        best_acc = best["acc"].cpu().numpy()
        out = []
        for i, (seed, fold, *_) in enumerate(gpairs):
            history = self._history(save_dir, seed, fold)
            if history is not None:
                for e in range(epochs):
                    history.append(e, tr_ce[e, i] / nb_fs[i], vce[e, i],
                                   tr_corr[e, i] / n_fs[i], vacc[e, i])
            out.append({
                "seed": seed, "fold": fold,
                "best_epoch": int(best_epoch[i]),
                "val_acc": float(best_acc[i]),
                "epoch_test": ([{"epoch": e, "loss": float(tce[e, i]),
                                 "acc_all": float(tacc[e, i])}
                                for e in range(epochs)]
                               if cfg.per_epoch_test else None),
                "params": {k: v.clone() for k, v in
                           stack.pair_state_dict(i, best["flat"]).items()},
                "history": history})
        return out

    def _group_epoch(self, gpairs, gens, nb_max):
        """One epoch's streams of a group, drawn per pair as
        :meth:`train_epoch` draws them: ``idx`` (nb_max, F, B) cohort rows,
        ``masks`` (nb_max, F, B, T), ``w`` (nb_max, F, B); each pair's
        ragged tail padded with weight-0 rows (its train set's row 0), its
        batches past its own ``nb`` all weight 0."""
        cfg = self.cfg
        bs, t = cfg.batch_size, len(cfg.modalities)
        rows = nb_max * bs
        idx, w, masks = [], [], []
        for (_s, _f, tr, *_), shuf, mgen in zip(gpairs, gens["shuffle"],
                                                gens["mask"]):
            n = len(tr)
            nrows = -(-n // bs) * bs
            order = torch.randperm(n, generator=shuf).numpy()
            idx.append(np.concatenate([tr[order],
                                       np.full(rows - n, tr[0], tr.dtype)]))
            w.append(np.concatenate([np.ones(n, np.float32),
                                     np.zeros(rows - n, np.float32)]))
            m = (generate_modal_masks(mgen, nrows, t) if t > 1
                 else torch.zeros((nrows, 1), dtype=torch.bool,
                                  device=self.device))
            masks.append(torch.cat([m, m.new_zeros((rows - nrows, t))]))

        def batches(a):
            return a.view(len(gpairs), nb_max, bs, *a.shape[2:]).transpose(
                0, 1).contiguous()
        return (batches(torch.from_numpy(np.stack(idx)).to(self.device)),
                batches(torch.stack(masks)),
                batches(torch.from_numpy(np.stack(w)).to(self.device)))
