"""Training logs: loss history, periodic mIoU, the predictor-path mIoU, the
model-graph dump, the fusion CV's per-fold curves — port of
``cervical_tpu/train/callbacks.py``.

Reference: ``Segmentation/deeplabv3+/utils/callbacks.py`` — TensorBoard
scalars + ``epoch_loss.txt``/``epoch_val_loss.txt`` + smoothed loss PNG
(:29-79), and ``EvalCallback`` writing ``epoch_miou.txt`` + a mIoU curve
(:84-200).  tensorboardX and matplotlib are optional, as in the JAX
package.  Under a process group only the primary rank writes files (the
reference's ``local_rank == 0`` guards, train.py:353-359); every rank keeps
the in-memory history.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cervical_tpu_torch.parallel.mesh import is_primary


class LossHistory:
    """Append per-epoch losses to txt files, optional tensorboardX scalars,
    optional matplotlib curve (savgol-smoothed when scipy is present)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._primary = is_primary()
        if self._primary:
            os.makedirs(log_dir, exist_ok=True)
        self.losses = []
        self.val_losses = []
        self.writer = None
        if self._primary:
            try:
                from tensorboardX import SummaryWriter
                self.writer = SummaryWriter(log_dir)
            except Exception:
                self.writer = None

    def add_model_graph(self, model: torch.nn.Module, example: torch.Tensor):
        """``add_graph`` (utils/callbacks.py:29-34): the text of a
        ``torch.export`` of ``model`` at ``example`` goes to
        ``model_graph.txt`` and, with tensorboardX, into a text summary;
        where the export fails, the reason does."""
        if not self._primary:
            return
        try:
            text = str(torch.export.export(model, (example,)))
        except Exception as e:  # the export's coverage varies by version
            text = f"(model graph unavailable: {type(e).__name__}: {e})"
        with open(os.path.join(self.log_dir, "model_graph.txt"), "w") as f:
            f.write(text)
        if self.writer is not None:
            # rendered as markdown: fence it, cap the size
            self.writer.add_text("model_graph", f"```\n{text[:200_000]}\n```",
                                 0)

    def append_loss(self, epoch: int, loss: float, val_loss: float):
        self.losses.append(loss)
        self.val_losses.append(val_loss)
        if not self._primary:
            return
        for name, v in (("epoch_loss", loss), ("epoch_val_loss", val_loss)):
            with open(os.path.join(self.log_dir, name + ".txt"), "a") as f:
                f.write(f"{v}\n")
        if self.writer is not None:
            self.writer.add_scalar("loss", loss, epoch)
            self.writer.add_scalar("val_loss", val_loss, epoch)
        self.loss_plot()

    def loss_plot(self):
        plt = _pyplot() if self._primary else None
        if plt is None:
            return
        it = range(len(self.losses))
        plt.figure()
        plt.plot(it, self.losses, "red", linewidth=2, label="train loss")
        plt.plot(it, self.val_losses, "coral", linewidth=2, label="val loss")
        if len(self.losses) >= 5:  # savgol needs window <= n
            try:
                from scipy.signal import savgol_filter
                num = 5 if len(self.losses) < 25 else 15
                plt.plot(it, savgol_filter(self.losses, num, 3), "green",
                         linestyle="--", linewidth=2, label="smooth train loss")
                plt.plot(it, savgol_filter(self.val_losses, num, 3), "#8B4513",
                         linestyle="--", linewidth=2, label="smooth val loss")
            except Exception:
                pass
        plt.grid(True)
        plt.xlabel("Epoch")
        plt.ylabel("Loss")
        plt.legend(loc="upper right")
        plt.savefig(os.path.join(self.log_dir, "epoch_loss.png"))
        plt.close("all")


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None where it is
    missing."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    return plt


class PredictorMiouCallback:
    """In-training evaluation through the inference path (``EvalCallback``,
    utils/callbacks.py:105-151,163-200): every ``period`` epochs the
    predictor letterboxes each val image from its file, predicts and
    un-letterboxes at the original resolution, and logs that mIoU to
    ``epoch_miou_predictor.txt`` — unlike :class:`MiouHistory`, which
    reuses the training eval step at the staged resolution.  Images of one
    resolution go through ``SegPredictor.predict_masks`` in batches of
    ``batch_size``, on ``device``."""

    def __init__(self, log_dir: str, dataset, period: int = 10,
                 batch_size: int = 8, device="cuda"):
        self.log_dir = log_dir
        self.ds = dataset
        self.period = period
        self.batch_size = batch_size
        self.device = device
        self._primary = is_primary()
        if self._primary:
            os.makedirs(log_dir, exist_ok=True)
        self._predictor = None

    def should_eval(self, epoch: int) -> bool:
        return (epoch + 1) % self.period == 0

    def run(self, cfg, state, epoch: int, log=print) -> float:
        from PIL import Image
        from cervical_tpu_torch import metrics as M
        from cervical_tpu_torch.data.voc import cvt_rgb
        from cervical_tpu_torch.inference.predictor import SegPredictor

        weights = state.model.state_dict()
        if self._predictor is None:
            self._predictor = SegPredictor(
                cfg, weights, fused_middle=cfg.fused_middle_eval,
                device=self.device)
        else:
            self._predictor.update_state(weights)
        nc = cfg.data.num_classes
        n = len(self.ds)
        hist = np.zeros((nc, nc), np.int64)

        def flush(bucket):
            imgs, lbls = bucket
            masks = self._predictor.predict_masks(
                np.stack(imgs), batch_size=self.batch_size)
            for lbl, mask in zip(lbls, masks):
                hist[...] += M.fast_hist(lbl, mask, nc)

        buckets = {}  # (ih, iw) -> (images, labels), one shape each
        for i in range(n):
            jpg_path, png_path = self.ds.paths(i)
            with Image.open(jpg_path) as jpg, Image.open(png_path) as png:
                img = np.asarray(cvt_rgb(jpg), np.uint8)
                lbl = np.asarray(png, np.uint8)
            b = buckets.setdefault(img.shape[:2], ([], []))
            b[0].append(img)
            b[1].append(lbl)
            if len(b[0]) >= 64:
                flush(buckets.pop(img.shape[:2]))
        for b in buckets.values():
            flush(b)
        miou = M.summarize_hist(hist)["miou"]
        if not self._primary:
            return miou
        with open(os.path.join(self.log_dir, "epoch_miou_predictor.txt"),
                  "a") as f:
            f.write(f"{miou}\n")
        log(f"predictor-path mIoU (original resolution, {n} images): "
            f"{miou:.4f}")
        return miou


class MiouHistory:
    """Track periodic mIoU evals: ``epoch_miou.txt`` + curve
    (callbacks.py:176-197)."""

    def __init__(self, log_dir: str, period: int = 10):
        self.log_dir = log_dir
        self.period = period
        self._primary = is_primary()
        if self._primary:
            os.makedirs(log_dir, exist_ok=True)
        self.epochs = [0]
        self.mious = [0.0]

    def should_eval(self, epoch: int) -> bool:
        return (epoch + 1) % self.period == 0

    def append(self, epoch: int, miou: float):
        self.epochs.append(epoch + 1)
        self.mious.append(miou)
        if not self._primary:
            return
        with open(os.path.join(self.log_dir, "epoch_miou.txt"), "a") as f:
            f.write(f"{miou}\n")
        plt = _pyplot()
        if plt is None:
            return
        plt.figure()
        plt.plot(self.epochs, self.mious, "red", linewidth=2,
                 label="train miou")
        plt.grid(True)
        plt.xlabel("Epoch")
        plt.ylabel("Miou")
        plt.title("A Miou Curve")
        plt.legend(loc="upper right")
        plt.savefig(os.path.join(self.log_dir, "epoch_miou.png"))
        plt.close("all")


class FusionHistory:
    """Per-fold loss/accuracy curves of the CV loop: one line per epoch in
    ``seed{S}_fold{F}_metrics.txt`` (epoch, train loss, val loss, train
    acc, val acc), PNG curves at the ``milestones`` epochs and at the end
    of the fold where matplotlib is present (the reference's milestone
    dumps, my_train(full).py:583-612)."""

    def __init__(self, log_dir: str, seed: int, fold: int,
                 milestones=(20, 50, 100, 150, 180)):
        self.log_dir = log_dir
        self.tag = f"seed{seed}_fold{fold}"
        self.milestones = set(milestones)
        self._primary = is_primary()
        if self._primary:
            os.makedirs(log_dir, exist_ok=True)
        self.train_loss, self.val_loss = [], []
        self.train_acc, self.val_acc = [], []

    def append(self, epoch: int, train_loss: float, val_loss: float,
               train_acc: float, val_acc: float):
        self.train_loss.append(train_loss)
        self.val_loss.append(val_loss)
        self.train_acc.append(train_acc)
        self.val_acc.append(val_acc)
        if not self._primary:
            return
        with open(os.path.join(self.log_dir, f"{self.tag}_metrics.txt"),
                  "a") as f:
            f.write(f"{epoch}\t{train_loss:.6f}\t{val_loss:.6f}\t"
                    f"{train_acc:.4f}\t{val_acc:.4f}\n")
        if (epoch + 1) in self.milestones:
            self.plot(epoch + 1)

    def plot(self, epoch=None):
        plt = _pyplot() if self._primary else None
        if plt is None:
            return
        suffix = f"_ep{epoch}" if epoch else ""
        it = range(len(self.train_loss))
        for name, tr, va, ylabel in (
                ("loss", self.train_loss, self.val_loss, "Loss"),
                ("acc", self.train_acc, self.val_acc, "Accuracy")):
            plt.figure()
            plt.plot(it, tr, label=f"train {name}")
            plt.plot(it, va, label=f"val {name}")
            plt.xlabel("Epoch")
            plt.ylabel(ylabel)
            plt.legend()
            plt.grid(True)
            plt.savefig(os.path.join(self.log_dir,
                                     f"{self.tag}_{name}{suffix}.png"))
            plt.close("all")
