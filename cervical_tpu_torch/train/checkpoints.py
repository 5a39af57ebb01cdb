"""Checkpoints: periodic / best / last — port of
``cervical_tpu/train/checkpoints.py`` (orbax there, ``torch.save`` here).

Reference semantics (``utils/utils_fit.py:191-198``): every ``save_period``
epochs save ``ep{N}-loss-valloss``; keep a rolling ``best_epoch_weights``
keyed on min validation loss; always refresh ``last_epoch_weights``.  Unlike
the reference, which saves ``model.state_dict()`` alone, a checkpoint holds
the model (params and BatchNorm running stats), both optimizers' states,
the step count and ``extra`` (epoch, val loss), so a resume is exact.  The
trainer's random generators are not saved, as the JAX package saves no
PRNG key.  Under a process group the ranks hold the same state: only the
primary rank writes (utils_fit.py:185-198), then every rank waits at a
barrier, so a restore that follows reads a whole file on every rank.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from cervical_tpu_torch.parallel.mesh import barrier, is_primary


class CheckpointManager:
    """The reference's three-way save policy, one ``torch.save`` file per
    name under ``save_dir``."""

    def __init__(self, save_dir: str, save_period: int = 10):
        self.save_dir = os.path.abspath(save_dir)
        self.save_period = save_period
        self.best_val_loss = float("inf")
        if is_primary():
            os.makedirs(self.save_dir, exist_ok=True)

    def _save(self, name: str, state, extra=None) -> str:
        path = os.path.join(self.save_dir, name)
        if not is_primary():
            return path
        payload = {"model": state.model.state_dict(),
                   "opt_state": {k: opt.state_dict()
                                 for k, opt in state.opt_state.items()},
                   "step": int(state.step), "extra": dict(extra or {})}
        # a kill mid-save leaves the temporary file, never a torn checkpoint
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        return path

    def on_epoch_end(self, epoch: int, state, train_loss: float,
                     val_loss: float, total_epochs: Optional[int] = None):
        """Apply the reference's three-way save policy
        (utils_fit.py:185-198); returns the paths written."""
        extra = {"epoch": epoch, "val_loss": val_loss}
        saved = []
        if (epoch + 1) % self.save_period == 0 or (
                total_epochs and epoch + 1 == total_epochs):
            saved.append(self._save(
                f"ep{epoch + 1:03d}-loss{train_loss:.3f}-val_loss{val_loss:.3f}",
                state, extra))
        if val_loss <= self.best_val_loss:
            self.best_val_loss = val_loss
            saved.append(self._save("best_epoch_weights", state, extra))
        saved.append(self._save("last_epoch_weights", state, extra))
        barrier("checkpoint")
        return saved

    def restore(self, name: str = "last_epoch_weights", state_template=None):
        """The checkpoint's dict; with a template
        :class:`~cervical_tpu_torch.train.seg_trainer.TrainState`, loads it
        into the template in place (model, both optimizers' states onto the
        template's params, step) and returns ``(state, extra)``."""
        payload = torch.load(os.path.join(self.save_dir, name),
                             map_location="cpu", weights_only=True)
        if state_template is None:
            return payload
        state_template.model.load_state_dict(payload["model"])
        for k, opt in state_template.opt_state.items():
            opt.load_state_dict(payload["opt_state"][k])
        state_template.step = payload["step"]
        return state_template, payload["extra"]
