"""Fold-stacked FusionMAE training — the port's counterpart of the JAX
package's vmapped-folds engine (``jax.vmap`` of the train and eval steps over
(seed, fold) pairs, ``cervical_tpu/train/fusion_trainer.py:652-727``).

* :class:`FoldStack` holds F pairs' params as one ``(F, P)`` tensor (each
  pair's params flattened in ``named_parameters`` order) and their dropout
  buffers ``rng`` ``(F, 2)``; its forward is ``torch.func.vmap`` over
  ``torch.func.functional_call`` of one base :class:`FusionMAE`, so every
  ``Linear`` of the F models runs as one batched product.
* :class:`StackedAdam` is Adam with coupled L2 on the ``(F, P)`` params:
  each pair has its own step count and takes the step only where ``do``
  holds (epoch 0's no-step, a padding batch), its params, moments and
  count otherwise left bit for bit as they were.  The arithmetic is
  ``torch.optim.Adam``'s capturable foreach path with per-pair bias
  corrections; the LR may be a 0-dim device tensor, so a step captures in
  a CUDA graph.
* :func:`make_stacked_step`: one micro-batch of every pair — each pair's
  rows gathered from the device cohort outside the ``vmap``, forward, the
  per-pair weighted loss summed over pairs, backward, the stacked Adam.  A
  pair whose batch has no weight > 0 (a padding batch) neither steps nor
  advances its dropout count.
* :func:`make_stacked_eval`: the weighted CE and accuracy of every pair on
  its evaluation rows.
* :func:`save_group_ckpt` / :func:`load_group_ckpt`: the mid-group snapshot
  ``vmap_group_ckpt.npz`` (numpy only, written atomically).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from cervical_tpu_torch import losses
from cervical_tpu_torch.data.masks import imputation_masks
from cervical_tpu_torch.models.fusion import FusionMAE


class FoldStack(nn.Module):
    """F ``FusionMAE`` pairs stacked on a leading axis: ``flat`` (F, P) the
    params, ``rng`` (F, 2) each pair's ``[dropout_seed, count]``, ``grad``
    (F, P) the last step's gradients.  ``base`` (not a submodule) is the
    module :meth:`functional` calls with a pair's params; ``views`` maps
    each param name to its (F, ...) view of ``flat``, the leaves the
    gradients are taken against."""

    def __init__(self, base: FusionMAE,
                 state_dicts: Sequence[Mapping[str, torch.Tensor]],
                 dropout_seeds: Sequence[int]):
        super().__init__()
        device = next(base.parameters()).device
        object.__setattr__(self, "base", base)
        self.shapes = {n: tuple(p.shape) for n, p in base.named_parameters()}
        flat = torch.stack([torch.cat([sd[n].reshape(-1).to(device)
                                       for n in self.shapes])
                            for sd in state_dicts])
        self.flat = nn.Parameter(flat, requires_grad=False)
        self.register_buffer("rng", torch.tensor(
            [[int(s), 0] for s in dropout_seeds], device=device))
        self.register_buffer("grad", torch.zeros_like(flat))
        self.views = self._split(self.flat)
        for v in self.views.values():
            v.requires_grad_(True)

    def _split(self, flat) -> Dict[str, torch.Tensor]:
        out, at = {}, 0
        for n, shape in self.shapes.items():
            size = int(np.prod(shape))
            out[n] = flat[:, at:at + size].view(flat.shape[0], *shape)
            at += size
        return out

    def pair_state_dict(self, i: int, flat=None) -> Dict[str, torch.Tensor]:
        """Pair ``i``'s params (of ``flat``, by default the stack's own) as a
        ``FusionMAE`` ``state_dict`` of views."""
        return {n: v[i] for n, v in self._split(
            self.flat if flat is None else flat).items()}

    def functional(self, params, rng, *args, **kwargs):
        """The base model's forward with one pair's ``params`` and ``rng``
        (call under ``torch.func.vmap``)."""
        return torch.func.functional_call(self.base, (params, {"rng": rng}),
                                          args, kwargs)


class StackedAdam(torch.optim.Optimizer):
    """Adam with coupled L2 (``torch.optim.Adam(weight_decay=...)``) on a
    :class:`FoldStack`'s (F, P) params; state ``step`` (F,) and both
    moments (F, P), made at construction.  ``step(grad, do, lr)``: pairs
    where ``do`` (F,) bool holds take torch's capturable foreach Adam step
    with their own count; the others keep params, moments and count bit
    for bit (their updates are multiplied by 0 or blended with weight 0).
    ``lr``: a float or a 0-dim tensor on the params' device."""

    def __init__(self, flat: torch.Tensor, lr: float = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__([flat], dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        self.state[flat] = {
            "step": torch.zeros(flat.shape[0], device=flat.device),
            "exp_avg": torch.zeros_like(flat),
            "exp_avg_sq": torch.zeros_like(flat)}

    @torch.no_grad()
    def step(self, grad: torch.Tensor, do: torch.Tensor, lr):
        group = self.param_groups[0]
        p = group["params"][0]
        st = self.state[p]
        beta1, beta2 = group["betas"]
        wd = group["weight_decay"]
        do_f = do.to(p.dtype)
        col = do_f[:, None]
        st["step"].add_(do_f)
        g = grad.add(p, alpha=wd) if wd else grad
        st["exp_avg"].lerp_(g, col * (1 - beta1))
        v = st["exp_avg_sq"]
        v.mul_(torch.where(do, beta2, 1.0)[:, None].to(p.dtype))
        v.addcmul_(g * (col * (1 - beta2)), g)
        # a pair that never stepped has count 0; any count >= 1 keeps its
        # (discarded) update finite
        t = st["step"].clamp(min=1.0)
        step_size = torch.reciprocal((torch.pow(beta1, t) - 1) / lr)
        bc2_sqrt = torch.sqrt(-(torch.pow(beta2, t) - 1))
        denom = v.sqrt().div_(bc2_sqrt[:, None]).add_(group["eps"])
        denom.div_(step_size[:, None])
        p.add_(st["exp_avg"].div(denom).mul_(col))


def make_stacked_step(stack: FoldStack, opt: StackedAdam,
                      loss_fn: Callable) -> Callable:
    """``step(feats_all, labels_all, idx (F, B), mask (F, B, T), w (F, B),
    lr, do_step) -> {"loss", "ce_all", "corr" (F,), "preds" (F, 1 + T,
    B)}``: one train step of every pair in place on ``stack`` / ``opt``,
    pair ``f`` on the rows ``idx[f]`` of the device cohort ``feats_all`` /
    ``labels_all``.  ``loss_fn(out, labels, mae_mask, weights) -> (total,
    ce_all, preds)`` is the sequential step's loss."""

    def pair(params, rng, feats, labels, mask, w):
        out = stack.functional(params, rng, feats, mae_mask=mask)
        return loss_fn(out, labels, mask, w)

    vpair = torch.func.vmap(pair)
    leaves = list(stack.views.values())

    def step(feats_all, labels_all, idx, mask, w, lr, do_step: bool):
        stack.base.train()
        f, b = idx.shape
        rows = idx.reshape(-1)
        feats = {m: v.index_select(0, rows).view(f, b, *v.shape[1:])
                 for m, v in feats_all.items()}
        labels = labels_all.index_select(0, rows).view(f, b)
        valid = (w > 0).any(dim=-1)
        count = stack.rng[:, 1].clone()
        total, ce_all, preds = vpair(stack.views, stack.rng, feats, labels,
                                     mask, w)
        grads = torch.autograd.grad(total.sum(), leaves)
        with torch.no_grad():
            torch.cat([g.reshape(f, -1) for g in grads], dim=1,
                      out=stack.grad)
            # a padding batch does not advance its pair's dropout stream
            stack.rng[:, 1] = count + valid.long()
            if do_step:  # without it no pair steps (epoch 0's quirk)
                opt.step(stack.grad, valid, lr)
        corr = torch.sum((preds[:, 0] == labels) * w, dim=-1)
        return {"loss": total.detach(), "ce_all": ce_all.detach(),
                "corr": corr, "preds": preds}

    return step


def make_stacked_eval(stack: FoldStack) -> Callable:
    """``evaluate(feats_all, labels_all, idx (F, V), w (F, V), present (F,
    V, T)) -> {"ce", "acc"} (F,)``: each pair's fused-head CE (weighted
    mean) and accuracy (weighted) on its rows, absent slots imputed."""

    def pair(params, rng, feats, labels, present, w):
        out = stack.functional(params, rng, feats, present=present,
                               mae_mask=imputation_masks(present))
        fused = out["logits"]["all"]
        ce = losses.softmax_cross_entropy(fused, labels, w)
        acc = torch.sum((fused.argmax(dim=-1) == labels) * w) / torch.clamp(
            torch.sum(w), min=1.0)
        return ce, acc

    vpair = torch.func.vmap(pair)

    @torch.no_grad()
    def evaluate(feats_all, labels_all, idx, w, present):
        stack.base.eval()
        f, v = idx.shape
        rows = idx.reshape(-1)
        feats = {m: x.index_select(0, rows).view(f, v, *x.shape[1:])
                 for m, x in feats_all.items()}
        labels = labels_all.index_select(0, rows).view(f, v)
        ce, acc = vpair(stack.views, stack.rng, feats, labels, present, w)
        return {"ce": ce, "acc": acc}

    return evaluate


# -- the mid-group snapshot ----------------------------------------------------------

def save_group_ckpt(path: str, pairs: Sequence, next_epoch: int,
                    stack: FoldStack, opt: StackedAdam,
                    best: Mapping[str, torch.Tensor],
                    hists: List[np.ndarray],
                    generators: Mapping[str, Sequence[torch.Generator]]
                    ) -> None:
    """The in-flight group at an epoch-chunk boundary: the pair identities,
    the cursor, the stacked params and dropout counts, Adam's counts and
    moments, the best-by-val snapshot, the histories so far (six (E, F)
    arrays) and each pair's generators (``{name: [generator per pair]}``).
    numpy only, one file, tmp + rename."""
    st = opt.state[stack.flat]
    meta = {"pairs": [[int(p[0]), int(p[1])] for p in pairs],
            "next_epoch": int(next_epoch)}
    arrays = {"flat": stack.flat, "rng": stack.rng, "step": st["step"],
              "exp_avg": st["exp_avg"], "exp_avg_sq": st["exp_avg_sq"],
              **{f"best_{k}": v for k, v in best.items()}}
    arrays = {k: v.detach().cpu().numpy() for k, v in arrays.items()}
    for name, gens in generators.items():
        arrays[f"gen_{name}"] = np.stack([g.get_state().numpy()
                                          for g in gens])
    tmp = path + ".tmp.npz"
    np.savez(tmp, meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
             **{f"h{i}": h for i, h in enumerate(hists)}, **arrays)
    os.replace(tmp, path)


def load_group_ckpt(path: str, pairs: Sequence, stack: FoldStack,
                    opt: StackedAdam, best: Mapping[str, torch.Tensor],
                    generators: Mapping[str, Sequence[torch.Generator]]
                    ) -> Optional[tuple]:
    """Restore :func:`save_group_ckpt`'s snapshot in place if it holds the
    pending group's (seed, fold) pairs; returns (next epoch, histories) or
    None."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        if meta["pairs"] != [[int(p[0]), int(p[1])] for p in pairs]:
            return None
        st = opt.state[stack.flat]
        with torch.no_grad():
            for name, t in (("flat", stack.flat), ("rng", stack.rng),
                            ("step", st["step"]),
                            ("exp_avg", st["exp_avg"]),
                            ("exp_avg_sq", st["exp_avg_sq"]),
                            *((f"best_{k}", v) for k, v in best.items())):
                t.copy_(torch.from_numpy(data[name]))
        for name, gens in generators.items():
            for g, s in zip(gens, data[f"gen_{name}"]):
                g.set_state(torch.from_numpy(s.copy()))
        hists = [data[f"h{i}"] for i in range(6)]
    return meta["next_epoch"], hists
