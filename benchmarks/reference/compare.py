"""The numbers that decide ``correct``, each beside its limit.

Training (the window's first K-step call and the val pass before and
after it): the widest relative gap of a step's loss (``loss_gap``) and
step 1's alone (``loss1_gap``); the relative gap of the val pass's summed
loss before and after (``val_loss_gap0``, ``val_loss_gap``) and the share
of val pixels whose confusion-matrix cell differs (``val_hist_gap0``,
``val_hist_gap``), and ``val_hist_gap0`` over the same share for the
reference's own first val pass with its convolutions in bfloat16, which
shows how far rounding alone moves that seed's val pass
(``val_hist_ratio0``; the witness's share floored at 1e-4); per leaf, the gap between the program's and the
reference's norms of Adam's first moment (``mean_gap``), of the root of
its second (``rms_gap``: the gradient's root mean square over the steps)
and of the parameters' change (``change_gap``), each over the larger of
the reference leaf's norm and the median leaf's, at the worst leaf and at
the median leaf (``..._median``).  Leaves whose reference gradient is
under a thousandth of the median leaf's move under Adam by round-off alone
and are left out of the change.  Between two runs of the reference (the
witness) step 1's gradients are compared too: the median leaf's gap of
norms and norm of the difference (``grad_gap_median``,
``grad_err_median``).

Serving: per pixel of the compared requests, how far the reference
probability of the served class lies below the reference's best class;
its mean over every pixel (``mask_gap_mean``), over the worst image
(``mask_gap_image``) and over the worst request (``mask_gap_request``),
its widest (``mask_gap_max``), and the share of pixels whose served class
is not the reference's best (``mask_mismatch``).

A cell judges the numbers its limits file names (``benchmarks/limits/``);
the others are readings for ``control.py``.  A number that is not finite
fails.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

Check = Tuple[str, float, float]


def _leaves(prog: dict, ref: dict, keep):
    """Per kept leaf: (gap of norms, norm of the difference), each over the
    larger of the reference leaf's norm and the median leaf's."""
    norms = {n: float(t.norm()) for n, t in ref.items()}
    floor = statistics.median(norms.values())
    gaps, errs = [], []
    for n, r in ref.items():
        if not keep(n):
            continue
        p = prog[n].to(r.device, r.dtype)
        d = max(norms[n], floor, 1e-30)
        gaps.append(abs(float(p.norm()) - norms[n]) / d)
        errs.append(float((p - r).norm()) / d)
    return gaps, errs


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    def hist_gap(a, b):
        return 0.5 * float((a - b).abs().sum()) / float(b.sum())

    gnorm = {n: float(t.norm()) for n, t in ref["rms"].items()}
    tiny = 1e-3 * statistics.median(gnorm.values())
    out = {
        "loss_gap": rel(prog["losses"], ref["losses"]),
        "loss1_gap": rel(prog["losses"][:1], ref["losses"][:1]),
    }
    for i, tag in enumerate(("0", "")):
        out["val_loss_gap" + tag] = rel([prog["val"][i]["loss"]],
                                        [ref["val"][i]["loss"]])
        out["val_hist_gap" + tag] = hist_gap(prog["val"][i]["hist"],
                                             ref["val"][i]["hist"])
    if "val_witness" in ref:
        out["val_hist_ratio0"] = out["val_hist_gap0"] / max(
            hist_gap(ref["val_witness"]["hist"], ref["val"][0]["hist"]),
            1e-4)
    for key, name in (("mean", "mean_gap"), ("rms", "rms_gap"),
                      ("changes", "change_gap")):
        keep = (lambda n: gnorm[n] >= tiny) if key == "changes" \
            else (lambda n: True)
        gaps, _ = _leaves(prog[key], ref[key], keep)
        out[name] = max(gaps)
        out[name + "_median"] = statistics.median(gaps)
    if "grads" in prog:
        gaps, errs = _leaves(prog["grads"], ref["grads"], lambda n: True)
        out["grad_gap_median"] = statistics.median(gaps)
        out["grad_err_median"] = statistics.median(errs)
    return out


def serve_numbers(gaps) -> Dict[str, float]:
    """``gaps``: one (B, H, W) tensor of per-pixel gaps per request."""
    total = sum(g.numel() for g in gaps)
    return {
        "mask_gap_max": max(float(g.max()) for g in gaps),
        "mask_gap_mean": sum(float(g.double().sum()) for g in gaps) / total,
        "mask_gap_image": max(float(g.double().mean(dim=(1, 2)).max())
                              for g in gaps),
        "mask_gap_request": max(float(g.double().mean()) for g in gaps),
        "mask_mismatch": sum(int((g > 0).sum()) for g in gaps) / total,
    }


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    """The numbers the cell's limits name, each with its limit."""
    return [(name, numbers[name], limit) for name, limit in limits.items()]


def correct(checks: List[Check]) -> bool:
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def train(prog: dict, ref: dict, limits: Dict[str, float]) -> List[Check]:
    return judge(train_numbers(prog, ref), limits)


def serve(gaps, limits: Dict[str, float]) -> List[Check]:
    return judge(serve_numbers(gaps), limits)
