"""The program's spans where they sit, on the CPU under
``utils.profiling.trace``: the predictor's request phases (``predict.*``),
the middle flow's host span (``mf.eval``) on its own and inside the fused
forward, and an epoch's parts (``seg.epoch``, ``seg.epoch.train``,
``seg.epoch.val``, one ``seg.call.train`` per train call) on the resident
and the host-loader paths."""

import math

import numpy as np
import pytest
import torch

from cervical_tpu_torch.config import SegDataConfig, SegTrainConfig
from cervical_tpu_torch.data.resident import ResidentSegData
from cervical_tpu_torch.data.voc import ArraySegDataset, BatchLoader
from cervical_tpu_torch.inference.predictor import SegPredictor
from cervical_tpu_torch.models.deeplab import DeepLab
from cervical_tpu_torch.ops import middle_flow as MF
from cervical_tpu_torch.train.seg_trainer import SegTrainer
from cervical_tpu_torch.utils import profiling as P
from cervical_tpu_torch.utils import trace

from torch_port_helpers import random_state, two_torch_threads  # noqa: F401

S = 32
PHASES = ("predict.stage", "predict.forward", "predict.unletterbox",
          "predict.argmax")


def _cfg(backbone="mobilenet", **kw):
    return SegTrainConfig(data=SegDataConfig(input_shape=(S, S)),
                          backbone=backbone, dtype="float32", **kw)


def _arrays(n, seed=0, hw=(S, S)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n,) + hw + (3,)).astype(np.uint8),
            rng.integers(0, 5, (n,) + hw).astype(np.uint8))


def _names_by_index(recs):
    return [r.name for r in recs]


@pytest.fixture(scope="module")
def mobilenet_predictor():
    state = random_state(DeepLab(num_classes=5, backbone="mobilenet"),
                         seed=11)
    return SegPredictor(_cfg(), state, device="cpu")


@pytest.mark.parametrize("n,batch", [(3, 2), (2, 2)])
def test_predict_masks_spans(mobilenet_predictor, tmp_path, n, batch):
    """One ``predict.request`` root; per batch one stage, forward,
    un-letterbox and argmax under it; one download; every record shares
    the request's root; no card seconds on the CPU."""
    images, _ = _arrays(n, seed=n, hw=(40, 52))
    with trace(str(tmp_path)) as tr:
        masks = mobilenet_predictor.predict_masks(images, batch_size=batch)
    assert masks.shape == (n, 40, 52)
    batches = math.ceil(n / batch)
    want = {"predict.request": (1, None), "predict.download":
            (1, "predict.request")}
    want.update({k: (batches, "predict.request") for k in PHASES})
    assert {k: (t.count, t.parent) for k, t in tr.spans.items()} == want
    recs = P.span_records()
    root = _names_by_index(recs).index("predict.request")
    assert {r.root for r in recs} == {root}
    assert all(r.device_s is None for r in recs)
    assert tr.spans["predict.request"].host_s >= sum(
        tr.spans[k].host_s for k in PHASES + ("predict.download",))


def test_run_stays_eager_on_the_cpu(mobilenet_predictor, tmp_path):
    """On the CPU ``_run`` is the eager forward: no graph kept, no
    ``predict.graph.*`` span, the probabilities of ``_serve``."""
    x = torch.rand(2, S, S, 3, generator=torch.Generator().manual_seed(5))
    with trace(str(tmp_path)) as tr:
        got = mobilenet_predictor._run(x)
    assert set(tr.spans) == {"predict.forward"}
    assert mobilenet_predictor._graphs == {}
    with torch.inference_mode():
        assert torch.equal(got, mobilenet_predictor._serve(x))


def test_middle_flow_eval_records_its_span(tmp_path):
    """``middle_flow_eval`` on the CPU (the plain path) is one ``mf.eval``
    host span per call."""
    rng = np.random.default_rng(3)
    c = 8
    folded = {k: torch.from_numpy(v.astype(np.float32)) for k, v in {
        "wdw": rng.standard_normal((2, 27, c)) * 0.2,
        "s1": rng.uniform(0.5, 1.5, (2, 3, c)),
        "c1": rng.standard_normal((2, 3, c)) * 0.1,
        "wpw": rng.standard_normal((2, 3, c, c)) * 0.5,
        "c2": rng.standard_normal((2, 3, c)) * 0.1}.items()}
    x = torch.from_numpy(rng.standard_normal((1, 5, 6, c)).astype(np.float32))
    with trace(str(tmp_path)) as tr:
        for _ in range(3):
            out = MF.middle_flow_eval(x, folded)
    torch.testing.assert_close(out, MF.middle_flow_reference(x, folded))
    assert tr.spans["mf.eval"].count == 3
    assert tr.spans["mf.eval"].parent is None
    assert tr.spans["mf.eval"].device_s is None


def test_fused_forward_holds_mf_eval(tmp_path):
    """In Xception's fused forward the middle flow's span sits inside
    ``predict.forward``: one per forward."""
    state = random_state(DeepLab(num_classes=5), seed=5)
    pred = SegPredictor(_cfg("xception"), state, fused_middle=True,
                        device="cpu")
    images, _ = _arrays(3, seed=4)
    with trace(str(tmp_path)) as tr:
        pred.predict_masks(images, batch_size=2)
    assert tr.spans["mf.eval"].count == tr.spans["predict.forward"].count == 2
    assert tr.spans["mf.eval"].parent == "predict.forward"


@pytest.mark.parametrize("path", ["resident", "loader"])
def test_epoch_spans(tmp_path, path):
    """An epoch of 5 train batches in 2-step calls and 3 val batches:
    ``seg.epoch`` the root of every record, its two parts under it, and one
    ``seg.call.train`` per train call under ``seg.epoch.train`` —
    ceil(5 / 2) resident calls; on the loader path 2 two-step calls and
    one single step.  The epoch's host time holds its parts'."""
    b, k = 4, 2
    imgs, lbls = _arrays(5 * b, seed=7)
    vimgs, vlbls = _arrays(3 * b - 1, seed=8)
    tr_ = SegTrainer(_cfg(steps_per_call=k, pipeline_depth=2), device="cpu")
    if path == "resident":
        train = ResidentSegData.from_arrays(imgs, lbls, b, "cpu")
        val = ResidentSegData.from_arrays(vimgs, vlbls, b, "cpu", train=False)
    else:
        train = BatchLoader(ArraySegDataset(imgs, lbls), b, shuffle=False)
        val = BatchLoader(ArraySegDataset(vimgs, vlbls), b, shuffle=False,
                          drop_last=False)
    with trace(str(tmp_path)) as tr:
        res = tr_.run_epoch(train, val, 0, False, 1e-4)
    assert math.isfinite(res.train_loss) and math.isfinite(res.val_loss)
    assert {k_: (t.count, t.parent) for k_, t in tr.spans.items()} == {
        "seg.epoch": (1, None), "seg.epoch.train": (1, "seg.epoch"),
        "seg.epoch.val": (1, "seg.epoch"),
        "seg.call.train": (math.ceil(5 / k), "seg.epoch.train")}
    recs = P.span_records()
    assert {r.root for r in recs} == {_names_by_index(recs).index(
        "seg.epoch")}
    s = tr.spans
    assert s["seg.epoch"].host_s >= s["seg.epoch.train"].host_s \
        + s["seg.epoch.val"].host_s
    assert s["seg.epoch.train"].host_s >= s["seg.call.train"].host_s
