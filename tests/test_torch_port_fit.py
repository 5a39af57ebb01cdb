"""The fit loop against the JAX package at 32², xception, float32 on the
CPU: ``SegTrainer.fit`` (the files its callbacks write, its history, the
graceful stop by ``request_stop`` and by the SIGTERM handler) and the
``train_seg`` CLI (config parsing against JAX's, one epoch in a
subprocess).  Checkpoints and ``pretrained`` loading are in
``test_torch_port_checkpoints.py``.

A checkpoint of the full-width model is up to ~0.65 GB (params and both
Adam states), so each test deletes its checkpoints when done.
"""

import dataclasses
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

from cervical_tpu import config as JC
from cervical_tpu.train import seg_trainer as JST
from cervical_tpu_torch.config import (SegTrainConfig, load_config,
                                       parse_cli_overrides)
from cervical_tpu_torch.data.voc import (VOCSegDataset, make_synthetic_voc,
                                         read_split)
from cervical_tpu_torch.train.checkpoints import CheckpointManager
from cervical_tpu_torch.train.seg_trainer import SegTrainer

from torch_port_helpers import (fit_overrides, tiny_jax_state,
                                two_torch_threads)  # noqa: F401

S = 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    """20 images at 32²: 16 train, 2 val."""
    return make_synthetic_voc(str(tmp_path_factory.mktemp("voc")),
                              num_images=20, size=S)


def _cfg(root, tmp_path, **kw):
    return load_config(SegTrainConfig, None,
                       fit_overrides(root, str(tmp_path / "logs"), S, **kw))


def _datasets(root):
    return (VOCSegDataset(root, read_split(root, "train"), (S, S)),
            VOCSegDataset(root, read_split(root, "val"), (S, S)))


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------

class _FakePredictor:
    """Stands in for the JAX ``SegPredictor`` (no program compiled)."""

    def __init__(self, cfg, state, fused_middle=False):
        del cfg, state, fused_middle

    def update_state(self, state):
        del state

    def predict_masks(self, images, batch_size=8):
        return np.zeros(np.shape(images)[:3], np.uint8)


def _listing(save_dir):
    """{file name, losses masked: line count (or None)}."""
    out = {}
    for name in os.listdir(save_dir):
        key = re.sub(r"loss\d+\.\d+", "loss*", name)
        key = re.sub(r"tfevents.*", "tfevents", key)
        path = os.path.join(save_dir, name)
        out[key] = None
        if name.endswith(".txt") and name != "model_graph.txt":
            with open(path) as f:
                out[key] = len(f.read().splitlines())
    return out


def test_fit_writes_the_files_of_a_jax_fit(voc_root, tmp_path, monkeypatch):
    """Two epochs, the first frozen, a checkpoint, an mIoU pass and a
    predictor-path pass every epoch: the port's fit writes the files a JAX
    fit on the same config writes — the same names (losses masked) and the
    same line counts of every .txt log — and returns the same history
    keys.  The JAX side's epochs, mIoU pass and predictor are stubbed and
    its state is a stand-in: compiling its xception train and eval steps
    on the CPU takes over two minutes, and the files are the fit loop's
    and the callbacks' bookkeeping, not the steps' arithmetic."""
    over = dict(freeze_train=True, freeze_epoch=1, unfreeze_epoch=2,
                save_period=1, eval_period=1, predictor_eval=True)
    cfg = _cfg(voc_root, tmp_path, **over)
    train, val = _datasets(voc_root)
    hist = SegTrainer(cfg, device="cpu").fit(train, val, log=lambda m: None)
    assert len(hist["train_loss"]) == 2
    assert all(np.isfinite(hist["train_loss"] + hist["val_loss"]))
    assert [e for e, _ in hist["miou"]] == [0, 1]
    assert [e for e, _ in hist["predictor_miou"]] == [0, 1]
    assert os.path.getsize(os.path.join(cfg.save_dir, "model_graph.txt")) \
        > 1000

    from cervical_tpu.data.voc import VOCSegDataset as JVOC
    from cervical_tpu.inference import predictor as JP
    monkeypatch.setattr(JST, "create_state",
                        lambda cfg, rng: tiny_jax_state())
    monkeypatch.setattr(JST.SegTrainer, "run_epoch",
                        lambda self, *a, **k: JST.EpochResult(
                            1.0, 2.0, 0.5, 0.5, 0.0))
    monkeypatch.setattr(JST.SegTrainer, "evaluate_miou",
                        lambda self, loader: {"miou": 0.5})
    monkeypatch.setattr(JP, "SegPredictor", _FakePredictor)
    jsave = str(tmp_path / "jax_logs")
    jcfg = JC.load_config(JC.SegTrainConfig, None,
                          fit_overrides(voc_root, jsave, S, **over))
    jtrain = JVOC(voc_root, read_split(voc_root, "train"), (S, S))
    jval = JVOC(voc_root, read_split(voc_root, "val"), (S, S))
    jhist = JST.SegTrainer(jcfg).fit(jtrain, jval, log=lambda m: None)
    assert sorted(hist) == sorted(jhist)
    got, want = _listing(cfg.save_dir), _listing(jsave)
    assert got == want
    assert got["epoch_loss.txt"] == 2 and got["epoch_miou_predictor.txt"] == 2
    shutil.rmtree(cfg.save_dir)


def test_fit_request_stop_checkpoints_and_resumes(voc_root, tmp_path):
    """The counterpart of ``test_fit_graceful_stop_checkpoints_and_resumes``:
    ``request_stop`` from the first epoch's log line finishes that epoch,
    checkpoints it and returns; the model-graph dump is the text of a
    ``torch.export`` program; ``last_epoch_weights`` holds epoch 0 and the
    trainer's step."""
    cfg = _cfg(voc_root, tmp_path)
    trainer = SegTrainer(cfg, device="cpu")
    train, val = _datasets(voc_root)

    def stopping_log(msg):
        trainer.request_stop()

    hist = trainer.fit(train, val, total_epochs=4, log=stopping_log)
    assert len(hist["train_loss"]) == 1
    graph_path = os.path.join(cfg.save_dir, "model_graph.txt")
    assert os.path.getsize(graph_path) > 1000
    with open(graph_path) as f:
        assert "ExportedProgram" in f.read(200)
    fresh = SegTrainer(cfg, seed=3, device="cpu")
    state, extra = CheckpointManager(cfg.save_dir).restore(
        "last_epoch_weights", fresh.state)
    assert extra["epoch"] == 0
    assert state.step == trainer.state.step > 0
    shutil.rmtree(cfg.save_dir)


def test_fit_stops_on_sigterm_and_restores_the_handlers(voc_root, tmp_path):
    """fit installs its SIGTERM/SIGINT handlers from the main thread: the
    handler in place during the first epoch, called as the signal would
    call it, stops the loop after that epoch; the previous handlers are
    back afterwards."""
    assert threading.current_thread() is threading.main_thread()
    cfg = _cfg(voc_root, tmp_path, freeze_train=True, freeze_epoch=10)
    trainer = SegTrainer(cfg, device="cpu")
    train, val = _datasets(voc_root)
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    seen = []

    def log(msg):
        seen.append(msg)
        if msg.startswith("Epoch 1/"):
            handler = signal.getsignal(signal.SIGTERM)
            assert handler is not before[signal.SIGTERM]
            assert signal.getsignal(signal.SIGINT) is handler
            handler(signal.SIGTERM, None)

    hist = trainer.fit(train, val, total_epochs=3, log=log)
    assert len(hist["train_loss"]) == 1
    assert any(m.startswith("stopped after epoch 1") for m in seen), seen
    assert {s: signal.getsignal(s) for s in before} == before
    shutil.rmtree(cfg.save_dir)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_config_matches_jax(tmp_path):
    """The same ``--config`` file and ``--key value`` list give the same
    config as the JAX CLI's parsing, over every field both have."""
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"backbone": "xception", "init_lr": 3e-4,
                                "data": {"num_classes": 4,
                                         "input_shape": [256, 256]}}))
    argv = ["--unfreeze_epoch", "7", "--data.aug_backend", "pallas",
            "--cls_weights", "[1, 2, 3, 4]", "--save_dir=runs/x",
            "--freeze_train", "true", "--data.jitter", "0.25"]
    got = load_config(SegTrainConfig, str(path), parse_cli_overrides(argv))
    want = JC.load_config(JC.SegTrainConfig, str(path),
                          JC.parse_cli_overrides(argv))
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert set(g) <= set(w) and set(g["data"]) <= set(w["data"])
    for k in g:
        if k == "data":
            for kk in g[k]:
                assert g[k][kk] == w[k][kk], kk
        else:
            assert g[k] == w[k], k
    assert got.data.input_shape == (256, 256) and got.unfreeze_epoch == 7


def test_train_seg_cli_defaults_to_cuda_and_refuses_multihost(voc_root,
                                                              monkeypatch):
    from cervical_tpu_torch import train_seg
    from cervical_tpu_torch.train import seg_trainer
    made = []

    class Recorder:
        def __init__(self, cfg, device="cuda"):
            made.append((cfg, device))

        def fit(self, train_ds, val_ds):
            made.append((len(train_ds), len(val_ds)))

    monkeypatch.setattr(seg_trainer, "SegTrainer", Recorder)
    train_seg.main(["--data.dataset_path", voc_root, "--unfreeze_epoch", "3"])
    assert made[0][1] == "cuda" and made[0][0].unfreeze_epoch == 3
    assert made[1] == (16, 2)
    with pytest.raises(NotImplementedError, match="item 14"):
        train_seg.main(["--multihost", "true"])
    with pytest.raises(NotImplementedError, match="item 14"):
        train_seg.main(["--coordinator=localhost:1234"])


def test_train_seg_cli_runs_one_epoch_on_cpu(voc_root, tmp_path):
    """``python -m cervical_tpu_torch.train_seg --device cpu`` trains one
    epoch at 32² from a JSON config plus overrides and writes its logs and
    checkpoints."""
    save_dir = tmp_path / "cli_logs"
    over = fit_overrides(voc_root, str(save_dir), S, unfreeze_epoch=1,
                      freeze_train=True, freeze_epoch=1)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({k: over.pop(k) for k in ("data", "dtype")}))
    argv = ["--config", str(path), "--device", "cpu"]
    for k, v in over.items():
        argv += [f"--{k}", v if isinstance(v, str) else json.dumps(v)]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-m", "cervical_tpu_torch.train_seg"]
                         + argv, cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert "num_train 16 / num_val 2" in out.stdout
    assert re.search(r"^Epoch 1/1 lr=", out.stdout, re.M), out.stdout[-2000:]
    names = set(os.listdir(save_dir))
    assert {"best_epoch_weights", "last_epoch_weights", "epoch_loss.txt",
            "epoch_val_loss.txt", "model_graph.txt"} <= names, names
    assert any(n.startswith("ep001-loss") for n in names), names
    shutil.rmtree(save_dir)
