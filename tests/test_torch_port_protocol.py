"""The reference segmentation protocol's runner against the JAX package's
(``scripts/run_seg_protocol.py``, loaded from its path): the synthetic
arrays and the on-disk val set bit for bit, then the port's ``main`` on
the CPU at 64² — a 10-epoch run (its summary keys, artifacts, each train
image read once per epoch) and a 6-epoch run resumed to 10 (the resumed
state equal to the checkpoint bit for bit).

Losses are not compared with JAX's: the augmentation and dropout streams
differ by design.  The JAX runner itself takes minutes at these arguments
on the CPU (it compiles its programs cold), so the summary keys are held
against the literal in its source.  A checkpoint of the full-width model
is ~0.65 GB; each test deletes its run directory.
"""

import ast
import copy
import importlib.util
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from cervical_tpu_torch import run_seg_protocol as RP
from cervical_tpu_torch.train.seg_trainer import SegTrainer

from torch_port_helpers import two_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RUNNER = os.path.join(REPO, "scripts", "run_seg_protocol.py")
TINY = ["--device", "cpu", "--size", "64", "--train_n", "32", "--val_n",
        "8", "--freeze_epoch", "5"]


def _jax_runner():
    spec = importlib.util.spec_from_file_location("jax_run_seg_protocol",
                                                  JAX_RUNNER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_summary_keys():
    """The keys of the ``summary`` dict literal in the JAX runner."""
    with open(JAX_RUNNER) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == "summary"
                        for t in node.targets):
            return [k.value for k in node.value.keys]
    raise AssertionError("no summary literal in the JAX runner")


def _quiet(*_):
    pass


@pytest.mark.parametrize("num_classes", [5, 3])
@pytest.mark.parametrize("seed", [0, 77])
@pytest.mark.parametrize("size", [64, 96, 512])
def test_synth_seg_arrays_bit_exact(size, seed, num_classes):
    ref_i, ref_l = _jax_runner().synth_seg_arrays(5, size, num_classes,
                                                  seed=seed, log=_quiet)
    img, lbl = RP.synth_seg_arrays(5, size, num_classes, seed=seed,
                                   log=_quiet)
    assert img.dtype == np.uint8 and lbl.dtype == np.uint8
    np.testing.assert_array_equal(img, ref_i)
    np.testing.assert_array_equal(lbl, ref_l)
    assert set(np.unique(lbl)) <= set(range(num_classes))


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_write_val_to_disk_matches_jax(tmp_path):
    images, labels = RP.synth_seg_arrays(4, 64, seed=77, log=_quiet)
    ref = _jax_runner().write_val_to_disk(str(tmp_path / "jax"), images,
                                          labels, log=_quiet)
    got = RP.write_val_to_disk(str(tmp_path / "port"), images, labels,
                               log=_quiet)
    assert _tree(got) == _tree(ref)
    assert len(_tree(got)) == 2 * 4 + 4
    for rel in _tree(got):
        a, b = os.path.join(got, rel), os.path.join(ref, rel)
        if rel.endswith(".txt"):
            with open(a) as fa, open(b) as fb:
                assert fa.read() == fb.read()
        else:
            with Image.open(a) as ia, Image.open(b) as ib:
                assert ia.mode == ib.mode
                np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))
    with Image.open(os.path.join(got, "VOC2007", "SegmentationClass",
                                 "000002.png")) as png:
        np.testing.assert_array_equal(np.asarray(png), labels[2])


def test_protocol_refuses_without_card(tmp_path):
    """No fallback: without a card the default device is refused before
    any data is made."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device runs there")
    assert RP.parse_args([]).device == "cuda"
    with pytest.raises(SystemExit, match="no CUDA device"):
        RP.main(["--save_dir", str(tmp_path / "run")])
    assert not os.path.exists(tmp_path / "run" / "protocol_summary.json")


def _lines(save_dir, name):
    with open(os.path.join(save_dir, name)) as f:
        return f.read().splitlines()


def test_protocol_main_cpu(tmp_path, monkeypatch):
    """Ten epochs (5 frozen at batch 16, 5 unfrozen at batch 8) over 32 /
    8 images at 64²: the summary has the JAX runner's keys, the eval and
    predictor files their epoch-10 line, the checkpoints exist, every loss
    is finite, and each resident call of an epoch reads every train image
    once."""
    calls = []
    original = SegTrainer._resident_train

    def recording(self, data, frozen, idx, lr, gather):
        calls.append((frozen, data.batch_size, gather,
                      np.array(idx, np.int64)))
        return original(self, data, frozen, idx, lr, gather)
    monkeypatch.setattr(SegTrainer, "_resident_train", recording)
    save = str(tmp_path / "run")
    try:
        summary = RP.main(TINY + ["--save_dir", save, "--epochs", "10"])
        with open(os.path.join(save, "protocol_summary.json")) as f:
            on_disk = json.load(f)
        assert list(summary) == _jax_summary_keys()
        assert json.loads(json.dumps(summary)) == on_disk
        assert summary["epochs_run"] == 10
        assert summary["n_unfrozen_epochs"] == 5
        assert (summary["train_n"], summary["val_n"], summary["size"]) == \
            (32, 8, 64)
        assert [e for e, _ in summary["miou_trajectory"]] == [9]
        assert [e for e, _ in summary["predictor_miou"]] == [9]
        names = set(os.listdir(save))
        assert {"protocol.log", "epoch_loss.txt", "epoch_val_loss.txt",
                "epoch_miou.txt", "epoch_miou_predictor.txt",
                "model_graph.txt", "best_epoch_weights",
                "last_epoch_weights", "protocol_summary.json",
                "val_voc"} <= names
        assert [n for n in names if n.startswith("ep010-")]
        assert not [n for n in names
                    if n.startswith("ep005-") or n.endswith(".tmp")]
        assert len(_lines(save, "epoch_miou.txt")) == 1
        assert len(_lines(save, "epoch_miou_predictor.txt")) == 1
        for name in ("epoch_loss.txt", "epoch_val_loss.txt"):
            vals = [float(v) for v in _lines(save, name)]
            assert len(vals) == 10 and all(map(math.isfinite, vals)), vals
        assert math.isfinite(summary["final_train_loss"])
        log = "\n".join(_lines(save, "protocol.log"))
        assert "device: cpu" in log and "Epoch 10/10" in log
        assert log.count("resident upload") == 2  # each set once
        # one call per epoch here (2 batches of 16, then 4 of 8, all under
        # K = 8): each reads every train image once, in gather mode
        assert [(f, b, g) for f, b, g, _ in calls] == \
            [(True, 16, True)] * 5 + [(False, 8, True)] * 5
        for f, b, _, idx in calls:
            assert idx.shape == (32 // b, b)
            np.testing.assert_array_equal(np.sort(idx.ravel()),
                                          np.arange(32))
    finally:
        shutil.rmtree(save, ignore_errors=True)


def test_protocol_resume_cpu(tmp_path, monkeypatch):
    """Six epochs, then ``--resume`` to ten: the resumed trainer starts
    from the epoch-6 checkpoint bit for bit (model and both Adam states)
    and runs epochs 7-10; the loss file holds all ten epochs."""
    save = str(tmp_path / "run")
    try:
        first = RP.main(TINY + ["--save_dir", save, "--epochs", "6"])
        assert first["epochs_run"] == 6 and first["n_unfrozen_epochs"] == 1
        ckpt = torch.load(os.path.join(save, "last_epoch_weights"),
                          map_location="cpu", weights_only=True)
        assert ckpt["extra"]["epoch"] == 5
        seen = {}
        original = SegTrainer.fit

        def snapshot(self, *a, **kw):
            seen["model"] = {k: v.clone() for k, v in
                             self.state.model.state_dict().items()}
            seen["opt"] = copy.deepcopy({k: opt.state_dict() for k, opt
                                         in self.state.opt_state.items()})
            seen["step"] = self.state.step
            seen["init_epoch"] = self.cfg.init_epoch
            return original(self, *a, **kw)
        monkeypatch.setattr(SegTrainer, "fit", snapshot)
        second = RP.main(TINY + ["--save_dir", save, "--epochs", "10",
                                 "--resume"])

        assert seen["init_epoch"] == 6 and seen["step"] == ckpt["step"]
        assert seen["model"].keys() == ckpt["model"].keys()
        for k, v in ckpt["model"].items():
            assert torch.equal(seen["model"][k], v), k
        for group in ("backbone", "head"):
            mine, theirs = seen["opt"][group], ckpt["opt_state"][group]
            assert mine["state"].keys() == theirs["state"].keys()
            assert mine["state"], group  # both groups stepped by epoch 6
            for i, st in theirs["state"].items():
                for k, v in st.items():
                    assert torch.equal(torch.as_tensor(mine["state"][i][k]),
                                       torch.as_tensor(v)), (group, i, k)
        assert second["epochs_run"] == 4 and second["n_unfrozen_epochs"] == 4
        log = _lines(save, "protocol.log")
        resumed = log.index(next(m for m in log
                                 if m.endswith("resumed from epoch 6")))
        epochs = [m.split("] ")[1].split()[1] for m in log[resumed:]
                  if "] Epoch " in m]
        assert epochs == ["7/10", "8/10", "9/10", "10/10"]
        vals = [float(v) for v in _lines(save, "epoch_loss.txt")]
        assert len(vals) == 10 and all(map(math.isfinite, vals))
        assert len(_lines(save, "epoch_miou.txt")) == 1
        assert [n for n in os.listdir(save) if n.startswith("ep010-")]
    finally:
        shutil.rmtree(save, ignore_errors=True)
