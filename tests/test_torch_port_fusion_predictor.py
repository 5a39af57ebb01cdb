"""The port's ``FusionPredictor`` and its two CLIs against the JAX package:
``predict_proba`` on one npz in both directions (a JAX-written
``best_seed*_fold*.npz`` served by the port, a port-written one served by
JAX) to 1e-5 (readings 6e-7 and 1.4e-6), the padded ragged tail, the imputation
path, the filler of absent slots; ``python -m
cervical_tpu_torch.predict_fusion`` and ``python -m
cervical_tpu_torch.train_fusion`` in a subprocess with ``--device cpu``.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from cervical_tpu.config import FusionTrainConfig as JCfg
from cervical_tpu.data.fusion_data import save_npz as j_save_npz
from cervical_tpu.inference.fusion_predictor import \
    FusionPredictor as JPredictor
from cervical_tpu.inference.fusion_predictor import \
    save_params_npz as j_save_params
from cervical_tpu.train.fusion_trainer import FusionTrainer as JTrainer
from cervical_tpu_torch.config import FusionTrainConfig
from cervical_tpu_torch.data.fusion_data import (load_npz,
                                                 make_synthetic_fusion,
                                                 save_npz)
from cervical_tpu_torch.inference.fusion_predictor import (FusionPredictor,
                                                           load_params_npz,
                                                           save_params_npz)
from cervical_tpu_torch.train.fusion_trainer import FusionTrainer

from torch_port_helpers import two_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODS = ("imgN", "imgA", "imgL", "cli")
TOL = 1e-5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fusion_pred")
    cfg_j = JCfg(in_features=32, hidden=64, batch_size=8)
    cfg_p = FusionTrainConfig(in_features=32, hidden=64, batch_size=8)
    ds = make_synthetic_fusion(num_patients=13, feature_dim=32, seed=0)
    jtr = JTrainer(cfg_j)
    params = jtr.init_state({m: v[:1] for m, v in ds["feats"].items()},
                            jax.random.PRNGKey(0))["params"]
    jax_npz = j_save_params(str(tmp / "jax.npz"), params)
    return cfg_j, cfg_p, ds, params, jax_npz, tmp


def _close(a, b):
    assert set(a) == set(b)
    worst = max(float(np.abs(np.asarray(a[k]) - b[k]).max()) for k in a)
    assert worst < TOL, worst
    return worst


def test_jax_npz_serves_in_the_port(setup):
    cfg_j, cfg_p, ds, params, jax_npz, _ = setup
    present = ds["present"].copy()
    present[::2, 1] = False
    present[3] = [False, False, False, True]
    for bs in (8, 512):  # 13 = one batch + a padded tail, or one batch
        ref = JPredictor(cfg_j, params, batch_size=bs).predict_proba(
            ds["feats"], present)
        got = FusionPredictor.from_npz(cfg_p, jax_npz, batch_size=bs,
                                       device="cpu").predict_proba(
            ds["feats"], present)
        print("JAX npz in the port", bs, _close(ref, got))


def test_port_npz_serves_in_jax(setup):
    cfg_j, cfg_p, ds, _, _, tmp = setup
    tr = FusionTrainer(cfg_p, device="cpu")
    st = tr.init_state(torch.Generator().manual_seed(5))
    path = save_params_npz(str(tmp / "port.npz"), st.model.state_dict())
    ref = JPredictor.from_npz(cfg_j, path, batch_size=8).predict_proba(
        ds["feats"])
    got = FusionPredictor(cfg_p, st.model.state_dict(), batch_size=8,
                          device="cpu").predict_proba(ds["feats"])
    print("port npz in JAX", _close(ref, got))
    back = load_params_npz(path)
    for k, v in st.model.state_dict().items():
        assert torch.equal(back[k], v), k


def test_predict_proba_shapes_sums_and_predict(setup):
    _, cfg_p, ds, _, jax_npz, _ = setup
    pred = FusionPredictor.from_npz(cfg_p, jax_npz, batch_size=8,
                                    device="cpu")
    probs = pred.predict_proba(ds["feats"], ds["present"])
    n = len(ds["labels"])
    assert set(probs) == {"all", *MODS}
    for v in probs.values():
        assert v.shape == (n, 4) and v.dtype == np.float32
        np.testing.assert_allclose(v.sum(-1), 1.0, atol=1e-5)
    out = pred.predict(ds["feats"])
    assert out["classes"].shape == (n,)
    np.testing.assert_array_equal(out["classes"], probs["all"].argmax(-1))
    assert (out["confidence"] > 0).all() and (out["confidence"] <= 1).all()
    for m in MODS:
        np.testing.assert_array_equal(out[f"classes_{m}"],
                                      probs[m].argmax(-1))
    for k in (1, 3, 13):
        sub = pred.predict_proba({m: v[:k] for m, v in ds["feats"].items()})
        np.testing.assert_allclose(sub["all"], probs["all"][:k], atol=1e-6)
    empty = pred.predict_proba({m: v[:0] for m, v in ds["feats"].items()})
    assert all(v.shape == (0, 4) for v in empty.values())


def test_imputation_and_filler_of_absent_slots(setup):
    _, cfg_p, ds, _, jax_npz, _ = setup
    pred = FusionPredictor.from_npz(cfg_p, jax_npz, batch_size=16,
                                    device="cpu")
    n = len(ds["labels"])
    full = pred.predict_proba(ds["feats"])["all"]
    present = np.ones((n, 4), bool)
    present[:, 1] = False
    nan_feats = dict(ds["feats"])
    nan_feats["imgA"] = np.full_like(nan_feats["imgA"], np.nan)
    nan = pred.predict_proba(nan_feats, present)
    zero_feats = dict(ds["feats"])
    zero_feats["imgA"] = np.zeros_like(zero_feats["imgA"])
    zero = pred.predict_proba(zero_feats, present)
    for k in nan:
        assert np.isfinite(nan[k]).all()
        np.testing.assert_allclose(nan[k], zero[k], atol=1e-6)
    assert np.abs(full - zero["all"]).max() > 1e-6


def test_unported_export_and_cpu_throughput_raise(setup):
    _, cfg_p, _, _, jax_npz, tmp = setup
    pred = FusionPredictor.from_npz(cfg_p, jax_npz, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pred.export_stablehlo(str(tmp / "x"))
    with pytest.raises(RuntimeError, match="card"):
        pred.get_throughput(batch_size=4, iters=1)


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_predict_fusion_cli(setup):
    cfg_j, _, ds, params, jax_npz, tmp = setup
    cohort = str(tmp / "cohort.npz")
    j_save_npz(cohort, ds)
    out = str(tmp / "preds.json")
    r = _run(["cervical_tpu_torch.predict_fusion", "--cohort", cohort,
              "--params", jax_npz, "--in_features", "32", "--hidden", "64",
              "--out", out, "--device", "cpu"], str(tmp))
    assert r.returncode == 0, r.stdout + r.stderr
    with open(out) as f:
        report = json.load(f)
    n = len(ds["labels"])
    assert len(report["classes"]) == n and len(report["probs"][0]) == 4
    assert "accuracy" in report and 0.0 <= report["accuracy"] <= 1.0
    ref = JPredictor(cfg_j, params).predict_proba(ds["feats"])
    np.testing.assert_array_equal(report["classes"], ref["all"].argmax(-1))
    for m in MODS:
        assert len(report[f"classes_{m}"]) == n
    r = _run(["cervical_tpu_torch.predict_fusion", "--cohort", cohort,
              "--params", jax_npz, "--in_features", "32", "--hidden", "64",
              "--export", str(tmp / "x.pt"), "--device", "cpu"], str(tmp))
    assert r.returncode != 0 and "NotImplementedError" in r.stderr


def test_predict_fusion_cli_unlabeled_two_modal(setup, tmp_path):
    """A label-free cohort, and a 2-modal model serving a 4-modal cohort
    with its present columns aligned by name."""
    _, _, ds, _, _, _ = setup
    unlabeled = dict(ds)
    unlabeled["labels"] = None
    save_npz(str(tmp_path / "u.npz"), unlabeled)
    cfg2 = FusionTrainConfig(in_features=32, hidden=64,
                             modalities=("imgN", "cli"))
    st = FusionTrainer(cfg2, device="cpu").init_state()
    save_params_npz(str(tmp_path / "p2.npz"), st.model.state_dict())
    out = str(tmp_path / "p2.json")
    r = _run(["cervical_tpu_torch.predict_fusion", "--cohort",
              str(tmp_path / "u.npz"), "--params", str(tmp_path / "p2.npz"),
              "--in_features", "32", "--hidden", "64", "--modalities",
              '["imgN","cli"]', "--out", out, "--device", "cpu"],
             str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    with open(out) as f:
        report = json.load(f)
    assert len(report["classes"]) == len(ds["ids"])
    assert "accuracy" not in report
    assert "classes_cli" in report and "classes_imgA" not in report
    assert load_npz(str(tmp_path / "u.npz"))["labels"] is None


def test_train_fusion_cli(tmp_path):
    ds = make_synthetic_fusion(num_patients=45, feature_dim=32, seed=3)
    save_npz(str(tmp_path / "cohort.npz"), ds)
    r = _run(["cervical_tpu_torch.train_fusion", "--cohort",
              str(tmp_path / "cohort.npz"), "--in_features", "32",
              "--hidden", "64", "--epochs", "2", "--kfold", "3",
              "--save_dir", str(tmp_path / "out"), "--log_dir",
              str(tmp_path / "log"), "--device", "cpu"], str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "mean test accuracy over folds" in r.stdout
    with open(tmp_path / "out" / "cv_results.json") as f:
        res = json.load(f)
    assert len(res["folds"]) == 3 and not res["stopped_early"]
    assert (tmp_path / "out" / "best_seed0_fold2.npz").exists()
    assert len(os.listdir(tmp_path / "log")) == 1
    # the fold-stacked engine, two pairs at a time (groups of 2 + 1): the
    # same files, and per fold the sequential CLI's results
    r = _run(["cervical_tpu_torch.train_fusion", "--cohort",
              str(tmp_path / "cohort.npz"), "--in_features", "32",
              "--hidden", "64", "--epochs", "2", "--kfold", "3",
              "--save_dir", str(tmp_path / "vm"), "--vmap_folds", "true",
              "--vmap_group", "2", "--device", "cpu"], str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "group 1: epochs 2/2" in r.stdout
    assert sorted(os.listdir(tmp_path / "vm")) == \
        sorted(os.listdir(tmp_path / "out"))
    with open(tmp_path / "vm" / "cv_results.json") as f:
        vm = json.load(f)
    with open(tmp_path / "vm" / "cv_progress.json") as f:
        assert len(json.load(f)["folds"]) == 3
    for a, b in zip(res["folds"], vm["folds"]):
        assert (a["seed"], a["fold"], a["best_epoch"]) == \
            (b["seed"], b["fold"], b["best_epoch"])
        assert abs(a["val_acc"] - b["val_acc"]) < 1e-5
        assert abs(a["test"]["acc_all"] - b["test"]["acc_all"]) < 1e-6
        assert a["test"]["confusion"] == b["test"]["confusion"]


def test_train_fusion_build_config_arity_deltas():
    from cervical_tpu_torch.train_fusion import build_config
    cfg, cohort, log_dir, vmap_folds, vmap_group, device = build_config(
        ["--modalities", '["imgN","imgA","imgL"]', "--kfold", "7",
         "--cohort", "c.npz"])
    assert (cfg.kfold, cfg.inner_test_size, cfg.weight_decay, cfg.lr_step) \
        == (7, 0.11, 1e-3, 30)
    assert cohort == "c.npz" and device == "cuda" and log_dir is None
    assert (vmap_folds, vmap_group) == (False, 25)
    # the fold-stacked engine's flags and bf16 go through to the trainer
    cfg, _, _, vmap_folds, vmap_group, _ = build_config(
        ["--vmap_folds", "true", "--vmap_group", "5", "--dtype",
         "bfloat16"])
    assert (vmap_folds, vmap_group, cfg.dtype) == (True, 5, "bfloat16")


def test_predictor_agrees_with_trainer_predict(setup):
    """The serving surface and the trainer's evaluation on one set of
    weights and a full-present cohort: the same fused classes."""
    _, cfg_p, ds, _, jax_npz, _ = setup
    sd = load_params_npz(jax_npz)
    pred = FusionPredictor(cfg_p, sd, batch_size=8, device="cpu")
    classes = pred.predict(ds["feats"])["classes"]
    rep = FusionTrainer(cfg_p, device="cpu").predict(sd, ds, batch_size=8)
    assert rep["acc_all"] == float(np.mean(classes == ds["labels"]))
    assert rep["confusion"].sum() == len(ds["labels"])


def test_cohort_npz_interchanges_with_jax(tmp_path):
    from cervical_tpu.data import fusion_data as JFD
    from cervical_tpu_torch.data.fusion_data import align_to_modalities
    ds = make_synthetic_fusion(num_patients=6, feature_dim=16, seed=2)
    ds["present"] = np.random.default_rng(0).random((6, 4)) > 0.3
    jds = JFD.make_synthetic_fusion(num_patients=6, feature_dim=16, seed=2)
    for m in MODS:
        np.testing.assert_array_equal(ds["feats"][m], jds["feats"][m])
    save_npz(str(tmp_path / "p.npz"), ds)
    JFD.save_npz(str(tmp_path / "j.npz"), dict(jds, present=ds["present"]))
    # each package reads the other's file: the same cohort
    a = load_npz(str(tmp_path / "j.npz"))
    b = JFD.load_npz(str(tmp_path / "p.npz"))
    assert a["modalities"] == b["modalities"] == list(MODS)
    assert a["ids"] == b["ids"]
    np.testing.assert_array_equal(a["labels"], b["labels"])
    np.testing.assert_array_equal(a["present"], b["present"])
    for m in MODS:
        np.testing.assert_array_equal(a["feats"][m], b["feats"][m])
    p = align_to_modalities(load_npz(str(tmp_path / "p.npz")),
                            ("imgL", "cli"))
    j = JFD.align_to_modalities(JFD.load_npz(str(tmp_path / "p.npz")),
                                ("imgL", "cli"))
    np.testing.assert_array_equal(p["present"], j["present"])
    assert list(p["feats"]) == ["imgL", "cli"]
    with pytest.raises(ValueError, match="lacks"):
        align_to_modalities(p, ("imgN",))
