"""The rest of serving against the JAX package: ``SegEvaluator`` /
``presence_sets``, ``python -m cervical_tpu_torch.eval_miou`` in both of
its modes (the dirs mode against ``scripts/eval_miou.py``, with the bar
charts), and ``SegPredictor.export_program`` on the MobileNetV2 DeepLab
(loaded program against the eager predictor and the JAX ``_forward``)."""

import importlib.util
import os

import numpy as np
import pytest
import torch
from PIL import Image

from cervical_tpu.config import SegDataConfig as JData
from cervical_tpu.config import SegTrainConfig as JCfg
from cervical_tpu.inference import evaluator as JE
from cervical_tpu.inference.predictor import SegPredictor as JaxPredictor
from cervical_tpu_torch import eval_miou
from cervical_tpu_torch.config import SegDataConfig, SegTrainConfig
from cervical_tpu_torch.inference import evaluator as PE
from cervical_tpu_torch.inference.predictor import SegPredictor
from cervical_tpu_torch.models.deeplab import DeepLab

from torch_port_helpers import (random_state, scaled_atol, to_flax,
                                two_torch_threads)  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (64, 64)
BARS = ("mIoU.png", "mPA.png", "Recall.png", "Precision.png")


def _masks(seed, n=6, shape=(24, 30)):
    rng = np.random.default_rng(seed)
    gt = rng.integers(0, 5, (n,) + shape).astype(np.uint8)
    pred = np.where(rng.random(gt.shape) < 0.7, gt,
                    rng.integers(0, 5, gt.shape)).astype(np.uint8)
    gt[0] = 0  # a background-only image: an empty presence set
    pred[1, :] = 3
    return gt, pred


@pytest.mark.parametrize("min_pixels", [1, 40])
def test_seg_evaluator_matches_jax(min_pixels):
    gt, pred = _masks(71)
    for g, p in zip(gt, pred):
        np.testing.assert_array_equal(PE.presence_sets(p, 5, min_pixels),
                                      JE.presence_sets(p, 5, min_pixels))
    pe = PE.SegEvaluator(5, min_pixels=min_pixels)
    je = JE.SegEvaluator(5, min_pixels=min_pixels)
    pe.add_batch(gt, pred)
    je.add_batch(gt, pred)
    a, b = pe.summary(), je.summary()
    assert a.keys() == b.keys() and a["names"] == b["names"]
    np.testing.assert_array_equal(a["hist"], b["hist"])
    for k in ("iou", "recall", "precision"):
        np.testing.assert_array_equal(a[k], b[k])
    assert (a["miou"], a["mpa"], a["accuracy"]) == \
        (b["miou"], b["mpa"], b["accuracy"])
    assert a["multilabel"] == b["multilabel"]
    la, lb = [], []
    pe.report(la.append)
    je.report(lb.append)
    assert la == lb and len(la) == 5 + 2
    empty = PE.SegEvaluator(3).summary()
    assert "multilabel" not in empty and \
        empty.keys() == JE.SegEvaluator(3).summary().keys()


def _load_jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_pngs(root, masks, names):
    os.makedirs(root, exist_ok=True)
    for name, m in zip(names, masks):
        Image.fromarray(m).save(os.path.join(root, name + ".png"))


def test_eval_miou_dirs_mode_matches_jax(tmp_path, capsys):
    """The dirs mode prints the JAX CLI's lines, writes its csv, and the
    four bar charts of ``_write_metric_bars``."""
    gt, pred = _masks(72)
    names = [f"img{i}" for i in range(len(gt))]
    _write_pngs(str(tmp_path / "gt"), gt, names)
    _write_pngs(str(tmp_path / "pred"), pred, names)
    (tmp_path / "ids.txt").write_text("\n".join(names) + "\n")
    common = ["--gt_dir", str(tmp_path / "gt"), "--pred_dir",
              str(tmp_path / "pred"), "--ids", str(tmp_path / "ids.txt")]
    s = eval_miou.main(common + ["--miou_out", str(tmp_path / "port")])
    port_out = capsys.readouterr().out
    _load_jax_script("eval_miou").main(
        common + ["--miou_out", str(tmp_path / "jax")])
    jax_out = capsys.readouterr().out
    assert port_out.splitlines() == jax_out.splitlines()
    assert len(port_out.splitlines()) == 5 + 1
    assert int(s["hist"].sum()) == gt.size
    for f in ("confusion_matrix.csv",) + BARS:
        assert (tmp_path / "port" / f).stat().st_size > 0, f
    assert (tmp_path / "port" / "confusion_matrix.csv").read_text() == \
        (tmp_path / "jax" / "confusion_matrix.csv").read_text()


def test_eval_miou_checkpoint_mode(tmp_path):
    """The checkpoint mode restores a ``SegTrainer`` checkpoint (a
    MobileNetV2 one, through ``--dataset``) and reports the matrix that
    trainer's ``evaluate_miou`` gives on the same split."""
    from cervical_tpu_torch.data.voc import (BatchLoader, VOCSegDataset,
                                             make_synthetic_voc, read_split)
    from cervical_tpu_torch.train.checkpoints import CheckpointManager
    from cervical_tpu_torch.train.seg_trainer import SegTrainer
    root = str(tmp_path / "voc")
    make_synthetic_voc(root, num_images=10, size=48)
    cfg = SegTrainConfig(data=SegDataConfig(input_shape=HW,
                                            dataset_path=root),
                         backbone="mobilenet", dtype="float32", seed=3)
    trainer = SegTrainer(cfg, device="cpu")
    CheckpointManager(str(tmp_path / "ck")).on_epoch_end(0, trainer.state,
                                                        1.0, 1.0)
    ds = VOCSegDataset(root, read_split(root, "test"), stage_hw=HW)
    want = trainer.evaluate_miou(BatchLoader(ds, cfg.eval_batch_size,
                                             shuffle=False, drop_last=False))
    got = eval_miou.main(["--dataset", root, "--ckpt",
                          str(tmp_path / "ck" / "last_epoch_weights"),
                          "--backbone", "mobilenet", "--dtype", "float32",
                          "--data.input_shape", "[64, 64]", "--seed", "4",
                          "--device", "cpu"])
    np.testing.assert_array_equal(got["hist"], want["hist"])
    assert int(got["hist"].sum()) == len(ds.ids) * HW[0] * HW[1]


@pytest.fixture(scope="module")
def mobilenet_predictor():
    state = random_state(DeepLab(num_classes=5, backbone="mobilenet"),
                         seed=73)
    cfg = SegTrainConfig(data=SegDataConfig(input_shape=HW),
                         backbone="mobilenet", dtype="float32")
    return state, SegPredictor(cfg, state, device="cpu")


def test_export_program_matches_eager_and_jax(mobilenet_predictor, tmp_path):
    """The loaded ``.pt2`` program against the eager predictor (the program
    holds its weights contiguous, the predictor channels_last: 1e-5) and
    against the JAX predictor's ``_forward`` at the f32 parity limits;
    ``export_savedmodel`` says why it is not ported."""
    state, pred = mobilenet_predictor
    path = pred.export_program(str(tmp_path / "seg.pt2"), batch_size=2)
    program = torch.export.load(path).module()
    x = np.random.default_rng(74).random((2,) + HW + (3,)).astype(np.float32)
    with torch.no_grad():
        got = program(torch.from_numpy(x)).numpy()
        eager = pred._run(torch.from_numpy(x)).numpy()
    assert got.shape == (2,) + HW + (5,)
    assert float(np.abs(got - eager).max()) <= 1e-5
    jcfg = JCfg(data=JData(input_shape=HW), backbone="mobilenet",
                dtype="float32")
    params, stats = to_flax(state, "mobilenet")
    ref = np.asarray(JaxPredictor(jcfg, None)._forward(params, stats, x))
    np.testing.assert_allclose(got, ref, atol=scaled_atol(ref), rtol=2e-3)
    with pytest.raises(NotImplementedError, match="torch.export"):
        pred.export_savedmodel(str(tmp_path / "saved"))
