"""Port ``SegPredictor`` on the CPU: its batched path vs its per-image path,
and its probs and masks vs the JAX ``SegPredictor`` on identical weights
(xception, os16, 64², f32).  Render modes, tiling, throughput and the CLI
run at the same small size."""

import types

import numpy as np
import pytest
import torch

from cervical_tpu.config import SegDataConfig as JData
from cervical_tpu.config import SegTrainConfig as JCfg
from cervical_tpu.inference.predictor import SegPredictor as JaxPredictor
from cervical_tpu_torch.config import SegDataConfig, SegTrainConfig
from cervical_tpu_torch.inference.predictor import SegPredictor
from cervical_tpu_torch.models.deeplab import DeepLab

from torch_port_helpers import (random_state, to_flax,
                                two_torch_threads)  # noqa: F401

HW = (64, 64)


@pytest.fixture(scope="module")
def state():
    return random_state(DeepLab(num_classes=5), seed=41)


@pytest.fixture(scope="module")
def predictor(state):
    cfg = SegTrainConfig(data=SegDataConfig(input_shape=HW), dtype="float32")
    return SegPredictor(cfg, state, device="cpu")


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(42)
    return rng.integers(0, 256, (5, 45, 70, 3)).astype(np.uint8)


def test_probs_and_masks_match_jax(state, predictor, images):
    """fp32 both sides.  Probs: softmax of logits that agree to ~1e-3
    absolute (the DeepLab parity tolerance), so 1e-3.  Masks: equal
    wherever the top two JAX probs differ by more than that."""
    params, stats = to_flax(state)
    cfg = JCfg(data=JData(input_shape=HW, num_classes=5), dtype="float32")
    jp = JaxPredictor(cfg, types.SimpleNamespace(params=params,
                                                 batch_stats=stats))
    masks = predictor.predict_masks(images, batch_size=2)
    for i, img in enumerate(images[:2]):
        ref = np.asarray(jp.predict_probs(img))
        got = predictor.predict_probs(img)
        assert got.shape == ref.shape == (45, 70, 5)
        np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)
        top2 = np.sort(ref, axis=-1)[..., -2:]
        decided = (top2[..., 1] - top2[..., 0]) > 1e-3
        np.testing.assert_array_equal(masks[i][decided],
                                      ref.argmax(-1)[decided])
        assert decided.mean() > 0.9
    assert len(np.unique(masks)) > 1  # the weights make a non-trivial map


def test_predict_masks_batched_matches_per_image(predictor, images):
    """Ragged tail (5 images at batch 2) padded and dropped; each mask
    equals the per-image get_miou_png."""
    masks = predictor.predict_masks(images, batch_size=2)
    assert masks.shape == (5, 45, 70) and masks.dtype == np.uint8
    for i, img in enumerate(images):
        np.testing.assert_array_equal(masks[i], predictor.get_miou_png(img))
    assert predictor.predict_masks(images[:0]).shape == (0, 45, 70)


def test_fused_middle_predictor_matches_plain(state, predictor, images):
    cfg = SegTrainConfig(data=SegDataConfig(input_shape=HW), dtype="float32")
    fused = SegPredictor(cfg, state, fused_middle=True, device="cpu")
    p0 = predictor.predict_probs(images[0])
    p1 = fused.predict_probs(images[0])
    np.testing.assert_allclose(p1, p0, atol=1e-3, rtol=0)


def test_bf16_predictor_runs(state, images):
    """The default compute dtype: bf16 convs, fp32 params and BN."""
    cfg = SegTrainConfig(data=SegDataConfig(input_shape=HW))
    p = SegPredictor(cfg, state, fused_middle=True, device="cpu")
    assert all(v.dtype == torch.float32 for v in p.model.state_dict().values()
               if v.dtype.is_floating_point)
    probs = p.predict_probs(images[0])
    assert probs.dtype == np.float32 and np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-4)


def test_detect_image_modes(predictor, images):
    img = images[0]
    for mode in (0, 1, 2):
        out = predictor.detect_image(img, mix_type=mode)
        assert out.shape == img.shape and out.dtype == np.uint8
    with pytest.raises(ValueError):
        predictor.detect_image(img, mix_type=9)


def _pixelwise_probs(x):
    """A pixel-local stand-in for the network: any correct tile stitching
    reproduces the whole-image map exactly."""
    x = x.float()
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    ch = torch.stack([r + 0.1, g + 0.2, b + 0.3, r * g + 0.05, (r + b) / 2], -1)
    return ch / ch.sum(-1, keepdim=True)


@pytest.mark.parametrize("shape", [(100, 75), (64, 64), (20, 45)])
def test_tiled_stitching_reproduces_pixelwise_map(predictor, shape):
    img = np.random.default_rng(43).integers(0, 255, shape + (3,)).astype(np.uint8)
    orig = predictor._run
    predictor._run = _pixelwise_probs
    try:
        out = predictor.predict_probs_tiled(img, overlap=0.25, batch_size=3)
    finally:
        predictor._run = orig
    expect = _pixelwise_probs(torch.from_numpy(img.astype(np.float32) / 255.0))
    np.testing.assert_allclose(out, expect.numpy(), atol=1e-5)
    with pytest.raises(ValueError):
        predictor.predict_probs_tiled(img, overlap=1.0)


def test_tiled_single_tile_matches_direct(predictor):
    img = np.random.default_rng(44).integers(0, 255, HW + (3,)).astype(np.uint8)
    np.testing.assert_allclose(predictor.predict_probs_tiled(img),
                               predictor.predict_probs(img), atol=1e-5)
    assert predictor.predict_mask_tiled(img).shape == HW


def test_throughput_and_fps_report_positive_rates(predictor, images):
    assert predictor.get_throughput(batch_size=2, iters=2) > 0
    assert predictor.get_fps(images[0], test_interval=2) > 0


def test_evaluate_miou_dir_matches_jax(tmp_path):
    from PIL import Image
    from cervical_tpu.inference.predictor import evaluate_miou_dir as jax_eval
    from cervical_tpu_torch.inference.predictor import evaluate_miou_dir
    rng = np.random.default_rng(45)
    names = []
    for i in range(3):
        for sub in ("gt", "pred"):
            (tmp_path / sub).mkdir(exist_ok=True)
            Image.fromarray(rng.integers(0, 5, (16, 20)).astype(np.uint8)).save(
                tmp_path / sub / f"im{i}.png")
        names.append(f"im{i}")
    got = evaluate_miou_dir(str(tmp_path / "gt"), str(tmp_path / "pred"),
                            names, 5, miou_out_path=str(tmp_path / "out"))
    ref = jax_eval(str(tmp_path / "gt"), str(tmp_path / "pred"), names, 5)
    np.testing.assert_array_equal(got["hist"], ref["hist"])
    assert got["miou"] == ref["miou"]
    assert (tmp_path / "out" / "confusion_matrix.csv").exists()


def test_cli_predicts_on_cpu(state, tmp_path):
    """``python -m cervical_tpu_torch.predict`` with a .pt and with a
    flax-layout .npz of the same weights renders the same image."""
    from PIL import Image
    from cervical_tpu_torch import predict
    img = np.random.default_rng(46).integers(0, 255, (50, 40, 3)).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "in.png")
    torch.save(state, tmp_path / "w.pt")
    params, stats = to_flax(state)
    flat = {}
    for root, tree in (("params", params), ("batch_stats", stats)):
        stack = [((root,), tree)]
        while stack:
            prefix, node = stack.pop()
            for k, v in node.items():
                if isinstance(v, dict):
                    stack.append((prefix + (k,), v))
                else:
                    flat["/".join(prefix + (k,))] = v
    np.savez(tmp_path / "w.npz", **flat)
    outs = []
    for ckpt in ("w.pt", "w.npz"):
        out = tmp_path / f"{ckpt}.png"
        predict.main(["--ckpt", str(tmp_path / ckpt), "--image",
                      str(tmp_path / "in.png"), "--out", str(out),
                      "--mix_type", "1", "--device", "cpu", "--dtype",
                      "float32", "--data.input_shape", "[64, 64]"])
        outs.append(np.asarray(Image.open(out)))
    assert outs[0].shape == img.shape
    np.testing.assert_array_equal(outs[0], outs[1])
    # --export writes a loadable torch.export program of the same weights;
    # it holds them contiguous where the predictor keeps them channels_last,
    # and the two layouts round differently (1.4e-6 in the probs)
    exported = tmp_path / "m.pt2"
    predict.main(["--ckpt", str(tmp_path / "w.pt"), "--export",
                  str(exported), "--device", "cpu", "--dtype", "float32",
                  "--data.input_shape", "[64, 64]"])
    x = torch.from_numpy(np.random.default_rng(47).random(
        (1, 64, 64, 3), np.float32))
    cfg = SegTrainConfig(data=SegDataConfig(input_shape=(64, 64)),
                         dtype="float32")
    with torch.no_grad():
        got = torch.export.load(str(exported)).module()(x)
    want = SegPredictor(cfg, state, device="cpu")._run(x)
    assert float((got - want).abs().max()) <= 1e-5
