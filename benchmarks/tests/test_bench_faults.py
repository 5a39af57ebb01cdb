"""The comparison that decides ``correct`` against the reference, at a
size the CPU holds: the reference agrees with the port where their
semantics meet, and a run with the timed path broken underneath (the
planted faults), or with the float8 control in the program's place, comes
out not correct under each cell's limits.  The card is not looked for:
the runners run on the CPU here."""

import numpy as np
import pytest
import torch

from benchmarks.harness import datagen, spec as S, weights
from benchmarks.reference import augment as A, compare
from benchmarks.reference.model import DeepLab
from benchmarks.tests.helpers import tiny_ctx

CPU = torch.device("cpu")


@pytest.mark.parametrize("backbone", ["xception", "mobilenet"])
def test_reference_forward_matches_the_port(backbone):
    from cervical_tpu_torch.models.deeplab import DeepLab as Port
    sd = weights.make(backbone, 5, 3, {"calibrate_bn": 2}, CPU, hw=(64, 64))
    ref = DeepLab(backbone, 5).eval()
    ref.load_state_dict(sd)
    port = Port(num_classes=5, backbone=backbone).eval()
    port.load_state_dict(sd)
    img, _ = datagen.scenes(3, 2, (64, 64), 5, CPU, labels=False)
    x = img.permute(0, 3, 1, 2).float() / 255
    with torch.no_grad():
        a = ref(x)
        b = port(x, resize_logits=False)
    assert torch.allclose(a, b, rtol=1e-4, atol=1e-4 * float(a.abs().max()))


def test_reference_augmentation_is_the_systems():
    from cervical_tpu_torch.ops import augment as PA
    from cervical_tpu_torch.ops.warp_xla import augment_batch_einsum
    imgs, lbls = datagen.scenes(10, 8, (96, 96), 5, CPU)
    p = A.sample_params(torch.Generator().manual_seed(12), 8)
    pp = PA.rows_to_params(PA.params_to_rows(PA.sample_augment_params(
        torch.Generator().manual_seed(12), 8, rotate_prefix=2,
        blur_suffix=2)))
    x, y = A.augment(imgs, lbls, p, (96, 96))
    xp, yp = augment_batch_einsum(imgs, lbls, pp, (96, 96),
                                  rotate_capacity=2, blur_capacity=2)
    assert torch.equal(y, yp)
    assert float((xp.float() - x).abs().mean()) * 255 < 1.5


def _run(cell):
    ctx = tiny_ctx(cell)
    return S.runner(ctx.traffic["runner"]).run(ctx)


def test_train_state_left_unchanged_fails(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    assert not compare.correct(_run("xception-train").checks)


def test_train_half_batch_fails(monkeypatch):
    import cervical_tpu_torch.train.seg_trainer as ST
    full = ST.seg_loss_bundle_fn

    def half(cfg, logits, labels, *a, **k):
        if k.get("sample_weights") is not None:  # the eval step
            return full(cfg, logits, labels, *a, **k)
        h = logits.shape[0] // 2
        return full(cfg, logits[:h], labels[:h], *a, **k)

    monkeypatch.setattr(ST, "seg_loss_bundle_fn", half)
    assert not compare.correct(_run("xception-train").checks)


def _serve_fault(monkeypatch, alter):
    from cervical_tpu_torch.inference.predictor import SegPredictor
    orig = SegPredictor.predict_masks

    def broken(self, images, batch_size=8):
        return alter(orig(self, images, batch_size))

    monkeypatch.setattr(SegPredictor, "predict_masks", broken)
    return _run("mobilenet-serve")


def test_serve_answer_altered_fails(monkeypatch):
    def alter(m):
        return (m + 1) % 5
    assert not compare.correct(_serve_fault(monkeypatch, alter).checks)


def test_serve_half_batch_fails(monkeypatch):
    def alter(m):
        m = m.copy()
        m[: len(m) // 2] = 0
        return m
    assert not compare.correct(_serve_fault(monkeypatch, alter).checks)


@pytest.mark.parametrize("cell", ["xception-train", "mobilenet-train"])
def test_train_control_fails(cell):
    from benchmarks.harness import train_epochs as T
    ctx = tiny_ctx(cell)
    s = T.Setup(ctx, warm=False)
    s.free()
    ref = s.reference()
    low = s.reference("float8")
    assert not compare.correct(compare.train(low, ref, ctx.limits))


@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("cell", ["mobilenet-serve", "xception-serve"])
def test_serve_control_fails(cell, seed):
    from benchmarks.reference import serve as R
    ctx = tiny_ctx(cell)
    backbone = ctx.config["model"]["backbone"]
    sd = weights.make(backbone, 5, seed, ctx.config["weights"], CPU,
                      hw=(64, 64))
    model = R.build(backbone, sd, 5, CPU)
    img, _ = datagen.scenes(seed, 4, (96, 128), 5, CPU, labels=False)
    p = R.probs(model, img, (64, 64))
    low = R.probs(model, img, (64, 64), "float8").argmax(1)
    assert not compare.correct(compare.serve([R.mask_gaps(p, low)],
                                             ctx.limits))
    assert np.isclose(float(R.mask_gaps(p, p.argmax(1)).max()), 0.0)
