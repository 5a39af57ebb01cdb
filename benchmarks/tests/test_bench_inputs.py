"""The traffic's inputs and the weights are functions of the seed, and the
weights fit the program's model and the reference's alike."""

import pytest
import torch

from benchmarks.harness import datagen, weights

CPU = torch.device("cpu")


def test_scenes_deterministic_in_seed():
    a = datagen.scenes(123456789012, 3, (40, 56), 5, CPU, chunk=2)
    b = datagen.scenes(123456789012, 3, (40, 56), 5, CPU, chunk=2)
    c = datagen.scenes(7, 3, (40, 56), 5, CPU, chunk=2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == c[0].shape == (3, 40, 56, 3)
    assert a[0].dtype == torch.uint8 and a[1].dtype == torch.uint8
    vals = set(torch.unique(a[1]).tolist())
    assert vals <= {0, 1, 2, 3, 4, 255} and len(vals) >= 3


def test_scenes_without_labels():
    img, lbl = datagen.scenes(5, 2, (16, 24), 5, CPU, labels=False)
    assert lbl is None and img.shape == (2, 16, 24, 3)


@pytest.mark.parametrize("scheme", [{}, {"residual_bn": 0.05,
                                         "calibrate_bn": 2}])
def test_weights_deterministic(scheme):
    a = weights.make("mobilenet", 5, 2 ** 33 + 5, scheme, CPU, hw=(32, 32))
    b = weights.make("mobilenet", 5, 2 ** 33 + 5, scheme, CPU, hw=(32, 32))
    c = weights.make("mobilenet", 5, 4, scheme, CPU, hw=(32, 32))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)


@pytest.mark.parametrize("backbone", ["xception", "mobilenet"])
def test_state_dict_fits_the_program(backbone):
    from cervical_tpu_torch.models.deeplab import DeepLab
    with torch.device("meta"):
        port = DeepLab(num_classes=5, backbone=backbone).state_dict()
    ours = {n: s for n, s, _ in weights.layout(backbone, 5)}
    assert ours.keys() == port.keys()
    assert all(tuple(port[n].shape) == ours[n] for n in ours)


def test_calibrated_weights_normalise_the_eval_forward():
    from benchmarks.reference.model import DeepLab
    sd = weights.make("mobilenet", 5, 9, {"calibrate_bn": 2}, CPU,
                      hw=(64, 64))
    m = DeepLab("mobilenet", 5).eval()
    m.load_state_dict(sd)
    img, _ = datagen.scenes(9, 2, (64, 64), 5, CPU, labels=False)
    with torch.no_grad():
        logits = m(img.permute(0, 3, 1, 2).float() / 255)
    assert 0.3 < float(logits.std()) < 30
