"""Weights and host-side copies: the port's ``deeplab_from_flax`` inverts the
JAX package's ``convert_deeplab`` exactly; the port's own copies of the
config and numpy metrics behave as the JAX package's."""

import json

import numpy as np
import pytest
import torch

from cervical_tpu import config as JC
from cervical_tpu import metrics as JM
from cervical_tpu_torch import config as TC
from cervical_tpu_torch import metrics as TM
from cervical_tpu_torch.models.deeplab import DeepLab
from cervical_tpu_torch.train.flax_import import deeplab_from_flax, load_flax_npz

from torch_port_helpers import random_state, to_flax


@pytest.fixture(scope="module")
def state():
    return random_state(DeepLab(num_classes=5, downsample_factor=16), seed=31)


def test_flax_round_trip_is_exact(state):
    params, stats = to_flax(state)
    back = deeplab_from_flax(params, stats)
    assert set(back) == set(state)
    for k, v in state.items():
        if v.dtype.is_floating_point:
            assert torch.equal(back[k], v), k
    model = DeepLab(num_classes=5)
    model.load_state_dict(back, strict=True)


def test_flax_npz_round_trip(state, tmp_path):
    params, stats = to_flax(state)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = v

    walk(params, ("params",))
    walk(stats, ("batch_stats",))
    np.savez(tmp_path / "w.npz", **flat)
    p2, s2 = load_flax_npz(str(tmp_path / "w.npz"))
    back = deeplab_from_flax(p2, s2)
    assert all(torch.equal(back[k], v) for k, v in state.items()
               if v.dtype.is_floating_point)


def test_flax_import_refuses_mobilenet(state):
    """The MobileNetV2 mapping inverts ``convert_deeplab(sd, "mobilenet")``
    exactly at full width; a tree of one backbone refuses the other's
    mapping, and an unknown backbone raises."""
    mb = random_state(DeepLab(num_classes=5, backbone="mobilenet"), seed=32)
    params, stats = to_flax(mb, "mobilenet")
    back = deeplab_from_flax(params, stats, "mobilenet")
    assert set(back) == set(mb)
    for k, v in mb.items():
        if v.dtype.is_floating_point:
            assert torch.equal(back[k], v), k
    DeepLab(num_classes=5, backbone="mobilenet").load_state_dict(back,
                                                                 strict=True)
    with pytest.raises(KeyError):
        deeplab_from_flax(params, stats, backbone="xception")
    xp, xs = to_flax(state)
    with pytest.raises(KeyError):
        deeplab_from_flax(xp, xs, backbone="mobilenet")
    with pytest.raises(ValueError):
        deeplab_from_flax(xp, xs, backbone="resnet")


def test_metrics_copy_matches_jax():
    rng = np.random.default_rng(32)
    label = rng.integers(0, 6, (40, 30))  # 5 = out of range, dropped
    pred = rng.integers(0, 5, (40, 30))
    hist = TM.fast_hist(label, pred, 5)
    np.testing.assert_array_equal(hist, JM.fast_hist(label, pred, 5))
    for fn in ("per_class_iu", "per_class_pa_recall", "per_class_precision",
               "per_accuracy"):
        np.testing.assert_array_equal(getattr(TM, fn)(hist),
                                      getattr(JM, fn)(hist))
    a, b = TM.summarize_hist(hist), JM.summarize_hist(hist)
    assert a.keys() == b.keys() and a["names"] == b["names"]
    assert a["miou"] == b["miou"] and a["accuracy"] == b["accuracy"]
    assert TM.DEFAULT_SEG_CLASS_NAMES == JM.DEFAULT_SEG_CLASS_NAMES


def test_config_copy_matches_jax(tmp_path):
    argv = ["--data.input_shape", "[64, 96]", "--dtype=float32",
            "--backbone", "xception", "--data.num_classes", "3"]
    assert TC.parse_cli_overrides(argv) == JC.parse_cli_overrides(argv)
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"downsample_factor": 8, "seed": 5}))
    ov = TC.parse_cli_overrides(argv)
    t = TC.load_config(TC.SegTrainConfig, str(path), ov)
    j = JC.load_config(JC.SegTrainConfig, str(path), ov)
    for name in ("backbone", "downsample_factor", "seed", "dtype"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.data.input_shape == j.data.input_shape == (64, 96)
    assert t.data.num_classes == j.data.num_classes == 3
    with pytest.raises(KeyError):
        TC.load_config(TC.SegTrainConfig, None, {"no_such_key": 1})
    # defaults the predictor reads agree with the JAX package
    t0, j0 = TC.SegTrainConfig(), JC.SegTrainConfig()
    assert (t0.data.input_shape, t0.data.num_classes, t0.backbone,
            t0.downsample_factor, t0.dtype, t0.seed) == \
        (j0.data.input_shape, j0.data.num_classes, j0.backbone,
         j0.downsample_factor, j0.dtype, j0.seed)
