"""The patch featurizer and the cohort builder against the JAX package:
``ResNetFeaturizer`` (ResNet-50 at 64², weights carried across by the JAX
package's ``convert_resnet``; the ResNet-101 parameter count at full
width), ``preprocess_imagenet``, ``resize_and_split``, the age features,
``assemble_cohort``, ``PatchFeaturizer`` on the CPU, and ``python -m
cervical_tpu_torch.build_graphs`` against ``scripts/build_graphs.py`` with
one cheap stand-in featurizer on both sides."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cervical_tpu.data import graphs as JG
from cervical_tpu.models.backbones import resnet as JR
from cervical_tpu.train import torch_import as JTI
from cervical_tpu_torch import build_graphs
from cervical_tpu_torch.data import graphs as PG
from cervical_tpu_torch.data.fusion_data import load_npz
from cervical_tpu_torch.models.backbones import resnet as PR

from torch_port_helpers import random_state, two_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = 32


@pytest.fixture(scope="module")
def resnet50():
    """The port's ResNet-50 with seeded weights (each bottleneck's closing
    ``bn3`` scaled ~0.1, so 16 blocks stay bounded), JAX's variables of the
    same weights, and 4 uint8 patches at 64²."""
    model = PR.ResNetFeaturizer(depth=50, out_features=OUT)
    state = random_state(model, seed=91, closing="bn3")
    model.load_state_dict(state)
    sd = {k: v.numpy() for k, v in state.items()
          if v.dtype.is_floating_point}
    params, stats, missing = JTI.convert_resnet(sd, depth=50, strict=True)
    assert not missing
    patches = np.random.default_rng(92).integers(
        0, 256, (4, 64, 64, 3)).astype(np.uint8)
    jm = JR.ResNetFeaturizer(depth=50, out_features=OUT)
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats},
        JR.preprocess_imagenet(jnp.asarray(patches))))
    return model.eval(), state, patches, ref


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()))


def test_resnet50_matches_jax(resnet50):
    model, _, patches, ref = resnet50
    with torch.inference_mode():
        got = model(PR.preprocess_imagenet(torch.from_numpy(patches))
                    .permute(0, 3, 1, 2)).numpy()
    print(f"\nresnet50: max abs {np.abs(got - ref).max():.3g} of max |ref| "
          f"{np.abs(ref).max():.3g}")
    assert got.shape == ref.shape == (4, OUT)
    _close(got, ref)


def test_patch_featurizer_matches_jax(resnet50):
    """``PatchFeaturizer`` with the same weights: one forward of the uint8
    patches in eval mode gives JAX's features as float32 numpy."""
    _, state, patches, ref = resnet50
    feat = PG.PatchFeaturizer(depth=50, out_features=OUT, state=state,
                              device="cpu")
    got = feat(patches)
    assert got.dtype == np.float32 and got.shape == (4, OUT)
    _close(got, ref)


def test_seeded_init_follows_flax():
    """Without a ``state`` the featurizer takes flax's init from its seed:
    conv and fc kernels at std sqrt(1/fan_in), BN scale 1, biases 0."""
    a = PG.PatchFeaturizer(depth=50, out_features=OUT, seed=3, device="cpu")
    b = PG.PatchFeaturizer(depth=50, out_features=OUT, seed=3, device="cpu")
    c = PG.PatchFeaturizer(depth=50, out_features=OUT, seed=4, device="cpu")
    sa, sb, sc = (f.model.state_dict() for f in (a, b, c))
    assert all(torch.equal(v, sb[k]) for k, v in sa.items())
    assert not torch.equal(sa["conv1.weight"], sc["conv1.weight"])
    for k in ("conv1.weight", "layer3.2.conv2.weight", "fc.weight"):
        w = sa[k]
        assert abs(float(w.std()) * w[0].numel() ** 0.5 - 1) < 0.05, k
    assert torch.equal(sa["bn1.weight"], torch.ones(64))
    assert not sa["fc.bias"].any()


def test_resnet101_parameter_count_matches_jax():
    """Full width (ResNet-101, 1024-d fc): the same number of parameters
    and of BatchNorm statistics as the JAX package's init, by
    ``jax.eval_shape`` (nothing computed)."""
    shapes = jax.eval_shape(
        JR.ResNetFeaturizer(depth=101, out_features=1024).init,
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)))
    count = lambda t: sum(int(np.prod(x.shape))  # noqa: E731
                          for x in jax.tree_util.tree_leaves(t))
    model = PR.ResNetFeaturizer(depth=101, out_features=1024)
    n_params = sum(p.numel() for p in model.parameters())
    n_stats = sum(b.numel() for n, b in model.named_buffers()
                  if "running" in n)
    assert n_params == count(shapes["params"])
    assert n_stats == count(shapes["batch_stats"])
    assert len(model.layer3) == 23


def test_preprocess_and_resize_and_split_match_jax():
    rng = np.random.default_rng(93)
    u8 = rng.integers(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    np.testing.assert_allclose(
        PR.preprocess_imagenet(torch.from_numpy(u8)).numpy(),
        np.asarray(JR.preprocess_imagenet(jnp.asarray(u8))), rtol=1e-6,
        atol=1e-6)
    image = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    got = PG.resize_and_split(image, 128, 32)
    ref = JG.resize_and_split(image, 128, 32)
    assert got.shape == ref.shape == (16, 32, 32, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * 255)
    # the patch order is x-major, as PIL crops: patch 1 is the one below 0
    full = PG.resize_and_split(image, 128, 128)[0]
    np.testing.assert_array_equal(got[1], full[32:64, :32])
    a, b = got.astype(np.uint8), ref.astype(np.uint8)
    diff = np.abs(a.astype(int) - b.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


def test_age_features_match_jax(monkeypatch):
    ages = {"p1": 23, "p2": 51, "p3": 37.5, "p4": 68, "p5": 23}
    assert PG.DIAGNOSIS_MAPPING == JG.DIAGNOSIS_MAPPING
    assert PG.normalize_ages(ages) == JG.normalize_ages(ages)
    assert PG.normalize_ages(ages, 20, 80) == JG.normalize_ages(ages, 20, 80)
    for age in (0, 4.9, 5, 23, 99, 120, -0.3, -1.0, 0.7):
        got = PG.age_to_one_hot(age, vector_length=50)
        np.testing.assert_array_equal(got, JG.age_to_one_hot(
            age, vector_length=50))
    # a normalised negative age lands in the last bin
    assert PG.age_to_one_hot(-0.3, vector_length=20)[19] == 1.0
    t = PG.make_embedding_table(5, 8, seed=2)
    assert t.shape == (5, 8) and t.dtype == np.float32
    np.testing.assert_array_equal(t, PG.make_embedding_table(5, 8, seed=2))
    monkeypatch.setattr(PG, "make_embedding_table", JG.make_embedding_table)
    got, ref = PG.build_cli_features(ages, dim=48), \
        JG.build_cli_features(ages, dim=48)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == np.float32 and got[k].shape == (4, 48)
        np.testing.assert_array_equal(got[k], ref[k])


def test_assemble_cohort_matches_jax():
    rng = np.random.default_rng(94)
    pids = [3, 1, 2, 5]
    diag = {p: int(rng.integers(0, 4)) for p in pids}
    img = {m: {p: rng.standard_normal((16, 6)).astype(np.float32)
               for p in pids if not (m == "imgL" and p in (1, 5))}
           for m in ("imgN", "imgA", "imgL")}
    img["imgA"].pop(2)
    cli = {p: rng.standard_normal((4, 6)).astype(np.float32) for p in pids}
    got = PG.assemble_cohort(img, cli, diag)
    ref = JG.assemble_cohort(img, cli, diag)
    assert got["ids"] == ref["ids"] == ["1", "2", "3", "5"]
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    np.testing.assert_array_equal(got["present"], ref["present"])
    assert not got["present"][[0, 3], 2].any() and not got["present"][1, 1]
    for m in ref["feats"]:
        np.testing.assert_array_equal(got["feats"][m], ref["feats"][m])
    with pytest.raises(ValueError, match="imgL"):
        PG.assemble_cohort({"imgN": img["imgN"], "imgA": img["imgA"]}, cli,
                           diag)


class _StandIn:
    """A cheap deterministic featurizer for both CLIs: (16, 1024) features
    read off the image's pixels, so no ResNet is built or compiled."""

    def __init__(self, depth=101, **kw):
        self.depth = depth

    def featurize_image(self, image):
        v = np.asarray(image, np.float32).reshape(-1)[:16 * 64]
        return np.repeat(v.reshape(16, 64), 16, axis=1) / 255.0


def _load_jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_build_graphs_cli_matches_jax(tmp_path, monkeypatch):
    """6 patients in a csv (numeric ids, diagnoses by name; a second table
    gives them by index),
    three PNG folders with one patient missing from imgA and two from imgL,
    and one unrelated file: the port's CLI writes the cohort npz of the
    JAX CLI — ids, their order, labels, presence and features."""
    ids = [104, 101, 106, 102, 105, 103]
    diags = ["CIS", "Moderate dysplasia", "Severe dysplasia",
             "Mild dysplasia", "Mild dysplasia", "Severe dysplasia"]
    ages = [34, 45, 29, 61, 52, 38]
    rows = ["id,age,diagnosis"] + [f"{i},{a},{d}"
                                   for i, a, d in zip(ids, ages, diags)]
    (tmp_path / "patients.csv").write_text("\n".join(rows) + "\n")
    rng = np.random.default_rng(95)
    folders = {}
    for mod, skip in (("imgN", ()), ("imgA", (102,)), ("imgL", (101, 105))):
        d = tmp_path / mod
        d.mkdir()
        for pid in ids:
            if pid not in skip:
                Image.fromarray(rng.integers(0, 256, (32, 32, 3)).astype(
                    np.uint8)).save(d / f"{pid}_{mod}.png")
        (d / "notes.txt").write_text("not an image")
        folders[mod] = str(d)
    argv = ["--table", str(tmp_path / "patients.csv")]
    for mod, d in folders.items():
        argv += [f"--{mod}", d]
    monkeypatch.setattr(PG, "PatchFeaturizer", _StandIn)
    monkeypatch.setattr(JG, "PatchFeaturizer", _StandIn)
    monkeypatch.setattr(PG, "make_embedding_table", JG.make_embedding_table)
    build_graphs.main(argv + ["--out", str(tmp_path / "port.npz"),
                              "--device", "cpu"])
    _load_jax_script("build_graphs").main(
        argv + ["--out", str(tmp_path / "jax.npz")])
    got, ref = (load_npz(str(tmp_path / f)) for f in ("port.npz", "jax.npz"))
    assert got["ids"] == ref["ids"] == [str(i) for i in sorted(ids)]
    assert got["modalities"] == ref["modalities"]
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    np.testing.assert_array_equal(got["labels"], [2, 1, 3, 0, 1, 3])
    np.testing.assert_array_equal(got["present"], ref["present"])
    assert int((~got["present"]).sum()) == 3
    for m in ref["feats"]:
        np.testing.assert_array_equal(got["feats"][m], ref["feats"][m])
    jax_cli = _load_jax_script("build_graphs")
    (tmp_path / "index.csv").write_text("pid,age,label\nA7,30,2\nB2,41,0\n")
    for table in ("patients.csv", "index.csv"):
        assert build_graphs.read_table(str(tmp_path / table)) == \
            jax_cli.read_table(str(tmp_path / table))
    (tmp_path / "bad.csv").write_text("id,age,diagnosis\n7,30,unknown\n")
    with pytest.raises(SystemExit, match="unknown"):
        build_graphs.read_table(str(tmp_path / "bad.csv"))
