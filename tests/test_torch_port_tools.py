"""The port's offline tools (``cervical_tpu_torch/tools``) and its
``prepare_dataset`` CLI against ``cervical_tpu.tools`` and
``scripts/prepare_dataset.py`` on the same temporary files: parsed records
equal, written files byte-equal, split ids equal, the 5x multimodal
augmentation to the tolerances of ``test_torch_port_histeq.py``."""

import base64
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from cervical_tpu.tools import labelbox as JLB
from cervical_tpu.tools import labelme as JLM
from cervical_tpu.tools import offline_aug as JOA
from cervical_tpu.tools import voc_annotation as JVA
from cervical_tpu_torch.tools import labelbox as LB
from cervical_tpu_torch.tools import labelme as LM
from cervical_tpu_torch.tools import offline_aug as OA
from cervical_tpu_torch.tools import voc_annotation as VA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _ndjson(path):
    recs = [
        {"data_row": {"external_id": "0002A0.jpg"},
         "projects": {"p1": {"labels": [{"annotations": {"objects": [
             {"name": "AWE", "mask": {"url": "http://x/m1"}},
             {"name": "Mosaic", "mask": {"url": "http://x/m2"},
              "composite_mask": {"url": "http://x/c"}}]}}]}}},
        {"data_row": {"external_id": "0003B1.jpg"},
         "projects": {"p1": {"labels": [{"annotations": {"objects": [
             {"name": "Atypical", "mask": {"url": "http://x/m3"}},
             {"name": "Punctation", "mask": {"url": "http://x/m4"}}]}}]}}},
        {"data_row": {"external_id": "0004C2.jpg"}, "projects": {}},
    ]
    with open(path, "w") as f:
        f.write("\n".join(json.dumps(r) for r in recs) + "\n\n")
    return path


def _stub_fetch(url):
    """White blobs on black, RGBA, drawn from the URL: the one stand-in
    for the network fetch on both sides."""
    rng = np.random.default_rng(sum(url.encode()))
    m = np.zeros((24, 24, 4), np.uint8)
    m[..., 3] = 255
    y, x = rng.integers(0, 16, 2)
    m[y:y + 8, x:x + 8, :3] = 255
    return m


def test_parse_ndjson_and_color_masks_equal_jax(tmp_path):
    p = _ndjson(str(tmp_path / "export.ndjson"))
    got, want = LB.parse_ndjson(p), JLB.parse_ndjson(p)
    assert got == want
    assert got[2] == ["0002A0", "0003B1", "0004C2"] and len(got[0]) == 4
    LB.build_color_masks(got[0], _stub_fetch, str(tmp_path / "port"))
    JLB.build_color_masks(want[0], _stub_fetch, str(tmp_path / "jax"))
    tree = _tree(tmp_path / "port")
    assert sorted(tree) == ["0002A0.png", "0003B1.png"]
    assert tree == _tree(tmp_path / "jax")
    LB.colors_to_gray(str(tmp_path / "port"), str(tmp_path / "gport"))
    JLB.colors_to_gray(str(tmp_path / "jax"), str(tmp_path / "gjax"))
    gray = _tree(tmp_path / "gport")
    assert gray == _tree(tmp_path / "gjax") and len(gray) == 2
    ids = np.unique(np.asarray(Image.open(tmp_path / "gport" / "0003B1.png")))
    assert set(ids.tolist()) == {0, 2, 4}
    src = tmp_path / "jpgs"
    src.mkdir()
    (src / "0002A0.jpg").write_bytes(b"jpeg")
    got = LB.copy_images_by_id(["0002A0", "0009Z9"], str(src),
                               str(tmp_path / "cp"))
    want = JLB.copy_images_by_id(["0002A0", "0009Z9"], str(src),
                                 str(tmp_path / "cpj"))
    assert got == want and _tree(tmp_path / "cp") == _tree(tmp_path / "cpj")


def test_recolor_and_merge_equal_jax():
    m = _stub_fetch("http://x/a")
    for name in LB.COLOR_MAP:
        np.testing.assert_array_equal(LB.recolor_mask(m, name),
                                      JLB.recolor_mask(m, name))
    parts = [LB.recolor_mask(_stub_fetch(u), n)[..., :3].astype(np.int64)
             for u, n in (("u1", "AWE"), ("u2", "Atypical"))]
    np.testing.assert_array_equal(np.asarray(LB.merge_masks(parts)),
                                  np.asarray(JLB.merge_masks(parts)))


def test_labelme_convert_folder_byte_equal(tmp_path):
    src = tmp_path / "json"
    src.mkdir()
    Image.fromarray(np.full((20, 24, 3), 180, np.uint8)).save(
        src / "a_src.png")
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(1).integers(
        0, 256, (20, 24, 3)).astype(np.uint8)).save(buf, format="PNG")
    recs = {
        "a.json": {"imagePath": "a_src.png", "shapes": [
            {"label": "person", "points": [[2, 2], [12, 2], [12, 12]]},
            {"label": "car", "shape_type": "rectangle",
             "points": [[14, 3], [20, 9]]}]},
        "b.json": {"imageData": base64.b64encode(buf.getvalue()).decode(),
                   "shapes": [
                       {"label": "cat", "shape_type": "circle",
                        "points": [[10, 10], [14, 10]]},
                       {"label": "nope", "points": [[0, 0], [5, 0], [5, 5]]}]},
    }
    for name, r in recs.items():
        (src / name).write_text(json.dumps(r))
    got = LM.convert_folder(str(src), str(tmp_path / "pj"),
                            str(tmp_path / "pp"))
    want = JLM.convert_folder(str(src), str(tmp_path / "jj"),
                              str(tmp_path / "jp"))
    assert got == want == ["a", "b"]
    assert _tree(tmp_path / "pj") == _tree(tmp_path / "jj")
    assert _tree(tmp_path / "pp") == _tree(tmp_path / "jp")
    mask = np.asarray(Image.open(tmp_path / "pp" / "b.png"))
    assert mask[10, 10] == LM.VOC_CLASSES.index("cat") and mask[1, 1] == 0


def _mini_voc(root, n=10, size=16, seed=0, binary=False):
    seg = os.path.join(root, "VOC2007", "SegmentationClass")
    jpg = os.path.join(root, "VOC2007", "JPEGImages")
    os.makedirs(seg)
    os.makedirs(jpg)
    rng = np.random.default_rng(seed)
    for i in range(n):
        m = rng.integers(0, 5, (size, size)).astype(np.uint8)
        if binary:
            m = (m > 2).astype(np.uint8) * 255
        Image.fromarray(m).save(os.path.join(seg, f"{i:03d}.png"))
        Image.fromarray(rng.integers(0, 255, (size, size, 3)).astype(
            np.uint8)).save(os.path.join(jpg, f"{i:03d}.jpg"))
    return root


@pytest.mark.parametrize("tv,tr,seed", [(1.0, 0.9, 0), (0.8, 0.75, 3)])
def test_generate_splits_equal_jax(tmp_path, tv, tr, seed):
    a = _mini_voc(str(tmp_path / "a"), n=13)
    b = _mini_voc(str(tmp_path / "b"), n=13)
    got = VA.generate_splits(a, tv, tr, seed)
    want = JVA.generate_splits(b, tv, tr, seed)
    assert got == want
    assert _tree(os.path.join(a, "VOC2007", "ImageSets")) == \
        _tree(os.path.join(b, "VOC2007", "ImageSets"))


@pytest.mark.parametrize("binary,num_classes", [(False, 5), (True, 5),
                                                (False, 3)])
def test_audit_labels_equal_jax(tmp_path, binary, num_classes):
    root = _mini_voc(str(tmp_path / "v"), n=4, binary=binary)
    counts, warnings = VA.audit_labels(root, num_classes)
    jcounts, jwarnings = JVA.audit_labels(root, num_classes)
    np.testing.assert_array_equal(counts, jcounts)
    assert warnings == jwarnings
    assert bool(warnings) == (binary or num_classes < 5)


def test_write_seg_augmented_byte_equal(tmp_path):
    """The same seed gives identical image and mask files, the masks
    following their image's transform."""
    root = _mini_voc(str(tmp_path / "v"), n=3, size=20)
    ids = ["000", "001", "002", "009"]  # a missing pair is skipped
    logs = []
    got = OA.write_seg_augmented(root, str(tmp_path / "p"), ids, seed=4,
                                 size=(24, 24), log=logs.append)
    want = JOA.write_seg_augmented(root, str(tmp_path / "j"), ids, seed=4,
                                   size=(24, 24), log=lambda m: None)
    assert got == want and len(got) == 24 and len(logs) == 1
    assert _tree(tmp_path / "p") == _tree(tmp_path / "j")
    OA.write_split_ids(got[:8], str(tmp_path / "s" / "train.txt"))
    JOA.write_split_ids(want[:8], str(tmp_path / "sj" / "train.txt"))
    assert _tree(tmp_path / "s") == _tree(tmp_path / "sj")


def test_augment_multimodal_5x_against_jax(tmp_path):
    """``augment_multimodal_5x(device="cpu")`` against JAX's: the equalized
    slot and its flips bit for bit, the blur within 1e-4 (convolution
    order), the rotation within 1e-3; the writers' files as names and
    pixels within one count (a blur value within 1e-4 of an integer can
    truncate to its neighbour)."""
    rng = np.random.default_rng(8)
    imgs = rng.integers(0, 256, (3, 32, 40, 3)).astype(np.uint8)
    angles = np.asarray([7.0, 33.0, 45.0], np.float32)
    got = OA.augment_multimodal_5x(imgs, angles, device="cpu")
    want = JOA.augment_multimodal_5x(imgs, angles)
    assert got.shape == want.shape == (5, 3, 32, 40, 3)
    np.testing.assert_array_equal(got[:3], want[:3])
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-4)
    over = int((np.abs(got[4] - want[4]).max(-1) > 1e-3).sum())
    assert over <= 1e-3 * got[4, ..., 0].size, over
    src = tmp_path / "src"
    src.mkdir()
    for i in range(2):
        Image.fromarray(imgs[i]).save(src / f"p{i}.png")
    names = OA.write_multimodal_augmented(str(src), str(tmp_path / "o"),
                                          batch=2, device="cpu")
    jnames = JOA.write_multimodal_augmented(str(src), str(tmp_path / "oj"),
                                            batch=2)
    assert names == jnames and len(names) == 10
    for n in names:
        a = np.asarray(Image.open(tmp_path / "o" / n), np.int16)
        b = np.asarray(Image.open(tmp_path / "oj" / n), np.int16)
        assert np.abs(a - b).max() <= 1, n


def test_prepare_dataset_cli_equals_script(tmp_path):
    """Every stage but the network fetch — the NDJSON report, colours to
    ids, splits 4,1,1, the 8x augmentation, the audit — in a subprocess of
    each CLI on two copies of one tree: the same output lines, split files
    and augmented tree."""
    base = tmp_path / "base"
    _mini_voc(str(base), n=6, size=24)
    seg = base / "VOC2007" / "SegmentationClass"
    palette = np.array([[0, 0, 0], [255, 255, 0], [255, 0, 0], [0, 255, 0],
                        [0, 0, 255]], np.uint8)
    colors = base / "colors"
    colors.mkdir()
    for f in sorted(os.listdir(seg)):
        Image.fromarray(palette[np.asarray(Image.open(seg / f))]).save(
            colors / f)
    shutil.rmtree(seg)
    _ndjson(str(base / "export.ndjson"))
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    outs = {}
    for side, cmd in (("port", ["-m", "cervical_tpu_torch.prepare_dataset"]),
                      ("jax", [os.path.join("scripts", "prepare_dataset.py")])):
        root = tmp_path / side
        shutil.copytree(base, root)
        args = ["--ndjson", str(root / "export.ndjson"),
                "--colors_dir", str(root / "colors"),
                "--gray_dir", str(root / "VOC2007" / "SegmentationClass"),
                "--split_root", str(root), "--ratios", "4,1,1",
                "--seed", "2", "--augment_root", str(root),
                "--augment_out", str(root / "aug"), "--audit", str(root)]
        r = subprocess.run([sys.executable] + cmd + args, cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr
        outs[side] = r.stdout.replace(str(root), "<root>")
    assert outs["port"] == outs["jax"]
    assert "splits: train 4 / val 1 / test 1" in outs["port"]
    assert "augmented 5 -> 40 images" in outs["port"]
    assert "WARNING" not in outs["port"]
    got = _tree(tmp_path / "port")
    assert got == _tree(tmp_path / "jax")
    assert len([k for k in got if k.startswith("aug")]) == 40 * 2 + 2
