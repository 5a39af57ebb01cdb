"""The port's native batch loader (``cervical_tpu_torch/native``) against
the JAX package's (``cervical_tpu/native``: the same source and the same
libjpeg/libpng) and against PIL; the sidecars each writes read by the
other; ``VOCSegDataset``'s decoder counts; ``augment_batch_kernels(
planar=True)`` on the loader's planar batch; two processes building the
library at once.  Each test skips, with the reason, where ``g++`` or the
codecs are missing."""

import os
import struct
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from PIL import Image

from cervical_tpu_torch import native
from cervical_tpu_torch.data.voc import (VOCSegDataset, make_synthetic_voc,
                                         read_split)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip(f"native loader unavailable: "
                    f"{native.unavailable_reason()}")
    return native


def _load_when_written(J, limit=60.0, quiet=1.0):
    """Load the JAX package's loader once its library file holds still.
    Its build runs ``g++ -o`` straight onto ``_fastloader.so``, and another
    test process (``test_native_loader.py``) may be writing it: a load then
    fails with an ``OSError`` ("file too short"), which the module caches.
    Wait, at most ``limit`` seconds, until the file's size has not changed
    for ``quiet`` seconds, clear the cached reason and load again; any
    other reason (no ``g++``, no codecs) stands."""
    deadline = time.monotonic() + limit
    last = None
    while (not J.available() and J.unavailable_reason().startswith("OSError")
           and time.monotonic() < deadline):
        time.sleep(quiet)
        size = os.path.getsize(J._SO) if os.path.exists(J._SO) else -1
        if size > 0 and size == last:
            J._lib, J._unavailable_reason = None, None
        last = size
    return J.available()


@pytest.fixture(scope="module")
def jax_native():
    from cervical_tpu import native as J
    if not _load_when_written(J):
        pytest.skip(f"the JAX package's loader: {J.unavailable_reason()}")
    return J


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = make_synthetic_voc(str(tmp_path_factory.mktemp("voc")),
                              num_images=8, size=48)
    ds = VOCSegDataset(root, read_split(root, "train"), (48, 48))
    jpgs, pngs = zip(*(ds.paths(i) for i in range(4)))
    return root, list(jpgs), list(pngs)


@pytest.mark.parametrize("hw,planar", [((48, 48), False), ((32, 40), False),
                                       ((48, 48), True), ((32, 40), True)])
def test_batches_bit_equal_to_jax_loader(lib, jax_native, voc, hw, planar):
    _, jpgs, pngs = voc
    got = lib.load_batch(jpgs, pngs, hw, mask_cache=False, planar=planar)
    want = jax_native.load_batch(jpgs, pngs, hw, mask_cache=False,
                                 planar=planar)
    assert got[2] == want[2] == 0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_against_pil_resize_and_planar(lib, voc):
    """Images within 3 counts of PIL's on average (IDCT variants), labels
    exact; the resize path's shapes and ids; planar = NHWC transposed."""
    root, jpgs, pngs = voc
    ds = VOCSegDataset(root, read_split(root, "train"), (48, 48),
                       use_native=False)
    imgs, lbls, fails = lib.load_batch(jpgs, pngs, (48, 48))
    assert fails == 0
    for i in range(4):
        ref_img, ref_lbl = ds.load(i)
        assert np.abs(imgs[i].astype(int) - ref_img).mean() < 3.0
        np.testing.assert_array_equal(lbls[i], ref_lbl)
    small, slbl, fails = lib.load_batch(jpgs, pngs, (32, 32))
    assert fails == 0 and small.shape == (4, 32, 32, 3)
    assert slbl.shape == (4, 32, 32) and set(np.unique(slbl)) <= set(range(5))
    plan, plbl, fails = lib.load_batch(jpgs, pngs, (32, 32), planar=True)
    assert fails == 0 and plan.shape == (4, 3, 32, 32)
    np.testing.assert_array_equal(plan, small.transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(plbl, slbl)


def test_missing_file_is_a_failure(lib, tmp_path):
    imgs, lbls, fails = lib.load_batch([str(tmp_path / "no.jpg")],
                                       [str(tmp_path / "no.png")], (16, 16))
    assert fails == 2 and imgs.sum() == 0 and lbls.sum() == 0
    _, _, fails = lib.load_batch([str(tmp_path / "no.jpg")], None, (16, 16))
    assert fails == 1


def test_palette_png_decodes_to_indices(lib, tmp_path):
    """A 'P'-mode mask holds class ids as palette indices (the VOC
    convention, what ``tools/labelme.py`` writes): 8-bit and packed 4-bit
    streams decode to the indices, as PIL reads them."""
    idx = np.random.default_rng(0).integers(0, 5, (40, 40)).astype(np.uint8)
    pal = np.zeros((256, 3), np.uint8)
    pal[:5] = [[0, 0, 0], [128, 0, 0], [0, 128, 0], [128, 128, 0],
               [0, 0, 128]]
    im = Image.fromarray(idx).convert("L")
    im.putpalette(pal.reshape(-1).tolist())
    assert im.mode == "P"
    p8, p4 = str(tmp_path / "m8.png"), str(tmp_path / "m4.png")
    im.save(p8)
    im.save(p4, bits=4)
    jpg = str(tmp_path / "i.jpg")
    Image.fromarray(np.zeros((40, 40, 3), np.uint8)).save(jpg)
    _, lbls, fails = lib.load_batch([jpg, jpg], [p8, p4], (40, 40))
    assert fails == 0
    for k in range(2):
        np.testing.assert_array_equal(lbls[k], idx)
        np.testing.assert_array_equal(np.asarray(Image.open((p8, p4)[k])),
                                      idx)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sidecars_read_across_packages(lib, jax_native, tmp_path, writer):
    """A ``.rawmask`` sidecar written by one package's loader is read, not
    re-decoded, by the other's: its payload, overwritten after the write
    (header kept), is what the reader returns."""
    rng = np.random.default_rng(3)
    jp, pp = str(tmp_path / "a.jpg"), str(tmp_path / "a.png")
    Image.fromarray(rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
                    ).save(jp, quality=95)
    msk = rng.integers(0, 5, (32, 32)).astype(np.uint8)
    Image.fromarray(msk).save(pp)
    first, second = ((jax_native, lib) if writer == "jax"
                     else (lib, jax_native))
    _, l1, f1 = first.load_batch([jp], [pp], (32, 32))
    side = pp + ".rawmask"
    assert f1 == 0 and os.path.exists(side)
    np.testing.assert_array_equal(l1[0], msk)
    with open(side, "rb") as f:
        header = f.read(24)
    assert struct.unpack("<IIiiq", header)[0] == 0x43524D33  # "CRM3"
    planted = (msk + 1) % 5
    with open(side, "wb") as f:
        f.write(header + planted.tobytes())
    _, l2, f2 = second.load_batch([jp], [pp], (32, 32))
    assert f2 == 0
    np.testing.assert_array_equal(l2[0], planted)


def test_dataset_counts_its_decoders(lib, voc, monkeypatch):
    """``use_native=True`` delivers native batches, equal to PIL's labels;
    ``use_native=False`` PIL batches; without the library the native
    dataset falls back to PIL, counted as such."""
    root, _, _ = voc
    ids = read_split(root, "train")
    nat = VOCSegDataset(root, ids, (48, 48))
    pil = VOCSegDataset(root, ids, (48, 48), use_native=False)
    a, la = nat.load_batch(np.arange(4))
    b, lb = pil.load_batch(np.arange(4))
    assert nat.batches == {"native": 1, "pil": 0}
    assert pil.batches == {"native": 0, "pil": 1}
    np.testing.assert_array_equal(la, lb)
    assert np.abs(a.astype(int) - b).mean() < 3.0
    monkeypatch.setattr(native, "available", lambda: False)
    c, lc = nat.load_batch(np.arange(4))
    assert nat.batches == {"native": 1, "pil": 1}
    np.testing.assert_array_equal(c, b)


@pytest.mark.parametrize("kw", [{}, {"carry_u8": True}, {"fused": True},
                                {"letterbox": True}])
def test_planar_augmentation_equals_nhwc(lib, voc, kw):
    """``augment_batch_kernels(planar=True)`` on the loader's planar batch
    equals the NHWC call on its NHWC batch (the plain versions here)."""
    from cervical_tpu_torch.ops import augment as A
    from cervical_tpu_torch.ops import warp as W
    _, jpgs, pngs = voc
    nhwc, lbls, _ = lib.load_batch(jpgs, pngs, (48, 40))
    planar, _, _ = lib.load_batch(jpgs, pngs, (48, 40), planar=True)
    p = A.sample_augment_params(torch.Generator().manual_seed(2), 4,
                                rotate_prefix=2, blur_suffix=2)
    lab = torch.from_numpy(lbls)
    got = W.augment_batch_kernels(torch.from_numpy(planar), lab, p, (32, 32),
                                  planar=True, **kw)
    want = W.augment_batch_kernels(torch.from_numpy(nhwc), lab, p, (32, 32),
                                   **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


_BUILD = """
import sys
from pathlib import Path
import cervical_tpu_torch.ops._build as B
B.BUILD_DIR = Path(sys.argv[1])
from cervical_tpu_torch import native
assert native.available(), native.unavailable_reason()
imgs, lbls, fails = native.load_batch([sys.argv[2]], [sys.argv[3]], (48, 48),
                                      mask_cache=False)
assert fails == 0 and imgs.any()
print(native.library_path())
"""


def test_concurrent_builds_each_load_a_whole_library(lib, voc, tmp_path):
    """Two processes building into one empty directory at once: each
    compiles to a temporary name and renames it into place, so both load
    a whole library and no temporary file is left."""
    _, jpgs, pngs = voc
    build_dir = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(build_dir),
                               jpgs[0], pngs[0]], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert sorted(os.listdir(build_dir)) == [os.path.basename(paths.pop())]
