"""The device-resident data path of the port (``data/resident.py`` and the
trainer's resident epoch) against the JAX package's, on the CPU:

* ``ResidentSegData.from_arrays``, ``rechunk`` and ``shuffle_`` against
  JAX's on the same arrays (the dropped tail, the padding and weights, the
  multiset a shuffle keeps);
* the row order of each epoch's calls in the "gather", "chunks" and
  "none" modes equal to the JAX package's (its ``run_epoch_resident``
  driven with its step programs replaced by recorders);
* a resident "none" epoch equal to the host-loader epoch, bit for bit (the
  same steps on the same batches and parameters; the JAX package's
  ``test_resident_epoch_matches_host_loader`` holds its two programs to
  float limits);
* a gather epoch reads every image once; the resident ``evaluate_miou``
  equals the host one; ``fit`` with ``device_resident`` runs end to end.
"""

import dataclasses
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cervical_tpu.config import SegDataConfig as JData
from cervical_tpu.config import SegTrainConfig as JCfg
from cervical_tpu.data.resident import ResidentSegData as JRes
from cervical_tpu.parallel import make_mesh
from cervical_tpu.train.seg_trainer import SegTrainer as JTrainer
from cervical_tpu_torch.config import SegDataConfig, SegTrainConfig
from cervical_tpu_torch.data.resident import ResidentSegData
from cervical_tpu_torch.data.voc import (ArraySegDataset, BatchLoader,
                                         VOCSegDataset, make_synthetic_voc,
                                         read_split)
from cervical_tpu_torch.train.seg_trainer import SegTrainer

from torch_port_helpers import two_torch_threads  # noqa: F401

S = 32


def _arrays(n, seed=0, size=S):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, size, size, 3)).astype(np.uint8),
            rng.integers(0, 5, (n, size, size)).astype(np.uint8))


def _cfg(**kw):
    return SegTrainConfig(data=SegDataConfig(input_shape=(S, S)),
                          dtype="float32", steps_per_call=2,
                          pipeline_depth=2, **kw)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_from_arrays_matches_jax(train):
    imgs, lbls = _arrays(11)
    got = ResidentSegData.from_arrays(imgs, lbls, 4, "cpu", train=train)
    want = JRes.from_arrays(imgs, lbls, 4, make_mesh(), train=train)
    np.testing.assert_array_equal(got.images.numpy(), np.asarray(want.images))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert (got.n, got.batch_size, len(got)) == (want.n, want.batch_size,
                                                  len(want))
    if train:
        assert got.weights is None and want.weights is None and got.n == 8
    else:
        np.testing.assert_array_equal(got.weights.numpy(),
                                      np.asarray(want.weights))
        assert got.weights.tolist() == [1.0] * 11 + [0.0]


def test_rechunk_matches_jax():
    imgs, lbls = _arrays(11)
    got = ResidentSegData.from_arrays(imgs, lbls, 4, "cpu", train=False)
    want = JRes.from_arrays(imgs, lbls, 4, make_mesh(), train=False)
    g6, w6 = got.rechunk(6), want.rechunk(6)
    assert (len(g6), g6.batch_size, g6.n) == (len(w6), w6.batch_size, w6.n)
    assert g6.images is got.images and g6.weights is got.weights
    for rs in (got, want):
        with pytest.raises(ValueError, match="rechunk"):
            rs.rechunk(5)


def test_shuffle_keeps_the_multiset_and_the_buffers():
    imgs, lbls = _arrays(12, seed=1)
    rs = ResidentSegData.from_arrays(imgs, lbls, 4, "cpu", train=True)
    ptr = rs.images.data_ptr()
    rs.shuffle_(torch.Generator().manual_seed(0))
    assert rs.images.data_ptr() == ptr
    got = rs.images.numpy().reshape(12, -1)
    assert not np.array_equal(got, imgs.reshape(12, -1))
    # the multiset of (image, label) pairs, as the JAX package's shuffle
    order = np.lexsort(got.T[::-1])
    ref = imgs.reshape(12, -1)
    ref_order = np.lexsort(ref.T[::-1])
    np.testing.assert_array_equal(got[order], ref[ref_order])
    np.testing.assert_array_equal(rs.labels.numpy()[order],
                                  lbls[ref_order])
    jrs = JRes.from_arrays(imgs, lbls, 4, make_mesh(), train=True)
    import jax
    jrs.shuffle_(jax.random.PRNGKey(0))
    jgot = np.asarray(jrs.images).reshape(12, -1)
    np.testing.assert_array_equal(jgot[np.lexsort(jgot.T[::-1])],
                                  ref[ref_order])
    val = ResidentSegData.from_arrays(imgs, lbls, 4, "cpu", train=False)
    with pytest.raises(ValueError, match="train sets"):
        val.shuffle_(torch.Generator())


def _jax_orders(mode, n, b, k, epoch, seed):
    """The index vectors the JAX package's resident epoch hands its K-step
    programs, recorded by stand-ins for the programs."""
    cfg = JCfg(data=JData(input_shape=(S, S)), backbone="mobilenet",
               dtype="float32", steps_per_call=k, resident_shuffle=mode,
               seed=seed)
    tr = JTrainer(cfg)
    seen = []

    def train_fn(frozen, kk, batch, gather=False):
        def run(state, im, lb, idx, lr, rng):
            seen.append(np.asarray(idx))
            return state, {"loss": jnp.zeros(kk), "f_score": jnp.zeros(kk)}
        return run

    def eval_fn(kk, batch):
        def run(state, im, lb, w, idx):
            return {"loss": 0.0, "f_score": 0.0, "count": kk}
        return run
    tr._train_step_scan_resident = train_fn
    tr._eval_step_scan_resident = eval_fn
    imgs, lbls = _arrays(n)
    mesh = make_mesh()
    tr.run_epoch_resident(JRes.from_arrays(imgs, lbls, b, mesh),
                          JRes.from_arrays(imgs[:4], lbls[:4], 4, mesh,
                                           train=False), epoch, False, 1e-3)
    return seen


@pytest.mark.parametrize("mode", ["gather", "chunks", "none"])
def test_epoch_row_orders_equal_jax(mode):
    """Each call's indices, in call order, as the JAX package's: 7 batches
    of 4 at K = 3 (two 3-step calls and a 1-step tail), epoch 5."""
    n, b, k, epoch = 30, 4, 3, 5
    want = _jax_orders(mode, n, b, k, epoch, seed=11)
    tr = SegTrainer(dataclasses.replace(_cfg(resident_shuffle=mode),
                                        steps_per_call=k), device="cpu")
    seen = []

    def record(data, frozen, idx, lr, gather):
        seen.append(np.asarray(idx))
        kk = len(idx)
        return {"loss": torch.zeros(kk), "f_score": torch.zeros(kk)}
    tr._resident_train = record
    tr._resident_eval = lambda data, pos, kk: {
        "loss": torch.zeros(()), "f_score": torch.zeros(())}
    imgs, lbls = _arrays(n)
    tr.run_epoch_resident(
        ResidentSegData.from_arrays(imgs, lbls, b, "cpu"),
        ResidentSegData.from_arrays(imgs[:4], lbls[:4], 4, "cpu",
                                    train=False), epoch, False, 1e-3)
    assert [len(x) for x in seen] == [3, 3, 1]
    assert len(seen) == len(want)
    for g, w in zip(seen, want):
        np.testing.assert_array_equal(g, w)


def test_resident_none_epoch_equals_host_loader_epoch():
    """``resident_shuffle="none"`` reads the batches in the host loader's
    unshuffled order: with K = 3 over 3 batches both epochs make one
    3-step call on the same batches and parameters."""
    imgs, lbls = _arrays(12, seed=2)
    vimgs, vlbls = _arrays(6, seed=3)
    cfg = dataclasses.replace(_cfg(resident_shuffle="none"),
                              steps_per_call=3)
    host, res = SegTrainer(cfg, device="cpu"), SegTrainer(cfg, device="cpu")
    r_host = host.run_epoch(
        BatchLoader(ArraySegDataset(imgs, lbls), 4, shuffle=False),
        BatchLoader(ArraySegDataset(vimgs, vlbls), 4, shuffle=False,
                    drop_last=False), 0, False, 1e-3)
    r_res = res.run_epoch(
        ResidentSegData.from_arrays(imgs, lbls, 4, "cpu"),
        ResidentSegData.from_arrays(vimgs, vlbls, 4, "cpu", train=False),
        0, False, 1e-3)
    assert r_host.train_loss == r_res.train_loss
    assert r_host.train_f_score == r_res.train_f_score
    assert r_host.val_loss == pytest.approx(r_res.val_loss, rel=1e-6)
    assert r_host.val_f_score == pytest.approx(r_res.val_f_score, rel=1e-6)
    sa, sb = host.state.model.state_dict(), res.state.model.state_dict()
    assert all(torch.equal(v, sb[k]) for k, v in sa.items())
    assert host.state.step == res.state.step == 3


def test_resident_gather_epoch_covers_every_image():
    imgs, lbls = _arrays(10, seed=4)
    tr = SegTrainer(_cfg(), device="cpu")
    seen = []
    run = tr._resident_train

    def record(data, frozen, idx, lr, gather):
        assert gather
        seen.append(np.asarray(idx).ravel())
        return run(data, frozen, idx, lr, gather)
    tr._resident_train = record
    rs = ResidentSegData.from_arrays(imgs, lbls, 4, "cpu")
    res = tr.run_epoch(rs, ResidentSegData.from_arrays(imgs, lbls, 4, "cpu",
                                                       train=False),
                       3, False, 1e-3)
    assert np.isfinite(res.train_loss) and np.isfinite(res.val_loss)
    assert sorted(np.concatenate(seen).tolist()) == list(range(8))
    assert tr.state.step == 2


def test_resident_evaluate_miou_equals_host():
    """11 images at batch 8 (one padded batch): the confusion matrices are
    equal, and count every real pixel once."""
    imgs, lbls = _arrays(11, seed=5)
    tr = SegTrainer(_cfg(), device="cpu")
    host = tr.evaluate_miou(BatchLoader(ArraySegDataset(imgs, lbls), 8,
                                        shuffle=False, drop_last=False))
    res = tr.evaluate_miou(ResidentSegData.from_arrays(imgs, lbls, 8, "cpu",
                                                       train=False))
    np.testing.assert_array_equal(host["hist"], res["hist"])
    assert res["hist"].sum() == 11 * S * S and host["miou"] == res["miou"]


def test_fit_device_resident_end_to_end(tmp_path):
    """Two epochs of ``fit`` with ``device_resident``: one frozen at batch
    8, then the rechunk to batch 4; the "images" shuffle; val and mIoU
    each epoch from the resident sets."""
    root = make_synthetic_voc(str(tmp_path / "voc"), num_images=20, size=S)
    train = VOCSegDataset(root, read_split(root, "train"), (S, S))
    val = VOCSegDataset(root, read_split(root, "val"), (S, S))
    cfg = dataclasses.replace(
        _cfg(resident_shuffle="images"), device_resident=True,
        freeze_train=True, freeze_epoch=1, freeze_batch_size=8,
        unfreeze_batch_size=4, eval_batch_size=2, eval_period=1,
        save_period=2, save_dir=str(tmp_path / "logs"))
    logs = []
    try:
        hist = SegTrainer(cfg, device="cpu").fit(train, val, total_epochs=2,
                                                 log=logs.append)
    finally:
        shutil.rmtree(cfg.save_dir, ignore_errors=True)
    assert len(hist["train_loss"]) == 2 and len(hist["miou"]) == 2
    assert all(np.isfinite(v) for v in hist["train_loss"] + hist["val_loss"])
    uploads = [m for m in logs if m.startswith("resident upload")]
    assert len(uploads) == 2, logs  # each dataset once, then a rechunk
