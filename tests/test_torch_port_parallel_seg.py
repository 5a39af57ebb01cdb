"""Data-parallel segmentation training of the port (``SegTrainer(mesh=...)``)
on two gloo ranks, against one process on the global batch and against the
JAX package's step on ``make_mesh(2)``: MobileNetV2 at 64², f32, batch 8
(4 per rank), one Adam step with the kernel augmentation (dropout off, for
JAX) and one with the einsum augmentation and dropout on; a ragged eval
pass; a resident epoch in the gather mode.

Limits.  The ranks hold bit-identical params.  Against the one-process
step: the losses to 5e-5 relative, the f-score to 1%, the running stats to
1e-3 of each tensor's largest magnitude; Adam's first moments (0.1 x the
gradients) to 15% global relative L2 and at most 5% of the updated
elements moving the other way (Adam's first step moves each by lr x the
gradient's sign).  Those are the limits ``test_torch_port_train_step.py``
holds the port's step to JAX with: the one-process step's own f32 rounding
noise, read between 1 and 3 torch threads, is 7.9% in the moments and
1.2e-5 in the loss (a global BatchNorm over two ranks rounds as another
thread count does).  Against JAX's data-mesh step the same limits, the
running stats to 2e-3 (``test_torch_port_mobilenet.py``'s)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flax.linen
from jax.sharding import NamedSharding, PartitionSpec

from cervical_tpu.config import SegDataConfig as JData
from cervical_tpu.config import SegTrainConfig as JCfg
from cervical_tpu.parallel import make_mesh as j_make_mesh
from cervical_tpu.parallel import shard_batch as j_shard_batch
from cervical_tpu.train import seg_trainer as JT
from cervical_tpu_torch.data.resident import ResidentSegData
from cervical_tpu_torch.data.voc import ArraySegDataset, BatchLoader
from cervical_tpu_torch.models.deeplab import DeepLab
from cervical_tpu_torch.train import seg_trainer as PT
from cervical_tpu_torch.train.flax_import import deeplab_from_flax

import _torch_port_parallel_worker as WK
from torch_port_helpers import (random_state, run_ranks, to_flax,
                                two_torch_threads)  # noqa: F401

HW, LR = (64, 64), 1e-3
STEPS = [("pallas", "pallas", False), ("einsum", "einsum", True)]
LIMITS = {"loss": 5e-5, "main_loss": 5e-5, "f_score": 1e-2, "stats": 1e-3,
          "moments_l2": 0.15, "update_sign": 0.05}


@pytest.fixture(scope="module")
def spec():
    rng = np.random.default_rng(5)
    return {"hw": HW, "backbone": "mobilenet", "lr": LR,
            "state": random_state(DeepLab(num_classes=5,
                                          backbone="mobilenet"), 3),
            "images": rng.integers(0, 256, (8,) + HW + (3,)).astype(np.uint8),
            "labels": rng.integers(0, 6, (8,) + HW).astype(np.uint8),
            "val_images": rng.integers(0, 256, (24,) + HW + (3,)
                                       ).astype(np.uint8),
            "val_labels": rng.integers(0, 5, (24,) + HW).astype(np.uint8),
            "res_images": rng.integers(0, 256, (16,) + HW + (3,)
                                       ).astype(np.uint8),
            "res_labels": rng.integers(0, 5, (16,) + HW).astype(np.uint8),
            "res_lr": 0.0, "steps": STEPS}


@pytest.fixture(scope="module")
def ranks(spec, tmp_path_factory):
    return run_ranks("seg", 2, tmp_path_factory.mktemp("seg"), spec)


def _one_process(spec, backend, dropout):
    tr = WK.seg_trainer(spec, None, backend, dropout)
    m = tr.train_step(torch.from_numpy(spec["images"]),
                      torch.from_numpy(spec["labels"]), False, LR)
    return WK.snapshot(tr, m)


def _errors(got, want, before):
    """Each metric's relative error; the running stats' largest error over
    each tensor's largest magnitude; Adam's first moments' global relative
    L2; the share of updated elements moving the other way."""
    err = {k: abs(got["metrics"][k] - v) / max(abs(v), 1e-6)
           for k, v in want["metrics"].items()}
    sg, sw = got["state"], want["state"]
    err["stats"] = max(float((sg[n] - w).abs().max())
                       / max(float(w.abs().max()), 1e-30)
                       for n, w in sw.items() if "running" in n)
    num = den = 0.0
    for n, w in want["exp_avg"].items():
        num += float(((got["exp_avg"][n].double()
                       - w.reshape(got["exp_avg"][n].shape).double()) ** 2
                      ).sum())
        den += float((w.double() ** 2).sum())
    err["moments_l2"] = (num / den) ** 0.5
    flips = moved = 0
    for n in want["exp_avg"]:
        dg, dw = sg[n] - before[n], sw[n] - before[n]
        moved += int((dw != 0).sum())
        flips += int(((torch.sign(dg) != torch.sign(dw)) & (dw != 0)).sum())
    err["update_sign"] = flips / max(moved, 1)
    return err


@pytest.mark.parametrize("step", STEPS, ids=[s[0] for s in STEPS])
def test_two_rank_step_equals_one_process_global_batch(spec, ranks, step):
    name, backend, dropout = step
    a, b = ranks[0][name], ranks[1][name]
    for k, v in a["state"].items():
        assert torch.equal(v, b["state"][k]), k
    assert a["metrics"] == b["metrics"]
    err = _errors(a, _one_process(spec, backend, dropout), spec["state"])
    print(f"\n2 ranks vs 1 process ({name}): " + ", ".join(
        f"{k} {v:.3g}" for k, v in err.items()))
    for k, t in LIMITS.items():
        assert err[k] <= t, (k, err)


class _NoDropout(flax.linen.Module):
    rate: float

    @flax.linen.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


def test_two_rank_step_matches_jax_data_mesh(spec, ranks):
    """JAX's ``_make_train_body`` (kernel augmentation, dropout identity)
    under jit on ``make_mesh(2)``, the batch and its augmentation rows
    sharded over 'data' (``shard_batch``), params replicated; the port's
    two ranks on the same weights, batch and rows (drawn by the port's
    trainer from its seeded stream, given to JAX)."""
    jcfg = JCfg(data=JData(input_shape=HW, aug_backend="pallas"),
                backbone="mobilenet", dtype="float32")
    tr = WK.seg_trainer(spec, None, "pallas", False)
    rows = tr._param_rows(None, 8)
    from cervical_tpu_torch.ops.augment import rows_to_params
    aug = {k: np.asarray(v) for k, v in rows_to_params(rows).items()}
    params, stats = to_flax(spec["state"], "mobilenet")
    mesh = j_make_mesh(2)
    rep = NamedSharding(mesh, PartitionSpec())
    mp = pytest.MonkeyPatch()
    mp.setattr(flax.linen, "Dropout", _NoDropout)
    try:
        model, tx = JT.build_model(jcfg), JT.make_optimizer(jcfg)
        p = jax.device_put(jax.tree_util.tree_map(jnp.asarray, params), rep)
        bp, hp = JT._split_params(p)
        s0 = JT.TrainState(step=jnp.zeros((), jnp.int32), params=p,
                           batch_stats=jax.device_put(
                               jax.tree_util.tree_map(jnp.asarray, stats),
                               rep),
                           opt_state={"backbone": tx.init(bp),
                                      "head": tx.init(hp)})
        images, labels, jaug = j_shard_batch(
            mesh, (spec["images"], spec["labels"], aug))
        s1, m = jax.jit(JT._make_train_body(jcfg, model, tx, False))(
            s0, images, labels, jaug, jnp.float32(LR),
            jax.random.PRNGKey(0))
    finally:
        mp.undo()
    want = {"metrics": {k: float(v) for k, v in m.items()},
            "state": deeplab_from_flax(
                jax.tree_util.tree_map(np.asarray, s1.params),
                jax.tree_util.tree_map(np.asarray, s1.batch_stats),
                "mobilenet"),
            "exp_avg": {}}
    for g in ("backbone", "head"):
        want["exp_avg"].update(deeplab_from_flax(
            jax.tree_util.tree_map(np.asarray,
                                   s1.opt_state[g].inner_state[1].mu),
            None, "mobilenet"))
    got = ranks[0]["pallas"]
    err = _errors(got, want, spec["state"])
    print("\n2 ranks vs JAX on make_mesh(2): " + ", ".join(
        f"{k} {v:.3g}" for k, v in err.items()))
    for k, t in {**LIMITS, "loss": 5e-4, "main_loss": 5e-4,
                 "stats": 2e-3}.items():
        assert err[k] <= t, (k, err)


def test_ragged_eval_counts_every_pixel_once(spec, ranks):
    """24 images at eval batch 16 (a ragged batch of 8, padded with
    weight-0 rows, 8 per rank): both ranks' matrices count 24·64·64
    pixels and equal the one-process matrix; the val loss is the one
    process's."""
    tr = WK.seg_trainer(spec, None, "pallas", False)
    loader = BatchLoader(ArraySegDataset(spec["val_images"],
                                         spec["val_labels"]), 16,
                         shuffle=False, drop_last=False)
    want = torch.as_tensor(tr.evaluate_miou(loader)["hist"])
    res = tr.run_epoch([], loader, 0, False, LR)
    for o in ranks:
        assert int(o["eval_hist"].sum()) == 24 * HW[0] * HW[1]
        assert torch.equal(o["eval_hist"], want)
        assert abs(o["eval_epoch"].val_loss - res.val_loss) <= 1e-5 * abs(
            res.val_loss)


def test_resident_epoch_reads_each_ranks_rows(spec, ranks):
    """A resident "gather" epoch (16 images, batch 8, one 2-step call; the
    eval set resident too): every rank holds the whole set, draws the same
    permutation and reads its rows of each global batch; the params equal
    across ranks, the losses and the resident eval's matrix the one
    process's.  At LR 0 (the BatchNorm stats still move), so that Adam's
    first step, which moves every element by the LR and flips with the
    sign of a rounding-level gradient, cannot blur which rows were read."""
    tr = WK.seg_trainer(spec, None, "pallas", False)
    tr.cfg.steps_per_call = 2
    rs = ResidentSegData.from_arrays(spec["res_images"], spec["res_labels"],
                                     8, "cpu", train=True)
    ev = ResidentSegData.from_arrays(spec["val_images"], spec["val_labels"],
                                     8, "cpu", train=False)
    r = tr.run_epoch_resident(rs, ev, 0, False, spec["res_lr"])
    a, b = ranks[0]["resident"], ranks[1]["resident"]
    for k, v in a["state"].items():
        assert torch.equal(v, b["state"][k]), k
    assert abs(a["train_loss"] - r.train_loss) <= 5e-5 * abs(r.train_loss)
    assert abs(a["val_loss"] - r.val_loss) <= 5e-5 * abs(r.val_loss)
    assert torch.equal(a["miou_hist"], torch.as_tensor(
        tr.evaluate_miou(ev)["hist"]))
    assert int(a["miou_hist"].sum()) == 24 * HW[0] * HW[1]


def test_einsum_capacities_split_the_global_layout():
    """The einsum backend's rotated prefix and blurred suffix of a global
    batch, as each rank's share: a rank holds a prefix of the rotated rows
    and a suffix of the blurred ones; one rank holds all."""
    assert PT.einsum_capacities(8) == (2, 2)
    assert [PT.einsum_capacities(4, r, 2) for r in range(2)] == [(2, 0),
                                                                (0, 2)]
    assert [PT.einsum_capacities(2, r, 4) for r in range(4)] == [
        (2, 0), (0, 0), (0, 0), (0, 2)]
    assert [PT.einsum_capacities(1, r, 8) for r in range(8)] == [
        (1, 0)] * 2 + [(0, 0)] * 4 + [(0, 1)] * 2


def test_einsum_rank_without_blurred_rows_skips_the_blur(monkeypatch):
    """A rank whose share holds none of the global blurred suffix (rank 0
    of 2: capacities (2, 0)) does not blur at all: the same images and
    labels as the capacity-0 call, which blurs every flagged row, when no
    row of its share is flagged; no blur computed."""
    from cervical_tpu_torch.config import SegDataConfig, SegTrainConfig
    from cervical_tpu_torch.ops import augment as A
    from cervical_tpu_torch.ops import warp_xla as WX
    from cervical_tpu_torch.parallel.mesh import Axis

    rng = np.random.default_rng(9)
    imgs = torch.from_numpy(rng.integers(0, 256, (4, 48, 48, 3)
                                         ).astype(np.uint8))
    lbls = torch.from_numpy(rng.integers(0, 5, (4, 48, 48)).astype(np.uint8))
    params = A.sample_augment_params(torch.Generator().manual_seed(2), 4,
                                     rotate_prefix=2, blur_suffix=0)
    assert not bool(params["blur"].any())
    calls = []
    blur = WX.gaussian_blur_einsum
    monkeypatch.setattr(WX, "gaussian_blur_einsum",
                        lambda x: calls.append(x.shape[0]) or blur(x))
    want = WX.augment_batch_einsum(imgs, lbls, params, (32, 32),
                                   rotate_capacity=2, blur_capacity=0)
    assert calls == [4]
    cfg = SegTrainConfig(data=SegDataConfig(input_shape=(32, 32)))
    got = PT.make_train_aug_fn(cfg, Axis(None, 0, 2))(imgs, lbls, params)
    assert calls == [4]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_fused_middle_eval_refuses_a_data_mesh():
    """``fused_middle_eval`` under a mesh of more than one device raises
    the JAX package's message."""
    from cervical_tpu_torch.config import SegTrainConfig

    class Mesh:
        def size(self):
            return 2
    with pytest.raises(ValueError, match="fused_middle_eval requires a "
                       "single-device mesh"):
        PT.SegTrainer(SegTrainConfig(fused_middle_eval=True), device="cpu",
                      mesh=Mesh())
    with pytest.raises(ValueError, match="num_devices=2 differs"):
        PT.SegTrainer(SegTrainConfig(num_devices=2), device="cpu")
