"""Checkpoints and weights against the JAX package at 32², xception,
float32 on the CPU: the checkpoint policy and its bit-exact round trip, a
resumed run against an uninterrupted one, loading ``pretrained`` weights
against JAX's ``load_pretrained``, and the small host helpers of the
training CLI.

A checkpoint of the full-width model is ~0.65 GB (params and both Adam
states), so each test deletes its checkpoints when done.
"""

import os
import shutil

import numpy as np
import pytest
import torch
import jax

from cervical_tpu import config as JC
from cervical_tpu.train import checkpoints as JCK
from cervical_tpu.train import seg_trainer as JST
from cervical_tpu_torch.config import SegTrainConfig, load_config
from cervical_tpu_torch.data.voc import ArraySegDataset
from cervical_tpu_torch.train.checkpoints import CheckpointManager
from cervical_tpu_torch.train.seg_trainer import (SegTrainer, TrainState,
                                                  make_optimizer)

from torch_port_helpers import (fit_overrides, random_state, tiny_jax_state,
                                to_flax, two_torch_threads)  # noqa: F401

S = 32


def _cfg(tmp_path, **kw):
    """No dataset is read: the trainer steps on batches made here."""
    return load_config(SegTrainConfig, None,
                       fit_overrides("", str(tmp_path / "logs"), S, **kw))


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (b, S, S, 3), dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 5, (b, S, S), dtype=np.uint8)))


def _small_state(cfg, seed):
    """A ``TrainState`` of a small conv + BatchNorm net, seeded, with an
    Adam for each group after one training step (moments, counts and
    running stats all set): the checkpoint format does not depend on the
    model, and a full-width checkpoint is 0.65 GB."""
    g = torch.Generator().manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3),
                                torch.nn.BatchNorm2d(4))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    opts = {"backbone": make_optimizer(cfg, list(model[0].parameters())),
            "head": make_optimizer(cfg, list(model[1].parameters()))}
    model(torch.randn(2, 3, 6, 6, generator=g)).square().mean().backward()
    for opt in opts.values():
        opt.param_groups[0]["lr"] = 1e-3
        opt.step()
    return TrainState(model, opts, step=1)


def _assert_states_equal(a, b):
    """Model (params and BN stats), both optimizers' states and the step,
    bit for bit."""
    sb = b.model.state_dict()
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, sb[k]), k
    for g in ("backbone", "head"):
        x, y = a.opt_state[g].state_dict(), b.opt_state[g].state_dict()
        assert x["state"].keys() == y["state"].keys(), g
        for i, st in x["state"].items():
            for k, v in st.items():
                assert torch.equal(torch.as_tensor(v),
                                   torch.as_tensor(y["state"][i][k])), (g, i, k)
    assert a.step == b.step


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_policy_matches_jax_and_restores_bit_exact(tmp_path):
    """The counterpart of ``test_checkpoint_roundtrip``: the same file
    names as the JAX manager over two epochs (periodic name format, best
    only on improvement, last always), the best's metadata, and a restore
    into a state made with another seed equal bit for bit (params, BN
    stats, both Adam states, step, extra)."""
    cfg = _cfg(tmp_path)
    state = _small_state(cfg, 0)
    mgr = CheckpointManager(cfg.save_dir, save_period=1)
    jmgr = JCK.CheckpointManager(str(tmp_path / "jax"), save_period=1)
    jstate = tiny_jax_state()
    for epoch, loss, val in ((0, 1.0, 2.0), (1, 1.25, 3.0)):
        got = mgr.on_epoch_end(epoch, state, loss, val, 2)
        want = jmgr.on_epoch_end(epoch, jstate, loss, val, 2)
        assert [os.path.basename(p) for p in got] == \
            [os.path.basename(p) for p in want]
    assert sorted(os.listdir(cfg.save_dir)) == [
        "best_epoch_weights", "ep001-loss1.000-val_loss2.000",
        "ep002-loss1.250-val_loss3.000", "last_epoch_weights"]
    jbest = jmgr.restore("best_epoch_weights")["extra"]
    assert mgr.restore("best_epoch_weights")["extra"] == \
        {"epoch": int(jbest["epoch"]), "val_loss": float(jbest["val_loss"])}

    fresh = _small_state(cfg, 5)
    restored, extra = mgr.restore("last_epoch_weights", fresh)
    assert extra == {"epoch": 1, "val_loss": 3.0}
    assert restored is fresh and restored.step == 1
    _assert_states_equal(state, restored)


def test_resume_reproduces_the_trajectory(tmp_path):
    """The counterpart of ``tests/test_resume.py`` on the full-width model:
    4 steps with a checkpoint after step 2, and a restore of it into a
    fresh trainer made with another seed followed by steps 3-4, give the
    same losses, params, BN stats and Adam moments (rtol 1e-6; they are
    equal).  Both runs get the same augmentation parameters, and the
    dropout generators restart from their seeds before steps 3-4 in both
    (a checkpoint carries no generator state, as the JAX package's carries
    no PRNG key)."""
    from cervical_tpu_torch.models.deeplab import Dropout
    from cervical_tpu_torch.train.seg_trainer import _sample_step_aug_params

    cfg = _cfg(tmp_path)
    g = torch.Generator().manual_seed(7)
    params = [_sample_step_aug_params(cfg, g, 2) for _ in range(4)]
    batches = [_batch(10 + i) for i in range(4)]

    def run(trainer, steps):
        fn = trainer._train_step(False)
        return [fn(trainer.state, *batches[i], params[i], 1e-3)["loss"].item()
                for i in steps]

    def reseed_dropouts(trainer):
        for m in trainer.state.model.modules():
            if isinstance(m, Dropout):
                m._gen = None

    full = SegTrainer(cfg, device="cpu")
    run(full, [0, 1])
    mgr = CheckpointManager(cfg.save_dir, save_period=10)
    mgr.on_epoch_end(0, full.state, 1.0, 1.0)
    reseed_dropouts(full)
    l_full = run(full, [2, 3])

    resumed = SegTrainer(cfg, seed=9, device="cpu")
    mgr.restore("last_epoch_weights", resumed.state)
    shutil.rmtree(cfg.save_dir)
    reseed_dropouts(resumed)
    l_resumed = run(resumed, [2, 3])

    np.testing.assert_allclose(l_resumed, l_full, rtol=1e-6)
    sr = resumed.state.model.state_dict()
    for k, v in full.state.model.state_dict().items():
        np.testing.assert_allclose(sr[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    for grp in ("backbone", "head"):
        a = full.state.opt_state[grp].state_dict()["state"]
        b = resumed.state.opt_state[grp].state_dict()["state"]
        assert a.keys() == b.keys() and len(a) > 0
        for i in a:
            for k in ("exp_avg", "exp_avg_sq", "step"):
                np.testing.assert_allclose(b[i][k].numpy(), a[i][k].numpy(),
                                           rtol=1e-6, atol=1e-7)
    assert resumed.state.step == full.state.step == 4


# ---------------------------------------------------------------------------
# pretrained weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["whole", "backbone_reshaped"])
def test_load_pretrained_matches_jax(tmp_path, kind):
    """A port ``state_dict`` saved whole, or backbone-only with one tensor
    of another shape, loaded over the same starting weights by JAX's
    ``load_pretrained`` and by the port's: the same log line (arrays loaded
    and skipped) and the same resulting weights, compared through
    ``to_flax``."""
    from cervical_tpu_torch.models.deeplab import DeepLab
    from cervical_tpu_torch.train.seg_trainer import load_pretrained

    model = DeepLab(num_classes=5)
    start, ckpt = random_state(model, 1), random_state(model, 2)
    if kind == "whole":
        sd = ckpt
    else:
        sd = {k[len("backbone."):]: v for k, v in ckpt.items()
              if k.startswith("backbone.")}
        sd["conv2.weight"] = torch.zeros(64, 32, 5, 5)
    path = str(tmp_path / "weights.pth")
    torch.save(sd, path)
    cfg = SegTrainConfig(pretrained=path)
    jcfg = JC.SegTrainConfig(pretrained=path)

    params, stats = to_flax(start)
    logs = []
    jvars = JST.load_pretrained(jcfg, {"params": params,
                                       "batch_stats": stats}, log=logs.append)
    model.load_state_dict(start)
    load_pretrained(cfg, model, log=logs.append)
    assert logs[0] == logs[1], logs
    assert ("skipped 1 shape mismatches" in logs[0]) == (kind != "whole")
    got_p, got_s = to_flax(model.state_dict())
    for want, got in ((jvars["params"], got_p), (jvars["batch_stats"], got_s)):
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat_w) == len(flat_g)
        for p, w in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[p]),
                                          np.asarray(w), err_msg=str(p))


def test_create_state_loads_pretrained_instead_of_the_init(tmp_path):
    """With ``pretrained`` set, ``create_state`` loads it and skips the
    seeded reference init (as JAX's does)."""
    from cervical_tpu_torch.models.deeplab import DeepLab
    from cervical_tpu_torch.train.seg_trainer import create_state
    sd = random_state(DeepLab(num_classes=5), 4)
    path = str(tmp_path / "whole.pth")
    torch.save({"state_dict": sd}, path)
    state = create_state(SegTrainConfig(pretrained=path), device="cpu")
    got = state.model.state_dict()
    for k, v in sd.items():
        if v.dtype.is_floating_point:
            assert torch.equal(got[k], v), k


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------

def test_host_helpers_match_jax():
    """``cvt_rgb`` against JAX's on grey, RGBA and RGB images;
    ``ArraySegDataset.paths`` raises as JAX's does; ``seed_everything``
    repeats Python's, numpy's and torch's draws."""
    import random
    from PIL import Image
    from cervical_tpu.data import voc as JV
    from cervical_tpu_torch.data.voc import cvt_rgb
    from cervical_tpu_torch.utils import seed_everything
    rng = np.random.default_rng(0)
    for mode, shape in (("L", (5, 6)), ("RGBA", (5, 6, 4)), ("RGB", (5, 6, 3))):
        img = Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode)
        got, want = cvt_rgb(img), JV.cvt_rgb(img)
        assert got.mode == want.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    ds = ArraySegDataset(np.zeros((2, 4, 4, 3)), np.zeros((2, 4, 4)))
    jds = JV.ArraySegDataset(np.zeros((2, 4, 4, 3)), np.zeros((2, 4, 4)))
    for d in (ds, jds):
        with pytest.raises(NotImplementedError, match="no backing files"):
            d.paths(0)

    def draws():
        return (random.random(), float(np.random.rand()),
                float(torch.rand(())))
    seed_everything(3)
    a = draws()
    seed_everything(3)
    assert draws() == a and os.environ["PYTHONHASHSEED"] == "3"
