"""K-step calls of the port's trainer (``steps_per_call``), on the CPU where
they run eagerly (on the card the same functions are captured as CUDA
graphs: ``tests/test_torch_port_cuda.py``, ``chip_smoke.py``):

* a K-step call equals K single steps bit for bit (the JAX package's
  ``test_train_step_scan_matches_sequential`` holds its scan to limits,
  since XLA compiles the two differently; here the operations are the
  same);
* ``run_epoch`` with ``steps_per_call=2`` and an odd batch count runs every
  batch once (``test_run_epoch_steps_per_call``);
* ``aug_pre_batch`` with the kernel backend equals the per-step call bit
  for bit (``test_scan_prebatch_aug_matches_per_step``), and with the
  einsum backend every train-step factory raises;
* one einsum-backend train step against the JAX package's
  ``_make_train_body(aug_backend="einsum")``, f32, dropout off, at 64²;
* the Nesterov SGD step with a tensor LR (what the card's graphs capture)
  against torch's float-LR step and the JAX package's optax chain.
"""

import dataclasses

import flax.linen
import optax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cervical_tpu.config import SegDataConfig as JData
from cervical_tpu.config import SegTrainConfig as JCfg
from cervical_tpu.train import seg_trainer as JT
from cervical_tpu_torch.config import SegDataConfig, SegTrainConfig
from cervical_tpu_torch.data.voc import ArraySegDataset, BatchLoader
from cervical_tpu_torch.models.deeplab import DeepLab
from cervical_tpu_torch.ops import augment as A
from cervical_tpu_torch.train import seg_trainer as PT

from test_torch_port_train_step import (F32_TOL, _NoDropout, _port_state,
                                        _report, step_errors)
from torch_port_helpers import (random_state, to_flax,
                                two_torch_threads)  # noqa: F401

S, B, LR = 32, 4, 1e-3


def _cfg(**kw):
    data = {k: kw.pop(k) for k in ("aug_backend", "aug_pre_batch")
            if k in kw}
    return SegTrainConfig(data=SegDataConfig(input_shape=(S, S), **data),
                          dtype="float32", **kw)


def _batches(seed, k):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (k, B, S, S, 3),
                                          dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 5, (k, B, S, S),
                                          dtype=np.uint8)))


def _same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(v, sb[k]) for k, v in sa.items())
    for g in ("backbone", "head"):
        xa, xb = (o.state_dict()["state"] for o in (a.opt_state[g],
                                                     b.opt_state[g]))
        assert xa.keys() == xb.keys(), g
        for i in xa:
            for k, v in xa[i].items():
                assert torch.equal(torch.as_tensor(v),
                                   torch.as_tensor(xb[i][k])), (g, i, k)
    assert a.step == b.step


def _k_call_against_steps(cfg, frozen, seed, k=2):
    """A K-step call and K single steps from two trainers of one seed, on
    the same batches: (K-step metrics, stacked single-step metrics, the two
    trainers)."""
    images, labels = _batches(seed, k)
    tk, ts = PT.SegTrainer(cfg, device="cpu"), PT.SegTrainer(cfg,
                                                             device="cpu")
    got = tk.train_steps(images, labels, frozen, LR)
    one = [ts.train_step(images[i], labels[i], frozen, LR) for i in range(k)]
    want = {n: torch.stack([m[n] for m in one]) for n in got}
    return got, want, tk, ts


@pytest.mark.parametrize("frozen", [False, True], ids=["unfrozen", "frozen"])
def test_k_step_call_equals_single_steps(frozen):
    got, want, tk, ts = _k_call_against_steps(_cfg(), frozen, 21)
    for n in ("loss", "main_loss", "f_score"):
        assert got[n].shape == (2,) and torch.equal(got[n], want[n]), n
    _same_state(tk.state, ts.state)
    assert tk.state.step == 2


def test_run_epoch_steps_per_call_runs_every_batch_once():
    """5 batches with K=2: two 2-step calls and one single step."""
    rng = np.random.default_rng(22)
    ds = ArraySegDataset(rng.integers(0, 256, (21, S, S, 3)),
                         rng.integers(0, 5, (21, S, S)))
    tr = PT.SegTrainer(_cfg(steps_per_call=2, pipeline_depth=2),
                       device="cpu")
    calls = {"k": 0, "one": 0}
    k_call, one = tr.train_steps, tr.train_step

    def count_k(*a):
        calls["k"] += 1
        return k_call(*a)

    def count_one(*a):
        calls["one"] += 1
        return one(*a)
    tr.train_steps, tr.train_step = count_k, count_one
    res = tr.run_epoch(BatchLoader(ds, B, seed=0),
                       BatchLoader(ds, B, shuffle=False, drop_last=False),
                       0, False, LR)
    assert tr.state.step == 5 and calls == {"k": 2, "one": 1}
    assert np.isfinite(res.train_loss) and np.isfinite(res.val_loss)


def test_pre_batched_kernel_augmentation_equals_per_step():
    """``aug_pre_batch`` (the kernel backend's plain versions here):
    the K sub-batches augmented as one batch, then K steps, against K
    per-step steps."""
    cfg = _cfg(aug_backend="pallas")
    images, labels = _batches(23, 2)
    pre = PT.SegTrainer(dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, aug_pre_batch=True)),
        device="cpu")
    per = PT.SegTrainer(cfg, device="cpu")
    got = pre.train_steps(images, labels, False, LR)
    want = per.train_steps(images, labels, False, LR)
    for n in got:
        assert torch.equal(got[n], want[n]), n
    _same_state(pre.state, per.state)


@pytest.mark.parametrize("factory", ["step", "scan", "scan_resident"])
def test_pre_batch_with_einsum_raises(factory):
    cfg = _cfg(aug_pre_batch=True)
    make = {"step": lambda: PT.make_train_step(cfg, False),
            "scan": lambda: PT.make_train_step_scan(cfg, False, 2),
            "scan_resident": lambda: PT.make_train_step_scan_resident(
                cfg, False, 2, B)}[factory]
    with pytest.raises(ValueError, match="aug_pre_batch requires"):
        make()


def test_einsum_train_step_matches_jax_f32():
    """One unfrozen f32 step with the einsum augmentation, from one set of
    weights, batch and JAX-sampled parameters, against the JAX package's
    step: the limits of ``test_train_step_matches_jax_f32``."""
    hw, b = (64, 64), 8
    mp = pytest.MonkeyPatch()
    mp.setattr(flax.linen, "Dropout", _NoDropout)
    try:
        state = random_state(DeepLab(num_classes=5), seed=71)
        params, stats = to_flax(state)
        rng = np.random.default_rng(72)
        images = rng.integers(0, 256, (b,) + hw + (3,)).astype(np.uint8)
        labels = rng.integers(0, 6, (b,) + hw).astype(np.uint8)
        jcfg = JCfg(data=JData(input_shape=hw, aug_backend="einsum"),
                    dtype="float32")
        aug = JT._sample_step_aug_params(jcfg, jax.random.PRNGKey(73), b)
        aug = {k: np.asarray(v) for k, v in aug.items()}
        model, tx = JT.build_model(jcfg), JT.make_optimizer(jcfg)
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        bp, hp = JT._split_params(jp)
        s0 = JT.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                           batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                              stats),
                           opt_state={"backbone": tx.init(bp),
                                      "head": tx.init(hp)})
        s1, m = jax.jit(JT._make_train_body(jcfg, model, tx, False))(
            s0, jnp.asarray(images), jnp.asarray(labels),
            {k: jnp.asarray(v) for k, v in aug.items()}, jnp.float32(1e-4),
            jax.random.PRNGKey(74))
    finally:
        mp.undo()
    pcfg = SegTrainConfig(data=SegDataConfig(input_shape=hw), dtype="float32",
                          weights_init="none")
    st = _port_state(pcfg, params, stats)
    before = {k: v.clone() for k, v in st.model.state_dict().items()}
    got = PT.make_train_step(pcfg, False)(
        st, torch.from_numpy(images), torch.from_numpy(labels),
        {k: torch.from_numpy(v.copy()) for k, v in aug.items()}, 1e-4)
    err = step_errors(st, got, before, s1, m)
    _report("einsum f32 step", err)
    for k in ("loss", "main_loss", "f_score", "stats", "moments_l2",
              "update_sign"):
        assert err[k] <= F32_TOL[k], (k, err)


def test_param_rows_follow_the_step_sampler():
    """K steps' rows are the single-step sampler's draws in step order."""
    cfg = _cfg()
    tr = PT.SegTrainer(cfg, device="cpu")
    rows = tr._param_rows(3, B)
    g = torch.Generator().manual_seed(cfg.seed + 1)
    for i in range(3):
        want = A.params_to_rows(PT._sample_step_aug_params(cfg, g, B))
        assert torch.equal(rows[i], want)


@pytest.mark.parametrize("weight_decay", [0.0, 5e-4])
def test_nesterov_sgd_tensor_lr_matches_float_lr_and_optax(weight_decay):
    """The SGD step as the card takes it (LR a 0-dim tensor, the form a CUDA
    graph captures) against torch's SGD with a float LR, and both against
    the JAX package's optax chain, over steps at three LRs on the same
    gradients: the params within 2**-22, two f32 steps at their size (below
    2; measured: 1.2e-7 against the float LR, 7.5e-9 against optax), the
    momentum equal."""
    rng = np.random.default_rng(41)
    shapes = [(3, 5), (7,), (2, 3, 4)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    lrs = (1e-2, 7e-3, 3e-3)
    cfg = SegTrainConfig(optimizer_type="sgd", weight_decay=weight_decay)

    def run(tensor_lr):
        ps = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in init]
        opt = PT.make_optimizer(cfg, ps)
        assert isinstance(opt, PT.NesterovSGD)
        for gs, lr in zip(grads, lrs):
            for p, g in zip(ps, gs):
                p.grad = torch.from_numpy(g.copy())
            for pg in opt.param_groups:
                pg["lr"] = torch.tensor(lr) if tensor_lr else lr
            opt.step()
        return ([p.detach().numpy() for p in ps],
                [opt.state[p]["momentum_buffer"].numpy() for p in ps])

    tensor_p, tensor_m = run(True)
    float_p, float_m = run(False)
    jopt = JT.make_optimizer(JCfg(optimizer_type="sgd",
                                  weight_decay=weight_decay))
    jp = [jnp.asarray(x) for x in init]
    st = jopt.init(jp)
    for gs, lr in zip(grads, lrs):
        st.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        upd, st = jopt.update([jnp.asarray(g) for g in gs], st, jp)
        jp = optax.apply_updates(jp, upd)
    for a, b, c in zip(tensor_p, float_p, jp):
        assert np.abs(a).max() < 2
        np.testing.assert_allclose(a, b, rtol=0, atol=2.0 ** -22)
        np.testing.assert_allclose(a, np.asarray(c), rtol=0, atol=2.0 ** -22)
    for a, b in zip(tensor_m, float_m):
        np.testing.assert_array_equal(a, b)
