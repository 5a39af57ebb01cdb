"""The port's fusion training against the JAX package: the fusion losses,
one step's loss and gradients against ``jax.value_and_grad``, K train
steps against JAX's ``train_step_fn`` (the epoch-0 no-step, a weight-0
padded tail), the epoch, the splits and metrics, and the CV loop (resume
equal to an uninterrupted run, the graceful stop, its files).

Dropout is off on both sides where steps are compared: flax's ``Dropout``
is identity inside those tests, the port's dropouts get ``p = 0``; the MAE
masks are given explicitly.  Limits (``pytest -s`` prints the readings):

* the loss of one step to 1e-5 relative; each gradient tensor to 1e-4 of
  its largest entry, that scale floored at 1e-3 of the largest entry of
  all (the gates' last biases have a zero gradient).  Readings: loss
  1.1e-7, gradients 2.5e-5 / 3.5e-5 (all rows / a weight-0 tail);
* after K = 4 steps at lr 1e-3 (3 of them Adam steps), each parameter
  entry within its own bound (``_adam_bounds``): 1e-5 plus, per step, how
  far Adam moves an entry for the gradient difference the two sides took
  the step on; the gates' last biases, whose gradient is rounding noise,
  2 lr per step.  99.92% of the other entries get a bound of at most 2e-5.
  Their losses to 1e-4 relative; each Adam moment to 1e-3 of its largest
  entry, floored as the gradients are; the counts equal.  Readings: losses
  7.3e-6, largest error over its bound 0.47, moments 2.7e-4 / 3.7e-4.  One
  step from a JAX state carried over: the same bound for one step, reading
  0.012.
"""

import dataclasses
import json
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cervical_tpu import losses as JLoss
from cervical_tpu import metrics as JMet
from cervical_tpu.config import FusionTrainConfig as JCfg
from cervical_tpu.data import splits as JS
from cervical_tpu.data.fusion_data import make_synthetic_fusion as j_synth
from cervical_tpu.train.fusion_trainer import FusionTrainer as JTrainer
from cervical_tpu.train.fusion_trainer import head_weights as j_head_weights
from cervical_tpu_torch import losses as PLoss
from cervical_tpu_torch import metrics as PMet
from cervical_tpu_torch.config import FusionTrainConfig, load_config
from cervical_tpu_torch.data import splits as PS
from cervical_tpu_torch.data.fusion_data import make_synthetic_fusion
from cervical_tpu_torch.train import fusion_trainer as PT
from cervical_tpu_torch.train.flax_import import (flatten_params,
                                                  fusion_from_flax,
                                                  fusion_to_flax,
                                                  load_adam_state)

from torch_port_helpers import fusion_feats, two_torch_threads  # noqa: F401

MODS = ("imgN", "imgA", "imgL", "cli")
IN, HID, B, LR = 32, 64, 8, 1e-3


class _NoDropout(flax.linen.Module):
    rate: float

    @flax.linen.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


def _cfgs(**kw):
    base = dict(in_features=IN, hidden=HID, batch_size=B, lr=LR)
    base.update(kw)
    return JCfg(**base), FusionTrainConfig(**base)


def _port_state(ptr, params, no_dropout=True):
    st = ptr.init_state()
    st.model.load_state_dict(fusion_from_flax(params), strict=True)
    if no_dropout:
        for m in st.model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
    return st


def _batch(seed, n=B):
    rng = np.random.default_rng(seed)
    feats = fusion_feats(MODS, n, seed)
    labels = rng.integers(0, 4, n).astype(np.int32)
    u = rng.random((n, 4))
    mask = np.argsort(np.argsort(u, 1), 1) < 3  # T-1 hidden per row
    return feats, labels, mask


def _rel_max(ref, got, floor=1e-30):
    """Max |ref - got| over the larger of max |ref| and ``floor``."""
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), floor))


# -- losses.py (the fusion half) -------------------------------------------------

def test_fusion_losses_match_jax():
    rng = np.random.default_rng(0)
    logits = {k: rng.normal(size=(6, 4)).astype(np.float32)
              for k in ("all", *MODS)}
    labels = rng.integers(0, 4, 6).astype(np.int32)
    w = np.array([1, 1, 0, 1, 0.5, 0], np.float32)
    out = rng.normal(size=(6, 4, 16)).astype(np.float32)
    tgt = rng.normal(size=(6, 4, 16)).astype(np.float32)
    mask = rng.random((6, 4)) > 0.4
    for weights in (None, w):
        ref = JLoss.softmax_cross_entropy(
            jnp.asarray(logits["all"]), jnp.asarray(labels),
            None if weights is None else jnp.asarray(weights))
        got = PLoss.softmax_cross_entropy(
            torch.from_numpy(logits["all"]), torch.from_numpy(labels),
            None if weights is None else torch.from_numpy(weights))
        assert abs(float(ref) - float(got)) < 1e-6
    ref = JLoss.masked_mae_mse(jnp.asarray(out), jnp.asarray(tgt),
                               jnp.asarray(mask))
    got = PLoss.masked_mae_mse(torch.from_numpy(out), torch.from_numpy(tgt),
                               torch.from_numpy(mask))
    assert abs(float(ref) - float(got)) < 1e-6
    hw = {"all": 1.0, "imgN": 0.3, "imgA": 0.25, "imgL": 0.3, "cli": 0.2}
    rt, rp = JLoss.fusion_multihead_loss(
        {k: jnp.asarray(v) for k, v in logits.items()}, jnp.asarray(labels),
        hw, jnp.asarray(0.7), mse_factor=5.0, num_micro_batches=2,
        sample_weights=jnp.asarray(w))
    gt, gp = PLoss.fusion_multihead_loss(
        {k: torch.from_numpy(v) for k, v in logits.items()},
        torch.from_numpy(labels), hw, torch.tensor(0.7), mse_factor=5.0,
        num_micro_batches=2, sample_weights=torch.from_numpy(w))
    assert abs(float(rt) - float(gt)) < 1e-5
    assert set(rp) == set(gp)
    for k in rp:
        assert abs(float(rp[k]) - float(gp[k])) < 1e-6, k


def test_config_and_arity_defaults_match_jax():
    for mods in (MODS, ("imgN", "imgA", "imgL"), ("imgN", "cli")):
        for explicit in (set(), {"kfold", "weight_decay"}):
            j = JCfg(modalities=mods, kfold=7, weight_decay=0.5)
            p = FusionTrainConfig(modalities=mods, kfold=7, weight_decay=0.5)
            j.arity_defaults(explicit), p.arity_defaults(explicit)
            assert dataclasses.asdict(j) == dataclasses.asdict(p)
    explicit = set()
    cfg = load_config(FusionTrainConfig, None, {"kfold": 3, "lr": 0.1},
                      explicit_out=explicit)
    assert explicit == {"kfold", "lr"} and cfg.kfold == 3
    assert dataclasses.asdict(FusionTrainConfig()) == dataclasses.asdict(JCfg())
    assert PT.head_weights(FusionTrainConfig()) == j_head_weights(JCfg())


def test_unported_options_raise():
    """A mesh that is no ``DeviceMesh`` (``parallel.make_mesh``'s) and an
    unknown dtype raise; the tensor-parallel mesh itself is held against
    JAX's in ``test_torch_port_parallel_fusion.py``."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        PT.FusionTrainer(FusionTrainConfig(), device="cpu", mesh=object())
    with pytest.raises(ValueError, match="unknown dtype"):
        PT.FusionTrainer(FusionTrainConfig(dtype="float16"), device="cpu")


# -- one step: loss and gradients --------------------------------------------------

def _jax_loss_and_grads(jtr, params, feats, labels, mask, weights):
    """The loss of JAX's train step (``train_step_fn``'s ``loss_fn``) and
    its gradients, by ``jax.value_and_grad``."""
    cfg = jtr.cfg
    hw = j_head_weights(cfg)

    def loss_fn(p):
        out = jtr.model.apply({"params": p}, feats, mae_mask=mask,
                              deterministic=False,
                              rngs={"dropout": jax.random.PRNGKey(0)})
        per = jax.vmap(JLoss.masked_mae_mse)(out["mae_out"],
                                             out["mae_labels"], mask)
        mse = (cfg.mse_loss_of_mae_factor * jnp.sum(per * weights)
               / jnp.maximum(jnp.sum(weights), 1.0))
        total, _ = JLoss.fusion_multihead_loss(
            out["logits"], labels, hw, mse, mse_factor=5.0,
            num_micro_batches=1, sample_weights=weights)
        return total

    return jax.value_and_grad(loss_fn)(params)


@pytest.mark.parametrize("ragged", [False, True])
def test_step_loss_and_gradients_match_jax(ragged):
    jcfg, pcfg = _cfgs()
    feats, labels, mask = _batch(1)
    w = np.ones(B, np.float32)
    if ragged:
        w[5:] = 0.0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        jtr = JTrainer(jcfg)
        params = jtr.init_state({m: v[:1] for m, v in feats.items()},
                                jax.random.PRNGKey(2))["params"]
        params = jax.tree_util.tree_map(np.asarray, params)
        loss, grads = _jax_loss_and_grads(
            jtr, params, {m: jnp.asarray(v) for m, v in feats.items()},
            jnp.asarray(labels), jnp.asarray(mask), jnp.asarray(w))
    ptr = PT.FusionTrainer(pcfg, device="cpu")
    st = _port_state(ptr, params)
    m = ptr.train_step_fn()(
        st, {k: torch.from_numpy(v) for k, v in feats.items()},
        torch.from_numpy(labels), torch.from_numpy(mask),
        torch.from_numpy(w), LR, False)  # do_step False: grads stay
    rel = abs(float(m["loss"]) - float(loss)) / abs(float(loss))
    pg = flatten_params(fusion_to_flax(
        {n: p.grad for n, p in st.model.named_parameters()}))
    jg = flatten_params(jax.tree_util.tree_map(np.asarray, grads))
    assert set(pg) == set(jg)
    # the gates' last bias has a zero gradient (a softmax over nodes is
    # shift-invariant): both sides hold rounding noise (~1e-13) there, so a
    # tensor's scale is floored at 1e-3 of the largest gradient entry
    floor = 1e-3 * max(float(np.abs(v).max()) for v in jg.values())
    worst = max(_rel_max(jg[k], pg[k], floor) for k in jg)
    print("step loss rel", rel, "gradient rel", worst)
    assert rel < 1e-5
    assert worst < 1e-4


# -- K steps against JAX's train_step_fn -----------------------------------------------

_NOISE_LEAF = "gate_fc2/bias"  # the gates' last biases: zero true gradient


def _port_grads(st):
    """The port's gradients after a step, in the flat flax layout."""
    return flatten_params(fusion_to_flax(
        {n: p.grad for n, p in st.model.named_parameters()}))


def _adam_bounds(jtr, steps):
    """Per parameter entry, how far the port's Adam steps may drift from
    JAX's, given the gradients each side took them on.  ``steps``: (JAX
    params before the step, batch, weights, JAX state after the step, the
    port's gradients of the step) per Adam step.

    The first step's gradients, taken at equal params, are held to the
    one-step limit of ``test_step_loss_and_gradients_match_jax`` (each
    tensor to 1e-4 of its largest entry, floored at 1e-3 of the largest
    entry of all); later ones differ also because the params have; d is
    each entry's largest gradient difference so far.  An Adam step is
    lr * m / sqrt(v): a gradient difference d moves m by at most d and
    sqrt(v) by at most d, so the step by at most ~2 lr d / sqrt(v), and
    never by more than 2 lr (a sign flip).  The bound is 1e-5 plus the sum
    over steps of lr * min(2, 2 d / sqrt(v)), v JAX's bias-corrected second
    moment after the step: ~1e-5 wherever the gradients agree well.

    The gates' last biases are named: their true gradient is 0 (a softmax
    over nodes is shift-invariant), so both sides hold rounding noise there
    (checked: at most 1e-7 of the largest gradient entry), which Adam scales
    to steps of up to ~lr either way; they get 2 lr per step."""
    bound, diff = {}, {}
    for params, (feats, labels, mask), w, after, pg in steps:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(flax.linen, "Dropout", _NoDropout)
            _, grads = _jax_loss_and_grads(
                jtr, params, {m: jnp.asarray(v) for m, v in feats.items()},
                jnp.asarray(labels), jnp.asarray(mask), jnp.asarray(w))
        jg = flatten_params(jax.tree_util.tree_map(np.asarray, grads))
        assert set(jg) == set(pg)
        if not diff:
            floor = 1e-3 * max(float(np.abs(v).max()) for v in jg.values())
            assert max(_rel_max(jg[k], pg[k], floor) for k in jg) < 1e-4
        adam = after["opt_state"].inner_state[1]
        nu = flatten_params(jax.tree_util.tree_map(np.asarray, adam.nu))
        corr = 1.0 - 0.999 ** int(adam.count)
        top = max(float(np.abs(v).max()) for v in jg.values())
        for k in jg:
            if k.endswith(_NOISE_LEAF):
                assert float(np.abs(jg[k]).max()) <= 1e-7 * top, k
                bound[k] = bound.get(k, 0.0) + 2.0 * LR
                continue
            d = np.abs(jg[k].astype(np.float64) - pg[k])
            diff[k] = np.maximum(diff.get(k, d), d)
            root = np.sqrt(nu[k].astype(np.float64) / corr)
            bound[k] = bound.get(k, 0.0) + LR * np.minimum(
                2.0, 2.0 * diff[k] / np.maximum(root, 1e-30))
    return {k: 1e-5 + v for k, v in bound.items()}


def _param_excess(ref, got, bound):
    """Max over entries of |ref - got| / bound (<= 1: within bound)."""
    assert set(ref) == set(got) == set(bound)
    return max(float((np.abs(np.asarray(ref[k], np.float64) - got[k])
                      / bound[k]).max()) for k in ref)


def test_k_train_steps_match_jax_train_step_fn():
    """Step 0 with do_step False (the epoch-0 quirk: nothing moves, Adam's
    count stays 0), steps 1-3 with Adam, the last on a batch whose last 3
    rows carry weight 0."""
    jcfg, pcfg = _cfgs()
    batches = [_batch(10 + k) for k in range(4)]
    weights = [np.ones(B, np.float32) for _ in range(4)]
    weights[3][5:] = 0.0
    do_steps = [False, True, True, True]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        jtr = JTrainer(jcfg)
        jstate = jtr.init_state({m: v[:1] for m, v in batches[0][0].items()},
                                jax.random.PRNGKey(3))
        params0 = jax.tree_util.tree_map(np.asarray, jstate["params"])
        step = jtr.train_step_fn()
        jloss, adam_steps = [], []
        for (feats, labels, mask), w, ds in zip(batches, weights, do_steps):
            before = jax.tree_util.tree_map(np.asarray, jstate["params"])
            jstate, jm = step(jstate, {m: jnp.asarray(v)
                                       for m, v in feats.items()},
                              jnp.asarray(labels), jnp.asarray(mask),
                              jnp.asarray(LR), jnp.asarray(ds),
                              jax.random.PRNGKey(0), jnp.asarray(w))
            jloss.append(float(jm["loss"]))
            if ds:
                adam_steps.append((before, (feats, labels, mask), w, jstate))
    ptr = PT.FusionTrainer(pcfg, device="cpu")
    st = _port_state(ptr, params0)
    pstep = ptr.train_step_fn()
    ploss, pgrads = [], []
    for k, ((feats, labels, mask), w, ds) in enumerate(
            zip(batches, weights, do_steps)):
        m = pstep(st, {n: torch.from_numpy(v) for n, v in feats.items()},
                  torch.from_numpy(labels), torch.from_numpy(mask),
                  torch.from_numpy(w), LR, ds)
        ploss.append(float(m["loss"]))
        if ds:
            pgrads.append(_port_grads(st))
        if k == 0:
            # nothing moved: params equal, no Adam state, step count 0
            sd = flatten_params(fusion_to_flax(st.model.state_dict()))
            ref = flatten_params(params0)
            assert all(np.array_equal(sd[n], ref[n]) for n in ref)
            assert not st.opt_state["params"].state and st.step == 0
    assert st.step == 3
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(jloss, ploss))
    pj = flatten_params(jax.tree_util.tree_map(np.asarray,
                                               jstate["params"]))
    pp = flatten_params(fusion_to_flax(st.model.state_dict()))
    bound = _adam_bounds(jtr, [a + (g,) for a, g in zip(adam_steps, pgrads)])
    excess = _param_excess(pj, pp, bound)
    adam = jstate["opt_state"].inner_state[1]
    assert int(adam.count) == 3
    opt = st.opt_state["params"]
    names = {id(p): n for n, p in st.model.named_parameters()}
    moments = {}
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        ref = flatten_params(jax.tree_util.tree_map(np.asarray, tree))
        got = flatten_params(fusion_to_flax(
            {names[id(p)]: s[key] for p, s in opt.state.items()}))
        floor = 1e-3 * max(float(np.abs(v).max()) for v in ref.values())
        moments[key] = max(_rel_max(ref[k], got[k], floor) for k in ref)
    steps = {float(s["step"]) for s in opt.state.values()}
    print("K steps: loss rel", loss_rel, "params: largest error over its "
          "bound", excess, moments)
    assert steps == {3.0}
    assert loss_rel < 1e-4
    assert excess <= 1.0
    assert max(moments.values()) < 1e-3


def test_adam_state_carries_over_from_jax():
    """``load_adam_state`` with ``fusion_from_flax``: a JAX state after two
    steps continues in the port as it continues in JAX."""
    jcfg, pcfg = _cfgs()
    batches = [_batch(20 + k) for k in range(3)]
    w = np.ones(B, np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        jtr = JTrainer(jcfg)
        js = jtr.init_state({m: v[:1] for m, v in batches[0][0].items()},
                            jax.random.PRNGKey(4))
        step = jtr.train_step_fn()
        states = []
        for feats, labels, mask in batches:
            states.append(js)
            js, _ = step(js, {m: jnp.asarray(v) for m, v in feats.items()},
                         jnp.asarray(labels), jnp.asarray(mask),
                         jnp.asarray(LR), jnp.asarray(True),
                         jax.random.PRNGKey(0), jnp.asarray(w))
    mid = states[2]  # after two steps
    ptr = PT.FusionTrainer(pcfg, device="cpu")
    st = _port_state(ptr, jax.tree_util.tree_map(np.asarray, mid["params"]))
    adam = mid["opt_state"].inner_state[1]
    load_adam_state(st.model, st.opt_state,
                    {"params": (int(adam.count),
                                jax.tree_util.tree_map(np.asarray, adam.mu),
                                jax.tree_util.tree_map(np.asarray, adam.nu))},
                    from_flax=fusion_from_flax)
    feats, labels, mask = batches[2]
    ptr.train_step_fn()(st, {n: torch.from_numpy(v) for n, v in feats.items()},
                        torch.from_numpy(labels), torch.from_numpy(mask),
                        torch.from_numpy(w), LR, True)
    pj = flatten_params(jax.tree_util.tree_map(np.asarray, js["params"]))
    pp = flatten_params(fusion_to_flax(st.model.state_dict()))
    bound = _adam_bounds(jtr, [(jax.tree_util.tree_map(
        np.asarray, mid["params"]), batches[2], w, js, _port_grads(st))])
    excess = _param_excess(pj, pp, bound)
    print("carried-over Adam step, params: largest error over its bound",
          excess)
    assert excess <= 1.0


def test_mse_factor_knob_scales_aux_loss():
    """aux = factor * mean_mse / 5 (the literal 5 of my_train(full).py:339):
    the factor is not cancelled."""
    feats, labels, mask = _batch(30)
    losses = {}
    for factor in (5.0, 25.0):
        _, pcfg = _cfgs(mse_loss_of_mae_factor=factor)
        tr = PT.FusionTrainer(pcfg, device="cpu")
        st = tr.init_state(torch.Generator().manual_seed(0))
        m = tr.train_step_fn()(
            st, {n: torch.from_numpy(v) for n, v in feats.items()},
            torch.from_numpy(labels), torch.from_numpy(mask),
            torch.ones(B), LR, True)
        losses[factor] = float(m["loss"])
    assert losses[25.0] > losses[5.0] + 1e-6, losses


# -- the epoch ---------------------------------------------------------------------------

def _params_and_adam(st):
    model = {k: v.clone() for k, v in st.model.state_dict().items()}
    opt = {id(p): {k: v.clone() for k, v in s.items()}
           for p, s in st.opt_state["params"].state.items()}
    return model, opt


@pytest.mark.parametrize("use_scan", [True, False])
def test_epoch0_no_step_keeps_params_and_adam(use_scan):
    _, pcfg = _cfgs(epoch0_no_step=True)
    ds = make_synthetic_fusion(num_patients=13, feature_dim=IN)
    tr = PT.FusionTrainer(pcfg, device="cpu")
    st = tr.init_state()
    before, _ = _params_and_adam(st)
    rep = tr.train_epoch(st, ds, 0, 1e-3, use_scan=use_scan)
    after, opt = _params_and_adam(st)
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert not opt and st.step == 0
    assert np.isfinite(rep["loss"])
    tr.train_epoch(st, ds, 1, 1e-3, use_scan=use_scan)
    moved, _ = _params_and_adam(st)
    assert any(not torch.equal(after[k], moved[k]) for k in after)
    assert st.step == 2  # ceil(13 / 8) steps


def test_epoch_report_keys_match_jax_printout():
    _, pcfg = _cfgs(epoch0_no_step=False)
    ds = make_synthetic_fusion(num_patients=16, feature_dim=IN)
    tr = PT.FusionTrainer(pcfg, device="cpu")
    st = tr.init_state()
    rep = tr.train_epoch(st, ds, 0, pcfg.lr)
    expected = {"loss", "acc_all", "acc_imgN", "acc_imgA", "acc_imgL",
                "acc_cli", "confusion", "precision", "recall", "f1",
                "fp", "fn", "tp", "tn", "sensitivity", "specificity"}
    assert expected <= set(rep)
    assert rep["confusion"].shape == (4, 4) and rep["confusion"].sum() == 16
    pred = tr.predict(st.model.state_dict(), ds)
    assert expected <= set(pred)
    assert pred["confusion"].sum() == 16


def test_scan_epoch_equals_its_steps_padded():
    """The default epoch is its micro-batches' steps with the ragged tail
    padded by weight-0 rows: replayed by hand from the same streams, the
    states are equal."""
    _, pcfg = _cfgs(epoch0_no_step=False)
    ds = make_synthetic_fusion(num_patients=13, feature_dim=IN, seed=1)
    a = PT.FusionTrainer(pcfg, device="cpu")
    sa = a.init_state()
    a.train_epoch(sa, ds, 1, 1e-3)
    b = PT.FusionTrainer(pcfg, device="cpu")
    sb = b.init_state()
    order = torch.randperm(13, generator=b.shuffle_generator).numpy()
    order = np.concatenate([order, np.zeros(3, order.dtype)]).reshape(2, 8)
    w = np.concatenate([np.ones(13), np.zeros(3)]).astype(np.float32)
    from cervical_tpu_torch.data.masks import generate_modal_masks
    masks = generate_modal_masks(b.mask_generator, 16, 4).reshape(2, 8, 4)
    feats = {m: torch.from_numpy(v) for m, v in ds["feats"].items()}
    labels = torch.from_numpy(ds["labels"]).long()
    for i in range(2):
        idx = torch.from_numpy(order[i])
        b.train_step_fn()(sb, {m: v[idx] for m, v in feats.items()},
                          labels[idx], masks[i],
                          torch.from_numpy(w.reshape(2, 8)[i]), 1e-3, True)
    for k, v in sa.model.state_dict().items():
        assert torch.equal(v, sb.model.state_dict()[k]), k


def test_training_learns():
    # hidden 256: at 64 each tower ends in hidden // 64 = 1 feature
    _, pcfg = _cfgs(epochs=6, lr=5e-4, batch_size=16, epoch0_no_step=False,
                    in_features=64, hidden=256)
    ds = make_synthetic_fusion(num_patients=48, feature_dim=64, noise=0.3)
    tr = PT.FusionTrainer(pcfg, device="cpu")
    st = tr.init_state()
    accs = [tr.train_epoch(st, ds, e, pcfg.lr)["acc_all"] for e in range(6)]
    assert accs[-1] > 0.7, accs
    final = tr.predict(st.model.state_dict(), ds)
    assert final["acc_all"] > 0.7


def test_subset_eval_matches_jax_predict():
    """``predict`` with ``use_type`` and a per-patient ``present`` mask
    against JAX's on the same weights."""
    jcfg, pcfg = _cfgs()
    ds = make_synthetic_fusion(num_patients=21, feature_dim=IN, seed=4)
    ds["present"] = ds["present"].copy()
    ds["present"][::3, 2] = False
    jtr = JTrainer(jcfg)
    params = jtr.init_state({m: v[:1] for m, v in ds["feats"].items()},
                            jax.random.PRNGKey(5))["params"]
    ptr = PT.FusionTrainer(pcfg, device="cpu")
    sd = fusion_from_flax(jax.tree_util.tree_map(np.asarray, params))
    for use_type in (None, ("imgN", "imgA", "imgL"), ("imgN", "cli")):
        for bs in (8, 512):
            ref = jtr.predict(params, ds, batch_size=bs, use_type=use_type)
            got = ptr.predict(sd, ds, batch_size=bs, use_type=use_type)
            assert abs(ref["loss"] - got["loss"]) < 1e-5
            for k in ("acc_all", "acc_imgN", "acc_cli"):
                assert ref[k] == got[k], (use_type, k)
            np.testing.assert_array_equal(ref["confusion"], got["confusion"])


# -- splits and metrics -----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_splits_equal_jax(seed):
    labels = np.random.default_rng(seed).integers(0, 4, 57)
    for (a, b), (c, d) in zip(JS.stratified_kfold(labels, 5, seed),
                              PS.stratified_kfold(labels, 5, seed)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
        for strat in (labels[a], None):
            r = JS.train_test_split(a, 0.25, seed, strat)
            g = PS.train_test_split(a, 0.25, seed, strat)
            np.testing.assert_array_equal(r[0], g[0])
            np.testing.assert_array_equal(r[1], g[1])
    assert JS.ratio_split(list(range(30)), seed=seed) == \
        PS.ratio_split(list(range(30)), seed=seed)
    with pytest.raises(ValueError, match=">= 2 members"):
        PS.train_test_split(np.arange(3), 0.5, stratify=[0, 1, 1])


def test_classification_metrics_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    t, p = rng.integers(0, 4, 50), rng.integers(0, 4, 50)
    p[:5] = 3
    ref, got = JMet.classification_report(t, p, 4), \
        PMet.classification_report(t, p, 4)
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ref[k]), np.asarray(got[k]))
    cm = ref["confusion"] + 1
    a, b = JMet.report_from_confusion(cm), PMet.report_from_confusion(cm)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    assert PMet.accuracy(t, p) == JMet.accuracy(t, p)
    assert PMet.accuracy([], []) == 0.0
    ts, ps = rng.random((20, 4)) > 0.5, rng.random((20, 4)) > 0.5
    assert PMet.multilabel_report(ts, ps) == JMet.multilabel_report(ts, ps)
    JMet.write_classification_report(a, str(tmp_path / "j"))
    PMet.write_classification_report(b, str(tmp_path / "p"))
    for f in ("confusion_matrix.csv", "classification_report.csv"):
        assert (tmp_path / "j" / f).read_text() == (tmp_path / "p" / f).read_text()


# -- the CV loop -----------------------------------------------------------------------------

def _cv_cfg(**kw):
    _, pcfg = _cfgs(**{"epochs": 2, "kfold": 3, "repeat_num": 1,
                       "epoch0_no_step": False, **kw})
    return pcfg


def test_cross_validate_fold_resume_exact(tmp_path):
    cfg = _cv_cfg()
    ds = make_synthetic_fusion(num_patients=45, feature_dim=IN, seed=3)
    full = PT.FusionTrainer(cfg, device="cpu").cross_validate(
        ds, log=lambda *a: None, save_dir=str(tmp_path / "full"))
    assert len(full["folds"]) == 3 and not full["stopped_early"]

    part_dir = tmp_path / "part"
    trainer = PT.FusionTrainer(cfg, device="cpu")

    def stopping_log(msg):
        if "test acc" in msg and "epoch" not in msg:
            trainer.request_stop()

    part = trainer.cross_validate(ds, log=stopping_log,
                                  save_dir=str(part_dir))
    assert part["stopped_early"] and len(part["folds"]) == 1
    assert (part_dir / "cv_progress.json").exists()

    resumed = PT.FusionTrainer(cfg, device="cpu").cross_validate(
        ds, log=lambda *a: None, save_dir=str(part_dir))
    assert len(resumed["folds"]) == 3
    for a, b in zip(full["folds"], resumed["folds"]):
        assert (a["seed"], a["fold"]) == (b["seed"], b["fold"])
        assert a["val_acc"] == b["val_acc"]
        assert a["best_epoch"] == b["best_epoch"]
        assert a["test"]["acc_all"] == b["test"]["acc_all"]
        assert a["test"]["loss"] == pytest.approx(b["test"]["loss"], abs=0)
        np.testing.assert_array_equal(np.asarray(a["test"]["confusion"]),
                                      np.asarray(b["test"]["confusion"]))
        assert [e["loss"] for e in a["epoch_test"]] == \
            [e["loss"] for e in b["epoch_test"]]
    assert full["mean_test_acc"] == resumed["mean_test_acc"]
    # the best weights of each fold are equal files
    for f in range(3):
        za = np.load(tmp_path / "full" / f"best_seed0_fold{f}.npz")
        zb = np.load(part_dir / f"best_seed0_fold{f}.npz")
        assert set(za.files) == set(zb.files)
        assert all(np.array_equal(za[k], zb[k]) for k in za.files)


def test_cross_validate_graceful_stop_and_files(tmp_path):
    cfg = _cv_cfg()
    trainer = PT.FusionTrainer(cfg, device="cpu")
    ds = make_synthetic_fusion(num_patients=45, feature_dim=IN, seed=3)
    msgs = []

    def stopping_log(msg):
        msgs.append(msg)
        if "test acc" in msg and "epoch" not in msg:
            trainer.request_stop()

    res = trainer.cross_validate(ds, log=stopping_log, save_dir=str(tmp_path))
    assert res["stopped_early"] is True and len(res["folds"]) == 1
    assert np.isfinite(res["mean_test_acc"])
    assert any("stopped early" in m for m in msgs)
    fold = res["folds"][0]
    assert [e["epoch"] for e in fold["epoch_test"]] == [0, 1]
    assert 0 <= fold["best_epoch"] <= 1
    with open(tmp_path / "cv_results.json") as f:
        saved = json.load(f)
    assert saved["stopped_early"] and saved["modalities"] == list(MODS)
    lines = (tmp_path / "seed0_fold0_metrics.txt").read_text().splitlines()
    assert len(lines) == 2
    cls_out = tmp_path / "classification_out"
    import csv
    with open(cls_out / "confusion_matrix.csv") as f:
        rows = list(csv.reader(f))
    assert sum(int(x) for r in rows[1:] for x in r[1:]) == \
        int(np.asarray(fold["test"]["confusion"]).sum())
    assert os.path.exists(tmp_path / "best_seed0_fold0.npz")


def test_cross_validate_two_modal_matches_jax_splits(tmp_path):
    """The port's folds are the JAX package's index sets: each fold's test
    confusion counts the same patients."""
    mods = ("imgN", "cli")
    cfg = _cv_cfg(modalities=mods, kfold=2, in_features=64)
    ds = make_synthetic_fusion(num_patients=40, modalities=mods,
                               feature_dim=64, noise=0.2)
    out = PT.FusionTrainer(cfg, device="cpu").cross_validate(
        ds, log=lambda *a: None)
    folds = list(JS.stratified_kfold(ds["labels"], 2, seed=0))
    for r, (_, test) in zip(out["folds"], folds):
        assert int(np.asarray(r["test"]["confusion"]).sum()) == len(test)
    jds = j_synth(num_patients=40, modalities=mods, feature_dim=64, noise=0.2)
    np.testing.assert_array_equal(jds["feats"]["imgN"], ds["feats"]["imgN"])
