"""The port's vmapped-folds CV engine and the fusion model in bf16, against
the JAX package and against the port's own sequential engine, on the CPU.

* The stacked train step (``train/fold_stack.py``) against JAX's
  ``jax.vmap(train_step_fn(), in_axes=(0, 0, 0, 0, None, 0, 0, 0))``, the
  ``vstep`` of ``_cv_seed_program``, on 3 pairs carried across with
  ``fusion_from_flax``: dropout off on both sides, explicit masks, 3 steps
  (the first with ``do_step`` False), one pair on an all-weight-0 batch at
  the last.  Params held to ``test_torch_port_fusion_train.py``'s per-entry
  bound (``_adam_bounds``), the moments to its limit, the per-pair counts
  exactly; the padded pair's params, moments and count bit for bit as they
  were.
* ``cross_validate(vmap_folds=True)`` against the sequential engine at JAX's
  own tolerances (``test_cross_validate_vmap_folds_matches_sequential``):
  best epoch and confusion equal, val accuracy 1e-5, test accuracy 1e-6,
  per-epoch test accuracy 1e-6 and loss 1e-4; folds of 3 and 4 batches, so
  the 3-batch folds ride an all-weight-0 padding batch.
* Groups (4 pairs as 3 + 1 across a seed boundary), the stop between epoch
  chunks and the bitwise resume from ``vmap_group_ckpt.npz``, and the
  fold-level resume from a sequential run's ``cv_progress.json``.
* bf16: ``FusionMAE(dtype=bf16)`` against JAX's ``FusionMAE(dtype=
  jnp.bfloat16)`` on the same weights, within 2x JAX's own distance between
  its bf16 and f32 outputs, every modality's first layer bf16 and nearer
  JAX's bf16 output than its f32 one; one bf16 train step's loss within 2x
  JAX's bf16 drift of the loss taken term by term; the vmapped engine
  against the sequential one in bf16.
  ``pytest -s`` prints the readings.
"""

import importlib.util
import json
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cervical_tpu import losses as JLoss
from cervical_tpu.models.fusion import FusionMAE as JFusion
from cervical_tpu.train.fusion_trainer import FusionTrainer as JTrainer
from cervical_tpu.train.fusion_trainer import head_weights as j_head_weights
from cervical_tpu_torch.config import FusionTrainConfig
from cervical_tpu_torch.data.fusion_data import make_synthetic_fusion
from cervical_tpu_torch.models.fusion import FusionMAE
from cervical_tpu_torch.train import fold_stack as FS
from cervical_tpu_torch.train import fusion_trainer as PT
from cervical_tpu_torch.train.flax_import import (flatten_params,
                                                  fusion_from_flax,
                                                  fusion_to_flax)

from test_torch_port_fusion_train import (B, LR, MODS, _adam_bounds, _batch,
                                          _cfgs, _NoDropout, _param_excess,
                                          _rel_max)
from torch_port_helpers import fusion_feats, two_torch_threads  # noqa: F401

F = 3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(tree, i):
    return jax.tree_util.tree_map(lambda a: np.asarray(a)[i], tree)


def _flax(stack, flat, i):
    """Pair ``i`` of a (F, P) tensor of ``stack`` in the flat flax layout."""
    return flatten_params(fusion_to_flax(
        {k: v.clone() for k, v in stack.pair_state_dict(i, flat).items()}))


# -- the stacked step against JAX's vmapped step ---------------------------------

def test_stacked_step_matches_jax_vmapped_step():
    jcfg, pcfg = _cfgs()
    batches = [[_batch(100 + 10 * k + f) for f in range(F)] for k in range(3)]
    weights = [[np.ones(B, np.float32) for _ in range(F)] for _ in range(3)]
    weights[2][1][:] = 0.0  # pair 1 on a padding batch
    weights[2][2][5:] = 0.0  # pair 2 on a ragged tail
    do_steps = [False, True, True]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        jtr = JTrainer(jcfg)
        feats0 = {m: v[:1] for m, v in batches[0][0][0].items()}
        states = [jtr.init_state(feats0, jax.random.PRNGKey(40 + f))
                  for f in range(F)]
        jstate = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)
        vstep = jax.vmap(jtr.train_step_fn(),
                         in_axes=(0, 0, 0, 0, None, 0, 0, 0))
        jloss, before, after = [], [], []
        for k in range(3):
            before.append(_np_tree(jstate["params"]))
            bw = np.stack(weights[k])
            do = do_steps[k] & np.any(bw > 0, axis=-1)
            jstate, jm = vstep(
                jstate, {m: jnp.stack([b[0][m] for b in batches[k]])
                         for m in MODS},
                jnp.stack([b[1] for b in batches[k]]),
                jnp.stack([b[2] for b in batches[k]]), jnp.asarray(LR),
                jnp.asarray(do), jax.random.split(jax.random.PRNGKey(0), F),
                jnp.asarray(bw))
            jloss.append(np.asarray(jm["loss"]))
            after.append(jstate)

    base = PT.build_model(pcfg)
    for m in base.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    stack = FS.FoldStack(base, [fusion_from_flax(_np_tree(s["params"]))
                                for s in states], [0] * F)
    opt = FS.StackedAdam(stack.flat, lr=LR, weight_decay=pcfg.weight_decay)
    step = FS.make_stacked_step(stack, opt, PT.make_loss(pcfg))
    # the cohort: every pair's rows of every step, gathered by index
    feats_all = {m: torch.from_numpy(np.concatenate(
        [b[0][m] for bk in batches for b in bk])) for m in MODS}
    labels_all = torch.from_numpy(np.concatenate(
        [b[1] for bk in batches for b in bk])).long()
    ploss, pgrads, moments = [], [], []
    for k in range(3):
        if k == 2:
            held = (stack.flat[1].clone(),
                    {n: opt.state[stack.flat][n][1].clone()
                     for n in ("step", "exp_avg", "exp_avg_sq")})
        idx = torch.arange(F * B).view(F, B) + k * F * B
        out = step(feats_all, labels_all, idx,
                   torch.from_numpy(np.stack([b[2] for b in batches[k]])),
                   torch.from_numpy(np.stack(weights[k])), LR, do_steps[k])
        ploss.append(out["loss"].numpy())
        pgrads.append([_flax(stack, stack.grad, f) for f in range(F)])
    st = opt.state[stack.flat]
    # the padded pair: params, moments and count as they were, bit for bit
    assert torch.equal(stack.flat[1], held[0])
    assert all(torch.equal(st[n][1], held[1][n]) for n in held[1])

    loss_rel = max(float(np.abs(a - b).max() / np.abs(a).max())
                   for a, b in zip(jloss, ploss))
    adam = jstate["opt_state"].inner_state[1]
    np.testing.assert_array_equal(np.asarray(adam.count), [2, 1, 2])
    np.testing.assert_array_equal(st["step"].numpy(), [2.0, 1.0, 2.0])
    excess, mom = [], []
    for f in range(F):
        adam_steps = [(_pair(before[k], f),
                       tuple(batches[k][f]), weights[k][f],
                       _pair(after[k], f), pgrads[k][f])
                      for k in range(3)
                      if do_steps[k] and weights[k][f].any()]
        bound = _adam_bounds(jtr, adam_steps)
        excess.append(_param_excess(
            flatten_params(_pair(jstate["params"], f)),
            _flax(stack, stack.flat, f), bound))
        for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            ref = flatten_params(_pair(tree, f))
            got = _flax(stack, st[key], f)
            floor = 1e-3 * max(float(np.abs(v).max()) for v in ref.values())
            mom.append(max(_rel_max(ref[n], got[n], floor) for n in ref))
    print("stacked step: loss rel", loss_rel, "params: largest error over "
          "its bound", excess, "moments", max(mom))
    assert loss_rel < 1e-4
    assert max(excess) <= 1.0
    assert max(mom) < 1e-3


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_stacked_pairs_match_the_sequential_step():
    """``chip_smoke.stacked_vs_sequential``, the card's check at full width,
    here at the test size: 3 stacked pairs, pair by pair, against the
    sequential ``train_step_fn`` on each pair's own model, dropout on and
    shared, one pair on a padding batch; to the limits of the stacked step
    against JAX above."""
    cs = _chip_smoke()
    cpu = torch.device("cpu")
    ok, r = cs.stacked_vs_sequential(
        torch, _cv_cfg(), cs.synthetic_cohort(torch, 40, 32, 7, cpu), F, cpu,
        torch.Generator().manual_seed(3))
    print("stacked pairs against the sequential step:", r)
    assert ok, r


# -- the engine against the sequential one ---------------------------------------

def _cv_cfg(**kw):
    return FusionTrainConfig(**{"in_features": 32, "hidden": 64,
                                "batch_size": 8, **kw})


def _quiet(*a):
    return None


def _assert_folds_match(seq, vm, exact=False, bf16=False):
    """JAX's tolerances; ``bf16``: the per-epoch test loss to bf16's unit
    roundoff of it (2**-8 relative) instead of 1e-4, the rest unchanged."""
    assert [(r["seed"], r["fold"]) for r in seq["folds"]] == \
        [(r["seed"], r["fold"]) for r in vm["folds"]]
    tol = 0.0 if exact else 1.0
    for a, b in zip(seq["folds"], vm["folds"]):
        assert a["best_epoch"] == b["best_epoch"]
        assert abs(a["val_acc"] - b["val_acc"]) <= 1e-5 * tol
        assert abs(a["test"]["acc_all"] - b["test"]["acc_all"]) <= 1e-6 * tol
        np.testing.assert_array_equal(np.asarray(a["test"]["confusion"]),
                                      np.asarray(b["test"]["confusion"]))
        for ea, eb in zip(a["epoch_test"], b["epoch_test"]):
            assert abs(ea["acc_all"] - eb["acc_all"]) <= 1e-6 * tol
            assert abs(ea["loss"] - eb["loss"]) <= (
                2.0 ** -8 * abs(ea["loss"]) if bf16 else 1e-4 * tol)
    assert abs(seq["mean_test_acc"] - vm["mean_test_acc"]) <= 1e-6 * tol


def test_vmapped_cv_matches_sequential(tmp_path):
    """48 patients: the folds' train sets hold 23, 24 and 25 patients, so
    two folds ride a padding batch in the third's fourth step."""
    cfg = _cv_cfg(epochs=3, kfold=3, repeat_num=1)
    ds = make_synthetic_fusion(num_patients=48, feature_dim=32, seed=5)
    seq = PT.FusionTrainer(cfg, device="cpu").cross_validate(
        ds, log=_quiet, save_dir=str(tmp_path / "seq"))
    logs = []
    vm = PT.FusionTrainer(cfg, device="cpu").cross_validate(
        ds, log=logs.append, save_dir=str(tmp_path / "vm"), vmap_folds=True)
    assert len(vm["folds"]) == 3 and not vm["stopped_early"]
    _assert_folds_match(seq, vm)
    assert logs.count("group 0: epochs 3/3") == 1
    for name in ("cv_results.json", "cv_progress.json", "best_seed0_fold0.npz",
                 "seed0_fold2_metrics.txt",
                 "classification_out/confusion_matrix.csv"):
        assert (tmp_path / "vm" / name).exists(), name
    assert len((tmp_path / "vm" / "seed0_fold1_metrics.txt").read_text()
               .splitlines()) == 3
    # chunked (epoch_chunk=2 over 3 epochs: a full and a ragged chunk), no
    # save_dir: invisible in the results
    ck = PT.FusionTrainer(cfg, device="cpu")._cross_validate_vmapped(
        ds, cfg.epochs, np.asarray(ds["labels"]), logs.append, None,
        epoch_chunk=2)
    assert "group 0: epochs 2/3" in logs
    _assert_folds_match(vm, ck, exact=True)


def test_vmapped_cv_matches_sequential_in_bf16():
    """``dtype="bfloat16"``: 2 pairs x 2 epochs of the vmapped engine
    against the sequential engine in bf16, at the f32 case's tolerances but
    for the per-epoch test loss: a batched bf16 product rounds otherwise
    than a single one, and one logit on the neighbouring bf16 value moves
    the loss by ~1e-4 (read: 2.4e-4 on 1.66 at epoch 1, the accuracies
    equal), so the loss is held to bf16's unit roundoff of it."""
    cfg = _cv_cfg(epochs=2, kfold=2, repeat_num=1, dtype="bfloat16")
    ds = make_synthetic_fusion(num_patients=40, feature_dim=32, seed=5)
    seq = PT.FusionTrainer(cfg, device="cpu").cross_validate(ds, log=_quiet)
    vm = PT.FusionTrainer(cfg, device="cpu").cross_validate(
        ds, log=_quiet, vmap_folds=True)
    assert len(vm["folds"]) == 2
    _assert_folds_match(seq, vm, bf16=True)


def test_vmapped_cv_group_chunking():
    """4 pairs over 2 seeds as groups of 3 + 1 (the tail crosses the seed
    boundary) give the one-group results."""
    cfg = _cv_cfg(epochs=2, kfold=2, repeat_num=2)
    ds = make_synthetic_fusion(num_patients=40, feature_dim=32, seed=9)
    one = PT.FusionTrainer(cfg, device="cpu").cross_validate(
        ds, log=_quiet, vmap_folds=True)
    logs = []
    grouped = PT.FusionTrainer(cfg, device="cpu").cross_validate(
        ds, log=logs.append, vmap_folds=True, vmap_group=3)
    assert len(one["folds"]) == len(grouped["folds"]) == 4
    assert "group 1: epochs 2/2" in logs
    _assert_folds_match(one, grouped)


def test_vmapped_cv_stop_mid_group_and_bitwise_resume(tmp_path):
    """A stop after the first of two epoch chunks writes the group in flight
    to ``vmap_group_ckpt.npz``; a fresh trainer restores it, runs only the
    second chunk and ends equal to an uninterrupted run bit for bit."""
    cfg = _cv_cfg(epochs=4, kfold=2, repeat_num=1, epoch0_no_step=False)
    ds = make_synthetic_fusion(num_patients=40, feature_dim=32, seed=13)
    labels = np.asarray(ds["labels"])
    full = PT.FusionTrainer(cfg, device="cpu")._cross_validate_vmapped(
        ds, cfg.epochs, labels, _quiet, str(tmp_path / "full"),
        epoch_chunk=2)
    part_dir = tmp_path / "part"
    part_dir.mkdir()
    trainer = PT.FusionTrainer(cfg, device="cpu")

    def stopping_log(msg):
        if "epochs 2/4" in msg:
            trainer.request_stop()

    part = trainer._cross_validate_vmapped(ds, cfg.epochs, labels,
                                           stopping_log, str(part_dir),
                                           epoch_chunk=2)
    assert part["stopped_early"] is True and part["folds"] == []
    assert (part_dir / "vmap_group_ckpt.npz").exists()
    assert not (part_dir / "cv_progress.json").exists()
    # a snapshot of other pairs is ignored
    other = tmp_path / "other"
    other.mkdir()
    (other / "vmap_group_ckpt.npz").write_bytes(
        (part_dir / "vmap_group_ckpt.npz").read_bytes())
    logs = []
    PT.FusionTrainer(_cv_cfg(epochs=1, kfold=2, start_seed=1), device="cpu"
                     )._cross_validate_vmapped(ds, 1, labels, logs.append,
                                               str(other))
    assert any("does not match" in m for m in logs)
    logs = []
    resumed = PT.FusionTrainer(cfg, device="cpu")._cross_validate_vmapped(
        ds, cfg.epochs, labels, logs.append, str(part_dir), epoch_chunk=2)
    assert "resuming group mid-training at epoch 2/4" in logs, logs
    assert not any("epochs 2/4" in m for m in logs)
    assert not (part_dir / "vmap_group_ckpt.npz").exists()
    _assert_folds_match(full, resumed, exact=True)
    for f in range(2):
        za = np.load(tmp_path / "full" / f"best_seed0_fold{f}.npz")
        zb = np.load(part_dir / f"best_seed0_fold{f}.npz")
        assert all(np.array_equal(za[k], zb[k]) for k in za.files)
    assert (part_dir / "seed0_fold1_metrics.txt").read_text() == \
        (tmp_path / "full" / "seed0_fold1_metrics.txt").read_text()


def test_vmapped_cv_resumes_a_sequential_progress_file(tmp_path):
    """The sequential engine stops after fold 0 of 4 pairs; the vmapped one
    resumes from its ``cv_progress.json``, trains the other 3 pairs as one
    group across the seed boundary and ends with the sequential engine's
    uninterrupted folds."""
    cfg = _cv_cfg(epochs=2, kfold=2, repeat_num=2)
    ds = make_synthetic_fusion(num_patients=40, feature_dim=32, seed=7)
    full = PT.FusionTrainer(cfg, device="cpu").cross_validate(
        ds, log=_quiet, save_dir=str(tmp_path / "full"))
    seq = PT.FusionTrainer(cfg, device="cpu")

    def stop_after_fold(msg):
        if msg.startswith("seed 0 fold 0: test acc"):
            seq.request_stop()

    part = seq.cross_validate(ds, log=stop_after_fold,
                              save_dir=str(tmp_path / "part"))
    assert part["stopped_early"] and len(part["folds"]) == 1
    logs = []
    resumed = PT.FusionTrainer(cfg, device="cpu").cross_validate(
        ds, log=logs.append, save_dir=str(tmp_path / "part"),
        vmap_folds=True)
    assert any(m.startswith("resuming: 1 completed folds") for m in logs)
    assert "group 0: epochs 2/2" in logs and \
        not any(m.startswith("group 1") for m in logs)
    assert not resumed["stopped_early"]
    _assert_folds_match(full, resumed)
    with open(tmp_path / "part" / "cv_progress.json") as f:
        assert len(json.load(f)["folds"]) == 4


# -- bf16 ------------------------------------------------------------------------------

def _max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def test_bf16_forward_within_twice_jax_bf16_drift():
    """Eval-mode logits of every head, with some slots absent, within 2x
    JAX's bf16-vs-f32 distance of JAX's bf16 logits.  That alone would pass
    an f32 forward cast to bf16 at the end (the logits sit about one drift
    from both sides), so every modality's first layer (the GNN: two bf16
    ``Dense``, inputs equal on both sides) is also held: bf16, and within a
    quarter of its distance to JAX's f32 output of JAX's bf16 output (an f32
    product rounded to bf16 would sit nearer the f32 one)."""
    feats = fusion_feats(MODS, 6, 61, 32)
    present = np.ones((6, 4), bool)
    present[::2, 1] = False
    present[1, 3] = False
    mask = present == 0
    j32 = JFusion(modalities=MODS, in_features=32, hidden=64)
    j16 = JFusion(modalities=MODS, in_features=32, hidden=64,
                  dtype=jnp.bfloat16)
    jf = {m: jnp.asarray(v) for m, v in feats.items()}
    params = _np_tree(j32.init(jax.random.PRNGKey(6), jf)["params"])
    args = dict(present=jnp.asarray(present), mae_mask=jnp.asarray(mask),
                capture_intermediates=True, mutable=["intermediates"])
    r32, i32 = j32.apply({"params": params}, jf, **args)
    r16, i16 = j16.apply({"params": params}, jf, **args)
    pm = FusionMAE(MODS, 32, 64, dtype=torch.bfloat16).eval()
    pm.load_state_dict(fusion_from_flax(params), strict=True)
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    gnn = {}
    for m in MODS:
        getattr(pm, f"{m}_gnn_2").register_forward_hook(
            lambda mod, inp, out, m=m: gnn.__setitem__(m, out))
    with torch.no_grad():
        got = pm({m: torch.from_numpy(v) for m, v in feats.items()},
                 present=torch.from_numpy(present),
                 mae_mask=torch.from_numpy(mask))["logits"]
    assert all(v.dtype == torch.bfloat16 for v in got.values())
    r32, r16 = r32["logits"], r16["logits"]
    drift = max(_max_abs(r16[k], r32[k]) for k in r32)
    dist = max(_max_abs(r16[k], got[k].float()) for k in r32)
    print("bf16 logits: port to JAX bf16", dist, "JAX bf16 to f32", drift)
    assert 0.0 < drift and dist <= 2.0 * drift
    for m in MODS:
        assert gnn[m].dtype == torch.bfloat16, m
        to16 = _max_abs(i16["intermediates"][f"{m}_gnn"]["__call__"][0],
                        gnn[m].float())
        to32 = _max_abs(i32["intermediates"][f"{m}_gnn"]["__call__"][0],
                        gnn[m].float())
        print(f"bf16 {m} GNN output: port to JAX bf16", to16, "to JAX f32",
              to32)
        assert 0.0 < to32 and to16 <= 0.25 * to32, m


def _jax_loss_parts(jtr, params, feats, labels, mask, w):
    """JAX's train-mode loss terms: ``fusion_multihead_loss``'s parts (each
    head's CE and the MAE term), as ``train_step_fn`` weighs them."""
    cfg = jtr.cfg

    @jax.jit
    def parts_of(params, feats, labels, mask, wj):
        out = jtr.model.apply({"params": params}, feats, mae_mask=mask,
                              deterministic=False,
                              rngs={"dropout": jax.random.PRNGKey(0)})
        per = jax.vmap(JLoss.masked_mae_mse)(out["mae_out"],
                                             out["mae_labels"], mask)
        mse = cfg.mse_loss_of_mae_factor * jnp.sum(per * wj) / jnp.maximum(
            jnp.sum(wj), 1.0)
        return JLoss.fusion_multihead_loss(
            out["logits"], labels, j_head_weights(cfg), mse, mse_factor=5.0,
            num_micro_batches=1, sample_weights=wj)[1]

    parts = parts_of(params, {m: jnp.asarray(v) for m, v in feats.items()},
                     jnp.asarray(labels), jnp.asarray(mask), jnp.asarray(w))
    return {k: float(v) for k, v in parts.items()}


def test_bf16_train_step_loss_within_twice_jax_bf16_drift():
    """The loss of one bf16 train step against JAX's bf16 step on the same
    weights and batch (dropout off).  The limit is 2x JAX's own bf16 drift
    of the loss taken term by term (sum over heads of head weight x |bf16
    CE - f32 CE|, plus the MAE term's), since the drifts of the terms
    cancel in JAX's total by chance."""
    feats, labels, mask = _batch(70)
    w = np.ones(B, np.float32)
    w[6:] = 0.0
    losses, parts = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        for name in ("bfloat16", "float32"):
            jcfg, _ = _cfgs(dtype=name)
            jtr = JTrainer(jcfg)
            js = jtr.init_state({m: v[:1] for m, v in feats.items()},
                                jax.random.PRNGKey(8))
            _, jm = jtr.train_step_fn()(
                js, {m: jnp.asarray(v) for m, v in feats.items()},
                jnp.asarray(labels), jnp.asarray(mask), jnp.asarray(LR),
                jnp.asarray(True), jax.random.PRNGKey(0), jnp.asarray(w))
            losses[name] = float(jm["loss"])
            parts[name] = _jax_loss_parts(jtr, js["params"], feats, labels,
                                          mask, w)
    _, pcfg = _cfgs(dtype="bfloat16")
    ptr = PT.FusionTrainer(pcfg, device="cpu")
    st = ptr.init_state()
    st.model.load_state_dict(fusion_from_flax(_np_tree(js["params"])))
    for m in st.model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    out = ptr.train_step_fn()(
        st, {n: torch.from_numpy(v) for n, v in feats.items()},
        torch.from_numpy(labels), torch.from_numpy(mask),
        torch.from_numpy(w), LR, True)
    assert out["loss"].dtype == torch.float32
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
               for p in st.model.parameters())
    hw = {**j_head_weights(_cfgs()[0]), "mae_mse": 1.0}
    drift = sum(hw[k] * abs(parts["bfloat16"][k] - parts["float32"][k])
                for k in parts["float32"])
    dist = abs(float(out["loss"]) - losses["bfloat16"])
    print("bf16 step loss: port to JAX bf16", dist, "JAX bf16 to f32, term "
          "by term", drift, "in total", abs(losses["bfloat16"]
                                            - losses["float32"]))
    # the terms are the step's: in f32 they sum to its loss
    assert abs(sum(hw[k] * v for k, v in parts["float32"].items())
               - losses["float32"]) < 1e-5
    assert dist <= 2.0 * drift
