"""One segmentation train step and one eval step of the port against the
JAX package's ``_make_train_body`` / ``_make_eval_body``, at 64², batch 8,
from one set of weights, one uint8 batch and one augmentation-parameter
dict (JAX's kernels in interpret mode, the port's plain versions).

Dropout is off on both sides: flax's ``Dropout`` is replaced by identity
inside these tests only, the port's dropouts get ``p = 0``.  The frozen
step starts from the JAX state after one unfrozen step, carried over whole
(params, batch stats, both Adam states) by ``train/flax_import``.

Each step is held three ways: its outputs against JAX's step; its
optimizer against the JAX package's optax chain applied to the port's own
gradients (tight, and shown to catch planted optimizer faults); its f32
gradients against the same step's in float64.  ``pytest -s`` prints the
readings the limits were set from.
"""

import dataclasses

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cervical_tpu.config import SegDataConfig as JData
from cervical_tpu.config import SegTrainConfig as JCfg
from cervical_tpu.train import seg_trainer as JT
from cervical_tpu_torch.config import SegDataConfig, SegTrainConfig
from cervical_tpu_torch.models.deeplab import DeepLab, Dropout
from cervical_tpu_torch.train import seg_trainer as PT
from cervical_tpu_torch.train.flax_import import (deeplab_from_flax,
                                                  load_adam_state)

from torch_port_helpers import (random_state, to_flax,
                                two_torch_threads)  # noqa: F401

HW, B, LR = (64, 64), 8, 1e-4


class _NoDropout(flax.linen.Module):
    rate: float

    @flax.linen.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


def _cfgs(dtype):
    jcfg = JCfg(data=JData(input_shape=HW, aug_backend="pallas"), dtype=dtype)
    pcfg = SegTrainConfig(data=SegDataConfig(input_shape=HW,
                                             aug_backend="pallas"),
                          dtype=dtype, weights_init="none")
    return jcfg, pcfg


def _adam(opt_state):
    """(count, mu, nu) of an optax inject_hyperparams(chain(wd, adam, lr))
    state, as numpy trees."""
    a = opt_state.inner_state[1]
    return (int(a.count), jax.tree_util.tree_map(np.asarray, a.mu),
            jax.tree_util.tree_map(np.asarray, a.nu))


def jax_runs():
    """JAX side: s0 -> unfrozen f32 step -> s1 -> frozen f32 step -> s2;
    an unfrozen bf16 step from s0; the eval step on s0.  Flax's dropout is
    identity while these run."""
    mp = pytest.MonkeyPatch()
    mp.setattr(flax.linen, "Dropout", _NoDropout)
    try:
        state = random_state(DeepLab(num_classes=5), seed=61)
        params, stats = to_flax(state)
        rng = np.random.default_rng(62)
        images = rng.integers(0, 256, (B,) + HW + (3,)).astype(np.uint8)
        labels = rng.integers(0, 6, (B,) + HW).astype(np.uint8)  # 5 = ignore
        jcfg, _ = _cfgs("float32")
        aug = JT._sample_step_aug_params(jcfg, jax.random.PRNGKey(63), B)
        aug = {k: np.asarray(v) for k, v in aug.items()}
        out = {"state": state, "images": images, "labels": labels,
               "aug": aug}
        for dtype in ("float32", "bfloat16"):
            jcfg, _ = _cfgs(dtype)
            model, tx = JT.build_model(jcfg), JT.make_optimizer(jcfg)
            jp = jax.tree_util.tree_map(jnp.asarray, params)
            bp, hp = JT._split_params(jp)
            s0 = JT.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                               batch_stats=jax.tree_util.tree_map(
                                   jnp.asarray, stats),
                               opt_state={"backbone": tx.init(bp),
                                          "head": tx.init(hp)})
            args = (jnp.asarray(images), jnp.asarray(labels),
                    {k: jnp.asarray(v) for k, v in aug.items()},
                    jnp.float32(LR), jax.random.PRNGKey(64))
            s1, m1 = jax.jit(JT._make_train_body(jcfg, model, tx, False))(
                s0, *args)
            out[dtype] = (s1, m1)
            if dtype == "float32":
                out["s1"] = s1
                out["frozen"] = jax.jit(JT._make_train_body(
                    jcfg, model, tx, True))(s1, *args)
                weights = np.array([1, 1, 0, 1, 1, 0, 1, 1], np.float32)
                out["weights"] = weights
                out["eval"] = jax.jit(JT._make_eval_body(jcfg, model))(
                    s0, args[0], args[1], jnp.asarray(weights))
        return out
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def runs():
    return jax_runs()


def _port_state(pcfg, params, stats, opt_state=None):
    st = PT.create_state(pcfg, device="cpu")
    st.model.load_state_dict(deeplab_from_flax(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, stats)))
    for m in st.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    if opt_state is not None:
        load_adam_state(st.model, st.opt_state,
                        {g: _adam(opt_state[g]) for g in ("backbone", "head")})
    return st


def _expected_sd(js):
    return deeplab_from_flax(jax.tree_util.tree_map(np.asarray, js.params),
                             jax.tree_util.tree_map(np.asarray, js.batch_stats))


def _moments(model, opt):
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: s for p, s in opt.state.items()}


def _rel_l2(pairs):
    """Global relative L2 error of (got, want) tensor pairs."""
    num = sum(float(((g.double() - w.double()) ** 2).sum()) for g, w in pairs)
    den = sum(float((w.double() ** 2).sum()) for _, w in pairs)
    return (num / max(den, 1e-300)) ** 0.5


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-6)


def _report(what, err):
    """Print a test's readings (shown with ``pytest -s``)."""
    print(f"\n{what}: " + ", ".join(f"{k} {v:.3g}" for k, v in err.items()))


def _moment_errors(model, opt_state, adam):
    """Largest global relative L2 of a group's Adam moments against
    ``adam = {group: (count, mu, nu)}``; each stepped group's step count
    equal to ``count`` (a group never stepped has no state)."""
    worst = 0.0
    for group, (count, mu, nu) in adam.items():
        mom = _moments(model, opt_state[group])
        assert len(mom) > 0 if count else not mom, group
        assert all(float(s["step"]) == count for s in mom.values()), group
        for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu)) if count else ():
            pairs = [(mom[n][key], t.reshape(mom[n][key].shape))
                     for n, t in deeplab_from_flax(tree, None).items()]
            worst = max(worst, _rel_l2(pairs))
    return worst


def run_port_step(r, kind):
    """The port's step ``kind`` ("unfrozen" or "frozen" in f32, "bf16"
    unfrozen) from the input state of the JAX step of ``r = jax_runs()``:
    (port state after the step, its metrics, its state_dict and backbone
    Adam state before, the JAX state after, the JAX metrics)."""
    dtype = "bfloat16" if kind == "bf16" else "float32"
    _, pcfg = _cfgs(dtype)
    frozen = kind == "frozen"
    if frozen:
        s_in, (s_out, m) = r["s1"], r["frozen"]
        st = _port_state(pcfg, s_in.params, s_in.batch_stats, s_in.opt_state)
    else:
        s_out, m = r[dtype]
        st = _port_state(pcfg, *to_flax(r["state"]))
    before = {k: v.clone() for k, v in st.model.state_dict().items()}
    adam_b = {n: {k: v.clone() for k, v in s.items()} for n, s in
              _moments(st.model, st.opt_state["backbone"]).items()}
    aug = {k: torch.from_numpy(v.copy()) for k, v in r["aug"].items()}
    got = PT.make_train_step(pcfg, frozen)(
        st, torch.from_numpy(r["images"]), torch.from_numpy(r["labels"]),
        aug, LR)
    return st, got, before, adam_b, s_out, m


@pytest.fixture(scope="module")
def port_steps(runs):
    return {kind: run_port_step(runs, kind)
            for kind in ("unfrozen", "frozen", "bf16")}


def step_errors(st, got, before, s_out, m):
    """The port's step (``st`` after it, metrics ``got``, state_dict
    ``before`` it) against the JAX state ``s_out`` and metrics ``m``: each
    metric's relative error; the running stats' largest error over each
    tensor's largest magnitude; the share of updated elements whose update
    has another sign than JAX's (a zero update reads 1, one of random sign
    0.5); the largest global relative L2 of a group's Adam moments, i.e. of
    the gradients."""
    err = {k: _rel(got[k], m[k]) for k in ("loss", "main_loss", "f_score")}
    want = _expected_sd(s_out)
    sd = st.model.state_dict()
    err["stats"] = max(float((sd[n] - w).abs().max())
                       / max(float(w.abs().max()), 1e-30)
                       for n, w in want.items() if "running" in n)
    flips = moved = 0
    for n, _ in st.model.named_parameters():
        dg, dw = sd[n] - before[n], want[n] - before[n]
        moved += int((dw != 0).sum())
        flips += int(((torch.sign(dg) != torch.sign(dw)) & (dw != 0)).sum())
    err["update_sign"] = flips / max(moved, 1)
    err["moments_l2"] = _moment_errors(
        st.model, st.opt_state,
        {g: _adam(s_out.opt_state[g]) for g in ("backbone", "head")})
    return err


def _grads(model):
    """The gradients a step left on ``model``'s params (None where a
    frozen param got none)."""
    return {n: None if p.grad is None else p.grad.detach().clone()
            for n, p in model.named_parameters()}


def optax_expected(r, kind, grads, before, lr=LR, weight_decay=0.0):
    """What the JAX package's optimizer (``make_optimizer``: optax's coupled
    L2 + Adam chain) makes of the gradients ``grads`` from the params
    ``before`` and the JAX step's input Adam state: (the params after,
    ``{group: (count, mu, nu)}`` of the groups it steps)."""
    jcfg, _ = _cfgs("bfloat16" if kind == "bf16" else "float32")
    tx = JT.make_optimizer(dataclasses.replace(jcfg,
                                               weight_decay=weight_decay))
    params, _ = to_flax(before)
    gsd = dict(before)
    gsd.update({n: g for n, g in grads.items() if g is not None})
    gtree, _ = to_flax(gsd)
    frozen = kind == "frozen"
    out, adam = {}, {}
    for group, p, g in zip(("backbone", "head"), JT._split_params(params),
                           JT._split_params(gtree)):
        p = jax.tree_util.tree_map(jnp.asarray, p)
        if frozen and group == "backbone":
            out.update(p)
            continue
        opt = r["s1"].opt_state[group] if frozen else tx.init(p)
        opt.hyperparams["learning_rate"] = jnp.float32(lr)
        upd, new = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt, p)
        out.update(optax.apply_updates(p, upd))
        adam[group] = _adam(new)
    return deeplab_from_flax(jax.tree_util.tree_map(np.asarray, out),
                             None), adam


def optimizer_errors(model, opt_state, before, expected):
    """The port's params and Adam moments after its optimizer step against
    :func:`optax_expected`: global relative L2 of the params' update, and
    the largest of a group's moments."""
    want, adam = expected
    pairs = [(p.detach() - before[n], want[n].reshape(p.shape) - before[n])
             for n, p in model.named_parameters()]
    return {"opt_update": _rel_l2(pairs),
            "opt_moments": _moment_errors(model, opt_state, adam)}


def all_errors(r, kind, port_step):
    st, got, before, _, s_out, m = port_step
    err = step_errors(st, got, before, s_out, m)
    err.update(optimizer_errors(st.model, st.opt_state, before,
                                optax_expected(r, kind, _grads(st.model),
                                               before)))
    return err


# The optimizer against optax on the same gradients: f32 rounding of the
# two Adam formulas (moments read 5e-8), and of p + update where an
# element's update moves it across one ulp of p (the update reads 1.6e-5).
OPT_TOL = {"opt_update": 1e-4, "opt_moments": 1e-6}
F32_TOL = {"loss": 5e-4, "main_loss": 5e-4, "f_score": 1e-2, "stats": 1e-3,
           "moments_l2": 0.15, "update_sign": 0.05, **OPT_TOL}


@pytest.mark.parametrize("frozen", [False, True], ids=["unfrozen", "frozen"])
def test_train_step_matches_jax_f32(runs, port_steps, frozen):
    """f32, the algorithm.  Against JAX's step: loss and main loss to 5e-4
    relative; f-score to 1% (its 0.5 threshold flips pixels whose
    probability is within rounding of it); running mean/var to 1e-3 of
    each tensor's largest magnitude.

    The optimizer, against the JAX package's optax chain fed the port's
    own gradients from the same input state: the update to 1e-4 and the
    moments to 1e-6 global relative L2.

    The gradients (Adam's first moment is 0.1 x the gradient) to 15% global
    relative L2 of JAX's.  That gap is JAX's own f32 rounding, not the
    port's: ``test_train_step_gradients_match_float64`` finds the port's
    f32 gradients 10x nearer the float64 ones than JAX's.  Adam's first
    step moves each element by lr x sign(gradient), so an element whose
    gradient is smaller than that rounding can move the other way: at most
    5% of the updated elements do.

    In the frozen step the backbone's params and its Adam state are
    bit-identical before and after, and its BN running stats still move.
    """
    kind = "frozen" if frozen else "unfrozen"
    st, _, before, adam_b, _, _ = port_steps[kind]
    err = all_errors(runs, kind, port_steps[kind])
    _report(f"f32 {kind} step", err)
    for k, t in F32_TOL.items():
        assert err[k] <= t, (k, err)
    if frozen:
        for n, p in st.model.named_parameters():
            if n.startswith("backbone."):
                assert torch.equal(p, before[n]), n
        for n, s in _moments(st.model, st.opt_state["backbone"]).items():
            for k, v in s.items():
                assert torch.equal(v, adam_b[n][k]), (n, k)
        assert not torch.equal(st.model.backbone.bn1.running_mean,
                               before["backbone.bn1.running_mean"])


def test_train_step_matches_jax_bf16(runs, port_steps):
    """bf16 compute: the two frameworks round activations to bf16 at other
    places, so against JAX the loss agrees to 2e-3 relative, the f-score to
    2%, the running stats to 2e-2 of each tensor's largest magnitude, and
    at most 25% of the updated elements move the other way than JAX's (a
    random sign would give 50%).  The gradients themselves are not held
    against JAX in bf16.  The optimizer is, as in f32, against optax fed
    the port's own gradients."""
    err = all_errors(runs, "bf16", port_steps["bf16"])
    _report("bf16 unfrozen step", err)
    for k, t in {"loss": 2e-3, "main_loss": 2e-3, "f_score": 2e-2,
                 "stats": 2e-2, "update_sign": 0.25, **OPT_TOL}.items():
        assert err[k] <= t, (k, err)


def test_train_step_gradients_match_float64(runs, port_steps):
    """The cause of the f32 gradient gap to JAX.  The unfrozen step's f32
    gradients against the same step's in float64 (the port's model in
    float64 on the same augmented batch; its logits and loss stay f32):
    the head's to 1e-4, the backbone's (behind 20 train-mode BatchNorm
    blocks) to 2% global relative L2.  JAX's f32 gradients (its first
    Adam moment / 0.1) are at least 4x farther from the float64 ones, in
    each group."""
    st, _, before, _, s_out, _ = port_steps["unfrozen"]
    _, pcfg = _cfgs("float32")
    aug = {k: torch.from_numpy(v.copy()) for k, v in runs["aug"].items()}
    images, labels = PT.make_train_aug_fn(pcfg)(
        torch.from_numpy(runs["images"]), torch.from_numpy(runs["labels"]),
        aug)
    f64 = torch.float64
    model = DeepLab(num_classes=5, dtype=f64).to(f64)
    model.load_state_dict({k: v.to(f64) if v.is_floating_point() else v
                           for k, v in before.items()})
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    model.train()
    logits = model(images.to(f64).permute(0, 3, 1, 2), resize_logits=False)
    total, _, _ = PT.seg_loss_bundle_fn(pcfg, logits.permute(0, 2, 3, 1),
                                        torch.clamp(labels, max=5),
                                        resize_to=HW)
    total.backward()
    exact = _grads(model)
    port = _grads(st.model)
    jax_g = {}
    for group in ("backbone", "head"):
        _, mu, _ = _adam(s_out.opt_state[group])
        jax_g.update({n: torch.from_numpy(np.asarray(t)).reshape(
            port[n].shape) / (1 - 0.9)
            for n, t in deeplab_from_flax(mu, None).items()})
    err = {}
    for group in ("backbone", "head"):
        names = [n for n in port if n.startswith("backbone.") ==
                 (group == "backbone")]
        err[f"{group}_port"] = _rel_l2([(port[n], exact[n]) for n in names])
        err[f"{group}_jax"] = _rel_l2([(jax_g[n], exact[n]) for n in names])
    _report("f32 gradients vs float64", err)
    assert err["head_port"] <= 1e-4, err
    assert err["backbone_port"] <= 2e-2, err
    for group in ("backbone", "head"):
        assert err[f"{group}_jax"] >= 4 * err[f"{group}_port"], err


def _faulty_adam_step(r, grads, make_opt, lr):
    """The head's second Adam step (the frozen step's optimizer) made by
    ``make_opt(params)`` on the frozen step's input state and ``grads``:
    (model, optimizers, params before)."""
    _, pcfg = _cfgs("float32")
    s1 = r["s1"]
    st = _port_state(pcfg, s1.params, s1.batch_stats)
    st.opt_state = {g: make_opt(ps) for g, ps in
                    zip(("backbone", "head"), PT._split_params(st.model))}
    load_adam_state(st.model, st.opt_state,
                    {g: _adam(s1.opt_state[g]) for g in ("backbone", "head")})
    before = {k: v.clone() for k, v in st.model.state_dict().items()}
    for n, p in st.model.named_parameters():
        p.grad = grads[n]
    for pg in st.opt_state["head"].param_groups:
        pg["lr"] = lr
    st.opt_state["head"].step()
    return st.model, st.opt_state, before


def _adam_cfg(weight_decay):
    return dataclasses.replace(_cfgs("float32")[1], weight_decay=weight_decay)


PLANTED = {
    "sound": (0.0, LR, lambda ps: PT.make_optimizer(_adam_cfg(0.0), ps)),
    "sound_l2": (1e-2, LR,
                 lambda ps: PT.make_optimizer(_adam_cfg(1e-2), ps)),
    "decoupled_decay": (1e-2, LR, lambda ps: torch.optim.AdamW(
        ps, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2)),
    "beta2": (0.0, LR, lambda ps: torch.optim.Adam(
        ps, lr=0.0, betas=(0.9, 0.99), eps=1e-8)),
    "beta1": (0.0, LR, lambda ps: torch.optim.Adam(
        ps, lr=0.0, betas=(0.8, 0.999), eps=1e-8)),
    "eps": (0.0, LR, lambda ps: torch.optim.Adam(
        ps, lr=0.0, betas=(0.9, 0.999), eps=1e-6)),
    "lr": (0.0, 1.01 * LR,
           lambda ps: PT.make_optimizer(_adam_cfg(0.0), ps)),
}


@pytest.mark.parametrize("case", list(PLANTED))
def test_optimizer_check_catches_planted_faults(runs, port_steps, case):
    """The optimizer check of the step tests can fail: the head's second
    Adam step on the port's frozen-step gradients, against optax fed the
    same.  The sound optimizer (with and without coupled L2) stays within
    ``OPT_TOL``; each planted fault (decoupled decay, beta2 0.99, beta1
    0.8, eps 1e-6, lr 1% high) reads at least 10x over it."""
    weight_decay, lr, make_opt = PLANTED[case]
    grads = _grads(port_steps["frozen"][0].model)
    model, opts, before = _faulty_adam_step(runs, grads, make_opt, lr)
    want = optax_expected(runs, "frozen", grads, before,
                          weight_decay=weight_decay)
    err = optimizer_errors(model, opts, before, want)
    _report(f"optimizer {case}", err)
    if case.startswith("sound"):
        assert all(err[k] <= t for k, t in OPT_TOL.items()), err
    else:
        assert any(err[k] > 10 * t for k, t in OPT_TOL.items()), err


def run_port_eval(r):
    """The port's eval step on the JAX eval step's inputs, two weight-0
    rows among them: (port metrics, JAX metrics)."""
    _, pcfg = _cfgs("float32")
    st = _port_state(pcfg, *to_flax(r["state"]))
    got = PT.make_eval_step(pcfg)(st, torch.from_numpy(r["images"]),
                                  torch.from_numpy(r["labels"]),
                                  torch.from_numpy(r["weights"]))
    return got, r["eval"]


def eval_errors(got, want):
    """Relative errors of loss and f-score; the share of confusion-matrix
    counts that differ from JAX's."""
    hist, jhist = got["hist"].numpy(), np.asarray(want["hist"])
    return {"loss": _rel(got["loss"], want["loss"]),
            "f_score": _rel(got["f_score"], want["f_score"]),
            "hist": float(np.abs(hist - jhist).sum()) / max(hist.sum(), 1)}


def test_eval_step_matches_jax(runs):
    """The eval step (letterbox, eval-mode forward, loss bundle, confusion
    matrix) with two weight-0 rows: loss and f-score to 1e-4 relative; the
    confusion matrix sums to the real rows' non-ignored pixels and
    differs from JAX's by argmax ties at most (< 0.2% of the counts)."""
    got, want = run_port_eval(runs)
    err = eval_errors(got, want)
    _report("eval step", err)
    assert err["loss"] <= 1e-4 and err["f_score"] <= 1e-4, err
    real = runs["labels"][runs["weights"] > 0]
    hist, jhist = got["hist"].numpy(), np.asarray(want["hist"])
    assert hist.sum() == jhist.sum() == int((real < 5).sum())
    assert err["hist"] <= 2e-3, err


def test_einsum_backend_raises_in_trainer():
    _, pcfg = _cfgs("float32")
    cfg = dataclasses.replace(
        pcfg, data=dataclasses.replace(pcfg.data, aug_backend="einsum"))
    with pytest.raises(NotImplementedError, match="einsum"):
        PT.make_train_step(cfg, False)
    cfg.data.aug_backend = "opencv"
    with pytest.raises(ValueError, match="aug_backend"):
        PT.make_train_step(cfg, False)
