"""The port's DeepLabV3+-MobileNetV2 against the JAX package's
``DeepLab(backbone="mobilenet")`` at 64², on identical weights: the port's
seeded ``state_dict`` goes through the JAX package's
``convert_deeplab(sd, "mobilenet")``.  Eval logits at os16 and os8 in f32
and bf16; one train step (forward in train mode, BatchNorm running stats,
the loss bundle, Adam) with dropout off on both sides; the seeded init;
a bubbliiiing-named backbone checkpoint through ``load_pretrained``.
``pytest -s`` prints the readings."""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cervical_tpu.config import SegDataConfig as JData
from cervical_tpu.config import SegTrainConfig as JCfg
from cervical_tpu.models.deeplab import DeepLab as JaxDeepLab
from cervical_tpu.train import seg_trainer as JT
from cervical_tpu.train import torch_import as JTI
from cervical_tpu_torch.config import SegDataConfig, SegTrainConfig
from cervical_tpu_torch.models.backbones.mobilenetv2 import (
    INVERTED_RESIDUAL_SETTING, _block_plan)
from cervical_tpu_torch.models.deeplab import DeepLab
from cervical_tpu_torch.models.layers import Dropout
from cervical_tpu_torch.train import seg_trainer as PT
from cervical_tpu_torch.train.flax_import import deeplab_from_flax

from torch_port_helpers import (random_state, scaled_atol, to_flax,
                                two_torch_threads)  # noqa: F401

HW, LR = (64, 64), 1e-4


def _model(ds=16, dtype=torch.float32):
    return DeepLab(num_classes=5, backbone="mobilenet", downsample_factor=ds,
                   dtype=dtype)


@pytest.fixture(scope="module")
def weights():
    state = random_state(_model(), seed=81)
    params, stats = to_flax(state, "mobilenet")
    x = np.random.default_rng(82).standard_normal(
        (2,) + HW + (3,)).astype(np.float32)
    return state, {"params": params, "batch_stats": stats}, x


def _jax_eval(variables, x, ds, dtype):
    m = JaxDeepLab(num_classes=5, backbone="mobilenet", downsample_factor=ds,
                   dtype=dtype)
    return np.asarray(jax.jit(lambda v, a: m.apply(v, a, train=False))(
        variables, x), np.float32)


def _port_eval(state, x, ds, dtype=torch.float32):
    model = _model(ds, dtype)
    model.load_state_dict(state)
    with torch.inference_mode():
        y = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype))
    return y.float().permute(0, 2, 3, 1).numpy()


def test_block_plan_matches_jax():
    from cervical_tpu.models.backbones.mobilenetv2 import (
        INVERTED_RESIDUAL_SETTING as J_SETTING, _block_plan as j_plan)
    assert INVERTED_RESIDUAL_SETTING == J_SETTING
    for ds in (8, 16, 32):
        assert _block_plan(ds) == j_plan(ds), ds
    with pytest.raises(ValueError):
        _block_plan(4)


@pytest.mark.parametrize("ds", [16, 8])
def test_mobilenet_deeplab_matches_jax_f32(weights, ds):
    """Eval logits at ``test_deeplab_matches_jax_f32``'s limits.  At os8
    the last stages run dilation 2 and 4 (one stride-2 block becomes
    stride 1 with dilation 1, another with dilation 2)."""
    state, variables, x = weights
    ref = _jax_eval(variables, x, ds, jnp.float32)
    got = _port_eval(state, x, ds)
    print(f"\nmobilenet os{ds} f32: max abs {np.abs(got - ref).max():.3g} "
          f"of max |ref| {np.abs(ref).max():.3g}")
    assert got.shape == ref.shape == (2,) + HW + (5,)
    np.testing.assert_allclose(got, ref, atol=scaled_atol(ref), rtol=2e-3)


def test_mobilenet_deeplab_bf16_within_jax_drift(weights):
    """bf16 convs with fp32 BatchNorm statistics: the port's bf16 logits
    lie within twice the JAX package's own bf16-vs-f32 distance of JAX's
    bf16 logits (torch's and XLA's bf16 roundings differ about as much as
    bf16 does from f32)."""
    state, variables, x = weights
    j32 = _jax_eval(variables, x, 16, jnp.float32)
    j16 = _jax_eval(variables, x, 16, jnp.bfloat16)
    got = _port_eval(state, x, 16, torch.bfloat16)
    drift, dist = np.abs(j16 - j32).max(), np.abs(got - j16).max()
    print(f"\nmobilenet bf16: port vs JAX bf16 {dist:.4g}; JAX bf16 vs f32 "
          f"{drift:.4g}")
    assert np.isfinite(got).all()
    assert 0 < drift and dist <= 2 * drift


class _NoDropout(flax.linen.Module):
    rate: float

    @flax.linen.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def train_step(weights):
    """One unfrozen f32 train step, batch 2, on pre-augmented images, on
    both sides from the same weights; dropout off (flax's ``Dropout`` is
    identity while JAX runs, the port's dropouts get ``p = 0``).  Also the
    train-mode forward alone (quarter-resolution logits, as the step sees
    them)."""
    state, variables, _ = weights
    rng = np.random.default_rng(83)
    images = rng.random((2,) + HW + (3,)).astype(np.float32)
    labels = rng.integers(0, 6, (2,) + HW).astype(np.uint8)  # 5 = ignore
    jcfg = JCfg(data=JData(input_shape=HW), backbone="mobilenet",
                dtype="float32")
    pcfg = SegTrainConfig(data=SegDataConfig(input_shape=HW),
                          backbone="mobilenet", dtype="float32",
                          weights_init="none")
    mp = pytest.MonkeyPatch()
    mp.setattr(flax.linen, "Dropout", _NoDropout)
    try:
        model, tx = JT.build_model(jcfg), JT.make_optimizer(jcfg)
        jlogits, jstats = jax.jit(lambda v, a: model.apply(
            v, a, train=True, resize_logits=False,
            mutable=["batch_stats"]))(variables, images)
        p = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        bp, hp = JT._split_params(p)
        s0 = JT.TrainState(step=jnp.zeros((), jnp.int32), params=p,
                           batch_stats=jax.tree_util.tree_map(
                               jnp.asarray, variables["batch_stats"]),
                           opt_state={"backbone": tx.init(bp),
                                      "head": tx.init(hp)})
        s1, m = jax.jit(JT._make_train_body(jcfg, model, tx, False,
                                            pre_augmented=True))(
            s0, jnp.asarray(images), jnp.asarray(labels), None,
            jnp.float32(LR), jax.random.PRNGKey(0))
    finally:
        mp.undo()

    def port_state():
        st = PT.create_state(pcfg, device="cpu")
        st.model.load_state_dict(state)
        for mod in st.model.modules():
            if isinstance(mod, Dropout):
                mod.p = 0.0
        return st

    def port_forward(dtype):
        model = _model(16, dtype)
        model.load_state_dict(state)
        model.to(dtype).train()
        for mod in model.modules():
            if isinstance(mod, Dropout):
                mod.p = 0.0
        with torch.no_grad():
            y = model(torch.from_numpy(images).to(dtype).permute(0, 3, 1, 2),
                      resize_logits=False).permute(0, 2, 3, 1)
        return y.double().numpy(), model.state_dict()

    plogits, pstats = port_forward(torch.float32)
    p64, _ = port_forward(torch.float64)
    st = port_state()
    got = PT._make_train_body(pcfg, False, pre_augmented=True)(
        st, torch.from_numpy(images), torch.from_numpy(labels), None, LR)
    return {"jax_logits": np.asarray(jlogits),
            "jax_fwd_stats": deeplab_from_flax(
                _tree(variables["params"]), _tree(jstats["batch_stats"]),
                "mobilenet"),
            "port_logits": plogits, "port_fwd_stats": pstats,
            "port_logits_f64": p64,
            "jax_state": s1, "jax_metrics": {k: float(v) for k, v in m.items()},
            "port_state": st, "port_metrics": {k: float(v)
                                               for k, v in got.items()},
            "before": state}


def _stats_err(got, want):
    return max(float((got[n] - w).abs().max()) / max(float(w.abs().max()),
                                                     1e-30)
               for n, w in want.items() if "running" in n)


def test_mobilenet_train_forward_and_loss_match_jax(train_step):
    """The train-mode forward (batch statistics), the BatchNorm running
    stats it leaves and the step's loss bundle.  Batch statistics over 2
    images (the ASPP pooling branch normalises 2 values per channel)
    amplify f32 rounding: the port's f32 logits lie 1.6e-4 to 2.8e-4 of
    their largest magnitude from its float64 forward (by thread count),
    JAX's 5.4e-4.  So the port is held to 1e-3 of its own float64 forward,
    and to JAX's f32 forward at 2e-3 (the logits, each running stat to its tensor's largest
    magnitude); the losses to 1e-4 relative, the f-score to 1% (its 0.5
    threshold flips pixels whose probability is within rounding of it)."""
    r = train_step
    ref, got, f64 = r["jax_logits"], r["port_logits"], r["port_logits_f64"]
    scale = np.abs(f64).max()
    err = {"logits": float(np.abs(got - ref).max() / scale),
           "logits_vs_f64": float(np.abs(got - f64).max() / scale),
           "jax_logits_vs_f64": float(np.abs(ref - f64).max() / scale),
           "forward_stats": _stats_err(r["port_fwd_stats"],
                                       r["jax_fwd_stats"])}
    for k in ("loss", "main_loss", "f_score"):
        err[k] = abs(r["port_metrics"][k] - r["jax_metrics"][k]) / max(
            abs(r["jax_metrics"][k]), 1e-6)
    print("\nmobilenet train forward: " + ", ".join(
        f"{k} {v:.3g}" for k, v in err.items()))
    limits = {"logits": 2e-3, "logits_vs_f64": 1e-3, "forward_stats": 2e-3,
              "loss": 1e-4, "main_loss": 1e-4, "f_score": 1e-2}
    for k, t in limits.items():
        assert err[k] <= t, (k, err)


def test_mobilenet_train_step_matches_jax(train_step):
    """One Adam step, held as ``test_train_step_matches_jax_f32`` holds
    xception's: the running stats after the step to 2e-3 of each tensor's
    largest magnitude (as the forward's, above); the gradients (Adam's first moment is 0.1 x the
    gradient) to 15% global relative L2 of JAX's; at most 5% of the
    updated elements move the other way than JAX's (Adam's first step
    moves each by lr x sign(gradient))."""
    r = train_step
    js, st, before = r["jax_state"], r["port_state"], r["before"]
    want = deeplab_from_flax(_tree(js.params), _tree(js.batch_stats),
                             "mobilenet")
    sd = st.model.state_dict()
    err = {"stats": _stats_err(sd, want)}
    flips = moved = still = 0
    for n, _ in st.model.named_parameters():
        dg, dw = sd[n] - before[n], want[n] - before[n]
        moved += int((dw != 0).sum())
        flips += int(((torch.sign(dg) != torch.sign(dw)) & (dw != 0)).sum())
        still += int(((dg == 0) != (dw == 0)).sum())
    err["update_sign"] = flips / max(moved, 1)
    # taps of ASPP's dilated convs that see only padding at 4x4 get no
    # gradient: Adam leaves those elements on both sides (a few more, whose
    # gradient is zero on one side only, read 9.6e-5)
    err["moved_differently"] = still / moved
    names = {id(p): n for n, p in st.model.named_parameters()}
    num = den = 0.0
    for g in ("backbone", "head"):
        mu = deeplab_from_flax(_tree(js.opt_state[g].inner_state[1].mu),
                               None, "mobilenet")
        for p, s in st.opt_state[g].state.items():
            w = mu[names[id(p)]].reshape(p.shape).double()
            num += float(((s["exp_avg"].double() - w) ** 2).sum())
            den += float((w ** 2).sum())
    err["moments_l2"] = (num / den) ** 0.5
    print("\nmobilenet train step: " + ", ".join(
        f"{k} {v:.3g}" for k, v in err.items()))
    assert err["moved_differently"] <= 1e-3, err
    assert err["stats"] <= 2e-3, err
    assert err["moments_l2"] <= 0.15, err
    assert err["update_sign"] <= 0.05, err


def test_reference_init_reaches_depthwise_kernels():
    """``reference_weights_init`` walks ``modules()``: every conv kernel,
    the depthwise (C, 1, 3, 3) ones included, is redrawn from N(0, 0.02),
    every BatchNorm scale from N(1, 0.02)."""
    model = _model()
    PT.reference_weights_init(model, torch.Generator().manual_seed(0))
    kernels = {n: p for n, p in model.named_parameters() if p.ndim == 4}
    depthwise = [n for n, p in kernels.items() if p.shape[1] == 1
                 and p.shape[2] == 3]
    assert len(depthwise) == 17
    for n, p in kernels.items():
        assert abs(float(p.detach().std()) - 0.02) < 0.01, n
    for n in depthwise:
        assert abs(float(kernels[n].detach().std()) - 0.02) < 0.005, n


def _bubbliiiing_sd(seed):
    """A stand-in for ``mobilenet_v2.pth.tar``: the reference classifier's
    names and shapes — ``features.0``-``features.17`` as the port's
    backbone holds them, the 1280-wide ``features.18`` and the 1000-class
    ``classifier.1`` — with seeded values."""
    full = random_state(_model(), seed)
    sd = {k[len("backbone."):]: v for k, v in full.items()
          if k.startswith("backbone.")}
    g = torch.Generator().manual_seed(seed)
    sd["features.18.0.weight"] = 0.05 * torch.randn(1280, 320, 1, 1,
                                                    generator=g)
    for k in ("weight", "bias", "running_mean", "running_var"):
        sd[f"features.18.1.{k}"] = torch.rand(1280, generator=g) + 0.5
    sd["features.18.1.num_batches_tracked"] = torch.tensor(7)
    sd["classifier.1.weight"] = 0.01 * torch.randn(1000, 1280, generator=g)
    sd["classifier.1.bias"] = torch.zeros(1000)
    return sd


def test_load_pretrained_bubbliiiing_backbone(weights, tmp_path):
    """A backbone-only checkpoint in the reference's names loads key for
    key under ``backbone.`` (``features.18`` and ``classifier`` are skipped
    by name, the integer counters left alone), as the JAX package's
    ``convert_mobilenetv2`` + ``merge_into`` load it; the logits of the two
    loaded models agree at the f32 parity limits."""
    state, variables, x = weights
    sd = _bubbliiiing_sd(84)
    path = tmp_path / "mobilenet_v2.pth.tar"
    torch.save(sd, path)
    cfg = SegTrainConfig(data=SegDataConfig(input_shape=HW),
                         backbone="mobilenet", dtype="float32",
                         pretrained=str(path))
    model = _model()
    model.load_state_dict(state)
    logs = []
    PT.load_pretrained(cfg, model, log=logs.append)
    floats = [k for k, v in sd.items() if v.dtype.is_floating_point]
    want_loaded = sorted("backbone." + k for k in floats
                         if not k.startswith(("features.18.", "classifier.")))
    want_skipped = sorted("backbone." + k for k in floats
                          if k.startswith(("features.18.", "classifier.")))
    from cervical_tpu_torch.train import torch_import as TI
    model2 = _model()
    loaded, skipped = TI.load_into(model2, sd, "backbone")
    assert sorted(loaded) == want_loaded and sorted(skipped) == want_skipped
    assert logs == [f"pretrained {str(path)!r}: loaded {len(want_loaded)} "
                    f"arrays, skipped {len(want_skipped)} shape mismatches"]

    params, stats, missing = JTI.convert_mobilenetv2(
        {k: v.numpy() for k, v in sd.items()}, strict=False)
    assert not missing
    jvars, jloaded, jskipped = JTI.merge_into(
        jax.tree_util.tree_map(np.copy, variables), params, stats,
        scope="backbone")
    assert len(jloaded) == len(want_loaded) and not jskipped
    back = deeplab_from_flax(jvars["params"], jvars["batch_stats"],
                             "mobilenet")
    for k, v in model.state_dict().items():
        if v.dtype.is_floating_point:
            assert torch.equal(back[k], v), k
    ref = _jax_eval(jvars, x, 16, jnp.float32)
    got = _port_eval(model.state_dict(), x, 16)
    np.testing.assert_allclose(got, ref, atol=scaled_atol(ref), rtol=2e-3)


def test_bubbliiiing_names_cover_the_reference_scheme():
    """Every backbone tensor of the port is named as ``convert_mobilenetv2``
    reads it: the strict JAX converter finds no key missing and maps as
    many arrays as the port's backbone holds, for the stem and blocks
    1-17."""
    sd = {k[len("backbone."):]: v.numpy()
          for k, v in _model().state_dict().items()
          if k.startswith("backbone.") and v.dtype.is_floating_point}
    params, stats, missing = JTI.convert_mobilenetv2(sd, strict=True)
    assert not missing
    leaves = jax.tree_util.tree_leaves((params, stats))
    assert len(leaves) == len(sd)
    n_blocks = sum(n for _, _, n, _ in INVERTED_RESIDUAL_SETTING)
    assert {k.split(".")[1] for k in sd} == {str(i)
                                              for i in range(n_blocks + 1)}
