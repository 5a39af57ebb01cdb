"""The training slice's host and model pieces against the JAX package, on
the CPU at small shapes: the segmentation losses (values and gradients),
the confusion matrix, the LR schedules, the label ops, train-mode DeepLab
(gradients and BatchNorm running stats), the Adam-state import, the data
feed, and ``SegTrainer`` end to end on the plain kernel versions."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cervical_tpu import losses as JL
from cervical_tpu.metrics import confusion_matrix_jax
from cervical_tpu.ops import image as JI
from cervical_tpu.train import schedules as JS
from cervical_tpu_torch import losses as PL
from cervical_tpu_torch.config import SegDataConfig, SegTrainConfig
from cervical_tpu_torch.metrics import confusion_matrix, fast_hist
from cervical_tpu_torch.ops import image as PI
from cervical_tpu_torch.train import schedules as PS

from torch_port_helpers import (random_state, to_flax,
                                two_torch_threads)  # noqa: F401

CLS_W = [1.0, 1.0, 5.0, 3.0, 4.0]


def _seg_case(seed, shape=(4, 6, 7), nc=5):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=shape + (nc,)).astype(np.float32)
    labels = rng.integers(0, nc + 1, shape).astype(np.int32)  # nc = ignore
    return logits, labels


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("focal", [True, False])
@pytest.mark.parametrize("dice", [True, False])
@pytest.mark.parametrize("weighted", ["none", "cls", "cls+rows"])
def test_seg_loss_bundle_matches_jax(focal, dice, weighted):
    """The bundle's (total, main, f_score) equal JAX's to f32 rounding
    (2e-5), with ignore pixels, class weights and a weight-0 row."""
    logits, labels = _seg_case(7)
    cls_w = None if weighted == "none" else CLS_W
    rows = np.array([1, 1, 0, 1], np.float32) if weighted == "cls+rows" \
        else None
    want = JL.seg_loss_bundle(jnp.asarray(logits), jnp.asarray(labels),
                              None if cls_w is None else jnp.asarray(cls_w),
                              5, focal=focal, dice=dice,
                              sample_weights=None if rows is None
                              else jnp.asarray(rows))
    got = PL.seg_loss_bundle(torch.from_numpy(logits),
                             torch.from_numpy(labels), cls_w, 5, focal=focal,
                             dice=dice, sample_weights=None if rows is None
                             else torch.from_numpy(rows))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["cross_entropy", "focal", "dice", "f_score"])
@pytest.mark.parametrize("rows", [False, True])
def test_separate_losses_match_jax(name, rows):
    logits, labels = _seg_case(8, (5, 6, 6))
    w = np.array([1, 1, 1, 0, 0], np.float32) if rows else None
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    if name in ("cross_entropy", "focal"):
        jf = getattr(JL, name + "_loss")
        tf = getattr(PL, name + "_loss")
        want = jf(jl, jnp.asarray(labels), jnp.asarray(CLS_W), 5,
                  sample_weights=jw)
        got = tf(tl, torch.from_numpy(labels), CLS_W, 5, sample_weights=tw)
    else:
        oh = np.array(JI.one_hot_with_ignore(jnp.asarray(labels), 5))
        np.testing.assert_array_equal(
            PI.one_hot_with_ignore(torch.from_numpy(labels), 5).numpy(), oh)
        jf = JL.dice_loss if name == "dice" else JL.f_score
        tf = PL.dice_loss if name == "dice" else PL.f_score
        want = jf(jl, jnp.asarray(oh), sample_weights=jw)
        got = tf(tl, torch.from_numpy(oh), sample_weights=tw)
    np.testing.assert_allclose(float(got), float(want), rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("resize", [False, True])
def test_seg_loss_bundle_grad_matches_jax(resize):
    """Gradients w.r.t. the logits (the train path: focal + dice with class
    weights, optionally with the in-bundle x4 upsample) to 1e-4."""
    rng = np.random.default_rng(3)
    hw = (5, 5) if not resize else (4, 5)
    logits = rng.normal(size=(2,) + hw + (5,)).astype(np.float32)
    out_hw = (16, 20) if resize else hw
    labels = rng.integers(0, 6, (2,) + out_hw).astype(np.int32)
    rt = out_hw if resize else None

    def jtotal(lg):
        return JL.seg_loss_bundle(lg, jnp.asarray(labels), jnp.asarray(CLS_W),
                                  5, resize_to=rt)[0]

    want = np.asarray(jax.grad(jtotal)(jnp.asarray(logits)))
    t = torch.from_numpy(logits).requires_grad_(True)
    PL.seg_loss_bundle(t, torch.from_numpy(labels), CLS_W, 5,
                       resize_to=rt)[0].backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-4, atol=1e-6)


def test_seg_loss_bundle_preds_and_resize_match_jax():
    rng = np.random.default_rng(11)
    logits = rng.normal(size=(2, 16, 16, 5)).astype(np.float32)
    labels = rng.integers(0, 6, (2, 64, 64)).astype(np.int32)
    want = JL.seg_loss_bundle(jnp.asarray(logits), jnp.asarray(labels),
                              jnp.asarray(CLS_W), 5, resize_to=(64, 64),
                              return_preds=True)
    got = PL.seg_loss_bundle(torch.from_numpy(logits),
                             torch.from_numpy(labels), CLS_W, 5,
                             resize_to=(64, 64), return_preds=True)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(float(g), float(w), rtol=2e-5, atol=1e-7)
    assert got[3].shape == (2, 64, 64)
    # argmax ties of the resized logits aside, the predictions agree
    assert (got[3].numpy() == np.asarray(want[3])).mean() > 0.999


# ---------------------------------------------------------------------------
# metrics, schedules, label ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nc", [2, 5])
def test_confusion_matrix_matches_jax(nc):
    rng = np.random.default_rng(nc)
    labels = rng.integers(0, nc + 2, (3, 17, 19))   # out-of-range dropped
    preds = rng.integers(0, nc, (3, 17, 19))
    want = np.asarray(confusion_matrix_jax(jnp.asarray(labels),
                                           jnp.asarray(preds), nc))
    got = confusion_matrix(torch.from_numpy(labels), torch.from_numpy(preds),
                           nc).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, fast_hist(labels, preds, nc))


@pytest.mark.parametrize("kind", ["cos", "step"])
@pytest.mark.parametrize("batch", [8, 16])
def test_schedules_match_jax(kind, batch):
    for backbone, opt in (("xception", "adam"), ("mobilenet", "sgd")):
        want = JS.adaptive_seg_lr(1e-4, 1e-6, batch, backbone=backbone,
                                  optimizer_type=opt)
        got = PS.adaptive_seg_lr(1e-4, 1e-6, batch, backbone=backbone,
                                 optimizer_type=opt)
        assert got == want
        js = JS.get_lr_scheduler(kind, *want, 200)
        ps = PS.get_lr_scheduler(kind, *got, 200)
        assert [ps(e) for e in range(200)] == [js(e) for e in range(200)]


@pytest.mark.parametrize("gamma,lr_step", [(0.8, 40), (0.5, 7)])
def test_fusion_step_decay_matches_jax(gamma, lr_step):
    js = JS.fusion_step_decay(1e-3, gamma=gamma, lr_step=lr_step)
    ps = PS.fusion_step_decay(1e-3, gamma=gamma, lr_step=lr_step)
    assert [ps(e) for e in range(200)] == [js(e) for e in range(200)]


def test_letterbox_label_matches_jax():
    rng = np.random.default_rng(5)
    for src in ((40, 64), (64, 48), (33, 33)):
        lbl = rng.integers(0, 5, src).astype(np.uint8)
        want = np.asarray(JI.letterbox_label(jnp.asarray(lbl), (64, 64)))
        got = PI.letterbox_label(torch.from_numpy(lbl), (64, 64)).numpy()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# train-mode DeepLab
# ---------------------------------------------------------------------------

def _flax_trees(state, rename):
    """A port module's ``state_dict`` -> float64 flax (params, batch_stats):
    OIHW/(C,1,3,3) kernels -> HWIO, BN weight/bias/running_* -> scale/bias/
    mean/var; ``rename`` maps a module path (list of names) to flax's."""
    params, stats = {}, {}
    for k, v in state.items():
        if k.endswith("num_batches_tracked"):
            continue
        *path, leaf = k.split(".")
        a = v.double().numpy()
        if leaf == "weight" and a.ndim == 4:
            tree, key, a = params, "kernel", a.transpose(2, 3, 1, 0)
        else:
            tree, key = {"weight": (params, "scale"),
                         "bias": (params, "bias"),
                         "running_mean": (stats, "mean"),
                         "running_var": (stats, "var")}[leaf]
        node = tree
        for part in rename(path):
            node = node.setdefault(part, {})
        node[key] = a
    return params, stats


_ASPP_NAMES = {"branch5_conv": ["branch5", "conv"],
               "branch5_bn": ["branch5", "bn"]}


def _aspp_rename(path):
    if path[0] in _ASPP_NAMES:
        return _ASPP_NAMES[path[0]]
    head = "fuse" if path[0] == "conv_cat" else path[0]
    return [head, {"0": "conv", "1": "bn"}[path[1]]]


def _block_rename(path):
    return ["skip_bn" if p == "skipbn" else p for p in path]


@pytest.mark.parametrize("case", ["block_conv_skip", "block_identity_skip",
                                  "aspp"])
def test_train_mode_gradients_match_jax_f64(case):
    """Train-mode forward and backward (BatchNorm on batch statistics) and
    the BatchNorm running-stat update of the model's building blocks — an
    Xception block with a strided conv skip, one with the identity skip at
    dilation 2, ASPP with its pooled branch (BN over the batch alone) —
    against the JAX modules with ``train=True``, both in float64, where
    rounding is out of the picture: outputs and input gradients to 1e-9 of
    their largest magnitude, param gradients to 1e-9 of the module's
    largest, running mean/var (the biased batch
    variance, flax's rule) to 1e-7 relative (flax's E[x²]-E[x]² variance
    cancels digits).  The whole model's f32 gradients are held against
    float64 and JAX in ``test_torch_port_train_step.py``."""
    import flax.linen
    from cervical_tpu.models.backbones.xception import XceptionBlock as JBlock
    from cervical_tpu.models.deeplab import ASPP as JASPP
    from cervical_tpu_torch.models.backbones.xception import XceptionBlock
    from cervical_tpu_torch.models.deeplab import ASPP
    f64 = torch.float64
    if case == "aspp":
        port, rename = ASPP(24, 16, rate=1, compute_dtype=f64), _aspp_rename
        jmod, shape = JASPP(16, rate=1, dtype=jnp.float64), (4, 5, 5, 24)
    elif case == "block_conv_skip":
        port = XceptionBlock(16, 32, 2, compute_dtype=f64)
        jmod, shape = JBlock(32, 2, dtype=jnp.float64), (4, 9, 9, 16)
        rename = _block_rename
    else:
        port = XceptionBlock(32, 32, 1, (2, 2, 2), compute_dtype=f64)
        jmod, shape = JBlock(32, 1, (2, 2, 2), dtype=jnp.float64), (4, 7, 7, 32)
        rename = _block_rename
    port = port.double().train()
    state = random_state(port, seed=71)
    port.load_state_dict(state)
    params, stats = _flax_trees(state, rename)
    rng = np.random.default_rng(72)
    x = rng.standard_normal(shape)

    def first(y):
        return y[0] if isinstance(y, tuple) else y

    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    yt = first(port(xt))
    r = rng.standard_normal(tuple(yt.permute(0, 2, 3, 1).shape))
    (yt.permute(0, 2, 3, 1) * torch.from_numpy(r)).sum().backward()
    with jax.enable_x64(True):
        def f(p, xx):
            y, upd = jmod.apply({"params": p, "batch_stats": stats}, xx,
                                train=True, mutable=["batch_stats"])
            return jnp.sum(first(y) * r), (first(y), upd["batch_stats"])

        (_, (yj, new_stats)), (gp, gx) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
        yj, gx = np.asarray(yj), np.asarray(gx)
        gp = jax.tree_util.tree_map(np.asarray, gp)
        new_stats = jax.tree_util.tree_map(np.asarray, new_stats)

    def close(got, want, what, scale=None):
        tol = 1e-9 * (scale or float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)

    close(yt.detach().permute(0, 2, 3, 1).numpy(), yj, "output")
    close(xt.grad.permute(0, 2, 3, 1).numpy(), gx, "input gradient")
    grads = {k: p.grad for k, p in port.named_parameters()}
    want_g, _ = _flax_trees(grads, rename)
    # a conv bias in front of a BN has a zero gradient (rounding noise on
    # both sides): param gradients are held to the module's largest one
    gmax = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(gp))
    for path, got in jax.tree_util.tree_leaves_with_path(want_g):
        want = gp
        for key in path:
            want = want[key.key]
        close(got, want, str(path), gmax)
    _, want_s = _flax_trees(port.state_dict(), rename)
    for path, got in jax.tree_util.tree_leaves_with_path(want_s):
        want = new_stats
        for key in path:
            want = want[key.key]
        np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-12,
                                   err_msg=str(path))


def test_dropout_is_seeded_and_freeze_stops_backbone_grads():
    from cervical_tpu_torch.models.deeplab import DeepLab
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    outs = []
    for _ in range(2):
        m = DeepLab(num_classes=5, dtype=torch.float32, dropout_seed=3)
        m.load_state_dict(random_state(m, seed=4))
        m.train()
        outs.append(m(x, resize_logits=False))
    assert torch.equal(outs[0], outs[1])
    m.eval()
    assert not torch.equal(m(x, resize_logits=False), outs[1])
    m.train()
    m(x, resize_logits=False, freeze_backbone=True).sum().backward()
    assert all(p.grad is None for p in m.backbone.parameters())
    assert m.cls_conv.weight.grad is not None


# ---------------------------------------------------------------------------
# Adam state import, optimizer
# ---------------------------------------------------------------------------

def test_adam_matches_optax_chain_with_coupled_l2():
    """make_optimizer's torch Adam (weight_decay = coupled L2) against the
    JAX package's optax chain over three steps."""
    from cervical_tpu.config import SegTrainConfig as JCfg
    from cervical_tpu.train import seg_trainer as JT
    from cervical_tpu_torch.train.seg_trainer import make_optimizer
    rng = np.random.default_rng(9)
    p0 = rng.standard_normal(7).astype(np.float32)
    grads = [rng.standard_normal(7).astype(np.float32) for _ in range(3)]
    jcfg = JCfg(weight_decay=0.01)
    tx = JT.make_optimizer(jcfg)
    jp = {"w": jnp.asarray(p0)}
    st = tx.init(jp)
    st.hyperparams["learning_rate"] = jnp.float32(1e-2)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer(SegTrainConfig(weight_decay=0.01), [tp])
    for g in grads:
        upd, st = tx.update({"w": jnp.asarray(g)}, st, jp)
        jp = {"w": jp["w"] + upd["w"]}
        tp.grad = torch.from_numpy(g.copy())
        opt.param_groups[0]["lr"] = 1e-2
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp["w"]),
                               rtol=1e-6, atol=1e-7)


def test_load_adam_state_round_trip():
    """optax-layout moments of both param groups land on the right torch
    params (every param covered), with the step count; count 0 leaves a
    group empty."""
    from cervical_tpu_torch.models.deeplab import DeepLab
    from cervical_tpu_torch.train.flax_import import load_adam_state
    from cervical_tpu_torch.train.seg_trainer import TrainState, create_state
    cfg = SegTrainConfig(dtype="float32", weights_init="none")
    st: TrainState = create_state(cfg, device="cpu")
    state = random_state(DeepLab(num_classes=5), seed=7)
    params, _ = to_flax(state)
    mu = jax.tree_util.tree_map(lambda a: np.asarray(a) * 2.0, params)
    nu = jax.tree_util.tree_map(lambda a: np.asarray(a) ** 2, params)
    head = lambda t: {k: v for k, v in t.items() if k != "backbone"}  # noqa
    load_adam_state(st.model, st.opt_state,
                    {"backbone": (0, {"backbone": mu["backbone"]},
                                  {"backbone": nu["backbone"]}),
                     "head": (3, head(mu), head(nu))})
    assert not st.opt_state["backbone"].state
    names = {id(p): n for n, p in st.model.named_parameters()}
    hs = st.opt_state["head"].state
    assert len(hs) == sum(1 for n in names.values()
                          if not n.startswith("backbone."))
    for p, s in hs.items():
        n = names[id(p)]
        torch.testing.assert_close(s["exp_avg"], state[n] * 2.0)
        torch.testing.assert_close(s["exp_avg_sq"], state[n] ** 2)
        assert float(s["step"]) == 3


# ---------------------------------------------------------------------------
# data feed and the trainer on the CPU
# ---------------------------------------------------------------------------

def test_host_local_batches_pads_with_weight0_rows():
    from cervical_tpu_torch.data.pipeline import device_prefetch, \
        host_local_batches
    from cervical_tpu_torch.data.voc import ArraySegDataset, BatchLoader
    rng = np.random.default_rng(0)
    ds = ArraySegDataset(rng.integers(0, 256, (10, 4, 4, 3)),
                         rng.integers(0, 5, (10, 4, 4)))
    loader = BatchLoader(ds, 4, shuffle=False, drop_last=False)
    batches = list(host_local_batches(loader, divisor=4, with_weights=True))
    assert [b[0].shape[0] for b in batches] == [4, 4, 4]
    np.testing.assert_array_equal(batches[-1][2], [1, 1, 0, 0])
    np.testing.assert_array_equal(batches[-1][0][2:], ds.images[[9, 9]])
    fed = list(device_prefetch(loader, "cpu", with_weights=True, divisor=4))
    assert all(isinstance(t, torch.Tensor) for b in fed for t in b)
    np.testing.assert_array_equal(fed[1][0].numpy(), batches[1][0])
    assert len(BatchLoader(ds, 4)) == 2 and len(loader) == 3


def test_voc_dataset_round_trip(tmp_path):
    from cervical_tpu_torch.data.voc import (BatchLoader, VOCSegDataset,
                                             make_synthetic_voc, read_split)
    root = make_synthetic_voc(str(tmp_path / "voc"), num_images=10, size=32)
    ids = read_split(root, "train")
    assert len(ids) == 8
    ds = VOCSegDataset(root, ids, stage_hw=(32, 32))
    imgs, lbls = next(iter(BatchLoader(ds, 4, seed=1, num_workers=2)))
    assert imgs.shape == (4, 32, 32, 3) and lbls.shape == (4, 32, 32)
    assert imgs.dtype == np.uint8 and int(lbls.max()) < 5


def test_seg_trainer_epoch_on_cpu():
    """SegTrainer(device="cpu") at 64² through the plain kernel versions:
    an unfrozen epoch, a frozen epoch (backbone params and Adam state
    bit-identical, BN running stats moving), finite losses, and an eval
    whose confusion matrix counts every real pixel once (ragged batch
    padded with weight-0 rows)."""
    from cervical_tpu_torch.data.voc import ArraySegDataset, BatchLoader
    from cervical_tpu_torch.train.seg_trainer import SegTrainer
    cfg = SegTrainConfig(data=SegDataConfig(input_shape=(64, 64),
                                            aug_backend="pallas"),
                         dtype="float32", pipeline_depth=2)
    rng = np.random.default_rng(0)
    train = ArraySegDataset(rng.integers(0, 256, (16, 64, 64, 3)),
                            rng.integers(0, 5, (16, 64, 64)))
    val = ArraySegDataset(rng.integers(0, 256, (6, 64, 64, 3)),
                          rng.integers(0, 5, (6, 64, 64)))
    tr = SegTrainer(cfg, device="cpu")
    val_loader = BatchLoader(val, 4, shuffle=False, drop_last=False)
    r1 = tr.run_epoch(BatchLoader(train, 8, seed=1), val_loader, 0, False,
                      tr.lr_schedule(8, 10)(0))
    assert np.isfinite([r1.train_loss, r1.val_loss]).all()
    model = tr.state.model
    bb = {n: p.detach().clone() for n, p in model.backbone.named_parameters()}
    adam = {id(p): {k: v.clone() for k, v in s.items()}
            for p, s in tr.state.opt_state["backbone"].state.items()}
    rm = model.backbone.bn1.running_mean.clone()
    r2 = tr.run_epoch(BatchLoader(train, 16, seed=2), val_loader, 1, True,
                      1e-4)
    assert np.isfinite([r2.train_loss, r2.val_loss]).all()
    for n, p in model.backbone.named_parameters():
        assert torch.equal(p, bb[n]), n
    for p, s in tr.state.opt_state["backbone"].state.items():
        assert all(torch.equal(v, adam[id(p)][k]) for k, v in s.items())
    assert not torch.equal(model.backbone.bn1.running_mean, rm)
    assert tr.state.step == 3
    miou = tr.evaluate_miou(val_loader)
    assert miou["hist"].sum() == 6 * 64 * 64
