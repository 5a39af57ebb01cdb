"""The fusion trainer's parallel layouts (``FusionTrainer(mesh=...)``): data
parallelism on two gloo ranks and the tensor-parallel layout
(``parallel/tp.py``) on ``model=2`` (two ranks) and ``data=2 x model=2``
(four), against one process and against the JAX package's tensor-parallel
step on its virtual mesh (``tests/test_parallel_layouts.py:218-265``).
Widths 32 / 128 (every split dimension divides 2); the ranks run
``train_epoch``, the trainer's own loop, over a cohort of 8 patients at
batch 8: one step an epoch.

Limits: ranks of one layout hold bit-identical full params.  The
tensor-parallel epoch losses (the fused head's CE) against the replicated
epochs (and against JAX's tensor-parallel step on the same rows and MAE
masks) to rtol 1e-5 on step 1 and 1e-3 on step 2, as the JAX test holds
them; the params after two Adam steps at lr 1e-3 within 2 lr a step (Adam
moves an element by lr x the sign of a gradient that can be rounding
noise: the gates' last biases).  The data-parallel epochs with dropout on
(each rank's slice of the global masks) the same way."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flax.linen

from cervical_tpu.config import FusionTrainConfig as JCfg
from cervical_tpu.parallel import fusion_param_specs as j_specs
from cervical_tpu.parallel import make_mesh as j_make_mesh
from cervical_tpu.parallel import place_params as j_place
from cervical_tpu.train.fusion_trainer import FusionTrainer as JTrainer
from cervical_tpu_torch.config import FusionTrainConfig
from cervical_tpu_torch.data.fusion_data import make_synthetic_fusion
from cervical_tpu_torch.data.masks import generate_modal_masks
from cervical_tpu_torch.parallel import fusion_param_specs
from cervical_tpu_torch.train.flax_import import fusion_to_flax
from cervical_tpu_torch.train.fusion_trainer import FusionTrainer, build_model

from torch_port_helpers import run_ranks, two_torch_threads  # noqa: F401

CFG = dict(in_features=32, hidden=128, batch_size=8, epoch0_no_step=False)
LR = 1e-3


class _NoDropout(flax.linen.Module):
    rate: float

    @flax.linen.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.fixture(scope="module")
def small():
    return make_synthetic_fusion(num_patients=8, feature_dim=32, seed=1)


def _epoch_draws(epochs, n=8):
    """The rows and MAE masks of each epoch's one step, as a fresh trainer's
    ``train_epoch`` draws them (its shuffle, then its masks)."""
    tr = FusionTrainer(FusionTrainConfig(**CFG), device="cpu")
    out = []
    for _ in range(epochs):
        order = torch.randperm(n, generator=tr.shuffle_generator).numpy()
        out.append((order, generate_modal_masks(tr.mask_generator, n,
                                                4).numpy()))
    return out


@pytest.fixture(scope="module")
def jax_tp(small):
    """JAX's tensor-parallel trainer on (data 2, model 4) of the virtual
    mesh, dropout identity, from the port's seeded initial weights carried
    across (``fusion_to_flax``; ``place_params`` lays them out as JAX's
    ``init_state`` does), stepped on the rows and masks of the port's two
    epochs: the weights and the two steps' fused-head CE."""
    jcfg = JCfg(**CFG)
    mesh = j_make_mesh(8, model_parallel=4)
    state = FusionTrainer(FusionTrainConfig(**CFG), device="cpu"
                          ).init_state().model.state_dict()
    mp = pytest.MonkeyPatch()
    mp.setattr(flax.linen, "Dropout", _NoDropout)
    try:
        tr = JTrainer(jcfg, mesh=mesh)
        params = j_place(mesh, jax.tree_util.tree_map(
            jnp.asarray, fusion_to_flax(state)))
        st = {"params": params, "opt_state": tr.tx.init(params)}
        ces = []
        for order, masks in _epoch_draws(2):
            feats = {m: jnp.asarray(np.asarray(v, np.float32)[order])
                     for m, v in small["feats"].items()}
            st, m = tr.train_step_fn()(
                st, feats, jnp.asarray(np.asarray(small["labels"])[order]),
                jnp.asarray(masks), jnp.asarray(LR), jnp.asarray(True),
                jax.random.PRNGKey(3), jnp.ones(8, jnp.float32))
            ces.append(float(m["ce_all"]))
    finally:
        mp.undo()
    return state, ces


def _spec(small, **kw):
    return {"cfg": CFG, "lr": LR, "steps": 2, "cohort": small,
            "specs": fusion_param_specs(build_model(FusionTrainConfig(**CFG))),
            **kw}


def _one_process(small, state, no_dropout, epochs=2):
    tr = FusionTrainer(FusionTrainConfig(**CFG), device="cpu")
    st = tr.init_state()
    if state is not None:
        st.model.load_state_dict(state)
    if no_dropout:
        for m in st.model._dropouts:
            m.p = 0.0
    losses = [tr.train_epoch(st, small, e, LR)["loss"]
              for e in range(epochs)]
    return losses, st.model.state_dict()


def _check(outs, losses, state, label):
    for o in outs[1:]:
        for k, v in outs[0]["state"].items():
            assert torch.equal(v, o["state"][k]), (label, k)
        assert [r["loss"] for r in o["steps"]] == \
            [r["loss"] for r in outs[0]["steps"]]
    got = [r["loss"] for r in outs[0]["steps"]]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, losses)]
    d = max(float((outs[0]["state"][k] - v).abs().max())
            for k, v in state.items() if v.is_floating_point())
    print(f"\n{label}: epoch losses {got} vs {losses} (rel {rel}), "
          f"params {d:.3g}")
    assert rel[0] <= 1e-5 and rel[1] <= 1e-3, (label, rel)
    assert d <= 2 * 2 * LR + 1e-5, (label, d)


@pytest.fixture(scope="module")
def cohort():
    return make_synthetic_fusion(num_patients=20, feature_dim=32, seed=4)


@pytest.fixture(scope="module")
def dp_run(small, cohort, tmp_path_factory):
    """Two data-parallel ranks (4 rows of each batch), dropout on: two
    epochs over ``small``, then an epoch over ``cohort`` from fresh
    weights."""
    return run_ranks("fusion", 2, tmp_path_factory.mktemp("dp"),
                     _spec(small, epoch=cohort, epoch_lr=1e-5))


def test_data_parallel_step_equals_one_process(small, dp_run):
    """Dropout on: each rank hashes its rows of the global batch's masks."""
    losses, state = _one_process(small, None, False)
    _check(dp_run, losses, state, "data=2")
    assert dp_run[0]["placed"] == 0


@pytest.fixture(scope="module")
def tp_runs(small, jax_tp, tmp_path_factory):
    """model=2 on two ranks and data=2 x model=2 on four, from JAX's
    initial weights, dropout off (JAX's is identity)."""
    state = jax_tp[0]
    spec = _spec(small, model_parallel=2, state=state, no_dropout=True)
    return {world: run_ranks("fusion", world, tmp_path_factory.mktemp(
        f"tp{world}"), spec) for world in (2, 4)}, state


@pytest.mark.parametrize("world", [2, 4], ids=["model2", "data2_model2"])
def test_tensor_parallel_step_equals_replicated_and_jax(small, jax_tp,
                                                        tp_runs, world):
    runs, state = tp_runs
    outs = runs[world]
    losses, sd = _one_process(small, state, True)
    _check(outs, losses, sd, f"tp world {world}")
    jl = jax_tp[1]
    got = [r["loss"] for r in outs[0]["steps"]]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, jl)]
    print(f"against JAX's tensor-parallel step: {got} vs {jl} (rel {rel})")
    assert rel[0] <= 1e-5 and rel[1] <= 1e-3, rel
    assert outs[0]["placed"] >= 40 and outs[0]["sharded"] >= 40


def test_sharded_params_are_jaxs():
    """The port's specs shard exactly the params JAX's specs shard (mapped
    through ``fusion_to_flax``), on the matching axes: JAX's kernels are
    (in, out), the port's weights (out, in)."""
    model = build_model(FusionTrainConfig(**CFG))
    specs = fusion_param_specs(model)
    coded = {}
    for n, p in model.named_parameters():
        s = specs[n]
        code = 0.0 if not s else (1.0 if s[0] == "model" else 2.0)
        coded[n] = torch.full(p.shape, code)
    tree = fusion_to_flax(coded)
    want = j_specs(tree)
    n = 0
    for (path, leaf), (_, spec) in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0],
            jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]):
        code = float(np.asarray(leaf).flat[0])
        name = path[-1].key
        if spec == jax.sharding.PartitionSpec():
            assert code == 0.0, path
            continue
        n += 1
        # a torch (out, in) weight split on out is flax's kernel on its
        # last axis; a bias split on its only axis
        if name == "kernel":
            assert code == (1.0 if spec == jax.sharding.PartitionSpec(
                None, "model") else 2.0), (path, spec)
        else:
            assert code == 1.0, (path, spec)
    assert n >= 40


def test_data_parallel_epoch_equals_one_process(cohort, dp_run):
    """A whole epoch on two ranks (20 patients: 3 micro-batches of 8, the
    tail padded with weight-0 rows, 4 rows a rank): the same shuffle and
    masks on every rank, the predictions gathered, the report equal to the
    one process's (lr 1e-5, so that Adam's sign-of-noise steps stay below
    the loss's rounding)."""
    tr = FusionTrainer(FusionTrainConfig(**CFG), device="cpu")
    st = tr.init_state()
    want = tr.train_epoch(st, cohort, 1, 1e-5)
    outs = dp_run
    for o in outs:
        rep = o["report"]
        assert abs(rep["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        for k in ("acc_all", "acc_imgN", "acc_cli"):
            assert rep[k] == want[k], k
        np.testing.assert_array_equal(rep["confusion"], want["confusion"])
    d = max(float((outs[0]["epoch_state"][k] - v).abs().max())
            for k, v in st.model.state_dict().items()
            if v.is_floating_point())
    assert d <= 3 * 2 * 1e-5 + 1e-6, d


def test_vmap_folds_refuses_a_mesh(monkeypatch):
    """As in JAX: fold-stacked params cannot also be tensor-sharded."""
    from torch.distributed.device_mesh import DeviceMesh
    import cervical_tpu_torch.parallel.mesh as PM

    class FakeMesh(DeviceMesh):
        def __init__(self):
            pass
    monkeypatch.setattr(PM, "axis", lambda mesh, name: PM.Axis(None, 0, 1))
    monkeypatch.setattr("cervical_tpu_torch.train.fusion_trainer.graph_rule",
                        lambda device, mesh: False)
    tr = FusionTrainer(FusionTrainConfig(**CFG), device="cpu",
                       mesh=FakeMesh())
    with pytest.raises(ValueError, match="vmap_folds is incompatible"):
        tr.cross_validate({"labels": np.zeros(4, int)}, vmap_folds=True)
