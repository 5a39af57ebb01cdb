"""The port's process-group layer (``cervical_tpu_torch/parallel/mesh.py``):
the launch flags against the JAX package's ``initialize_from_cli`` on the
same argv lists, the global-batch statistics of ``ops.conv.BatchNorm2d``,
the loss bundle and the dropouts across two gloo ranks against one process
on the whole batch, and ``python -m cervical_tpu_torch.train_seg`` launched
as two processes on the CPU.  The ranks are processes of
``tests/_torch_port_parallel_worker.py`` joined by a ``FileStore``."""

import json
import os
import subprocess
import sys

import pytest
import torch

import cervical_tpu.parallel.mesh as JM
from cervical_tpu_torch import losses
from cervical_tpu_torch.models.layers import Dropout, KeyedDropout
from cervical_tpu_torch.ops.conv import BatchNorm2d
from cervical_tpu_torch.parallel import mesh as PM

from torch_port_helpers import (fit_overrides, run_ranks,
                                two_torch_threads)  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARGVS = [
    [],
    ["--backbone", "mobilenet"],
    ["--multihost", "false", "--epochs", "3"],
    ["--multihost=no"],
    ["--coordinator", "h:1234", "--num_processes", "2", "--process_id", "1",
     "--epochs", "3"],
    ["--x", "1", "--coordinator=h:1", "--num_processes=4", "--process_id=3"],
    ["--coordinator", "h:1"],
    ["--num_processes", "2", "--process_id", "0"],
    ["--process_id"],
]


def _run_cli(fn, argv):
    try:
        return "ok", fn(list(argv))
    except SystemExit as e:
        return "exit", str(e)


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) or "none"
                                             for a in ARGVS])
def test_initialize_from_cli_matches_jax(argv, monkeypatch):
    """Same remaining argv, same (coordinator, processes, id) handed to the
    group's initialiser, same refusals with the same message."""
    jcalls, pcalls = [], []
    monkeypatch.setattr(JM, "initialize_multihost",
                        lambda *a: jcalls.append(a))
    monkeypatch.setattr(PM, "initialize_multihost",
                        lambda *a, **k: pcalls.append(a))
    want = _run_cli(JM.initialize_from_cli, argv)
    got = _run_cli(lambda a: PM.initialize_from_cli(a, device="cpu"), argv)
    assert got == want
    assert pcalls == jcalls


def test_multihost_true_reads_torchrun_env(monkeypatch):
    """``--multihost true``: JAX auto-detects a pod; the port reads
    torchrun's ``env://`` variables, this rank's card ``LOCAL_RANK``."""
    import jax
    jcalls, pcalls = [], []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda *a, **k: jcalls.append(a))
    monkeypatch.setattr(PM, "initialize_multihost",
                        lambda *a, **k: pcalls.append((a, k)))
    for k, v in {"RANK": "3", "WORLD_SIZE": "4", "MASTER_ADDR": "h",
                 "MASTER_PORT": "1", "LOCAL_RANK": "1"}.items():
        monkeypatch.setenv(k, v)
    argv = ["--multihost", "true", "--epochs", "2"]
    assert JM.initialize_from_cli(argv) == ["--epochs", "2"]
    assert PM.initialize_from_cli(argv, device="cpu") == ["--epochs", "2"]
    assert jcalls == [()]
    assert pcalls == [(("env://", 4, 3), {"device": "cpu"})]
    pcalls.clear()
    PM.initialize_from_cli(argv, device="cuda")
    assert pcalls[0][1] == {"device": "cuda:1"}
    monkeypatch.delenv("MASTER_PORT")
    with pytest.raises(SystemExit, match="MASTER_PORT"):
        PM.initialize_from_cli(argv, device="cpu")


def test_single_process_layer():
    """Without a process group: rank 0 is primary, the barrier is a no-op,
    a mesh cannot be made, and the one-process slice is the whole batch."""
    assert PM.is_primary()
    PM.barrier("nothing")
    with pytest.raises(RuntimeError, match="process group"):
        PM.make_mesh()
    assert PM.local_batch_slice(8) == slice(0, 8)
    t = torch.ones(3)
    assert PM.global_sums(None, t)[0] is t
    assert PM.data_sharding(None, 3) == ("data", None, None)
    assert PM.replicated_sharding(None) == ()


def test_set_data_axis_reaches_the_layers():
    """``set_data_axis`` hands the axis to every module that takes one
    (BatchNorm, both dropouts, ``FusionMAE``) and to no other; None takes
    it back."""
    from cervical_tpu_torch.models.fusion import FusionMAE
    model = torch.nn.Sequential(BatchNorm2d(3), Dropout(0.5),
                                KeyedDropout(0.5), torch.nn.Linear(2, 2),
                                FusionMAE(in_features=8, hidden=64))
    a = PM.Axis(None, 1, 2)
    PM.set_data_axis(model, a)
    takers = [m for m in model.modules()
              if isinstance(m, (BatchNorm2d, Dropout, KeyedDropout,
                                FusionMAE))]
    assert len(takers) > 4
    assert all(m.data_axis is a for m in takers)
    assert not any("data_axis" in vars(m) for m in model.modules()
                   if m not in takers)
    PM.set_data_axis(model, None)
    assert all(m.data_axis is None for m in takers)


# -- two gloo ranks against one process -------------------------------------------

BN_CASES = [("f64", torch.float64, torch.contiguous_format),
            ("f64_channels_last", torch.float64, torch.channels_last),
            ("bf16_channels_last", torch.bfloat16, torch.channels_last)]


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    g = torch.Generator().manual_seed(0)
    spec = {"x": torch.randn(8, 6, 5, 7, generator=g, dtype=torch.float64)
            * 3 + 1,
            "g": torch.randn(8, 6, 5, 7, generator=g, dtype=torch.float64),
            "w": torch.rand(6, generator=g) + 0.5,
            "b": torch.randn(6, generator=g), "momentum": 0.1,
            "bn_cases": BN_CASES,
            "logits": torch.randn(8, 4, 4, 5, generator=g),
            "seg_labels": torch.randint(0, 6, (8, 16, 16), generator=g),
            "cw": torch.tensor([1.0, 1, 5, 3, 4]),
            "sw": torch.tensor([1.0, 1, 0, 1, 1, 1, 0, 1]), "focal": True,
            "shape": (4, 3, 5, 6)}
    outs = run_ranks("units", 2, tmp_path_factory.mktemp("units"), spec)
    return spec, outs


def _one_process_bn(spec, dtype, fmt):
    bn = BatchNorm2d(6, momentum=spec["momentum"]).to(dtype).train()
    with torch.no_grad():
        bn.weight.copy_(spec["w"])
        bn.bias.copy_(spec["b"])
    x = spec["x"].to(dtype).contiguous(memory_format=fmt).detach()
    x.requires_grad_(True)
    y = bn(x)
    (y.double() * spec["g"]).sum().backward()
    return {"y": y.detach(), "x_grad": x.grad, "w_grad": bn.weight.grad,
            "b_grad": bn.bias.grad, "running_mean": bn.running_mean,
            "running_var": bn.running_var}


@pytest.mark.parametrize("case", BN_CASES, ids=[c[0] for c in BN_CASES])
def test_batchnorm_global_batch_statistics(units, case):
    """Train mode on two ranks' halves equals one process on the whole
    batch: outputs, input gradients, the affine's gradients (summed over
    the ranks, divided by 2, as the trainer's all-reduce does) and flax's
    running stats; in f64 to 1e-12 of each tensor's scale, in bf16 (f32
    statistics) to one bf16 step."""
    spec, outs = units
    name, dtype, fmt = case
    want = _one_process_bn(spec, dtype, fmt)
    tol = 1e-12 if dtype == torch.float64 else 2.0 ** -7
    for k, v in want.items():
        got = torch.cat([o[name][k] for o in outs]) if k in ("y", "x_grad") \
            else outs[0][name][k]
        if k not in ("y", "x_grad"):
            assert torch.equal(got, outs[1][name][k]), k
        err = float((got.double() - v.double()).abs().max())
        assert err <= tol * max(float(v.double().abs().max()), 1.0), (k, err)


def test_loss_bundle_is_the_global_batch_loss(units):
    """The focal + dice + f-score bundle with sample weights on two ranks'
    halves (its sums in one all-reduce) equals one process on the whole
    batch, and so do the logits' gradients (each rank's divided by 2):
    not a mean of per-rank dice."""
    spec, outs = units
    lg = spec["logits"].clone().requires_grad_(True)
    total, main, fs = losses.seg_loss_bundle(
        lg, spec["seg_labels"], spec["cw"], 5, sample_weights=spec["sw"],
        focal=True, resize_to=(16, 16))
    total.backward()
    for o in outs:
        for k, v in (("total", total.detach()), ("main", main.detach()),
                     ("fs", fs)):
            assert abs(float(o["bundle"][k]) - float(v)) <= 1e-6 * abs(
                float(v)), k
    got = torch.cat([o["bundle"]["grad"] for o in outs])
    assert float((got - lg.grad).abs().max()) <= 1e-6 * float(
        lg.grad.abs().max())
    half = [losses.seg_loss_bundle(spec["logits"][r * 4:(r + 1) * 4],
                                   spec["seg_labels"][r * 4:(r + 1) * 4],
                                   spec["cw"], 5,
                                   sample_weights=spec["sw"][r * 4:(r + 1) * 4],
                                   resize_to=(16, 16))[0] for r in range(2)]
    assert abs(float(sum(half)) / 2 - float(total.detach())) > 1e-4


def test_dropout_masks_are_the_global_batchs_rows(units):
    """Each rank's seg ``Dropout`` mask and ``KeyedDropout`` mask are its
    rows of the one-process masks on the global batch."""
    spec, outs = units
    x = torch.ones((8,) + spec["shape"][1:])
    d = Dropout(0.5, seed=7).train()
    k = KeyedDropout(0.5, layer=3).train()
    k.key = 12345
    assert torch.equal(torch.cat([o["dropout"] for o in outs]), d(x))
    assert torch.equal(torch.cat([o["keyed"] for o in outs]), k(x))
    assert not torch.equal(outs[0]["dropout"], outs[1]["dropout"])


# -- the CLI as two processes --------------------------------------------------------

def test_train_seg_cli_two_processes(tmp_path):
    """``python -m cervical_tpu_torch.train_seg --device cpu --coordinator
    file://... --num_processes 2 --process_id I``, one epoch at 32² on a
    synthetic VOC: both exit 0 with the same epoch line; only process 0
    writes files (each was given its own ``--save_dir``)."""
    from cervical_tpu_torch.data.voc import make_synthetic_voc

    root = make_synthetic_voc(str(tmp_path / "voc"), num_images=20, size=32)
    store = "file://" + str(tmp_path / "store")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for r in range(2):
        over = fit_overrides(root, str(tmp_path / f"logs{r}"), 32,
                             unfreeze_epoch=1, predictor_eval=False)
        argv = ["--device", "cpu", "--coordinator", store,
                "--num_processes", "2", f"--process_id={r}"]
        for k, v in over.items():
            argv += [f"--{k}", v if isinstance(v, str) else json.dumps(v)]
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cervical_tpu_torch.train_seg"] + argv,
            cwd=str(tmp_path), env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    lines = [[ln.split("(")[0] for ln in log.splitlines()
              if ln.startswith("Epoch 1/1")] for log in logs]
    assert len(lines[0]) == 1 and lines[0] == lines[1], lines
    assert "data parallel: 2 ranks" in logs[0]
    names = set(os.listdir(tmp_path / "logs0"))
    assert {"last_epoch_weights", "epoch_loss.txt", "model_graph.txt"} \
        <= names, names
    assert not (tmp_path / "logs1").exists()
