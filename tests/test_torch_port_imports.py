"""The port stands alone: importing every module of ``cervical_tpu_torch``
loads no JAX, flax, optax, orbax or ``cervical_tpu`` module; its entry
points (predictor, CLIs, trainer) default to CUDA; ``chip_smoke.py`` refuses
to run without a card or without the package."""

import inspect
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "cervical_tpu")

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
import cervical_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cervical_tpu_torch.__path__,
                                                "cervical_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def _clean_env():
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    return env


def test_port_imports_no_jax_or_reference_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 62, out.stdout


def test_port_sources_name_no_reference_package():
    """No source line of the port imports JAX or the JAX package."""
    pkg = os.path.join(REPO, "cervical_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            for line in open(os.path.join(root, f)):
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    mod = s.split()[1].split(".")[0]
                    assert mod not in FORBIDDEN, (f, s)


def test_entry_points_default_to_cuda():
    from cervical_tpu_torch.inference.predictor import SegPredictor
    from cervical_tpu_torch import predict, run_seg_protocol
    from cervical_tpu_torch.train.seg_trainer import SegTrainer, create_state
    assert inspect.signature(SegPredictor).parameters["device"].default == "cuda"
    assert "device" in predict._CLI_KEYS
    assert run_seg_protocol.parse_args([]).device == "cuda"
    for fn in (SegTrainer, create_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_training_slice_modules_import_alone():
    """Every module of the training and fit slices is importable without
    JAX, and the kernel module builds nothing at import."""
    code = (
        "import sys\n"
        "import cervical_tpu_torch.ops.warp as W, cervical_tpu_torch.ops.warp_xla,"
        " cervical_tpu_torch.ops.augment, cervical_tpu_torch.losses,"
        " cervical_tpu_torch.data.voc, cervical_tpu_torch.data.pipeline,"
        " cervical_tpu_torch.train.seg_trainer, cervical_tpu_torch.train.schedules,"
        " cervical_tpu_torch.train.checkpoints, cervical_tpu_torch.train.callbacks,"
        " cervical_tpu_torch.train.torch_import, cervical_tpu_torch.train_seg,"
        " cervical_tpu_torch.run_seg_protocol,"
        " cervical_tpu_torch.utils.seeding, cervical_tpu_torch.utils.logging\n"
        "assert W._lib_handle is None\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_fusion_entry_points_default_to_cuda():
    from cervical_tpu_torch import predict_fusion
    from cervical_tpu_torch.inference.fusion_predictor import FusionPredictor
    from cervical_tpu_torch.train.fusion_trainer import FusionTrainer
    from cervical_tpu_torch.train_fusion import build_config
    assert inspect.signature(FusionTrainer).parameters["device"].default == \
        "cuda"
    for fn in (FusionPredictor, FusionPredictor.from_npz):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert "device" in predict_fusion._CLI_KEYS
    assert build_config([])[-1] == "cuda"


def test_fusion_entry_points_refuse_without_card():
    """No fallback: on a host without CUDA the trainer and the predictor
    at their default device raise instead of running on the CPU."""
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the entry points run there")
    from cervical_tpu_torch.config import FusionTrainConfig
    from cervical_tpu_torch.inference.fusion_predictor import FusionPredictor
    from cervical_tpu_torch.train.fusion_trainer import FusionTrainer
    cfg = FusionTrainConfig(in_features=8, hidden=64)
    with pytest.raises((RuntimeError, AssertionError)):
        FusionTrainer(cfg)
    sd = FusionTrainer(cfg, device="cpu").init_state().model.state_dict()
    with pytest.raises((RuntimeError, AssertionError)):
        FusionPredictor(cfg, sd)


def test_fusion_slice_modules_import_alone():
    """Every module of the fusion slice is importable without JAX."""
    code = (
        "import sys\n"
        "import cervical_tpu_torch.models.fusion, cervical_tpu_torch.models.mae,"
        " cervical_tpu_torch.models.layers, cervical_tpu_torch.ops.graph,"
        " cervical_tpu_torch.data.masks, cervical_tpu_torch.data.splits,"
        " cervical_tpu_torch.data.fusion_data,"
        " cervical_tpu_torch.inference.fusion_predictor,"
        " cervical_tpu_torch.train.fusion_trainer,"
        " cervical_tpu_torch.predict_fusion, cervical_tpu_torch.train_fusion\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_refuses_without_card_or_package(tmp_path):
    """Without CUDA (this host) and from a directory holding only the
    script, chip_smoke.py exits non-zero and prints no result line."""
    import torch
    script = os.path.join(REPO, "chip_smoke.py")
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(script, lone)
    runs = [(lone, tmp_path)]
    if not torch.cuda.is_available():
        runs.append((script, REPO))
    env = _clean_env()
    env.pop("PYTHONPATH")
    for path, cwd in runs:
        out = subprocess.run([sys.executable, str(path)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0, out.stdout
        assert '"ok": true' not in out.stdout


def test_data_preparation_modules_import_alone():
    """The data-preparation slice imports without JAX, the native loader
    builds nothing at import, and the 5x augmentation defaults to CUDA."""
    code = (
        "import sys, inspect\n"
        "import cervical_tpu_torch.native as N, cervical_tpu_torch.ops.histeq,"
        " cervical_tpu_torch.tools.labelbox, cervical_tpu_torch.tools.labelme,"
        " cervical_tpu_torch.tools.voc_annotation,"
        " cervical_tpu_torch.tools.offline_aug as OA,"
        " cervical_tpu_torch.prepare_dataset, cervical_tpu_torch.utils.profiling\n"
        "assert N._lib is None and N._unavailable_reason is None\n"
        "for fn in (OA.augment_multimodal_5x, OA.write_multimodal_augmented):\n"
        "    assert inspect.signature(fn).parameters['device'].default == 'cuda'\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_parallel_modules_import_alone():
    """The parallel layer (``cervical_tpu_torch.parallel``: the mesh, the
    tensor-parallel layout, the pipeline) imports without JAX, joins no
    process group at import, exports the JAX package's names, and the
    trainers take a mesh."""
    code = (
        "import sys, inspect\n"
        "import torch.distributed as dist\n"
        "import cervical_tpu_torch.parallel as P, cervical_tpu_torch.parallel.mesh,"
        " cervical_tpu_torch.parallel.tp, cervical_tpu_torch.parallel.pipeline\n"
        "from cervical_tpu_torch.train.seg_trainer import SegTrainer\n"
        "from cervical_tpu_torch.train.fusion_trainer import FusionTrainer\n"
        "assert not dist.is_initialized()\n"
        "names = ('make_mesh', 'data_sharding', 'replicated_sharding',"
        " 'shard_batch', 'initialize_multihost', 'local_batch_slice',"
        " 'barrier', 'initialize_from_cli', 'is_primary',"
        " 'fusion_param_specs', 'place_params', 'pipeline_apply',"
        " 'stack_block_params', 'middle_flow_pipeline')\n"
        "assert all(callable(getattr(P, n)) for n in names)\n"
        "for cls in (SegTrainer, FusionTrainer):\n"
        "    assert inspect.signature(cls).parameters['mesh'].default is None\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
