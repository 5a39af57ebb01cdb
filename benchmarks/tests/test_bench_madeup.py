"""A configuration of another model family, its runner, its cell, its
limits and a program-span metric take new files and entries only: a
made-up benchmark (``helpers.make_madeup``: the real one copied, with the
fusion classifier's made-up cell from ``madeup/`` added) passes every
contract check, leaves the real benchmark as it was, and fails a check
without its span case or its runner's ``program_config``."""

import hashlib
import os

import pytest

from benchmarks import control
from benchmarks.harness import spec as S
from benchmarks.tests import contract as C
from benchmarks.tests.helpers import make_madeup

RUNNER = os.path.join("benchmarks", "harness", "cv_groups_madeup.py")


def _digest() -> str:
    """Every file of the real benchmark, ``BENCHMARK.json`` with it."""
    h = hashlib.sha256()
    paths = [os.path.join(S.ROOT, "BENCHMARK.json")]
    for d, dirs, files in os.walk(os.path.join(S.ROOT, "benchmarks")):
        dirs[:] = sorted(x for x in dirs if x != "__pycache__")
        paths += [os.path.join(d, f) for f in sorted(files)]
    for p in paths:
        h.update(os.path.relpath(p, S.ROOT).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _without(root: str, rel: str, hook: str) -> None:
    """The file ``rel`` under ``root`` with its function ``hook`` renamed."""
    path = os.path.join(root, rel)
    with open(path) as f:
        src = f.read()
    assert f"def {hook}(" in src
    with open(path, "w") as f:
        f.write(src.replace(f"def {hook}(", f"def _{hook}("))


def test_madeup_benchmark_passes_every_check(tmp_path, monkeypatch):
    before = _digest()
    root = make_madeup(str(tmp_path))
    spec = S.load(root)
    assert "fusion-madeup" in {w["name"] for w in spec["workloads"]}
    assert "epoch_ms.madeup" in C.span_metrics(spec)
    cfg = S.runner("cv_groups_madeup", root).program_config(
        S.config(spec, "fusion-mae-madeup", root), 3)
    assert type(cfg).__name__ == "FusionTrainConfig"
    C.all_checks(spec, root, monkeypatch)
    assert _digest() == before


def test_madeup_without_its_span_case_fails(tmp_path):
    root = make_madeup(str(tmp_path))
    os.remove(os.path.join(root, "benchmarks", "tests", "span_cases",
                           "epoch_ms.madeup.json"))
    with pytest.raises(AssertionError):
        C.span_cases_cover(S.load(root), root)


def test_madeup_runner_without_program_config_fails(tmp_path):
    root = make_madeup(str(tmp_path))
    _without(root, RUNNER, "program_config")
    spec = S.load(root)
    with pytest.raises(AssertionError):
        C.config_builds(spec, root, "fusion-mae-madeup")
    with pytest.raises(AssertionError):
        C.runners_and_limits(spec, root)


def test_control_takes_the_madeup_runners_readings(tmp_path):
    root = make_madeup(str(tmp_path))
    read = control.readings(S.load(root), "fusion-madeup", root)
    assert read(None) == {"program": {"loss_gap": 0.0}}


def test_control_refuses_a_runner_without_readings(tmp_path):
    root = make_madeup(str(tmp_path))
    _without(root, RUNNER, "control_readings")
    with pytest.raises(LookupError, match="cv_groups_madeup"):
        control.readings(S.load(root), "fusion-madeup", root)
