"""BENCHMARK.json against the benchmark's contract (``contract.py``), and
every file it names found by name."""

import pytest

from benchmarks.harness import spec as S
from benchmarks.harness.common import seg_config
from benchmarks.tests import contract as C

SPEC = S.load()
SEG_RUNNERS = ("train_epochs", "serve_masks")


def test_top_level_keys_and_command():
    C.top_level(SPEC, S.ROOT)


def test_entries_keys_and_names():
    C.entries(SPEC)


def test_every_cell_reports_enough():
    C.cells_report_enough(SPEC)


@pytest.mark.parametrize("what", sorted(S.all_files(SPEC)))
def test_named_file_exists(what):
    C.named_file(SPEC, S.ROOT, what)


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_builds_the_program_config(name):
    C.config_builds(SPEC, S.ROOT, name)


def _seg_configs():
    """The configurations that a DeepLab runner runs, with those runners."""
    out = {}
    for w in SPEC["workloads"]:
        runner = S.traffic(w["traffic"])["runner"]
        if runner in SEG_RUNNERS:
            out.setdefault(w["config"], set()).add(runner)
    return out


@pytest.mark.parametrize("name", sorted(_seg_configs()))
def test_seg_runner_builds_the_seg_config(name):
    """The DeepLab runners' program config is ``SegTrainConfig`` of the
    file's model and program sections, as ``common.seg_config`` builds it."""
    conf = S.config(SPEC, name)
    for runner in sorted(_seg_configs()[name]):
        cfg = S.runner(runner).program_config(conf, 3)
        assert cfg == seg_config(conf, 3)
        assert cfg.backbone == conf["model"]["backbone"]
        assert cfg.data.input_shape == tuple(conf["model"]["input_shape"])


def test_runners_and_limits_found():
    C.runners_and_limits(SPEC, S.ROOT)
