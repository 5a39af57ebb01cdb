"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import os
import re

import pytest

from benchmarks.harness import spec as S

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = S.load()


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmarks/run.py"]
    assert SPEC["paths"] == ["benchmarks"]
    assert 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(S.ROOT, "BENCHMARK.json")) < 64 * 1024


def test_entries_keys_and_names():
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source",
                              "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves", "workloads"}}
    for group, keys in allowed.items():
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
        for e in SPEC[group]:
            assert set(e) <= keys, (group, e)
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_enough():
    layers = {}
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        e2e = [m["name"] for m in S.end_to_end(SPEC, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        per = S.per_layer(SPEC, w["name"])
        assert per
        for m in per:  # each moves an end-to-end metric the cell reports
            assert m["moves"] in e2e
            layers.setdefault(m["layer"], set()).add(m["name"])
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


@pytest.mark.parametrize("what", sorted(S.all_files(SPEC)))
def test_named_file_exists(what):
    path = S.all_files(SPEC)[what]
    assert os.path.isfile(path), path
    if path.endswith(".py"):
        assert callable(S.reader(os.path.basename(path)[:-3]))
    else:
        with open(path) as f:
            json.load(f)


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_builds_the_program_config(name):
    from benchmarks.harness.common import seg_config
    conf = S.config(SPEC, name)
    cfg = seg_config(conf, 3)
    assert cfg.backbone == conf["model"]["backbone"]
    assert cfg.data.input_shape == tuple(conf["model"]["input_shape"])
    entry = [c for c in SPEC["configs"] if c["name"] == name][0]
    for key in entry["reduced"]:
        assert key in conf and key in conf["published"]


def test_runners_and_limits_found():
    for w in SPEC["workloads"]:
        tr = S.traffic(w["traffic"])
        assert hasattr(S.runner(tr["runner"]), "run")
        limits = S.limits(w["name"])
        assert all(v is None or v > 0 for v in limits.values())
