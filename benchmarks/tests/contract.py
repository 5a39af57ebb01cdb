"""The benchmark's contract as checks of ``(spec, root)``: ``BENCHMARK.json``
and every file it names, found by name under the checkout ``root``.  The
tests run them over the real benchmark, and over a made-up copy that adds
a configuration of another model family (``helpers.make_madeup``), to show
that such a configuration, its runner, its cell and a span metric need
new files and entries only.  Each check raises ``AssertionError``."""

from __future__ import annotations

import collections
import glob
import json
import os
import re

import pytest

from benchmarks.harness import spec as S

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
RUNNER_HOOKS = ("run", "program_config", "control_readings")

# the fields of the program's ``profiling.SpanTotal``
SpanTotal = collections.namedtuple("SpanTotal", "count host_s device_s parent")


def top_level(spec: dict, root: str) -> None:
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "benchmarks/run.py"]
    assert spec["paths"] == ["benchmarks"]
    assert 1 <= spec["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(root, "BENCHMARK.json")) < 64 * 1024


def entries(spec: dict) -> None:
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source",
                              "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves", "workloads"}}
    for group, keys in allowed.items():
        names = [e["name"] for e in spec[group]]
        assert len(names) == len(set(names))
        for e in spec[group]:
            assert set(e) <= keys, (group, e)
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def cells_report_enough(spec: dict) -> None:
    for w in spec["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        e2e = [m["name"] for m in S.end_to_end(spec, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        per = S.per_layer(spec, w["name"])
        assert per, w["name"]
        for m in per:  # each moves an end-to-end metric the cell reports
            assert m["moves"] in e2e, (w["name"], m["name"])
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}


def named_file(spec: dict, root: str, what: str) -> None:
    """The file ``what`` of ``S.all_files`` exists and parses."""
    path = S.all_files(spec, root)[what]
    assert os.path.isfile(path), path
    if path.endswith(".py"):
        assert callable(S.reader(os.path.basename(path)[:-3], root))
    else:
        with open(path) as f:
            json.load(f)


def runners_and_limits(spec: dict, root: str) -> None:
    """Each cell's runner has its three hooks; its limits are positive."""
    for w in spec["workloads"]:
        name = S.traffic(w["traffic"], root)["runner"]
        mod = S.runner(name, root)
        for hook in RUNNER_HOOKS:
            assert callable(getattr(mod, hook, None)), (name, hook)
        limits = S.limits(w["name"], root)
        assert all(v is None or v > 0 for v in limits.values())


def config_builds(spec: dict, root: str, name: str) -> None:
    """The configuration ``name`` builds its program config through the
    runner of every cell that runs it; what it cut is what it publishes."""
    conf = S.config(spec, name, root)
    cells = [w for w in spec["workloads"] if w["config"] == name]
    assert cells, name
    for w in cells:
        mod = S.runner(S.traffic(w["traffic"], root)["runner"], root)
        assert hasattr(mod, "program_config"), (w["name"], mod.__name__)
        assert mod.program_config(conf, 3) is not None
    entry = [c for c in spec["configs"] if c["name"] == name][0]
    for key in entry["reduced"]:
        assert key in conf and key in conf["published"], key


def span_metrics(spec: dict) -> list:
    return sorted(m["name"] for m in spec["per_layer"]
                  if m["source"] == "program_span")


def span_cases(root: str) -> dict:
    """Per metric, the case of ``benchmarks/tests/span_cases/<metric>.json``:
    made-up span ``totals``, the value the reader should ``want`` from
    them, and whether it reads the card's clock (``card_clock``)."""
    out = {}
    for path in sorted(glob.glob(os.path.join(
            root, "benchmarks", "tests", "span_cases", "*.json"))):
        with open(path) as f:
            out[os.path.basename(path)[:-len(".json")]] = json.load(f)
    return out


def span_cases_cover(spec: dict, root: str) -> None:
    """Every program-span metric has a case, and every case names one."""
    cases = span_cases(root)
    assert span_metrics(spec) == sorted(cases)
    for name, case in cases.items():
        assert {"totals", "want", "card_clock"} <= set(case) <= \
            {"totals", "want", "card_clock", "about"}, name
        assert isinstance(case["card_clock"], bool), name


def _totals(case: dict) -> dict:
    return {k: SpanTotal(**t) for k, t in case["totals"].items()}


def _set_totals(monkeypatch, totals: dict) -> None:
    from cervical_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "span_totals", lambda: dict(totals),
                        raising=False)


def span_value(root: str, name: str, monkeypatch) -> None:
    """The reader gives the case's value from the case's totals."""
    case = span_cases(root)[name]
    _set_totals(monkeypatch, _totals(case))
    assert S.reader(name, root)(None, {}) == pytest.approx(case["want"])


def span_none_without_records(root: str, name: str, monkeypatch) -> None:
    from cervical_tpu_torch.utils import profiling
    _set_totals(monkeypatch, {})
    assert S.reader(name, root)(None, {}) is None
    # a program with no spans at all, as the commit before them
    monkeypatch.delattr(profiling, "span_totals")
    assert S.reader(name, root)(None, {}) is None


def span_host_only(root: str, name: str, monkeypatch) -> None:
    """Spans timed on the host alone (a CPU run): a reader of the card's
    clock gives nothing, a reader of the host's the case's value."""
    case = span_cases(root)[name]
    _set_totals(monkeypatch, {k: t._replace(device_s=None)
                              for k, t in _totals(case).items()})
    got = S.reader(name, root)(None, {})
    if case["card_clock"]:
        assert got is None
    else:
        assert got == pytest.approx(case["want"])


def all_checks(spec: dict, root: str, monkeypatch) -> None:
    """Every check above, over every name it takes."""
    top_level(spec, root)
    entries(spec)
    cells_report_enough(spec)
    for what in S.all_files(spec, root):
        named_file(spec, root, what)
    runners_and_limits(spec, root)
    for c in spec["configs"]:
        config_builds(spec, root, c["name"])
    span_cases_cover(spec, root)
    for name in span_cases(root):
        with monkeypatch.context() as mp:
            span_value(root, name, mp)
        with monkeypatch.context() as mp:
            span_none_without_records(root, name, mp)
        with monkeypatch.context() as mp:
            span_host_only(root, name, mp)
