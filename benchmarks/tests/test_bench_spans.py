"""The readers of the program's spans (``metrics/*`` with ``source:
program_span``) on the made-up span totals of each metric's case
(``span_cases/<metric>.json``): ``None`` where the records are empty or the
program has no spans, and each value by hand."""

import pytest

from benchmarks.harness import spec as S
from benchmarks.tests import contract as C

SPEC = S.load()
CASES = C.span_cases(S.ROOT)


def test_every_span_metric_has_a_case():
    C.span_cases_cover(SPEC, S.ROOT)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_values(monkeypatch, name):
    C.span_value(S.ROOT, name, monkeypatch)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_none_without_records(monkeypatch, name):
    C.span_none_without_records(S.ROOT, name, monkeypatch)


@pytest.mark.parametrize("name", sorted(n for n, c in CASES.items()
                                        if c["card_clock"]))
def test_reader_none_without_card_times(monkeypatch, name):
    """Spans timed on the host alone (a CPU run) give no card reading."""
    C.span_host_only(S.ROOT, name, monkeypatch)


@pytest.mark.parametrize("name", sorted(n for n, c in CASES.items()
                                        if not c["card_clock"]))
def test_host_reader_needs_no_card_times(monkeypatch, name):
    """A reader of host times reads the same without card times."""
    C.span_host_only(S.ROOT, name, monkeypatch)
