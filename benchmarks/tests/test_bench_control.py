"""``control.py`` reads each cell through the ``control_readings`` of the
runner its traffic mix names, and those readings, moved there from
``control.py``, keep their kinds and numbers (at a size the CPU holds)."""

import pytest

from benchmarks import control
from benchmarks.harness import serve_masks, spec as S, train_epochs
from benchmarks.tests.helpers import tiny_ctx

SPEC = S.load()
RUNNERS = {"xception-train": train_epochs, "mobilenet-train": train_epochs,
           "xception-serve": serve_masks, "mobilenet-serve": serve_masks}
SERVE_NUMBERS = ["mask_gap_max", "mask_gap_mean", "mask_gap_image",
                 "mask_gap_request", "mask_mismatch"]


@pytest.mark.parametrize("cell", sorted(RUNNERS))
def test_control_reads_the_cells_runner(cell):
    assert control.readings(SPEC, cell) is RUNNERS[cell].control_readings


def test_serve_readings():
    r = serve_masks.control_readings(tiny_ctx("mobilenet-serve"))
    assert list(r) == ["program", "control", "half_batch", "altered"]
    assert all(list(v) == SERVE_NUMBERS for v in r.values())
    assert r["program"]["mask_gap_image"] < r["altered"]["mask_gap_image"]


def test_train_readings():
    r = train_epochs.control_readings(tiny_ctx("mobilenet-train"))
    assert list(r) == ["program", "control", "half_batch", "witness_bf16",
                       "unchanged"]
    assert all(set(r["program"]) <= set(v) for v in r.values())
    assert r["program"]["change_gap"] < r["unchanged"]["change_gap"] == 1.0
