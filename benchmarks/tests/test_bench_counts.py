"""The work counted from shapes: model FLOPs and K4's bound."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmarks.reference.model import DeepLab
from benchmarks.rooflines import flops, k4, peaks


@pytest.mark.parametrize("backbone,gflop", [("xception", 165.506793472),
                                            ("mobilenet", 52.487684096)])
def test_forward_flops(backbone, gflop):
    got = flops.forward(backbone, 5, (512, 512))
    assert got / 1e9 == pytest.approx(gflop, rel=1e-12)
    with torch.device("meta"):
        m = DeepLab(backbone, 5).eval()
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            m(torch.zeros(1, 3, 512, 512))
    assert fc.get_total_flops() == got


@pytest.mark.parametrize("backbone", ["xception", "mobilenet"])
def test_train_flops_are_three_forwards_less_the_stem_input_gradient(
        backbone):
    f = flops.forward(backbone, 5, (512, 512))
    t = flops.train_step(backbone, 5, (512, 512))
    stem = 2 * 256 * 256 * 32 * 27  # the stride-2 3x3 conv, 3 -> 32
    assert t == 3 * f - stem


def test_k4_bound():
    s, by = k4.bound_s(8, 32, 32)
    assert s * 1e3 == pytest.approx(0.507, abs=5e-4)
    assert by == "operations"
    assert peaks()["bf16_flops"] == 989e12
