"""Host side of the middle flow's kernels (``mf_dw_stencil``,
``mf_pw_gemm``), on the CPU.

The kernels run only on the card (``test_torch_port_cuda.py``); here the
launch plans their wrappers compute, the wrappers' refusals and the
K-major copy of the fold are held without a GPU.
"""

import re

import pytest
import torch

from cervical_tpu_torch.ops import middle_flow as MF


@pytest.mark.parametrize("m,k", [(8192, 728), (32768, 728), (105, 8),
                                 (105, 40)])
def test_plans_cover_every_row_and_column_and_fit(m, k):
    """os16 and os8 at full width, and the tests' ragged shapes: K padded
    to whole 64-wide k-tiles (a multiple of wgmma's k16), tiles covering
    every row and column, within the 227 KB a block may opt in to, TMA
    boxes 128 bytes wide (the swizzle's width) and at most 256 rows."""
    g = MF.pw_gemm_plan(m, k, k)
    assert g["k_pad"] % 16 == 0 and g["k_pad"] >= k > g["k_pad"] - 64
    assert g["k_pad"] == g["k_tiles"] * MF.BK
    gn, gm = g["grid"]
    assert gm * MF.GBM >= m > (gm - 1) * MF.GBM
    assert gn * MF.GBN >= k > (gn - 1) * MF.GBN
    # 4 stages of A's and W^T's boxes, barriers, 1024-byte alignment slack
    assert g["smem_bytes"] == 1024 + 4 * (256 + 184) * 64 * 2 + 16 * 4
    assert 48 * 1024 < g["smem_bytes"] <= 232448
    assert g["threads"] == 384
    for box in (g["box_a"], g["box_w"]):
        assert box[0] * 2 == 128 and box[1] <= 256
    if (m, k) == (8192, 728):  # os16
        assert g["k_pad"] == 768
        assert g["grid"] == (4, 32)  # 128 tiles: one wave on 132 SMs
    if m == 32768:
        assert g["grid"] == (4, 128)


@pytest.mark.parametrize("b,h,w,c,d", [
    (8, 32, 32, 728, 1),    # os16
    (8, 64, 64, 728, 2),    # os8 at dilation 2
    (3, 7, 5, 8, 2),        # the CUDA tests' ragged shapes
    (3, 13, 211, 40, 1),
    (2, 14, 37, 24, 3),     # residues with unequal row counts
])
def test_stencil_plan_covers_every_output(b, h, w, c, d):
    """Every (image, row, column, 8-channel chunk) belongs to exactly one
    thread: blocks of 8 chunks x 32 columns tile the channels and columns;
    for each residue r of h mod d, the segments of ``rows`` steps reach its
    last row and no segment starts past the tallest residue's rows."""
    p = MF.dw_stencil_plan(b, h, w, c, d)
    assert p["block"] == (MF.ST_CX, MF.ST_WY) and p["rows"] == MF.STENCIL_ROWS
    gx, gy, gz = p["grid"]
    ctiles = -(-(c // 8) // MF.ST_CX)
    assert gx % ctiles == 0 and gz == b and gy % d == 0
    assert ctiles * MF.ST_CX >= c // 8 > (ctiles - 1) * MF.ST_CX
    wtiles = gx // ctiles
    assert wtiles * MF.ST_WY >= w > (wtiles - 1) * MF.ST_WY
    segs = gy // d
    owner = {}
    for r in range(d):
        for seg in range(segs):
            t0 = seg * p["rows"]
            for t in range(t0, min(t0 + p["rows"], -(-(h - r) // d))):
                owner.setdefault(r + t * d, []).append((r, seg))
    assert sorted(owner) == list(range(h))
    assert all(len(v) == 1 for v in owner.values())
    assert (segs - 1) * p["rows"] < -(-h // d)  # no segment wholly idle
    if (b, h, w, c, d) == (8, 32, 32, 728, 1):
        assert p["grid"] == (12, 4, 8)  # 384 blocks of 256 threads


def test_plan_constants_match_the_source():
    """The plans mirror ``csrc/middle_flow.cu``'s constants."""
    src = MF.SOURCE.read_text()
    for name in ("BK", "THREADS", "GBM", "GBN", "GSTAGES", "ST_CX", "ST_WY"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == getattr(MF, name), name
    assert "smem < 1024 + GSTAGES * G_STAGE + 16 * GSTAGES" in src
    assert "const int segs = ((H + d - 1) / d + rows - 1) / rows;" in src


@pytest.mark.parametrize("m,k,n,match", [(105, 12, 16, "multiples of 8"),
                                         (105, 16, 12, "multiples of 8"),
                                         (0, 8, 8, "rows >= 1")])
def test_plan_refuses_shapes_the_kernel_does_not_take(m, k, n, match):
    with pytest.raises(ValueError, match=match):
        MF.pw_gemm_plan(m, k, n)


@pytest.mark.parametrize("case", ["cpu", "f16", "misaligned"])
def test_wrappers_refuse_before_building(case):
    """Both wrappers raise on a CPU tensor, an f16 input or a misaligned
    operand before they load (or build) the kernel library."""
    z = torch.zeros(1, 4, 4, 16)
    zb = z.to(torch.bfloat16)
    if case == "f16":
        z, zb = z.half(), z.half()
        err, match = TypeError, "bf16|float16"
    elif case == "misaligned":  # 4 bytes past an aligned start
        z = torch.zeros(1 + 256)[1:].view(1, 4, 4, 16)
        zb = torch.zeros(1 + 256, dtype=torch.bfloat16)[1:].view(1, 4, 4, 16)
        err, match = ValueError, "aligned"
    else:
        err, match = ValueError, "CUDA"
    with pytest.raises(err, match=match):
        MF.dw_stencil(z, torch.zeros(9, 16, dtype=torch.bfloat16),
                      torch.zeros(16), torch.zeros(16), 1)
    with pytest.raises(err, match=match):
        MF.pw_gemm(zb, torch.zeros(16, 16, dtype=torch.bfloat16),
                   torch.zeros(16))
    assert MF._lib_handle is None


def test_fold_keeps_a_k_major_copy():
    from cervical_tpu_torch.models.backbones.xception import XceptionBlock
    from torch_port_helpers import random_state

    class Mini(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.block4 = XceptionBlock(16, 16, 1)
            self.block5 = XceptionBlock(16, 16, 1)
    mini = Mini()
    mini.load_state_dict(random_state(mini, 3))
    f = MF.fold_middle_flow(mini, count=2)
    assert f["wpw_t"].shape == (2, 3, 16, 16) and f["wpw_t"].is_contiguous()
    assert torch.equal(f["wpw_t"], f["wpw"].transpose(-1, -2))
