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


# ---------------------------------------------------------------------------
# The f32 instances: mf_dw_stencil_f32 (the stencil's plan, above) and
# mf_pw_gemm_f32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [16, 728])
@pytest.mark.parametrize("m", [1, 16, 8192, 32768])
def test_f32_plan_covers_every_row_and_column_and_fits(m, k):
    """One block per 128 x 128 output tile covering every row and column
    (K = N), K in whole k-tiles of 8 (no ragged k-tile: K is a multiple of
    8), two buffers of A's and W^T's transposed k-tiles within the 227 KB a
    block may opt in to (and under the 48 KB default), rows of A, W^T and
    the output 16-byte aligned for the kernel's 16-byte loads and stores,
    256 threads of 8 x 8 accumulators filling the tile."""
    g = MF.pw_gemm_f32_plan(m, k, k)
    gn, gm = g["grid"]
    assert gm * MF.FBM >= m > (gm - 1) * MF.FBM
    assert gn * MF.FBN >= k > (gn - 1) * MF.FBN
    assert g["k_tiles"] * MF.FBK == k
    assert g["smem_bytes"] == 2 * 2 * MF.FBK * MF.FLD * 4 == 16896
    assert g["smem_bytes"] <= 48 * 1024 <= 232448
    assert all(b % 16 == 0 for b in g["row_bytes"])
    # a padded shared row keeps 16-byte float4 reads aligned
    assert (MF.FLD * 4) % 16 == 0 and MF.FLD >= MF.FBM
    assert g["threads"] == MF.FTHREADS == 256
    assert g["threads"] * 8 * 8 == MF.FBM * MF.FBN \
        == g["tile"][0] * g["tile"][1]
    # the copy: each thread moves 4 floats of one row of A's and of W^T's
    # k-tile
    assert g["threads"] * 4 == MF.FBM * MF.FBK == MF.FBN * MF.FBK
    if (m, k) == (8192, 728):  # os16: 64 x 6 tiles
        assert g["grid"] == (6, 64)


def test_f32_stash_is_free_of_bank_conflicts():
    """The transposing stores of a warp (threads t = 0..31: row t // 2,
    k-columns (t % 2) * 4 + i for each i) land in 32 distinct banks with
    rows padded to FLD floats."""
    for i in range(4):
        banks = {(((t % 2) * 4 + i) * MF.FLD + t // 2) % 32 for t in range(32)}
        assert len(banks) == 32, i


def test_f32_plan_constants_match_the_source():
    """``pw_gemm_f32_plan`` mirrors ``csrc/middle_flow.cu``'s constants."""
    src = MF.SOURCE.read_text()
    for name in ("FBM", "FBN", "FBK", "FTHREADS"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == getattr(MF, name), name
    assert "constexpr int FLD = FBM + 4;" in src and MF.FLD == MF.FBM + 4
    assert "constexpr int F_STAGE = 2 * FBK * FLD;" in src
    assert "constexpr int F_SMEM = 2 * F_STAGE * (int)sizeof(float);" in src
    assert "smem < F_SMEM || smem > 48 * 1024" in src and "K % FBK" in src
    assert "static_assert(F_SMEM <= 48 * 1024" in src


@pytest.mark.parametrize("m,k,n,match", [(105, 12, 16, "multiples of 8"),
                                         (105, 16, 12, "multiples of 8"),
                                         (0, 8, 8, "rows >= 1")])
def test_f32_plan_refuses_shapes_the_kernel_does_not_take(m, k, n, match):
    with pytest.raises(ValueError, match=match):
        MF.pw_gemm_f32_plan(m, k, n)


@pytest.mark.parametrize("case", ["cpu", "misaligned", "bf16_input"])
def test_f32_wrappers_refuse_before_building(case):
    """The f32 set (taps, z, zb and the weight f32) raises on a CPU tensor,
    a misaligned operand, or a bf16 block input asked for an f32 zb, before
    the kernel library loads (or builds)."""
    z = torch.zeros(1, 4, 4, 16)
    if case == "misaligned":
        z = torch.zeros(1 + 256)[1:].view(1, 4, 4, 16)
        err, match = ValueError, "aligned"
    elif case == "bf16_input":
        z = z.to(torch.bfloat16)
        err, match = TypeError, "f32"
    else:
        err, match = ValueError, "CUDA"
    with pytest.raises(err, match=match):
        MF.dw_stencil(z, torch.zeros(9, 16), torch.zeros(16), torch.zeros(16),
                      1, torch.float32)
    if case != "bf16_input":
        with pytest.raises(err, match=match):
            MF.pw_gemm(z, torch.zeros(16, 16), torch.zeros(16), skip_src=z)
    assert MF._lib_handle is None


def test_f32_fold_feeds_the_f32_kernels():
    """A fold at compute_dtype=float32 gives f32 taps and an f32 K-major
    weight: the f32 set the wrappers take."""
    from cervical_tpu_torch.models.backbones.xception import XceptionBlock
    from torch_port_helpers import random_state

    class Mini(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.block4 = XceptionBlock(16, 16, 1)
    mini = Mini()
    mini.load_state_dict(random_state(mini, 4))
    f = MF.fold_middle_flow(mini, count=1, compute_dtype=torch.float32)
    assert f["wdw"].dtype == f["wpw_t"].dtype == torch.float32
    assert f["wdw"][0, :9].is_contiguous() and f["wpw_t"][0, 1].is_contiguous()
    assert torch.equal(f["wpw_t"], f["wpw"].transpose(-1, -2))
