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
# The f32 kernels: mf_pw_gemm_f32 (3xTF32 wgmma + TMA) and mf_dw_stencil_f32
# (rows staged in shared memory by TMA)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [16, 728])
@pytest.mark.parametrize("m", [1, 16, 8192, 32768])
def test_f32_plan_covers_every_row_and_column_and_fits(m, k):
    """One block per 128 x 184 output tile covering every row and column
    (K = N), K padded to whole 32-wide k-tiles (128 bytes of f32, the
    swizzle's width; a multiple of wgmma's k8), three stages of A's, W_hi's
    and W_lo's boxes within the 227 KB a block may opt in to (above the 48
    KB default), TMA boxes at most 256 rows, and the setmaxnreg split
    within the SM's registers."""
    g = MF.pw_gemm_f32_plan(m, k, k)
    gn, gm = g["grid"]
    assert gm * MF.FBM >= m > (gm - 1) * MF.FBM
    assert gn * MF.GBN >= k > (gn - 1) * MF.GBN
    assert g["k_pad"] == g["k_tiles"] * MF.FBK and g["k_pad"] % 8 == 0
    assert g["k_pad"] >= k > g["k_pad"] - MF.FBK
    assert g["stage_bytes"] == (128 + 2 * 184) * 32 * 4 == 63488
    assert g["smem_bytes"] == 1024 + 3 * 63488 + 16 * 3
    assert 48 * 1024 < g["smem_bytes"] <= 232448
    assert g["smem_bytes"] + g["stage_bytes"] > 232448  # a 4th stage won't
    for box in (g["box_a"], g["box_w"]):
        assert box[0] * 4 == 128 and box[1] <= 256
    assert g["threads"] == 384
    producer, consumer = g["regs"]
    assert 128 * producer + 256 * consumer <= 65536
    assert producer % 8 == consumer % 8 == 0 and 24 <= producer < consumer
    # the consumer's two accumulator sets (92 each) and a k-tile's A
    # fragments (hi and lo, 4 k8 steps x 4) fit its registers
    assert 2 * 92 + 2 * 4 * 4 < consumer <= 255
    if (m, k) == (8192, 728):  # os16: 64 x 4 tiles, 1.94 waves on 132 SMs
        assert g["grid"] == (4, 64) and g["k_tiles"] == 23


def _swizzle128(row, byte):
    """Byte offset of (row, byte in row) in a 128-byte-swizzled box whose
    rows are 128 bytes: 16-byte chunk c of row r sits at chunk c ^ (r % 8)
    (TMA's CU_TENSOR_MAP_SWIZZLE_128B, the layout wgmma's descriptor names)."""
    return row * 128 + (((byte // 16) ^ (row % 8)) * 16) + byte % 16


def _fragment_offset(j, warp, lane, s, q):
    """``gemm_f32_kernel``'s A fragment load: consumer warpgroup j, its
    warp and lane, k8 step s, register q; mirrors the source's
    ``a_row + (q % 2) * 1024 + (((2 * s + q / 2) ^ g) << 4)``."""
    g, t = lane // 4, lane % 4
    a_row = (64 * j + 16 * warp + g) * 128 + t * 4
    return a_row + (q % 2) * 1024 + (((2 * s + q // 2) ^ g) << 4)


def test_f32_fragment_loads_read_the_swizzled_tile():
    """Register q of a thread holds A's element (row 16 warp + lane / 4 +
    8 (q % 2), k 8 s + lane % 4 + 4 (q // 2)) of its warpgroup's 64 rows
    (wgmma's .tf32 A fragment), read at the byte where TMA's 128-byte
    swizzle put it, for every warpgroup, warp, lane, k8 step and register;
    no two threads read one element."""
    seen = set()
    for j in range(2):
        for warp in range(4):
            for lane in range(32):
                for s in range(MF.FBK // 8):
                    for q in range(4):
                        row = 64 * j + 16 * warp + lane // 4 + 8 * (q % 2)
                        k = 8 * s + lane % 4 + 4 * (q // 2)
                        off = _fragment_offset(j, warp, lane, s, q)
                        assert off == _swizzle128(row, 4 * k)
                        seen.add(off)
    assert len(seen) == MF.FBM * MF.FBK  # the whole 128 x 32 box


def test_f32_fragment_loads_are_free_of_bank_conflicts():
    """Each of a warp's 16 fragment loads (k8 step s, register q) reads 32
    distinct banks: the swizzle spreads its 8 rows' chunks."""
    for warp in range(4):
        for s in range(MF.FBK // 8):
            for q in range(4):
                banks = {_fragment_offset(0, warp, lane, s, q) // 4 % 32
                         for lane in range(32)}
                assert len(banks) == 32, (warp, s, q)


def test_f32_descriptors_step_inside_the_swizzle_atom():
    """wgmma reads W's parts through 128-byte-swizzle descriptors: each box
    starts on a 1024-byte atom in every stage (the 1024-aligned base + whole
    atoms), a k8 step moves 32 bytes (2 in the >> 4 address field) and the
    k-tile's 4 steps stay inside the atom's 128-byte rows; the highest
    address fits the descriptor's 14-bit field (>> 4)."""
    a_tile, w_tile = MF.FBM * MF.FBK * 4, MF.GBN * MF.FBK * 4
    stage = a_tile + 2 * w_tile
    assert a_tile % 1024 == 0 and w_tile % 1024 == 0
    for st in range(MF.FSTAGES):
        for part in (a_tile, a_tile + w_tile):
            assert (st * stage + part) % 1024 == 0
    step = 8 * 4
    assert step >> 4 == 2 and (MF.FBK // 8) * step == 128
    top = 1024 + MF.FSTAGES * stage
    assert (top >> 4) < (1 << 14)


def test_f32_plan_constants_match_the_source():
    """``pw_gemm_f32_plan`` and ``dw_stencil_f32_plan`` mirror
    ``csrc/middle_flow.cu``'s constants and expressions."""
    src = MF.SOURCE.read_text()
    for name in ("FBK", "FBM", "FSTAGES", "F_PRODUCER_REGS",
                 "F_CONSUMER_REGS", "SW", "SQ_MAX", "S_OUT", "GBN"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == getattr(MF, name), name
    for line in ("constexpr int FA_TILE = FBM * FBK * 4;",
                 "constexpr int FW_TILE = GBN * FBK * 4;",
                 "constexpr int F_STAGE = FA_TILE + 2 * FW_TILE;",
                 "constexpr int F_SMEM = 1024 + FSTAGES * F_STAGE + 16 * "
                 "FSTAGES;",
                 "st + a_row + (q % 2) * 1024 + (((2 * s + q / 2) ^ g) << 4)",
                 "const int a_row = (64 * j + 16 * wl + g) * 128 + t * 4;",
                 "slot = ((SW + 2 * d) * cs * 4 + 127) / 128 * 128;",
                 "in = (11 * cs * 4 + 127) / 128 * 128;",
                 "out = in + (rows + 2) * slot;",
                 "bars = out + S_OUT * SW * cs * 4;",
                 "bytes = 128 + bars + 8 * (rows + 2);",
                 "for (int q = 3; q <= SQ_MAX; q += 2)",
                 "*grid = dim3(C / (4 * sq) * ((W + SW - 1) / SW), d * segs, "
                 "B);"):
        assert line in src, line
    assert "smem < F_SMEM" in src


@pytest.mark.parametrize("b,h,w,c,d", [
    (8, 32, 32, 728, 1),    # os16
    (8, 64, 64, 728, 2),    # os8 at dilation 2
    (3, 7, 5, 8, 2),        # the CUDA tests' ragged shapes
    (3, 13, 211, 40, 1),
    (2, 14, 37, 24, 3),     # residues with unequal row counts
])
def test_stencil_f32_plan_covers_every_output_and_fits(b, h, w, c, d):
    """Every (image, row, column, channel) belongs to exactly one block
    and thread: slices of 4 sq channels tile C exactly (no idle lane), 32
    columns a block, and for each residue of h mod d the segments of
    ``rows`` steps reach its last row.  A block's rows + 2 input boxes,
    output ring and barriers fit the 227 KB it may opt in to, each box at
    most 256 wide with 16-byte rows, each slot 128-aligned for TMA."""
    p = MF.dw_stencil_f32_plan(b, h, w, c, d)
    sq = MF.stencil_f32_quads(c)
    assert p["block"] == (MF.SW, sq) and p["slice"] == 4 * sq
    assert c % p["slice"] == 0 and sq % 2 == 1 and sq <= MF.SQ_MAX
    gx, gy, gz = p["grid"]
    slices = c // p["slice"]
    assert gx % slices == 0 and gz == b and gy % d == 0
    wtiles = gx // slices
    assert wtiles * MF.SW >= w > (wtiles - 1) * MF.SW
    segs, rows = gy // d, p["rows"]
    owner = {}
    for r in range(d):
        for seg in range(segs):
            t0 = seg * rows
            for t in range(t0, min(t0 + rows, -(-(h - r) // d))):
                owner.setdefault(r + t * d, []).append((r, seg))
    assert sorted(owner) == list(range(h))
    assert all(len(v) == 1 for v in owner.values())
    assert p["smem_bytes"] <= 232448
    assert p["slot_bytes"] % 128 == 0
    assert p["slot_bytes"] >= p["box_in"][0] * p["box_in"][1] * 4
    for box in (p["box_in"], p["box_out"]):
        assert box[1] <= 256 and (box[0] * 4) % 16 == 0
    if (b, h, w, c, d) == (8, 32, 32, 728, 1):
        assert p["grid"] == (14, 8, 8) and p["rows"] == 4
        # 3 blocks an SM: 228 KB, 1 KB of it reserved per block
        assert 3 * (p["smem_bytes"] + 1024) <= 228 * 1024


@pytest.mark.parametrize("c,sq", [(728, 13), (8, 1), (24, 3), (40, 5),
                                  (16, 1), (2048, 1), (104, 13)])
def test_stencil_f32_slices_leave_no_idle_lane(c, sq):
    """The slice's quads: the largest odd divisor of C / 4 up to 13, so
    every lane of every block has 4 channels of its own, and a column's
    odd number of 16-byte chunks spreads a warp's loads over all banks."""
    assert MF.stencil_f32_quads(c) == sq
    assert (c // 4) % sq == 0
    banks = {((lane * sq) % 8) for lane in range(8)}  # 16-byte chunks
    assert len(banks) == 8


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
    """A fold at compute_dtype=float32 gives f32 taps, an f32 K-major
    weight and its TF32 parts (hi, lo) stacked K-major: the f32 set the
    wrappers take; the bf16 fold has no parts."""
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
    split = f["wpw_t_split"]
    assert split.shape == (1, 3, 2, 16, 16) and split.dtype == torch.float32
    assert split[0, 1].is_contiguous()
    hi, lo = MF.tf32_split(f["wpw_t"])
    assert torch.equal(split[:, :, 0], hi) and torch.equal(split[:, :, 1], lo)
    assert not (split.view(torch.int32) & 0x1FFF).any()
    assert "wpw_t_split" not in MF.fold_middle_flow(mini, count=1)
