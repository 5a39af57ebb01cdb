"""K1's window rule (``ops/warp.py`` ``rotation_windows``), held against the
taps the plain 3-shear chain reads.

The kernel stages each output tile's rotation in shared memory: L2 (the
plane after shear 2) at the tile's rows, L1 (after shear 1) and L0 (the
resample) at the windows the rule gives.  A tap outside its window is
computed for its point by the recursive path, so the rule decides speed,
not values; these tests check that only the reads that wrap past an image
edge fall outside, that every window at the sampler's angles fits the
kernel's buffers, and the resamples per output that follow.  No JAX, no
card.
"""

import re

import pytest
import torch

from cervical_tpu_torch.ops import augment as A
from cervical_tpu_torch.ops import warp as W


def _row(angle, s):
    """(tan(theta/2), sin(theta)) of one image's f32 warp row."""
    p = A.sample_augment_params(torch.Generator().manual_seed(0), 1)
    p["angle"] = torch.tensor([float(angle)])
    wp = W.make_warp_params(p, (s, s), (s, s))
    return wp[0, W.P_TANH].item(), wp[0, W.P_SINT].item()


def _plain_taps(shift, s, lanes):
    """The plain chain's reads for one shear of an S x S plane, as
    ``ops/warp.py`` ``_shear`` indexes them: (valid, at) per point (r, c),
    where the point reads ``at`` and ``at - 1`` (before the wrap modulo S)
    along the shear's axis."""
    sc = torch.clamp(torch.floor(shift), -W.MAX_SHIFT, W.MAX_SHIFT - 1).long()
    coord = torch.arange(s)
    if lanes:   # shift per row r, along the columns
        at = coord[None, :] - sc[:, None]
        d = coord.float()[None, :] - shift[:, None]
    else:       # shift per column c, along the rows
        at = coord[:, None] - sc[None, :]
        d = coord.float()[:, None] - shift[None, :]
    return (d >= -0.5) & (d <= s - 0.5), at


def _check_level(valid, at, rows, cols, lo, hi, s):
    """Taps of the valid points of rows x cols: each inside [lo, hi] or
    past an image edge.  Returns (taps outside the window, of them inside
    [0, S))."""
    v, t = valid[rows][:, cols], at[rows][:, cols]
    out, stray = 0, 0
    for tap in (t, t - 1):
        miss = v & ((tap < lo) | (tap > hi))
        out += int(miss.sum())
        stray += int((miss & (tap >= 0) & (tap < s)).sum())
    return out, stray


@pytest.mark.parametrize("halo", [0, W.K5_HALO])
@pytest.mark.parametrize("s", [64, 512])
@pytest.mark.parametrize("angle", [a for a in range(-10, 11) if a] + [30])
def test_rotation_windows_cover_the_plain_chains_taps(angle, s, halo):
    tile = W.K1_TILE
    tan_half, sint = _row(angle, s)
    win = W.rotation_windows(tan_half, sint, s, halo)
    if angle == 30:
        # past ~10 degrees the windows outgrow the buffers: those tiles take
        # the recursive path
        assert not bool(win["fits"].all())
        return
    w2, h1, w0 = W.k1_buffers(halo)
    sides = (win["b2"] - win["a2"] + 1, win["b1"] - win["a1"] + 1,
             win["b0"] - win["a0"] + 1)
    assert all(int(v.max()) <= m for v, m in zip(sides, (w2, h1, w0)))
    assert bool(win["fits"].all())
    grid = torch.arange(s, dtype=torch.float32) - float(s // 2)
    tanc = torch.tensor(-tan_half, dtype=torch.float32)
    lanes = _plain_taps(tanc * grid, s, True)       # shears 1 and 3
    rows_ = _plain_taps(torch.tensor(sint, dtype=torch.float32) * grid, s,
                        False)                      # shear 2
    resamples, wrapped = 0, 0

    def span(a, b):  # a window's indices; empty where b < a
        return slice(a, max(a, b + 1))
    for i in range(win["fits"].shape[0]):
        for j in range(win["fits"].shape[1]):
            k = {n: int(v[i, j]) for n, v in win.items()}
            tr, tc = span(k["ra"], k["rb"]), span(k["ca"], k["cb"])
            c2, r1 = span(k["a2"], k["b2"]), span(k["a1"], k["b1"])
            # shear 3: the tile's outputs read L2 at columns a2..b2
            n3, s3 = _check_level(*lanes, tr, tc, k["a2"], k["b2"], s)
            # shear 2: L2's points read L1 at rows a1..b1
            n2, s2 = _check_level(*rows_, tr, c2, k["a1"], k["b1"], s)
            # shear 1: L1's points read L0 at columns a0..b0
            n1, s1 = _check_level(*lanes, r1, c2, k["a0"], k["b0"], s)
            assert s3 == s2 == s1 == 0, (i, j, s3, s2, s1)
            wrapped += n3 + n2 + n1
            # L0 resampled once per point, a wrapped tap of shear k by the
            # recursive path: 2^(k-1) resamples
            resamples += len(range(s)[r1]) * len(range(s)[span(k["a0"],
                                                              k["b0"])]) \
                + n1 + 2 * n2 + 4 * n3
    per_output = resamples / (s * s)
    print(f"angle {angle} S {s} tile {tile} halo {halo}: {per_output:.3f} "
          f"resamples per output, {wrapped} wrapped reads")
    assert per_output <= 2.0
    if s == 512:
        # only the image's edges wrap: ~0.3% of the outputs at 10 degrees
        assert wrapped <= 0.005 * s * s


@pytest.mark.parametrize("halo", [0, W.K5_HALO])
def test_buffers_fit_static_shared_memory(halo):
    """The Python rule sizes the kernels' buffers from the kernel's own
    constants, read from ``csrc/warp.cu``.  K1's 32 x 32 tile takes windows
    of (36, 40, 41) values a side, K5's 36 x 36 region (the tile and the
    blur's halo) (41, 44, 46): L1 in f32 beside L0 in bf16, which L2 (f32)
    reuses; K5 adds its gain tables (181 hue entries of 8 bytes, 256 + 256
    of 4) and lays its staged f32 tile (36 rows of 40) over L1.  Each fits
    the 48 KB a block has without opting in."""
    src = W.SOURCE.read_text()

    def ints(*names):
        return tuple(int(re.search(rf"\b{n} = (\d+)", src)[1])
                     for n in names)
    rows, cols = ints("K1_ROWS", "K1_COLS")
    assert (rows, cols) == W.K1_TILE == (32, 32)
    assert ints("kTanHalfMax", "kSinMax") == W.ROTATION_SLOPES
    assert ints("K5_HALO") == (W.K5_HALO,)
    w2, h1, w0 = W.k1_buffers(halo)
    assert (w2, h1, w0) == {0: (36, 40, 41), 2: (41, 44, 46)}[halo]
    r2 = rows + 2 * halo
    l1, l0, l2 = 4 * 3 * h1 * w2, 2 * 3 * h1 * w0, 4 * 3 * r2 * w2
    total = l1 + max(l0, l2)
    if halo:
        hue, sat, val = W.GAIN_TABLE_SIZES
        total += 8 * hue + 4 * (sat + val)
        (pad,) = ints("K3_PAD")
        assert 4 * 3 * r2 * (cols + 2 * pad) <= l1  # the staged tile
        assert (l1, l0, l2, total) == (21648, 12144, 17712, 42856)
    assert total <= 48 * 1024
