"""K3's per-image gain tables (``ops/warp.py`` ``photometric_tables``), the
CPU mirror of what ``csrc/warp.cu`` fills in shared memory, held against
the plain HSV map and JAX's.

The kernel splits the cv2 HSV gain jitter into (1) (r, g, b) -> the
integers ``rint(h)``, ``rint(s)``, ``rint(v)``; (2) per channel, the values
the rest of the map needs of that integer under the image's gain, read
from a table of every integer (181 hues, 256 saturations and values); (3)
the combine.  These tests hold (2) exactly against ``ops/augment``'s
``_lut_gains`` + ``_hsv_to_rgb`` on every integer, against JAX's
``_hsv_jitter_planes`` on integer RGB grids, and a plain map that reads the
tables (an index outside them computed directly, as the kernel does)
against ``photometric_reference`` bit for bit.  Table sizes are read from
the kernel's source.  No card.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cervical_tpu.ops import pallas_warp as PW
from cervical_tpu_torch.ops import augment as A
from cervical_tpu_torch.ops import warp as W

# (B, 3) gains: the sampler's draws, then extremes: a hue gain that wraps
# past 180, saturation and value gains that clip at 255, a gain of exactly
# 1, negative gains (jnp.mod's sign rule, not fmod's), 0
_SAMPLED = A.sample_augment_params(torch.Generator().manual_seed(4), 6)["gains"]
_EXTREME = torch.tensor([[1.1, 1.7, 1.3], [1.0, 1.0, 1.0], [0.9, 0.3, 0.7],
                         [-0.35, 1.0, 2.5], [3.7, 0.0, 1.0], [0.0, 255.0, 1e-6]])
GAIN_SETS = {"sampled": _SAMPLED.float(), "extreme": _EXTREME}


def _combine(factor, sextant, sf, vq):
    """Part (3), ``csrc/warp.cu`` ``hsv_combine``: (r, g, b) in [0, 255]."""
    cc = vq * sf
    xx = cc * factor
    m = vq - cc
    z = torch.zeros_like(cc)
    return (A._select6(sextant, cc, xx, z, z, xx, cc) + m,
            A._select6(sextant, xx, cc, cc, xx, z, z) + m,
            A._select6(sextant, z, z, xx, cc, cc, xx) + m)


def _lookup(table, q, direct):
    """(B, N) values of a (B, n) table at (B, N) integer-valued ``q``; an
    index outside the table (negative, -0, NaN or >= n) takes ``direct``,
    the entry computed for its own ``q``, as ``GainTables::jitter`` does.
    Returns (values, count of indices outside)."""
    n = table.shape[1]
    inside = ~torch.signbit(q) & (q <= n - 1)
    idx = torch.where(inside, q, torch.zeros_like(q)).long()
    got = torch.gather(table, 1, idx)
    return torch.where(inside, got, direct), int((~inside).sum())


def _jitter_via_tables(r, g, b, gains):
    """The HSV gain jitter of (B, N) f32 planes through the tables."""
    t = W.photometric_tables(gains)
    q = [torch.round(u) for u in A._rgb_to_hsv(r, g, b)]
    direct = W.gain_entries(*q, *(gains[:, k:k + 1] for k in range(3)))
    hq, sq, vq = q
    factor, n_h = _lookup(t["hue_factor"], hq, direct[0])
    sextant, _ = _lookup(t["hue_sextant"], hq, direct[1])
    sf, n_s = _lookup(t["sat"], sq, direct[2])
    val, n_v = _lookup(t["val"], vq, direct[3])
    return _combine(factor, sextant, sf, val), n_h + n_s + n_v


def _photometric_via_tables(x, gains, flags, out_dtype, mode):
    """``photometric_reference`` with the HSV map read through the
    tables.  Returns (output, count of channel indices outside a table)."""
    x = x.to(torch.float32)
    if mode != "none":
        blurred = W._blur1d(W._blur1d(x, 2), 3)
        x = blurred if mode == "all" else torch.where(
            flags[:, None, None, None], blurred, x)
    b, _, h, w = x.shape
    planes = [x[:, k].reshape(b, h * w) for k in range(3)]
    rgb, outside = _jitter_via_tables(*planes, gains.float())
    inv255 = torch.tensor(1.0 / 255.0, dtype=torch.float32)
    out = torch.stack([c.reshape(b, h, w) for c in rgb], 1) * inv255
    return out.to(out_dtype), outside


def test_table_sizes_and_tile_are_the_kernels():
    """The mirror's sizes are the kernel's constants, read from its source,
    and the blurred tile (3 channels of f32 with a 2-pixel halo, the first
    pixel of a row 16 bytes in) and the tables fit a block's 48 KB of
    static shared memory."""
    src = W.SOURCE.read_text()

    def ints(*names):
        return tuple(int(re.search(rf"\b{n} = (\d+)", src)[1]) for n in names)
    assert ints("kHueEntries", "kSatEntries", "kValEntries") \
        == W.GAIN_TABLE_SIZES == (181, 256, 256)
    run, threads, cols, pad = ints("K3_RUN", "K3_THREADS", "K3_COLS", "K3_PAD")
    rows = threads * run // cols
    tile = 4 * 3 * (rows + 4) * (cols + 2 * pad)
    tables = 8 * W.GAIN_TABLE_SIZES[0] + 4 * sum(W.GAIN_TABLE_SIZES[1:])
    assert (rows, pad) == (32, 4) and tile + tables <= 48 * 1024


@pytest.mark.parametrize("which", sorted(GAIN_SETS))
def test_tables_are_the_lut_gains_and_hsv_to_rgb(which):
    """Every table entry against ``_lut_gains``' integers, and the combine
    of the entries against ``_lut_gains`` + ``_hsv_to_rgb`` bit for bit on
    every hue x saturation at 9 values and every value x saturation at 7
    hues, for each image's gains."""
    gains = GAIN_SETS[which]
    b = gains.shape[0]
    t = W.photometric_tables(gains)
    nh, ns, nv = W.GAIN_TABLE_SIZES
    gh, gs, gv = (gains[:, k:k + 1] for k in range(3))
    lut_h, lut_s, lut_v = A._lut_gains(
        torch.arange(nh, dtype=torch.float32).expand(b, nh),
        torch.arange(ns, dtype=torch.float32).expand(b, ns),
        torch.arange(nv, dtype=torch.float32).expand(b, nv), gh, gs, gv)
    inv255 = torch.tensor(1.0 / 255.0)
    assert torch.equal(t["val"], lut_v)
    assert torch.equal(t["sat"], lut_s * inv255)
    hp = (lut_h * 2.0) * torch.tensor(1.0 / 60.0)
    assert torch.equal(t["hue_sextant"], torch.floor(hp).to(torch.int32) % 6)

    def grid(hs, ss, vs):
        h, s, v = torch.meshgrid(torch.as_tensor(hs), torch.as_tensor(ss),
                                 torch.as_tensor(vs), indexing="ij")
        return [u.reshape(1, -1).expand(b, -1).long() for u in (h, s, v)]
    spots = [0, 1, 2, 127, 128, 200, 253, 254, 255]
    for h, s, v in (grid(range(nh), range(ns), spots),
                    grid([0, 1, 29, 30, 90, 179, 180], range(ns), range(nv))):
        want = A._hsv_to_rgb(*A._lut_gains(h.float(), s.float(), v.float(),
                                           gh, gs, gv))
        got = _combine(torch.gather(t["hue_factor"], 1, h),
                       torch.gather(t["hue_sextant"], 1, h),
                       torch.gather(t["sat"], 1, s),
                       torch.gather(t["val"], 1, v))
        for c_got, c_want in zip(got, want):
            assert torch.equal(c_got, c_want)


@pytest.mark.parametrize("which", sorted(GAIN_SETS))
def test_tables_match_jax_hsv_jitter_planes(which):
    """The map through the tables against JAX's ``_hsv_jitter_planes``
    (the Pallas kernel's HSV map, compiled by XLA on the CPU) on the integer
    RGB grid of step 5 and every gray level: equal bit for bit."""
    gains = GAIN_SETS[which]
    levels = np.arange(0, 256, 5, dtype=np.float32)
    r, g, b = (u.reshape(-1) for u in np.meshgrid(levels, levels, levels,
                                                  indexing="ij"))
    gray = np.arange(256, dtype=np.float32)
    r, g, b = (np.concatenate([u, gray]) for u in (r, g, b))
    planes = [torch.from_numpy(u)[None].expand(gains.shape[0], -1)
              for u in (r, g, b)]
    got, outside = _jitter_via_tables(*planes, gains)
    assert outside == 0
    fn = jax.jit(PW._hsv_jitter_planes)
    for i, gi in enumerate(gains.numpy()):
        want = fn(*(jnp.asarray(u) for u in (r, g, b)), *gi)
        for c_got, c_want in zip(got, want):
            np.testing.assert_array_equal(c_got[i].numpy(), np.asarray(c_want))


@pytest.mark.parametrize("mode", W.BLUR_MODES)
@pytest.mark.parametrize("in_dtype", [torch.uint8, torch.bfloat16,
                                      torch.float32])
def test_map_via_tables_is_photometric_reference(in_dtype, mode):
    """A plain K3 that reads the tables equals ``photometric_reference``
    bit for bit, bf16 and f32 out, with sampled and extreme gains.  uint8
    input indexes the tables only; bf16 rounds 255.875 up to 256, past
    the value table."""
    rng = np.random.default_rng(31)
    x = rng.integers(0, 256, (6, 3, 12, 20)).astype(np.float32)
    if in_dtype != torch.uint8:  # non-integer values, as K1 writes bf16
        x = x + rng.integers(0, 8, x.shape) / 8.0
    x = torch.from_numpy(x).to(in_dtype)
    flags = torch.tensor([True, False, True, False, False, True])
    for gains in GAIN_SETS.values():
        for out_dtype in (torch.bfloat16, torch.float32):
            got, outside = _photometric_via_tables(x, gains, flags, out_dtype,
                                                   mode)
            assert outside == 0 or in_dtype != torch.uint8
            assert torch.equal(got, W.photometric_reference(
                x, gains, flags, out_dtype, mode))


@pytest.mark.parametrize("mode", W.BLUR_MODES)
def test_map_via_tables_outside_0_255(mode):
    """f32 input outside [0, 255] (not clipped by the wrapper): indices
    outside the tables, computed directly, keep the map equal to
    ``photometric_reference`` bit for bit."""
    rng = np.random.default_rng(37)
    x = rng.uniform(-300.0, 600.0, (6, 3, 12, 20)).astype(np.float32)
    x[1] = np.round(x[1])
    x = torch.from_numpy(x)
    flags = torch.tensor([True, False, True, False, False, True])
    for gains in GAIN_SETS.values():
        got, outside = _photometric_via_tables(x, gains, flags, torch.float32,
                                               mode)
        assert outside > 0
        assert torch.equal(got, W.photometric_reference(
            x, gains, flags, torch.float32, mode))
