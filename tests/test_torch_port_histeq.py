"""The port's ``ops/histeq.py`` against ``cervical_tpu.ops.histeq`` (JAX
jitted on the CPU) on the same numpy inputs: the Y channel, each image's
histogram and LUT, the equalized batch, the flips bit for bit; the
rotations and the resize within 1e-3 on the [0, 255] scale; the 5x set."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cervical_tpu.ops import histeq as JH
from cervical_tpu_torch.ops import histeq as H


def _images(seed, b=4, h=40, w=48):
    """Uniform noise, a low-contrast image, a constant image and a smooth
    ramp: every LUT case (wide, narrow, one bin)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (b, h, w, 3)).astype(np.float32)
    x[1] = np.clip(rng.normal(110, 9, (h, w, 3)), 0, 255).round()
    x[2] = 77.0
    yy, xx = np.mgrid[:h, :w]
    x[3] = np.stack([xx * 5, yy * 6, (xx + yy) * 2], -1) % 256
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_y_bins_histograms_and_luts_equal_jax(seed):
    """The Y channel (the bins' source) bit for bit; each image's histogram
    of its rounded Y and, at every occupied bin, its LUT entry equal to
    what JAX's equalization maps that bin to."""
    x = _images(seed)
    jy = np.asarray(jax.jit(JH.rgb_to_ycrcb)(jnp.asarray(x)))
    py = H.rgb_to_ycrcb(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(py, jy)
    y = jy[..., 0].copy()
    j_eq = np.asarray(jax.jit(jax.vmap(JH.equalize_hist_channel))(
        jnp.asarray(y)))
    hist, lut = H.equalize_luts(torch.from_numpy(y))
    bins = np.clip(np.round(y), 0, 255).astype(np.int64)
    for i in range(len(x)):
        np.testing.assert_array_equal(
            hist[i].numpy(), np.bincount(bins[i].ravel(), minlength=256))
        for v in np.unique(bins[i]):
            assert set(j_eq[i][bins[i] == v].tolist()) == {float(lut[i, v])}
    np.testing.assert_array_equal(
        H.equalize_hist_batch(torch.from_numpy(y)).numpy(), j_eq)


def test_ycrcb_to_rgb_equals_jax():
    rng = np.random.default_rng(2)
    ycc = np.stack([rng.uniform(0, 255, (3, 24, 24)),
                    rng.uniform(40, 220, (3, 24, 24)),
                    rng.uniform(40, 220, (3, 24, 24))], -1).astype(np.float32)
    np.testing.assert_array_equal(
        H.ycrcb_to_rgb(torch.from_numpy(ycc)).numpy(),
        np.asarray(jax.jit(JH.ycrcb_to_rgb)(jnp.asarray(ycc))))


@pytest.mark.parametrize("seed", [0, 3])
def test_equalize_histogram_batch_bit_exact(seed):
    """Bit-exact: the port rounds the way back to RGB as XLA simplifies
    the jitted program (chroma gains folded into one constant each, the
    products fused onto ``y_eq``)."""
    x = _images(seed)
    want = np.asarray(JH.equalize_histogram_batch(jnp.asarray(x)))
    got = H.equalize_histogram_batch(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_constant_channel_returned_unchanged():
    ch = np.full((2, 16, 20), 93.0, np.float32)
    ch[1] = 0.0
    got = H.equalize_hist_batch(torch.from_numpy(ch)).numpy()
    np.testing.assert_array_equal(got, ch)
    np.testing.assert_array_equal(
        np.asarray(JH.equalize_hist_channel(jnp.asarray(ch[0]))), ch[0])


def test_flips_exact():
    x = _images(4)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(H.flip_horizontal(t).numpy(),
                                  np.asarray(JH.flip_horizontal(
                                      jnp.asarray(x))))
    np.testing.assert_array_equal(H.flip_vertical(t).numpy(),
                                  np.asarray(JH.flip_vertical(
                                      jnp.asarray(x))))


def _held(name, got, want, flips, tol=1e-3):
    """Within ``tol`` on [0, 255] but where a source coordinate's floor
    landed on the other side of an integer; those pixels under 0.1%."""
    err = np.abs(got - want).max(-1)
    over = int((err > tol).sum())
    print(f"{name}: max |diff| {err.max():.3g}, {over} pixels over {tol}, "
          f"{flips} floor flips of {err.size} pixels")
    assert over <= flips and flips <= 1e-3 * err.size


@pytest.mark.parametrize("angles", [[45.0, 30.0, -17.3, 60.0],
                                    [1.0, 10.0, -45.0, 90.0]])
def test_rotate_batch_within_1e3(angles):
    x = _images(5)
    a = np.asarray(angles, np.float32)
    want = np.asarray(JH.rotate_batch(jnp.asarray(x), jnp.asarray(a)))
    got = H.rotate_batch(torch.from_numpy(x), torch.from_numpy(a)).numpy()
    jy, jx = (np.asarray(v) for v in jax.jit(jax.vmap(
        lambda t: JH._rotate_coords(x.shape[1], x.shape[2], t)))(
            jnp.asarray(a)))
    py, px = (v.numpy() for v in H.rotate_coords(x.shape[1], x.shape[2],
                                                 torch.from_numpy(a)))
    flips = int(((np.floor(py) != np.floor(jy))
                 | (np.floor(px) != np.floor(jx))).sum())
    _held("rotate_batch", got, want, flips)


@pytest.mark.parametrize("out_hw", [(32, 36), (48, 40)])
def test_rotate_expand_and_resize_within_1e3(out_hw):
    """``rotate_expand_batch``'s coordinates are inline in JAX: a pixel over
    the tolerance counts as a floor flip, under 0.1%."""
    x = _images(6)
    a = np.asarray([45.0, -20.0, 33.0, 90.0], np.float32)
    want = np.asarray(JH.rotate_expand_batch(jnp.asarray(x), jnp.asarray(a),
                                             out_hw))
    got = H.rotate_expand_batch(torch.from_numpy(x), torch.from_numpy(a),
                                out_hw).numpy()
    over = int((np.abs(got - want).max(-1) > 1e-3).sum())
    _held("rotate_expand_batch", got, want, over)
    want = np.asarray(JH.resize_batch(jnp.asarray(x), out_hw))
    got = H.resize_batch(torch.from_numpy(x), out_hw).numpy()
    _held("resize_batch", got, want, 0)


@pytest.mark.parametrize("angles", [None, [12.0, 45.0, 3.0, 27.0]])
def test_fivefold_augment(angles):
    """The 5x set, (5, B, H, W, 3): the equalized image and its flips bit
    for bit, the rotation within 1e-3; the blur within 1e-4 (XLA's and
    torch's CPU convolutions sum the 5 taps in another order)."""
    x = _images(7)
    ja = None if angles is None else jnp.asarray(angles, jnp.float32)
    pa = None if angles is None else torch.tensor(angles)
    want = np.asarray(JH.fivefold_augment(jnp.asarray(x), ja))
    got = H.fivefold_augment(torch.from_numpy(x), pa).numpy()
    assert got.shape == (5,) + x.shape
    for k in range(3):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-4)
    over = int((np.abs(got[4] - want[4]).max(-1) > 1e-3).sum())
    _held("fivefold rotate", got[4], want[4], over)
