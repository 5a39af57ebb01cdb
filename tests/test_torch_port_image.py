"""Port ``ops/image.py`` vs ``cervical_tpu.ops.image`` on the same numpy
inputs, odd sizes included.  Tolerance 1e-5 absolute on values up to 255
is fp32 matmul rounding in another summation order (the interpolation
matrices are identical: the port keeps its own copy of the function that
makes them)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cervical_tpu.ops import image as J
from cervical_tpu_torch.ops import image as T

ATOL = 1e-5 * 255


@pytest.mark.parametrize("shape,out_hw,align", [
    ((2, 7, 11, 3), (13, 5), True),
    ((2, 7, 11, 3), (13, 5), False),
    ((9, 4, 2), (3, 8), True),
    ((9, 4, 2), (1, 8), True),
    ((5, 5, 3), (5, 5), False),
])
def test_resize_bilinear_matches_jax(shape, out_hw, align):
    x = np.random.default_rng(0).uniform(0, 255, shape).astype(np.float32)
    ref = np.asarray(J.resize_bilinear(jnp.asarray(x), out_hw, align))
    got = T.resize_bilinear(torch.from_numpy(x), out_hw, align).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("src", [(37, 53), (53, 37), (64, 64), (17, 90)])
def test_letterbox_matches_jax(src):
    dst = (32, 48)
    img = np.random.default_rng(1).integers(0, 256, src + (3,)).astype(np.uint8)
    assert T.letterbox_params(src, dst) == J.letterbox_params(src, dst)
    ref = np.asarray(J.letterbox_image(jnp.asarray(img, jnp.float32), dst))
    got = T.letterbox_image(torch.from_numpy(img), dst)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    # the batched form the predictor uses equals the per-image one
    batched = T.letterbox_image(torch.from_numpy(np.stack([img, img])), dst)
    np.testing.assert_array_equal(batched[1].numpy(), got.numpy())


@pytest.mark.parametrize("src", [(37, 53), (53, 37), (17, 90)])
def test_unletterbox_matches_jax(src):
    dst = (32, 48)
    logits = np.random.default_rng(2).standard_normal(dst + (5,)).astype(np.float32)
    ref = np.asarray(J.unletterbox_logits(jnp.asarray(logits), src, dst))
    got = T.unletterbox_logits(torch.from_numpy(logits), src, dst).numpy()
    assert got.shape == src + (5,)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_preprocess_matches_jax():
    x = np.arange(256, dtype=np.float32)
    np.testing.assert_array_equal(
        T.preprocess_input(torch.from_numpy(x)).numpy(),
        np.asarray(J.preprocess_input(jnp.asarray(x))))


def test_resize_cache_stays_real_after_torch_export():
    """``torch.export`` traces through the cached interpolation matrices
    (``fit`` exports the model for its graph dump); a later real resize of
    the same shape must compute with a real matrix, not the trace's fake
    one, and still match JAX."""
    class Resize(torch.nn.Module):
        def forward(self, x):
            return T.resize_bilinear(x, (9, 7))

    x = np.random.default_rng(3).uniform(0, 255, (1, 5, 6, 2)).astype(np.float32)
    T._resident_interp.cache_clear()
    torch.export.export(Resize(), (torch.from_numpy(x),))
    got = T.resize_bilinear(torch.from_numpy(x), (9, 7))
    assert type(got.sum().item()) is float
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(J.resize_bilinear(jnp.asarray(x),
                                                            (9, 7))),
                               atol=ATOL)
