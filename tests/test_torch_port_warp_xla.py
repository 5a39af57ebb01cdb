"""The einsum augmentation backend of the port (``ops/warp_xla.py``,
``ops/augment.py``'s fast HSV and einsum blur) against the JAX package's
``cervical_tpu/ops/warp_xla.py`` on the CPU, on the same uint8 batches and
JAX-sampled parameters, in the cases of ``tests/test_warp_xla.py``.

JAX's functions run jitted, as the train step compiles them: XLA fuses
``a*o + b`` (and the HSV map's ``n + h/30`` and ``v - c*t``) into
multiply-adds, which the port reproduces.  Limits: labels and every uint8
stage exact; bf16 images within one bf16 step on at most 1e-3 of the
elements (0 measured in every case; ``pytest -s`` prints the readings).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cervical_tpu.ops import augment as JA
from cervical_tpu.ops import warp_xla as JW
from cervical_tpu.ops.pallas_warp import P_FILL
from cervical_tpu_torch.ops import augment as A
from cervical_tpu_torch.ops import warp_xla as W
from cervical_tpu_torch.ops.warp import make_warp_params

B, S = 4, 64
FILL = np.array([128, 128, 128, 0], np.uint8)


def _data(seed, shape=(B, S, S)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, shape + (3,)).astype(np.uint8),
            rng.integers(0, 5, shape).astype(np.uint8))


def _torch_params(p):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in p.items()}


def _images_ok(got, want, what, max_share=1e-3):
    """Every element within one bf16 step, at most ``max_share`` differing;
    prints the reading."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    d = np.abs(got - want)
    share = float((d > 0).mean())
    print(f"\n{what}: {share:.2e} of elements differ, max {d.max():.3g}")
    assert got.shape == want.shape
    assert np.all(d <= 2.0 ** -7 * np.abs(want)), d.max()
    assert share <= max_share, share


# (sampler prefix/suffix, augment_batch_einsum options); the prefix and
# suffix of the sampler follow the capacities, as the train step's do
CASES = {
    "rotate_all_3shear": ((B, None), {}),
    "two_shear": ((B, None), {"two_shear": True}),
    "rotate_prefix": ((2, None), {"rotate_capacity": 2}),
    "blur_suffix_piecewise": ((1, 2), {"rotate_capacity": 1,
                                       "blur_capacity": 2}),
    "piecewise_no_middle": ((2, 2), {"rotate_capacity": 2,
                                     "blur_capacity": 2}),
    "fallback_k_plus_m_over_b": ((3, 2), {"rotate_capacity": 3,
                                          "blur_capacity": 2}),
    "rotate_false": ((None, None), {"rotate": False}),
    "not_normalized": ((1, 1), {"rotate_capacity": 1, "blur_capacity": 1,
                                "normalized": False}),
    "int8_resample": ((1, 1), {"rotate_capacity": 1, "blur_capacity": 1,
                               "int8_resample": True}),
    "int8_two_shear": ((1, 1), {"rotate_capacity": 1, "blur_capacity": 1,
                                "int8_resample": True, "two_shear": True}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_augment_batch_einsum_matches_jax(case):
    (prefix, suffix), kw = CASES[case]
    images, labels = _data(11)
    p = JA.sample_augment_params(jax.random.PRNGKey(12), B,
                                 rotate_prefix=prefix, blur_suffix=suffix)
    wi, wl = JW.augment_batch_einsum(jnp.asarray(images), jnp.asarray(labels),
                                     p, (S, S), **kw)
    gi, gl = W.augment_batch_einsum(torch.from_numpy(images),
                                    torch.from_numpy(labels),
                                    _torch_params(p), (S, S), **kw)
    assert gi.dtype == torch.bfloat16 and gl.dtype == torch.uint8
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    _images_ok(gi.float().numpy(), wi, case)


def test_identity_letterbox_exact():
    """The letterbox of an image onto its own size is the identity, as the
    gather oracle says."""
    images, labels = _data(0)
    p = A.letterbox_params_like(B, (S, S), (S, S))
    gi, gl = W.augment_batch_einsum(torch.from_numpy(images),
                                    torch.from_numpy(labels), p, (S, S),
                                    letterbox=True, normalized=False)
    np.testing.assert_array_equal(gi.float().numpy(), images)
    np.testing.assert_array_equal(gl.numpy(), labels)


@pytest.mark.parametrize("two_shear", [False, True], ids=["3shear", "2shear"])
def test_rotation_matches_packed_ladder(two_shear):
    """The port's gather shears on four uint8 planes against the JAX
    package's uint32-packed barrel ladder: bit for bit."""
    rng = np.random.default_rng(7)
    planes = rng.integers(0, 256, (B, S, S, 4)).astype(np.uint8)
    p = JA.sample_augment_params(jax.random.PRNGKey(7), B, rotate_prefix=B)
    wp = JW.make_warp_params(p, (S, S), (S, S))
    want = jax.jit(lambda x, w: JW._rotate_packed(
        x, w, FILL, two_shear=two_shear))(jnp.asarray(planes), wp)
    twp = make_warp_params(_torch_params(p), (S, S), (S, S))
    np.testing.assert_array_equal(twp.numpy(), np.asarray(wp))
    got = W.rotate_planes(torch.from_numpy(planes), twp, two_shear)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rotation_matches_u8_ladder():
    """... and against the plain uint8 ladder (``_rotate_u8``, the label
    byte nearest), on an odd canvas and at +-10 degrees."""
    s = 45
    rng = np.random.default_rng(8)
    planes = rng.integers(0, 256, (B, s, s, 4)).astype(np.uint8)
    p = dict(JA.sample_augment_params(jax.random.PRNGKey(8), B,
                                      rotate_prefix=B))
    p["angle"] = jnp.array([10.0, -10.0, 3.0, -1.0])
    wp = JW.make_warp_params(p, (s, s), (s, s))
    want = jax.jit(lambda x, w: JW._rotate_u8(
        x, w, nearest=False, fill_u8=FILL, nearest_tail=1))(
            jnp.asarray(planes), wp)
    got = W.rotate_planes(torch.from_numpy(planes),
                          make_warp_params(_torch_params(p), (s, s), (s, s)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scale", [1.0, 1.0 / 255.0], ids=["x1", "x1_255"])
def test_hsv_jitter_batched_fast_matches_jax(scale):
    rng = np.random.default_rng(3)
    x = np.array(jnp.asarray(rng.random((16, S, S, 3)) * 255,
                             jnp.bfloat16).astype(jnp.float32))
    gains = (1 + (rng.random((16, 3)) * 2 - 1)
             * np.array([0.1, 0.7, 0.3])).astype(np.float32)
    want = jax.jit(lambda a, g: JA.hsv_jitter_batched_fast(a, g, scale))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(gains))
    got = A.hsv_jitter_batched_fast(torch.from_numpy(x).to(torch.bfloat16),
                                    torch.from_numpy(gains), scale)
    assert got.dtype == torch.bfloat16
    _images_ok(got.float().numpy(), want, f"hsv fast x{scale:.4g}")


def test_gaussian_blur_einsum_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (B, S, 48, 3)).astype(np.float32)
    want = jax.jit(JA.gaussian_blur_einsum)(jnp.asarray(x, jnp.bfloat16))
    got = A.gaussian_blur_einsum(torch.from_numpy(x).to(torch.bfloat16))
    _images_ok(got.float().numpy(), want, "blur einsum")
    np.testing.assert_array_equal(A._blur_matrix_np(48),
                                  JA._blur_matrix(48, 5, 0.0))


def test_int8_resample_stages_match_jax():
    """The integer-tap resample: images (uint8 between and after the
    passes) and labels, each exact."""
    images, labels = _data(9)
    p = JA.sample_augment_params(jax.random.PRNGKey(11), B, rotate_prefix=1,
                                 blur_suffix=1)
    wp = JW.make_warp_params(p, (S, S), (S, S))
    twp = make_warp_params(_torch_params(p), (S, S), (S, S))
    want = jax.jit(lambda x, w: JW._resample_int8(x, w, S, fill=w[:, P_FILL]))(
        jnp.asarray(images), wp)
    got = W._resample_int8(torch.from_numpy(images), twp, S,
                           fill=twp[:, P_FILL])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jax.jit(lambda x, w: JW._resample_labels_int8(x, w, S))(
        jnp.asarray(labels)[..., None], wp)
    got = W._resample_labels_int8(torch.from_numpy(labels)[..., None], twp, S)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rotation_first_order_matches_jax():
    angles = np.array([0.0, 3.0, 0.0, -7.0, 0.0, 10.0])
    np.testing.assert_array_equal(W.rotation_first_order(angles),
                                  JW.rotation_first_order(angles))
    np.testing.assert_array_equal(
        W.rotation_first_order(torch.from_numpy(angles)), [1, 3, 5, 0, 2, 4])


def test_param_rows_round_trip():
    p = A.sample_augment_params(torch.Generator().manual_seed(2), 8,
                                rotate_prefix=2, blur_suffix=2)
    rows = A.params_to_rows(p)
    assert rows.shape == (8, A.NUM_PARAM_COLUMNS)
    back = A.rows_to_params(rows)
    assert back.keys() == p.keys()
    for k, v in p.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_params_on_another_device_raise():
    images, labels = _data(1)
    p = A.sample_augment_params(torch.Generator().manual_seed(2), B)
    with pytest.raises(ValueError, match="upload the params"):
        W.augment_batch_einsum(torch.from_numpy(images),
                               torch.from_numpy(labels),
                               {k: v.to("meta") for k, v in p.items()},
                               (S, S))
