"""The augmentation slice against the JAX package at 64², batch 4: the
plain versions of K1 ``warp_images``, K2 ``warp_labels``, K3
``photometric`` and K5 ``warp_photo_images`` against the Pallas kernels in
interpret mode on the same parameter rows; the chained
``augment_batch_kernels`` (two-kernel and fused) against
``augment_batch_pallas``; ``make_warp_params``; the gather oracle
``ops/augment``; the sampler's distributions; the eval letterbox of
``ops/warp_xla``.

Tolerances found: K2 is exactly equal.  K3 is exactly equal on these
cases.  K1 follows XLA's fused multiply-adds (the source coordinate and
the shear lerp), and ``test_plain_versions_follow_xla_rounding`` measures
it exactly equal too over 4 seeds with every image rotated (``pytest -s``
prints the counts); a lerp that lands on a bf16 rounding-boundary tie can
still differ by one step, so K1 and K3 are held to one bf16 step with at
most 1e-4 of the elements off.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cervical_tpu.ops import augment as JA
from cervical_tpu.ops import pallas_warp as PW
from cervical_tpu_torch.ops import augment as A
from cervical_tpu_torch.ops import warp as W

B, S = 4, 64


def _data(seed, src_hw=(S, S)):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B,) + src_hw + (3,)).astype(np.uint8)
    labels = rng.integers(0, 5, (B,) + src_hw).astype(np.uint8)
    return images, labels


def _t(params):
    """A JAX/numpy params dict as CPU tensors (same values)."""
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()
            if k != "letterbox"}


def _jparams(case):
    """Parameter dicts covering rotation (+-3, +-10, 0), flip, scale above
    and below 1, a non-square source, the letterbox map."""
    if case == "nonsquare":
        p = dict(JA.letterbox_params_like(B, (40, 64), (S, S)))
        p["angle"] = jnp.array([0.0, 5.0, -10.0, 0.0])
        return p, (40, 64), True
    p = dict(JA.sample_augment_params(jax.random.PRNGKey(7), B,
                                      rotate_prefix=B, blur_suffix=2))
    if case == "rotate":
        p["angle"] = jnp.array([3.0, -3.0, 10.0, -10.0])
    else:  # flip and scale, no rotation
        p["angle"] = jnp.zeros(B)
        p["flip"] = jnp.array([True, False, True, False])
        p["scale"] = jnp.array([0.5, 1.5, 0.8, 2.0])
    return p, (S, S), False


def _one_step_ok(got, want, max_share=1e-4):
    """Every element within one bf16 step of ``want`` (2^-7 relative
    covers a step anywhere in a binade), at most ``max_share`` of them
    differing at all."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    d = np.abs(got - want)
    assert (d <= 2.0 ** -7 * np.abs(want) + 1e-12).all(), float(d.max())
    assert (d > 0).mean() <= max_share, (d > 0).mean()


@pytest.mark.parametrize("case", ["rotate", "flip_scale", "nonsquare"])
@pytest.mark.parametrize("u8", [False, True], ids=["bf16", "u8"])
def test_warp_images_and_labels_match_pallas(case, u8):
    jp, src_hw, letterbox = _jparams(case)
    images, labels = _data(11, src_hw)
    wp = np.array(PW.make_warp_params(jp, src_hw, (S, S),
                                      letterbox=letterbox))
    planar = np.ascontiguousarray(images.transpose(0, 3, 1, 2))
    jdt, tdt = (jnp.uint8, torch.uint8) if u8 else (jnp.bfloat16,
                                                      torch.bfloat16)
    want = PW.warp_images(jnp.asarray(planar), jnp.asarray(wp), out_size=S,
                          interpret=True, out_dtype=jdt)
    # the NHWC batch read through its permuted view, as the train step does
    got = W.warp_images(torch.from_numpy(images).permute(0, 3, 1, 2),
                        torch.from_numpy(wp), S, tdt)
    assert got.dtype == tdt and tuple(got.shape) == (B, 3, S, S)
    _one_step_ok(got.float().numpy(), want)
    if not u8:
        want_l = PW.warp_labels(jnp.asarray(labels), jnp.asarray(wp),
                                out_size=S, interpret=True)
        got_l = W.warp_labels(torch.from_numpy(labels), torch.from_numpy(wp), S)
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


@pytest.mark.parametrize("mode", ["select", "all", "none"])
@pytest.mark.parametrize("in_dtype", ["uint8", "bfloat16", "float32"])
def test_photometric_matches_pallas(mode, in_dtype):
    rng = np.random.default_rng(19)
    x = rng.integers(0, 256, (B, 3, S, S)).astype(np.float32)
    if in_dtype == "bfloat16":  # non-integer bf16 values, as K1 writes
        x = x + rng.integers(0, 8, x.shape) / 8.0
    gains = rng.uniform(0.7, 1.3, (B, 3)).astype(np.float32)
    flags = np.array([True, False, True, False])
    jx = jnp.asarray(x).astype(in_dtype)
    tx = torch.from_numpy(x).to(getattr(torch, in_dtype))
    want = PW.photometric(jx, jnp.asarray(gains), jnp.asarray(flags),
                          interpret=True, blur_mode=mode)
    got = W.photometric(tx, torch.from_numpy(gains), torch.from_numpy(flags),
                        blur_mode=mode)
    assert got.dtype == torch.bfloat16
    _one_step_ok(got.float().numpy(), want)


@pytest.mark.parametrize("kw", [{}, {"normalized": False}, {"carry_u8": True},
                                {"blur_capacity": 2}, {"letterbox": True},
                                {"fused": True},
                                {"fused": True, "normalized": False}],
                         ids=["default", "unnormalized", "carry_u8",
                              "blur_capacity", "letterbox", "fused",
                              "fused_unnormalized"])
def test_augment_batch_kernels_matches_pallas(kw):
    """End to end, each side computing its own warp rows from one params
    dict: labels equal, images within one bf16 step.  ``fused`` runs K5
    on both sides."""
    images, labels = _data(23)
    jp = dict(JA.sample_augment_params(jax.random.PRNGKey(29), B,
                                       rotate_prefix=2, blur_suffix=2))
    if kw.get("letterbox"):
        jp = dict(JA.letterbox_params_like(B, (S, S), (S, S)))
        jp["angle"] = jnp.array([0.0, 4.0, 0.0, -6.0])
    wi, wl = PW.augment_batch_pallas(jnp.asarray(images), jnp.asarray(labels),
                                     jp, (S, S), interpret=True, **kw)
    gi, gl = W.augment_batch_kernels(torch.from_numpy(images),
                                     torch.from_numpy(labels), _t(jp), (S, S),
                                     **kw)
    assert gi.shape == (B, S, S, 3) and gi.dtype == torch.bfloat16
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    _one_step_ok(gi.float().numpy(), wi)


def test_plain_versions_follow_xla_rounding(monkeypatch):
    """Why the plain versions fuse ``a*o + b`` and the shear lerp
    (``ops/warp._fma``), as XLA compiles the Pallas kernels on the CPU:
    over 4 seeds (B=4, 64², every image rotated, half blurred) K2 equals
    the Pallas kernel and K1/K3 are within one bf16 step on at most 1e-4
    of the elements; with every such multiply-add rounded twice instead,
    K2 differs on some labels (exact ties of rational scales)."""
    def two_roundings(a, x, c):
        return (a * x + c).to(torch.float32)

    cases, want = [], {"K1": [], "K2": [], "K3": []}
    for seed in range(4):
        images, labels = _data(seed)
        p = JA.sample_augment_params(jax.random.PRNGKey(seed), B,
                                     rotate_prefix=B, blur_suffix=B // 2)
        wp = np.array(PW.make_warp_params(p, (S, S), (S, S)))
        planar = np.ascontiguousarray(images.transpose(0, 3, 1, 2))
        jk1 = np.asarray(PW.warp_images(jnp.asarray(planar), jnp.asarray(wp),
                                        out_size=S, interpret=True),
                         np.float32)
        gains, flags = np.array(p["gains"]), np.array(p["blur"])
        want["K1"].append(jk1)
        want["K2"].append(np.asarray(PW.warp_labels(
            jnp.asarray(labels), jnp.asarray(wp), out_size=S,
            interpret=True)))
        want["K3"].append(np.asarray(PW.photometric(
            jnp.asarray(jk1).astype(jnp.bfloat16), jnp.asarray(gains),
            jnp.asarray(flags), interpret=True), np.float32))
        cases.append((planar, labels, wp, jk1, gains, flags))
    want = {k: np.concatenate(v) for k, v in want.items()}

    counts = {}
    for variant in ("as_written", "two_roundings"):
        if variant == "two_roundings":
            monkeypatch.setattr(W, "_fma", two_roundings)
        got = {"K1": [], "K2": [], "K3": []}
        for planar, labels, wp, jk1, gains, flags in cases:
            tw = torch.from_numpy(wp)
            got["K1"].append(W.warp_images(torch.from_numpy(planar), tw,
                                           S).float().numpy())
            got["K2"].append(W.warp_labels(torch.from_numpy(labels), tw,
                                           S).numpy())
            got["K3"].append(W.photometric(
                torch.from_numpy(jk1).to(torch.bfloat16),
                torch.from_numpy(gains), torch.from_numpy(flags)
            ).float().numpy())
        got = {k: np.concatenate(v) for k, v in got.items()}
        counts[variant] = {k: (int((got[k] != want[k]).sum()), want[k].size)
                           for k in got}
        if variant == "as_written":
            np.testing.assert_array_equal(got["K2"], want["K2"])
            _one_step_ok(got["K1"], want["K1"])
            _one_step_ok(got["K3"], want["K3"])
    print("\nelements that differ from the Pallas kernels: " + "; ".join(
        f"{v} {k} {n} of {size}" for v, c in counts.items()
        for k, (n, size) in c.items()))
    assert counts["two_roundings"]["K2"][0] > 0, counts


def test_warp_photo_images_matches_pallas():
    """K5's plain version against ``warp_photo_images`` in interpret mode:
    4 seeds, 64², every image rotated, half of them blurred, parameters
    sampled by JAX.  Measured exactly equal (0 of 196,608 elements differ;
    ``pytest -s`` prints the count); held to one bf16 step on at most 1e-4
    of the elements, as K1 and K3 are."""
    got, want = [], []
    for seed in range(4):
        images, _ = _data(seed)
        p = JA.sample_augment_params(jax.random.PRNGKey(seed), B,
                                     rotate_prefix=B, blur_suffix=B // 2)
        wp = np.array(PW.make_warp_params(p, (S, S), (S, S)))
        full = np.concatenate([wp, np.array(p["gains"], np.float32),
                               np.array(p["blur"], np.float32)[:, None]], 1)
        planar = np.ascontiguousarray(images.transpose(0, 3, 1, 2))
        want.append(np.asarray(PW.warp_photo_images(
            jnp.asarray(planar), jnp.asarray(full), out_size=S,
            interpret=True), np.float32))
        out = W.warp_photo_images(torch.from_numpy(images).permute(0, 3, 1, 2),
                                  torch.from_numpy(full), S)
        assert out.dtype == torch.bfloat16 and tuple(out.shape) == (B, 3, S, S)
        got.append(out.float().numpy())
    got, want = np.concatenate(got), np.concatenate(want)
    print(f"\nK5 plain version vs the Pallas kernel: {int((got != want).sum())}"
          f" of {want.size} elements differ")
    _one_step_ok(got, want)


@pytest.mark.parametrize("letterbox", [False, True])
def test_make_warp_params_matches_jax(letterbox):
    for seed, src in ((0, (S, S)), (1, (40, 64)), (2, (96, 80))):
        jp = dict(JA.letterbox_params_like(B, src, (S, S)) if letterbox else
                  JA.sample_augment_params(jax.random.PRNGKey(seed), B,
                                           rotate_prefix=2))
        want = np.asarray(PW.make_warp_params(jp, src, (S, S),
                                              letterbox=letterbox))
        got = W.make_warp_params(_t(jp), src, (S, S), letterbox).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the gather oracle and the sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("letterbox", [False, True])
def test_oracle_augment_batch_matches_jax(letterbox):
    """The gather oracle on one params dict.  JAX contracts its coordinate
    arithmetic into fused multiply-adds, so source coordinates differ in
    the last bit: images to 0.05 mean / 2 counts max except at nearest-
    neighbour-sized hue flips (< 0.1% of values), labels on >= 99.9% of
    pixels."""
    images, labels = _data(31)
    if letterbox:
        jp = dict(JA.letterbox_params_like(B, (S, S), (S, S)))
        jp["angle"] = jnp.array([0.0, 7.0, 0.0, -9.0])
        jp["blur"] = jnp.array([False, True, False, True])
    else:
        jp = dict(JA.sample_augment_params(jax.random.PRNGKey(37), B))
    wi, wl = JA.augment_batch(jnp.asarray(images), jnp.asarray(labels), jp,
                              (S, S), letterbox=letterbox)
    gi, gl = A.augment_batch(torch.from_numpy(images),
                             torch.from_numpy(labels), _t(jp), (S, S),
                             letterbox=letterbox)
    d = np.abs(gi.numpy() - np.asarray(wi))
    assert d.mean() < 0.05 and (d > 2.0).mean() < 1e-3, (d.mean(), d.max())
    assert (gl.numpy() == np.asarray(wl)).mean() >= 0.999


def test_oracle_photometric_pieces_match_jax():
    rng = np.random.default_rng(41)
    rgb = rng.integers(0, 256, (B, 8, 9, 3)).astype(np.float32)
    gains = rng.uniform(0.7, 1.3, (B, 3)).astype(np.float32)
    np.testing.assert_allclose(
        A.rgb_to_hsv_cv2(torch.from_numpy(rgb)).numpy(),
        np.asarray(JA.rgb_to_hsv_cv2(jnp.asarray(rgb))), rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(
        A.hsv_jitter_batched(torch.from_numpy(rgb),
                             torch.from_numpy(gains)).numpy(),
        np.asarray(jax.jit(JA.hsv_jitter_batched)(jnp.asarray(rgb),
                                                  jnp.asarray(gains))))
    np.testing.assert_allclose(
        A.gaussian_blur(torch.from_numpy(rgb)).numpy(),
        np.asarray(JA.gaussian_blur(jnp.asarray(rgb))), rtol=1e-5, atol=1e-3)


def test_oracle_hsv_to_rgb_matches_jax():
    rng = np.random.default_rng(43)
    rgb = rng.integers(0, 256, (B, 8, 9, 3)).astype(np.float32)
    hsv = np.array(JA.rgb_to_hsv_cv2(jnp.asarray(rgb)))
    got = A.hsv_to_rgb_cv2(torch.from_numpy(hsv)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax.jit(JA.hsv_to_rgb_cv2)(jnp.asarray(hsv))),
        rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got, rgb, atol=1e-3)   # the round trip


def test_sampler_distributions():
    """The torch sampler is held to the JAX sampler's distributions, not to
    its stream: rates of flip (0.5), blur and rotation (0.25) and their
    prefix/suffix forms, the ranges of every draw."""
    g = torch.Generator().manual_seed(0)
    n = 20000
    p = A.sample_augment_params(g, n, scale_range=(0.25, 2.0), hue=0.1,
                                sat=0.7, val=0.3)
    assert abs(p["flip"].float().mean() - 0.5) < 0.02
    assert abs(p["blur"].float().mean() - 0.25) < 0.02
    rot = p["angle"] != 0
    assert abs(rot.float().mean() - 0.25 * 20 / 21) < 0.02
    a = p["angle"][rot]
    assert a.min() == -10 and a.max() == 10 and torch.equal(a, a.round())
    assert 0.25 <= p["scale"].min() and p["scale"].max() <= 2.0
    lo, hi = 0.7 / 1.3, 1.3 / 0.7
    assert lo <= p["ar_jitter"].min() and p["ar_jitter"].max() <= hi
    for k in ("dx_frac", "dy_frac"):
        assert 0.0 <= p[k].min() and p[k].max() < 1.0
    dev = (p["gains"] - 1.0).abs().max(0).values
    assert torch.all(dev <= torch.tensor([0.1, 0.7, 0.3]) + 1e-6)
    assert torch.all(dev >= torch.tensor([0.09, 0.6, 0.25]))
    q = A.sample_augment_params(g, 8, rotate_prefix=2, blur_suffix=2)
    assert not q["blur"][:6].any() and q["blur"][6:].all()
    assert (q["angle"][2:] == 0).all()


def test_train_aug_of_the_step_uses_prefix_and_suffix():
    from cervical_tpu_torch.config import SegTrainConfig
    from cervical_tpu_torch.train.seg_trainer import _sample_step_aug_params
    p = _sample_step_aug_params(SegTrainConfig(),
                                torch.Generator().manual_seed(3), 16)
    assert p["blur"].tolist() == [False] * 12 + [True] * 4
    assert (p["angle"][4:] == 0).all()


# ---------------------------------------------------------------------------
# the eval step's letterbox (ops/warp_xla)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src", [(S, S), (40, 64), (96, 72)])
def test_letterbox_einsum_matches_jax(src):
    from cervical_tpu.ops.warp_xla import augment_batch_einsum as jeinsum
    from cervical_tpu_torch.ops.warp_xla import augment_batch_einsum
    images, labels = _data(43, src)
    jp = JA.letterbox_params_like(B, src, (S, S))
    wi, wl = jeinsum(jnp.asarray(images), jnp.asarray(labels), jp, (S, S),
                     letterbox=True)
    gi, gl = augment_batch_einsum(torch.from_numpy(images),
                                  torch.from_numpy(labels),
                                  A.letterbox_params_like(B, src, (S, S)),
                                  (S, S), letterbox=True)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    _one_step_ok(gi.float().numpy(), wi, max_share=1e-2)
    with pytest.raises(NotImplementedError):
        augment_batch_einsum(torch.from_numpy(images),
                             torch.from_numpy(labels),
                             A.letterbox_params_like(B, src, (S, S)), (S, S))
