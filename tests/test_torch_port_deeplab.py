"""Port DeepLabV3+-Xception vs ``cervical_tpu.models.deeplab.DeepLab`` in
f32 eval mode at 64², on identical weights: the port's seeded
``state_dict`` goes through the JAX package's ``convert_deeplab``.  Plain
and ``fused_middle=True`` (JAX's fused path in interpret mode; the port's
on a CPU tensor is its plain middle flow)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cervical_tpu.models.deeplab import DeepLab as JaxDeepLab
from cervical_tpu.ops.depthwise import depthwise_conv3x3_reference
from cervical_tpu_torch.models.deeplab import DeepLab
from cervical_tpu_torch.ops.depthwise import depthwise_conv3x3

from torch_port_helpers import (random_state, scaled_atol, to_flax,
                                two_torch_threads)  # noqa: F401


@pytest.fixture(scope="module")
def setup():
    model = DeepLab(num_classes=5, backbone="xception", downsample_factor=16,
                    dtype=torch.float32)
    state = random_state(model, seed=21)
    model.load_state_dict(state)
    params, stats = to_flax(state)
    x = np.random.default_rng(22).standard_normal((2, 64, 64, 3)).astype(np.float32)
    return model.eval(), state, {"params": params, "batch_stats": stats}, x


def _port(model, x, fused):
    model.backbone.fused_middle = fused
    try:
        with torch.inference_mode():
            y = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    finally:
        model.backbone.fused_middle = False
    return y.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def jax_logits(setup):
    _, _, variables, x = setup
    out = {}
    for fused in (False, True):
        m = JaxDeepLab(num_classes=5, backbone="xception", downsample_factor=16,
                       dtype=jnp.float32, fused_middle=fused)
        out[fused] = np.asarray(jax.jit(
            lambda v, a, m=m: m.apply(v, a, train=False))(variables, x))
    return out


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused_middle"])
def test_deeplab_matches_jax_f32(setup, jax_logits, fused):
    """fp32 both sides; the tolerance scales with the logits, as in the
    torch-reference parity test (fp32 rounding through ~100 convs)."""
    model, _, _, x = setup
    ref = jax_logits[fused]
    got = _port(model, x, fused)
    assert got.shape == ref.shape == (2, 64, 64, 5)
    np.testing.assert_allclose(got, ref, atol=scaled_atol(ref), rtol=2e-3)


@pytest.mark.parametrize("ds", [16, 8])
def test_fused_matches_plain_inside_port(setup, ds):
    """The fused middle flow (fold + plain version on CPU) reproduces the
    unfused blocks in fp32 at os16 and os8 (dilation 2)."""
    _, state, _, x = setup
    model = DeepLab(num_classes=5, downsample_factor=ds, dtype=torch.float32)
    model.load_state_dict(state)
    model.eval()
    plain, fused = _port(model, x, False), _port(model, x, True)
    np.testing.assert_allclose(fused, plain, atol=scaled_atol(plain), rtol=2e-3)


def test_fold_cache_follows_weights(setup):
    """The cached fold is dropped by load_state_dict, train() and to()."""
    from cervical_tpu_torch.ops.middle_flow import fold_middle_flow
    model, state, _, x = setup
    before = _port(model, x, True)
    assert model.backbone._folded is not None
    bumped = {k: v * 1.1 if k.endswith("pointwise.weight") else v
              for k, v in state.items()}
    model.load_state_dict(bumped)
    assert model.backbone._folded is None
    try:
        after, plain = _port(model, x, True), _port(model, x, False)
        fresh = fold_middle_flow(model.backbone, compute_dtype=torch.float32)
        torch.testing.assert_close(model.backbone._folded, fresh, rtol=0,
                                   atol=0)
    finally:
        model.load_state_dict(state)
    assert np.abs(after - before).max() > 1e-2
    np.testing.assert_allclose(after, plain, atol=scaled_atol(plain), rtol=2e-3)
    for drop in (lambda m: m.train(False), lambda m: m.to(torch.float32)):
        _port(model, x, True)
        drop(model)
        assert model.backbone._folded is None


@pytest.mark.parametrize("stride,dilation",
                         [(1, 1), (2, 1), (1, 2), (1, 3), (1, 4)])
def test_depthwise_matches_jax(stride, dilation):
    rng = np.random.default_rng(23)
    x = rng.standard_normal((2, 9, 11, 8)).astype(np.float32)
    k = rng.standard_normal((3, 3, 1, 8)).astype(np.float32)
    ref = np.asarray(depthwise_conv3x3_reference(jnp.asarray(x), jnp.asarray(k),
                                                 stride, dilation))
    got = depthwise_conv3x3(torch.from_numpy(x), torch.from_numpy(k), stride,
                            dilation).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_unported_backbone_and_stride_raise():
    """MobileNetV2 builds (320 channels into ASPP, 24 into the shortcut);
    the fused middle flow is xception-only and output stride 32 is
    unsupported, as in JAX; an unknown backbone raises."""
    model = DeepLab(backbone="mobilenet")
    assert model.aspp.branch1[0].in_channels == 320
    assert model.shortcut_conv[0].in_channels == 24
    with pytest.raises(ValueError, match="xception-only"):
        DeepLab(backbone="mobilenet", fused_middle=True)
    for backbone in ("xception", "mobilenet"):
        with pytest.raises(ValueError):
            DeepLab(backbone=backbone, downsample_factor=32)
    with pytest.raises(ValueError):
        DeepLab(backbone="resnet")
