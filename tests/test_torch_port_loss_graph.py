"""The port's ``seg_trainer.seg_loss_fn`` and ``ops.graph.
edge_index_from_adjacency`` against the JAX package's, on the same numpy
inputs; ``seg_loss_fn`` also against the port's own fused loss bundle at
the model's quarter-resolution logits, as ``tests/test_losses.py`` holds
JAX's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cervical_tpu import config as JC
from cervical_tpu.ops import graph as JG
from cervical_tpu.ops.image import one_hot_with_ignore as jax_one_hot
from cervical_tpu.train import seg_trainer as JST
from cervical_tpu_torch import losses
from cervical_tpu_torch.config import SegDataConfig, SegTrainConfig
from cervical_tpu_torch.ops import graph as G
from cervical_tpu_torch.ops.image import one_hot_with_ignore
from cervical_tpu_torch.train import seg_trainer as T

NC = 5


def _inputs(seed=3, b=3, h=16, w=12):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((b, h, w, NC))).astype(np.float32)
    labels = rng.integers(0, NC + 1, (b, h, w)).astype(np.int32)  # 5: ignore
    one_hot = np.array(jax_one_hot(jnp.asarray(labels), NC))
    return logits, labels, one_hot


@pytest.mark.parametrize("weights", [None, (1.0, 0.0, 0.5)],
                         ids=["unweighted", "sample_weights"])
@pytest.mark.parametrize("dice", [True, False], ids=["dice", "no_dice"])
@pytest.mark.parametrize("focal", [True, False], ids=["focal", "ce"])
def test_seg_loss_fn_matches_jax(focal, dice, weights):
    logits, labels, one_hot = _inputs()
    jcfg = JC.SegTrainConfig(data=JC.SegDataConfig(num_classes=NC),
                             focal_loss=focal, dice_loss=dice)
    cfg = SegTrainConfig(data=SegDataConfig(num_classes=NC),
                         focal_loss=focal, dice_loss=dice)
    jw = None if weights is None else jnp.asarray(weights, jnp.float32)
    tw = None if weights is None else torch.tensor(weights)
    j_total, j_main = JST.seg_loss_fn(jcfg, jnp.asarray(logits),
                                      jnp.asarray(labels),
                                      jnp.asarray(one_hot),
                                      sample_weights=jw)
    total, main = T.seg_loss_fn(cfg, torch.from_numpy(logits),
                                torch.from_numpy(labels),
                                torch.from_numpy(one_hot),
                                sample_weights=tw)
    np.testing.assert_allclose(total.numpy(), np.asarray(j_total),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(main.numpy(), np.asarray(j_main),
                               rtol=2e-5, atol=1e-6)
    if not dice:
        assert float(total) == float(main)


def test_seg_loss_fn_matches_bundle_at_resize():
    """The model's quarter-resolution logits through the bundle with
    ``resize_to`` equal the full-resolution logits through ``seg_loss_fn``
    (and ``losses.f_score``); the bundle's argmax is the full logits'."""
    cfg = SegTrainConfig(data=SegDataConfig(input_shape=(64, 64),
                                            num_classes=NC),
                         backbone="mobilenet", dtype="float32")
    model = T.build_model(cfg).eval()
    rng = np.random.default_rng(11)
    images = torch.from_numpy(
        rng.normal(size=(2, 3, 64, 64)).astype(np.float32))
    labels = torch.from_numpy(
        rng.integers(0, NC + 1, (2, 64, 64)).astype(np.int64))
    with torch.no_grad():
        full = model(images).permute(0, 2, 3, 1)
        quarter = model(images, resize_logits=False).permute(0, 2, 3, 1)
    assert full.shape == (2, 64, 64, NC) and quarter.shape[1] < 64
    one_hot = one_hot_with_ignore(labels, NC)
    total_ref, main_ref = T.seg_loss_fn(cfg, full, labels, one_hot)
    fs_ref = losses.f_score(full, one_hot)
    total, main, fs = T.seg_loss_bundle_fn(cfg, quarter, labels,
                                           resize_to=(64, 64))
    for got, ref in ((total, total_ref), (main, main_ref), (fs, fs_ref)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5,
                                   atol=1e-6)
    t2, _, _, preds = T.seg_loss_bundle_fn(cfg, quarter, labels,
                                           resize_to=(64, 64),
                                           return_preds=True)
    np.testing.assert_allclose(t2.numpy(), total_ref.numpy(), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(preds.numpy(),
                                  full.argmax(dim=-1).numpy())


@pytest.mark.parametrize("name", ["grid4x4", "full5", "random7"])
def test_edge_index_from_adjacency_matches_jax(name):
    adj = {"grid4x4": lambda: G.grid_adjacency(4, 4),
           "full5": lambda: G.full_adjacency(5),
           "random7": lambda: (np.random.default_rng(5).random((7, 7))
                               < 0.4).astype(np.float32)}[name]()
    ei = G.edge_index_from_adjacency(adj)
    ref = np.asarray(JG.edge_index_from_adjacency(adj))
    assert isinstance(ei, torch.Tensor) and ei.dtype == torch.int64
    assert ei.shape == (2, int(np.count_nonzero(adj)))
    np.testing.assert_array_equal(ei.numpy(), ref)
    # row-major: sorted by source, then target
    flat = ei[0] * adj.shape[1] + ei[1]
    assert torch.all(flat[1:] > flat[:-1])
