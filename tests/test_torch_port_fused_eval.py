"""The f32 eval path with the fused middle flow against the JAX package:
``SegTrainer(fused_middle_eval=True)`` at ``dtype="float32"`` (xception,
os16, 64², 5 classes) on both sides, from one set of weights and the same
few validation images.  JAX runs its middle-flow Pallas kernel in
interpret mode on the CPU (as its own tests run it), the port the plain
version of its f32 kernels; both fold the middle flow at float32, so
nothing rounds between the ops.

``evaluate_miou`` over a ragged loader (6 images at batch 4, the tail
padded with weight-0 rows): the confusion matrices are equal.  The eval
step on each padded batch: the losses within 1e-5 relative (f32 sums in
another order through ~100 convolutions), the matrices equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cervical_tpu.config import SegDataConfig as JData
from cervical_tpu.config import SegTrainConfig as JCfg
from cervical_tpu.data.voc import ArraySegDataset as JArrays
from cervical_tpu.data.voc import BatchLoader as JLoader
from cervical_tpu.train import seg_trainer as JT
from cervical_tpu_torch.config import SegDataConfig, SegTrainConfig
from cervical_tpu_torch.data.resident import ResidentSegData
from cervical_tpu_torch.data.voc import ArraySegDataset, BatchLoader
from cervical_tpu_torch.models.deeplab import DeepLab
from cervical_tpu_torch.ops import middle_flow as MF
from cervical_tpu_torch.train import seg_trainer as PT

from torch_port_helpers import (random_state, to_flax,
                                two_torch_threads)  # noqa: F401

HW, N, B = (64, 64), 6, 4


@pytest.fixture(scope="module")
def case():
    state = random_state(DeepLab(num_classes=5), seed=81)
    rng = np.random.default_rng(82)
    images = rng.integers(0, 256, (N,) + HW + (3,)).astype(np.uint8)
    labels = rng.integers(0, 5, (N,) + HW).astype(np.uint8)
    labels[1, :8] = 5  # ignored pixels (class id past the last)

    jt = JT.SegTrainer(JCfg(data=JData(input_shape=HW, num_classes=5),
                            backbone="xception", dtype="float32",
                            fused_middle_eval=True, num_devices=1))
    params, stats = to_flax(state)
    jt.state = jt.state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    pt = PT.SegTrainer(SegTrainConfig(data=SegDataConfig(input_shape=HW),
                                      dtype="float32",
                                      fused_middle_eval=True), device="cpu")
    pt.state.model.load_state_dict(state)
    assert pt.state.model.backbone.fused_middle
    return jt, pt, images, labels


def _padded_batches():
    """(rows, weights) of the ragged loader's batches: the tail repeats
    row 0 with weight 0."""
    for s in range(0, N, B):
        rows = list(range(s, min(s + B, N)))
        w = [1.0] * len(rows) + [0.0] * (B - len(rows))
        yield rows + [0] * (B - len(rows)), np.asarray(w, np.float32)


def test_fused_f32_evaluate_miou_matches_jax(case):
    """Host-fed and resident ``evaluate_miou`` of the port both give JAX's
    matrix exactly, counting each labelled pixel once."""
    jt, pt, images, labels = case
    want = jt.evaluate_miou(JLoader(JArrays(images, labels), B,
                                    shuffle=False, drop_last=False))["hist"]
    MF.reset_launches()
    got = pt.evaluate_miou(BatchLoader(ArraySegDataset(images, labels), B,
                                       shuffle=False, drop_last=False))["hist"]
    res = pt.evaluate_miou(ResidentSegData.from_arrays(
        images, labels, B, "cpu", train=False))["hist"]
    assert MF.LAUNCHES == {"dw_stencil": 0, "pw_gemm": 0}  # CPU: plain
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(res, got)
    assert got.sum() == int((labels < 5).sum())


def test_fused_f32_eval_step_losses_match_jax(case):
    jt, pt, images, labels = case
    jstep, pstep = jt._eval_step(), pt._eval_step()
    for rows, w in _padded_batches():
        want = jstep(jt.state, jnp.asarray(images[rows]),
                     jnp.asarray(labels[rows]), jnp.asarray(w))
        got = pstep(pt.state, torch.from_numpy(images[rows]),
                    torch.from_numpy(labels[rows]), torch.from_numpy(w))
        for k in ("loss", "f_score"):
            a, b = float(got[k]), float(want[k])
            print(f"rows {rows}: {k} port {a:.9g} jax {b:.9g} rel "
                  f"{abs(a - b) / abs(b):.3g}")
            assert abs(a - b) <= 1e-5 * abs(b), (k, a, b)
        np.testing.assert_array_equal(got["hist"].numpy(),
                                      np.asarray(want["hist"]))
