"""Shared helpers of the ``test_torch_port_*`` files: seeded weights made with
numpy for the port's DeepLab, and their flax counterparts through the JAX
package's own importer."""

import numpy as np
import pytest
import torch


def random_state(model, seed, closing="sepconv3.bn2"):
    """A ``state_dict`` for ``model`` with every float tensor drawn from
    ``np.random.default_rng(seed)``: kaiming-scaled kernels, BN scale ~1,
    running var in [0.8, 1.2].  The BN closing each residual branch
    (``closing``: Xception's ``sepconv3.bn2``, a ResNet's ``bn3``) scales
    by ~0.1, so the 20 residual blocks grow activations only ~10x while
    the logits still depend strongly on every block (a 10% change of the
    middle flow's pointwise weights moves them by O(1), and the argmax
    takes several classes)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if not v.dtype.is_floating_point:
            out[k] = v.clone()
            continue
        if k.endswith("running_var"):
            a = 0.8 + 0.4 * rng.random(shape)
        elif k.endswith("running_mean"):
            a = 0.05 * rng.standard_normal(shape)
        elif v.ndim == 1 and k.endswith(".weight"):  # BN scale
            loc = 0.1 if closing in k else 1.0
            a = loc + 0.02 * rng.standard_normal(shape)
        elif v.ndim == 1:  # biases
            a = 0.05 * rng.standard_normal(shape)
        else:
            fan_in = int(np.prod(shape[1:]))
            a = np.sqrt(2.0 / max(fan_in, 1)) * rng.standard_normal(shape)
        out[k] = torch.from_numpy(a.astype(np.float32))
    return out


def to_flax(state, backbone="xception"):
    """Port ``state_dict`` -> (params, batch_stats) through
    ``cervical_tpu.train.torch_import.convert_deeplab``."""
    from cervical_tpu.train import torch_import as TI
    sd = {k: v.numpy() for k, v in state.items() if v.dtype.is_floating_point}
    params, stats, missing = TI.convert_deeplab(sd, backbone, strict=True)
    assert not missing
    return params, stats


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Caps torch's intra-op threads at 2 for a test module (autouse where
    imported): the Tier-1 run shares 8 cores among 6 workers, and a
    full-width model trained by 8 threads in each worker spends its time
    spinning, not computing.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def fit_overrides(root, save_dir, size, **kw):
    """Config overrides of the fit tests: a synthetic VOC at ``root``,
    ``size``² input, the kernel augmentation, float32, batch 8."""
    over = {"data": {"input_shape": [size, size], "aug_backend": "pallas",
                     "dataset_path": root},
            "dtype": "float32", "save_dir": save_dir,
            "freeze_batch_size": 8, "unfreeze_batch_size": 8,
            "eval_batch_size": 8}
    over.update(kw)
    return over


def tiny_jax_state():
    """A stand-in JAX ``TrainState`` of a few numbers, for exercising the
    JAX package's checkpoint policy and fit bookkeeping without building
    its model."""
    import jax.numpy as jnp
    from cervical_tpu.train.seg_trainer import TrainState
    one = jnp.ones(2)
    return TrainState(step=jnp.zeros((), jnp.int32), params={"w": one},
                      batch_stats={"m": one}, opt_state={"mu": one})


def scaled_atol(ref, floor=5e-4, rel=2e-4):
    """Absolute tolerance for fp32 logits after ~100 convs: both stacks
    round in fp32 in another order, so the error grows with the scale."""
    return max(floor, rel * float(np.abs(ref).max()))


FUSION_IN, FUSION_HIDDEN = 32, 64  # tests/test_torch_fusion_parity.py's


def fusion_feats(mods, b, seed, in_features=FUSION_IN):
    """Seeded numpy node features ``{m: (b, nodes, in_features)}``."""
    rng = np.random.default_rng(seed)
    return {m: rng.normal(size=(b, 4 if m == "cli" else 16, in_features)
                          ).astype(np.float32) for m in mods}


def fusion_pair(mods, seed=0, in_features=FUSION_IN, hidden=FUSION_HIDDEN,
                mix=True):
    """(JAX ``FusionMAE``, its numpy params initialised from ``seed``, the
    port's ``FusionMAE`` in eval mode holding the same weights through
    ``fusion_from_flax``)."""
    import jax
    import jax.numpy as jnp
    from cervical_tpu.models.fusion import FusionMAE as JFusion
    from cervical_tpu_torch.models.fusion import FusionMAE
    from cervical_tpu_torch.train.flax_import import fusion_from_flax

    jm = JFusion(modalities=tuple(mods), in_features=in_features,
                 hidden=hidden, mix=mix)
    feats = {m: jnp.asarray(v) for m, v in
             fusion_feats(mods, 1, 0, in_features).items()}
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(seed), feats)["params"])
    pm = FusionMAE(tuple(mods), in_features, hidden, mix=mix).eval()
    pm.load_state_dict(fusion_from_flax(params), strict=True)
    return jm, params, pm


def run_ranks(task, world, workdir, spec, timeout=240):
    """Run ``task`` of ``tests/_torch_port_parallel_worker.py`` in ``world``
    gloo processes joined by a ``FileStore`` in ``workdir`` (no TCP port:
    the Tier-1 workers run side by side); returns each rank's output.  A
    rank that exits non-zero fails the caller with its log."""
    import os
    import subprocess
    import sys

    os.makedirs(workdir, exist_ok=True)
    torch.save(spec, os.path.join(workdir, "spec.pt"))
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_torch_port_parallel_worker.py")
    store = "file://" + os.path.join(workdir, "store")
    procs = [subprocess.Popen([sys.executable, worker, task, str(r),
                               str(world), store, str(workdir)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n" \
            + log[-4000:]
    return [torch.load(os.path.join(workdir, f"out{r}.pt"),
                       weights_only=False) for r in range(world)]


def _toward_zero_f32(x):
    """f64 ``x`` cut to an f32 value toward zero (as f64)."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)),
                       f).double()


def split_gemm_model(a, w, k_tile=32, promote=True):
    """CPU model of ``mf_pw_gemm_f32``'s sum ``a @ w`` (a (M, K), w (K, N),
    f32) from the TF32 parts of both (``middle_flow.tf32_split``): per k8
    step the products A_hi W_lo, A_lo W_hi, A_hi W_hi (in that order), each
    step's 8 products (exact in f64) added to the accumulator and the
    result cut to f32 toward zero, as a tensor core's adder that truncates
    rather than rounds would (the pessimistic case).  With ``promote`` each
    k-tile of ``k_tile`` starts a fresh accumulator, which is then added to
    an f32 sum rounded to nearest, as the kernel does; without, one
    accumulator runs over all of K."""
    from cervical_tpu_torch.ops.middle_flow import tf32_split
    ah, al = (t.double() for t in tf32_split(a))
    wh, wl = (t.double() for t in tf32_split(w))
    m, k = a.shape
    total = torch.zeros(m, w.shape[1])
    part = torch.zeros(m, w.shape[1], dtype=torch.float64)
    for k0 in range(0, k, 8):
        if promote and k0 % k_tile == 0:
            part = torch.zeros_like(part)
        s = slice(k0, min(k0 + 8, k))
        for x, y in ((ah, wl), (al, wh), (ah, wh)):
            part = _toward_zero_f32(part + x[:, s] @ y[s])
        if promote and ((k0 + 8) % k_tile == 0 or k0 + 8 >= k):
            total = total + part.float()
    return total if promote else part.float()
