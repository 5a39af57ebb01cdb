"""Port ``ops/middle_flow.py`` vs ``cervical_tpu.ops.pallas_xception``.

The plain PyTorch version is held against the JAX kernel in interpret mode
and against its jnp oracle on the same numpy inputs; the BN fold against
the JAX fold on carried weights.  The CUDA kernels are held against the
plain version only on the card (they have no interpret mode), in
``test_torch_port_cuda.py``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cervical_tpu.ops import pallas_xception as PX
from cervical_tpu_torch.ops import _build
from cervical_tpu_torch.ops import middle_flow as MF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_folded(seed, nblk, c):
    """Folded weights scaled like tests/test_pallas_xception.py: small
    magnitudes keep a block chain numerically tame."""
    rng = np.random.default_rng(seed)
    return {
        "wdw": (rng.standard_normal((nblk, 27, c)) * 0.2).astype(np.float32),
        "s1": rng.uniform(0.5, 1.5, (nblk, 3, c)).astype(np.float32),
        "c1": (rng.standard_normal((nblk, 3, c)) * 0.1).astype(np.float32),
        "wpw": (rng.standard_normal((nblk, 3, c, c))
                * (1.5 / np.sqrt(c))).astype(np.float32),
        "c2": (rng.standard_normal((nblk, 3, c)) * 0.1).astype(np.float32),
    }


def _jax(folded, dtype):
    return {k: jnp.asarray(v).astype(dtype) if k in ("wdw", "wpw")
            else jnp.asarray(v) for k, v in folded.items()}


def _torch(folded, dtype, device="cpu"):
    return {k: torch.from_numpy(v).to(device, dtype if k in ("wdw", "wpw")
                                      else torch.float32)
            for k, v in folded.items()}


@pytest.mark.parametrize("dilation", [1, 2])
def test_plain_matches_jax_f32(dilation):
    """f32: the same ops in the same order; 1e-5 covers matmul summation
    order (JAX's tolerance for its own kernel vs oracle)."""
    nblk, b, h, w, c = 3, 2, 8, 8, 16
    folded = _random_folded(0, nblk, c)
    x = np.random.default_rng(1).standard_normal((b, h, w, c)).astype(np.float32)
    got = MF.middle_flow_reference(torch.from_numpy(x),
                                   _torch(folded, torch.float32), dilation)
    kern = PX.middle_flow_eval(jnp.asarray(x), _jax(folded, jnp.float32),
                               dilation=dilation, interpret=True)
    oracle = PX.middle_flow_reference(jnp.asarray(x), _jax(folded, jnp.float32),
                                      dilation=dilation)
    for ref in (kern, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dilation", [1, 2])
def test_plain_matches_jax_bf16(dilation):
    """bf16: zb and block outputs round to bf16 on both sides; a 1-ulp flip
    from f32 summation order is up to 2^-8 relative, hence 1e-2 (JAX's
    bf16 tolerance for its kernel)."""
    nblk, b, h, w, c = 2, 2, 10, 10, 16
    folded = _random_folded(2, nblk, c)
    x = np.random.default_rng(3).standard_normal((b, h, w, c)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = MF.middle_flow_reference(xt, _torch(folded, torch.bfloat16),
                                   dilation).float().numpy()
    kern = PX.middle_flow_eval(xj, _jax(folded, jnp.bfloat16),
                               dilation=dilation, interpret=True)
    oracle = PX.middle_flow_reference(xj, _jax(folded, jnp.bfloat16),
                                      dilation=dilation)
    for ref in (kern, oracle):
        np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                                   rtol=1e-2, atol=1e-2)


def test_eval_on_cpu_is_the_plain_version():
    folded = _torch(_random_folded(4, 2, 16), torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 6, 6, 16)).astype(np.float32)).to(torch.bfloat16)
    MF.reset_launches()
    np.testing.assert_array_equal(
        MF.middle_flow_eval(x, folded, 2).float().numpy(),
        MF.middle_flow_reference(x, folded, 2).float().numpy())
    assert MF.LAUNCHES == {"dw_stencil": 0, "pw_gemm": 0}


class _MiniMiddle(torch.nn.Module):
    """Port blocks 4..4+n at narrow width, for the fold."""

    def __init__(self, c, nblk):
        super().__init__()
        from cervical_tpu_torch.models.backbones.xception import XceptionBlock
        self.nblk = nblk
        for i in range(4, 4 + nblk):
            setattr(self, f"block{i}", XceptionBlock(c, c, 1))

    def forward(self, x):
        for i in range(4, 4 + self.nblk):
            x, _ = getattr(self, f"block{i}")(x)
        return x


def _mini_with_weights(c, nblk, seed):
    from torch_port_helpers import random_state
    mini = _MiniMiddle(c, nblk)
    state = random_state(mini, seed)
    mini.load_state_dict(state)
    return mini.eval(), state


def _flax_variables(state, nblk):
    """The flax block variables for the same weights (torch_import's
    conventions: OIHW -> HWIO, BN weight/bias/mean/var ->
    scale/bias/mean/var)."""
    params, stats = {}, {}
    hwio = lambda t: np.transpose(t.numpy(), (2, 3, 1, 0))  # noqa: E731
    for b in range(4, 4 + nblk):
        for i in (1, 2, 3):
            pre = f"block{b}.sepconv{i}"
            p = params.setdefault(f"block{b}", {}).setdefault(f"sepconv{i}", {})
            s = stats.setdefault(f"block{b}", {}).setdefault(f"sepconv{i}", {})
            p["depthwise"] = {"kernel": hwio(state[pre + ".depthwise.weight"])}
            p["pointwise"] = {"kernel": hwio(state[pre + ".pointwise.weight"])}
            for bn in ("bn1", "bn2"):
                p[bn] = {"scale": state[f"{pre}.{bn}.weight"].numpy(),
                         "bias": state[f"{pre}.{bn}.bias"].numpy()}
                s[bn] = {"mean": state[f"{pre}.{bn}.running_mean"].numpy(),
                         "var": state[f"{pre}.{bn}.running_var"].numpy()}
    return {"params": params, "batch_stats": stats}


def test_fold_matches_jax_fold():
    """Same carried weights through both folds, f32: rsqrt and products
    in fp32 on both sides, 1e-6 relative."""
    c, nblk = 32, 3
    mini, state = _mini_with_weights(c, nblk, seed=6)
    got = MF.fold_middle_flow(mini, first=4, count=nblk,
                              compute_dtype=torch.float32)
    ref = PX.fold_middle_flow(_flax_variables(state, nblk), first=4,
                              count=nblk, compute_dtype=jnp.float32)
    for k in ("wdw", "s1", "c1", "wpw", "c2"):
        assert tuple(got[k].shape) == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("dilation", [1, 2])
def test_fold_and_plain_match_port_blocks(dilation):
    """Structural check inside the port (f32): fold + plain middle flow
    reproduce the unfused port blocks (BN folding, relu(x) skip, tap
    layout).  2e-4 as JAX's fold-vs-flax test: the fold reassociates the
    BN scale into the pointwise weights."""
    c, nblk = 32, 3
    mini, _ = _mini_with_weights(c, nblk, seed=7)
    for i in range(4, 4 + nblk):
        for k in (1, 2, 3):
            getattr(getattr(mini, f"block{i}"), f"sepconv{k}").depthwise \
                .dilation = dilation
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 9, 9, c)).astype(np.float32) * 2)
    with torch.no_grad():
        ref = mini(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        folded = MF.fold_middle_flow(mini, first=4, count=nblk,
                                     compute_dtype=torch.float32)
        got = MF.middle_flow_reference(x, folded, dilation)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4, atol=2e-4)


def test_kernel_module_imports_without_nvcc(tmp_path):
    """Importing the kernel module builds nothing and needs no nvcc."""
    env = dict(os.environ, PATH=str(tmp_path), PYTHONPATH=REPO)
    env.pop("CUDA_HOME", None)
    code = ("import cervical_tpu_torch.ops.middle_flow as MF, "
            "cervical_tpu_torch.ops._build as B; "
            "assert MF._lib_handle is None and not B._loaded; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the kernel wrappers raise before building anything;
    only middle_flow_eval routes CPU tensors to the plain version."""
    z = torch.zeros(1, 4, 4, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        MF.dw_stencil(z, torch.zeros(9, 16, dtype=torch.bfloat16),
                      torch.zeros(16), torch.zeros(16), 1)
    with pytest.raises(ValueError, match="CUDA"):
        MF.pw_gemm(z, torch.zeros(16, 16, dtype=torch.bfloat16),
                   torch.zeros(16))
    with pytest.raises(ValueError, match="multiples of 8"):
        MF.pw_gemm(z[..., :12], torch.zeros(12, 12, dtype=torch.bfloat16),
                   torch.zeros(12))
    assert MF._lib_handle is None


def test_library_path_follows_the_source(tmp_path):
    """A kernel library is named by a hash of its source: an edit rebuilds,
    an unchanged source is reused."""
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    p1 = _build.library_path(src)
    assert p1 == _build.library_path(src) and p1.parent == _build.BUILD_DIR
    src.write_text("// v2\n")
    assert _build.library_path(src) != p1
    assert _build.KERNEL_SOURCES == (MF.SOURCE,) and MF.SOURCE.exists()
