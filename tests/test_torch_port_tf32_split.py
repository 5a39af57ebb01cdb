"""The f32 product's split form (``mf_pw_gemm_f32``, 3xTF32), on the CPU.

``middle_flow.tf32_split`` is the plain version of the kernel's operand
split (``cvt.rna.tf32.f32`` twice; the card holds the two bit for bit in
``test_torch_port_cuda.py``).  ``torch_port_helpers.split_gemm_model``
repeats the kernel's sum in the pessimistic case of a tensor core that
truncates its sums: held against an f64 product and against
``torch.matmul`` within ``chip_smoke.py``'s f32 limits, and, inside the
middle flow, against JAX's ``middle_flow_reference`` in f32.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import chip_smoke as CS
from cervical_tpu.ops import pallas_xception as PX
from cervical_tpu_torch.ops import middle_flow as MF
from torch_port_helpers import split_gemm_model


def _rna_reference(x):
    """x rounded to 11 significant bits, to nearest, ties away from zero,
    by frexp in f64 (no bit arithmetic)."""
    x = x.astype(np.float64)
    m, e = np.frexp(np.abs(x))  # |x| = m 2^e, m in [0.5, 1)
    r = np.floor(m * 2.0 ** 11 + 0.5)
    return (np.sign(x) * np.ldexp(r, e - 11)).astype(np.float32)


def _cases(name):
    rng = np.random.default_rng(7)
    one = np.float32(1.0)
    if name == "normal":
        return rng.standard_normal(20000).astype(np.float32)
    if name == "tiny_and_huge":
        return (rng.standard_normal(20000) * 10.0 ** rng.integers(
            -30, 30, 20000)).astype(np.float32)
    if name == "ties":  # exactly half of TF32's last unit above 1 + k 2^-10
        k = np.arange(1, 1000, dtype=np.float64)
        t = 1.0 + k * 2.0 ** -10 + 2.0 ** -11
        return np.concatenate([t, -t, t * 2.0 ** 40]).astype(np.float32)
    if name == "carry":  # rounding up carries into the exponent
        return np.array([2 - 2 ** -12, -(4 - 2 ** -11), 2 - 2 ** -23,
                         0.5 - 2 ** -14], np.float32)
    if name == "exact":  # already TF32: lo is 0
        return np.array([0.0, -0.0, one, -3.5, 2.0 ** -100, 1.0 + 2 ** -10],
                        np.float32)
    if name == "just_below_tie":
        k = np.arange(1, 500, dtype=np.float64)
        t = 1.0 + k * 2.0 ** -10 + 2.0 ** -11 - 2.0 ** -23
        return t.astype(np.float32)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["normal", "tiny_and_huge", "ties", "carry",
                                  "exact", "just_below_tie"])
def test_tf32_split_identities(name):
    """hi rounds x to TF32 to nearest, ties away (as frexp says); hi and lo
    have their 13 low mantissa bits zero (TF32 in an f32); x - hi is exact
    and lo is its TF32 rounding, so |x - hi - lo| <= 2^-22 |x|."""
    x = _cases(name)
    xt = torch.from_numpy(x)
    hi, lo = MF.tf32_split(xt)
    assert np.array_equal(hi.numpy(), _rna_reference(x))
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    rest = xt.double() - hi.double()
    assert torch.equal(rest.float().double(), rest)  # exact in f32
    assert np.array_equal(lo.numpy(), _rna_reference(rest.float().numpy()))
    err = (xt.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * xt.double().abs()).all())


def _smoke_operands(m, seed):
    """zb and W as chip_smoke.py draws them: N(0, 1) and N(0, 1.5^2 / K)."""
    g = torch.Generator().manual_seed(seed)
    zb = torch.randn(m, 728, generator=g)
    w = torch.randn(728, 728, generator=g) * (1.5 / 728 ** 0.5)
    return zb, w


def test_split_product_model_within_the_smoke_limits():
    """At the main path's K = N = 728: the modelled kernel sum is within
    ``F32_GEMM_RTOL`` of |zb| @ |W| from ``torch.matmul`` in f32, and its
    largest error from an f64 product is at most twice ``torch.matmul``'s
    (the smoke's two checks), with the tensor cores' sums truncated."""
    zb, w = _smoke_operands(192, 0)
    got = split_gemm_model(zb, w)
    ref = zb @ w
    exact = zb.double() @ w.double()
    ratio = CS.f32_gemm_ratio(got, ref, zb, w)
    e_model = (got.double() - exact).abs().max().item()
    e_mm = (ref.double() - exact).abs().max().item()
    print(f"model: {ratio:.3g} of |zb| @ |W| from torch.matmul; max |err| "
          f"from f64 {e_model:.3g} against torch.matmul's {e_mm:.3g}")
    assert ratio <= CS.F32_GEMM_RTOL
    assert e_model <= 2 * e_mm


def test_one_unpromoted_accumulator_fails_the_f64_check():
    """Why the kernel promotes: in one accumulator over all of K, 273
    truncated sums (91 k8 steps x 3 products) bias the result toward zero
    and the largest error from f64 outgrows twice ``torch.matmul``'s."""
    zb, w = _smoke_operands(192, 0)
    exact = zb.double() @ w.double()
    e_one = (split_gemm_model(zb, w, promote=False).double()
             - exact).abs().max().item()
    e_mm = ((zb @ w).double() - exact).abs().max().item()
    print(f"one accumulator: max |err| from f64 {e_one:.3g} against "
          f"torch.matmul's {e_mm:.3g}")
    assert e_one > 2 * e_mm


def _random_folded(seed, nblk, c):
    rng = np.random.default_rng(seed)
    return {
        "wdw": (rng.standard_normal((nblk, 27, c)) * 0.2).astype(np.float32),
        "s1": rng.uniform(0.5, 1.5, (nblk, 3, c)).astype(np.float32),
        "c1": (rng.standard_normal((nblk, 3, c)) * 0.1).astype(np.float32),
        "wpw": (rng.standard_normal((nblk, 3, c, c))
                * (1.5 / np.sqrt(c))).astype(np.float32),
        "c2": (rng.standard_normal((nblk, 3, c)) * 0.1).astype(np.float32),
    }


def _model_gemm(zb, w, c2, skip_src=None):
    """``pw_gemm_reference`` with the product from ``split_gemm_model``."""
    k = zb.shape[-1]
    z = split_gemm_model(zb.reshape(-1, k), w).view(*zb.shape[:3], -1) + c2
    return z if skip_src is None else z + torch.relu(skip_src)


@pytest.mark.parametrize("nblk,c,dilation", [(1, 16, 1), (2, 16, 2),
                                             (1, 32, 2), (2, 32, 1)])
def test_split_middle_flow_matches_jax_f32(nblk, c, dilation):
    """The f32 middle flow with each product from the model against JAX's
    ``middle_flow_reference`` in f32 on the same numpy inputs: each block
    within ``F32_BLOCK_RTOL`` and the chain within ``F32_CHAIN_RTOL`` of
    the largest output magnitude, the smoke's limits on the card."""
    folded = _random_folded(nblk * 10 + c, nblk, c)
    x = np.random.default_rng(c + dilation).standard_normal(
        (2, 9, 7, c)).astype(np.float32)
    tf = {k: torch.from_numpy(v) for k, v in folded.items()}
    jf = {k: jnp.asarray(v) for k, v in folded.items()}
    xt = torch.from_numpy(x)
    chain = MF._middle_flow(xt, tf, dilation, MF.dw_stencil_reference,
                            _model_gemm)
    want = np.asarray(PX.middle_flow_reference(jnp.asarray(x), jf,
                                               dilation=dilation))
    scale = np.abs(want).max()
    assert np.abs(chain.numpy() - want).max() <= CS.F32_CHAIN_RTOL * scale
    xk = x
    for k in range(nblk):
        part = {n: v[k:k + 1] for n, v in tf.items()}
        got = MF._middle_flow(torch.from_numpy(xk), part, dilation,
                              MF.dw_stencil_reference, _model_gemm).numpy()
        ref = np.asarray(PX.middle_flow_reference(
            jnp.asarray(xk), {n: v[k:k + 1] for n, v in jf.items()},
            dilation=dilation))
        assert np.abs(got - ref).max() <= CS.F32_BLOCK_RTOL * \
            np.abs(ref).max()
        xk = np.array(ref)
