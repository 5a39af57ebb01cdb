"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels have no interpret
mode): on a host without CUDA each skips with its reason.  The file imports
no JAX, so the machine with the card runs it alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from cervical_tpu_torch.ops import middle_flow as MF


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels (middle flow, "
                    "warp, photometric) are CUDA only and have no interpret "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _random_folded(seed, nblk, c, device, dtype=torch.bfloat16):
    """Folded weights scaled like tests/test_pallas_xception.py, with the
    K-major copy the kernels read, as fold_middle_flow makes it; taps and
    pointwise weights in ``dtype``, the compute type."""
    rng = np.random.default_rng(seed)
    f = {"wdw": rng.standard_normal((nblk, 27, c)) * 0.2,
         "s1": rng.uniform(0.5, 1.5, (nblk, 3, c)),
         "c1": rng.standard_normal((nblk, 3, c)) * 0.1,
         "wpw": rng.standard_normal((nblk, 3, c, c)) * (1.5 / np.sqrt(c)),
         "c2": rng.standard_normal((nblk, 3, c)) * 0.1}
    out = {k: torch.from_numpy(v.astype(np.float32)).to(
        device, dtype if k in ("wdw", "wpw") else torch.float32)
        for k, v in f.items()}
    out["wpw_t"] = out["wpw"].transpose(-1, -2).contiguous()
    if dtype == torch.float32:
        out["wpw_t_split"] = torch.stack(MF.tf32_split(out["wpw_t"]), 2)
    return out


F32_GEMM_RTOL = 1e-5


def _assert_f32_gemm_close(got, ref, zb, w, skip=None):
    """The f32 GEMM against ``pw_gemm_reference`` (cuBLAS's SGEMM, TF32
    off): both sum K products in f32 in their own order, each within
    K 2^-24 (|zb| @ |w|) at worst (4.3e-5 of it at K = 728) and about
    sqrt(K) 2^-24 of it in practice, so |got - ref| <= 1e-5 (|zb| @ |w|) +
    1e-6; with the skip added after the sum, plus one rounding of the
    result (2^-24 relative)."""
    scale = torch.matmul(zb.abs().flatten(0, -2), w.abs()).view(ref.shape)
    bound = F32_GEMM_RTOL * scale + 1e-6
    if skip is not None:
        bound = bound + 2.0 ** -24 * ref.abs()
    err = (got - ref).abs()
    assert bool((err <= bound).all()), float((err / bound).max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("c", [32, 728])
def test_middle_flow_kernels_match_plain(cuda_device, c, dilation, dtype):
    """Odd spatial sizes and ragged C=728 tiles, each block held against the
    plain version on the same input.  bf16: f32 sums in another order flip
    bf16 roundings of zb and the block output, so rtol=atol=1e-2 as JAX
    holds its own kernel.  (Chained, the flips compound block by block:
    the whole-chain drift is what chip_smoke.py reports.)  f32: nothing is
    rounded between the ops, the stencils are bit-exact and the products
    differ from cuBLAS's by their sum order (~1e-6 of |zb| @ |w| per
    product, through three products and the skip): 1e-5 of the block
    output's largest magnitude."""
    folded = _random_folded(9, 3, c, cuda_device, dtype)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, 11, 13, c)).astype(np.float32)).to(cuda_device, dtype)
    MF.reset_launches()
    chained = MF.middle_flow_eval(x, folded, dilation)
    assert MF.LAUNCHES == {"dw_stencil": 9, "pw_gemm": 9}
    assert MF.F32_LAUNCHES == (MF.LAUNCHES if dtype == torch.float32 else
                               {"dw_stencil": 0, "pw_gemm": 0})
    for k in range(3):
        part = {n: v[k:k + 1] for n, v in folded.items()}
        got = MF.middle_flow_eval(x, part, dilation)
        torch.cuda.synchronize()
        ref = MF.middle_flow_reference(x, part, dilation)
        if dtype == torch.bfloat16:
            torch.testing.assert_close(got.float(), ref.float(), rtol=1e-2,
                                       atol=1e-2)
        else:
            assert got.dtype == torch.float32
            err = (got - ref).abs().max().item()
            assert err <= 1e-5 * ref.abs().max().item(), err
        x = got
    assert torch.equal(chained, x)  # the chain is the blocks one by one


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("c", [8, 40, 728])
def test_stencil_is_exact_and_gemm_close(cuda_device, c, dtype):
    """The stencil repeats the plain version's f32 ops in order without
    FMA: bit-exact.  bf16: the GEMM sums exact bf16 products in f32 in
    another order: 1e-4.  With a bf16 output that is one bf16 step (2^-7
    relative) plus the f32 sum's error where adding the skip cancels the
    value.  f32 (f32 taps, zb, weight and skip): the GEMM to
    ``_assert_f32_gemm_close``'s bound."""
    g = torch.Generator().manual_seed(c)
    z = torch.randn(3, 7, 5, c, generator=g).to(cuda_device)
    w9 = torch.randn(9, c, generator=g).to(cuda_device, dtype)
    s1 = torch.rand(c, generator=g).to(cuda_device) + 0.5
    c1 = torch.randn(c, generator=g).to(cuda_device)
    if dtype == torch.float32:
        got = MF.dw_stencil(z, w9, s1, c1, 2, dtype)
        assert got.dtype == torch.float32
        assert torch.equal(got, MF.dw_stencil_reference(z, w9, s1, c1, 2,
                                                        dtype))
        zb = torch.randn(3, 7, 5, c, generator=g).to(cuda_device)
        w = torch.randn(c, c, generator=g).to(cuda_device)
        w_t = torch.stack(MF.tf32_split(w.t().contiguous()), 0)
        c2 = torch.randn(c, generator=g).to(cuda_device)
        _assert_f32_gemm_close(MF.pw_gemm(zb, w_t, c2),
                               MF.pw_gemm_reference(zb, w, c2), zb, w)
        got = MF.pw_gemm(zb, w_t, c2, z)
        assert got.dtype == torch.float32
        _assert_f32_gemm_close(got, MF.pw_gemm_reference(zb, w, c2, z), zb,
                               w, skip=z)
        return
    for zin in (z, z.to(torch.bfloat16)):
        got = MF.dw_stencil(zin, w9, s1, c1, 2)
        ref = MF.dw_stencil_reference(zin, w9, s1, c1, 2, torch.bfloat16)
        assert torch.equal(got, ref)
    zb = torch.randn(3, 7, 5, c, generator=g).to(cuda_device, torch.bfloat16)
    w = torch.randn(c, c, generator=g).to(cuda_device, torch.bfloat16)
    w_t = w.t().contiguous()
    c2 = torch.randn(c, generator=g).to(cuda_device)
    torch.testing.assert_close(MF.pw_gemm(zb, w_t, c2),
                               MF.pw_gemm_reference(zb, w, c2),
                               rtol=1e-4, atol=1e-4)
    skip = z.to(torch.bfloat16)
    torch.testing.assert_close(MF.pw_gemm(zb, w_t, c2, skip).float(),
                               MF.pw_gemm_reference(zb, w, c2, skip).float(),
                               rtol=2 ** -7, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("c", [8, 40, 728])
@pytest.mark.parametrize("bhw", [(3, 7, 5), (3, 13, 211)])
def test_kernels_match_plain_at_ragged_shapes(cuda_device, bhw, c, dilation,
                                              dtype):
    """Both kernels at ragged M (105 and 8192 + 37 rows; 211 columns span
    7 column tiles of the stencil) and ragged C.  The stencil repeats the
    plain version's f32 ops in order without FMA: bit-exact, for the bf16
    block input and the f32 z between convs.  The GEMM sums exact bf16
    products in f32 in another order: rtol=atol=1e-4; with the skip added
    and a bf16 output, one bf16 step (2^-7 relative).  f32: the block input
    is f32 too, the stencil bit-exact and the GEMM (N = 728 is 5 x 128 +
    88, 8 is a tile's 8 columns) to ``_assert_f32_gemm_close``'s bound,
    with the f32 launches counted on their own."""
    rng = np.random.default_rng(c * 10 + dilation)

    def t(*shape, scale=1.0, dtype=torch.float32):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(cuda_device, dtype)
    z, x = t(*bhw, c), t(*bhw, c, dtype=dtype)
    w9, w = t(9, c, scale=0.3, dtype=dtype), \
        t(c, c, scale=c ** -0.5, dtype=dtype)
    s1 = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)).to(
        cuda_device)
    c1, c2 = t(c, scale=0.1), t(c, scale=0.1)
    f32 = dtype == torch.float32
    w_t = w.t().contiguous()
    if f32:  # the f32 product reads the weight's TF32 parts
        w_t = torch.stack(MF.tf32_split(w_t), 0)
    for zin, skip in ((x, None), (z, None), (z, x)):
        MF.reset_launches()
        zb = MF.dw_stencil(zin, w9, s1, c1, dilation, dtype)
        got = MF.pw_gemm(zb, w_t, c2, skip)
        torch.cuda.synchronize()
        assert MF.LAUNCHES == {"dw_stencil": 1, "pw_gemm": 1}
        assert MF.F32_LAUNCHES == {"dw_stencil": int(f32), "pw_gemm": int(f32)}
        zb_ref = MF.dw_stencil_reference(zin, w9, s1, c1, dilation, dtype)
        assert torch.equal(zb, zb_ref)
        ref = MF.pw_gemm_reference(zb_ref, w, c2, skip)
        if f32:
            _assert_f32_gemm_close(got, ref, zb_ref, w, skip)
        elif skip is None:
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
        else:
            torch.testing.assert_close(got.float(), ref.float(),
                                       rtol=2 ** -7, atol=1e-4)


@pytest.mark.parametrize("rows", [1, 3, 4, 16])
@pytest.mark.parametrize("dilation", [1, 2, 3])
def test_stencil_row_segments_cover_every_output(cuda_device, monkeypatch,
                                                 rows, dilation):
    """Each stencil thread walks ``rows`` output rows of one residue of h
    mod the dilation, carrying its running sums: segments that end inside
    the image, one longer than it, and residues with fewer rows than
    others all give the plain version's zb bit for bit."""
    import functools
    monkeypatch.setattr(MF, "dw_stencil_plan", functools.partial(
        MF.dw_stencil_plan, rows=rows))
    g = torch.Generator().manual_seed(rows * 10 + dilation)
    z = torch.randn(2, 14, 37, 24, generator=g).to(cuda_device)
    w9 = torch.randn(9, 24, generator=g).to(cuda_device, torch.bfloat16)
    s1, c1 = (torch.randn(24, generator=g).to(cuda_device) for _ in range(2))
    got = MF.dw_stencil(z, w9, s1, c1, dilation)
    assert torch.equal(got, MF.dw_stencil_reference(z, w9, s1, c1, dilation,
                                                    torch.bfloat16))


def test_gemm_kernel_has_the_registers_setmaxnreg_needs(cuda_device):
    """setmaxnreg moves registers inside the block's allocation (producer
    40 + two consumer warpgroups 232 over 384 threads), so ptxas must give
    the GEMM 168 per thread; the host refuses to launch otherwise."""
    lib = MF._lib()
    assert lib.mf_pw_gemm_regs(0) == 168
    assert lib.mf_pw_gemm_regs(1) == 168
    with pytest.raises(RuntimeError, match="setmaxnreg"):
        MF._raise("mf_pw_gemm", 20000 + 160)


def test_kernels_opt_in_to_large_shared_memory(cuda_device):
    """The GEMM keeps 5 stages of A and W^T boxes, ~196 KB: above the 48
    KB default, a launch runs only after cudaFuncSetAttribute.  A fresh
    process (no attribute set yet) runs both GEMM variants once."""
    import os
    import subprocess
    import sys
    assert MF.pw_gemm_plan(105, 728, 728)["smem_bytes"] > 48 * 1024
    code = (
        "import torch; from cervical_tpu_torch.ops import middle_flow as MF\n"
        "d = torch.device('cuda'); g = torch.Generator().manual_seed(0)\n"
        "z = torch.randn(1, 15, 7, 728, generator=g).to(d)\n"
        "w9 = torch.randn(9, 728, generator=g).to(d, torch.bfloat16)\n"
        "w = torch.randn(728, 728, generator=g).to(d, torch.bfloat16) / 27\n"
        "v = torch.randn(728, generator=g).to(d)\n"
        "zb = MF.dw_stencil(z, w9, v, v, 1)\n"
        "wt = w.t().contiguous(); x = z.to(torch.bfloat16)\n"
        "torch.testing.assert_close(MF.pw_gemm(zb, wt, v),\n"
        "    MF.pw_gemm_reference(zb, w, v), rtol=1e-4, atol=1e-4)\n"
        "torch.testing.assert_close(MF.pw_gemm(zb, wt, v, x).float(),\n"
        "    MF.pw_gemm_reference(zb, w, v, x).float(), rtol=2 ** -7,\n"
        "    atol=1e-4)\n"
        "torch.cuda.synchronize(); print('ok')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_f32_gemm_shared_memory(cuda_device):
    """mf_pw_gemm_f32 keeps 3 stages of A's and W's two parts' boxes,
    191,536 bytes, and mf_dw_stencil_f32 its rows and output buffers, 72 KB
    at C = 728: above the 48 KB default, a launch runs only after
    cudaFuncSetAttribute.  A fresh process (no attribute set yet) runs the
    f32 stencil and both f32 GEMM variants once at K = N = 728."""
    import os
    import subprocess
    import sys
    assert MF.pw_gemm_f32_plan(105, 728, 728)["smem_bytes"] == 191536
    assert MF.dw_stencil_f32_plan(1, 15, 7, 728, 1)["smem_bytes"] > 48 * 1024
    code = (
        "import torch; from cervical_tpu_torch.ops import middle_flow as MF\n"
        "torch.backends.cuda.matmul.allow_tf32 = False\n"
        "d = torch.device('cuda'); g = torch.Generator().manual_seed(0)\n"
        "z = torch.randn(1, 15, 7, 728, generator=g).to(d)\n"
        "w9 = torch.randn(9, 728, generator=g).to(d)\n"
        "w = torch.randn(728, 728, generator=g).to(d) / 27\n"
        "v = torch.randn(728, generator=g).to(d)\n"
        "zb = MF.dw_stencil(z, w9, v, v, 1, torch.float32)\n"
        "assert torch.equal(zb, MF.dw_stencil_reference(z, w9, v, v, 1,\n"
        "    torch.float32))\n"
        "ws = torch.stack(MF.tf32_split(w.t().contiguous()), 0)\n"
        "torch.testing.assert_close(MF.pw_gemm(zb, ws, v),\n"
        "    MF.pw_gemm_reference(zb, w, v), rtol=1e-5, atol=1e-5)\n"
        "torch.testing.assert_close(MF.pw_gemm(zb, ws, v, z),\n"
        "    MF.pw_gemm_reference(zb, w, v, z), rtol=1e-5, atol=1e-5)\n"
        "assert MF.F32_LAUNCHES == {'dw_stencil': 1, 'pw_gemm': 2}\n"
        "torch.cuda.synchronize(); print('ok')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_f32_gemm_has_the_registers_setmaxnreg_needs(cuda_device):
    """The f32 GEMM's setmaxnreg split (producer 24 + two consumer
    warpgroups 240 over 384 threads) needs ptxas's 168 per thread; the host
    refuses to launch otherwise."""
    lib = MF._lib()
    assert lib.mf_pw_gemm_f32_regs(0) == 168
    assert lib.mf_pw_gemm_f32_regs(1) == 168
    with pytest.raises(RuntimeError, match="setmaxnreg.*24 \\+ 2 x 240"):
        MF._raise("mf_pw_gemm_f32", 20000 + 160)


def test_card_split_equals_tf32_split(cuda_device):
    """The GEMM's own split on the card (cvt.rna.tf32.f32, kernel
    mf_tf32_split) equals the plain ``tf32_split`` bit for bit: normal
    values over 60 decades, exact ties either side of zero, carries into
    the exponent, zeros and values already TF32."""
    g = torch.Generator().manual_seed(5)
    k = torch.arange(1, 1000, dtype=torch.float64)
    ties = 1.0 + k * 2.0 ** -10 + 2.0 ** -11
    x = torch.cat([
        torch.randn(200000, generator=g) * 10.0 ** torch.randint(
            -30, 30, (200000,), generator=g).float(),
        ties.float(), -ties.float(), (ties * 2.0 ** 40).float(),
        torch.tensor([2 - 2 ** -12, -(4 - 2 ** -11), 0.0, -0.0, 1.0, -3.5])])
    hi, lo = MF.tf32_split_on_card(x.to(cuda_device))
    torch.cuda.synchronize()
    phi, plo = MF.tf32_split(x)
    assert torch.equal(hi.cpu().view(torch.int32), phi.view(torch.int32))
    assert torch.equal(lo.cpu().view(torch.int32), plo.view(torch.int32))


@pytest.mark.parametrize("final", [False, True], ids=["plain", "final"])
def test_f32_gemm_at_os8_rows(cuda_device, final):
    """The f32 GEMM at M = 32768 (batch 8 at output stride 8, 64 x 64), on
    the fold's split weights: within ``_assert_f32_gemm_close``'s bound of
    ``torch.matmul`` (TF32 off), and its largest error from an
    f64-accumulated product at most twice ``torch.matmul``'s (the
    smoke's check)."""
    g = torch.Generator().manual_seed(8)
    zb = torch.randn(8, 64, 64, 728, generator=g).to(cuda_device)
    w = (torch.randn(728, 728, generator=g) * (1.5 / 728 ** 0.5)).to(
        cuda_device)
    c2 = (torch.randn(728, generator=g) * 0.1).to(cuda_device)
    skip = torch.randn(8, 64, 64, 728, generator=g).to(cuda_device) \
        if final else None
    ws = torch.stack(MF.tf32_split(w.t().contiguous()), 0)
    got = MF.pw_gemm(zb, ws, c2, skip)
    torch.cuda.synchronize()
    ref = MF.pw_gemm_reference(zb, w, c2, skip)
    _assert_f32_gemm_close(got, ref, zb, w, skip)
    exact = (zb.double().view(-1, 728) @ w.double()).view(ref.shape) \
        + c2.double()
    if final:
        exact = exact + torch.relu(skip.double())
    e_kernel = (got.double() - exact).abs().max().item()
    e_mm = (ref.double() - exact).abs().max().item()
    assert e_kernel <= 2 * e_mm, (e_kernel, e_mm)


def test_f32_wrappers_refuse_mixed_types(cuda_device):
    """The kernels take a bf16 set or an f32 set: f32 taps with a bf16
    input or output, bf16 taps asked for an f32 zb, an f32 zb with a bf16
    weight or skip (and the other way round) raise TypeError; nothing is
    cast to the other type's kernels.  An f32 zb wants the weight's TF32
    parts (2, N, K): an unsplit (N, K) weight raises."""
    z = torch.zeros(1, 4, 4, 16, device=cuda_device)
    zh = z.to(torch.bfloat16)
    w32 = torch.zeros(9, 16, device=cuda_device)
    v = torch.zeros(16, device=cuda_device)
    MF.reset_launches()
    with pytest.raises(TypeError):
        MF.dw_stencil(z, w32, v, v, 1)  # f32 taps, bf16 zb
    with pytest.raises(TypeError):
        MF.dw_stencil(zh, w32, v, v, 1, torch.float32)  # bf16 input
    with pytest.raises(TypeError):
        MF.dw_stencil(z, w32.to(torch.bfloat16), v, v, 1, torch.float32)
    w_t = torch.zeros(16, 16, device=cuda_device)
    w_split = torch.zeros(2, 16, 16, device=cuda_device)
    with pytest.raises(TypeError):
        MF.pw_gemm(zh, w_t, v)  # bf16 zb, f32 weight
    with pytest.raises(TypeError):
        MF.pw_gemm(z, w_split, v, skip_src=zh)  # f32 zb, bf16 skip
    with pytest.raises(TypeError):
        MF.pw_gemm(zh, w_t.to(torch.bfloat16), v, skip_src=z)
    with pytest.raises(ValueError, match="shape"):
        MF.pw_gemm(z, w_t, v)  # f32 zb, an unsplit weight
    assert MF.LAUNCHES == {"dw_stencil": 0, "pw_gemm": 0}


def test_wrappers_check_their_inputs(cuda_device):
    z = torch.zeros(1, 4, 4, 16, device=cuda_device)
    w9 = torch.zeros(9, 16, device=cuda_device, dtype=torch.bfloat16)
    v = torch.zeros(16, device=cuda_device)
    with pytest.raises(TypeError):
        MF.dw_stencil(z.half(), w9, v, v, 1)
    with pytest.raises(ValueError, match="contiguous"):
        MF.dw_stencil(z.transpose(1, 2), w9, v, v, 1)
    with pytest.raises(TypeError):
        MF.pw_gemm(z, w9.new_zeros(16, 16), v)  # f32 zb
    with pytest.raises(ValueError, match="multiple of 8"):
        MF.dw_stencil(z[..., :12].contiguous(), w9[:, :12].contiguous(),
                      v[:12], v[:12], 1)
    with pytest.raises(ValueError, match="aligned"):
        MF.dw_stencil(z, w9, v, torch.zeros(20, device=cuda_device)[2:18], 1)
    zb = z.to(torch.bfloat16)
    w_t = w9.new_zeros(16, 16)
    with pytest.raises(ValueError, match="aligned"):
        MF.pw_gemm(zb, w_t, v, skip_src=torch.zeros(
            1 + z.numel(), device=cuda_device, dtype=torch.bfloat16)[1:]
            .view(z.shape))
    with pytest.raises(ValueError, match="shape"):
        MF.pw_gemm(zb, w9.new_zeros(16, 24), v)  # K 24 against zb's 16
    with pytest.raises(KeyError, match="wpw_t"):
        folded = _random_folded(0, 1, 16, cuda_device)
        del folded["wpw_t"]
        MF.middle_flow_eval(zb, folded, 1)
    with pytest.raises(KeyError, match="wpw_t_split"):
        folded = _random_folded(0, 1, 16, cuda_device, torch.float32)
        del folded["wpw_t_split"]
        MF.middle_flow_eval(z, folded, 1)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"],
                         ids=["bf16", "f32"])
def test_fused_predictor_matches_plain_on_cuda(cuda_device, dtype):
    """SegPredictor at 64², defaults to CUDA; the fused middle flow goes
    through the kernels and agrees with the unfused model.  bf16: masks on
    >= 99% of pixels, probs to 0.05.  f32, with TF32 off for cuBLAS and
    cuDNN (both set here): the f32 kernels (96 launches of each type's
    count), masks on >= 99.9% of pixels, probs to 1e-4."""
    from cervical_tpu_torch.config import SegDataConfig, SegTrainConfig
    from cervical_tpu_torch.inference.predictor import SegPredictor
    from cervical_tpu_torch.models.deeplab import DeepLab
    from torch_port_helpers import random_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = random_state(DeepLab(num_classes=5), seed=51)
    cfg = SegTrainConfig(data=SegDataConfig(input_shape=(64, 64)),
                         dtype=dtype)
    fused = SegPredictor(cfg, state, fused_middle=True)
    plain = SegPredictor(cfg, state)
    assert fused.device.type == "cuda"
    imgs = np.random.default_rng(52).integers(0, 256, (3, 45, 70, 3)).astype(np.uint8)
    MF.reset_launches()
    m1 = fused.predict_masks(imgs, batch_size=2)
    assert MF.LAUNCHES == {"dw_stencil": 96, "pw_gemm": 96}
    m0 = plain.predict_masks(imgs, batch_size=2)
    if dtype == "bfloat16":
        assert MF.F32_LAUNCHES == {"dw_stencil": 0, "pw_gemm": 0}
        assert (m1 == m0).mean() >= 0.99
        np.testing.assert_allclose(fused.predict_probs(imgs[0]),
                                   plain.predict_probs(imgs[0]), atol=0.05)
        return
    assert MF.F32_LAUNCHES == MF.LAUNCHES
    assert (m1 == m0).mean() >= 0.999
    np.testing.assert_allclose(fused.predict_probs(imgs[0]),
                               plain.predict_probs(imgs[0]), rtol=0,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# K1 warp_images, K2 warp_labels, K3 photometric (csrc/warp.cu)
# ---------------------------------------------------------------------------

def _warp_case(seed, b, src_hw, s, angles):
    from cervical_tpu_torch.ops import augment as A
    from cervical_tpu_torch.ops import warp as W
    g = torch.Generator().manual_seed(seed)
    p = A.sample_augment_params(g, b, rotate_prefix=b // 2,
                                blur_suffix=b // 2)
    p["angle"] = torch.tensor(angles, dtype=torch.float32)
    wp = W.make_warp_params(p, src_hw, (s, s))
    rng = np.random.default_rng(seed)
    imgs = torch.from_numpy(rng.integers(0, 256, (b,) + src_hw + (3,),
                                         dtype=np.uint8))
    lbls = torch.from_numpy(rng.integers(0, 5, (b,) + src_hw, dtype=np.uint8))
    return p, wp, imgs, lbls


_MIXED = [3.0, -3.0, 10.0, -10.0, 0, 0, 0, 0]


@pytest.mark.parametrize("src_hw,s,angles", [
    ((64, 64), 64, _MIXED), ((40, 64), 64, _MIXED), ((512, 512), 512, _MIXED),
    ((512, 512), 512, [10.0, -10.0] * 4),
    ((512, 512), 512, [3.0, -3.0] * 4),
    ((512, 512), 512, [1.0, -1.0] * 4),
    # past K1's window buffers: those tiles take the recursive path
    ((64, 64), 64, [30.0, -30.0, 45.0, 10.0, 0.0, 0.0, -10.0, 20.0]),
    # 100 is no multiple of K1's 32 x 32 tile; 67 no multiple of the
    # un-rotated images' 4-pixel stores
    ((40, 64), 100, [10.0, -10.0, 3.0, -3.0, 1.0, -1.0, 0.0, 0.0]),
    ((67, 70), 67, [5.0, 0.0, -7.0, 0.0, 0.0, 2.0, 0.0, 0.0]),
    # S < 64: K2's shears wrap by an integer %, not one conditional step
    ((40, 40), 40, _MIXED), ((30, 50), 63, [9.0, -9.0, 2.0, 0.0] * 2)])
def test_warp_kernels_match_plain(cuda_device, src_hw, s, angles):
    """K1 and K2 on the card against their plain versions on the same rows:
    scale above and below 1, flip, paste, rotations and 0, a non-square
    source, an NHWC source read through its permuted view, labels
    contiguous and as a view with a column stride of 2.  Both repeat the
    plain versions' f32 ops with the same roundings, so both are equal bit
    for bit: K1 in bf16 and uint8 out, whether a tile's rotation is staged
    in shared memory (a tap outside its window computed by the recursive
    path) or, past the buffers, recursive throughout; K2 whether its shears
    wrap by one step (S >= 64) or by %, its runs stored whole or not."""
    from cervical_tpu_torch.ops import warp as W
    _, wp, imgs, lbls = _warp_case(s, 8, src_hw, s, angles)
    wpd, xd, ld = wp.to(cuda_device), imgs.to(cuda_device), lbls.to(cuda_device)
    wide = torch.zeros(lbls.shape[:2] + (2 * lbls.shape[2],),
                       dtype=torch.uint8, device=cuda_device)
    strided = wide[:, :, ::2]
    strided.copy_(ld)
    W.reset_launches()
    for out_dtype in (torch.bfloat16, torch.uint8):
        got = W.warp_images(xd.permute(0, 3, 1, 2), wpd, s, out_dtype)
        torch.cuda.synchronize()
        ref = W.warp_images_reference(xd.permute(0, 3, 1, 2), wpd, s,
                                      out_dtype)
        assert torch.equal(got, ref), int((got != ref).sum())
    ref = W.warp_labels_reference(ld, wpd, s)
    for labels in (ld, strided):
        got = W.warp_labels(labels, wpd, s)
        assert torch.equal(got, ref), int((got != ref).sum())
    assert W.LAUNCHES == {"warp_images": 2, "warp_labels": 2,
                          "photometric": 0, "warp_photo_images": 0}


def _k3_case(case, in_dtype, device):
    """(images, gains, flags) for K3 on the card.  "512": the train step's
    shape, flags on the last 2 of 8 images; "67x70", "5x13": widths that
    are no multiple of 8 (the scalar path); "slice": ``x[1:]`` of a batch of
    3 x 5 x 8 images (uint8: 8 bytes off 16-byte alignment); "offset": a
    view one element into its storage (misaligned for every type, the
    scalar path); "outside": values outside [0, 255] where the type holds
    them (uint8: the ends of its range); "extreme": gains that wrap the hue
    past 180, clip saturation and value, negative, 0 and exactly 1; "cube":
    every (r, g, b) of uint8 (a 4096 x 4096 image; bf16 and f32: the 160
    bf16 values nearest 0, 1.6, 3.2, .. 254.4, cubed), the divisions of
    the HSV map at every operand pair those inputs give."""
    rng = np.random.default_rng(len(case))
    shape = {"512": (8, 3, 512, 512), "67x70": (4, 3, 67, 70),
             "5x13": (4, 3, 5, 13), "slice": (5, 3, 5, 8),
             "offset": (4, 3, 16, 24), "outside": (4, 3, 24, 32),
             "extreme": (6, 3, 16, 32), "cube": (1, 3, 4096, 4096)}[case]
    x = rng.integers(0, 256, shape).astype(np.float32)
    if in_dtype != torch.uint8:  # non-integer values, as K1 writes bf16
        x = x + rng.integers(0, 8, shape) / 8.0
    if case == "cube":
        lv = np.arange(256, dtype=np.float32) if in_dtype == torch.uint8 \
            else torch.tensor(np.arange(160) * 1.6).to(torch.bfloat16).float(
            ).numpy()
        cube = np.stack(np.meshgrid(lv, lv, lv, indexing="ij")).reshape(3, -1)
        x = np.zeros(shape, np.float32).reshape(3, -1)
        x[:, :cube.shape[1]] = cube
        x = x.reshape(shape)
    if case == "outside":
        x = rng.uniform(-300.0, 600.0, shape).astype(np.float32)
        if in_dtype == torch.uint8:
            x = np.where(x < 128, 0.0, 255.0)
    b = shape[0] - (case == "slice")
    gains = rng.uniform(0.7, 1.3, (b, 3)).astype(np.float32)
    if case == "extreme":
        gains = np.array([[1.1, 1.7, 1.3], [1.0, 1.0, 1.0], [-0.35, 1.0, 2.5],
                          [3.7, 0.0, 1.0], [0.0, 255.0, 1e-6],
                          [0.9, 0.3, 0.7]], np.float32)
    # "select" blurs the flagged images' tiles first: none flagged, all,
    # the train step's last 2 of 8, every other
    flags = torch.tensor([{"outside": False, "extreme": True}.get(
        case, i >= b - 2 if case == "512" else i % 2 == 0)
        for i in range(b)], device=device)
    t = torch.from_numpy(x).to(device, in_dtype)
    if case == "slice":
        t = t[1:]
    elif case == "offset":
        buf = torch.empty(t.numel() + 1, dtype=in_dtype, device=device)
        t = buf[1:].view(shape).copy_(t)
    return t, torch.from_numpy(gains).to(device), flags


@pytest.mark.parametrize("case", ["512", "67x70", "5x13", "slice", "offset",
                                  "outside", "extreme", "cube"])
@pytest.mark.parametrize("mode", ["select", "all", "none"])
@pytest.mark.parametrize("in_dtype", [torch.uint8, torch.bfloat16,
                                      torch.float32])
def test_photometric_kernel_matches_plain(cuda_device, mode, in_dtype, case):
    """K3 against its plain version: the same f32 ops in the same order
    (the gains read from per-image tables filled by the same operations,
    an index outside them computed per pixel), so bf16 and f32 outputs are
    equal bit for bit, whether runs move as 16-byte vectors (W % 8 == 0,
    pointers aligned) or one element each, whether a group of pixels
    divides by the checked fast sequence or takes the exact path."""
    from cervical_tpu_torch.ops import warp as W
    x, gains, flags = _k3_case(case, in_dtype, cuda_device)
    W.reset_launches()
    for out_dtype in (torch.bfloat16, torch.float32):
        got = W.photometric(x, gains, flags, out_dtype, mode)
        ref = W.photometric_reference(x, gains, flags, out_dtype, mode)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), int((got != ref).sum())
    assert W.LAUNCHES["photometric"] == 2


_ALT = [1, 0, 1, 0, 1, 0, 1, 0]


@pytest.mark.parametrize("src_hw,s,angles,flags", [
    ((64, 64), 64, _MIXED, _ALT), ((40, 64), 64, _MIXED, _ALT),
    ((512, 512), 512, _MIXED, _ALT),
    # 67: S % 4 != 0, each value stored alone
    ((67, 70), 67, _MIXED, _ALT),
    # 100: the last tile row and column ragged (4 of 32), stored as runs
    ((40, 64), 100, [10.0, -10.0, 3.0, -3.0, 1.0, -1.0, 0.0, 0.0],
     [1, 1, 0, 0, 1, 0, 1, 1]),
    # every image rotated at +-10 degrees and blurred: each edge tile's
    # halo crosses the image's edge
    ((512, 512), 512, [10.0, -10.0] * 4, [1] * 8),
    ((64, 64), 64, [10.0, -10.0] * 4, [1] * 8),
    # all blurred, half rotated: the heavy-first order over 2 classes
    ((64, 64), 64, [0.0, 5.0, 0.0, -5.0, 0.0, 7.0, 0.0, -7.0], [1] * 8),
    # past the window buffers: those regions take the recursive path
    ((64, 64), 64, [30.0, -30.0, 45.0, 10.0, 0.0, 0.0, -10.0, 20.0],
     [1, 0, 1, 1, 0, 1, 0, 1]),
    # 40 images, 9 / 7 / 13 / 11 in the four cost classes: each block's
    # image found over two ballots of 32
    ((40, 36), 36, [0.0, 5.0, 0.0, -8.0, 0.0] * 8,
     [1, 0, 0, 1, 1, 0, 1] * 5 + [1, 1, 0, 0, 0])])
def test_warp_photo_kernel_matches_plain_and_chain(cuda_device, src_hw, s,
                                                   angles, flags):
    """K5 against its plain version and against the K1 -> K3 kernel chain
    on the same rows: images rotated and blurred, rotated only, blurred
    only, neither; ragged output sizes; the (B, H, W, 3) batch read
    through its permuted view, as ``augment_batch_kernels`` passes it, and
    a contiguous planar copy; bf16 and f32 out.  The same f32 ops with the
    same roundings as the chain, so equal bit for bit, whether a region's
    rotation is staged in shared memory (a tap outside its window computed
    by the recursive path) or recursive throughout."""
    from cervical_tpu_torch.ops import warp as W
    p, wp, imgs, _ = _warp_case(s + 1, len(angles), src_hw, s, angles)
    fl = torch.tensor(flags, dtype=torch.bool)
    full = torch.cat([wp, p["gains"].float(), fl.float()[:, None]],
                     1).to(cuda_device)
    x = imgs.to(cuda_device).permute(0, 3, 1, 2)
    W.reset_launches()
    for src in (x, x.contiguous()):
        for out_dtype in (torch.bfloat16, torch.float32):
            got = W.warp_photo_images(src, full, s, out_dtype)
            ref = W.warp_photo_images_reference(src, full, s, out_dtype)
            chain = W.photometric(W.warp_images(src, full[:, :8], s),
                                  full[:, 8:11], fl.to(cuda_device),
                                  out_dtype)
            torch.cuda.synchronize()
            for want in (ref, chain):
                assert torch.equal(got, want), int((got != want).sum())
    assert W.LAUNCHES == {"warp_images": 4, "warp_labels": 0,
                          "photometric": 4, "warp_photo_images": 4}


def test_augment_batch_kernels_on_card(cuda_device):
    """The chained pipeline (two-kernel and fused) on the card against the
    same calls on the CPU (plain versions): labels equal, images within one
    bf16 step; fused=True launches K5 and neither K1 nor K3."""
    from cervical_tpu_torch.ops import warp as W
    p, _, imgs, lbls = _warp_case(3, 8, (64, 64), 64,
                                  [5.0, -7.0, 0, 0, 0, 0, 0, 0])
    for kw in ({"carry_u8": False}, {"carry_u8": True}, {"fused": True},
               {"fused": True, "normalized": False}):
        W.reset_launches()
        gi, gl = W.augment_batch_kernels(imgs.to(cuda_device),
                                         lbls.to(cuda_device), p, (64, 64),
                                         **kw)
        fused = kw.get("fused", False)
        assert W.LAUNCHES == {"warp_images": int(not fused), "warp_labels": 1,
                              "photometric": int(not fused),
                              "warp_photo_images": int(fused)}
        ri, rl = W.augment_batch_kernels(imgs, lbls, p, (64, 64), **kw)
        assert torch.equal(gl.cpu(), rl)
        err = (gi.float().cpu() - ri.float()).abs()
        assert bool((err <= 2.0 ** -8 * ri.float().abs() + 1e-7).all())


@pytest.mark.parametrize("src_hw,s", [((64, 64), 64), ((40, 64), 64),
                                      ((512, 512), 512)])
@pytest.mark.parametrize("kw", [{}, {"carry_u8": True}, {"fused": True},
                                {"letterbox": True}])
def test_augment_batch_kernels_planar_equals_nhwc(cuda_device, src_hw, s,
                                                  kw):
    """``planar=True`` on the (B, 3, H, W) batch the native loader emits
    equals the NHWC call on the same pixels bit for bit, kernels on both
    sides, with the same launches."""
    from cervical_tpu_torch.ops import warp as W
    p, _, imgs, lbls = _warp_case(4, 8, src_hw, s, _MIXED)
    nhwc = imgs.to(cuda_device)
    planar = nhwc.permute(0, 3, 1, 2).contiguous()
    lbls = lbls.to(cuda_device)
    W.reset_launches()
    gi, gl = W.augment_batch_kernels(planar, lbls, p, (s, s), planar=True,
                                     **kw)
    launches = dict(W.LAUNCHES)
    W.reset_launches()
    ri, rl = W.augment_batch_kernels(nhwc, lbls, p, (s, s), **kw)
    assert launches == W.LAUNCHES
    assert launches["warp_labels"] == 1
    assert torch.equal(gi, ri) and torch.equal(gl, rl)


def test_trainer_epoch_on_card_matches_cpu_losses(cuda_device):
    """SegTrainer defaults to CUDA; at 64², f32, one unfrozen epoch of 2
    steps launches K1-K3 once per step, and with dropout off (the CPU and
    CUDA generators draw different masks) its first train loss matches the
    same step on the CPU (plain kernel versions) to 1e-3 relative
    (convolutions sum in another order; TF32 is off)."""
    from cervical_tpu_torch.config import SegDataConfig, SegTrainConfig
    from cervical_tpu_torch.data.voc import ArraySegDataset, BatchLoader
    from cervical_tpu_torch.ops import warp as W
    from cervical_tpu_torch.train.seg_trainer import SegTrainer
    cfg = SegTrainConfig(data=SegDataConfig(input_shape=(64, 64),
                                            aug_backend="pallas"),
                         dtype="float32")
    rng = np.random.default_rng(5)
    ds = ArraySegDataset(rng.integers(0, 256, (16, 64, 64, 3)),
                         rng.integers(0, 5, (16, 64, 64)))
    val = BatchLoader(ds, 4, shuffle=False, drop_last=False)
    card = SegTrainer(cfg)
    assert card.device.type == "cuda"
    W.reset_launches()
    res = card.run_epoch(BatchLoader(ds, 8, seed=1), val, 0, False, 1e-4)
    assert W.LAUNCHES == {"warp_images": 2, "warp_labels": 2,
                          "photometric": 2, "warp_photo_images": 0}
    assert np.isfinite(res.train_loss)
    cpu, gpu = SegTrainer(cfg, device="cpu"), SegTrainer(cfg)
    for m in (*cpu.state.model.modules(), *gpu.state.model.modules()):
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    images = torch.from_numpy(ds.images[:8])
    labels = torch.from_numpy(ds.labels[:8])
    m_cpu = cpu.train_step(images, labels, False, 1e-4)
    m_gpu = gpu.train_step(images.to(cuda_device), labels.to(cuda_device),
                           False, 1e-4)
    np.testing.assert_allclose(m_gpu["loss"].item(), m_cpu["loss"].item(),
                               rtol=1e-3)


# ---------------------------------------------------------------------------
# K-step calls as CUDA graphs (train/graphs.py) and the einsum backend
# ---------------------------------------------------------------------------

@pytest.fixture
def deterministic_cudnn(cuda_device):
    """cuDNN's deterministic algorithms: at these f32 test shapes its
    heuristics may take a backward algorithm that sums with atomics, and
    then two eager runs differ too; the graph is held to the eager steps
    bit for bit with that noise removed."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield cuda_device
    torch.backends.cudnn.deterministic = was


def _graph_cfg(**kw):
    from cervical_tpu_torch.config import SegDataConfig, SegTrainConfig
    data = {k: kw.pop(k) for k in ("aug_backend", "aug_pre_batch")
            if k in kw}
    return SegTrainConfig(data=SegDataConfig(input_shape=(64, 64), **data),
                          dtype="float32", **kw)


def _k_batches(device, k=3, b=4, seed=31):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (k, b, 64, 64, 3),
                                          dtype=np.uint8)).to(device),
            torch.from_numpy(rng.integers(0, 5, (k, b, 64, 64),
                                          dtype=np.uint8)).to(device))


def _states_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    same = all(torch.equal(v, sb[k]) for k, v in sa.items())
    for g in ("backbone", "head"):
        xa, xb = (o.state_dict()["state"] for o in (a.opt_state[g],
                                                     b.opt_state[g]))
        same &= xa.keys() == xb.keys() and all(
            torch.equal(torch.as_tensor(v), torch.as_tensor(xb[i][k]))
            for i in xa for k, v in xa[i].items())
    return same


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
@pytest.mark.parametrize("frozen", [False, True], ids=["unfrozen", "frozen"])
def test_k_step_graph_equals_eager_steps(deterministic_cudnn, optimizer,
                                        frozen):
    """A K-step call, captured and replayed twice, against 2K eager steps
    from a trainer of the same seed (dropout on, the einsum backend), with
    Adam and with Nesterov SGD: the same losses and states bit for bit, the
    step count advanced per replay."""
    from cervical_tpu_torch.train.seg_trainer import SegTrainer
    cfg = _graph_cfg(optimizer_type=optimizer)
    images, labels = _k_batches(deterministic_cudnn)
    tg, te = SegTrainer(cfg), SegTrainer(cfg)
    got = torch.cat([tg.train_steps(images, labels, frozen, 1e-3)["loss"]
                     for _ in range(2)])
    want = torch.stack([te.train_step(images[i], labels[i], frozen,
                                      1e-3)["loss"]
                        for _ in range(2) for i in range(3)])
    assert torch.equal(got, want)
    assert tg.state.step == te.state.step == 6
    assert _states_equal(tg.state, te.state)


def test_sgd_epoch_on_default_steps_per_call(cuda_device):
    """Nesterov SGD with the default ``steps_per_call`` (8) on the card: a
    9-batch epoch runs one 8-step graph call and one single step, every
    batch once, with finite metrics and moved params."""
    from cervical_tpu_torch.config import SegTrainConfig
    from cervical_tpu_torch.data.voc import ArraySegDataset, BatchLoader
    from cervical_tpu_torch.train.seg_trainer import SegTrainer
    cfg = _graph_cfg(optimizer_type="sgd")
    assert cfg.steps_per_call == SegTrainConfig().steps_per_call == 8
    rng = np.random.default_rng(37)
    imgs = rng.integers(0, 256, (36, 64, 64, 3), dtype=np.uint8)
    lbls = rng.integers(0, 5, (36, 64, 64), dtype=np.uint8)
    tr = SegTrainer(cfg)
    before = [p.detach().clone() for p in tr.state.model.parameters()]
    res = tr.run_epoch(BatchLoader(ArraySegDataset(imgs, lbls), 4, seed=1),
                       BatchLoader(ArraySegDataset(imgs[:8], lbls[:8]), 4,
                                   shuffle=False),
                       0, False, 1e-2)
    assert tr.state.step == 9 and np.isfinite(res.train_loss)
    assert len(tr._graphs) == 1
    assert not all(torch.equal(a, p) for a, p in
                   zip(before, tr.state.model.parameters()))


def test_graph_replays_count_kernel_launches(deterministic_cudnn):
    """The kernel backend in a K-step graph: each replay adds the captured
    launches (K per kernel), the capture and its warm-up none; with
    aug_pre_batch one launch per kernel per call, and the call equals the
    per-step eager steps bit for bit."""
    from cervical_tpu_torch.ops import warp as W
    from cervical_tpu_torch.train.seg_trainer import SegTrainer
    images, labels = _k_batches(deterministic_cudnn)
    per = SegTrainer(_graph_cfg(aug_backend="pallas"))
    W.reset_launches()
    per.train_steps(images, labels, False, 1e-3)
    assert W.LAUNCHES["warp_images"] == W.LAUNCHES["photometric"] == 3
    per.train_steps(images, labels, False, 1e-3)
    assert W.LAUNCHES == {"warp_images": 6, "warp_labels": 6,
                          "photometric": 6, "warp_photo_images": 0}
    pre = SegTrainer(_graph_cfg(aug_backend="pallas", aug_pre_batch=True))
    eager = SegTrainer(_graph_cfg(aug_backend="pallas"))
    W.reset_launches()
    got = pre.train_steps(images, labels, False, 1e-3)["loss"]
    assert W.LAUNCHES == {"warp_images": 1, "warp_labels": 1,
                          "photometric": 1, "warp_photo_images": 0}
    want = torch.stack([eager.train_step(images[i], labels[i], False,
                                         1e-3)["loss"] for i in range(3)])
    assert torch.equal(got, want) and _states_equal(pre.state, eager.state)


def test_resident_graph_epoch_on_card(cuda_device):
    """A resident gather epoch on the card (graphs for the 2-step calls,
    the 1-step tail and the eval sums): every image read once; the
    resident confusion matrix equals the host-fed one."""
    from cervical_tpu_torch.data.resident import ResidentSegData
    from cervical_tpu_torch.data.voc import ArraySegDataset, BatchLoader
    from cervical_tpu_torch.train.seg_trainer import SegTrainer
    rng = np.random.default_rng(33)
    imgs = rng.integers(0, 256, (22, 64, 64, 3), dtype=np.uint8)
    lbls = rng.integers(0, 5, (22, 64, 64), dtype=np.uint8)
    tr = SegTrainer(_graph_cfg(steps_per_call=2, device_resident=True))
    seen, run = [], tr._resident_train

    def record(data, frozen, idx, lr, gather):
        seen.append(np.asarray(idx).ravel())
        return run(data, frozen, idx, lr, gather)
    tr._resident_train = record
    trs = ResidentSegData.from_arrays(imgs, lbls, 4, cuda_device)
    vrs = ResidentSegData.from_arrays(imgs[:11], lbls[:11], 4, cuda_device,
                                      train=False)
    res = tr.run_epoch(trs, vrs, 0, False, 1e-3)
    assert np.isfinite(res.train_loss) and tr.state.step == 5
    assert sorted(np.concatenate(seen).tolist()) == list(range(20))
    host = tr.evaluate_miou(BatchLoader(ArraySegDataset(imgs[:11], lbls[:11]),
                                        4, shuffle=False, drop_last=False))
    np.testing.assert_array_equal(tr.evaluate_miou(vrs)["hist"],
                                  host["hist"])


def test_spans_time_the_card(cuda_device, tmp_path):
    """The program's spans under ``utils.profiling.trace`` on the card.  A
    resident epoch whose graphs are captured inside the trace: one
    ``seg.graph.capture`` per graph (host only), the epoch's parts timed on
    the card within the epoch, its train calls on the host.  Then fused
    ``predict_masks``: every ``predict.*`` span timed on the card, the
    phases within the request, ``mf.eval`` once per forward; a span
    opened on a stream that captures a graph records no event; and an
    annotation around ``middle_flow_eval`` keeps its mirror on the card's
    timeline."""
    from cervical_tpu_torch.config import SegDataConfig, SegTrainConfig
    from cervical_tpu_torch.data.resident import ResidentSegData
    from cervical_tpu_torch.inference.predictor import SegPredictor
    from cervical_tpu_torch.models.deeplab import DeepLab
    from cervical_tpu_torch.train.seg_trainer import SegTrainer
    from cervical_tpu_torch.utils import profiling as P
    from torch_port_helpers import random_state

    rng = np.random.default_rng(34)
    imgs = rng.integers(0, 256, (20, 64, 64, 3), dtype=np.uint8)
    lbls = rng.integers(0, 5, (20, 64, 64), dtype=np.uint8)
    tr = SegTrainer(_graph_cfg(steps_per_call=2, device_resident=True))
    trs = ResidentSegData.from_arrays(imgs, lbls, 4, cuda_device)
    vrs = ResidentSegData.from_arrays(imgs[:8], lbls[:8], 4, cuda_device,
                                      train=False)
    with P.trace(str(tmp_path)) as t:
        tr.run_epoch(trs, vrs, 0, False, 1e-3)
    s = t.spans
    # 2-step calls, the 1-step tail, one 2-batch eval call
    assert s["seg.graph.capture"].count == 3
    assert s["seg.graph.capture"].device_s is None
    assert s["seg.call.train"].count == 3
    assert s["seg.call.train"].parent == "seg.epoch.train"
    parts = s["seg.epoch.train"].device_s + s["seg.epoch.val"].device_s
    assert 0 < parts <= s["seg.epoch"].device_s

    state = random_state(DeepLab(num_classes=5), seed=53)
    cfg = SegTrainConfig(data=SegDataConfig(input_shape=(64, 64)))
    pred = SegPredictor(cfg, state, fused_middle=True)
    images = rng.integers(0, 256, (3, 45, 70, 3)).astype(np.uint8)
    pred.predict_masks(images, batch_size=2)  # warm
    folded = _random_folded(9, 2, 32, cuda_device)
    x = torch.randn(2, 5, 7, 32, device=cuda_device).to(torch.bfloat16)
    with P.trace(str(tmp_path)) as t:
        pred.predict_masks(images, batch_size=2)
        with torch.profiler.record_function("test.k4"):
            MF.middle_flow_eval(x, folded)
        stream = torch.cuda.Stream()
        graph = torch.cuda.CUDAGraph()
        x = torch.zeros(8, device=cuda_device)
        with torch.cuda.graph(graph, stream=stream):
            with P.span("test.captured", cuda_device):
                x.add_(1)
    s = t.spans
    names = ("predict.stage", "predict.forward", "predict.unletterbox",
             "predict.argmax", "predict.download")
    assert all(s[k].device_s > 0 for k in names + ("predict.request",))
    assert sum(s[k].device_s for k in names) <= s["predict.request"].device_s
    # two forwards' and the annotated call's
    assert s["mf.eval"].count == 3 and s["mf.eval"].parent == \
        "predict.forward"
    assert s["test.captured"].count == 1
    assert s["test.captured"].device_s is None
    # an annotation around a span keeps its mirror on the card's timeline
    # (the benchmark's bench.k4 around middle_flow_eval)
    events = t.profile.profiler.kineto_results.events()
    on_card = {e.name() for e in events
               if str(e.device_type()).endswith("CUDA")}
    assert "test.k4" in on_card and "mf.eval" not in on_card


def test_f32_fused_eval_trainer_on_card(cuda_device):
    """An f32 SegTrainer with ``fused_middle_eval=True`` (TF32 off, set by
    the fixture): ``evaluate_miou`` host-fed and resident (a CUDA graph,
    whose replays count the captured launches) run the f32 kernels, 48
    launches of each per eval forward and no bf16 one, give the same
    matrix, and agree with the unfused f32 trainer on >= 99.9% of
    pixels."""
    from cervical_tpu_torch.config import SegDataConfig, SegTrainConfig
    from cervical_tpu_torch.data.resident import ResidentSegData
    from cervical_tpu_torch.data.voc import ArraySegDataset, BatchLoader
    from cervical_tpu_torch.models.deeplab import DeepLab
    from cervical_tpu_torch.train.seg_trainer import SegTrainer
    from torch_port_helpers import random_state
    rng = np.random.default_rng(39)
    imgs = rng.integers(0, 256, (11, 64, 64, 3), dtype=np.uint8)
    lbls = rng.integers(0, 5, (11, 64, 64), dtype=np.uint8)
    state = random_state(DeepLab(num_classes=5), seed=53)
    hists = []
    for fused in (True, False):
        tr = SegTrainer(SegTrainConfig(
            data=SegDataConfig(input_shape=(64, 64)), dtype="float32",
            fused_middle_eval=fused))
        tr.state.model.load_state_dict(state)
        MF.reset_launches()
        host = tr.evaluate_miou(BatchLoader(ArraySegDataset(imgs, lbls), 4,
                                            shuffle=False, drop_last=False))
        want = {"dw_stencil": 48 * 3 * fused, "pw_gemm": 48 * 3 * fused}
        assert MF.LAUNCHES == MF.F32_LAUNCHES == want
        if fused:
            MF.reset_launches()
            res = tr.evaluate_miou(ResidentSegData.from_arrays(
                imgs, lbls, 4, cuda_device, train=False))
            assert MF.LAUNCHES == MF.F32_LAUNCHES == want
            np.testing.assert_array_equal(res["hist"], host["hist"])
        hists.append(host["hist"])
    assert hists[0].sum() == 11 * 64 * 64
    assert np.abs(hists[0] - hists[1]).sum() // 2 <= 1e-3 * hists[0].sum()


def test_einsum_augmentation_on_card_matches_cpu(cuda_device):
    """The einsum backend at the step's caps on the card against the CPU:
    labels equal, images within one bf16 step on at most 1e-3 of the
    elements."""
    from cervical_tpu_torch.ops import augment as A
    from cervical_tpu_torch.ops.warp_xla import augment_batch_einsum
    rng = np.random.default_rng(34)
    imgs = torch.from_numpy(rng.integers(0, 256, (8, 80, 96, 3),
                                         dtype=np.uint8))
    lbls = torch.from_numpy(rng.integers(0, 5, (8, 80, 96), dtype=np.uint8))
    p = A.sample_augment_params(torch.Generator().manual_seed(35), 8,
                                rotate_prefix=2, blur_suffix=2)
    for kw in ({}, {"two_shear": True}, {"int8_resample": True}):
        kw.update(rotate_capacity=2, blur_capacity=2)
        ri, rl = augment_batch_einsum(imgs, lbls, p, (64, 64), **kw)
        gi, gl = augment_batch_einsum(
            imgs.to(cuda_device), lbls.to(cuda_device),
            {k: v.to(cuda_device) for k, v in p.items()}, (64, 64), **kw)
        assert torch.equal(gl.cpu(), rl), kw
        d = (gi.float().cpu() - ri.float()).abs()
        assert bool((d <= 2.0 ** -7 * ri.float().abs()).all()), kw
        assert float((d > 0).float().mean()) <= 1e-3, kw


def test_capture_refuses_host_uploads(cuda_device):
    """No fallback: the kernel chain asked to upload host parameters while
    a graph captures raises."""
    from cervical_tpu_torch.ops import augment as A
    from cervical_tpu_torch.ops import warp as W
    images, labels = _k_batches(cuda_device)
    p = A.sample_augment_params(torch.Generator().manual_seed(36), 4)
    W.augment_batch_kernels(images[0], labels[0], p, (64, 64))  # warm
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="captures"):
        with torch.cuda.graph(g):
            W.augment_batch_kernels(images[0], labels[0], p, (64, 64))


# -- the fusion classifier ------------------------------------------------------

def _fusion_trainer(device, **kw):
    from cervical_tpu_torch.config import FusionTrainConfig
    from cervical_tpu_torch.train.fusion_trainer import FusionTrainer
    cfg = FusionTrainConfig(**{"in_features": 64, "hidden": 128,
                               "batch_size": 8, "lr": 1e-3, **kw})
    return FusionTrainer(cfg, device=device)


def _fusion_states_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    if not all(torch.equal(v, sb[k]) for k, v in sa.items()):
        return False
    xa = a.opt_state["params"].state_dict()["state"]
    xb = b.opt_state["params"].state_dict()["state"]
    return xa.keys() == xb.keys() and all(
        torch.equal(torch.as_tensor(xa[i][k]), torch.as_tensor(xb[i][k]))
        for i in xa for k in xa[i])


@pytest.mark.parametrize("do_step", [False, True])
def test_fusion_graph_step_equals_eager_step(cuda_device, do_step):
    """The train step replayed from its CUDA graph (dropout on, the
    generators registered) equals the eager step on a twin state bit for
    bit: losses, predictions, params, Adam state.  Without ``do_step``
    nothing moves and Adam has no state."""
    from cervical_tpu_torch.data.fusion_data import make_synthetic_fusion
    from cervical_tpu_torch.data.masks import generate_modal_masks
    ds = make_synthetic_fusion(num_patients=20, feature_dim=64, seed=2)
    ga, gb = _fusion_trainer("cuda"), _fusion_trainer("cuda")
    sa, sb = ga.init_state(), gb.init_state()
    dev = ga._device_cohort(ds)
    call = ga._batch_step(sa, dev["feats"], dev["labels"], 8, do_step)
    step = gb.train_step_fn()
    masks = generate_modal_masks(torch.Generator("cuda").manual_seed(1),
                                 4 * 8, 4).reshape(4, 8, 4)
    w = torch.ones(8, device="cuda")
    w[5:] = 0
    for i in range(4):
        idx = torch.randint(0, 20, (8,), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(i))
        ma = call(idx, masks[i], w, ga._lr_arg(1e-3))
        mb = step(sb, {m: v.index_select(0, idx)
                       for m, v in dev["feats"].items()},
                  dev["labels"].index_select(0, idx), masks[i], w,
                  gb._lr_arg(1e-3), do_step)
        for k in ma:
            assert torch.equal(ma[k], mb[k]), (i, k)
    assert sa.step == sb.step == (4 if do_step else 0)
    assert _fusion_states_equal(sa, sb)
    assert bool(sa.opt_state["params"].state) == do_step


def test_fusion_epoch_and_cv_on_card(cuda_device, tmp_path):
    """The default epoch (graph replays) learns; cross_validate runs to its
    files on the card; the graphs were captured once per (batch, do_step)
    of a fold."""
    from cervical_tpu_torch.data.fusion_data import make_synthetic_fusion
    tr = _fusion_trainer("cuda", hidden=256, epochs=3, kfold=3, lr=5e-4,
                         batch_size=16)
    ds = make_synthetic_fusion(num_patients=60, feature_dim=64, noise=0.3)
    st = tr.init_state()
    accs = [tr.train_epoch(st, ds, e, 5e-4)["acc_all"] for e in range(5)]
    assert accs[-1] > 0.7, accs
    assert set(tr._graphs) == {(16, False), (16, True)}
    res = tr.cross_validate(ds, log=lambda *a: None, save_dir=str(tmp_path))
    assert len(res["folds"]) == 3
    assert (tmp_path / "best_seed0_fold2.npz").exists()


def test_fusion_predictor_on_card_matches_cpu(cuda_device):
    from cervical_tpu_torch.config import FusionTrainConfig
    from cervical_tpu_torch.data.fusion_data import make_synthetic_fusion
    from cervical_tpu_torch.inference.fusion_predictor import FusionPredictor
    cfg = FusionTrainConfig()  # full width: 1024 -> 512, 4 modalities
    st = _fusion_trainer("cpu", in_features=1024, hidden=512).init_state()
    ds = make_synthetic_fusion(num_patients=40, feature_dim=1024, seed=4)
    present = ds["present"].copy()
    present[::3, 1] = False
    kw = dict(batch_size=16)
    cpu = FusionPredictor(cfg, st.model.state_dict(), device="cpu", **kw)
    card = FusionPredictor(cfg, st.model.state_dict(), device="cuda", **kw)
    a = cpu.predict_proba(ds["feats"], present)
    b = card.predict_proba(ds["feats"], present)
    for k in a:
        assert float(np.abs(a[k] - b[k]).max()) < 1e-4, k
    assert card.get_throughput(batch_size=64, iters=2) > 0


def test_fusion_cv_resume_on_card_equals_uninterrupted(cuda_device, tmp_path):
    """A CV stopped after fold 0 and resumed in a fresh trainer gives the
    uninterrupted run's folds on the card too: the graphs replay the
    fold-keyed streams exactly."""
    from cervical_tpu_torch.data.fusion_data import make_synthetic_fusion
    ds = make_synthetic_fusion(num_patients=45, feature_dim=64, seed=3)
    kw = dict(epochs=2, kfold=3, epoch0_no_step=False)
    full = _fusion_trainer("cuda", **kw).cross_validate(
        ds, log=lambda *a: None, save_dir=str(tmp_path / "full"))
    tr = _fusion_trainer("cuda", **kw)

    def stop(msg):
        if ": test acc" in msg:
            tr.request_stop()
    part = tr.cross_validate(ds, log=stop, save_dir=str(tmp_path / "part"))
    assert part["stopped_early"] and len(part["folds"]) == 1
    resumed = _fusion_trainer("cuda", **kw).cross_validate(
        ds, log=lambda *a: None, save_dir=str(tmp_path / "part"))
    for a, b in zip(full["folds"], resumed["folds"]):
        assert a["val_acc"] == b["val_acc"]
        assert a["test"]["loss"] == b["test"]["loss"]
        assert [e["loss"] for e in a["epoch_test"]] == \
            [e["loss"] for e in b["epoch_test"]]
    for f in range(3):
        za = np.load(tmp_path / "full" / f"best_seed0_fold{f}.npz")
        zb = np.load(tmp_path / "part" / f"best_seed0_fold{f}.npz")
        assert all(np.array_equal(za[k], zb[k]) for k in za.files)


# -- the vmapped-folds engine and bf16 -------------------------------------------

def _stacked_twins(cfg, f, device):
    from cervical_tpu_torch.train import fold_stack as FS
    from cervical_tpu_torch.train.fusion_trainer import build_model, make_loss
    from cervical_tpu_torch.train.seg_trainer import TrainState
    sds = [build_model(cfg).init_weights(
        torch.Generator().manual_seed(30 + i)).state_dict() for i in range(f)]
    out = []
    for _ in range(2):
        stack = FS.FoldStack(build_model(cfg).to(device), sds,
                             [7 + i for i in range(f)])
        opt = FS.StackedAdam(stack.flat, lr=cfg.lr,
                             weight_decay=cfg.weight_decay)
        out.append((TrainState(stack, {"params": opt}),
                    FS.make_stacked_step(stack, opt, make_loss(cfg))))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fusion_stacked_graph_equals_eager(cuda_device, dtype):
    """Stacked steps of 3 pairs replayed from their CUDA graphs (one per
    ``do_step``) equal the same steps run eagerly on a twin stack bit for
    bit, dropout on: steps 0-1 without Adam (epoch 0), 2-3 with it, pair 1
    on an all-weight-0 batch at step 3, which moves neither its params nor
    its counts."""
    from cervical_tpu_torch.data.fusion_data import make_synthetic_fusion
    from cervical_tpu_torch.data.masks import generate_modal_masks
    from cervical_tpu_torch.train.graphs import GraphedCall
    cfg = _fusion_trainer("cpu", dtype=dtype).cfg
    ds = _fusion_trainer("cuda")._device_cohort(
        make_synthetic_fusion(num_patients=30, feature_dim=64, seed=6))
    (sa, step_a), (sb, step_b) = _stacked_twins(cfg, 3, cuda_device)
    g = torch.Generator("cuda").manual_seed(2)
    idx = torch.randint(0, 30, (4, 3, 8), generator=g, device="cuda")
    masks = generate_modal_masks(g, 96, 4).view(4, 3, 8, 4)
    w = torch.ones((4, 3, 8), device="cuda")
    w[3, 1] = 0
    w[3, 2, 5:] = 0
    lr = torch.full((), 1e-3, device="cuda")
    calls = {d: GraphedCall(
        lambda i, m, ww, l, d=d: step_a(ds["feats"], ds["labels"], i, m, ww,
                                        l, d),
        sa, (idx[0], masks[0], w[0], lr), cuda_device) for d in (False, True)}
    for k in range(4):
        if k == 3:
            held = sa.model.flat[1].clone()
        ma = calls[k >= 2](idx[k], masks[k], w[k], lr)
        mb = step_b(ds["feats"], ds["labels"], idx[k], masks[k], w[k], lr,
                    k >= 2)
        for key in ma:
            assert torch.equal(ma[key], mb[key]), (k, key)
        assert torch.isfinite(ma["loss"]).all()
    oa, ob = (s.opt_state["params"].state[s.model.flat] for s in (sa, sb))
    assert torch.equal(sa.model.flat, sb.model.flat)
    assert torch.equal(sa.model.rng, sb.model.rng)
    assert all(torch.equal(oa[k], ob[k]) for k in oa)
    assert torch.equal(sa.model.flat[1], held)
    assert oa["step"].tolist() == [2.0, 1.0, 2.0]
    assert sa.model.rng[:, 1].tolist() == [4, 3, 4]


def test_fusion_bf16_step_graph_equals_eager(cuda_device):
    """The sequential train step in bf16: graph replays equal eager steps
    bit for bit, finite losses, f32 params."""
    from cervical_tpu_torch.data.fusion_data import make_synthetic_fusion
    from cervical_tpu_torch.data.masks import generate_modal_masks
    ds = make_synthetic_fusion(num_patients=20, feature_dim=64, seed=2)
    ga = _fusion_trainer("cuda", dtype="bfloat16")
    gb = _fusion_trainer("cuda", dtype="bfloat16")
    sa, sb = ga.init_state(), gb.init_state()
    dev = ga._device_cohort(ds)
    call = ga._batch_step(sa, dev["feats"], dev["labels"], 8, True)
    masks = generate_modal_masks(torch.Generator("cuda").manual_seed(1),
                                 3 * 8, 4).reshape(3, 8, 4)
    w = torch.ones(8, device="cuda")
    for i in range(3):
        idx = torch.randint(0, 20, (8,), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(i))
        ma = call(idx, masks[i], w, ga._lr_arg(1e-3))
        mb = gb.train_step_fn()(
            sb, {m: v.index_select(0, idx) for m, v in dev["feats"].items()},
            dev["labels"].index_select(0, idx), masks[i], w,
            gb._lr_arg(1e-3), True)
        for k in ma:
            assert torch.equal(ma[k], mb[k]), (i, k)
        assert torch.isfinite(ma["loss"])
    assert _fusion_states_equal(sa, sb)
    assert all(p.dtype == torch.float32 for p in sa.model.parameters())


def test_fusion_vmapped_cv_on_card_matches_sequential(cuda_device, tmp_path):
    """``cross_validate(vmap_folds=True)`` on the card against the
    sequential engine there, at the CPU test's size and tolerances (folds
    of 3 and 4 batches)."""
    from cervical_tpu_torch.data.fusion_data import make_synthetic_fusion
    ds = make_synthetic_fusion(num_patients=48, feature_dim=32, seed=5)
    kw = dict(in_features=32, hidden=64, epochs=3, kfold=3)
    seq = _fusion_trainer("cuda", **kw).cross_validate(
        ds, log=lambda *a: None)
    vm = _fusion_trainer("cuda", **kw).cross_validate(
        ds, log=lambda *a: None, save_dir=str(tmp_path), vmap_folds=True)
    assert len(seq["folds"]) == len(vm["folds"]) == 3
    for a, b in zip(seq["folds"], vm["folds"]):
        assert a["best_epoch"] == b["best_epoch"]
        assert abs(a["val_acc"] - b["val_acc"]) <= 1e-5
        assert abs(a["test"]["acc_all"] - b["test"]["acc_all"]) <= 1e-6
        assert np.array_equal(a["test"]["confusion"], b["test"]["confusion"])
        for ea, eb in zip(a["epoch_test"], b["epoch_test"]):
            assert abs(ea["acc_all"] - eb["acc_all"]) <= 1e-6
            assert abs(ea["loss"] - eb["loss"]) <= 1e-4
    assert (tmp_path / "best_seed0_fold2.npz").exists()
