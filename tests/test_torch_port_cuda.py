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
        pytest.skip("needs an NVIDIA GPU: the middle-flow kernels are CUDA "
                    "only and have no interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _random_folded(seed, nblk, c, device):
    """Folded weights scaled like tests/test_pallas_xception.py."""
    rng = np.random.default_rng(seed)
    f = {"wdw": rng.standard_normal((nblk, 27, c)) * 0.2,
         "s1": rng.uniform(0.5, 1.5, (nblk, 3, c)),
         "c1": rng.standard_normal((nblk, 3, c)) * 0.1,
         "wpw": rng.standard_normal((nblk, 3, c, c)) * (1.5 / np.sqrt(c)),
         "c2": rng.standard_normal((nblk, 3, c)) * 0.1}
    return {k: torch.from_numpy(v.astype(np.float32)).to(
        device, torch.bfloat16 if k in ("wdw", "wpw") else torch.float32)
        for k, v in f.items()}


@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("c", [32, 728])
def test_middle_flow_kernels_match_plain(cuda_device, c, dilation):
    """Odd spatial sizes and ragged C=728 tiles, each block held against the
    plain version on the same input.  bf16: f32 sums in another order flip
    bf16 roundings of zb and the block output, so rtol=atol=1e-2 as JAX
    holds its own kernel.  (Chained, the flips compound block by block:
    the whole-chain drift is what chip_smoke.py reports.)"""
    folded = _random_folded(9, 3, c, cuda_device)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, 11, 13, c)).astype(np.float32)).to(cuda_device, torch.bfloat16)
    MF.reset_launches()
    chained = MF.middle_flow_eval(x, folded, dilation)
    assert MF.LAUNCHES == {"dw_stencil": 9, "pw_gemm": 9}
    for k in range(3):
        part = {n: v[k:k + 1] for n, v in folded.items()}
        got = MF.middle_flow_eval(x, part, dilation)
        torch.cuda.synchronize()
        ref = MF.middle_flow_reference(x, part, dilation)
        torch.testing.assert_close(got.float(), ref.float(), rtol=1e-2,
                                   atol=1e-2)
        x = got
    assert torch.equal(chained, x)  # the chain is the blocks one by one


@pytest.mark.parametrize("c", [8, 40, 728])
def test_stencil_is_exact_and_gemm_close(cuda_device, c):
    """The stencil repeats the plain version's f32 ops in order without
    FMA: bit-exact.  The GEMM sums exact bf16 products in f32 in another
    order: 1e-4.  With a bf16 output that is one bf16 step (2^-7 relative)
    plus the f32 sum's error where adding the skip cancels the value."""
    g = torch.Generator().manual_seed(c)
    z = torch.randn(3, 7, 5, c, generator=g).to(cuda_device)
    w9 = torch.randn(9, c, generator=g).to(cuda_device, torch.bfloat16)
    s1 = torch.rand(c, generator=g).to(cuda_device) + 0.5
    c1 = torch.randn(c, generator=g).to(cuda_device)
    for zin in (z, z.to(torch.bfloat16)):
        got = MF.dw_stencil(zin, w9, s1, c1, 2)
        ref = MF.dw_stencil_reference(zin, w9, s1, c1, 2, torch.bfloat16)
        assert torch.equal(got, ref)
    zb = torch.randn(3, 7, 5, c, generator=g).to(cuda_device, torch.bfloat16)
    w = torch.randn(c, c, generator=g).to(cuda_device, torch.bfloat16)
    c2 = torch.randn(c, generator=g).to(cuda_device)
    torch.testing.assert_close(MF.pw_gemm(zb, w, c2),
                               MF.pw_gemm_reference(zb, w, c2),
                               rtol=1e-4, atol=1e-4)
    skip = z.to(torch.bfloat16)
    torch.testing.assert_close(MF.pw_gemm(zb, w, c2, skip).float(),
                               MF.pw_gemm_reference(zb, w, c2, skip).float(),
                               rtol=2 ** -7, atol=1e-3)


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


def test_fused_predictor_matches_plain_on_cuda(cuda_device):
    """SegPredictor at 64², bf16, defaults to CUDA; the fused middle flow
    goes through the kernels and agrees with the unfused model."""
    from cervical_tpu_torch.config import SegDataConfig, SegTrainConfig
    from cervical_tpu_torch.inference.predictor import SegPredictor
    from cervical_tpu_torch.models.deeplab import DeepLab
    from torch_port_helpers import random_state

    state = random_state(DeepLab(num_classes=5), seed=51)
    cfg = SegTrainConfig(data=SegDataConfig(input_shape=(64, 64)))
    fused = SegPredictor(cfg, state, fused_middle=True)
    plain = SegPredictor(cfg, state)
    assert fused.device.type == "cuda"
    imgs = np.random.default_rng(52).integers(0, 256, (3, 45, 70, 3)).astype(np.uint8)
    MF.reset_launches()
    m1 = fused.predict_masks(imgs, batch_size=2)
    assert MF.LAUNCHES == {"dw_stencil": 96, "pw_gemm": 96}
    m0 = plain.predict_masks(imgs, batch_size=2)
    assert (m1 == m0).mean() >= 0.99
    np.testing.assert_allclose(fused.predict_probs(imgs[0]),
                               plain.predict_probs(imgs[0]), atol=0.05)
