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


@pytest.mark.parametrize("src_hw,s", [((64, 64), 64), ((40, 64), 64),
                                      ((512, 512), 512)])
def test_warp_kernels_match_plain(cuda_device, src_hw, s):
    """K1 and K2 on the card against their plain versions on the same rows:
    scale above and below 1, flip, paste, +-3/+-10 degree rotations and 0,
    a non-square source, an NHWC source read through its permuted view.
    Both repeat the plain versions' f32 ops with the same roundings, so K2
    is exact and K1 is held to one bf16 step (it is expected exact)."""
    from cervical_tpu_torch.ops import warp as W
    _, wp, imgs, lbls = _warp_case(s, 8, src_hw, s,
                                   [3.0, -3.0, 10.0, -10.0, 0, 0, 0, 0])
    wpd, xd, ld = wp.to(cuda_device), imgs.to(cuda_device), lbls.to(cuda_device)
    W.reset_launches()
    for out_dtype in (torch.bfloat16, torch.uint8):
        got = W.warp_images(xd.permute(0, 3, 1, 2), wpd, s, out_dtype)
        ref = W.warp_images_reference(xd.permute(0, 3, 1, 2), wpd, s,
                                      out_dtype)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        step = 1.0 if out_dtype == torch.uint8 else \
            2.0 ** -8 * ref.float().abs().clamp(min=1.0)
        assert bool((err <= step).all()), float(err.max())
    got = W.warp_labels(ld, wpd, s)
    assert torch.equal(got, W.warp_labels_reference(ld, wpd, s))
    assert W.LAUNCHES == {"warp_images": 2, "warp_labels": 1,
                          "photometric": 0, "warp_photo_images": 0}


@pytest.mark.parametrize("mode", ["select", "all", "none"])
@pytest.mark.parametrize("in_dtype", [torch.uint8, torch.bfloat16,
                                      torch.float32])
def test_photometric_kernel_matches_plain(cuda_device, mode, in_dtype):
    """K3 against its plain version: the same f32 ops in the same order,
    so the bf16 output is expected exact; held to one bf16 step."""
    from cervical_tpu_torch.ops import warp as W
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(0, 256, (4, 3, 67, 70)).astype(
        np.float32)).to(cuda_device, in_dtype)
    gains = torch.from_numpy(rng.uniform(0.7, 1.3, (4, 3)).astype(
        np.float32)).to(cuda_device)
    flags = torch.tensor([True, False, True, False], device=cuda_device)
    for out_dtype in (torch.bfloat16, torch.float32):
        got = W.photometric(x, gains, flags, out_dtype, mode)
        ref = W.photometric_reference(x, gains, flags, out_dtype, mode)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        assert bool((err <= 2.0 ** -8 * ref.float().abs() + 1e-7).all()), \
            float(err.max())


@pytest.mark.parametrize("src_hw,s", [((64, 64), 64), ((40, 64), 64),
                                      ((67, 70), 67), ((512, 512), 512)])
def test_warp_photo_kernel_matches_plain_and_chain(cuda_device, src_hw, s):
    """K5 against its plain version and against the K1 -> K3 kernel chain
    on the same rows: images rotated and blurred, rotated only, blurred
    only, neither; a ragged output size.  The same f32 ops with the same
    roundings as the chain, so both are expected exact; held to one bf16
    step."""
    from cervical_tpu_torch.ops import warp as W
    p, wp, imgs, _ = _warp_case(s + 1, 8, src_hw, s,
                                [3.0, -3.0, 10.0, -10.0, 0, 0, 0, 0])
    flags = torch.tensor([1, 0, 1, 0, 1, 0, 1, 0], dtype=torch.bool)
    full = torch.cat([wp, p["gains"].float(), flags.float()[:, None]],
                     1).to(cuda_device)
    x = imgs.to(cuda_device).permute(0, 3, 1, 2)
    W.reset_launches()
    for out_dtype in (torch.bfloat16, torch.float32):
        got = W.warp_photo_images(x, full, s, out_dtype)
        ref = W.warp_photo_images_reference(x, full, s, out_dtype)
        chain = W.photometric(W.warp_images(x, full[:, :8], s),
                              full[:, 8:11], flags.to(cuda_device), out_dtype)
        torch.cuda.synchronize()
        for want in (ref, chain):
            err = (got.float() - want.float()).abs()
            assert bool((err <= 2.0 ** -8 * want.float().abs() + 1e-7)
                        .all()), float(err.max())
    assert W.LAUNCHES == {"warp_images": 2, "warp_labels": 0,
                          "photometric": 2, "warp_photo_images": 2}


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
