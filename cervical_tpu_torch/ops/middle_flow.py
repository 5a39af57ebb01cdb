"""Eval-mode Xception middle flow (backbone blocks 4-19): BN fold, the plain
PyTorch version, and the wrappers of its two Hopper kernels.

Port of ``cervical_tpu/ops/pallas_xception.py``.  Per block:
``skip = relu(x)``; three times [ReLU, depthwise 3x3 (zero pad, dilation
d), folded BN1 affine, pointwise C x C product with BN2's scale folded in,
+ BN2 shift]; ``out = z + skip``.  ``z`` stays f32 between the three
separable convs; only the product's input ``zb`` and the block output are
rounded to the compute dtype.

Tensors are NHWC, as in JAX.  :func:`middle_flow_eval` takes the plain
version for a CPU tensor only; for a CUDA tensor it launches the kernels of
``csrc/middle_flow.cu`` (two per separable conv, 96 for the 16 blocks) or
raises.  Design notes and bounds are in that file's header.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cervical_tpu_torch.ops import _build

SOURCE = _build.CSRC_DIR / "middle_flow.cu"

# kernel launches, counted by the wrappers where they launch
LAUNCHES = {"dw_stencil": 0, "pw_gemm": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# BatchNorm folding
# ---------------------------------------------------------------------------

@torch.no_grad()
def fold_middle_flow(backbone, first: int = 4, count: int = 16,
                     eps: float = 1e-5, compute_dtype=torch.bfloat16):
    """Stacked, BN-folded middle-flow weights from an
    :class:`~cervical_tpu_torch.models.backbones.xception.XceptionBackbone`
    (fp32 params and running stats).  Returns a dict:

    * ``wdw``  (count, 27, C) ``compute_dtype`` — depthwise taps, laid out
      ``[sepconv*9 + dy*3 + dx]``;
    * ``s1/c1`` (count, 3, C) f32 — folded bn1 affine after the depthwise;
    * ``wpw``  (count, 3, C, C) ``compute_dtype`` — pointwise weights
      (in, out) with bn2's scale folded in;
    * ``c2``  (count, 3, C) f32 — folded bn2 shift.
    """
    wdw, s1, c1, wpw, c2 = [], [], [], [], []
    for b in range(first, first + count):
        block = getattr(backbone, f"block{b}")
        bwdw, bs1, bc1, bwpw, bc2 = [], [], [], [], []
        for i in (1, 2, 3):
            sp = getattr(block, f"sepconv{i}")
            sc1 = sp.bn1.weight.float() * torch.rsqrt(
                sp.bn1.running_var.float() + eps)
            sh1 = sp.bn1.bias.float() - sp.bn1.running_mean.float() * sc1
            sc2 = sp.bn2.weight.float() * torch.rsqrt(
                sp.bn2.running_var.float() + eps)
            sh2 = sp.bn2.bias.float() - sp.bn2.running_mean.float() * sc2
            k = sp.depthwise.weight.float()            # (C, 1, 3, 3)
            bwdw.append(k[:, 0].reshape(k.shape[0], 9).t())
            bs1.append(sc1)
            bc1.append(sh1)
            w = sp.pointwise.weight.float()[:, :, 0, 0].t()  # (in, out)
            bwpw.append(w * sc2[None, :])
            bc2.append(sh2)
        wdw.append(torch.cat(bwdw, 0))
        s1.append(torch.stack(bs1))
        c1.append(torch.stack(bc1))
        wpw.append(torch.stack(bwpw))
        c2.append(torch.stack(bc2))
    return {
        "wdw": torch.stack(wdw).to(compute_dtype).contiguous(),
        "s1": torch.stack(s1).contiguous(),
        "c1": torch.stack(c1).contiguous(),
        "wpw": torch.stack(wpw).to(compute_dtype).contiguous(),
        "c2": torch.stack(c2).contiguous(),
    }


# ---------------------------------------------------------------------------
# Plain PyTorch version of the two kernels
# ---------------------------------------------------------------------------

def dw_stencil_reference(z, wdw9, s1, c1, dilation: int, dtype):
    """``dtype((sum_taps relu(z)·w) * s1 + c1)``: ReLU, the 9 zero-padded
    depthwise taps at ``dilation`` in f32, the folded BN1 affine."""
    d = dilation
    h, w = z.shape[1], z.shape[2]
    zp = F.pad(torch.relu(z.float()), (0, 0, d, d, d, d))
    acc = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            tap = zp[:, d + dy * d: d + dy * d + h, d + dx * d: d + dx * d + w]
            term = tap * wdw9[(dy + 1) * 3 + (dx + 1)].float()
            acc = term if acc is None else acc + term
    return (acc * s1 + c1).to(dtype)


def pw_gemm_reference(zb, w, c2, skip_src=None):
    """``zb @ w + c2`` in f32 (products of the bf16 inputs are exact in
    f32); with ``skip_src`` (the block input) adds ``relu(skip_src)`` and
    rounds to its dtype."""
    z = torch.matmul(zb.float(), w.float()) + c2
    if skip_src is None:
        return z
    return (z + torch.relu(skip_src.float())).to(skip_src.dtype)


def _middle_flow(x, folded, dilation, stencil, gemm):
    for k in range(folded["wdw"].shape[0]):
        z = x
        for i in range(3):
            zb = stencil(z, folded["wdw"][k, 9 * i:9 * i + 9],
                         folded["s1"][k, i], folded["c1"][k, i], dilation,
                         x.dtype)
            z = gemm(zb, folded["wpw"][k, i], folded["c2"][k, i],
                     x if i == 2 else None)
        x = z
    return x


def middle_flow_reference(x, folded, dilation: int = 1):
    """Plain PyTorch version, op for op as
    ``pallas_xception.middle_flow_reference``: (B, H, W, C) -> same."""
    return _middle_flow(x, folded, dilation, dw_stencil_reference,
                        pw_gemm_reference)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_lib_handle = None


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load(SOURCE)
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mf_dw_stencil.argtypes = [vp, i32, vp, vp, vp, vp, i32, i32, i32,
                                      i32, i32, vp]
        lib.mf_dw_stencil.restype = i32
        lib.mf_pw_gemm.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, vp]
        lib.mf_pw_gemm.restype = i32
        _lib_handle = lib
    return _lib_handle


def _check(name, t, dtype, shape):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (the kernels load "
                         "16-byte vectors)")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def dw_stencil(z, wdw9, s1, c1, dilation: int, dtype=torch.bfloat16):
    """Kernel ``mf_dw_stencil``: :func:`dw_stencil_reference` on the card.
    ``z`` (B, H, W, C) bf16 or f32, ``wdw9`` (9, C) bf16, ``s1``/``c1``
    (C,) f32, C a multiple of 8; returns ``zb`` (B, H, W, C) bf16."""
    if dtype != torch.bfloat16 or z.dtype not in (torch.bfloat16,
                                                  torch.float32):
        raise TypeError("the middle-flow kernels compute in bf16, got "
                        f"input {z.dtype}, output {dtype}")
    if z.ndim != 4:
        raise ValueError(f"z must be (B, H, W, C), got {tuple(z.shape)}")
    b, h, w, c = z.shape
    if c % 8:
        raise ValueError(f"channels must be a multiple of 8, got {c}")
    _check("z", z, z.dtype, z.shape)
    _check("wdw9", wdw9, torch.bfloat16, (9, c))
    _check("s1", s1, torch.float32, (c,))
    _check("c1", c1, torch.float32, (c,))
    zb = torch.empty(z.shape, dtype=torch.bfloat16, device=z.device)
    rc = _lib().mf_dw_stencil(z.data_ptr(), int(z.dtype == torch.float32),
                              wdw9.data_ptr(), s1.data_ptr(), c1.data_ptr(),
                              zb.data_ptr(), b, h, w, c, dilation, _stream(z))
    if rc:
        raise RuntimeError(f"mf_dw_stencil launch failed: CUDA error {rc}")
    LAUNCHES["dw_stencil"] += 1
    return zb


def pw_gemm(zb, w, c2, skip_src=None):
    """Kernel ``mf_pw_gemm``: :func:`pw_gemm_reference` on the card.
    ``zb`` (B, H, W, K) bf16, ``w`` (K, N) bf16, ``c2`` (N,) f32; returns
    f32, or with ``skip_src`` (B, H, W, N) bf16 a bf16 tensor."""
    if zb.ndim != 4:
        raise ValueError(f"zb must be (B, H, W, C), got {tuple(zb.shape)}")
    k, n = w.shape[0], w.shape[-1]
    if k % 8 or n % 8:
        raise ValueError(f"channels must be multiples of 8, got {k}x{n}")
    m = zb.numel() // k
    _check("zb", zb, torch.bfloat16, zb.shape[:3] + (k,))
    _check("w", w, torch.bfloat16, (k, n))
    _check("c2", c2, torch.float32, (n,))
    out_shape = zb.shape[:3] + (n,)
    if skip_src is not None:
        _check("skip_src", skip_src, torch.bfloat16, out_shape)
    out = torch.empty(out_shape, device=zb.device,
                      dtype=torch.float32 if skip_src is None
                      else torch.bfloat16)
    rc = _lib().mf_pw_gemm(zb.data_ptr(), w.data_ptr(), c2.data_ptr(),
                           None if skip_src is None else skip_src.data_ptr(),
                           out.data_ptr(), m, k, n, _stream(zb))
    if rc:
        raise RuntimeError(f"mf_pw_gemm launch failed: CUDA error {rc}")
    LAUNCHES["pw_gemm"] += 1
    return out


def middle_flow_eval(x, folded, dilation: int = 1):
    """Fused eval-mode middle flow: (B, H, W, C) -> (B, H, W, C).

    ``folded`` comes from :func:`fold_middle_flow`.  A CPU tensor takes
    :func:`middle_flow_reference`; a CUDA tensor (bf16, C a multiple of 8)
    runs the two kernels, 96 launches for 16 blocks.  Other devices raise.
    """
    if x.device.type == "cpu":
        return middle_flow_reference(x, folded, dilation)
    if not x.is_cuda:
        raise ValueError(f"middle_flow_eval runs on cpu or cuda, got {x.device}")
    return _middle_flow(x.contiguous(), folded, dilation, dw_stencil, pw_gemm)
