"""Eval-mode Xception middle flow (backbone blocks 4-19): BN fold, the plain
PyTorch version, and the wrappers of its Hopper kernels.

Port of ``cervical_tpu/ops/pallas_xception.py``.  Per block:
``skip = relu(x)``; three times [ReLU, depthwise 3x3 (zero pad, dilation
d), folded BN1 affine, pointwise C x C product with BN2's scale folded in,
+ BN2 shift]; ``out = z + skip``.  ``z`` stays f32 between the three
separable convs; only the product's input ``zb`` and the block output are
rounded to the compute dtype.

Tensors are NHWC, as in JAX.  :func:`middle_flow_eval` takes the plain
version for a CPU tensor only; for a CUDA tensor it launches the kernels of
``csrc/middle_flow.cu`` or raises: ``mf_dw_stencil`` then ``mf_pw_gemm``
per separable conv in bf16, ``mf_dw_stencil_f32`` then ``mf_pw_gemm_f32``
in f32 (the fold's compute dtype, as the JAX kernel computes in its
caller's), 96 launches for the 16 blocks.  Design notes and bounds are in
that file's header.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cervical_tpu_torch.ops import _build

SOURCE = _build.CSRC_DIR / "middle_flow.cu"

# kernel launches, counted by the wrappers where they launch: LAUNCHES
# counts each wrapper's launches in either type, F32_LAUNCHES those of its
# f32 instance (mf_dw_stencil_f32, mf_pw_gemm_f32) once more on their own
LAUNCHES = {"dw_stencil": 0, "pw_gemm": 0}
F32_LAUNCHES = {"dw_stencil": 0, "pw_gemm": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, F32_LAUNCHES):
        for k in counts:
            counts[k] = 0


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
    * ``c2``  (count, 3, C) f32 — folded bn2 shift;
    * ``wpw_t`` (count, 3, C, C) — ``wpw`` K-major, (out, in), the layout
      the kernels' tensor maps read (port-only key).
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
    out = {
        "wdw": torch.stack(wdw).to(compute_dtype).contiguous(),
        "s1": torch.stack(s1).contiguous(),
        "c1": torch.stack(c1).contiguous(),
        "wpw": torch.stack(wpw).to(compute_dtype).contiguous(),
        "c2": torch.stack(c2).contiguous(),
    }
    out["wpw_t"] = out["wpw"].transpose(-1, -2).contiguous()
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch version of the kernels
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
    """``zb @ w + c2`` in f32 (products of bf16 inputs are exact in f32;
    on the card an f32 ``zb`` needs TF32 off for a full-f32 product); with
    ``skip_src`` (the block input) adds ``relu(skip_src)`` and rounds to
    its dtype."""
    z = torch.matmul(zb.float(), w.float()) + c2
    if skip_src is None:
        return z
    return (z + torch.relu(skip_src.float())).to(skip_src.dtype)


def _middle_flow(x, folded, dilation, stencil, gemm, w_key="wpw"):
    """The block loop; ``gemm`` takes ``folded[w_key]``'s weight."""
    for k in range(folded["wdw"].shape[0]):
        z = x
        for i in range(3):
            zb = stencil(z, folded["wdw"][k, 9 * i:9 * i + 9],
                         folded["s1"][k, i], folded["c1"][k, i], dilation,
                         x.dtype)
            z = gemm(zb, folded[w_key][k, i], folded["c2"][k, i],
                     x if i == 2 else None)
        x = z
    return x


def middle_flow_reference(x, folded, dilation: int = 1):
    """Plain PyTorch version, op for op as
    ``pallas_xception.middle_flow_reference``: (B, H, W, C) -> same."""
    return _middle_flow(x, folded, dilation, dw_stencil_reference,
                        pw_gemm_reference)


# ---------------------------------------------------------------------------
# Launch plans of the kernels (mirror csrc/middle_flow.cu's constants)
# ---------------------------------------------------------------------------

ST_CX, ST_WY, STENCIL_ROWS = 8, 32, 8
BK, THREADS, GBM, GBN, GSTAGES = 64, 384, 256, 184, 4
FBM, FBN, FBK, FTHREADS, FLD = 128, 128, 8, 256, 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def dw_stencil_plan(b: int, h: int, w: int, c: int, dilation: int,
                    rows: int = STENCIL_ROWS) -> dict:
    """Launch of ``mf_dw_stencil``: blocks of ``ST_CX`` 8-channel chunks x
    ``ST_WY`` columns, each thread walking ``rows`` output rows of one
    residue of h mod ``dilation``; grid (channel x column tiles, residues x
    row segments, images)."""
    if c % 8 or min(b, h, w, c, dilation, rows) < 1:
        raise ValueError(f"channels must be a multiple of 8 and sizes >= 1, "
                         f"got {(b, h, w, c)}, dilation {dilation}, rows "
                         f"{rows}")
    segs = _cdiv(_cdiv(h, dilation), rows)
    return {"grid": (_cdiv(c // 8, ST_CX) * _cdiv(w, ST_WY),
                     dilation * segs, b),
            "block": (ST_CX, ST_WY), "rows": rows}


def pw_gemm_plan(m: int, k: int, n: int) -> dict:
    """Launch of ``mf_pw_gemm``: one block per ``GBM`` x ``GBN`` output
    tile, A's ``BK`` x ``GBM`` and W^T's ``BK`` x ``GBN`` boxes of each
    k-tile streamed together through ``GSTAGES`` stages (the last k-tile
    zero-filled past K)."""
    if k % 8 or n % 8 or m < 1 or k < 8 or n < 8:
        raise ValueError(f"channels must be multiples of 8 and rows >= 1, "
                         f"got m={m} k={k} n={n}")
    smem = 1024 + GSTAGES * (GBM + GBN) * BK * 2 + 16 * GSTAGES
    return {"grid": (_cdiv(n, GBN), _cdiv(m, GBM)), "threads": THREADS,
            "k_tiles": _cdiv(k, BK), "k_pad": _cdiv(k, BK) * BK,
            "smem_bytes": smem, "box_a": (BK, GBM), "box_w": (BK, GBN),
            "stages": GSTAGES}


def pw_gemm_f32_plan(m: int, k: int, n: int) -> dict:
    """Launch of ``mf_pw_gemm_f32``: one block of ``FTHREADS`` per ``FBM``
    x ``FBN`` output tile (8 x 8 accumulators a thread), K in whole k-tiles
    of ``FBK``; two shared buffers, each holding A's and W^T's k-tile
    transposed in rows of ``FLD`` floats."""
    if k % 8 or n % 8 or m < 1 or k < 8 or n < 8:
        raise ValueError(f"channels must be multiples of 8 and rows >= 1, "
                         f"got m={m} k={k} n={n}")
    return {"grid": (_cdiv(n, FBN), _cdiv(m, FBM)), "threads": FTHREADS,
            "k_tiles": k // FBK, "smem_bytes": 2 * 2 * FBK * FLD * 4,
            "tile": (FBM, FBN, FBK), "row_bytes": (k * 4, n * 4)}


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
                                      i32, i32, i32, vp]
        lib.mf_dw_stencil.restype = i32
        lib.mf_pw_gemm.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32, vp]
        lib.mf_pw_gemm.restype = i32
        lib.mf_pw_gemm_regs.argtypes = [i32]
        lib.mf_pw_gemm_regs.restype = i32
        lib.mf_dw_stencil_f32.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32,
                                          i32, i32, i32, vp]
        lib.mf_dw_stencil_f32.restype = i32
        lib.mf_pw_gemm_f32.argtypes = lib.mf_pw_gemm.argtypes
        lib.mf_pw_gemm_f32.restype = i32
        _lib_handle = lib
    return _lib_handle


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (the kernels load "
                         "16-byte vectors and TMA reads 16-byte-aligned "
                         "rows)")
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise(name, rc):
    if rc >= 20000:
        raise RuntimeError(f"{name}: ptxas gave the kernel {rc - 20000} "
                           "registers per thread; its setmaxnreg split (40 "
                           "+ 232 over 384 threads) needs 168")
    if rc >= 10000:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed "
                           f"(CUresult {rc - 10000}; 999: no driver entry)")
    raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def dw_stencil(z, wdw9, s1, c1, dilation: int, dtype=torch.bfloat16):
    """Kernel ``mf_dw_stencil`` (bf16) or ``mf_dw_stencil_f32`` (f32):
    :func:`dw_stencil_reference` on the card.  ``s1``/``c1`` (C,) f32, C a
    multiple of 8; ``dtype`` is the compute type, that of ``wdw9`` (9, C)
    and of the returned ``zb`` (B, H, W, C): bf16 from a ``z`` (B, H, W, C)
    in bf16 or f32, or f32 from an f32 ``z``."""
    f32 = dtype == torch.float32
    if not (f32 and z.dtype == torch.float32 or dtype == torch.bfloat16
            and z.dtype in (torch.bfloat16, torch.float32)):
        raise TypeError("the middle-flow kernels compute in bf16 (z bf16 or "
                        "f32) or in f32 (z f32), got input "
                        f"{z.dtype}, output {dtype}")
    if z.ndim != 4:
        raise ValueError(f"z must be (B, H, W, C), got {tuple(z.shape)}")
    b, h, w, c = z.shape
    if c % 8:
        raise ValueError(f"channels must be a multiple of 8, got {c}")
    _check("z", z, z.dtype, z.shape)
    _check("wdw9", wdw9, dtype, (9, c))
    _check("s1", s1, torch.float32, (c,))
    _check("c1", c1, torch.float32, (c,))
    plan = dw_stencil_plan(b, h, w, c, dilation)
    zb = torch.empty(z.shape, dtype=dtype, device=z.device)
    if f32:
        rc = _lib().mf_dw_stencil_f32(z.data_ptr(), wdw9.data_ptr(),
                                      s1.data_ptr(), c1.data_ptr(),
                                      zb.data_ptr(), b, h, w, c, dilation,
                                      plan["rows"], _stream(z))
    else:
        rc = _lib().mf_dw_stencil(z.data_ptr(), int(z.dtype == torch.float32),
                                  wdw9.data_ptr(), s1.data_ptr(),
                                  c1.data_ptr(), zb.data_ptr(), b, h, w, c,
                                  dilation, plan["rows"], _stream(z))
    if rc:
        _raise("mf_dw_stencil_f32" if f32 else "mf_dw_stencil", rc)
    LAUNCHES["dw_stencil"] += 1
    if f32:
        F32_LAUNCHES["dw_stencil"] += 1
    return zb


def pw_gemm(zb, w_t, c2, skip_src=None):
    """Kernel ``mf_pw_gemm`` (bf16) or ``mf_pw_gemm_f32`` (f32):
    :func:`pw_gemm_reference` on the card.  ``zb`` (B, H, W, K) and
    ``w_t`` (N, K) (the weight K-major, as ``fold_middle_flow``'s
    ``wpw_t``) both bf16 or both f32, ``c2`` (N,) f32; returns f32, or with
    ``skip_src`` (B, H, W, N) of ``zb``'s type a tensor of that type."""
    if zb.ndim != 4 or w_t.ndim != 2:
        raise ValueError(f"zb must be (B, H, W, K) and w_t (N, K), got "
                         f"{tuple(zb.shape)} and {tuple(w_t.shape)}")
    if zb.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"zb must be bf16 or f32, got {zb.dtype}")
    f32 = zb.dtype == torch.float32
    n, k = w_t.shape
    if k % 8 or n % 8:
        raise ValueError(f"channels must be multiples of 8, got {k}x{n}")
    m = zb.numel() // k
    _check("zb", zb, zb.dtype, zb.shape[:3] + (k,))
    _check("w_t", w_t, zb.dtype, (n, k))
    _check("c2", c2, torch.float32, (n,))
    out_shape = zb.shape[:3] + (n,)
    if skip_src is not None:
        _check("skip_src", skip_src, zb.dtype, out_shape)
    plan = (pw_gemm_f32_plan if f32 else pw_gemm_plan)(m, k, n)
    out = torch.empty(out_shape, device=zb.device,
                      dtype=torch.float32 if skip_src is None
                      else skip_src.dtype)
    launch = _lib().mf_pw_gemm_f32 if f32 else _lib().mf_pw_gemm
    rc = launch(zb.data_ptr(), w_t.data_ptr(), c2.data_ptr(),
                None if skip_src is None else skip_src.data_ptr(),
                out.data_ptr(), m, k, n, plan["smem_bytes"], _stream(zb))
    if rc:
        _raise("mf_pw_gemm_f32" if f32 else "mf_pw_gemm", rc)
    LAUNCHES["pw_gemm"] += 1
    if f32:
        F32_LAUNCHES["pw_gemm"] += 1
    return out


def middle_flow_eval(x, folded, dilation: int = 1):
    """Fused eval-mode middle flow: (B, H, W, C) -> (B, H, W, C).

    ``folded`` comes from :func:`fold_middle_flow` at ``x``'s dtype.  A
    CPU tensor takes :func:`middle_flow_reference`; a CUDA tensor (bf16 or
    f32, C a multiple of 8) runs :func:`dw_stencil` then :func:`pw_gemm`
    (on ``wpw_t``) per separable conv in ``x``'s dtype, 96 launches for 16
    blocks.  Other devices raise.
    """
    if x.device.type == "cpu":
        return middle_flow_reference(x, folded, dilation)
    if not x.is_cuda:
        raise ValueError(f"middle_flow_eval runs on cpu or cuda, got {x.device}")
    if "wpw_t" not in folded:
        raise KeyError("folded lacks 'wpw_t', the K-major pointwise weights "
                       "the kernels read: fold with fold_middle_flow")
    return _middle_flow(x.contiguous(), folded, dilation, dw_stencil, pw_gemm,
                        "wpw_t")
