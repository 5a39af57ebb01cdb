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
caller's; the f32 product runs on the tensor cores from the TF32 high and
low parts of its operands, :func:`tf32_split`), 96 launches for the 16
blocks.  Design notes and bounds are in that file's header.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cervical_tpu_torch.ops import _build
from cervical_tpu_torch.utils.profiling import span

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
      the kernels' tensor maps read (port-only key);
    * ``wpw_t_split`` (count, 3, 2, C, C), at ``compute_dtype=float32``
      only — ``wpw_t``'s TF32 high and low parts (:func:`tf32_split`), what
      the f32 product reads (port-only key).
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
    if compute_dtype == torch.float32:
        out["wpw_t_split"] = torch.stack(tf32_split(out["wpw_t"]), 2)
    return out


def _tf32_rna(x):
    """``x`` f32 rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32``: an f32 with the 13 low mantissa
    bits zero.  Bit arithmetic on the pattern: adding half of the dropped
    unit carries into the kept bits exactly when the dropped part is at
    least half of it (finite inputs)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x):
    """``(hi, lo)`` with ``hi = _tf32_rna(x)``, ``lo = _tf32_rna(x - hi)``
    (``x - hi`` is exact in f32): ``|x - hi - lo| <= 2^-22 |x|``.  The f32
    product's operands as its kernel splits them."""
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x.float() - hi)


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
FBK, FBM, FSTAGES, F_PRODUCER_REGS, F_CONSUMER_REGS = 32, 128, 3, 24, 240
SW, SQ_MAX, S_OUT = 32, 13, 4
# output rows per block of mf_dw_stencil_f32, by dilation
STENCIL_F32_ROWS = {1: 4, 2: 3}


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
    """Launch of ``mf_pw_gemm_f32``: one block per ``FBM`` x ``GBN`` output
    tile (one m64 panel per consumer warpgroup), A's ``FBK`` x ``FBM`` box
    and W_hi's and W_lo's ``FBK`` x ``GBN`` boxes of each k-tile (128
    bytes of f32: the swizzle's width, the last k-tile zero-filled past K)
    streamed together through ``FSTAGES`` stages."""
    if k % 8 or n % 8 or m < 1 or k < 8 or n < 8:
        raise ValueError(f"channels must be multiples of 8 and rows >= 1, "
                         f"got m={m} k={k} n={n}")
    stage = (FBM + 2 * GBN) * FBK * 4
    return {"grid": (_cdiv(n, GBN), _cdiv(m, FBM)), "threads": THREADS,
            "k_tiles": _cdiv(k, FBK), "k_pad": _cdiv(k, FBK) * FBK,
            "stage_bytes": stage,
            "smem_bytes": 1024 + FSTAGES * stage + 16 * FSTAGES,
            "box_a": (FBK, FBM), "box_w": (FBK, GBN), "stages": FSTAGES,
            "regs": (F_PRODUCER_REGS, F_CONSUMER_REGS)}


def stencil_f32_quads(c: int) -> int:
    """Channel quads per block of ``mf_dw_stencil_f32``: the largest odd
    divisor of C / 4 up to ``SQ_MAX`` (728: 13)."""
    return max(q for q in range(1, SQ_MAX + 1, 2) if (c // 4) % q == 0)


def dw_stencil_f32_plan(b: int, h: int, w: int, c: int, dilation: int,
                        rows: int | None = None) -> dict:
    """Launch of ``mf_dw_stencil_f32``: blocks of ``SW`` columns x ``sq``
    channel quads (a slice of ``4 sq`` channels), each walking ``rows``
    output rows of one residue of h mod ``dilation`` from its ``rows + 2``
    input rows, all in shared memory; grid (slices x column tiles, residues
    x row segments, images).  ``rows`` defaults to ``STENCIL_F32_ROWS``."""
    d = dilation
    if rows is None:
        rows = STENCIL_F32_ROWS.get(d, STENCIL_ROWS)
    if c % 8 or min(b, h, w, c, d, rows) < 1:
        raise ValueError(f"channels must be a multiple of 8 and sizes >= 1, "
                         f"got {(b, h, w, c)}, dilation {d}, rows {rows}")
    sq = stencil_f32_quads(c)
    cs = 4 * sq

    def up(x):
        return _cdiv(x, 128) * 128
    slot = up((SW + 2 * d) * cs * 4)
    taps = up(11 * cs * 4)
    smem = (128 + taps + (rows + 2) * slot + S_OUT * SW * cs * 4
            + 8 * (rows + 2))
    segs = _cdiv(_cdiv(h, d), rows)
    return {"grid": (c // cs * _cdiv(w, SW), d * segs, b), "block": (SW, sq),
            "rows": rows, "slice": cs, "slot_bytes": slot,
            "smem_bytes": smem, "box_in": (cs, SW + 2 * d),
            "box_out": (cs, SW)}


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
        lib.mf_pw_gemm_f32_regs.argtypes = [i32]
        lib.mf_pw_gemm_f32_regs.restype = i32
        lib.mf_tf32_split.argtypes = [vp, vp, vp, i32, vp]
        lib.mf_tf32_split.restype = i32
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
        split = "24 + 2 x 240" if name.endswith("f32") else "40 + 2 x 232"
        raise RuntimeError(f"{name}: ptxas gave the kernel {rc - 20000} "
                           "registers per thread; its setmaxnreg split "
                           f"({split} over 3 warpgroups) needs 168")
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
    plan = (dw_stencil_f32_plan if f32 else dw_stencil_plan)(
        b, h, w, c, dilation)
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
    :func:`pw_gemm_reference` on the card.  ``zb`` (B, H, W, K) bf16 or
    f32, ``c2`` (N,) f32; ``w_t`` the weight K-major, of ``zb``'s type: bf16
    (N, K) (``fold_middle_flow``'s ``wpw_t``), or in f32 its TF32 high and
    low parts (2, N, K) (``wpw_t_split``, :func:`tf32_split`).  Returns
    f32, or with ``skip_src`` (B, H, W, N) of ``zb``'s type a tensor of
    that type."""
    if zb.ndim != 4:
        raise ValueError(f"zb must be (B, H, W, K), got {tuple(zb.shape)}")
    if zb.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"zb must be bf16 or f32, got {zb.dtype}")
    f32 = zb.dtype == torch.float32
    k, n = zb.shape[-1], w_t.shape[-2] if w_t.ndim >= 2 else 0
    if k % 8 or n % 8:
        raise ValueError(f"channels must be multiples of 8, got {k}x{n}")
    _check("zb", zb, zb.dtype, zb.shape)
    m = zb.numel() // k
    _check("w_t", w_t, zb.dtype, ((2,) if f32 else ()) + (n, k))
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


def tf32_split_on_card(x):
    """The f32 product's own split of ``x`` (f32, on the card), by kernel
    ``mf_tf32_split``: ``(hi, lo)``, to hold against :func:`tf32_split`."""
    _check("x", x, torch.float32, x.shape)
    hi, lo = torch.empty_like(x), torch.empty_like(x)
    rc = _lib().mf_tf32_split(x.data_ptr(), hi.data_ptr(), lo.data_ptr(),
                              x.numel(), _stream(x))
    if rc:
        _raise("mf_tf32_split", rc)
    return hi, lo


def middle_flow_eval(x, folded, dilation: int = 1):
    """Fused eval-mode middle flow: (B, H, W, C) -> (B, H, W, C).

    ``folded`` comes from :func:`fold_middle_flow` at ``x``'s dtype.  A
    CPU tensor takes :func:`middle_flow_reference`; a CUDA tensor (bf16 or
    f32, C a multiple of 8) runs :func:`dw_stencil` then :func:`pw_gemm`
    (on ``wpw_t`` in bf16, ``wpw_t_split`` in f32) per separable conv in
    ``x``'s dtype, 96 launches for 16 blocks.  Other devices raise.  The
    host span ``mf.eval`` covers the call on either path.
    """
    with span("mf.eval"):
        if x.device.type == "cpu":
            return middle_flow_reference(x, folded, dilation)
        if not x.is_cuda:
            raise ValueError(
                f"middle_flow_eval runs on cpu or cuda, got {x.device}")
        key = "wpw_t_split" if x.dtype == torch.float32 else "wpw_t"
        if key not in folded:
            raise KeyError(f"folded lacks {key!r}, the K-major pointwise "
                           "weights the kernels read: fold with "
                           "fold_middle_flow")
        return _middle_flow(x.contiguous(), folded, dilation, dw_stencil,
                            pw_gemm, key)
