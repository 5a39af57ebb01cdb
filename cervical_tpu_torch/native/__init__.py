"""Native (C++) batch loader: threaded libjpeg/libpng decode + staging
resize — the port's counterpart of ``cervical_tpu/native``, built from its
own copy of ``loader.cc``.

The reference delegates image IO to torch DataLoader worker *processes*
(train.py:507-512); here a ctypes-loaded C++ library decodes whole batches
on a std::thread pool with the GIL released, writing directly into numpy
buffers.  This is host decoding: the batch then goes to the card as one
upload.

The library builds with ``g++`` at first use (never at import) into
``cervical_tpu_torch/_build/``, named by a hash of the source and the
flags like the CUDA libraries (``ops/_build.py``).  Each build writes a
temporary file and renames it into place, so processes that build at once
(test workers, trainers) each load a whole library.  It needs the libjpeg
and libpng headers and libraries; where the toolchain or a codec is
missing, :func:`available` is false, :func:`unavailable_reason` says why,
and ``data.voc.VOCSegDataset`` decodes with PIL.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from cervical_tpu_torch.ops import _build

SOURCE = Path(__file__).resolve().parent / "loader.cc"
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
LINK_FLAGS = ("-ljpeg", "-lpng", "-pthread")

_lock = threading.Lock()
_lib = None
_unavailable_reason: Optional[str] = None


def library_path() -> Path:
    return _build.library_path(SOURCE, GXX_FLAGS + LINK_FLAGS)


def build() -> Path:
    """Compile ``loader.cc`` into :func:`library_path` (if missing) through
    a temporary file and an atomic rename; raises with g++'s output."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    try:
        out = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE),
                              *LINK_FLAGS], capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {out.returncode}): "
                               f"{out.stderr.strip()}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def get_lib():
    """The loaded library (built first if missing), or None if it cannot
    be built or loaded."""
    global _lib, _unavailable_reason
    with _lock:
        if _lib is not None or _unavailable_reason is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
            lib.fill_batch.restype = ctypes.c_int
            lib.fill_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int,
            ]
            _lib = lib
        except Exception as e:  # toolchain- or codec-dependent
            _unavailable_reason = f"{type(e).__name__}: {e}"
        return _lib


def available() -> bool:
    return get_lib() is not None


def unavailable_reason() -> Optional[str]:
    """Why the library is missing (the build's or the loader's error), or
    None when it is available."""
    get_lib()
    return _unavailable_reason


def default_threads() -> int:
    """2 threads per core (decode overlaps file IO), capped at 8."""
    return max(2, min(8, (os.cpu_count() or 1) * 2))


def load_batch(jpg_paths: Sequence[str], png_paths: Optional[Sequence[str]],
               stage_hw, num_threads: Optional[int] = None,
               mask_cache: bool = True, planar: bool = False):
    """Decode a batch of (jpeg, png-mask) pairs into fresh numpy arrays.

    Returns (images (N, H, W, 3) uint8 — or (N, 3, H, W) with ``planar``,
    the layout ``ops/warp.augment_batch_kernels(planar=True)`` takes —
    labels (N, H, W) uint8, n_failures).  A failed slot is zeroed and
    counted.  ``png_paths=None`` skips masks (labels returned zeroed).
    ``mask_cache``: write/read uncompressed ``<png>.rawmask`` sidecars (PNG
    inflate dominates mask decode), so epochs after the first skip it;
    best-effort, a read-only dataset directory decodes the PNG every time.
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_unavailable_reason}")
    if num_threads is None:
        num_threads = default_threads()
    n = len(jpg_paths)
    h, w = stage_hw
    imgs = np.empty((n, 3, h, w) if planar else (n, h, w, 3), np.uint8)
    lbls = np.zeros((n, h, w), np.uint8)
    jarr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in jpg_paths])
    if png_paths is None:
        parr = ctypes.cast(None, ctypes.POINTER(ctypes.c_char_p))
    else:
        parr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in png_paths])
    failures = lib.fill_batch(
        jarr, parr, n,
        imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        lbls.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, num_threads, int(mask_cache), int(planar))
    return imgs, lbls, int(failures)
