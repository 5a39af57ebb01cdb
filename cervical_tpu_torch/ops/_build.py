"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and compiles on its own
into a shared library under ``cervical_tpu_torch/_build/`` (git-ignored),
named by a hash of the source and the flags, so an edited source rebuilds
and an unchanged one is reused.  Nothing builds at import: the first call
of a kernel wrapper builds its library, and :func:`build` starts one
``nvcc`` per source, all at once, for callers that want every kernel up
front.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
KERNEL_SOURCES = (CSRC_DIR / "middle_flow.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[Path, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the default
    toolkit location; raises if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed (set CUDA_HOME)")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(Path(source).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(sources: Iterable[Path] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile every source whose library is missing, one ``nvcc`` each, all
    started together.  Returns ``{source name: nvcc/ptxas log}`` for the
    sources built now; raises with the compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
        procs[Path(src)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True), tmp, out)
    logs, failed = {}, []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[src.name] = log
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: concurrent builds race safely
        else:
            os.unlink(tmp)
            failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(source: Path) -> ctypes.CDLL:
    """The shared library of ``source``, built first if missing."""
    path = library_path(source)
    lib = _loaded.get(path)
    if lib is None:
        if not path.exists():
            build([source])
        lib = _loaded[path] = ctypes.CDLL(str(path))
    return lib
