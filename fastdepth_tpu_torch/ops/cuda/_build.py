"""Build the port's CUDA sources at first use and load them with ctypes.

``nvcc`` compiles every ``fastdepth_tpu_torch/csrc/*.cu`` for Hopper
(``sm_90a``) into one shared library with a plain C interface under
``fastdepth_tpu_torch/_build/``.  No PyTorch header is included, so a
build takes seconds.  The library's file name carries a hash of the
sources and the flags: an edited source builds anew, an unchanged one
loads the library already there.  The build writes a temporary file and
renames it into place, so a concurrent or interrupted build never leaves
a half-written library under the final name.

Nothing here runs at import time: the package imports on hosts without
``nvcc`` or a GPU, and only a kernel launch on a CUDA tensor builds.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import tempfile
from typing import Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIB: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """The CUDA toolkit's ``nvcc``, located as ``torch.utils.cpp_extension``
    locates it (``CUDA_HOME``, ``CUDA_PATH``, ``PATH``)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc is None or not os.path.isfile(nvcc):
        raise RuntimeError(
            "cannot build the CUDA kernels: no nvcc found (set CUDA_HOME to "
            "the CUDA toolkit)")
    return nvcc


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def library_path(srcs, flags=NVCC_FLAGS) -> str:
    h = hashlib.sha256()
    for path in srcs:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"libfd_kernels-{h.hexdigest()[:16]}.so")


def build(nvcc: Optional[str] = None) -> Tuple[str, str]:
    """Compile the sources unless a library of the same hash exists.
    Returns (library path, nvcc's stderr — the ``-Xptxas=-v`` register
    and shared-memory report; empty when nothing was built).  A failed
    build raises with nvcc's stderr."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    out = library_path(srcs)
    if os.path.exists(out):
        return out, ""
    nvcc = nvcc or find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *srcs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stderr


def load() -> ctypes.CDLL:
    """The kernels' library, built if needed, loaded once per process."""
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(build()[0])
    return _LIB
