"""Build the port's CUDA sources at first use and load them with ctypes.

``nvcc`` compiles every ``fastdepth_tpu_torch/csrc/*.cu`` for Hopper
(``sm_90a``), one process per source, all started together, and links
the objects into one shared library with a plain C interface under
``fastdepth_tpu_torch/_build/``.  No PyTorch header is included, so a
build takes seconds.  The library's file name carries a hash of the
sources, the headers they share (``csrc/*.cuh``) and the flags: an
edited source or header builds anew, an unchanged tree loads the library
already there.  The build writes a temporary file and renames it into
place, so a concurrent or interrupted build never leaves a half-written
library under the final name.

:func:`build_native` builds the host preprocessing library
(``csrc/preprocess.cpp``, loaded by ``data/native.py``) the same way with
``g++`` and the flags of the JAX package's ``csrc/Makefile``.

Nothing here runs at import time: the package imports on hosts without
``nvcc`` or a GPU, and only a kernel launch on a CUDA tensor builds.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*GENCODE, "-std=c++17", "-O3", "-Xptxas=-v", "-Xcompiler", "-fPIC")

# -ffp-contract=off: the PIL-exact blend (fd_blend_gray_u8) depends on
# separately rounded mul + add; a fused FMA lands 1 off at exact-integer
# blend results (Image.blend truncates the float32 intermediate).
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fPIC", "-shared", "-Wall")
NATIVE_SOURCE = os.path.join(CSRC_DIR, "preprocess.cpp")

_LIB: Optional[ctypes.CDLL] = None
_FUNCS: dict = {}


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


def headers() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path(files, flags=NVCC_FLAGS, stem="libfd_kernels") -> str:
    h = hashlib.sha256()
    for path in files:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def build_native() -> str:
    """Compile ``csrc/preprocess.cpp`` with ``g++`` (or ``$CXX``) unless a
    library of the same hash exists; returns its path.  Raises when no
    compiler is found or the compile fails."""
    out = library_path([NATIVE_SOURCE], CXX_FLAGS, stem="libfdpreproc")
    if os.path.exists(out):
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("cannot build the native preprocessing library: no g++ found")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, NATIVE_SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build(nvcc: Optional[str] = None) -> Tuple[str, str]:
    """Compile the sources unless a library of the same hash exists.
    Returns (library path, nvcc's stderr — the ``-Xptxas=-v`` register
    and shared-memory report; empty when nothing was built).  A failed
    build raises with nvcc's stderr."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    out = library_path(srcs + headers())
    if os.path.exists(out):
        return out, ""
    nvcc = nvcc or find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    objdir = tempfile.mkdtemp(dir=BUILD_DIR)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        objs = [os.path.join(objdir, os.path.basename(src) + ".o") for src in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", src, "-o", obj],
                                  stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(srcs, objs)]
        logs = [p.communicate()[1] for p in procs]
        failed = [(src, p.returncode, log) for src, p, log in zip(srcs, procs, logs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{os.path.basename(src)} (exit {rc}):\n{log}" for src, rc, log in failed))
        proc = subprocess.run([nvcc, *GENCODE, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to link (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, "".join(logs)


def function(name: str, argtypes) -> ctypes._CFuncPtr:
    """The library's C entry ``name``, which returns a CUDA error code,
    with its argument types set (pointers and the stream as ``c_void_p``:
    a ``c_int`` would cut them).  Built, loaded and looked up once per
    process."""
    fn = _FUNCS.get(name)
    if fn is None:
        fn = getattr(load(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[name] = fn
    return fn


def load() -> ctypes.CDLL:
    """The kernels' library, built if needed, loaded once per process."""
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(build()[0])
    return _LIB
