"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` into a shared library with a plain C
interface, at first use, into ``build/kernels/`` beside the package.  The
library's name carries a hash of the sources and flags, so an edited
source builds anew and a built one is reused.  It is loaded with
``ctypes``; pointers and the stream pass as ``c_void_p``.

Nothing here runs at import: ``load()`` is called by the kernel wrappers
when they are first given a CUDA tensor.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCES = (_PKG / "csrc" / "stencil.cu",)
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# what the last build printed (the ptxas register/shared-memory report);
# None when the library was already built
build_log = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: no nvcc to build the kernels")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libglims_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for their hash exists."""
    global build_log
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{build_log}"
        )
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare the C functions' signatures."""
    lib = ctypes.CDLL(str(build()))
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.glims_stencil_apply.argtypes = [i32, i32, vp, vp, vp, i32, vp, i32, vp]
    lib.glims_stencil_apply.restype = i32
    lib.glims_stencil_pcg.argtypes = [
        i32, vp, vp, vp, vp, vp, vp, vp, i32, vp, i32, f32, f32, i32, vp,
    ]
    lib.glims_stencil_pcg.restype = i32
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")


def offsets_array(offsets):
    """Host int32 array of stencil offsets for the C entry points."""
    return (ctypes.c_int * len(offsets))(*[int(o) for o in offsets])
