"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into a shared library of its own with
a plain C interface, at first use, into ``build/kernels/`` beside the
package; the ``nvcc`` processes of all sources start together.  A
library's name carries a hash of its source and the flags, so an edited
source builds anew and a built one is reused.  Libraries are loaded with
``ctypes``; pointers and the stream pass as ``c_void_p``.

Nothing here runs at import: ``load(name)`` is called by the kernel
wrappers when they are first given a CUDA tensor.  A failed build raises.
Processes that build at once (the ranks of a sharded run) take turns on
a lock file in the build directory, so each library is built once.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCES = {
    "stencil": _PKG / "csrc" / "stencil.cu",
    "bell": _PKG / "csrc" / "bell.cu",
}
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# what the last build of each source printed (the ptxas register and
# shared-memory report), by source name; empty when every library was
# already built
build_log: dict = {}


def _signatures():
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return {
        "stencil": {
            "glims_stencil_apply": [i32, i32, vp, vp, vp, i32, i32, vp, vp],
            "glims_stencil_apply_sum": [
                i32, vp, vp, f32, vp, vp, f32, vp, vp, f32, vp, vp, i32, i32, vp, vp,
            ],
            "glims_stencil_pcg": [
                i32, vp, vp, vp, vp, vp, vp, vp, i32, vp, f32, f32, i32,
                vp, i32, i32, i32, i32,
            ],
        },
        "bell": {
            "glims_bell_bmv": [
                vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32,
                i32, vp,
            ],
        },
    }


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: no nvcc to build the kernels")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(SOURCES[name].read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libglims_{name}_{h.hexdigest()[:16]}.so"


def build_all() -> None:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together, under an exclusive lock on
    ``build/kernels/.lock``; raise if any of them fails."""
    if all(library_path(name).exists() for name in SOURCES):
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        _build_missing()


def _build_missing() -> None:
    todo = [name for name in SOURCES if not library_path(name).exists()]
    if not todo:
        return
    nvcc = _nvcc()
    jobs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, tmp, cmd, proc))
    failed = []
    for name, tmp, cmd, proc in jobs:
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed (exit {proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build every missing library, load ``name``'s, and declare its C
    functions' signatures."""
    build_all()
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in _signatures()[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")


# the 3D Kuhn lattice's 15 offsets: csrc/stencil.cu GLIMS_MAX_OFF
MAX_OFF = 15


class Offsets(ctypes.Structure):
    """csrc/stencil.cu's ``Offsets``: the count, then the offsets mod n."""

    _fields_ = [("n", ctypes.c_int), ("v", ctypes.c_int * MAX_OFF)]


@functools.lru_cache(maxsize=64)
def _pack(offsets: tuple, n: int, halo: int):
    if not 1 <= len(offsets) <= MAX_OFF:
        raise ValueError(f"{len(offsets)} stencil offsets; the kernels take "
                         f"1 to {MAX_OFF}")
    if halo and max(abs(int(o)) for o in offsets) > halo:
        raise ValueError(f"stencil offsets {list(offsets)} reach past a halo of "
                         f"{halo} rows")
    vals = [int(o) + halo if halo else int(o) % n for o in offsets]
    pack = Offsets(len(offsets), (ctypes.c_int * MAX_OFF)(*vals))
    return pack, ctypes.addressof(pack)


def pack_offsets(offsets, n: int, halo: int = 0):
    """``(Offsets, its address)`` for the C entry points: the offsets taken
    mod ``n``, or (``halo`` > 0, stencil_apply's halo form) as ``halo +
    off``, which raises where an offset reaches past the halo; packed once
    per (offsets, n, halo) and cached by their values, so a changed
    sequence gets a pack of its own."""
    return _pack(tuple(offsets), n, int(halo))
