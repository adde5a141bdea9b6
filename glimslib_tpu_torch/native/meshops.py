"""ctypes binding of the native Reverse Cuthill-McKee reordering, with its
scipy fallback.

Copy of ``rcm_permutation`` from glimslib_tpu/native/meshops.py, kept byte
for byte apart from paths: the port builds and loads its own library
(``meshops.cpp`` beside this file, ``make`` with g++) into the repository's
git-ignored ``build/native/``.  When the library cannot be built the scipy
fallback computes the permutation.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_OUT = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "native")
_LIB_PATH = os.path.join(_OUT, "libmeshops.so")
_lib: Optional[ctypes.CDLL] = None


def build(force=False) -> bool:
    """Compile libmeshops.so with make; returns success."""
    if os.path.exists(_LIB_PATH) and not force:
        return True
    try:
        subprocess.run(["make", "-C", _HERE, f"OUT={_OUT}"], check=True,
                       capture_output=True, text=True)
        return os.path.exists(_LIB_PATH)
    except Exception as e:  # toolchain absent
        logger.warning("native meshops build failed: %s", e)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and not build():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
    lib.meshops_rcm.restype = None
    lib.meshops_rcm.argtypes = [
        i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i64p,
    ]
    _lib = lib
    return lib


def rcm_permutation(cells: np.ndarray, n_nodes: int) -> np.ndarray:
    """Reverse Cuthill-McKee node permutation (old -> new index)."""
    cells = np.ascontiguousarray(cells, dtype=np.int64)
    n_cells, npe = cells.shape
    lib = _load()
    if lib is not None:
        out = np.empty(n_nodes, dtype=np.int64)
        lib.meshops_rcm(cells, n_cells, npe, n_nodes, out)
        return out
    # scipy fallback
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    rows = np.repeat(cells, npe, axis=1).ravel()
    cols = np.tile(cells, (1, npe)).ravel()
    A = sp.coo_matrix(
        (np.ones(len(rows), dtype=np.int8), (rows, cols)),
        shape=(n_nodes, n_nodes),
    ).tocsr()
    order = reverse_cuthill_mckee(A, symmetric_mode=True)
    perm = np.empty(n_nodes, dtype=np.int64)
    perm[order] = np.arange(n_nodes)
    return perm
