"""ctypes bindings for the port's native mesh-ops library, with numpy
fallbacks.

Copy of glimslib_tpu/native/meshops.py, kept byte for byte apart from
paths and imports: the port builds and loads its own library
(``meshops.cpp`` beside this file, ``make`` with g++) into the
repository's git-ignored ``build/native/``, once a process (``make``
rebuilds a library older than its source).  When the library cannot be
built every function falls back to the pure-numpy implementations (the
RCM to scipy's), so nothing hard-depends on the native build.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_OUT = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "native")
_LIB_PATH = os.path.join(_OUT, "libmeshops.so")
_lib: Optional[ctypes.CDLL] = None
_made = False


def build(force=False) -> bool:
    """Compile libmeshops.so with make, once a process (make rebuilds a
    library older than meshops.cpp); returns success."""
    global _made
    if _made and os.path.exists(_LIB_PATH) and not force:
        return True
    try:
        subprocess.run(["make", "-C", _HERE, f"OUT={_OUT}"] + (["-B"] if force else []),
                       check=True, capture_output=True, text=True)
        _made = True
        return os.path.exists(_LIB_PATH)
    except Exception as e:  # toolchain absent
        logger.warning("native meshops build failed: %s", e)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not build():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
    lib.meshops_facets.restype = ctypes.c_int64
    lib.meshops_facets.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64, i64p, i64p]
    lib.meshops_cell_adjacency.restype = ctypes.c_int64
    lib.meshops_cell_adjacency.argtypes = [
        i64p, ctypes.c_int64, ctypes.c_int64, i64p, i64p,
    ]
    lib.meshops_partition.restype = None
    lib.meshops_partition.argtypes = [
        i64p, i64p, ctypes.c_int64, ctypes.c_int64, i64p,
    ]
    lib.meshops_rcm.restype = None
    lib.meshops_rcm.argtypes = [
        i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i64p,
    ]
    lib.meshops_used_vertices.restype = None
    lib.meshops_used_vertices.argtypes = [
        i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, u8p,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# Wrapped operations (native first, numpy fallback)
# ---------------------------------------------------------------------------


def facets(cells: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Unique facets + adjacent cells: (facet_nodes (nf, npe-1),
    facet_cells (nf, 2) with -1 for exterior)."""
    cells = np.ascontiguousarray(cells, dtype=np.int64)
    n_cells, npe = cells.shape
    lib = _load()
    if lib is not None:
        maxf = n_cells * npe
        out_f = np.empty((maxf, npe - 1), dtype=np.int64)
        out_c = np.empty((maxf, 2), dtype=np.int64)
        nf = lib.meshops_facets(cells, n_cells, npe, out_f, out_c)
        return out_f[:nf].copy(), out_c[:nf].copy()
    from glimslib_tpu_torch.core.subdomains import _interior_facets

    fn, c0, c1 = _interior_facets(cells)
    return np.sort(fn, axis=1), np.stack([c0, c1], axis=1)


def cell_adjacency(cells: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """CSR cell adjacency (xadj, adj) via shared facets."""
    cells = np.ascontiguousarray(cells, dtype=np.int64)
    n_cells = len(cells)
    fn, fc = facets(cells)
    lib = _load()
    if lib is not None:
        fc_c = np.ascontiguousarray(fc, dtype=np.int64)
        xadj = np.empty(n_cells + 1, dtype=np.int64)
        n_int = int((fc[:, 1] >= 0).sum())
        adj = np.empty(2 * n_int, dtype=np.int64)
        lib.meshops_cell_adjacency(fc_c, len(fc), n_cells, xadj, adj)
        return xadj, adj
    # numpy fallback
    mask = fc[:, 1] >= 0
    a = fc[mask, 0]
    b = fc[mask, 1]
    rows = np.concatenate([a, b])
    cols = np.concatenate([b, a])
    order = np.argsort(rows, kind="stable")
    rows, cols = rows[order], cols[order]
    xadj = np.zeros(n_cells + 1, dtype=np.int64)
    np.add.at(xadj[1:], rows, 1)
    np.cumsum(xadj, out=xadj)
    return xadj, cols.astype(np.int64)


def partition_graph(cells: np.ndarray, n_parts: int) -> np.ndarray:
    """Greedy graph-growing cell partition (n_cells,) part ids."""
    xadj, adj = cell_adjacency(cells)
    n_cells = len(cells)
    lib = _load()
    if lib is not None:
        out = np.empty(n_cells, dtype=np.int64)
        lib.meshops_partition(
            np.ascontiguousarray(xadj), np.ascontiguousarray(adj),
            n_cells, n_parts, out,
        )
        return out
    # numpy fallback: BFS growing
    part = -np.ones(n_cells, dtype=np.int64)
    target = -(-n_cells // n_parts)
    seed = 0
    from collections import deque

    for p in range(n_parts):
        while seed < n_cells and part[seed] >= 0:
            seed += 1
        if seed >= n_cells:
            break
        count = 0
        q = deque([seed])
        while q and count < target:
            c = q.popleft()
            if part[c] >= 0:
                continue
            part[c] = p
            count += 1
            q.extend(int(x) for x in adj[xadj[c] : xadj[c + 1]] if part[x] < 0)
    part[part < 0] = n_parts - 1
    return part


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
