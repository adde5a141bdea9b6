"""Node block-ELL operator values (counterpart of the part of
``glimslib_tpu/ops/ell.py`` that the two-level coarse build reads).

The reference builds the frozen Galerkin coarse matrices of the
unstructured path from node-adjacency ELL values once per model
(``glimslib_tpu/models/base.py`` ``runtime_aux``): B (n, K, d, d) with
column ids ``adj`` (n, K), sentinel n.  The ELL matvecs (the
``GLIMS_BELL=0`` operator fallback) are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from glimslib_tpu_torch.ops.assembly import make_scatter_plan, pull_accumulate
from glimslib_tpu_torch.ops.bell import elasticity_entries, rd_const_entries


class EllPlan:
    """Host-precomputed node adjacency and entry -> slot plan of one mesh;
    ``adj`` is numpy, ``adj_idx`` and the pull table are int64 tensors on
    ``device``."""

    def __init__(self, mesh, device="cpu"):
        cells = np.asarray(mesh.cells, dtype=np.int64)
        nc, npe = cells.shape
        n = mesh.n_nodes
        self.n_nodes = n
        self.npe = npe
        # all (row, col) pairs in (i, j, cell) entry order
        rows = np.repeat(cells.T, npe, axis=0).reshape(npe, npe, nc)
        cols = np.tile(cells.T, (npe, 1)).reshape(npe, npe, nc)
        rflat = rows.ravel()
        cflat = cols.ravel()
        key = rflat * n + cflat
        uniq = np.unique(key)
        urow = uniq // n
        ucol = uniq % n
        starts = np.searchsorted(urow, np.arange(n))
        ends = np.searchsorted(urow, np.arange(n) + 1)
        K = int((ends - starts).max())
        self.K = K
        adj = np.full((n, K), n, dtype=np.int32)
        within = np.arange(len(uniq)) - starts[urow]
        adj[urow, within] = ucol
        self.adj = adj
        slot = np.searchsorted(uniq, key) - starts[rflat]
        self.value_plan = make_scatter_plan(rflat * K + slot, n * K)
        dev = torch.device(device)
        self.adj_idx = torch.as_tensor(adj.astype(np.int64), device=dev)
        self.value_idx = torch.as_tensor(
            self.value_plan.pull_table.astype(np.int64), device=dev)

    def assemble(self, entry_values):
        """(npe, npe, nc, ...) per-entry values -> (n, K, ...)."""
        tail = tuple(entry_values.shape[3:])
        flat = entry_values.reshape((-1,) + tail)
        vals = pull_accumulate(self.value_idx, self.n_nodes * self.K, flat)
        return vals.reshape((self.n_nodes, self.K) + tail)


def build_ell_elasticity(plan: EllPlan, mesh_arrays, mu, lam):
    """(n, K, d, d) elasticity stiffness values."""
    return plan.assemble(elasticity_entries(mesh_arrays, mu, lam))


def build_ell_rd_const(plan: EllPlan, mesh_arrays, D, rho, dt, m0):
    """(n, K) values of M + dt D K - dt rho M."""
    return plan.assemble(rd_const_entries(mesh_arrays, D, rho, dt, m0))
