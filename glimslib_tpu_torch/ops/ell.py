"""Node block-ELL operators (counterpart of ``glimslib_tpu/ops/ell.py``).

The operator lane of unstructured meshes under ``GLIMS_BELL=0``
(``models/base.py``): the elasticity operator and the rd Jacobian are
assembled into a node-adjacency ELL layout

    B (n, K, d, d)   with column ids  adj (n, K), sentinel n

and every CG matvec is one row gather of ``x`` at ``adj`` (the sentinel
row zero) and a multiply-sum.  The same values feed the two-level coarse
build on either lane (``models/base.py runtime_aux``).  The matvecs are
plain torch on every device: the reference computes them with XLA
gathers outside any Pallas kernel, so no TPU kernel stands behind them.
Every function is differentiable in its values and in ``x``.
"""

from __future__ import annotations

import numpy as np
import torch

from glimslib_tpu_torch.ops.assembly import make_scatter_plan, pull_accumulate, pull_index
from glimslib_tpu_torch.ops.bell import elasticity_entries, rd_const_entries, rd_wc_entries


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
        self.value_idx = pull_index(self.value_plan, dev)

    def assemble(self, entry_values):
        """(npe, npe, nc, ...) per-entry values -> (n, K, ...)."""
        tail = tuple(entry_values.shape[3:])
        flat = entry_values.reshape((-1,) + tail)
        vals = pull_accumulate(self.value_idx, flat)
        return vals.reshape((self.n_nodes, self.K) + tail)


def build_ell_elasticity(plan: EllPlan, mesh_arrays, mu, lam):
    """(n, K, d, d) elasticity stiffness values."""
    return plan.assemble(elasticity_entries(mesh_arrays, mu, lam))


def build_ell_rd_const(plan: EllPlan, mesh_arrays, D, rho, dt, m0):
    """(n, K) values of M + dt D K - dt rho M."""
    return plan.assemble(rd_const_entries(mesh_arrays, D, rho, dt, m0))


def build_ell_rd_wc(plan: EllPlan, mesh_arrays, cells_flat, c, rho, dt, t0, conc_max):
    """(n, K) values of the logistic Jacobian correction +2 dt rho W(c)/c_max,
    W(c)_ij = vol t0 (S + c_i + c_j + δij (S + 2 c_i))."""
    return plan.assemble(rd_wc_entries(mesh_arrays, cells_flat, c, rho, dt, t0,
                                       conc_max))


def _rows(adj_idx, x):
    """(n, K, ...) rows of x at the adjacency, the sentinel n a zero row."""
    n, K = adj_idx.shape
    xp = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return xp.index_select(0, adj_idx.reshape(-1)).reshape((n, K) + tuple(x.shape[1:]))


def apply_ell_vector(adj_idx, B, x):
    """y[i, a] = sum_k sum_b B[i, k, a, b] x[adj[i, k], b]; x (n, d)."""
    return (B * _rows(adj_idx, x)[:, :, None, :]).sum(dim=(1, 3))


def apply_ell_scalar(adj_idx, W, x):
    """y[i] = sum_k W[i, k] x[adj[i, k]]; x (n,)."""
    return (W * _rows(adj_idx, x)).sum(dim=1)
