# Copy of glimslib_tpu/utils/interpolation.py (numpy and scipy only). The code
# is kept byte for byte apart from imports, which point into
# glimslib_tpu_torch so that the port never imports the JAX package.
"""Point location and P1 interpolation on unstructured tri/tet meshes.

Host-side replacement for DOLFIN's BoundingBoxTree point evaluation and
VTK's probe filter (reference vtk_utils.py:234-244, data_io.py:176-225):
locate query points in cells via a cKDTree over cell centroids (k-nearest
candidate cells, exact barycentric inside test), then evaluate P1 fields.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def _barycentric(points, cells, q, cand):
    """Barycentric coords of q[i] in candidate cell cand[i].

    Returns (lam (nq, d+1),)."""
    X = points[cells[cand]]  # (nq, d+1, d)
    d = points.shape[1]
    T = np.swapaxes(X[:, 1:, :] - X[:, :1, :], 1, 2)  # (nq, d, d) columns=edges
    rhs = q - X[:, 0, :]
    sol = np.linalg.solve(T, rhs[..., None])[..., 0]  # (nq, d)
    lam0 = 1.0 - sol.sum(axis=1)
    return np.concatenate([lam0[:, None], sol], axis=1)


class MeshLocator:
    def __init__(self, points, cells, n_candidates=12):
        self.points = points
        self.cells = cells
        self.centroids = points[cells].mean(axis=1)
        self.tree = cKDTree(self.centroids)
        self.k = min(n_candidates, len(cells))

    def locate(self, q, tol=1e-10):
        """For each query point, the containing cell (-1 if none) and its
        barycentric coordinates."""
        q = np.asarray(q, dtype=np.float64)
        nq = len(q)
        _, cand = self.tree.query(q, k=self.k)
        if self.k == 1:
            cand = cand[:, None]
        found = np.full(nq, -1, dtype=np.int64)
        lam_out = np.zeros((nq, self.cells.shape[1]))
        remaining = np.arange(nq)
        for j in range(cand.shape[1]):
            if len(remaining) == 0:
                break
            c = cand[remaining, j]
            lam = _barycentric(self.points, self.cells, q[remaining], c)
            ok = (lam >= -tol).all(axis=1)
            hit = remaining[ok]
            found[hit] = c[ok]
            lam_out[hit] = lam[ok]
            remaining = remaining[~ok]
        # fallback: nearest centroid cell with clipped barycentrics
        if len(remaining):
            c = cand[remaining, 0]
            lam = _barycentric(self.points, self.cells, q[remaining], c)
            lam_out[remaining] = lam
        self._last_outside = remaining
        return found, lam_out


def build_locator(points, cells):
    return MeshLocator(points, cells)


def sample_fields(locator, points, cells, nodal_values, q, tol=1e-10):
    """Evaluate a P1 nodal field at query points.

    Returns (values, inside_mask); outside points get nearest-cell
    extrapolation values (mask them as needed)."""
    cell_idx, lam = locator.locate(q, tol=tol)
    inside = cell_idx >= 0
    use = np.where(inside, cell_idx, 0)
    vals_per_cell = nodal_values[cells[use]]  # (nq, d+1, ...) or (nq, d+1)
    if nodal_values.ndim == 1:
        out = np.einsum("qi,qi->q", lam, vals_per_cell)
    else:
        out = np.einsum("qi,qic->qc", lam, vals_per_cell)
    return out, inside
