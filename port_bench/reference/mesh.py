"""The reference's own mesh of the box [0, L]^3: n^3 voxels, each split
into the six tetrahedra of its Kuhn (Freudenthal) triangulation, one for
each order in which a monotone lattice path from the voxel's corner
(0, 0, 0) to its corner (1, 1, 1) takes the three axes.

Every dof is named by its position on the doubled grid: a vertex (i, j, k)
by (2i, 2j, 2k), the midpoint of an edge by the sum of its vertices'
positions.  On this triangulation no two edges share a midpoint, so the
doubled-grid position is a dof's key, and the harness matches the port's
dofs to these by their coordinates alone.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

# local edges of a tetrahedron, in the reference's own order
EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def grid_key(ijk2, n):
    """The key of doubled-grid positions (m, 3) on a box of n voxels a side."""
    m = 2 * n + 1
    ijk2 = torch.as_tensor(ijk2, dtype=torch.int64)
    return (ijk2[:, 0] * m + ijk2[:, 1]) * m + ijk2[:, 2]


def keys_of_points(points, n, length):
    """Doubled-grid keys of coordinates (m, 3), with a check that each
    lies on the doubled grid."""
    x = torch.as_tensor(np.asarray(points, dtype=np.float64)) * (2 * n / length)
    ijk2 = torch.round(x)
    if float((x - ijk2).abs().max()) > 1e-6:
        raise ValueError("a point lies off the doubled grid of the box")
    return grid_key(ijk2.to(torch.int64), n)


class KuhnBox:
    """Vertices, tetrahedra, geometry and (``p2``) P2 dofs of the box,
    as torch tensors on ``device``."""

    def __init__(self, n, length=10.0, p2=False, device="cpu"):
        self.n, self.length, self.h = n, float(length), float(length) / n
        dev = torch.device(device)
        self.device = dev
        g = torch.arange(n + 1, device=dev)
        ijk = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
        self.vertex_ijk = ijk
        self.points = ijk.to(torch.float64) * self.h
        self.n_nodes = ijk.shape[0]

        def vid(i, j, k):
            return (i * (n + 1) + j) * (n + 1) + k

        v = torch.arange(n, device=dev)
        o = torch.stack(torch.meshgrid(v, v, v, indexing="ij"), -1).reshape(-1, 3)
        tets = []
        for order in itertools.permutations(range(3)):
            path = [o.clone()]
            for axis in order:
                nxt = path[-1].clone()
                nxt[:, axis] += 1
                path.append(nxt)
            tets.append(torch.stack([vid(p[:, 0], p[:, 1], p[:, 2]) for p in path], 1))
        self.cells = torch.cat(tets, 0)
        self.n_cells = self.cells.shape[0]

        X = self.points[self.cells]  # (nc, 4, 3)
        E = X[:, 1:] - X[:, :1]  # (nc, 3, 3): rows are edge vectors
        det = torch.linalg.det(E)
        self.vol = det.abs() / 6.0
        # gradients of the barycentric functions: rows of E^-T, lambda_0 the rest
        Ginv = torch.linalg.inv(E)  # columns map to barycentrics 1..3
        g123 = Ginv.transpose(1, 2)  # (nc, 3, 3): grad lambda_{1..3}
        self.grads = torch.cat([-g123.sum(1, keepdim=True), g123], 1)  # (nc, 4, 3)

        on_face = ((ijk == 0) | (ijk == n)).any(1)
        self.boundary_vertex = on_face
        self.cell_vertex_keys = grid_key(2 * ijk, n)
        if p2:
            self._p2_dofs()

    def _p2_dofs(self):
        """P2 dofs: keys of the 4 vertices and 6 edge midpoints of each
        cell, numbered by their sorted unique keys."""
        ijk2 = 2 * self.vertex_ijk[self.cells]  # (nc, 4, 3)
        mids = torch.stack([(ijk2[:, a] + ijk2[:, b]) // 2 for a, b in EDGES], 1)
        allpos = torch.cat([ijk2, mids], 1)  # (nc, 10, 3)
        keys = grid_key(allpos.reshape(-1, 3), self.n)
        uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
        self.dof_keys = uniq
        self.n_dofs2 = uniq.shape[0]
        self.cell_dofs2 = inv.reshape(self.n_cells, 10)
        m = 2 * self.n + 1
        pos = torch.stack([uniq // (m * m), (uniq // m) % m, uniq % m], 1)
        self.dof_points2 = pos.to(torch.float64) * (self.h / 2)
