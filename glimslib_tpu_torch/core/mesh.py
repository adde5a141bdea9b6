# Copy of glimslib_tpu/core/mesh.py (numpy only). The code is kept byte for
# byte apart from imports, which point into glimslib_tpu_torch so that the
# port never imports the JAX package's core (its __init__ imports jax).
"""Unstructured simplex mesh (host-side construction, device-resident arrays).

TPU-native replacement for DOLFIN's C++ mesh classes (reference layer 0,
SURVEY.md §2.2): the mesh is a flat pair of arrays ``points (n_nodes, dim)``
and ``cells (n_cells, dim+1)`` plus precomputed geometric factors that the
matrix-free assembly kernels consume directly from HBM:

- per-cell shape-function gradients (constant for P1 simplices),
- per-cell volumes,
- boundary facet lists with areas and outward normals,
- a sorted scatter plan so element->node accumulation runs as a
  ``segment_sum`` over sorted indices instead of random-access scatter-add.

Mesh construction and topology extraction run on host (numpy / the native
C++ meshops library); the result is an immutable bundle of device arrays.

Reference behaviours covered:
- ``fenics.RectangleMesh`` / ``BoxMesh`` constructors used by the 2D/3D test
  cases (e.g. test_case_simulation_tumor_growth_2D_uniform.py:35).
- Facet/boundary topology that DOLFIN computes internally and the reference
  samples via ``fenics.cells``/facet loops (helper_classes.py:431-501).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def _facets_of_cells(cells: np.ndarray) -> np.ndarray:
    """All facets of each cell.

    Returns array (n_cells, n_facets_per_cell, dim) of node indices, where a
    facet of a simplex is the set of nodes excluding one local vertex.
    Facet ``f`` of cell ``c`` is opposite local vertex ``f``.
    """
    npe = cells.shape[1]  # nodes per element = dim+1
    idx = [[j for j in range(npe) if j != i] for i in range(npe)]
    return cells[:, np.asarray(idx)]  # (n_cells, npe, npe-1)


def _simplex_volumes_and_grads(points: np.ndarray, cells: np.ndarray):
    """Closed-form P1 gradients and volumes for tri/tet meshes (vectorized).

    For cell with vertices x_0..x_d, the edge matrix J has rows
    x_{a+1}-x_0.  Shape-function gradients: grad(lambda_{a+1}) = row a of
    J^{-1}; grad(lambda_0) = -sum.  Volume = |det J| / d!.
    """
    import math

    dim = points.shape[1]
    X = points[cells]  # (nc, d+1, d)
    J = X[:, 1:, :] - X[:, :1, :]  # rows = edge vectors x_{a+1}-x_0
    detJ = np.linalg.det(J)
    vol = np.abs(detJ) / math.factorial(dim)
    Jinv = np.linalg.inv(J)  # (nc, d, d)
    # x = x0 + J^T xi  =>  grad_x(xi_a) = column a of J^{-1}
    grads_rest = np.swapaxes(Jinv, 1, 2)  # grads_rest[e, a, :] = Jinv[e, :, a]
    grad0 = -grads_rest.sum(axis=1, keepdims=True)  # grad(lambda_0) = -sum
    grads = np.concatenate([grad0, grads_rest], axis=1)  # (nc, d+1, d)
    return vol, grads


def _boundary_facets(cells: np.ndarray):
    """Extract boundary facets (facets belonging to exactly one cell).

    Returns (facet_nodes, facet_cell, facet_local) where facet_nodes is
    (n_bf, dim) node indices, facet_cell the owning cell index, facet_local
    the local facet id (opposite local vertex).
    """
    all_f = _facets_of_cells(cells)  # (nc, npe, npe-1)
    nc, npe, nfn = all_f.shape
    flat = all_f.reshape(-1, nfn)
    key = np.sort(flat, axis=1)
    order = np.lexsort(key.T[::-1])
    skey = key[order]
    # boundary facets appear exactly once
    same_as_prev = np.zeros(len(skey), dtype=bool)
    same_as_prev[1:] = (skey[1:] == skey[:-1]).all(axis=1)
    same_as_next = np.zeros(len(skey), dtype=bool)
    same_as_next[:-1] = same_as_prev[1:]
    unique_mask = ~(same_as_prev | same_as_next)
    bidx = order[unique_mask]
    facet_nodes = flat[bidx]
    facet_cell = bidx // npe
    facet_local = bidx % npe
    return facet_nodes, facet_cell, facet_local


def _facet_geometry(points, cells, facet_nodes, facet_cell):
    """Areas (lengths in 2D) and outward unit normals of boundary facets."""
    dim = points.shape[1]
    X = points[facet_nodes]  # (nf, dim, dim)  (dim nodes per facet)
    if dim == 1:
        area = np.ones(len(facet_nodes))
        normal = np.zeros((len(facet_nodes), 1))
    elif dim == 2:
        e = X[:, 1] - X[:, 0]
        area = np.linalg.norm(e, axis=1)
        normal = np.stack([e[:, 1], -e[:, 0]], axis=1)
        normal /= np.maximum(area, 1e-300)[:, None]
    else:
        e1 = X[:, 1] - X[:, 0]
        e2 = X[:, 2] - X[:, 0]
        cr = np.cross(e1, e2)
        nrm = np.linalg.norm(cr, axis=1)
        area = 0.5 * nrm
        normal = cr / np.maximum(nrm, 1e-300)[:, None]
    # orient outward: normal points away from the cell centroid
    centroids = points[cells[facet_cell]].mean(axis=1)
    fmid = X.mean(axis=1)
    flip = ((fmid - centroids) * normal).sum(axis=1) < 0
    normal[flip] *= -1
    return area, normal


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Immutable simplex mesh.

    Attributes (all numpy on host; use :meth:`device_arrays` for jnp copies):
      points        (n_nodes, dim) float64 vertex coordinates
      cells         (n_cells, dim+1) int32 connectivity
      cell_volumes  (n_cells,)
      cell_grads    (n_cells, dim+1, dim) P1 shape-function gradients
      boundary_facet_nodes   (n_bf, dim) node ids of each boundary facet
      boundary_facet_cell    (n_bf,) owning cell
      boundary_facet_area    (n_bf,)
      boundary_facet_normal  (n_bf, dim) outward unit normal
    """

    points: np.ndarray
    cells: np.ndarray
    cell_volumes: np.ndarray
    cell_grads: np.ndarray
    boundary_facet_nodes: np.ndarray
    boundary_facet_cell: np.ndarray
    boundary_facet_local: np.ndarray
    boundary_facet_area: np.ndarray
    boundary_facet_normal: np.ndarray
    # set by the structured constructors (rectangle_mesh/box_mesh): node
    # index = sum_a idx_a * lattice_strides[a]; enables the offset-stencil
    # operator fast path (ops/stencil.py)
    lattice_shape: Optional[tuple] = None
    lattice_strides: Optional[tuple] = None
    # lazily-populated cache for edges() (frozen dataclass: set via
    # object.__setattr__; excluded from equality/repr)
    _edges_cache: Optional[tuple] = dataclasses.field(
        default=None, compare=False, repr=False
    )

    # -- construction -------------------------------------------------------

    @staticmethod
    def from_arrays(points: np.ndarray, cells: np.ndarray,
                    lattice_shape=None, lattice_strides=None) -> "Mesh":
        points = np.ascontiguousarray(np.asarray(points, dtype=np.float64))
        cells = np.ascontiguousarray(np.asarray(cells, dtype=np.int32))
        assert points.ndim == 2 and cells.ndim == 2
        dim = points.shape[1]
        assert cells.shape[1] == dim + 1, (
            f"expected simplex cells with {dim + 1} nodes, got {cells.shape}"
        )
        vol, grads = _simplex_volumes_and_grads(points, cells)
        if (vol <= 0).any():
            n_bad = int((vol <= 0).sum())
            raise ValueError(f"mesh has {n_bad} degenerate (zero-volume) cells")
        fn, fc, fl = _boundary_facets(cells)
        fa, fnorm = _facet_geometry(points, cells, fn, fc)
        return Mesh(
            points=points,
            cells=cells,
            cell_volumes=vol,
            cell_grads=grads,
            boundary_facet_nodes=fn.astype(np.int32),
            boundary_facet_cell=fc.astype(np.int32),
            boundary_facet_local=fl.astype(np.int32),
            boundary_facet_area=fa,
            boundary_facet_normal=fnorm,
            lattice_shape=tuple(lattice_shape) if lattice_shape else None,
            lattice_strides=tuple(lattice_strides) if lattice_strides else None,
        )

    # -- properties ---------------------------------------------------------

    @property
    def dim(self) -> int:
        return self.points.shape[1]

    @property
    def n_nodes(self) -> int:
        return self.points.shape[0]

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    def geometry_dim(self) -> int:
        """Reference API: ``mesh.geometry().dim()``."""
        return self.dim

    @property
    def cell_midpoints(self) -> np.ndarray:
        return self.points[self.cells].mean(axis=1)

    @property
    def boundary_nodes(self) -> np.ndarray:
        return np.unique(self.boundary_facet_nodes.ravel())

    def hmin(self) -> float:
        """Minimum cell diameter (as DOLFIN ``mesh.hmin()``)."""
        X = self.points[self.cells]
        npe = X.shape[1]
        h = 0.0
        hmin = np.inf
        for i in range(npe):
            for j in range(i + 1, npe):
                d = np.linalg.norm(X[:, i] - X[:, j], axis=1)
                hmin = min(hmin, d.min())
                h = max(h, d.max())
        return float(hmin)

    # -- P2 support: global edge enumeration --------------------------------

    def edges(self):
        """Unique edges (n_edges, 2) sorted node pairs + per-cell edge ids.

        Returns (edge_nodes, cell_edges) where cell_edges (n_cells, n_edges_per_cell)
        indexes into edge_nodes.  Local edge ordering follows the convention:
        edge k connects the local vertex pair ``EDGE_VERTICES[dim][k]``.
        """
        if self._edges_cache is not None:
            return self._edges_cache
        ev = EDGE_VERTICES[self.dim]
        pairs = self.cells[:, np.asarray(ev)]  # (nc, ne, 2)
        keys = np.sort(pairs.reshape(-1, 2), axis=1)
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        cell_edges = inv.reshape(self.n_cells, len(ev)).astype(np.int32)
        out = (uniq.astype(np.int32), cell_edges)
        object.__setattr__(self, "_edges_cache", out)
        return out

    def edge_ids_for_pairs(self, pairs: np.ndarray) -> np.ndarray:
        """Map (m, 2) vertex-node pairs (either order) to global edge ids.

        Edge ids index into ``edges()[0]``; raises ``KeyError`` if a pair is
        not an edge of the mesh.  Used to locate P2 edge dofs on boundary
        facets (Dirichlet/von-Neumann over the quad concentration space,
        reference helper_classes.py:632-723).
        """
        edge_nodes, _ = self.edges()
        key = np.sort(np.asarray(pairs, dtype=np.int64), axis=1)
        packed = key[:, 0] * self.n_nodes + key[:, 1]
        en = edge_nodes.astype(np.int64)
        epacked = en[:, 0] * self.n_nodes + en[:, 1]  # sorted (np.unique)
        idx = np.searchsorted(epacked, packed)
        idx_c = np.clip(idx, 0, len(epacked) - 1)
        if (epacked[idx_c] != packed).any():
            raise KeyError("node pair(s) are not mesh edges")
        return idx_c.astype(np.int32)

    # -- transformations ----------------------------------------------------

    def reordered_rcm(self) -> "Mesh":
        """Reverse-Cuthill-McKee-reordered copy (nodes relabelled, cells
        sorted by first node).

        Clusters every cell's nodes in index space, so the matrix-free
        gather path touches banded memory regions: on the v5e, ``jnp.take``
        runs ~2.5-3x faster with banded indices than with random ones.  Use
        on unstructured (non-lattice) meshes before building a model; all
        fields/outputs are consistently in the new node order.  Lattice
        meshes should NOT be reordered (the offset-stencil fast path needs
        lattice node order).
        """
        from glimslib_tpu_torch.native.meshops import rcm_permutation

        perm = np.asarray(rcm_permutation(self.cells, self.n_nodes))
        order = np.argsort(perm)  # order[new] = old
        cells = perm[self.cells].astype(np.int32)
        cells = cells[np.argsort(cells.min(axis=1), kind="stable")]
        return Mesh.from_arrays(self.points[order], cells)

    def reordered_morton(self, bits: int = 10) -> "Mesh":
        """Morton (Z-order space-filling-curve) reordered copy.

        Contiguous node-index ranges become compact spatial blobs — the
        property the two-level aggregation preconditioner needs for its
        reshape-only coarse transfers (solvers/twolevel.py; measured 87 vs
        156 elasticity CG iterations against RCM slab aggregates at n=24).
        Gather throughput on the v5e is locality-flat at these sizes
        (tools/bench_ell_variants.py), so the ELL matvec does not regress
        relative to RCM order.  Use on unstructured meshes before building
        a model; lattice meshes keep lattice order.
        """
        p = np.asarray(self.points, np.float64)
        lo, hi = p.min(axis=0), p.max(axis=0)
        qv = ((p - lo) / np.maximum(hi - lo, 1e-30) * ((1 << bits) - 1)
              ).astype(np.uint64)
        d = p.shape[1]
        code = np.zeros(len(p), np.uint64)
        for b in range(bits):
            for a in range(d):
                code |= (
                    (qv[:, a] >> np.uint64(b)) & np.uint64(1)
                ) << np.uint64(b * d + a)
        order = np.argsort(code, kind="stable")  # order[new] = old
        perm = np.empty_like(order)
        perm[order] = np.arange(len(order))
        cells = perm[self.cells].astype(np.int32)
        cells = cells[np.argsort(cells.min(axis=1), kind="stable")]
        return Mesh.from_arrays(self.points[order], cells)

    def moved(self, displacement: np.ndarray) -> "Mesh":
        """Return a new mesh with vertices moved by ``displacement``
        (n_nodes, dim).  Replacement for ``fenics.ALE.move``
        (reference simulation_base.py:228-234) — functional, not in-place.
        """
        return Mesh.from_arrays(self.points + np.asarray(displacement), self.cells)


# local vertex pairs forming the edges of a simplex (FEniCS-like convention)
EDGE_VERTICES = {
    1: [(0, 1)],
    2: [(1, 2), (0, 2), (0, 1)],  # edge k opposite vertex k
    3: [(2, 3), (1, 3), (1, 2), (0, 3), (0, 2), (0, 1)],
}


# -- constructors (reference: fenics.RectangleMesh / BoxMesh) ----------------


def pad_mesh_nodes(mesh: Mesh, multiple: int) -> Mesh:
    """Pad the node array to a multiple of ``multiple`` with unused nodes.

    JAX/GSPMD shards an array axis only when its size divides the device
    count, so multi-chip node-sharded execution (parallel/gspmd.py — the
    replacement for the reference's ``mpirun -np N`` domain decomposition,
    README.md:142-183) needs ``n_nodes % n_devices == 0``.  The padding
    nodes are referenced by no cell; the simulation machinery already treats
    unused nodes as zero-Dirichlet dofs (Simulation._unused_node_mask) and
    the stencil planes carry exact zeros there, so results on the real nodes
    are bit-identical.  Cells, volumes, gradients, facets and the lattice
    tagging are shared with the original mesh (no recomputation).
    """
    n = mesh.n_nodes
    multiple = int(multiple)
    if n % multiple == 0:
        return mesh
    lattice_shape = mesh.lattice_shape
    lattice_strides = mesh.lattice_strides
    if lattice_shape is not None and n == int(np.prod(lattice_shape)):
        # Lattice mesh: pad the slowest-varying lattice axis (largest
        # stride) to a multiple of the device count.  Appending slabs there
        # keeps every existing node index unchanged AND keeps
        # n_nodes == prod(lattice_shape), so the stencil plane construction
        # (lattice-shaped slice adds, ops/stencil.py) reshapes cleanly to
        # the sharded flat node axis — GSPMD shards the construction too,
        # not just the final planes.
        a = int(np.argmax(lattice_strides))
        slab = n // lattice_shape[a]  # == lattice_strides[a] for dense packs
        new_len = -(-lattice_shape[a] // multiple) * multiple
        pad = (new_len - lattice_shape[a]) * slab
        lattice_shape = tuple(
            new_len if i == a else s for i, s in enumerate(lattice_shape)
        )
    else:
        pad = (-n) % multiple
        lattice_shape = None
        lattice_strides = None
    # place pad nodes at the last real point (coordinates are only read for
    # IV/BC evaluation, where pad values are discarded by the unused mask)
    extra = np.broadcast_to(mesh.points[-1], (pad, mesh.dim))
    points = np.concatenate([mesh.points, extra], axis=0)
    return dataclasses.replace(
        mesh,
        points=np.ascontiguousarray(points),
        lattice_shape=lattice_shape,
        lattice_strides=lattice_strides,
    )


def interval_mesh(a: float, b: float, n: int) -> Mesh:
    pts = np.linspace(a, b, n + 1)[:, None]
    cells = np.stack([np.arange(n), np.arange(1, n + 1)], axis=1)
    return Mesh.from_arrays(pts, cells)


def rectangle_mesh(
    p0, p1, nx: int, ny: int, diagonal: str = "right"
) -> Mesh:
    """Structured triangle mesh of [p0, p1], matching
    ``fenics.RectangleMesh(Point(p0), Point(p1), nx, ny, diagonal)``
    (used by e.g. test_case_simulation_tumor_growth_2D_uniform.py:35).

    Vertex index = iy*(nx+1) + ix (x fastest), like DOLFIN.
    """
    x0, y0 = p0
    x1, y1 = p1
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(ix, iy):
        return iy * (nx + 1) + ix

    # lattice declared slowest-axis-first (y, x) so strides are descending —
    # the convention the stencil lattice meta requires (vid = iy*(nx+1)+ix)
    lattice = (
        None if diagonal == "crossed" else (((ny + 1), (nx + 1)), (nx + 1, 1))
    )
    cells = []
    for iy in range(ny):
        for ix in range(nx):
            v00 = vid(ix, iy)
            v10 = vid(ix + 1, iy)
            v01 = vid(ix, iy + 1)
            v11 = vid(ix + 1, iy + 1)
            if diagonal == "right":
                cells.append((v00, v10, v11))
                cells.append((v00, v11, v01))
            elif diagonal == "left":
                cells.append((v00, v10, v01))
                cells.append((v10, v11, v01))
            elif diagonal == "crossed":
                # centre vertex appended later
                cells.append((v00, v10, v11, v01))  # placeholder quad
            else:
                raise ValueError(f"unknown diagonal {diagonal!r}")
    if diagonal == "crossed":
        quads = np.asarray(cells)
        nq = len(quads)
        centers = pts[quads].mean(axis=1)
        cidx = len(pts) + np.arange(nq)
        pts = np.concatenate([pts, centers], axis=0)
        tris = []
        for q in range(nq):
            v = quads[q]
            c = cidx[q]
            tris += [(v[0], v[1], c), (v[1], v[2], c), (v[2], v[3], c), (v[3], v[0], c)]
        cells = tris
    if lattice:
        return Mesh.from_arrays(pts, np.asarray(cells),
                                lattice_shape=lattice[0],
                                lattice_strides=lattice[1])
    return Mesh.from_arrays(pts, np.asarray(cells))


def box_mesh(p0, p1, nx: int, ny: int, nz: int) -> Mesh:
    """Structured tet mesh of a box: each hex is split into 6 tets
    (matching ``fenics.BoxMesh`` topology: Kuhn triangulation)."""
    x0, y0, z0 = p0
    x1, y1, z1 = p1
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    zs = np.linspace(z0, z1, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    # vertex index = ix*(ny+1)*(nz+1) + iy*(nz+1) + iz  (z fastest)
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    sy = nz + 1
    sx = (ny + 1) * (nz + 1)

    ix, iy, iz = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    v000 = (ix * sx + iy * sy + iz).ravel()
    v100 = v000 + sx
    v010 = v000 + sy
    v001 = v000 + 1
    v110 = v000 + sx + sy
    v101 = v000 + sx + 1
    v011 = v000 + sy + 1
    v111 = v000 + sx + sy + 1
    # Kuhn subdivision into 6 tets around the main diagonal v000-v111.
    # Voxel-major cell order (the 6 tets of a voxel are adjacent): a
    # contiguous slice of the cell axis then corresponds to a slab of the
    # node lattice, which lets GSPMD shard the stencil-plane construction
    # over devices (ops/stencil.py strided-group accumulation).
    tets = np.stack(
        [
            np.stack([v000, v100, v110, v111], axis=1),
            np.stack([v000, v110, v010, v111], axis=1),
            np.stack([v000, v010, v011, v111], axis=1),
            np.stack([v000, v011, v001, v111], axis=1),
            np.stack([v000, v001, v101, v111], axis=1),
            np.stack([v000, v101, v100, v111], axis=1),
        ],
        axis=1,
    ).reshape(-1, 4)
    return Mesh.from_arrays(
        pts, tets,
        lattice_shape=(nx + 1, ny + 1, nz + 1),
        lattice_strides=(sx, sy, 1),
    )


def mesh_from_image_lattice(
    origin, spacing, shape2d, flat_to_node: Optional[np.ndarray] = None
) -> Mesh:
    """Triangle mesh whose vertices are exactly the pixel centres of a 2D
    image — the reference's ``image2fct2D`` trick (data_io.py:31-63) where
    dof order equals pixel order, enabling zero-interpolation image<->field
    round trips."""
    ny, nx = shape2d  # rows (y), cols (x)
    x0, y0 = origin
    dx, dy = spacing
    m = rectangle_mesh(
        (x0, y0), (x0 + (nx - 1) * dx, y0 + (ny - 1) * dy), nx - 1, ny - 1
    )
    return m
