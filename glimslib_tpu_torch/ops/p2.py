"""Quadrature-based P2 (quadratic) concentration kernels in torch
(counterpart of ``glimslib_tpu/ops/p2.py``, ``p2_dof_layout`` and
``P2Kernels``).

The reference's quad model family uses degree-2 Lagrange concentration on
the same mesh (``simulation_tumor_growth_quad.py:69``).  These kernels
integrate with tabulated quadrature of degree 6, exact for the cubic
``c^2 v`` logistic term with P2 ``c``.

Dof layout: the shared numbering of :func:`p2_dof_layout` (interleaved
Morton order unless ``GLIMS_P2_INTERLEAVE=0``) over ``[vertex dofs
(n_nodes) | edge dofs (n_edges)]``; per-cell P2 connectivity ``rank[[cells | n_nodes +
cell_edges]]``.

Geometry is affine (P1 simplices), so physical basis gradients are
``ref_grad @ A_e`` with ``A_e[a, :] = grad(lambda_{a+1})`` from the P1
gradient table.  Every per-cell tensor keeps the cell axis last, and the
small npe / nq / d axes reduce as multiply-and-sum loops (never a matrix
product).  Accumulation into the dofs is one static pull
(``ops/assembly.py pull_accumulate``), so autograd differentiates every
kernel for the adjoint.  The TPU's gather tricks (duplicated width-2
rows, class-split pull plans) have no counterpart here.

``P2FacetKernels``: von Neumann fluxes of a P2 field, by quadrature on
the facets' trace element.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from glimslib_tpu_torch.core.elements import P1Element, P2Element, simplex_quadrature
from glimslib_tpu_torch.ops.assembly import make_scatter_plan, pull_accumulate, pull_index


def p2_dof_layout(mesh):
    """Shared P2 dof numbering for a mesh: ``(perm, rank, n_edges)``, a
    copy of the reference's (``p2.py:30-77``).

    ``perm[new_id] = canonical_id`` and ``rank[canonical_id] = new_id``,
    where canonical = ``[vertices | n_nodes + edges]``.  By default the
    dofs are numbered in Morton order over their coordinates (vertices at
    vertex positions, edge dofs at midpoints), so vertex and edge dofs
    that are spatial neighbours get nearby ids and the supernode halo-ELL
    plan of ``ops/p2_ell.py`` stays compact.  ``GLIMS_P2_INTERLEAVE=0``
    keeps the canonical order, as in the reference (every vertex-edge
    coupling then lies outside its supernode: the reference's flagship P2
    plan at s = 32 has Kh = 890 there, against 240 interleaved).

    Cached on the mesh object at the first call, the switch read then;
    every P2 consumer (P2Kernels, FunctionSpace projections, Dirichlet
    conditions) maps through this one layout, so a model built under
    another value of the switch needs a mesh of its own."""
    cached = getattr(mesh, "_p2_layout_cache", None)
    if cached is not None:
        return cached
    edge_nodes, _ = mesh.edges()
    n, ne = mesh.n_nodes, len(edge_nodes)
    if os.environ.get("GLIMS_P2_INTERLEAVE", "1") == "0":
        perm = np.arange(n + ne, dtype=np.int64)
        rank = perm
    else:
        pts = np.asarray(mesh.points, np.float64)
        coords = np.concatenate([pts, pts[edge_nodes].mean(axis=1)], axis=0)
        bits = 10
        lo, hi = coords.min(axis=0), coords.max(axis=0)
        qv = ((coords - lo) / np.maximum(hi - lo, 1e-30) * ((1 << bits) - 1)
              ).astype(np.uint64)
        d = coords.shape[1]
        code = np.zeros(len(coords), np.uint64)
        for b in range(bits):
            for a in range(d):
                code |= (
                    (qv[:, a] >> np.uint64(b)) & np.uint64(1)
                ) << np.uint64(b * d + a)
        perm = np.argsort(code, kind="stable").astype(np.int64)
        rank = np.empty_like(perm)
        rank[perm] = np.arange(len(perm))
    out = (perm, rank, ne)
    object.__setattr__(mesh, "_p2_layout_cache", out)
    return out


def p2_dof_coordinates(mesh):
    """(n_dofs, d) coordinates of the P2 dofs (vertices, then edge
    midpoints) in the order of :func:`p2_dof_layout`."""
    perm, _, _ = p2_dof_layout(mesh)
    pts = mesh.points
    return np.concatenate([pts, pts[mesh.edges()[0]].mean(axis=1)], axis=0)[perm]


class P2Kernels:
    """Matrix-free kernels for a scalar P2 field on a simplex mesh, in
    ``dtype`` on ``device``.  Coefficients (``D``, ``rho``, ``source``)
    are scalars or per-cell tensors (nc,)."""

    def __init__(self, mesh, dtype=torch.float64, device="cpu", quad_degree=6):
        self.dtype = dtype
        self.device = torch.device(device)
        self.dim = mesh.dim
        self.mesh = mesh
        self.n_nodes = mesh.n_nodes
        self.n_cells = mesh.n_cells
        kw = dict(dtype=dtype, device=self.device)

        edge_nodes, cell_edges = mesh.edges()
        self.n_edges = len(edge_nodes)
        self.n_dofs = mesh.n_nodes + self.n_edges
        perm, rank, _ = p2_dof_layout(mesh)
        self.dof_perm = perm
        self.dof_rank = rank
        self.vertex_ids = torch.as_tensor(rank[: mesh.n_nodes], device=self.device)
        cell_dofs = rank[np.concatenate(
            [mesh.cells, mesh.n_nodes + cell_edges], axis=1
        )].astype(np.int64)
        self.cell_dofs = cell_dofs  # (nc, npe) numpy, the plans' connectivity
        self.npe = cell_dofs.shape[1]
        self.cell_dofs_T = torch.as_tensor(
            np.ascontiguousarray(cell_dofs.T), device=self.device)  # (npe, nc)
        # the dof pull of (npe, nc) cell-last entries
        self._pull = pull_index(make_scatter_plan(cell_dofs.T, self.n_dofs),
                                self.device)

        qp, qw = simplex_quadrature(mesh.dim, quad_degree)
        vals, rgrads = P2Element(mesh.dim).tabulate(qp)
        self.qw = torch.as_tensor(qw, **kw)  # (nq,)
        self.vals = torch.as_tensor(vals, **kw)  # (nq, npe)
        self.rgrads = torch.as_tensor(rgrads, **kw)  # (nq, npe, d)
        self.detJ = torch.as_tensor(
            mesh.cell_volumes * math.factorial(mesh.dim), **kw)  # (nc,)
        # affine map A[e, a, :] = grad(lambda_{a+1}); cell last: A_T[a, d, nc]
        self.A_T = torch.as_tensor(np.ascontiguousarray(
            np.transpose(np.asarray(mesh.cell_grads[:, 1:, :]), (1, 2, 0))), **kw)

        self.dof_coords = p2_dof_coordinates(mesh)  # for IVs and targets

    def _co(self, x):
        """A scalar or per-cell coefficient as a (nc,)-broadcastable tensor."""
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    # -- basics --------------------------------------------------------------

    def gather(self, f):
        """(n_dofs,) -> (nc, npe) cell-dof values, cell-major."""
        return f[self.cell_dofs_T.T]

    def gather2(self, f, f2):
        """Two fields at once: -> (nc, npe, 2)."""
        return torch.stack([f, f2], dim=-1)[self.cell_dofs_T.T]

    def gather_T(self, f):
        """(n_dofs,) -> (npe, nc) cell-dof values, cell axis last."""
        return f[self.cell_dofs_T]

    def gather2_T(self, f, f2):
        """Two fields at once, cell axis last: -> (npe, nc, 2)."""
        return torch.stack([f, f2], dim=-1)[self.cell_dofs_T]

    def at_quad_T(self, feT):
        """(npe, nc) dof values -> (nq, nc) values at the quadrature points."""
        out = self.vals[:, 0, None] * feT[0][None, :]
        for i in range(1, self.npe):
            out = out + self.vals[:, i, None] * feT[i][None, :]
        return out

    def at_quad(self, fe):
        """(nc, npe) dof values -> (nc, nq) values at the quadrature points."""
        return (self.vals[None] * fe[:, None, :]).sum(dim=-1)

    def ref_grad_at_quad(self, fe):
        """(nc, npe) -> reference-space gradient (nc, nq, d)."""
        return (self.rgrads[None] * fe[:, None, :, None]).sum(dim=2)

    def phys_grad_at_quad(self, fe):
        """(nc, npe) -> physical gradient (nc, nq, d), through the affine
        map A[e, a, :] = grad(lambda_{a+1})."""
        rg = self.ref_grad_at_quad(fe)  # (nc, nq, a)
        A = self.A_T.permute(2, 0, 1)  # (nc, a, d)
        return (rg[..., :, None] * A[:, None, :, :]).sum(dim=-2)

    def _test_T(self, wq):
        """(nq, nc) weighted point values -> (npe, nc) Σ_q vals[q, i] wq[q]."""
        return torch.stack([(self.vals[:, i, None] * wq).sum(dim=0)
                            for i in range(self.npe)])

    def scatter_T(self, contrib_T):
        """(npe, nc) cell-last contributions -> (n_dofs,)."""
        return pull_accumulate(self._pull, contrib_T.reshape(-1))

    def _wdet(self):
        return self.qw[:, None] * self.detJ[None, :]  # (nq, nc)

    def _phys_grad(self, i):
        """(nq, d, nc) physical gradient of basis function i."""
        pg = self.rgrads[:, i, 0][:, None, None] * self.A_T[0][None]
        for a in range(1, self.dim):
            pg = pg + self.rgrads[:, i, a][:, None, None] * self.A_T[a][None]
        return pg

    # -- residuals -----------------------------------------------------------

    def rd_residual(self, c, c_prev, D, rho, dt, source=0.0, conc_max=1.0):
        """Implicit-Euler Fisher-KPP residual for P2 c, by quadrature
        (von Neumann terms excluded):
        R_i = ∫ (c - c_prev - dt ρ c (1 - c/c_max) - dt s) φ_i
              + dt D ∇c·∇φ_i dx."""
        npe, d = self.npe, self.dim
        ceT = self.gather_T(c)
        cpT = self.gather_T(c_prev)
        D, rho, source = self._co(D), self._co(rho), self._co(source)
        wdet = self._wdet()
        cq = self.at_quad_T(ceT)
        cpq = self.at_quad_T(cpT)
        point = (cq - cpq) - dt * rho * cq * (1.0 - cq / conc_max) - dt * source
        mass_T = self._test_T(wdet * point)
        # stiffness, cell last:
        #   rgq[q,a,nc] = Σ_i rgrads[q,i,a] ce[i,nc]     (ref-space grad)
        #   gc[q,d,nc]  = Σ_a rgq[q,a,nc] A_T[a,d,nc]    (physical grad)
        #   t[q,a,nc]   = Σ_d gc[q,d,nc] A_T[a,d,nc]
        #   stiff[i,nc] = Σ_{q,a} wdet[q,nc] rgrads[q,i,a] t[q,a,nc]
        rgq = self.rgrads[:, 0, :, None] * ceT[0][None, None, :]
        for i in range(1, npe):
            rgq = rgq + self.rgrads[:, i, :, None] * ceT[i][None, None, :]
        gc = rgq[:, 0, None, :] * self.A_T[0][None]
        for a in range(1, d):
            gc = gc + rgq[:, a, None, :] * self.A_T[a][None]
        t = gc[:, 0, None, :] * self.A_T[:, 0][None]
        for dd in range(1, d):
            t = t + gc[:, dd, None, :] * self.A_T[:, dd][None]
        wt = wdet[:, None, :] * t  # (nq, a, nc)
        stiff_T = torch.stack([
            (self.rgrads[:, i, :, None] * wt).sum(dim=(0, 1)) for i in range(npe)
        ])  # (npe, nc)
        return self.scatter_T(mass_T + (dt * D) * stiff_T)

    def rd_mass_stiffness_diag(self, D, rho, dt):
        """Jacobi diagonal of (M + dt D K), cell axis last (rho unused)."""
        D = self._co(D)
        wdet = self._wdet()
        kdiag_T = torch.stack([
            (wdet[:, None, :] * self._phys_grad(i) ** 2).sum(dim=(0, 1))
            for i in range(self.npe)])
        return self.scatter_T(self._mass_diag_T() + (dt * D) * kdiag_T)

    def mass_residual(self, c):
        """Consistent mass action ∫ c φ_i dx, (n_dofs,) -> (n_dofs,)."""
        cq = self.at_quad_T(self.gather_T(c))
        return self.scatter_T(self._test_T(self._wdet() * cq))

    def lumped_mass(self):
        """Row-sum lumped mass, floored at 1% of its mean magnitude (P2
        vertex row sums can be ~0)."""
        m = self.mass_residual(torch.ones(self.n_dofs, dtype=self.dtype,
                                          device=self.device))
        floor = m.abs().mean() * 1e-2
        return torch.where(m.abs() > floor, m.abs(), floor)

    def _mass_diag_T(self):
        """(npe, nc) ∫_e φ_i² dx."""
        wdet = self._wdet()
        return torch.stack([((self.vals[:, i] ** 2)[:, None] * wdet).sum(dim=0)
                            for i in range(self.npe)])

    def mass_diag(self):
        """Exact mass-matrix diagonal ∫ φ_i² dx, strictly positive: the
        Jacobi preconditioner of P2 mass solves."""
        return self.scatter_T(self._mass_diag_T())

    def cell_integral(self, c):
        """∫_e c dx per cell, (..., n_dofs) -> (..., nc): each cell's basis
        integrals against its gathered dofs (the growth-strain coupling's
        input; a batch: the analysis of many recorded steps in one pass)."""
        w = self._test_T(self._wdet())  # (npe, nc) ∫_e φ_i dx
        return (c[..., self.cell_dofs_T] * w).sum(dim=-2)

    def integrate(self, c):
        return self.cell_integral(c).sum()

    # -- projection (IVs / targets) ------------------------------------------

    def project_pointwise(self, fn_or_values):
        """Nodal interpolation at the P2 dof coordinates."""
        if callable(fn_or_values):
            return np.asarray(fn_or_values(self.dof_coords), dtype=np.float64)
        v = np.asarray(fn_or_values, dtype=np.float64)
        if v.shape == (self.n_dofs,):
            return v
        raise ValueError("expected callable or (n_dofs,) array")

    def project_rhs(self, fn_or_values, quad_degree=6):
        """Right side of the L2 projection, b_i = ∫ f φ_i dx by quadrature:
        ``fn_or_values`` is a callable of physical points (m, d) (numpy)
        or a (n_dofs,) coefficient vector (then b = M f)."""
        if not callable(fn_or_values):
            return self.mass_residual(self._co(fn_or_values))
        qp, qw = simplex_quadrature(self.dim, quad_degree)
        vals, _ = P2Element(self.dim).tabulate(qp)  # (nq, npe)
        p1v, _ = P1Element(self.dim).tabulate(qp)  # (nq, d+1)
        X = self.mesh.points[self.mesh.cells]  # (nc, d+1, dim)
        xq = np.matmul(p1v, X)  # (nc, nq, dim)
        fq = np.asarray(fn_or_values(xq.reshape(-1, self.dim)), dtype=np.float64)
        fq = fq.reshape(self.n_cells, len(qw))
        detJ = self.mesh.cell_volumes * math.factorial(self.dim)
        contrib = (detJ[:, None] * qw[None, :] * fq) @ vals  # (nc, npe)
        return self.scatter_T(self._co(np.ascontiguousarray(contrib.T)))

    def vertex_part(self, c):
        """A P2 coefficient vector's vertex dofs, in mesh-node order."""
        return c[self.vertex_ids]

    def edge_dof_ids(self, eids):
        """Dof ids of edge dofs given canonical edge indices."""
        return self.dof_rank[self.mesh.n_nodes + np.asarray(eids, np.int64)]

    def vertex_dof_ids(self, nids):
        """Dof ids of vertex dofs given mesh-node indices."""
        return self.dof_rank[np.asarray(nids, np.int64)]


class P2FacetKernels:
    """Surface-integral kernels of a scalar P2 field on exterior facets,
    ∫_Γ q φ_i ds by facet quadrature on the trace element (counterpart of
    ``glimslib_tpu/ops/p2.py P2FacetKernels``): the cell's P2 basis
    restricted to a facet is the P2 element of the (d-1)-simplex, its
    dofs the facet's vertices and edge midpoints, so the kernels tabulate
    ``P2Element(dim - 1)`` at a degree-4 facet rule.  In ``dtype`` on
    ``device``; the accumulation is one static pull."""

    def __init__(self, mesh, facet_idx, n_dofs, dtype=torch.float64, device="cpu"):
        from glimslib_tpu_torch.core.mesh import EDGE_VERTICES

        d = mesh.dim
        if d < 2:
            raise ValueError("P2 facet kernels need dim >= 2")
        self.dim = d
        self.dtype = dtype
        self.device = torch.device(device)
        kw = dict(dtype=dtype, device=self.device)
        fidx = np.asarray(facet_idx, dtype=np.int64)
        self.n_facets = len(fidx)
        fnodes = mesh.boundary_facet_nodes[fidx]  # (nf, d) vertex ids
        self.facet_area = torch.as_tensor(mesh.boundary_facet_area[fidx], **kw)
        # facet dofs in P2Element(d - 1)'s order: vertices, then edges
        fev = EDGE_VERTICES[d - 1]
        if self.n_facets:
            pairs = np.concatenate([fnodes[:, list(p)] for p in fev], axis=0)
            eids = mesh.edge_ids_for_pairs(pairs).reshape(len(fev), self.n_facets).T
        else:
            eids = np.zeros((0, len(fev)), dtype=np.int32)
        _, rank, _ = p2_dof_layout(mesh)
        facet_dofs = rank[np.concatenate([fnodes, mesh.n_nodes + eids], axis=1)
                          ].astype(np.int64)  # (nf, nfd), interleaved order
        self._pull = pull_index(make_scatter_plan(facet_dofs, n_dofs), self.device)
        qp, qw = simplex_quadrature(d - 1, 4)
        vals, _ = P2Element(d - 1).tabulate(qp)  # (nq, nfd)
        self.qw = torch.as_tensor(qw * math.factorial(d - 1), **kw)  # sums to 1
        self.vals = torch.as_tensor(vals, **kw)
        self.n_quad = len(qw)
        # physical quadrature points of the affine facets, (nf, nq, dim)
        p1v, _ = P1Element(d - 1).tabulate(qp)  # (nq, d)
        X = mesh.points[fnodes]  # (nf, d, dim)
        self.value_coords = torch.as_tensor(
            np.sum(p1v[None, :, :, None] * X[:, None, :, :], axis=2), **kw)

    def scalar_flux_residual(self, q):
        """∫_Γ q φ_i ds with q a constant, per facet (nf,) or per facet
        quadrature point (nf, nq); returns (n_dofs,)."""
        q = torch.as_tensor(q, dtype=self.dtype, device=self.device)
        if q.dim() <= 1:
            qq = (q[:, None] if q.dim() == 1 else q).expand(self.n_facets, self.n_quad)
        else:
            qq = q
        w = self.facet_area[:, None] * self.qw[None, :] * qq  # (nf, nq)
        contrib = (w[:, :, None] * self.vals[None]).sum(dim=1)  # (nf, nfd)
        return pull_accumulate(self._pull, contrib.reshape(-1))
