"""Geometric multigrid preconditioning on lattice meshes (counterpart of
``glimslib_tpu/solvers/multigrid.py``).

Every level is another lattice over the same extents, the grid transfers
are axis-wise linear interpolation and its exact adjoint (reshapes,
slices and adds), and the level operators are the offset-stencil planes
of ``ops/stencil.py`` at each resolution.

- hierarchy: every lattice axis halved while the cell counts are even and
  at least 4 (a rediscretised ``box_mesh`` / ``rectangle_mesh``);
- coefficients: a per-cell coefficient is averaged over the fine cells in
  each coarse voxel (a host table, a torch mean: differentiable in the
  tissue parameters);
- smoother: the Chebyshev polynomial of ``solvers/cg.py`` over the
  (block-)Jacobi inner preconditioner on the upper spectrum
  [lmax/8, lmax], so the V(1,1) cycle with R = P^T is a symmetric
  positive preconditioner and plain CG stays valid;
- coarsest level: the exact dense inverse of the masked operator (its
  columns, then ``torch.linalg.inv``), or a degree-``coarse_degree``
  Chebyshev sweep above ``DENSE_COARSE_MAX_DOFS``;
- Dirichlet masks restricted by injection; level vectors keep masked dofs
  at exactly zero.

The level operators go through the stencil kernel's wrappers
(``ops/stencil_kernels.py apply_scalar`` / ``apply_vector``): on CUDA
tensors each apply launches ``stencil_apply<1,1>`` / ``<d,d>`` at that
level's offsets and node count, on CPU tensors it runs the plain version.
``plain=True`` takes the plain version on any device.  The kernel takes
float32 on the card.

The JAX package's tests measured the scalar block at ~10 CG iterations
against ~156 with Jacobi (stiffness-dominated, 16^3), and the elasticity
block at nu = 0.45 no better than block-Jacobi (coarse P1 spaces miss the
fine divergence-free modes).  No model is wired to it, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from glimslib_tpu_torch.config import resolve_device
from glimslib_tpu_torch.ops import stencil_kernels
from glimslib_tpu_torch.solvers.cg import estimate_lmax, make_chebyshev_precond

# -- grid transfers (axis-wise linear interpolation and its exact adjoint) ---


def _prolong_axis(a, axis):
    """Linear interpolation along one axis: size m -> 2m - 1."""
    a = torch.movedim(a, axis, 0)
    odd = 0.5 * (a[:-1] + a[1:])  # (m - 1, ...)
    # interleave [e0, o0, e1, o1, ..., e_{m-2}, o_{m-2}] + [e_{m-1}]
    body = torch.stack([a[:-1], odd], dim=1).reshape(
        (2 * (a.shape[0] - 1),) + tuple(a.shape[1:]))
    return torch.movedim(torch.cat([body, a[-1:]], dim=0), 0, axis)


def _restrict_axis(r, axis):
    """Exact adjoint of :func:`_prolong_axis`: size 2m - 1 -> m."""
    r = torch.movedim(r, axis, 0)
    even = r[0::2]  # (m, ...)
    half = 0.5 * r[1::2]  # (m - 1, ...)
    zero = torch.zeros_like(half[:1])
    out = even + torch.cat([zero, half], dim=0) + torch.cat([half, zero], dim=0)
    return torch.movedim(out, 0, axis)


def _to_flat(g, ndim, comp):
    n = 1
    for s in g.shape[:ndim]:
        n *= s
    return g.reshape((n,) + tuple(comp))


def prolong(xc, coarse_shape, ndim):
    """Coarse flat node field -> fine flat node field.  ``xc`` (n_coarse,)
    or (n_coarse, d); shapes in the lattice's descending-stride axis order
    (``Mesh.lattice_shape``)."""
    comp = xc.shape[1:]
    g = xc.reshape(tuple(coarse_shape) + tuple(comp))
    for ax in range(ndim):
        g = _prolong_axis(g, ax)
    return _to_flat(g, ndim, comp)


def restrict(rf, fine_shape, ndim):
    """Fine flat node field -> coarse flat node field (adjoint of prolong)."""
    comp = rf.shape[1:]
    g = rf.reshape(tuple(fine_shape) + tuple(comp))
    for ax in range(ndim):
        g = _restrict_axis(g, ax)
    return _to_flat(g, ndim, comp)


def inject_mask(mask, fine_shape, ndim):
    """Coarse mask by injection (every other node along each axis), of a
    numpy array or a tensor."""
    comp = mask.shape[1:]
    g = mask.reshape(tuple(fine_shape) + tuple(comp))
    g = g[tuple(slice(None, None, 2) for _ in range(ndim))]
    return _to_flat(g, ndim, comp)


# -- hierarchy ---------------------------------------------------------------


def _axis_cells(mesh):
    return tuple(s - 1 for s in mesh.lattice_shape)


def _coarsen_mesh(mesh):
    """Half-resolution lattice mesh over the same extents (or None)."""
    from glimslib_tpu_torch.core.mesh import box_mesh, rectangle_mesh

    cells = _axis_cells(mesh)
    if any(c % 2 for c in cells) or min(cells) < 4:
        return None
    p0 = mesh.points.min(axis=0)
    p1 = mesh.points.max(axis=0)
    if mesh.dim == 2:
        ny, nx = cells  # lattice axis order (y, x) on rectangles
        return rectangle_mesh(tuple(p0), tuple(p1), nx // 2, ny // 2)
    nx, ny, nz = cells
    return box_mesh(tuple(p0), tuple(p1), nx // 2, ny // 2, nz // 2)


def _cell_voxel_keys(mesh):
    """Voxel index of each cell, raveled over the voxel grid in lattice
    axis order, and the cells a lattice axis."""
    cells = np.asarray(_axis_cells(mesh))
    p0 = mesh.points.min(axis=0)
    p1 = mesh.points.max(axis=0)
    mids = mesh.cell_midpoints
    # the constructors' conventions: rectangle lattice (y, x), box (x, y, z)
    coord_axes = (1, 0) if mesh.dim == 2 else (0, 1, 2)
    vi = []
    for la, ca in enumerate(coord_axes):
        h = (p1[ca] - p0[ca]) / cells[la]
        vi.append(np.clip(np.floor((mids[:, ca] - p0[ca]) / h).astype(np.int64),
                          0, cells[la] - 1))
    key = vi[0]
    for la in range(1, mesh.dim):
        key = key * cells[la] + vi[la]
    return key, cells


def _coeff_restriction_table(fine_mesh, coarse_mesh):
    """((nc_coarse, K) int64 table of the fine cells inside each coarse
    cell's voxel, -1 padded; K)."""
    fine_key, fine_cells = _cell_voxel_keys(fine_mesh)
    coarse_key, coarse_cells = _cell_voxel_keys(coarse_mesh)
    d = fine_mesh.dim
    # unravel the fine key, halve, ravel over the coarse voxel grid
    idxs = []
    rem = fine_key
    for la in reversed(range(d)):
        idxs.append(rem % fine_cells[la])
        rem = rem // fine_cells[la]
    idxs = idxs[::-1]
    ck = idxs[0] // 2
    for la in range(1, d):
        ck = ck * coarse_cells[la] + idxs[la] // 2
    order = np.argsort(ck, kind="stable")
    sorted_ck = ck[order]
    ncv = int(np.prod(coarse_cells))
    starts = np.searchsorted(sorted_ck, np.arange(ncv))
    ends = np.searchsorted(sorted_ck, np.arange(ncv) + 1)
    K = int((ends - starts).max()) if ncv else 0
    table = np.full((ncv, K), -1, dtype=np.int64)
    for v in range(ncv):
        ch = order[starts[v]:ends[v]]
        table[v, :len(ch)] = ch
    return table[coarse_key], K


def restrict_cell_coeff(coeff, table):
    """Mean of a per-cell coefficient over each coarse cell's children
    (differentiable); a scalar coefficient passes through."""
    if not torch.is_tensor(coeff) or coeff.dim() == 0:
        return coeff
    t = torch.as_tensor(np.maximum(table, 0), device=coeff.device)
    valid = torch.as_tensor(table >= 0, dtype=coeff.dtype, device=coeff.device)
    vals = coeff[t] * valid
    cnt = torch.clamp(valid.sum(dim=1), min=1.0)
    return vals.sum(dim=1) / cnt


class LatticeHierarchy:
    """The multigrid hierarchy of a lattice mesh: the level meshes, the
    coefficient restriction tables, one ``StencilOperators`` a level on
    ``device`` (default: the card)."""

    def __init__(self, mesh, dtype, max_levels=10, device=None):
        from glimslib_tpu_torch.ops.stencil import StencilOperators

        self.dtype = dtype
        self.device = resolve_device(device)
        self.meshes = [mesh]
        self.tables = []  # coefficient restriction a level pair
        m = mesh
        while len(self.meshes) < max_levels:
            c = _coarsen_mesh(m)
            if c is None:
                break
            table, _ = _coeff_restriction_table(m, c)
            self.meshes.append(c)
            self.tables.append(table)
            m = c
        self.n_levels = len(self.meshes)
        self.ops = [StencilOperators(mm, dtype=dtype, device=self.device)
                    for mm in self.meshes]
        self.shapes = [mm.lattice_shape for mm in self.meshes]
        self.ndim = mesh.dim

    @property
    def usable(self):
        return self.n_levels >= 2


class _MGBase:
    """The V(1,1) cycle: per-level Dirichlet masks by injection, Chebyshev
    smoothing on the upper spectrum, exact-adjoint transfers.  Subclasses
    give the level operator, the inner preconditioner and the per-level
    data (``build``).  ``plain``: every level apply takes the plain torch
    version of the stencil kernel, on any device."""

    # the dense coarse solve up to this many dofs (Cinv is n_dofs^2)
    DENSE_COARSE_MAX_DOFS = 2048

    def __init__(self, hierarchy: LatticeHierarchy, mask, smooth_degree=3,
                 coarse_degree=40, smooth_lmin_factor=0.125, plain=False):
        self.h = hierarchy
        self.smooth_degree = smooth_degree
        self.coarse_degree = coarse_degree
        self.smooth_lmin_factor = smooth_lmin_factor
        self.plain = plain
        m = torch.as_tensor(mask, dtype=torch.bool, device=hierarchy.device)
        self.masks = [m]
        for lv in range(1, hierarchy.n_levels):
            m = inject_mask(m, hierarchy.shapes[lv - 1], hierarchy.ndim)
            self.masks.append(m.contiguous())

    def _apply_op(self, lv, data_lv, v):
        raise NotImplementedError

    def _apply_inner(self, lv, data_lv, r):
        raise NotImplementedError

    def _dense_coarse_inverse(self, lv, data_lv, shape):
        """Exact inverse of the masked coarsest-level operator from its
        columns (masked dofs are identity rows of the masked operator)."""
        n_dofs = 1
        for s in shape:
            n_dofs *= s
        A = self._masked_op(lv, data_lv)
        eye = torch.eye(n_dofs, dtype=self.h.dtype, device=self.h.device)
        cols = torch.stack([A(eye[k].reshape(shape)).reshape(-1) for k in range(n_dofs)])
        return torch.linalg.inv(cols.T)

    def _masked_op(self, lv, data_lv):
        mask = self.masks[lv]

        def A(v):
            return torch.where(mask, v, self._apply_op(lv, data_lv,
                                                       torch.where(mask, 0.0, v)))

        return A

    def _masked_inner(self, lv, data_lv):
        mask = self.masks[lv]

        def M(r):
            return torch.where(mask, r, self._apply_inner(lv, data_lv,
                                                          torch.where(mask, 0.0, r)))

        return M

    def _coarse_or_lmax(self, lv, d, shape):
        """The coarsest level's dense inverse ``Cinv`` where it is small
        enough, else the level's ``lmax``."""
        n_dofs = 1
        for s in shape:
            n_dofs *= s
        if lv == self.h.n_levels - 1 and n_dofs <= self.DENSE_COARSE_MAX_DOFS:
            d["Cinv"] = self._dense_coarse_inverse(lv, d, shape)
        else:
            d["lmax"] = estimate_lmax(self._masked_op(lv, d), self._masked_inner(lv, d),
                                      shape, self.h.dtype, device=self.h.device)
        return d

    # -- application ---------------------------------------------------------

    def apply(self, data, r):
        """V-cycle approximate solve on the finest level."""
        return self._cycle(0, data, r)

    def _cycle(self, lv, data, r):
        h = self.h
        A = self._masked_op(lv, data[lv])
        M_in = self._masked_inner(lv, data[lv])
        if lv == h.n_levels - 1:
            if "Cinv" in data[lv]:
                return (data[lv]["Cinv"] @ r.reshape(-1)).reshape(r.shape)
            return make_chebyshev_precond(A, M_in, data[lv]["lmax"],
                                          self.coarse_degree)(r)
        # smooth the upper spectrum only: a wide interval at low degree
        # smooths nothing and stalls the cycle
        S = make_chebyshev_precond(A, M_in, data[lv]["lmax"], self.smooth_degree,
                                   lmin_factor=self.smooth_lmin_factor)
        x = S(r)
        rc = restrict(r - A(x), h.shapes[lv], h.ndim)
        rc = torch.where(self.masks[lv + 1], 0.0, rc)
        xc = self._cycle(lv + 1, data, rc)
        corr = prolong(xc, h.shapes[lv + 1], h.ndim)
        x = x + torch.where(self.masks[lv], 0.0, corr)
        return x + S(r - A(x))


class MGElasticity(_MGBase):
    """V(1,1)-cycle preconditioner for the vector elasticity block."""

    def build(self, mu, lam):
        """Per-level data: planes ``W``, block-Jacobi ``Binv``, and
        ``Cinv`` or ``lmax``."""
        h = self.h
        data = []
        mu_l, lam_l = mu, lam
        for lv in range(h.n_levels):
            if lv > 0:
                mu_l = restrict_cell_coeff(mu_l, h.tables[lv - 1])
                lam_l = restrict_cell_coeff(lam_l, h.tables[lv - 1])
            ops = h.ops[lv]
            W = ops.build_elasticity(mu_l, lam_l)
            d = {"W": W, "Binv": ops.block_jacobi_inverse(W, mask=self.masks[lv])}
            data.append(self._coarse_or_lmax(lv, d, (h.meshes[lv].n_nodes, h.ndim)))
        return tuple(data)

    def _apply_op(self, lv, data_lv, v):
        offs, W = self.h.ops[lv].offsets, data_lv["W"]
        if self.plain:
            return stencil_kernels.apply_vector_plain(offs, W, v)
        return stencil_kernels.apply_vector(offs, W, v)

    def _apply_inner(self, lv, data_lv, r):
        return self.h.ops[lv].apply_block_jacobi(data_lv["Binv"], r)


class MGScalar(_MGBase):
    """V(1,1)-cycle preconditioner for the scalar concentration block."""

    def build(self, D, rho, dt, conc_max=1.0):
        """Per-level planes of the constant part of the rd Jacobian,
        M + dt D K - dt rho M (the logistic correction is left to the
        fine-level smoother), the Jacobi diagonal ``diag``, and ``Cinv``
        or ``lmax``."""
        h = self.h
        data = []
        D_l, rho_l = D, rho
        for lv in range(h.n_levels):
            if lv > 0:
                D_l = restrict_cell_coeff(D_l, h.tables[lv - 1])
                rho_l = restrict_cell_coeff(rho_l, h.tables[lv - 1])
            ops = h.ops[lv]
            W = ops.build_rd_jacobian_const(D_l, rho_l, dt)
            diag = W[ops.offsets.index(0)]
            diag = torch.where(self.masks[lv], 1.0,
                               torch.where(diag > 0, diag, torch.ones_like(diag)))
            data.append(self._coarse_or_lmax(lv, {"W": W, "diag": diag},
                                             (h.meshes[lv].n_nodes,)))
        return tuple(data)

    def _apply_op(self, lv, data_lv, v):
        offs, W = self.h.ops[lv].offsets, data_lv["W"]
        if self.plain:
            return stencil_kernels.apply_scalar_plain(offs, W, v)
        return stencil_kernels.apply_scalar(offs, W, v)

    def _apply_inner(self, lv, data_lv, r):
        return r / data_lv["diag"]
