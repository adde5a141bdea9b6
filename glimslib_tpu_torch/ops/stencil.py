"""Assembled offset-stencil operators for lattice meshes (counterpart of
``glimslib_tpu/ops/stencil.py``).

On a lattice mesh every FEM matrix entry connects nodes at one of a fixed
small set of index offsets (15 on the 3D Kuhn lattice), so each Jacobian
is assembled once into dense per-offset weight planes

    W[o, i] = A[i, i + off_o]

and applying it is a streaming pass:

    (A v)[i] = sum_o W[o, i] * v[(i + off_o) mod n]      (torch.roll)

Wrapped reads are harmless: a node without a neighbour at offset o has
W[o, i] = 0 exactly.

The ``apply_*`` methods run the plain torch versions of the CUDA stencil
kernel (``ops/stencil_kernels.py``); the models call the kernel wrappers.
A symmetric operator can be kept folded, as its offset >= 0 planes
(``fold_sym``), and applied from them (``apply_scalar_sym``,
``apply_vector_sym``, ``block_jacobi_inverse_sym``), in plain torch as in
the JAX package; no path of either package calls them.

On a rank's node slab (``parallel/gspmd.py NodeSlab``) the operators are
built over the cells that touch an owned node, in node ids local to the
halo-padded slab, with the whole mesh's offsets: the planes hold the
owned rows only, (n_off, ..., n_own), and take halo-padded nodal fields.

Entry formulas (closed forms on the unit-volume simplex, vol-scaled):
    M_ij      = vol m0 (1 + delta_ij)
    K_ij      = vol g_i.g_j
    W(c)_ij   = vol t0 (S + c_i + c_j + delta_ij (S + 2 c_i)),  S = sum_k c_k
    J_cc      = M + dt D K - dt rho (M - 2 W(c)/c_max)
    A_uu[(ia),(jb)] = vol (mu (g_j[a] g_i[b] + delta_ab g_i.g_j)
                           + lam g_j[b] g_i[a])
"""

from __future__ import annotations

import math

import numpy as np
import torch

from glimslib_tpu_torch.ops import stencil_kernels


def apply_block_jacobi(Binv, r):
    """r (n, d) -> (n, d): per-node block solve with Binv (d, d, n)."""
    return (Binv.permute(2, 0, 1) * r[:, None, :]).sum(dim=2)


def stencil_offsets(cells):
    """The sorted offset set (node id differences within a cell, 0
    included) of a lattice mesh's cells (nc, npe)."""
    cells = np.asarray(cells, dtype=np.int64)
    return np.unique(cells[:, None, :] - cells[:, :, None]).astype(np.int64)


class StencilPlan:
    """Host-precomputed entry -> (node, offset slot) map of a lattice mesh.

    Planes are accumulated with one ``index_add_`` over the flat
    (node, slot) ids.  The reference places voxel blocks by static pads
    for GSPMD-sharded construction; that is structure of the TPU build, and
    the sums are the same.

    ``offsets`` and ``rows`` (a node slab): the offset set to use (the
    whole mesh's) and the node range [lo, hi) whose rows the planes hold;
    entries of other rows are dropped."""

    def __init__(self, mesh, device="cpu", offsets=None, rows=None):
        if mesh.lattice_strides is None:
            raise NotImplementedError(
                "offset-stencil operators need a lattice mesh "
                "(lattice_strides); a mesh without one takes the unstructured "
                "lane, the supernode halo-ELL operators of ops/bell.py"
            )
        self.mesh = mesh
        self.dim = mesh.dim
        self.npe = mesh.dim + 1
        lo, hi = (0, mesh.n_nodes) if rows is None else rows
        self.n_nodes = hi - lo
        cells = mesh.cells.astype(np.int64)  # (nc, npe)
        diffs = cells[:, None, :] - cells[:, :, None]  # (nc, i, j): col - row
        self.offsets = (stencil_offsets(cells) if offsets is None
                        else np.asarray(offsets, dtype=np.int64))  # sorted, has 0
        self.n_off = len(self.offsets)
        slot = np.searchsorted(self.offsets, diffs)
        if offsets is not None and not np.array_equal(
                self.offsets[np.minimum(slot, self.n_off - 1)], diffs):
            raise ValueError("a cell's offset is not in the given offset set")
        rows_ = np.broadcast_to(cells[:, :, None], diffs.shape) - lo
        self.n_segments = self.n_nodes * self.n_off
        # entries of rows outside [lo, hi) go to one dropped segment
        sid = np.where((rows_ >= 0) & (rows_ < self.n_nodes),
                       rows_ * self.n_off + slot, self.n_segments)  # (nc, i, j)
        self._dropped = bool((sid == self.n_segments).any())
        # entry order (i, j, nc), the layout of the build_* entry tensors
        self.sid_T = torch.as_tensor(
            np.ascontiguousarray(sid.transpose(1, 2, 0)).reshape(-1),
            device=torch.device(device),
        )

    def accumulate(self, entries_T):
        """entries (npe_i, npe_j, nc) -> W (n_off, n_nodes)."""
        w = torch.zeros(
            self.n_segments + self._dropped, dtype=entries_T.dtype,
            device=entries_T.device
        )
        w.index_add_(0, self.sid_T, entries_T.reshape(-1))
        return w[:self.n_segments].reshape(self.n_nodes, self.n_off).T.contiguous()


class StencilOperators:
    """Builds and applies the stencil-form Jacobians of the coupled system;
    on a rank's ``slab`` (``parallel/gspmd.py NodeSlab``) its owned rows
    (module docstring)."""

    def __init__(self, mesh, dtype=torch.float64, device="cpu", slab=None):
        self.dtype = dtype
        self.device = torch.device(device)
        if slab is not None:
            mesh = slab.local_mesh
            self.plan = StencilPlan(mesh, device=self.device, offsets=slab.offsets,
                                    rows=slab.own_rows)
        else:
            self.plan = StencilPlan(mesh, device=self.device)
        self.dim = mesh.dim
        self.npe = mesh.dim + 1
        self.n_nodes = self.plan.n_nodes
        kw = dict(dtype=dtype, device=self.device)
        self.vol = torch.as_tensor(mesh.cell_volumes, **kw)
        self.cells_T = torch.as_tensor(
            np.ascontiguousarray(mesh.cells.T), dtype=torch.int64,
            device=self.device,
        )
        self.grads_T = torch.as_tensor(
            np.ascontiguousarray(np.moveaxis(mesh.cell_grads, 0, -1)), **kw
        )  # (npe, d, nc)
        self._m0 = 1.0 / ((self.dim + 1) * (self.dim + 2))
        self._t0 = math.factorial(self.dim) / math.factorial(self.dim + 3)
        self.offsets = [int(o) for o in self.plan.offsets]
        self._eye = torch.eye(self.npe, **kw)
        # folded storage of a symmetric operator: its offset >= 0 planes
        # (A[i, i + o] = A[i + o, i]^T), the zero offset first
        self.sym_idx = np.asarray([i for i, o in enumerate(self.offsets) if o >= 0],
                                  dtype=np.int64)
        sym_offsets = [self.offsets[i] for i in self.sym_idx]
        assert sym_offsets[0] == 0
        self.pos_offsets = sym_offsets[1:]

    def _cell_coeff(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def _gather_ce(self, c):
        """Element-node values (npe, nc) of a nodal field."""
        return c[self.cells_T]

    def _gg(self):
        g = self.grads_T
        return (g[:, None, :, :] * g[None, :, :, :]).sum(dim=2)  # (i, j, nc)

    def _wc_entries(self, c):
        ce = self._gather_ce(c)
        S = ce.sum(dim=0)
        eye = self._eye
        return self._t0 * (
            S[None, None, :]
            + ce[:, None, :]
            + ce[None, :, :]
            + eye[:, :, None] * (S[None, None, :] + 2.0 * ce[:, None, :])
        ) * self.vol[None, None, :]

    # -- plane construction --------------------------------------------------

    def build_rd_jacobian(self, c, D, rho, dt, conc_max=1.0):
        """W (n_off, n) for J_cc = M + dt D K - dt rho (M - 2 W(c)/c_max)."""
        v = self.vol
        D = self._cell_coeff(D)
        rho = self._cell_coeff(rho)
        m = self._m0 * (1.0 + self._eye)[:, :, None] * v[None, None, :]
        k = self._gg() * v[None, None, :]
        wc = self._wc_entries(c)
        entries = m + (dt * D) * k - (dt * rho) * (m - 2.0 * wc / conc_max)
        return self.plan.accumulate(entries)

    def build_rd_jacobian_const(self, D, rho, dt):
        """Theta-only part of J_cc: M + dt D K - dt rho M."""
        v = self.vol
        D = self._cell_coeff(D)
        rho = self._cell_coeff(rho)
        m = self._m0 * (1.0 + self._eye)[:, :, None] * v[None, None, :]
        k = self._gg() * v[None, None, :]
        return self.plan.accumulate(m + (dt * D) * k - (dt * rho) * m)

    def build_mass_planes(self):
        """Consistent-mass planes M (n_off, n)."""
        m = self._m0 * (1.0 + self._eye)[:, :, None] * self.vol[None, None, :]
        return self.plan.accumulate(m)

    def build_rd_wc(self, c, rho, dt, conc_max=1.0):
        """State-dependent part of J_cc: (2 dt rho / c_max) W(c), rebuilt
        per Newton iteration."""
        rho = self._cell_coeff(rho)
        return self.plan.accumulate(
            (2.0 * dt * rho / conc_max) * self._wc_entries(c)
        )

    def build_elasticity(self, mu, lam):
        """W (n_off, d, d, n) for the elasticity stiffness operator."""
        d = self.dim
        v = self.vol
        g = self.grads_T
        mu = self._cell_coeff(mu)
        lam = self._cell_coeff(lam)
        gg = self._gg()
        planes = []
        for a in range(d):
            row = []
            for b in range(d):
                ent = v * (
                    mu * (g[None, :, a, :] * g[:, None, b, :]
                          + (1.0 if a == b else 0.0) * gg)
                    + lam * (g[None, :, b, :] * g[:, None, a, :])
                )
                row.append(self.plan.accumulate(ent))
            planes.append(torch.stack(row, dim=1))  # (n_off, d_b, n)
        return torch.stack(planes, dim=1)  # (n_off, d_a, d_b, n)

    def build_coupling_uc(self, mu, lam, coupling):
        """Planes C (n_off, d, n) of the growth-strain coupling in the
        elasticity residual: R_u = W_el*u + C_uc*c - load."""
        d = self.dim
        g = self.grads_T
        kfac = (
            self._cell_coeff(coupling)
            * (2.0 * self._cell_coeff(mu) + d * self._cell_coeff(lam))
            * self.vol
            / (d + 1)
        )
        planes = []
        for a in range(d):
            ent = (-kfac * g[:, a, :])[:, None, :].expand(
                self.npe, self.npe, g.shape[-1]
            )
            planes.append(self.plan.accumulate(ent))
        return torch.stack(planes, dim=1)  # (n_off, d, n)

    def block_jacobi_inverse(self, W, mask=None):
        """Per-node (d, d) diagonal-block inverse from the zero-offset plane;
        masked (Dirichlet) nodes use the identity block.  Returns (d, d, n)."""
        return self._block_inverse(W[self.offsets.index(0)], mask)

    def _block_inverse(self, B, mask):
        """Per-node inverses (d, d, n) of the diagonal blocks B (d, d, n),
        the identity at masked nodes."""
        if mask is not None:
            m = mask.any(dim=1)
            eye = torch.eye(self.dim, dtype=B.dtype, device=B.device)[:, :, None]
            B = torch.where(m[None, None, :], eye, B)
        Binv = torch.linalg.inv(torch.movedim(B, -1, 0))
        return torch.movedim(Binv, 0, -1).contiguous()

    def apply_block_jacobi(self, Binv, r):
        """r (n, d) -> (n, d): per-node block solve."""
        return apply_block_jacobi(Binv, r)

    def block_jacobi_inverse_sym(self, Ws, mask=None):
        """:meth:`block_jacobi_inverse` from folded planes (their first
        plane is the zero offset)."""
        return self._block_inverse(Ws[0], mask)

    # -- folded symmetric planes (plain torch) ---------------------------------

    def fold_sym(self, W):
        """The offset >= 0 planes of a symmetric operator (plane axis
        first), for the ``*_sym`` applies: the full-plane result from half
        the planes."""
        return W[torch.as_tensor(self.sym_idx, device=W.device)]

    def apply_scalar_sym(self, Ws, vvec):
        """Symmetric scalar matvec from folded planes: the +o plane serves
        both directions, A[i, i+o] v[i+o] and, rolled, A[i+o, i] v[i]."""
        acc = Ws[0] * vvec
        for k, off in enumerate(self.pos_offsets):
            w = Ws[k + 1]
            acc = acc + w * torch.roll(vvec, -off)
            acc = acc + torch.roll(w * vvec, off)
        return acc

    def apply_vector_sym(self, Ws, u):
        """Symmetric vector matvec from folded planes (n_sym, d, d, n): the
        reverse direction takes the transposed (a, b) block."""
        d = self.dim
        cols = []
        for a in range(d):
            acc = torch.zeros(u.shape[0], dtype=u.dtype, device=u.device)
            for b in range(d):
                acc = acc + Ws[0, a, b] * u[:, b]
            cols.append(acc)
        for k, off in enumerate(self.pos_offsets):
            W = Ws[k + 1]
            for a in range(d):
                fwd = torch.zeros(u.shape[0], dtype=u.dtype, device=u.device)
                rev = torch.zeros(u.shape[0], dtype=u.dtype, device=u.device)
                for b in range(d):
                    fwd = fwd + W[a, b] * torch.roll(u[:, b], -off)
                    rev = rev + W[b, a] * u[:, b]
                cols[a] = cols[a] + fwd + torch.roll(rev, off)
        return torch.stack(cols, dim=1)

    # -- plain applications (torch.roll; ops/stencil_kernels.py) -------------

    def apply_scalar(self, W, vvec):
        """(A v)[i] = sum_o W[o, i] v[i + off_o]."""
        return stencil_kernels.apply_scalar_plain(self.offsets, W, vvec)

    def apply_vector(self, W, u):
        """(A u)[i, a] = sum_o sum_b W[o, a, b, i] u[i + off_o, b]."""
        return stencil_kernels.apply_vector_plain(self.offsets, W, u)

    def apply_coupling(self, C, cvec):
        """(C c)[i, a] = sum_o C[o, a, i] c[i + off_o]; returns (n, d)."""
        return stencil_kernels.apply_coupling_plain(self.offsets, C, cvec)
