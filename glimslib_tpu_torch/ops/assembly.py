"""Matrix-free P1 element assembly in torch (counterpart of the
``P1Kernels`` members of ``glimslib_tpu/ops/assembly.py`` that the lattice
step reads).

Per-cell tensors keep the reference's cell-axis-last layout: cells
(npe, nc), gradients (npe, d, nc), element contributions (npe, nc).  Node
accumulation is ``index_add_`` over the npe-major entry order.  On the
TPU this was a pull-gather because TPU scatters are slow; here the
scatter is the plain formulation, and it runs once per simulate (or once
at set-up), never inside the solver loops.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from glimslib_tpu_torch.core.elements import p1_mass_matrix


class P1Kernels:
    """Per-mesh P1 kernels of the coupled Fisher-KPP + elasticity system.

    Coefficients (``D``, ``rho``, ``mu``, ``lam``, ``source``) are scalars
    (Python numbers or 0-d tensors) or per-cell tensors (nc,)."""

    def __init__(self, mesh, dtype=torch.float64, device="cpu"):
        self.dim = mesh.dim
        self.n_nodes = mesh.n_nodes
        self.n_cells = mesh.n_cells
        self.npe = mesh.dim + 1
        self.dtype = dtype
        self.device = torch.device(device)
        kw = dict(dtype=dtype, device=self.device)
        self.cells_T = torch.as_tensor(
            np.ascontiguousarray(mesh.cells.T), dtype=torch.int64,
            device=self.device,
        )  # (npe, nc)
        self.cells_flat = self.cells_T.reshape(-1)
        self.vol = torch.as_tensor(mesh.cell_volumes, **kw)  # (nc,)
        self.grads_T = torch.as_tensor(
            np.ascontiguousarray(np.moveaxis(mesh.cell_grads, 0, -1)), **kw
        )  # (npe, d, nc)
        self.mass_unit = torch.as_tensor(p1_mass_matrix(self.dim), **kw)
        self._m0 = 1.0 / ((self.dim + 1) * (self.dim + 2))
        self._t0 = math.factorial(self.dim) / math.factorial(self.dim + 3)

    def _cellco(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def _gather_T(self, c):
        """nodal (n,) -> (npe, nc)."""
        return c[self.cells_T]

    def _scatter_scalar(self, contrib):
        """(npe, nc) element contributions -> (n_nodes,)."""
        out = torch.zeros(self.n_nodes, dtype=contrib.dtype, device=self.device)
        return out.index_add_(0, self.cells_flat, contrib.reshape(-1))

    def _scatter_vector(self, contrib):
        """(npe, d, nc) element contributions -> (n_nodes, d)."""
        ent = torch.movedim(contrib, 1, -1).reshape(-1, self.dim)
        out = torch.zeros(
            (self.n_nodes, self.dim), dtype=contrib.dtype, device=self.device
        )
        return out.index_add_(0, self.cells_flat, ent)

    def _mass_apply(self, xe):
        return self._m0 * (xe.sum(dim=0) + xe)

    def _cubic_apply(self, ce):
        S = ce.sum(dim=0)
        Q = (ce * ce).sum(dim=0)
        return self._t0 * (S * S + Q + 2.0 * ce * (S + ce))

    def rd_residual(self, c, c_prev, D, rho, dt, source=0.0, conc_max=1.0):
        """Implicit-Euler Fisher-KPP residual (von Neumann terms excluded):
        R_i = ∫ c v + dt D ∇c·∇v - c_prev v - dt ρ c(1-c/c_max) v - dt s v."""
        g = self.grads_T
        v = self.vol
        D = self._cellco(D)
        rho = self._cellco(rho)
        source = self._cellco(source)
        ce = self._gather_T(c)
        cpe = self._gather_T(c_prev)
        m_diff = self._mass_apply(ce - cpe)
        grad_c = (ce[:, None, :] * g).sum(dim=0)  # (d, nc)
        k_term = (grad_c[None] * g).sum(dim=1)  # (npe, nc)
        contrib = v * (
            m_diff
            + (dt * D) * k_term
            - (dt * rho) * (self._mass_apply(ce) - self._cubic_apply(ce) / conc_max)
            - (dt * source / (self.dim + 1))
        )
        return self._scatter_scalar(contrib)

    def rd_mass_stiffness_diag(self, D, rho, dt):
        """Diagonal of (M + dt D K), the Jacobi preconditioner of the
        concentration block (rho unused, kept for interface parity)."""
        g = self.grads_T
        v = self.vol
        D = self._cellco(D)
        mdiag = torch.diagonal(self.mass_unit)[:, None] * v[None]
        kdiag = (dt * D) * v * (g * g).sum(dim=1)
        return self._scatter_scalar(mdiag + kdiag)

    def elasticity_diag(self, mu, lam):
        """Diagonal of the elasticity stiffness operator per (node, comp)."""
        g = self.grads_T
        v = self.vol
        mu = self._cellco(mu)
        lam = self._cellco(lam)
        g2 = (g * g).sum(dim=1)
        ga2 = g * g
        return self._scatter_vector(v * (mu * (g2[:, None, :] + ga2) + lam * ga2))

    def mass_residual(self, c):
        """Consistent mass action ∫ c v dx, (n,) -> (n,)."""
        return self._scatter_scalar(self.vol * self._mass_apply(self._gather_T(c)))

    def mass_vector_residual(self, u):
        """Vector consistent mass action, (n, d) -> (n, d)."""
        ue = u[self.cells_T]  # (npe, nc, d)
        contrib = self.vol[None, :, None] * self._m0 * (
            ue.sum(dim=0, keepdim=True) + ue
        )
        out = torch.zeros_like(u)
        return out.index_add_(0, self.cells_flat, contrib.reshape(-1, self.dim))

    def lumped_mass(self):
        """Row-sum lumped mass vector (n,)."""
        contrib = (self.vol / (self.dim + 1)).expand(self.npe, self.n_cells)
        return self._scatter_scalar(contrib)
