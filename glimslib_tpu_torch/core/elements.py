# Copy of glimslib_tpu/core/elements.py (numpy only). The code is kept byte for
# byte apart from imports, which point into glimslib_tpu_torch so that the
# port never imports the JAX package's core (its __init__ imports jax).
"""Finite elements on simplices: P1 and P2 Lagrange, with quadrature tables.

TPU-native replacement for UFL + FFC runtime code generation (SURVEY.md §2.2):
instead of JIT-compiling element kernels, the two element families the
reference uses — P1 (``fenics.FiniteElement("Lagrange", cell, 1)``,
simulation_tumor_growth.py:67-72) and P2 concentration (quad variants,
simulation_tumor_growth_quad.py:69) — are tabulated once as numpy arrays of
shape-function values/gradients at quadrature points, and the assembly ops
consume the tables inside vectorized JAX kernels.

Also provides exact closed-form simplex integrals of barycentric monomials,
used by the fast P1 path:  ∫_T Π λ_i^{a_i} dx = d! Π a_i! / (d+Σa_i)! · |T|.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np


# ---------------------------------------------------------------------------
# Quadrature on the reference simplex {xi_i >= 0, sum xi <= 1}
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def simplex_quadrature(dim: int, degree: int):
    """Quadrature points/weights on the unit simplex, exact to ``degree``.

    Returns (points (nq, dim), weights (nq,)); weights sum to the simplex
    volume 1/d!.  Rules: Grundmann-Moeller style collapsed Gauss product —
    simple, robust, works for any degree (not minimal-point, but assembly is
    precomputation-bound, not quadrature-bound).
    """
    # The collapsed-coordinate transform multiplies the integrand by the
    # Jacobian (1-u)^{dim-1} and scales coordinates by (1-u)/(1-v) factors,
    # raising the per-axis polynomial degree to at most degree+dim; choose
    # the 1D Gauss order to integrate that exactly.
    n1 = ((degree + dim) // 2) + 1
    x, w = np.polynomial.legendre.leggauss(n1)
    x = (x + 1.0) / 2.0  # map to [0,1]
    w = w / 2.0
    if dim == 1:
        return x[:, None], w
    if dim == 2:
        # Duffy transform: (u, v) in [0,1]^2 -> (xi1, xi2) = (u(1-v), u v) ... use
        # standard collapsed square: xi1 = u, xi2 = v(1-u); jacobian (1-u)
        U, V = np.meshgrid(x, x, indexing="ij")
        WU, WV = np.meshgrid(w, w, indexing="ij")
        xi1 = U
        xi2 = V * (1 - U)
        wq = WU * WV * (1 - U)
        return (
            np.stack([xi1.ravel(), xi2.ravel()], axis=1),
            wq.ravel(),
        )
    if dim == 3:
        U, V, W_ = np.meshgrid(x, x, x, indexing="ij")
        WU, WV, WW = np.meshgrid(w, w, w, indexing="ij")
        xi1 = U
        xi2 = V * (1 - U)
        xi3 = W_ * (1 - U) * (1 - V)
        wq = WU * WV * WW * (1 - U) ** 2 * (1 - V)
        return (
            np.stack([xi1.ravel(), xi2.ravel(), xi3.ravel()], axis=1),
            wq.ravel(),
        )
    raise ValueError(f"dim {dim} not supported")


def barycentric_integral(dim: int, powers) -> float:
    """∫ over the unit-volume simplex of Π λ_i^{a_i}, normalized so that the
    simplex volume is 1 (multiply by |T| for a physical cell):
    d! Π a_i! / (d + Σ a_i)!."""
    s = sum(powers)
    num = math.factorial(dim)
    for a in powers:
        num *= math.factorial(a)
    return num / math.factorial(dim + s)


@lru_cache(maxsize=None)
def p1_mass_matrix(dim: int) -> np.ndarray:
    """Exact P1 mass matrix on a unit-volume simplex:
    M_ij = (1 + δ_ij) / ((d+1)(d+2))."""
    n = dim + 1
    M = np.full((n, n), 1.0 / ((dim + 1) * (dim + 2)))
    M[np.diag_indices(n)] *= 2.0
    return M


@lru_cache(maxsize=None)
def p1_cubic_tensor(dim: int) -> np.ndarray:
    """Exact T_ijk = ∫ λ_i λ_j λ_k on a unit-volume simplex — used for the
    quadratic logistic term ρ c (1-c) v with P1 c (reference
    math_reaction_diffusion.py:2-3) without quadrature."""
    n = dim + 1
    T = np.zeros((n, n, n))
    for i in range(n):
        for j in range(n):
            for k in range(n):
                powers = [0] * n
                powers[i] += 1
                powers[j] += 1
                powers[k] += 1
                T[i, j, k] = barycentric_integral(dim, tuple(powers))
    return T


# ---------------------------------------------------------------------------
# Lagrange elements
# ---------------------------------------------------------------------------


class P1Element:
    """Linear Lagrange on a simplex: dofs at vertices."""

    degree = 1

    def __init__(self, dim: int):
        self.dim = dim
        self.n_dofs = dim + 1

    def tabulate(self, pts: np.ndarray):
        """Values (nq, n_dofs) and reference gradients (nq, n_dofs, dim)."""
        nq = pts.shape[0]
        lam0 = 1.0 - pts.sum(axis=1)
        vals = np.concatenate([lam0[:, None], pts], axis=1)
        grads = np.zeros((nq, self.n_dofs, self.dim))
        grads[:, 0, :] = -1.0
        for a in range(self.dim):
            grads[:, a + 1, a] = 1.0
        return vals, grads


class P2Element:
    """Quadratic Lagrange on a simplex: dofs at vertices + edge midpoints.

    Edge ordering follows :data:`glimslib_tpu.core.mesh.EDGE_VERTICES`.
    Basis: vertex i -> λ_i(2λ_i - 1); edge (a,b) -> 4 λ_a λ_b.
    """

    degree = 2

    def __init__(self, dim: int):
        from glimslib_tpu_torch.core.mesh import EDGE_VERTICES

        self.dim = dim
        self.edges = EDGE_VERTICES[dim]
        self.n_dofs = (dim + 1) + len(self.edges)

    def tabulate(self, pts: np.ndarray):
        nq = pts.shape[0]
        nv = self.dim + 1
        lam = np.concatenate([(1.0 - pts.sum(axis=1))[:, None], pts], axis=1)
        dlam = np.zeros((nv, self.dim))
        dlam[0, :] = -1.0
        for a in range(self.dim):
            dlam[a + 1, a] = 1.0

        vals = np.zeros((nq, self.n_dofs))
        grads = np.zeros((nq, self.n_dofs, self.dim))
        for i in range(nv):
            vals[:, i] = lam[:, i] * (2 * lam[:, i] - 1)
            grads[:, i, :] = (4 * lam[:, i] - 1)[:, None] * dlam[i]
        for e, (a, b) in enumerate(self.edges):
            vals[:, nv + e] = 4 * lam[:, a] * lam[:, b]
            grads[:, nv + e, :] = 4 * (
                lam[:, a][:, None] * dlam[b] + lam[:, b][:, None] * dlam[a]
            )
        return vals, grads


def element(family_degree: int, dim: int):
    if family_degree == 1:
        return P1Element(dim)
    if family_degree == 2:
        return P2Element(dim)
    raise ValueError(f"unsupported Lagrange degree {family_degree}")
