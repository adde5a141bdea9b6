"""P1 function spaces and initial values (counterpart of
``glimslib_tpu/core/functionspace.py``, P1 subspaces only).

A mixed P1-vector x P1-scalar space is a pair of nodal arrays,
displacement (n_nodes, d) and concentration (n_nodes,).  Initial values
are projected as in the reference: an L2 projection with the quadrature
right-hand side in numpy and a mass-matrix CG solve in torch, float64 on
the CPU (set-up, run once per model).  P2 subspaces raise
``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from glimslib_tpu_torch.core.elements import P1Element, simplex_quadrature


class SubSpace:
    """One subspace of a mixed space (e.g. displacement or concentration)."""

    def __init__(self, name: str, rank: int, degree: int, n_dofs: int, dim: int):
        self.name = name
        self.rank = rank  # 0 scalar, 1 vector
        self.degree = degree
        self.n_dofs = n_dofs
        self.dim = dim

    @property
    def value_size(self) -> int:
        return self.dim if self.rank == 1 else 1

    @property
    def shape(self):
        return (self.n_dofs, self.dim) if self.rank == 1 else (self.n_dofs,)


class SubSpaces:
    """Registry of subspaces."""

    def __init__(self, n: int):
        self.n = n
        self._subspaces: Dict[int, SubSpace] = {}
        self.names: Dict[int, str] = {}

    def set_subspace(self, subspace_id: int, subspace: SubSpace):
        self._subspaces[subspace_id] = subspace
        self.names[subspace_id] = subspace.name

    def get_subspace(self, subspace_id: int) -> SubSpace:
        return self._subspaces[subspace_id]


class FunctionSpace:
    """Mixed P1 function space over a Mesh; ``element_spec`` lists
    ``(rank, degree)`` per subspace."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.subspaces: Optional[SubSpaces] = None
        self._kernels_cache = None

    def init_function_space(self, element_spec, subspace_names):
        self.subspaces = SubSpaces(len(element_spec))
        for sid, (rank, degree) in enumerate(element_spec):
            if degree != 1:
                raise NotImplementedError(
                    "only P1 subspaces are ported (degree 2 waits for the "
                    "quad family)"
                )
            self.subspaces.set_subspace(sid, SubSpace(
                name=subspace_names.get(sid, f"subspace_{sid}"), rank=rank,
                degree=degree, n_dofs=self.mesh.n_nodes, dim=self.mesh.dim,
            ))

    @property
    def has_subspaces(self) -> bool:
        return self.subspaces is not None and self.subspaces.n > 1

    def dof_coordinates(self, subspace_id: int) -> np.ndarray:
        return self.mesh.points

    def _eval_expression(self, expr, coords, value_size, time=None):
        """Evaluate a constant / array / callable expression at coords."""
        n = len(coords)
        if callable(expr):
            try:
                vals = expr(coords, time) if time is not None else expr(coords)
            except TypeError:
                vals = expr(coords)
            vals = np.asarray(vals, dtype=np.float64)
            return vals.reshape(n) if value_size == 1 else vals.reshape(n, value_size)
        vals = np.asarray(expr, dtype=np.float64)
        if vals.ndim == 0:
            return np.full((n,) if value_size == 1 else (n, value_size), vals)
        if vals.shape == (value_size,) and value_size > 1:
            return np.broadcast_to(vals, (n, value_size)).copy()
        return vals  # already nodal

    def _kernels(self):
        if self._kernels_cache is None:
            from glimslib_tpu_torch.ops.assembly import P1Kernels

            self._kernels_cache = P1Kernels(self.mesh, dtype=torch.float64)
        return self._kernels_cache

    def project(self, expr, subspace_id: int, time=None, rtol=1e-12, maxiter=2000):
        """L2 projection onto a P1 subspace: solve M x = b with
        b_i = ∫ expr φ_i dx by degree-4 quadrature (numpy float64)."""
        from glimslib_tpu_torch.solvers.cg import pcg

        ss = self.subspaces.get_subspace(subspace_id)
        mesh = self.mesh
        qp, qw = simplex_quadrature(mesh.dim, 4)
        vals, _ = P1Element(mesh.dim).tabulate(qp)  # (nq, npe)
        X = mesh.points[mesh.cells]  # (nc, npe, d)
        # contractions as matmuls (BLAS): a multi-operand einsum runs its
        # naive loop, seconds at 10^5 cells
        xq = np.matmul(vals, X)  # (nc, nq, d)
        detJ = mesh.cell_volumes * math.factorial(mesh.dim)
        fq = self._eval_expression(
            expr, xq.reshape(-1, mesh.dim), ss.value_size, time
        )
        if ss.value_size == 1:
            fq = fq.reshape(mesh.n_cells, len(qw))
            loc = (detJ[:, None] * fq * qw) @ vals  # (nc, npe)
            b = np.zeros(mesh.n_nodes)
            np.add.at(b, mesh.cells.ravel(), loc.ravel())
        else:
            fq = fq.reshape(mesh.n_cells, len(qw), ss.value_size)
            loc = np.matmul(vals.T, detJ[:, None, None] * fq * qw[:, None])  # (nc, npe, a)
            b = np.zeros((mesh.n_nodes, ss.value_size))
            np.add.at(b, mesh.cells.ravel(), loc.reshape(-1, ss.value_size))
        k = self._kernels()
        lumped = k.lumped_mass()
        # full-lattice meshes may carry unused nodes (zero mass rows)
        lumped = torch.where(lumped > 0, lumped, torch.ones_like(lumped))
        if ss.value_size == 1:
            x, _ = pcg(k.mass_residual, torch.as_tensor(b),
                       M=lambda r: r / lumped, rtol=rtol, maxiter=maxiter)
        else:
            x, _ = pcg(k.mass_vector_residual, torch.as_tensor(b),
                       M=lambda r: r / lumped[:, None], rtol=rtol,
                       maxiter=maxiter)
        return x.numpy()

    def project_over_space(self, expr_dict: Dict[int, object], time=None):
        """Project a dict of per-subspace expressions -> dict of arrays."""
        return {
            sid: self.project(expr, sid, time) for sid, expr in expr_dict.items()
        }
