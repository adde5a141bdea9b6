"""P1 and P2 function spaces and initial values (counterpart of
``glimslib_tpu/core/functionspace.py``).

A mixed space is one array per subspace: a P1 subspace holds one value a
mesh node (displacement (n_nodes, d), concentration (n_nodes,)), a P2
subspace one a node and one an edge, in the shared interleaved order of
``ops/p2.py p2_dof_layout`` (the quad models' concentration).  Initial
values are projected as in the reference: an L2 projection with the
quadrature right-hand side in numpy and a mass-matrix CG solve in torch,
float64 (set-up, run once per call).  P1 solves run on the CPU; P2 solves
(degree-6 quadrature, the exact mass diagonal as Jacobi preconditioner,
reference ``functionspace.py:196-258``) on the space's ``device``, the
model's.
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

    @property
    def size(self) -> int:
        return self.n_dofs * self.value_size


class SubSpaces:
    """Registry of subspaces."""

    def __init__(self, n: int):
        self.n = n
        self._subspaces: Dict[int, SubSpace] = {}
        self.names: Dict[int, str] = {}

    def set_subspace(self, subspace_id: int, subspace: SubSpace):
        self._subspaces[subspace_id] = subspace
        self.names[subspace_id] = subspace.name

    def get_subspace_ids(self):
        return list(self._subspaces.keys())

    def get_subspace(self, subspace_id: int) -> SubSpace:
        return self._subspaces[subspace_id]

    def exists(self, subspace_id: int) -> bool:
        return subspace_id in self._subspaces


class FunctionSpace:
    """Mixed P1/P2 function space over a Mesh; ``element_spec`` lists
    ``(rank, degree)`` per subspace.  ``dtype`` is the numpy dtype of
    :meth:`zero_function`'s and :meth:`interpolate`'s arrays; P2
    projections run on ``device``."""

    def __init__(self, mesh, projection_parameters=None, dtype=np.float64,
                 device="cpu"):
        self.mesh = mesh
        self.dtype = dtype
        self.projection_parameters = projection_parameters or {
            "solver_type": "cg",
            "preconditioner_type": "jacobi",
        }
        self.device = torch.device(device)
        self.subspaces: Optional[SubSpaces] = None
        self._kernels_cache = None
        self._p2_kernels_cache = None

    def init_function_space(self, element_spec, subspace_names):
        self.subspaces = SubSpaces(len(element_spec))
        for sid, (rank, degree) in enumerate(element_spec):
            if degree == 1:
                n_dofs = self.mesh.n_nodes
            elif degree == 2:
                n_dofs = self.mesh.n_nodes + len(self.mesh.edges()[0])
            else:
                raise ValueError(f"unsupported degree {degree}")
            self.subspaces.set_subspace(sid, SubSpace(
                name=subspace_names.get(sid, f"subspace_{sid}"), rank=rank,
                degree=degree, n_dofs=n_dofs, dim=self.mesh.dim,
            ))

    @property
    def has_subspaces(self) -> bool:
        return self.subspaces is not None and self.subspaces.n > 1

    def get_subspace_names(self):
        return self.subspaces.names

    def dof_coordinates(self, subspace_id: int) -> np.ndarray:
        """Coordinates of a subspace's scalar dofs, in its dof order."""
        if self.subspaces.get_subspace(subspace_id).degree == 1:
            return self.mesh.points
        from glimslib_tpu_torch.ops.p2 import p2_dof_coordinates

        return p2_dof_coordinates(self.mesh)

    # -- field containers ---------------------------------------------------

    def zero_function(self) -> Dict[int, np.ndarray]:
        """Dict of zero arrays per subspace: the 'mixed function'."""
        return {
            sid: np.zeros(self.subspaces.get_subspace(sid).shape, self.dtype)
            for sid in self.subspaces.get_subspace_ids()
        }

    def pack(self, fields: Dict[int, object]):
        """Mixed function dict -> flat vector (sorted subspace ids, each
        field ravelled): a tensor when any field is one, else numpy."""
        parts = [fields[sid] for sid in sorted(fields)]
        if any(isinstance(v, torch.Tensor) for v in parts):
            like = next(v for v in parts if isinstance(v, torch.Tensor))
            return torch.cat([
                torch.as_tensor(v, device=like.device).reshape(-1) for v in parts
            ])
        return np.concatenate([np.ravel(v) for v in parts])

    def unpack(self, flat):
        """Flat vector -> mixed function dict (views of ``flat``, a tensor
        or a numpy array)."""
        out, ofs = {}, 0
        for sid in self.subspaces.get_subspace_ids():
            ss = self.subspaces.get_subspace(sid)
            out[sid] = flat[ofs:ofs + ss.size].reshape(ss.shape)
            ofs += ss.size
        return out

    def split_function(self, fields, subspace_id: int):
        """One subspace's field of a mixed function dict."""
        return fields[subspace_id]

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

    def interpolate(self, expr, subspace_id: int, time=None):
        """Nodal interpolation of an expression onto a subspace: its value
        at :meth:`dof_coordinates` (P2: the interleaved dof order)."""
        ss = self.subspaces.get_subspace(subspace_id)
        coords = self.dof_coordinates(subspace_id)
        vals = self._eval_expression(expr, coords, ss.value_size, time)
        return np.asarray(vals, dtype=self.dtype)

    def _kernels(self):
        if self._kernels_cache is None:
            from glimslib_tpu_torch.ops.assembly import P1Kernels

            self._kernels_cache = P1Kernels(self.mesh, dtype=torch.float64)
        return self._kernels_cache

    def _p2_kernels(self):
        if self._p2_kernels_cache is None:
            from glimslib_tpu_torch.ops.p2 import P2Kernels

            self._p2_kernels_cache = P2Kernels(self.mesh, dtype=torch.float64,
                                               device=self.device)
        return self._p2_kernels_cache

    def _project_p2(self, expr, ss, subspace_id, time, rtol, maxiter):
        """L2 projection onto a P2 subspace: b_i = ∫ expr φ_i dx by
        degree-6 quadrature, then a mass CG with the exact mass diagonal as
        Jacobi preconditioner (1 on zero rows); a vector subspace solves
        one scalar system a component."""
        from glimslib_tpu_torch.solvers.cg import pcg

        p2 = self._p2_kernels()
        vs = ss.value_size
        diag = p2.mass_diag()
        # the vertex dofs of nodes no cell touches (an image's full
        # lattice) have zero mass rows: their b is 0, so x stays 0 there
        diag = torch.where(diag > 0, diag, torch.ones_like(diag))

        def solve(b):
            x, _ = pcg(p2.mass_residual, b, M=lambda r: r / diag, rtol=rtol,
                       maxiter=maxiter)
            return x.cpu().numpy()

        if callable(expr):
            def comp(a):
                return lambda x: np.asarray(
                    self._eval_expression(expr, x, vs, time)).reshape(len(x), vs)[:, a]
            bs = [p2.project_rhs(comp(a)) for a in range(vs)]
        else:
            vals = self._eval_expression(
                expr, self.dof_coordinates(subspace_id), vs, time
            ).reshape(ss.n_dofs, vs)
            bs = [p2.mass_residual(torch.as_tensor(vals[:, a], device=p2.device))
                  for a in range(vs)]
        xs = [solve(b) for b in bs]
        return xs[0] if vs == 1 else np.stack(xs, axis=1)

    def project(self, expr, subspace_id: int, time=None, rtol=1e-12, maxiter=2000):
        """L2 projection onto a subspace: solve M x = b with
        b_i = ∫ expr φ_i dx by quadrature (degree 4 for P1, 6 for P2)."""
        from glimslib_tpu_torch.solvers.cg import pcg

        ss = self.subspaces.get_subspace(subspace_id)
        if ss.degree == 2:
            return self._project_p2(expr, ss, subspace_id, time, rtol, maxiter)
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
