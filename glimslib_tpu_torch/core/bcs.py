"""Boundary conditions: Dirichlet dof masks and values (counterpart of
``glimslib_tpu/core/bcs.py``).

The same specification dictionaries are accepted; Dirichlet conditions
compile to a per-subspace (mask, values) pair of numpy arrays that the
models move to their device.  Values may be constants or callables
``f(coords, t)`` evaluated with numpy on the host.

Von Neumann conditions are outside this slice of the port and raise
``NotImplementedError``.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np

from glimslib_tpu_torch.core.subdomains import _eval_predicate

logger = logging.getLogger(__name__)


class DirichletBC:
    """Compiled Dirichlet condition on one subspace."""

    def __init__(self, subspace_id, nodes, value, coords, value_size):
        self.subspace_id = subspace_id
        self.nodes = np.asarray(nodes, dtype=np.int64)
        self.value = value  # constant array or callable(x, t)
        self.coords = coords  # (n_bc_nodes, dim)
        self.value_size = value_size

    def values_at(self, t=0.0):
        n = len(self.nodes)
        shape = (n, self.value_size) if self.value_size > 1 else (n,)
        v = self.value(self.coords, t) if callable(self.value) else self.value
        return np.broadcast_to(np.asarray(v, dtype=np.float64), shape)

    @property
    def is_time_dependent(self):
        return callable(self.value)


class BoundaryConditions:
    """Compiles BC spec dicts into masks over a FunctionSpace + SubDomains."""

    def __init__(self, functionspace, subdomains):
        self._functionspace = functionspace
        self._subdomains = subdomains
        self.dirichlet_bcs: List[DirichletBC] = []

    def setup_dirichlet_boundary_conditions(self, dirichlet_bcs=None):
        for bc_name, bc_dict in (dirichlet_bcs or {}).items():
            bc = self._construct_dirichlet_bc(bc_dict)
            if bc is not None:
                self.dirichlet_bcs.append(bc)
            else:
                logger.warning("Dirichlet BC '%s' incomplete -- skipping", bc_name)

    def _boundary_nodes_for(self, bc_dict) -> Optional[np.ndarray]:
        m = self._subdomains.mesh
        if "boundary" in bc_dict:
            bn = m.boundary_nodes
            ok = _eval_predicate(bc_dict["boundary"], m.points[bn], True)
            return bn[ok]
        if "subdomain_boundary" in bc_dict:
            name = bc_dict["subdomain_boundary"]
            if name in self._subdomains.subdomain_boundaries_id_dict:
                return self._subdomains.subdomain_boundary_nodes(name)
            return None
        if "named_boundary" in bc_dict:
            name = bc_dict["named_boundary"]
            if self._subdomains.named_boundaries_id_dict.get(name) is None:
                return None
            fidx = self._subdomains.named_boundary_facets(name)
            return np.unique(m.boundary_facet_nodes[fidx].ravel())
        return None

    def _construct_dirichlet_bc(self, bc_dict) -> Optional[DirichletBC]:
        if "bc_value" not in bc_dict:
            logger.error("Dirichlet BC dict missing 'bc_value'")
            return None
        subspace_id = bc_dict.get("subspace_id")
        if self._functionspace.has_subspaces and subspace_id is None:
            logger.error("Dirichlet BC dict missing 'subspace_id'")
            return None
        subspace_id = subspace_id or 0
        nodes = self._boundary_nodes_for(bc_dict)
        if nodes is None:
            return None
        ss = self._functionspace.subspaces.get_subspace(subspace_id)
        coords = self._functionspace.dof_coordinates(subspace_id)[nodes]
        return DirichletBC(
            subspace_id, nodes, bc_dict["bc_value"], coords, ss.value_size
        )

    def dirichlet_mask_and_values(self, subspace_id: int, t=0.0):
        """(mask, values) numpy arrays shaped like the subspace field."""
        shape = self._functionspace.subspaces.get_subspace(subspace_id).shape
        mask = np.zeros(shape, dtype=bool)
        vals = np.zeros(shape, dtype=np.float64)
        for bc in self.dirichlet_bcs:
            if bc.subspace_id != subspace_id:
                continue
            mask[bc.nodes] = True
            vals[bc.nodes] = bc.values_at(t)
        return mask, vals

    @property
    def has_time_dependent_dirichlet(self):
        return any(bc.is_time_dependent for bc in self.dirichlet_bcs)

    def setup_von_neumann_boundary_conditions(self, von_neumann_bcs=None):
        if von_neumann_bcs:
            raise NotImplementedError(
                "von Neumann boundary conditions are not ported yet"
            )
