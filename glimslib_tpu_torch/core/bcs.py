"""Boundary conditions: Dirichlet dof masks and values (counterpart of
``glimslib_tpu/core/bcs.py``).

The same specification dictionaries are accepted; Dirichlet conditions
compile to a per-subspace (mask, values) pair of numpy arrays that the
models move to their device.  Values may be constants or callables
``f(coords, t)`` evaluated with numpy on the host.  On a P2 subspace a
condition constrains the edge-midpoint dofs of its facets as well as
their vertex dofs (``fenics.DirichletBC``'s topological semantics, a
facet belongs to the condition when all its vertices do), in the shared
interleaved dof order (``ops/p2.py p2_dof_layout``).

Von Neumann conditions compile to facet kernels
(:class:`~glimslib_tpu_torch.ops.assembly.FacetKernels` on a P1
subspace, :class:`~glimslib_tpu_torch.ops.p2.P2FacetKernels` on a P2
one) in the model's dtype on its device, whose residual contributions
the models add per step: exterior facets of a named boundary, a
``subdomain_boundary`` bound to the exterior ``ds`` measure (which
reaches none of its interior facets, so it contributes zero, as in the
reference), or with ``measure='dS'`` the inter-tissue facets themselves
(P1).  A time-dependent ``bc_value`` is a callable ``f(x, t)`` of torch
coordinates (m, dim) on the model's device and the step time ``t`` (a
float), evaluated inside the step at the kernels' value points (facet
nodes for P1, facet quadrature points for P2).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from glimslib_tpu_torch.core.subdomains import _eval_predicate

logger = logging.getLogger(__name__)


def _facet_kernels(*args, **kw):
    # deferred: core <-> ops would otherwise be a circular import
    from glimslib_tpu_torch.ops.assembly import FacetKernels

    return FacetKernels(*args, **kw)


def _p2_facet_kernels(*args, **kw):
    from glimslib_tpu_torch.ops.p2 import P2FacetKernels

    return P2FacetKernels(*args, **kw)


def _facet_edge_dofs(mesh, facet_vertex_sets: np.ndarray) -> np.ndarray:
    """Edge-midpoint dof ids (offset by n_nodes) of the facets given as
    (nf, d) vertex-node arrays — the P2 dofs a facet carries beyond its
    vertices."""
    if len(facet_vertex_sets) == 0:
        return np.zeros(0, dtype=np.int64)
    d = mesh.dim
    if d == 2:
        pairs = facet_vertex_sets  # a 2D facet is itself one edge
    else:
        pairs = np.concatenate(
            [
                facet_vertex_sets[:, [0, 1]],
                facet_vertex_sets[:, [0, 2]],
                facet_vertex_sets[:, [1, 2]],
            ],
            axis=0,
        )
    eids = np.unique(mesh.edge_ids_for_pairs(pairs))
    return mesh.n_nodes + eids.astype(np.int64)


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

    def __init__(self, functionspace, subdomains, dtype=torch.float64, device="cpu"):
        """``dtype`` and ``device``: those of the von Neumann facet
        kernels (the model's)."""
        self._functionspace = functionspace
        self._subdomains = subdomains
        self.dtype = dtype
        self.device = torch.device(device)
        self.dirichlet_bcs: List[DirichletBC] = []
        self.von_neumann_bcs: Dict[str, dict] = {}

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
            pred = bc_dict["boundary"]
            bn = m.boundary_nodes
            ok = _eval_predicate(pred, m.points[bn], True)
            return bn[ok]
        if "subdomain_boundary" in bc_dict:
            name = bc_dict["subdomain_boundary"]
            if name in self._subdomains.subdomain_boundaries_id_dict:
                return self._subdomains.subdomain_boundary_nodes(name)
            return None
        if "named_boundary" in bc_dict:
            name = bc_dict["named_boundary"]
            bid = self._subdomains.named_boundaries_id_dict.get(name)
            if bid is None:
                return None
            fidx = self._subdomains.named_boundary_facets(name)
            return np.unique(m.boundary_facet_nodes[fidx].ravel())
        return None

    def _boundary_facet_vertex_sets_for(self, bc_dict) -> Optional[np.ndarray]:
        """Facets covered by the BC spec, as (nf, d) vertex-node arrays.

        Used to locate P2 edge dofs (topological semantics, like
        ``fenics.DirichletBC`` 'topological' method: a facet belongs to the
        BC when all its vertices do)."""
        m = self._subdomains.mesh
        if "boundary" in bc_dict:
            pred = bc_dict["boundary"]
            ok = np.zeros(m.n_nodes, dtype=bool)
            bn = m.boundary_nodes
            ok[bn[_eval_predicate(pred, m.points[bn], True)]] = True
            sel = ok[m.boundary_facet_nodes].all(axis=1)
            return m.boundary_facet_nodes[sel]
        if "subdomain_boundary" in bc_dict:
            name = bc_dict["subdomain_boundary"]
            if name in self._subdomains.subdomain_boundaries_id_dict:
                return self._subdomains.subdomain_boundary_facet_nodes(name)
            return None
        if "named_boundary" in bc_dict:
            name = bc_dict["named_boundary"]
            if self._subdomains.named_boundaries_id_dict.get(name) is None:
                return None
            fidx = self._subdomains.named_boundary_facets(name)
            return m.boundary_facet_nodes[fidx]
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
        if ss.degree == 2:
            from glimslib_tpu_torch.ops.p2 import p2_dof_layout

            m = self._subdomains.mesh
            _, rank, _ = p2_dof_layout(m)
            nodes = rank[np.asarray(nodes, np.int64)]
            fvs = self._boundary_facet_vertex_sets_for(bc_dict)
            if fvs is not None and len(fvs):
                nodes = np.concatenate([nodes, rank[_facet_edge_dofs(m, fvs)]])
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

    # -- von Neumann (reference core/bcs.py:236-403) --------------------------

    def setup_von_neumann_boundary_conditions(self, von_neumann_bcs=None):
        """Compile the von Neumann specs into facet kernels: each entry of
        ``von_neumann_bcs`` (name -> spec dict) becomes
        ``self.von_neumann_bcs[name]`` = {"bc_value", "kernels",
        "kernel_factory" (dtype -> kernels on this device), "subspace_id",
        "facet_idx", "facet_cells" (the cell whose coefficients a facet
        takes)}; a P1 entry's factory also takes ``n_rows``, ``keep`` and
        ``node_map``, a rank's share of its facets
        (:class:`~glimslib_tpu_torch.ops.assembly.FacetKernels`).
        Incomplete specs are skipped with a warning."""
        von_neumann_bcs = von_neumann_bcs or {}
        m = self._subdomains.mesh
        n_nodes = m.n_nodes
        dev = self.device
        for bc_name, bc_dict in von_neumann_bcs.items():
            if "bc_value" not in bc_dict:
                logger.error("von Neumann BC '%s' missing 'bc_value'", bc_name)
                continue
            subspace_id = bc_dict.get("subspace_id")
            if self._functionspace.has_subspaces and subspace_id is None:
                logger.error("von Neumann BC '%s' missing 'subspace_id'", bc_name)
                continue
            fidx = None
            if "named_boundary" in bc_dict:
                try:
                    fidx = self._subdomains.named_boundary_facets(
                        bc_dict["named_boundary"]
                    )
                except KeyError:
                    fidx = None
            elif "subdomain_boundary" in bc_dict:
                name = bc_dict["subdomain_boundary"]
                if bc_dict.get("measure", "ds") == "dS":
                    # the inter-tissue facets themselves (the JAX package's
                    # opt-in, beyond the reference); per-facet coefficients
                    # from the lower-id adjacent cell
                    ss_ = self._functionspace.subspaces.get_subspace(
                        subspace_id or 0
                    )
                    if ss_.degree == 2:
                        raise NotImplementedError(
                            "measure='dS' von Neumann BCs support P1 "
                            "subspaces only"
                        )
                    if name not in self._subdomains.subdomain_boundaries_id_dict:
                        logger.warning(
                            "von Neumann BC '%s': unknown subdomain "
                            "boundary '%s' -- skipping", bc_name, name,
                        )
                        continue
                    interior_nodes = (
                        self._subdomains.subdomain_boundary_facet_nodes(name)
                    )
                    interior_cells = (
                        self._subdomains.subdomain_boundary_facet_cells(name)
                    )

                    def factory(dtype, n_rows=n_nodes, m=m, fn=interior_nodes, **share):
                        return _facet_kernels(m, None, n_rows, dtype=dtype, facet_nodes=fn,
                                              device=dev, **share)

                    self.von_neumann_bcs[bc_name] = {
                        "bc_value": bc_dict["bc_value"],
                        "kernels": factory(self.dtype),
                        "kernel_factory": factory,
                        "subspace_id": subspace_id,
                        "facet_idx": np.arange(len(interior_nodes)),
                        "facet_cells": interior_cells[:, 0],
                    }
                    continue
                # the reference binds the BC to the exterior 'ds' measure
                # restricted to the inter-tissue marker: the facets are
                # interior, so it integrates over none and adds zero
                if name not in self._subdomains.subdomain_boundaries_id_dict:
                    fidx = None
                else:
                    fidx = self._subdomains.subdomain_boundary_exterior_facets(
                        name
                    )
                    if len(fidx) == 0:
                        logger.warning(
                            "von Neumann BC '%s': subdomain boundary '%s' "
                            "marks interior facets only; the exterior 'ds' "
                            "measure integrates over none of them, so this "
                            "BC contributes zero. Pass measure='dS' to "
                            "integrate over the interior facets themselves.",
                            bc_name, name,
                        )
            if fidx is None:
                logger.warning("von Neumann BC '%s' incomplete -- skipping", bc_name)
                continue
            ss = self._functionspace.subspaces.get_subspace(subspace_id or 0)
            if ss.degree == 2:
                if ss.value_size != 1:
                    raise NotImplementedError(
                        "von Neumann BCs on degree-2 vector subspaces are "
                        "not supported (the reference has no such case)"
                    )

                def factory(dtype, m=m, fidx=fidx, nd=ss.n_dofs):
                    return _p2_facet_kernels(m, fidx, nd, dtype=dtype, device=dev)
            else:

                def factory(dtype, n_rows=n_nodes, m=m, fidx=fidx, **share):
                    return _facet_kernels(m, fidx, n_rows, dtype=dtype, device=dev,
                                          **share)

            self.von_neumann_bcs[bc_name] = {
                "bc_value": bc_dict["bc_value"],
                "kernels": factory(self.dtype),
                "kernel_factory": factory,
                "subspace_id": subspace_id,
                "facet_idx": fidx,
                "facet_cells": m.boundary_facet_cell[fidx],
            }

    def von_neumann_kernels(self, bc, hi=False):
        """Facet kernels of one von Neumann entry; ``hi=True``: an f64
        build (made once), for mixed-precision refinement's defect
        residuals."""
        if not hi:
            return bc["kernels"]
        if "kernels_hi" not in bc:
            bc["kernels_hi"] = bc["kernel_factory"](torch.float64)
        return bc["kernels_hi"]

    def von_neumann_values(self, kern, val, value_size, t):
        """A condition's value at ``kern``'s value points, (nf, k) or (nf,
        k, value_size), from a callable ``val(x, t)`` of torch coordinates;
        a constant as given."""
        if not callable(val):
            return val
        coords = kern.value_coords
        v = torch.as_tensor(val(coords.reshape(-1, coords.shape[-1]), t),
                            dtype=kern.dtype, device=kern.device)
        if value_size == 1:
            return v.reshape(coords.shape[:2])
        return v.reshape(coords.shape[:2] + (value_size,))

    def von_neumann_residual(self, subspace_id: int, t=0.0, scale=1.0, hi=False):
        """Sum of the surface integrals ∫ q φ_i ds (scalar subspace) or ∫
        t·v ds (vector subspace) of every condition on ``subspace_id``, or
        None when it has none.  ``scale`` multiplies the value; ``hi=True``
        evaluates with the f64 facet kernels."""
        out = None
        ss = self._functionspace.subspaces.get_subspace(subspace_id)
        for bc in self.von_neumann_bcs.values():
            if bc["subspace_id"] != subspace_id:
                continue
            kern = self.von_neumann_kernels(bc, hi=hi)
            v = self.von_neumann_values(kern, bc["bc_value"], ss.value_size, t)
            if ss.value_size == 1:
                term = kern.scalar_flux_residual(v) * scale
            else:
                term = kern.traction_residual(v) * scale
            out = term if out is None else out + term
        return out

    def time_update_bcs(self, time, kind="dirichlet"):
        """No-op: condition values are callables evaluated when a step is
        solved.  Kept for the reference's API."""
