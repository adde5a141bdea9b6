# Copy of glimslib_tpu/core/subdomains.py (numpy only). The code is kept byte for
# byte apart from imports, which point into glimslib_tpu_torch so that the
# port never imports the JAX package's core (its __init__ imports jax).
"""Subdomain (tissue) handling: label maps, boundaries, measures.

Rebuild of reference ``helper_classes.py`` ``SubDomains`` (l.385-615):

- cell subdomain ids from a nodal label function: the reference samples the
  P1 label function at each cell midpoint and truncates to int
  (helper_classes.py:431-444) — here that is the vectorized
  ``int(mean(vertex labels))``.
- inter-tissue boundaries: every pair of tissues gets a named facet set
  ``"{name_a}_{name_b}"`` (helper_classes.py:457-501, via
  ``itertools.combinations``), computed from shared-facet cell adjacency.
- named boundaries from predicates ``inside(x, on_boundary)``
  (helper_classes.py:503-528), evaluated on exterior facet vertices.
- measures: instead of UFL ``dx(i)/ds(i)/dsn(i)`` (helper_classes.py:539-562),
  subdomain-restricted integration is expressed as per-cell masks and facet
  index arrays that the assembly kernels consume.

TPU-first design note: per-tissue coefficients become ``values[cell_labels]``
gathers (differentiable w.r.t. the per-tissue value vector), replacing the
reference's ``DiscontinuousScalar`` Expression (helper_classes.py:47-58)
and removing its dolfin-adjoint incompatibility (simulation_base.py:79-82).
"""

from __future__ import annotations

import itertools
import logging
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)


def _interior_facets(cells: np.ndarray):
    """All unique facets with their adjacent cells.

    Returns (facet_nodes (nf, d), cell0 (nf,), cell1 (nf,)) with cell1 = -1
    for exterior facets.
    """
    from glimslib_tpu_torch.core.mesh import _facets_of_cells

    all_f = _facets_of_cells(cells)
    nc, npe, nfn = all_f.shape
    flat = all_f.reshape(-1, nfn)
    key = np.sort(flat, axis=1)
    order = np.lexsort(key.T[::-1])
    skey = key[order]
    new_group = np.ones(len(skey), dtype=bool)
    new_group[1:] = (skey[1:] != skey[:-1]).any(axis=1)
    group_ids = np.cumsum(new_group) - 1
    n_facets = group_ids[-1] + 1 if len(group_ids) else 0
    facet_nodes = np.full((n_facets, nfn), -1, dtype=np.int64)
    cell0 = np.full(n_facets, -1, dtype=np.int64)
    cell1 = np.full(n_facets, -1, dtype=np.int64)
    owner = order // npe
    firsts = np.where(new_group)[0]
    facet_nodes[:] = flat[order[firsts]]
    cell0[:] = owner[firsts]
    # second occurrence (if any)
    second_mask = np.zeros(len(skey), dtype=bool)
    second_mask[1:] = ~new_group[1:]
    cell1[group_ids[second_mask]] = owner[second_mask]
    return facet_nodes, cell0, cell1


def _eval_predicate(pred, coords: np.ndarray, on_boundary: bool) -> np.ndarray:
    """Evaluate an ``inside(x, on_boundary)``-style predicate at coords.

    Accepts: objects with ``.inside``, plain callables; vectorized or
    per-point implementations."""
    fn = pred.inside if hasattr(pred, "inside") else pred
    try:
        out = fn(coords.T, on_boundary)  # FEniCS convention: x[0], x[1]
        out = np.asarray(out)
        if out.shape == (len(coords),):
            return out.astype(bool)
    except Exception:
        pass
    try:
        out = fn(coords, on_boundary)
        out = np.asarray(out)
        if out.shape == (len(coords),):
            return out.astype(bool)
    except Exception:
        pass
    return np.array([bool(fn(x, on_boundary)) for x in coords])


class SubDomains:
    """Subdomain/boundary management over a Mesh."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.dim_geo = mesh.dim
        self.subdomains: Optional[np.ndarray] = None  # per-cell labels
        self.label_function: Optional[np.ndarray] = None  # nodal labels
        self.tissue_id_name_map: Dict[int, str] = {}
        self.subdomain_boundaries_id_dict: Dict[str, int] = {}
        self._subdomain_boundary_facets: Dict[int, np.ndarray] = {}
        self._subdomain_boundary_facet_nodes: Dict[int, np.ndarray] = {}
        self._subdomain_boundary_facet_cells: Dict[int, np.ndarray] = {}
        self.named_boundaries_id_dict: Dict[str, int] = {}
        self.named_boundaries_function_dict: Dict[str, object] = {}
        self._named_boundary_facets: Dict[int, np.ndarray] = {}

    # -- subdomain labels (helper_classes.py:402-444) -----------------------

    def setup_subdomains(self, label_function=None, subdomains=None, replace=False):
        if self.subdomains is not None and not replace:
            if label_function is not None or subdomains is not None:
                logger.warning("'subdomains' already exists ... do nothing.")
            return
        if subdomains is not None:
            self.subdomains = np.asarray(subdomains, dtype=np.int32)
            assert len(self.subdomains) == self.mesh.n_cells
        elif label_function is not None:
            self.label_function = np.asarray(label_function)
            # P1 label fct at cell midpoint == mean of vertex labels; int()
            # truncates (reference helper_classes.py:441-443)
            mid_vals = self.label_function[self.mesh.cells].mean(axis=1)
            self.subdomains = mid_vals.astype(np.int32)
        else:
            self.subdomains = np.zeros(self.mesh.n_cells, dtype=np.int32)

    @property
    def cell_labels(self) -> np.ndarray:
        return self.subdomains

    # -- boundaries ---------------------------------------------------------

    def setup_boundaries(self, tissue_map=None, boundary_fct_dict=None):
        if tissue_map is not None:
            self._setup_boundaries_from_subdomains(tissue_map)
        if boundary_fct_dict is not None:
            self._setup_boundaries_from_functions(boundary_fct_dict)

    def _setup_boundaries_from_subdomains(self, tissue_id_name_map):
        """Inter-tissue facet boundaries (helper_classes.py:457-501)."""
        if self.subdomains is None:
            logger.warning("Need subdomains to define boundaries.")
            return
        self.tissue_id_name_map = dict(tissue_id_name_map)
        boundary_types = list(itertools.combinations(self.tissue_id_name_map.keys(), 2))
        boundary_names = list(itertools.combinations(self.tissue_id_name_map.values(), 2))
        names_string = list(map("_".join, boundary_names))
        boundary_type_dict = dict(zip(boundary_types, names_string))
        boundary_id_dict = dict(zip(names_string, range(len(boundary_type_dict))))
        value_no_boundary = (max(boundary_id_dict.values()) + 1) if boundary_id_dict else 0
        boundary_id_dict["no_boundary"] = value_no_boundary

        fnodes, c0, c1 = _interior_facets(self.mesh.cells)
        lab0 = self.subdomains[c0]
        lab1 = np.where(c1 >= 0, self.subdomains[np.maximum(c1, 0)], lab0)
        for (ta, tb), name in boundary_type_dict.items():
            lo, hi = min(ta, tb), max(ta, tb)
            mask = (np.minimum(lab0, lab1) == lo) & (np.maximum(lab0, lab1) == hi) & (c1 >= 0)
            bid = boundary_id_dict[name]
            self._subdomain_boundary_facets[bid] = np.where(mask)[0]
            self._subdomain_boundary_facet_nodes[bid] = fnodes[mask]
            self._subdomain_boundary_facet_cells[bid] = np.stack(
                [c0[mask], c1[mask]], axis=1
            )
        self.subdomain_boundaries_id_dict = boundary_id_dict
        self._all_facet_nodes = fnodes

    def _setup_boundaries_from_functions(self, boundary_dict):
        """Named boundaries from predicates (helper_classes.py:503-528).

        A facet is marked when all its vertices satisfy the predicate with
        ``on_boundary=True`` — matching DOLFIN's ``SubDomain.mark`` on
        exterior facets."""
        m = self.mesh
        boundary_id = 0
        for name, pred in boundary_dict.items():
            boundary_id += 1
            node_ok = np.zeros(m.n_nodes, dtype=bool)
            bnodes = m.boundary_nodes
            node_ok[bnodes] = _eval_predicate(pred, m.points[bnodes], True)
            facet_mask = node_ok[m.boundary_facet_nodes].all(axis=1)
            self._named_boundary_facets[boundary_id] = np.where(facet_mask)[0]
            self.named_boundaries_id_dict[name] = boundary_id
            self.named_boundaries_function_dict[name] = pred
            logger.info("boundary '%s' id=%d: %d facets", name, boundary_id,
                        int(facet_mask.sum()))

    # -- measures (helper_classes.py:539-562) -------------------------------

    def setup_measures(self):
        """No-op placeholder: measures are expressed as masks/index arrays,
        see :meth:`cell_mask`, :meth:`named_boundary_facets`,
        :meth:`subdomain_boundary_nodes`."""

    def cell_mask(self, subdomain_id: int) -> np.ndarray:
        """dx(i): boolean mask over cells."""
        return self.subdomains == subdomain_id

    def named_boundary_facets(self, name_or_id) -> np.ndarray:
        """dsn(i): indices into the mesh's exterior boundary facet arrays."""
        bid = (
            self.named_boundaries_id_dict.get(name_or_id)
            if isinstance(name_or_id, str)
            else name_or_id
        )
        if bid is None:
            raise KeyError(f"unknown named boundary {name_or_id!r}")
        return self._named_boundary_facets[bid]

    def subdomain_boundary_facet_nodes(self, name_or_id) -> np.ndarray:
        """ds(i): facet-node array of an inter-tissue boundary."""
        bid = (
            self.subdomain_boundaries_id_dict.get(name_or_id)
            if isinstance(name_or_id, str)
            else name_or_id
        )
        if bid is None:
            raise KeyError(f"unknown subdomain boundary {name_or_id!r}")
        return self._subdomain_boundary_facet_nodes[bid]

    def subdomain_boundary_nodes(self, name_or_id) -> np.ndarray:
        """Unique nodes on an inter-tissue boundary (for Dirichlet BCs)."""
        return np.unique(self.subdomain_boundary_facet_nodes(name_or_id).ravel())

    def subdomain_boundary_facet_cells(self, name_or_id) -> np.ndarray:
        """(nf, 2) adjacent cells of each inter-tissue facet — both sides
        of the interior 'dS' measure (column 0 = lower cell id)."""
        bid = (
            self.subdomain_boundaries_id_dict.get(name_or_id)
            if isinstance(name_or_id, str)
            else name_or_id
        )
        if bid is None:
            raise KeyError(f"unknown subdomain boundary {name_or_id!r}")
        return self._subdomain_boundary_facet_cells[bid]

    def subdomain_boundary_exterior_facets(self, name_or_id) -> np.ndarray:
        """ds(i) with exterior-facet semantics: indices into the mesh's
        exterior boundary facet arrays whose facet carries the inter-tissue
        marker ``name_or_id``.

        Matches the reference, where ``subdomain_boundary`` von Neumann BCs
        integrate against ``self.ds(boundary_id)`` (helper_classes.py:819-825)
        — an *exterior*-facet measure — while the marker function only ever
        marks facets shared by two cells of different tissues, i.e. interior
        facets (helper_classes.py:478-490).  The intersection is therefore
        empty by construction and the BC contributes zero, exactly as in the
        reference (documented there at helper_classes.py:747-756).  The
        matching is still done generically (by facet node sets) so any future
        marking rule that does reach the exterior is handled correctly.
        """
        marked = self.subdomain_boundary_facet_nodes(name_or_id)
        if len(marked) == 0:
            return np.empty(0, dtype=np.int64)
        ext = np.sort(np.asarray(self.mesh.boundary_facet_nodes), axis=1)
        mk = {tuple(row) for row in np.sort(marked, axis=1)}
        hits = [i for i, row in enumerate(ext) if tuple(row) in mk]
        return np.asarray(hits, dtype=np.int64)

    # -- tissue name/id maps ------------------------------------------------

    def get_subdomain_id(self, subdomain_name: str):
        inv = {v: k for k, v in self.tissue_id_name_map.items()}
        if subdomain_name in inv:
            return inv[subdomain_name]
        logger.error("Subdomain '%s' does not exist", subdomain_name)
        return None

    # -- heterogeneous coefficients -----------------------------------------

    def tissue_value_array(self, param_dict: Dict[str, float], fill=0.0) -> np.ndarray:
        """Per-tissue dict {tissue_name: value} -> dense lookup array indexed
        by label id (the rebuild's ``DiscontinuousScalar``,
        helper_classes.py:578-603).  Per-cell values are then
        ``lookup[cell_labels]`` — a differentiable gather."""
        max_id = max(
            [int(self.subdomains.max())] + list(self.tissue_id_name_map.keys())
        )
        lookup = np.full(max_id + 1, fill, dtype=np.float64)
        for tid, name in self.tissue_id_name_map.items():
            if name in param_dict:
                lookup[tid] = param_dict[name]
        return lookup

    def create_discontinuous_scalar_from_parameter_map(self, param_dict, name=None,
                                                       replace=False):
        """Reference-compatible alias returning the per-cell coefficient
        array for {tissue_name: value}."""
        lookup = self.tissue_value_array(param_dict)
        return lookup[self.subdomains]
