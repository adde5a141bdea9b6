"""Matrix-free P1 element assembly in torch (counterpart of the
``P1Kernels`` members of ``glimslib_tpu/ops/assembly.py`` that the forward
step reads, and of its ``ScatterPlan`` pull-gather).

Per-cell tensors keep the reference's cell-axis-last layout: cells
(npe, nc), gradients (npe, d, nc), element contributions (npe, nc).  Node
accumulation of residuals is ``index_add_`` over the npe-major entry
order; it runs once per simulate or once per Newton iteration, never
inside the CG loops.  Operator assembly (``ops/bell.py``, ``ops/ell.py``)
and the per-Newton quadratic residual pull through a static
:class:`ScatterPlan` as the reference does: one ``index_select`` of
padded entries and a sum over the slots, with no TPU gather tricks
(width-2 duplicated rows, row chunking).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from glimslib_tpu_torch.core.elements import p1_mass_matrix


class ScatterPlan(NamedTuple):
    """Static pull-gather plan for entry -> segment accumulation.

    pull_table (n_segments, K) entry index per incident slot, where
                               n_entries is the zero-pad slot
    push_table (n_entries, m)  its inverse, the segments that pull each
                               entry, where n_segments is the zero-pad slot
                               (the pull's VJP gathers through it)
    n_entries  int             number of real entries
    n_segments int             number of segments (nodes, pairs, slots)
    """

    pull_table: np.ndarray
    push_table: np.ndarray
    n_entries: int
    n_segments: int


def make_scatter_plan(index_map: np.ndarray, n_segments: int) -> ScatterPlan:
    """Numpy copy of ``glimslib_tpu/ops/assembly.py make_scatter_plan``;
    each entry is pulled by its one segment ``index_map[e]``."""
    flat = np.asarray(index_map, dtype=np.int64).ravel()
    n_entries = len(flat)
    order = np.argsort(flat, kind="stable")
    sorted_ids = flat[order]
    starts = np.searchsorted(sorted_ids, np.arange(n_segments))
    ends = np.searchsorted(sorted_ids, np.arange(n_segments) + 1)
    counts = ends - starts
    K = int(counts.max()) if n_segments else 0
    # padded slots point at the sentinel entry (index n_entries -> zero row)
    table = np.full((n_segments, max(K, 1)), n_entries, dtype=np.int32)
    within = np.arange(n_entries) - starts[sorted_ids]
    table[sorted_ids, within] = order
    return ScatterPlan(
        pull_table=table, push_table=flat[:, None], n_entries=n_entries,
        n_segments=int(n_segments),
    )


def make_scatter_plan_dropping(index_map, n_segments):
    """Numpy copy of ``glimslib_tpu/ops/assembly.py
    make_scatter_plan_dropping``, its pull table: entries whose id is
    ``>= n_segments`` are dropped (they claim no slot and do not inflate
    the per-segment width K); padded slots hold ``n_entries``."""
    flat = np.asarray(index_map, dtype=np.int64).ravel()
    n_entries = len(flat)
    order = np.argsort(flat, kind="stable")
    sorted_ids = flat[order]
    starts = np.searchsorted(sorted_ids, np.arange(n_segments))
    ends = np.searchsorted(sorted_ids, np.arange(n_segments) + 1)
    counts = ends - starts
    K = int(counts.max()) if n_segments else 0
    table = np.full((n_segments, max(K, 1)), n_entries, dtype=np.int32)
    keep = sorted_ids < n_segments
    within = np.arange(n_entries) - starts[
        np.minimum(sorted_ids, max(n_segments - 1, 0))
    ]
    table[sorted_ids[keep], within[keep]] = order[keep]
    return table


def scatter_plan_from_pull(pull_table: np.ndarray, n_entries: int) -> ScatterPlan:
    """The plan of a pull table built otherwise (entries pulled by any
    number of segments, or by none): its push table padded to the largest
    count."""
    pull_table = np.asarray(pull_table, dtype=np.int64)
    n_segments, K = pull_table.shape
    ent = pull_table.ravel()
    seg = np.repeat(np.arange(n_segments, dtype=np.int64), K)
    real = ent < n_entries
    order = np.argsort(ent[real], kind="stable")
    ent, seg = ent[real][order], seg[real][order]
    counts = np.bincount(ent, minlength=n_entries)
    m = max(int(counts.max()) if len(ent) else 0, 1)
    within = np.arange(len(ent)) - (np.cumsum(counts) - counts)[ent]
    push = np.full((n_entries, m), n_segments, dtype=np.int64)
    push[ent, within] = seg
    return ScatterPlan(pull_table=pull_table, push_table=push, n_entries=int(n_entries),
                       n_segments=int(n_segments))


class PullIndex(NamedTuple):
    """A :class:`ScatterPlan`'s tables on the device (int64)."""

    pull: torch.Tensor  # (n_segments, K)
    push: torch.Tensor  # (n_entries, m)


def pull_index(plan: ScatterPlan, device) -> PullIndex:
    idx = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)  # noqa: E731
    return PullIndex(idx(plan.pull_table), idx(plan.push_table))


def _gather_sum(table, x):
    """sum_k x_padded[table[:, k]] for a (rows, K) table into x (n, ...)
    padded with one zero row (the sentinel n)."""
    rows, K = table.shape
    tail = tuple(x.shape[1:])
    padded = torch.cat([x, x.new_zeros((1,) + tail)])
    got = padded.index_select(0, table.reshape(-1))
    return got if K == 1 else got.reshape((rows, K) + tail).sum(dim=1)


class _Pull(torch.autograd.Function):
    """:func:`pull_accumulate`, whose VJP is the gather-sum through the
    push table (the default VJP of a gather, an ``index_add_``, piles every
    padded slot's atomic add onto the one sentinel row).  Being linear,
    its JVP is the same pull of the tangent (``torch.func.jvp``)."""

    @staticmethod
    def forward(pull, push, contrib):
        return _gather_sum(pull, contrib)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pull, push, _ = inputs
        ctx.save_for_backward(push)
        ctx.pull = pull

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (push,) = ctx.saved_tensors
        return None, None, _gather_sum(push, g)

    @staticmethod
    def jvp(ctx, _pull_t, _push_t, contrib_t):
        return _gather_sum(ctx.pull, contrib_t)


def pull_accumulate(index: PullIndex, contrib):
    """Accumulate entries (n_entries, ...) into segments (n_segments, ...):
    gather ``index.pull``'s entries of ``contrib`` padded with one zero row
    (the sentinel target) and sum over the slots."""
    return _Pull.apply(index.pull, index.push, contrib)


def scatter(plan: ScatterPlan, contrib_flat):
    """Accumulate per-entry contributions (n_entries, ...) into segments
    (n_segments, ...) through the plan's pull table, on the contributions'
    device."""
    return pull_accumulate(pull_index(plan, contrib_flat.device), contrib_flat)


# -- the per-cell element contributions (cell axis last), shared by
# P1Kernels' residuals and diagonals --------------------------------------


def rd_element_contrib(ce, cpe, gT, vol, D, rho, dt, source, conc_max, m0, t0,
                       dim):
    """Fisher-KPP implicit-Euler element contributions (npe, nc).

    ce/cpe (npe, nc), gT (npe, d, nc), vol (nc,); D/rho/source scalar or
    (nc,).  The mass and cubic terms are the closed forms
    (M c)_i = m0 (S + c_i), (T:cc)_i = t0 (S^2 + 2 c_i S + Q + 2 c_i^2)
    with S = sum_j c_j, Q = sum_j c_j^2."""
    dc = ce - cpe
    m_diff = m0 * (dc.sum(dim=0) + dc)
    grad_c = (ce[:, None, :] * gT).sum(dim=0)  # (d, nc)
    k_term = (grad_c[None] * gT).sum(dim=1)  # (npe, nc)
    S = ce.sum(dim=0)
    Q = (ce * ce).sum(dim=0)
    m_c = m0 * (S + ce)
    t_cc = t0 * (S * S + Q + 2.0 * ce * (S + ce))
    return vol * (
        m_diff
        + (dt * D) * k_term
        - (dt * rho) * (m_c - t_cc / conc_max)
        - (dt * source / (dim + 1))
    )


def rd_diag_contrib(gT, vol, D, dt, m0, dim):
    """Jacobi diagonal of (M + dt D K), element contributions (npe, nc)."""
    mdiag = (2.0 * m0) * vol
    g2 = (gT * gT).sum(dim=1)  # (npe, nc)
    return mdiag.expand(g2.shape) + (dt * D) * vol * g2


def elasticity_element_contrib(ue, c_int, gT, vol, mu, lam, coupling, bf_T,
                               dim):
    """Growth-coupled elasticity element contributions (npe, d, nc).

    ue (d, npe, nc), c_int (nc,) the per-cell ∫c, gT (npe, d, nc), bf_T
    None | (d, 1) | (d, nc)."""
    d = dim
    # grad_u[a, b] = sum_j ue[a, j] g[j, b]
    grad_u = (ue[:, None, :, :] * gT.permute(1, 0, 2)[None]).sum(dim=2)
    eps = 0.5 * (grad_u + grad_u.transpose(0, 1))  # (d, d, nc)
    tr_eps = eps.diagonal(dim1=0, dim2=1).sum(dim=-1)  # (nc,)
    eye = torch.eye(d, dtype=eps.dtype, device=eps.device)[:, :, None]
    sigma = 2.0 * mu * eps + (lam * tr_eps) * eye  # (d, d, nc)
    # term_stress[i, a] = vol sum_b sigma[a, b] g[i, b]
    term_stress = vol * (gT[:, None, :, :] * sigma[None]).sum(dim=2)
    kfac = coupling * (2.0 * mu + d * lam) * c_int  # (nc,)
    contrib = term_stress - kfac * gT
    if bf_T is not None:
        contrib = contrib - (vol / (d + 1)) * bf_T[None]
    return contrib


def elasticity_diag_contrib(gT, vol, mu, lam):
    """Elasticity Jacobi diagonal, element contributions (npe, d, nc)."""
    g2 = (gT * gT).sum(dim=1)  # (npe, nc)
    ga2 = gT * gT  # (npe, d, nc)
    return vol * (mu * (g2[:, None, :] + ga2) + lam * ga2)


class P1Kernels:
    """Per-mesh P1 kernels of the coupled Fisher-KPP + elasticity system.

    Coefficients (``D``, ``rho``, ``mu``, ``lam``, ``source``) are scalars
    (Python numbers or 0-d tensors) or per-cell tensors (nc,).

    ``rows`` = (lo, hi): the members that accumulate onto the nodes return
    rows [lo, hi) of the result only: on a rank's node slab
    (``parallel/gspmd.py NodeSlab``, ``mesh`` its ``local_mesh``, ``rows``
    its owned rows) they read halo-padded fields and return the owned
    rows."""

    def __init__(self, mesh, dtype=torch.float64, device="cpu", rows=None):
        self._rows = None if rows is None else slice(*rows)
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

    def _out_rows(self, out):
        return out if self._rows is None else out[self._rows]

    def _scatter_scalar(self, contrib):
        """(npe, nc) element contributions -> (n_nodes,) (its ``rows``)."""
        out = torch.zeros(self.n_nodes, dtype=contrib.dtype, device=self.device)
        return self._out_rows(out.index_add_(0, self.cells_flat, contrib.reshape(-1)))

    def _scatter_vector(self, contrib):
        """(npe, d, nc) element contributions -> (n_nodes, d) (its ``rows``)."""
        ent = torch.movedim(contrib, 1, -1).reshape(-1, self.dim)
        out = torch.zeros(
            (self.n_nodes, self.dim), dtype=contrib.dtype, device=self.device
        )
        return self._out_rows(out.index_add_(0, self.cells_flat, ent))

    def _mass_apply(self, xe):
        return self._m0 * (xe.sum(dim=0) + xe)

    def rd_residual(self, c, c_prev, D, rho, dt, source=0.0, conc_max=1.0):
        """Implicit-Euler Fisher-KPP residual (von Neumann terms excluded):
        R_i = ∫ c v + dt D ∇c·∇v - c_prev v - dt ρ c(1-c/c_max) v - dt s v."""
        contrib = rd_element_contrib(
            self._gather_T(c), self._gather_T(c_prev), self.grads_T, self.vol,
            self._cellco(D), self._cellco(rho), dt, self._cellco(source),
            conc_max, self._m0, self._t0, self.dim)
        return self._scatter_scalar(contrib)

    @property
    def _quad_pull_cells(self):
        """:class:`PullIndex` of the node pull by CELL (sentinel nc):
        entries are npe-major, so cell = entry % nc."""
        if not hasattr(self, "_quad_pull_cells_cache"):
            cells_T = self.cells_T.cpu().numpy()
            plan = make_scatter_plan(cells_T, self.n_nodes)
            pt = plan.pull_table.astype(np.int64)
            nc = self.n_cells
            cell_pt = np.where(pt == plan.n_entries, nc, pt % nc)
            self._quad_pull_cells_cache = pull_index(
                scatter_plan_from_pull(cell_pt, nc), self.device)
        return self._quad_pull_cells_cache

    def rd_quad_residual(self, c, rho, dt, conc_max=1.0):
        """Only the quadratic logistic term of :meth:`rd_residual`,
        q_i = dt rho / c_max ∫ c² φ_i dx: per-cell scalars
        [rho vol (S²+Q), rho vol S, rho vol] pulled to the nodes, then
        q_i = (dt t0 / c_max)(A_i + 2 c_i (B_i + c_i C_i))."""
        rho = self._cellco(rho)
        ce = self._gather_T(c)
        S = ce.sum(dim=0)
        Q = (ce * ce).sum(dim=0)
        rv = (rho * self.vol).expand(self.n_cells)
        pack = torch.stack([rv * (S * S + Q), rv * S, rv], dim=-1)  # (nc, 3)
        agg = pull_accumulate(self._quad_pull_cells, pack)
        return (dt / conc_max) * self._t0 * (
            agg[:, 0] + 2.0 * c * (agg[:, 1] + c * agg[:, 2])
        )

    def rd_mass_stiffness_diag(self, D, rho, dt):
        """Diagonal of (M + dt D K), the Jacobi preconditioner of the
        concentration block (rho unused, kept for interface parity)."""
        return self._scatter_scalar(rd_diag_contrib(
            self.grads_T, self.vol, self._cellco(D), dt, self._m0, self.dim))

    def elasticity_diag(self, mu, lam):
        """Diagonal of the elasticity stiffness operator per (node, comp)."""
        return self._scatter_vector(elasticity_diag_contrib(
            self.grads_T, self.vol, self._cellco(mu), self._cellco(lam)))

    def elasticity_diag_blocks(self, mu, lam):
        """Per-node (d, d) diagonal blocks of the elasticity operator,
        A[(i,a),(i,b)] = Σ_cells V [μ(g_i[a] g_i[b] + δ_ab |g_i|²) + λ
        g_i[a] g_i[b]], (n, d, d): the block-Jacobi preconditioner of the
        matrix-free lane."""
        g = self.grads_T  # (npe, d, nc)
        v = self.vol
        mu = self._cellco(mu)
        lam = self._cellco(lam)
        gg = g[:, :, None, :] * g[:, None, :, :]  # (npe, a, b, nc)
        g2 = (g * g).sum(dim=1)  # (npe, nc)
        eye = torch.eye(self.dim, dtype=self.dtype, device=self.device)[None, :, :, None]
        contrib = v * (mu * (gg + eye * g2[:, None, None, :]) + lam * gg)
        d = self.dim
        ent = torch.movedim(contrib, -1, 1).reshape(-1, d * d)  # npe-major entries
        out = torch.zeros((self.n_nodes, d * d), dtype=contrib.dtype, device=self.device)
        return self._out_rows(out.index_add_(0, self.cells_flat, ent)).reshape(-1, d, d)

    def block_jacobi_inverse_blocks(self, B, mask=None):
        """The inverses of per-node (d, d) blocks, (n, d, d); the blocks of
        nodes with any masked component (``mask`` (n, d): Dirichlet dofs,
        nodes no cell references) are identity before inversion."""
        if mask is not None:
            eye = torch.eye(self.dim, dtype=B.dtype, device=B.device)[None]
            B = torch.where(mask.any(dim=1)[:, None, None], eye, B)
        return torch.linalg.inv(B)

    @staticmethod
    def apply_block_jacobi(Binv, r):
        """r (n, d) -> (n, d), each node's block solve."""
        return (Binv * r[:, None, :]).sum(dim=2)

    # -- vector elasticity block (the gather path: the matrix-free lane,
    # the residuals with facet or time-dependent terms, refinement's f64
    # defect residuals) ----------------------------------------------------

    def elasticity_residual(self, u, c, mu, lam, coupling, body_force=None):
        """Residual of the growth-coupled linear elasticity equation,
        R_{i,a} = ∫ σ(u):ε(φ_i e_a) - σ(φ_i e_a):(k c I) - b·(φ_i e_a) dx,
        with σ(v):(k c I) = k c (2μ + d λ) div v.  ``u`` (n, d), ``c``
        (n,); returns (n, d)."""
        c_int = self._gather_T(c).mean(dim=0) * self.vol  # exact ∫c per cell
        return self.elasticity_residual_cint(u, c_int, mu, lam, coupling, body_force)

    def elasticity_residual_cint(self, u, c_int, mu, lam, coupling, body_force=None):
        """:meth:`elasticity_residual` with the concentration given by its
        per-cell integral ``c_int`` (nc,): the growth strain couples
        through ∫_e c dx only, which is how a P2 concentration enters
        (``models/tumor_growth_quad.py``)."""
        bf_T = None
        if body_force is not None:
            bf = self._cellco(body_force)
            bf_T = bf[:, None] if bf.dim() == 1 else bf.T  # (d, 1) or (d, nc)
        contrib = elasticity_element_contrib(
            u[self.cells_T].permute(2, 0, 1), c_int, self.grads_T, self.vol,
            self._cellco(mu), self._cellco(lam), self._cellco(coupling), bf_T,
            self.dim)
        return self._scatter_vector(contrib)

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
        return self._out_rows(out.index_add_(0, self.cells_flat,
                                             contrib.reshape(-1, self.dim)))

    def lumped_mass(self):
        """Row-sum lumped mass vector (n,)."""
        contrib = (self.vol / (self.dim + 1)).expand(self.npe, self.n_cells)
        return self._scatter_scalar(contrib)

    def gather(self, nodal):
        """nodal (n, ...) -> per-cell (nc, npe, ...) (cell-major)."""
        return nodal[self.cells_T.T]

    def stiffness_residual(self, c, D=1.0):
        """∫ D ∇c·∇v dx, (n,) -> (n,)."""
        g = self.grads_T
        grad_c = (self._gather_T(c)[:, None, :] * g).sum(dim=0)  # (d, nc)
        contrib = (self._cellco(D) * self.vol) * (grad_c[None] * g).sum(dim=1)
        return self._scatter_scalar(contrib)

    def integrate_cellwise(self, values_per_cell):
        """∫ f dx of a piecewise-constant f: Σ f_e V_e (a 0-d tensor)."""
        return torch.sum(values_per_cell * self.vol)

    def integrate_p1(self, c):
        """∫ c dx of a P1 field: Σ_e V_e mean(c_e) (a 0-d tensor)."""
        return torch.sum(self.cell_integral(c))

    def cell_gradient(self, c):
        """Per-cell (constant) gradient of a P1 scalar field, (nc, d)."""
        return (self._gather_T(c)[:, None, :] * self.grads_T).sum(dim=0).T

    def cell_average(self, c):
        """Per-cell average of P1 fields, (..., n) -> (..., nc)."""
        return c[..., self.cells_T].mean(dim=-2)

    def cell_integral(self, c):
        """∫_e c dx per cell, (..., n) -> (..., nc): exact for P1 c.  Masked
        sums of it are the reference's subdomain ``dx(i)`` measures."""
        return self.vol * self.cell_average(c)

    def cell_vector_gradient(self, u):
        """Per-cell displacement gradient ∇u[a,b] = ∂u_a/∂x_b, (n, d) ->
        (nc, d, d)."""
        ue = u[self.cells_T]  # (npe, nc, d)
        return torch.einsum("knb,kdn->nbd", ue, self.grads_T)


# -- facet (boundary-integral) kernels: von Neumann conditions ----------------


class FacetKernels:
    """Surface-integral kernels over a set of facets (counterpart of
    ``glimslib_tpu/ops/assembly.py FacetKernels``): ∫_Γ q φ_i ds (a
    scalar flux) and ∫_Γ t·v ds (a traction), with the facet P1 mass
    matrix M^f_ij = A (1 + δ_ij) / (d (d + 1)) on a (d-1)-simplex of d
    nodes, in ``dtype`` on ``device``.

    Built over exterior facets (``facet_idx`` into the mesh's boundary
    facet arrays) or over explicit facet nodes (``facet_nodes`` (nf, d),
    e.g. inter-tissue facets for the ``dS`` measure, their areas from the
    facet geometry).  Accumulation into
    the nodes is one static pull (``pull_accumulate``), so autograd and
    ``torch.func.jvp`` pass through.

    A rank's share under sharding (``parallel/``): ``keep`` selects the
    facets (indices into the set above) and ``node_map`` (mesh node ->
    row) numbers their nodes in the rank's ``n_nodes`` rows, a node it
    maps to ``n_nodes`` or above being dropped; each kept row sums its
    facets' contributions in the order the whole set does."""

    def __init__(self, mesh, facet_idx, n_nodes, dtype=torch.float64, facet_nodes=None,
                 device="cpu", keep=None, node_map=None):
        self.dim = mesh.dim
        self.dtype = dtype
        self.device = torch.device(device)
        if facet_nodes is None:
            fidx = np.asarray(facet_idx, dtype=np.int64)
            fnodes = mesh.boundary_facet_nodes[fidx]
            area = mesh.boundary_facet_area[fidx]
        else:
            fnodes = np.asarray(facet_nodes, dtype=np.int64)
            coords = mesh.points[fnodes]  # (nf, dim, dim)
            if mesh.dim == 2:
                area = np.linalg.norm(coords[:, 1] - coords[:, 0], axis=1)
            elif mesh.dim == 3:
                area = 0.5 * np.linalg.norm(np.cross(coords[:, 1] - coords[:, 0],
                                                     coords[:, 2] - coords[:, 0]), axis=1)
            else:
                raise NotImplementedError("facet geometry needs dim 2 or 3")
        if keep is not None:
            keep = np.asarray(keep, dtype=np.int64)
            fnodes, area = np.asarray(fnodes)[keep], np.asarray(area)[keep]
        kw = dict(dtype=dtype, device=self.device)
        self.n_facets = len(fnodes)
        self.facet_nodes = np.asarray(fnodes, dtype=np.int64)
        self.facet_area = torch.as_tensor(area, **kw)
        # where callables are evaluated: the facet nodes, (nf, d, dim)
        self.value_coords = torch.as_tensor(mesh.points[fnodes], **kw)
        if node_map is None:
            plan = make_scatter_plan(self.facet_nodes, n_nodes)
        else:
            rows = np.asarray(node_map, dtype=np.int64)[self.facet_nodes]
            plan = scatter_plan_from_pull(
                make_scatter_plan_dropping(rows, n_nodes), rows.size)
        self._pull = pull_index(plan, self.device)
        d = mesh.dim
        M = np.full((d, d), 1.0 / (d * (d + 1)))
        M[np.diag_indices(d)] *= 2.0
        self.facet_mass_unit = torch.as_tensor(M, **kw)

    def _value(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def scalar_flux_residual(self, q):
        """∫_Γ q φ_i ds with q a constant, per facet (nf,) or per facet
        node (nf, d); returns (n_nodes,)."""
        q = self._value(q)
        if q.dim() <= 1:
            qn = (q[:, None] if q.dim() == 1 else q).expand(self.n_facets, self.dim)
        else:
            qn = q
        # contrib[f, i] = A_f sum_j M[i, j] qn[f, j]
        contrib = self.facet_area[:, None] * (self.facet_mass_unit[None]
                                              * qn[:, None, :]).sum(dim=2)
        return pull_accumulate(self._pull, contrib.reshape(-1))

    def traction_residual(self, t):
        """∫_Γ t·v ds with t a constant (d,), per facet (nf, d) or per
        facet node (nf, d_nodes, d); returns (n_nodes, d)."""
        t = self._value(t)
        if t.dim() <= 2:
            tf = t if t.dim() == 2 else t[None, :]
            tn = tf.expand(self.n_facets, t.shape[-1])[:, None, :].expand(
                self.n_facets, self.dim, t.shape[-1])
        else:
            tn = t
        # contrib[f, i, a] = A_f sum_j M[i, j] tn[f, j, a]
        contrib = self.facet_area[:, None, None] * (
            self.facet_mass_unit[None, :, :, None] * tn[:, None, :, :]).sum(dim=2)
        return pull_accumulate(self._pull, contrib.reshape(-1, contrib.shape[-1]))
