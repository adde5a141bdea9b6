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

    # -- vector elasticity block (the gather path: refinement's f64 defect
    # residuals) ---------------------------------------------------------

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
        ue = u[self.cells_T].permute(2, 0, 1)  # (d, npe, nc)
        d = self.dim
        g = self.grads_T  # (npe, d, nc)
        v = self.vol
        mu = self._cellco(mu)
        lam = self._cellco(lam)
        coupling = self._cellco(coupling)
        # grad_u[a, b] = sum_j ue[a, j] g[j, b]
        grad_u = (ue[:, None, :, :] * g.permute(1, 0, 2)[None]).sum(dim=2)
        eps = 0.5 * (grad_u + grad_u.transpose(0, 1))  # (d, d, nc)
        tr_eps = eps.diagonal(dim1=0, dim2=1).sum(dim=-1)  # (nc,)
        eye = torch.eye(d, dtype=eps.dtype, device=eps.device)[:, :, None]
        sigma = 2.0 * mu * eps + (lam * tr_eps) * eye  # (d, d, nc)
        # term_stress[i, a] = v sum_b sigma[a, b] g[i, b]
        term_stress = v * (g[:, None, :, :] * sigma[None]).sum(dim=2)  # (npe, d, nc)
        kfac = coupling * (2.0 * mu + d * lam) * c_int  # (nc,)
        contrib = term_stress - kfac * g
        if body_force is not None:
            bf = self._cellco(body_force)
            bf_T = bf[:, None] if bf.dim() == 1 else bf.T  # (d, 1) or (d, nc)
            contrib = contrib - (v / (d + 1)) * bf_T[None]
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
        return out.index_add_(0, self.cells_flat, contrib.reshape(-1, self.dim))

    def lumped_mass(self):
        """Row-sum lumped mass vector (n,)."""
        contrib = (self.vol / (self.dim + 1)).expand(self.npe, self.n_cells)
        return self._scatter_scalar(contrib)
