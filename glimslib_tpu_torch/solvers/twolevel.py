"""Two-level coarse-space preconditioning for unstructured meshes
(counterpart of ``glimslib_tpu/solvers/twolevel.py``, canonical layout).

Aggregates are contiguous ranges of ``agg_size`` nodes in mesh order
(Morton-ordered meshes give compact blobs), so restriction and
prolongation are a reshape and a sum or broadcast.  Per node, the
elasticity coarse space carries the affine modes u = t + G r (q = d + d²)
and the scalar one c = a + b·r (qs = 1 + d); Dirichlet dofs zero their
mode rows.  The Galerkin coarse matrix A_c = P~ᵀ A P~ is assembled from
node block-ELL values (``ops/ell.py``) into a dense matrix once per
model, and its inverse is kept as a Gram factor B with B Bᵀ ≈ A_c⁻¹,
computed on the host in f64 from an eigendecomposition (``numpy``), as
the reference does.  The preconditioner is the additive

    M(r) = base(r) + P~ B Bᵀ P~ᵀ r

whose coarse term is positive semidefinite in any float precision.

Deviation from the reference: the reference stores the factor in bf16 on
f32 runs (its ``GLIMS_TWOLEVEL_BF16`` default, halving the factor's
memory traffic); the port stores it in the working dtype.  The
node-axis-last (TPU lane) layouts of the mode matrices are not ported.
"""

from __future__ import annotations

import numpy as np
import torch


def n_affine_modes(d: int) -> int:
    return d + d * d  # translations + full displacement gradient


def n_scalar_modes(d: int) -> int:
    return 1 + d  # constant + linear


class AggPlan:
    """Host-precomputed contiguous-aggregate coarse space; node count
    zero-padded to a multiple of ``agg_size``."""

    def __init__(self, mesh, agg_size: int = 64):
        n = mesh.n_nodes
        d = mesh.dim
        m = int(agg_size)
        nagg = (n + m - 1) // m
        self.n, self.d, self.m, self.nagg = n, d, m, nagg
        self.n_pad = nagg * m
        self.q = n_affine_modes(d)

        pts = np.zeros((self.n_pad, d), dtype=np.float64)
        pts[:n] = np.asarray(mesh.points, dtype=np.float64)
        cent = pts.reshape(nagg, m, d).mean(axis=1)
        off = pts - np.repeat(cent, m, axis=0)
        off[n:] = 0.0
        # per-aggregate O(1) scaling for coarse-Gram conditioning
        scale = np.maximum(
            np.abs(off.reshape(nagg, m, d)).max(axis=(1, 2)), 1e-12
        )
        self.offsets = off / np.repeat(scale, m)[:, None]  # (n_pad, d)
        # aggregate id per node + the sentinel column of the ELL adjacency
        agg_of = np.empty(n + 1, dtype=np.int64)
        agg_of[:n] = np.arange(n) // m
        agg_of[n] = nagg
        self.agg_of = agg_of

    def mode_matrix(self, f):
        """Masked per-node affine mode matrices (n_pad, d, q), numpy f64;
        rows scaled by f = 1 - mask (n, d)."""
        d, n, n_pad = self.d, self.n, self.n_pad
        M = np.zeros((n_pad, d, self.q), dtype=np.float64)
        M[:, :, :d] = np.eye(d)
        for a in range(d):
            for c in range(d):
                M[:, a, d + a * d + c] = self.offsets[:, c]
        M[n:] = 0.0
        fp = np.zeros((n_pad, d))
        fp[:n] = np.asarray(f, dtype=np.float64)
        return M * fp[:, :, None]

    def mode_matrix_scalar(self, f):
        """Masked per-node scalar mode matrix (n_pad, qs), numpy f64; rows
        scaled by f = 1 - mask (n,)."""
        n, n_pad = self.n, self.n_pad
        M = np.zeros((n_pad, n_scalar_modes(self.d)), dtype=np.float64)
        M[:, 0] = 1.0
        M[:, 1:] = self.offsets
        M[n:] = 0.0
        fp = np.zeros(n_pad)
        fp[:n] = np.asarray(f, dtype=np.float64)
        return M * fp[:, None]

    # -- transfers (reshape only) --------------------------------------------

    def restrict(self, Mt, r):
        """P~ᵀ r: fine (n, d) -> coarse (nagg q,); Mt (n_pad, d, q)."""
        rp = torch.cat([r, r.new_zeros((self.n_pad - self.n, self.d))])
        per = (Mt * rp[:, :, None]).sum(dim=1)  # (n_pad, q)
        return per.reshape(self.nagg, self.m, -1).sum(dim=1).reshape(-1)

    def prolong(self, Mt, w):
        """P~ w: coarse (nagg q,) -> fine (n, d)."""
        wq = w.reshape(self.nagg, -1).repeat_interleave(self.m, dim=0)
        return (Mt * wq[:, None, :]).sum(dim=2)[: self.n]

    def restrict_scalar(self, Ms, r):
        """Ps~ᵀ r: fine (n,) -> coarse (nagg qs,); Ms (n_pad, qs)."""
        rp = torch.cat([r, r.new_zeros(self.n_pad - self.n)])
        per = Ms * rp[:, None]
        return per.reshape(self.nagg, self.m, -1).sum(dim=1).reshape(-1)

    def prolong_scalar(self, Ms, w):
        """Ps~ w: coarse (nagg qs,) -> fine (n,)."""
        wq = w.reshape(self.nagg, -1).repeat_interleave(self.m, dim=0)
        return (Ms * wq).sum(dim=1)[: self.n]


def _galerkin(plan: AggPlan, adj, ent, q, dtype, device, reg):
    """Scatter (n, K, q, q) coarse contributions into the dense
    (nagg q)² matrix and add the ridge that keeps masked-out and
    degenerate modes invertible."""
    n, nagg = plan.n, plan.nagg
    agg_of = torch.as_tensor(plan.agg_of, device=device)
    gi = agg_of[:n]
    gj = agg_of[adj].clamp(max=nagg - 1)  # sentinel columns carry zero ent
    dim_c = nagg * q
    p = torch.arange(q, device=device)
    rowc = gi[:, None, None, None] * q + p[None, None, :, None]
    colc = gj[:, :, None, None] * q + p[None, None, None, :]
    flat = (rowc * dim_c + colc).reshape(-1)
    Ac = torch.zeros(dim_c * dim_c, dtype=dtype, device=device)
    Ac = Ac.index_add_(0, flat, ent.reshape(-1)).reshape(dim_c, dim_c)
    dg = torch.diagonal(Ac)
    eps = reg * dg.max() + 1e-30
    fix = eps + (dg <= 0).to(dtype)
    return Ac + torch.diag(fix)


def build_coarse(plan: AggPlan, adj, B, mask_u, reg: float = 1e-8):
    """Dense Galerkin coarse matrix A_c = P~ᵀ A P~ (nagg q, nagg q) from
    node block-ELL values: ``adj`` (n, K) int64 (sentinel n), ``B``
    (n, K, d, d), ``mask_u`` (n, d) bool.  Once per model."""
    n, d, q = plan.n, plan.d, plan.q
    B = B.detach()
    f = 1.0 - mask_u.detach().cpu().numpy().astype(np.float64)
    Mi = torch.as_tensor(plan.mode_matrix(f)[:n], dtype=B.dtype,
                         device=B.device)  # (n, d, q)
    Mpad = torch.cat([Mi, Mi.new_zeros((1, d, q))])
    Mj = Mpad[adj.clamp(max=n)]  # (n, K, d, q)
    tmp = torch.einsum("nap,nkab->nkpb", Mi, B)
    ent = torch.einsum("nkpb,nkbq->nkpq", tmp, Mj)
    return _galerkin(plan, adj, ent, q, B.dtype, B.device, reg)


def build_coarse_scalar(plan: AggPlan, adj, W, mask_c, reg: float = 1e-8):
    """Dense Galerkin coarse matrix of the scalar rd Jacobian from node-ELL
    values ``W`` (n, K) with the affine scalar modes."""
    n = plan.n
    qs = n_scalar_modes(plan.d)
    W = W.detach()
    f = 1.0 - mask_c.detach().cpu().numpy().astype(np.float64)
    Mi = torch.as_tensor(plan.mode_matrix_scalar(f)[:n], dtype=W.dtype,
                         device=W.device)  # (n, qs)
    Mpad = torch.cat([Mi, Mi.new_zeros((1, qs))])
    Mj = Mpad[adj.clamp(max=n)]  # (n, K, qs)
    ent = Mi[:, None, :, None] * W[:, :, None, None] * Mj[:, :, None, :]
    return _galerkin(plan, adj, ent, qs, W.dtype, W.device, reg)


def coarse_inverse(Ac, droptol: float = 1e-7, k: int | None = None):
    """Gram factor B (dim_c, k) with B Bᵀ ≈ A_c⁻¹, from the f64
    eigendecomposition on the host; eigenvalues below droptol·λmax
    contribute nothing, and ``k`` keeps the k largest-weight columns (the
    smallest surviving eigenvalues).  Returned in Ac's dtype and device."""
    A = Ac.detach().cpu().double().numpy()
    lam, V = np.linalg.eigh(0.5 * (A + A.T))
    lmax = float(lam.max()) if len(lam) else 1.0
    inv_sqrt = np.where(lam > droptol * lmax,
                        1.0 / np.sqrt(np.maximum(lam, 1e-300)), 0.0)
    B = V * inv_sqrt[None, :]
    if k is not None and 0 < k < B.shape[1]:
        idx = np.argsort(-inv_sqrt, kind="stable")[:k]
        B = np.ascontiguousarray(B[:, idx])
    return torch.as_tensor(B, dtype=Ac.dtype, device=Ac.device)


def make_twolevel_precond(plan: AggPlan, B, Mt, base_apply):
    """M(r) = base_apply(r) + P~ B Bᵀ P~ᵀ r; Mt (n_pad, d, q)."""

    def M(r):
        rc = plan.restrict(Mt, r.to(B.dtype))
        w = B @ (B.T @ rc)
        return base_apply(r) + plan.prolong(Mt, w).to(r.dtype)

    return M


def make_twolevel_precond_scalar(plan: AggPlan, B, Ms, base_apply):
    """M(r) = base_apply(r) + Ps~ B Bᵀ Ps~ᵀ r; Ms (n_pad, qs)."""

    def M(r):
        rc = plan.restrict_scalar(Ms, r.to(B.dtype))
        w = B @ (B.T @ rc)
        return base_apply(r) + plan.prolong_scalar(Ms, w).to(r.dtype)

    return M
