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
computed in f64 from an eigendecomposition, as the reference does (on
the model's device: the reference's runs on the host).  The preconditioner is the additive

    M(r) = base(r) + P~ B Bᵀ P~ᵀ r

whose coarse term is positive semidefinite in any float precision.

On f32 runs the factor is stored in bf16, as in the reference's
default (the factor's stream is the coarse apply's cost, and the Gram
form stays positive semidefinite under rounding).  Its two products then take bf16 operands and accumulate and
return float32 (:func:`_gemv_f32`): on the card ``torch.mm`` with
``out_dtype=torch.float32`` (cuBLAS; the reference's ``jnp.dot`` with
``preferred_element_type``, outside any Pallas kernel), on the CPU the
bf16 factor upcast to float32, which gives the same products.  Bᵀ rc
reads a row-major copy of Bᵀ where the caller keeps one (``Bt``): cuBLAS
runs the bf16 product over a transposed view at about half the rate of
a row-major one (an NVIDIA H100, ``PERF.md``).  The
node-axis-last (TPU lane) layouts of the mode matrices are not ported.

Under block sharding (``Simulation.use_sharding(mode="bell")``) rank r
holds the aggregates [a0, a1) of :func:`coarse_slab`: the factor's rows
of their modes and the mode matrices' rows of their nodes.  Its
restriction is then exactly its own coarse rows, Bᵀ rc is a sum of the
ranks' partial products (one ``all_reduce`` of k values), B z gives its
own rows again, and the prolongation its own nodes, gathered into the
replicated result (one more collective).
"""

from __future__ import annotations

from typing import NamedTuple

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

    # -- transfers (reshape only), over the aggregates [a0, a1) (default:
    # all; under block sharding a rank's, Mt then their nodes' rows) -------

    def _own_nodes(self, r, a0, a1):
        """Rows [a0 m, a1 m) of r (n, ...) zero-padded to n_pad rows."""
        lo, hi = a0 * self.m, a1 * self.m
        own = r[lo:min(hi, self.n)]
        if own.shape[0] < hi - lo:
            own = torch.cat([own, own.new_zeros((hi - lo - own.shape[0],)
                                                + tuple(r.shape[1:]))])
        return own

    def restrict(self, Mt, r, a0=0, a1=None):
        """P~ᵀ r: fine (n, d) -> coarse ((a1 - a0) q,); Mt (m (a1 - a0), d, q)."""
        a1 = self.nagg if a1 is None else a1
        per = (Mt * self._own_nodes(r, a0, a1)[:, :, None]).sum(dim=1)
        return per.reshape(a1 - a0, self.m, -1).sum(dim=1).reshape(-1)

    def prolong(self, Mt, w, a0=0, a1=None):
        """P~ w: coarse ((a1 - a0) q,) -> fine (m (a1 - a0), d) at the
        aggregates' nodes (padded rows included)."""
        a1 = self.nagg if a1 is None else a1
        wq = w.reshape(a1 - a0, -1).repeat_interleave(self.m, dim=0)
        return (Mt * wq[:, None, :]).sum(dim=2)

    def restrict_scalar(self, Ms, r, a0=0, a1=None):
        """Ps~ᵀ r: fine (n,) -> coarse ((a1 - a0) qs,); Ms (m (a1 - a0), qs)."""
        a1 = self.nagg if a1 is None else a1
        per = Ms * self._own_nodes(r, a0, a1)[:, None]
        return per.reshape(a1 - a0, self.m, -1).sum(dim=1).reshape(-1)

    def prolong_scalar(self, Ms, w, a0=0, a1=None):
        """Ps~ w: coarse ((a1 - a0) qs,) -> fine (m (a1 - a0),)."""
        a1 = self.nagg if a1 is None else a1
        wq = w.reshape(a1 - a0, -1).repeat_interleave(self.m, dim=0)
        return (Ms * wq).sum(dim=1)


class CoarseSlab(NamedTuple):
    """Rank ``mesh.rank``'s aggregates [a0, a1) of an :class:`AggPlan`."""

    mesh: object
    a0: int
    a1: int


def coarse_slab(plan: AggPlan, mesh) -> CoarseSlab:
    """The aggregates of ``mesh.rank``: an even split of the nagg
    contiguous aggregates (off by one where world does not divide it)."""
    r, w = mesh.rank, mesh.world
    return CoarseSlab(mesh, r * plan.nagg // w, (r + 1) * plan.nagg // w)


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
    eigendecomposition on Ac's device (the reference takes numpy's on the
    host; PERF.md has both times on the card); eigenvalues
    below droptol·λmax contribute nothing, and ``k`` keeps the k
    largest-weight columns (the smallest surviving eigenvalues).  Returned
    in Ac's dtype and device."""
    A = Ac.detach().double()
    lam, V = torch.linalg.eigh(0.5 * (A + A.T))
    lmax = float(lam.max()) if len(lam) else 1.0
    inv_sqrt = torch.where(lam > droptol * lmax,
                           1.0 / torch.sqrt(torch.clamp(lam, min=1e-300)), 0.0)
    B = V * inv_sqrt[None, :]
    if k is not None and 0 < k < B.shape[1]:
        idx = torch.argsort(-inv_sqrt, stable=True)[:k]
        B = B[:, idx].contiguous()
    return B.to(Ac.dtype)


def _gemv_f32(A, x):
    """A @ x for a bf16 matrix A and bf16 vector x, accumulated in and
    returned as float32 (never a bf16 result)."""
    if A.is_cuda:
        return torch.mm(A, x[:, None], out_dtype=torch.float32)[:, 0]
    return A.float() @ x.float()


def _coarse_apply(B, rc, Bt=None, reduce=None):
    """B Bᵀ rc: in the working dtype, or, for a bf16 factor, z = Bᵀ rc
    and w = B z each from bf16 operands in float32 (z rounded to bf16
    between them); returns w as float32 in the bf16 case.  ``Bt``: a
    row-major copy of Bᵀ, or None (the transposed view).  ``reduce``
    sums the ranks' partial z where B holds a rank's rows."""
    if B.dtype != torch.bfloat16:
        z = B.T @ rc
        return B @ (z if reduce is None else reduce(z))
    z = _gemv_f32(B.T if Bt is None else Bt, rc.to(torch.bfloat16))
    if reduce is not None:
        z = reduce(z)
    return _gemv_f32(B, z.to(torch.bfloat16))


def _twolevel(plan: AggPlan, B, Mt, base_apply, Bt, slab, restrict, prolong):
    """M(r) = base_apply(r) + P B Bᵀ Pᵀ r with the transfers ``restrict``
    and ``prolong`` of ``plan`` (vector or scalar): on a rank's
    aggregates under ``slab``, which then sums the partial Bᵀ rc and
    gathers the prolonged nodes."""
    bf16 = B.dtype == torch.bfloat16
    a0, a1 = (0, plan.nagg) if slab is None else slab[1:]
    reduce = None if slab is None else slab.mesh.all_reduce

    def M(r):
        rc = restrict(Mt, r if bf16 else r.to(B.dtype), a0, a1)
        fine = prolong(Mt.float() if bf16 else Mt, _coarse_apply(B, rc, Bt, reduce),
                       a0, a1)
        if slab is not None:
            fine = slab.mesh.gather_rows(fine, a0 * plan.m, plan.n_pad)
        return base_apply(r) + fine[: plan.n].to(r.dtype)

    return M


def make_twolevel_precond(plan: AggPlan, B, Mt, base_apply, Bt=None, slab=None):
    """M(r) = base_apply(r) + P~ B Bᵀ P~ᵀ r; Mt (n_pad, d, q) in the
    working dtype.  A bf16 ``B`` is restricted against in the working
    dtype and prolonged in float32; ``Bt`` as :func:`_coarse_apply`.
    ``slab`` (:class:`CoarseSlab`): B and Mt hold the rank's aggregates'
    rows (module docstring)."""
    return _twolevel(plan, B, Mt, base_apply, Bt, slab, plan.restrict, plan.prolong)


def make_twolevel_precond_scalar(plan: AggPlan, B, Ms, base_apply, Bt=None, slab=None):
    """M(r) = base_apply(r) + Ps~ B Bᵀ Ps~ᵀ r; Ms (n_pad, qs), as
    :func:`make_twolevel_precond`."""
    return _twolevel(plan, B, Ms, base_apply, Bt, slab, plan.restrict_scalar,
                     plan.prolong_scalar)
