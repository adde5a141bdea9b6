"""Assembled supernode halo-ELL operators for the P2 concentration space
(counterpart of ``glimslib_tpu/ops/p2_ell.py``).

The quad models' rd Jacobian is assembled into the same supernode
halo-ELL layout as the P1 operators (``ops/bell.py``, over the P2 dofs),
so each concentration CG iteration is one halo gather and one batched
matvec through the CUDA kernel ``bell_bmv``.

Exactness: the entries are integrated with the residual's degree-6 rule,
but the affine geometry factors every entry into constant reference
tensors contracted with small per-cell factors:

    M^e_ij         = det_e M0[i, j]
    (dt D K)^e_ij  = dt D_e det_e sum_ab T[i, j, a, b] (A_e A_e^T)_ab
    W(c)^e_ij      = det_e sum_k c^e_k C[i, j, k]

with M0 = Σ_q w φiφj, T = Σ_q w ∇̂φi ⊗ ∇̂φj, C = Σ_q w φiφjφk tabulated
once on the reference simplex (numpy, f64).  The assembled operator's
matvec equals the jvp of ``P2Kernels.rd_residual`` to round-off, so the
adjoint keeps exact gradients.

The chord operator replaces the consistent logistic correction by its
row sums, Σ_j W(c)_ij = det Σ_k c_k M0[i, k] (Σ_j φj = 1): Newton still
converges the exact residual.

The plan has the reference's s = 64 and a flat halo (the reference's
chunk-aligned halo, ``GLIMS_P2_HALO_CHUNK`` 4, gathers aligned 4-dof rows
for the TPU's row-rate-bound gathers; on the card it only adds zero
slots).  The reference's streamed residual helpers (``p2_mass_entries``,
``p2_cubic_residual``, behind ``GLIMS_P2STREAM``, off by default) are
not ported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from glimslib_tpu_torch.core.elements import P2Element, simplex_quadrature
from glimslib_tpu_torch.ops.bell import BellPlan


@functools.lru_cache(maxsize=None)
def p2_ref_tensors(dim: int, quad_degree: int = 6):
    """(M0, T, C) constant reference-simplex tensors (numpy f64):
    M0 (npe, npe), T (npe, npe, d, d), C (npe, npe, npe)."""
    qp, qw = simplex_quadrature(dim, quad_degree)
    vals, rgrads = P2Element(dim).tabulate(qp)  # (nq, npe), (nq, npe, d)
    M0 = np.sum(qw[:, None, None] * vals[:, :, None] * vals[:, None, :], axis=0)
    T = np.sum(
        qw[:, None, None, None, None]
        * rgrads[:, :, None, :, None] * rgrads[:, None, :, None, :],
        axis=0,
    )  # (i, j, a, b)
    C = np.sum(
        qw[:, None, None, None]
        * vals[:, :, None, None] * vals[:, None, :, None] * vals[:, None, None, :],
        axis=0,
    )  # (i, j, k)
    return M0, T, C


def make_p2_plan(p2k, s: int = 64, device=None):
    """Supernode halo-ELL plan over the P2 dof space (the interleaved
    Morton layout keeps contiguous supernodes compact), on ``device``
    (default: the kernels')."""
    return BellPlan(conn=p2k.cell_dofs, n=p2k.n_dofs, s=s, prefix="_P2B",
                    device=p2k.device if device is None else device)


def _ref(p2k, a):
    return torch.as_tensor(a, dtype=p2k.dtype, device=p2k.device)


def _geom(p2k):
    """(AAT (d, d, nc), det (nc,)) per-cell geometry factors, cell last."""
    A = p2k.A_T  # (a, d, nc): A[e, a, :] = grad(lambda_{a+1})
    AAT = (A[:, None, :, :] * A[None, :, :, :]).sum(dim=2)
    return AAT, p2k.detJ


def stiffness_geom(p2k):
    """(npe, npe, nc) Σ_ab T[i, j, a, b] (A Aᵀ)_ab: the unit-coefficient
    stiffness entries before det_e, summed over the d² geometry factors
    one at a time."""
    d, npe, nc = p2k.dim, p2k.npe, p2k.n_cells
    _, T_, _ = p2_ref_tensors(d)
    T = _ref(p2k, T_.reshape(npe * npe, d * d))
    AAT, _ = _geom(p2k)
    AAT2 = AAT.reshape(d * d, nc)
    K = T[:, 0, None] * AAT2[0][None, :]
    for ab in range(1, d * d):
        K = K + T[:, ab, None] * AAT2[ab][None, :]
    return K.reshape(npe, npe, nc)


def const_entries(p2k, D, rho, dt):
    """(npe, npe, nc) entries of M + dt D K - dt rho M."""
    M0 = _ref(p2k, p2_ref_tensors(p2k.dim)[0])
    _, det = _geom(p2k)
    D, rho = p2k._co(D), p2k._co(rho)
    return (((1.0 - dt * rho) * det) * M0[:, :, None]
            + (dt * D * det) * stiffness_geom(p2k))


def build_p2_rd_const(plan: BellPlan, p2k, D, rho, dt):
    """(nb, s, Kh) halo-ELL values of M + dt D K - dt rho M over P2."""
    return plan.assemble(const_entries(p2k, D, rho, dt))


def build_p2_rd_wc(plan: BellPlan, p2k, c, rho, dt, conc_max):
    """(nb, s, Kh) values of the logistic Jacobian correction
    +2 dt rho W(c)/c_max with W(c)_ij = ∫ c φi φj dx."""
    C = _ref(p2k, p2_ref_tensors(p2k.dim)[2])
    _, det = _geom(p2k)
    rho = p2k._co(rho)
    ceT = p2k.gather_T(c)  # (npe, nc)
    W = C[:, :, 0, None] * ceT[0][None, None, :]
    for k in range(1, p2k.npe):
        W = W + C[:, :, k, None] * ceT[k][None, None, :]
    return plan.assemble(((2.0 * dt / conc_max) * rho * det) * W)


def build_p2_rd_wc_lumped(p2k, c, rho, dt, conc_max):
    """(n_dofs,) row sums of :func:`build_p2_rd_wc` (the chord operator's
    lumped logistic diagonal): det Σ_k c_k M0[i, k] a cell."""
    M0 = _ref(p2k, p2_ref_tensors(p2k.dim)[0])
    _, det = _geom(p2k)
    rho = p2k._co(rho)
    ceT = p2k.gather_T(c)  # (npe, nc)
    rowsum_T = (M0[:, :, None] * ceT[None, :, :]).sum(dim=1)
    return p2k.scatter_T(((2.0 * dt / conc_max) * rho * det) * rowsum_T)
