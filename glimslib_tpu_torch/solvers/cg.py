"""Preconditioned conjugate gradients and the Chebyshev polynomial
preconditioner (counterpart of ``glimslib_tpu/solvers/cg.py``: ``pcg``,
``cg_fixed_iters``, ``estimate_lmax``, ``make_chebyshev_precond``).

``pcg`` is the solver of the pcg and jvp branches (``solvers/coupled.py``)
and the plain reference of the whole-solve CUDA kernels in
``ops/fused_cg.py``: the same update order and the same stopping rule,
``rr <= max(rtol * |b|, atol)**2`` or ``maxiter``.  The loop reads ``rr``
on the host once per iteration; the kernels do not.  Its matvecs and
preconditioner applies, the polynomial's included, are the caller's: on
the card they launch the lanes' kernels.
"""

from __future__ import annotations

import torch


def _dot(a, b):
    return torch.sum(a * b)


def pcg(A, b, x0=None, M=None, rtol=1e-10, atol=0.0, maxiter=500, reduce=None):
    """Solve A x = b with preconditioned CG.

    A : callable(x) -> tensor, symmetric positive definite action
    M : callable(r) -> tensor, preconditioner (approx A^{-1})
    reduce : callable(t) -> t summed over the ranks of a group, for
        vectors that hold a rank's rows (the node-sharded lattice,
        ``parallel/gspmd.py``): every dot product is this rank's partial
        sum, reduced, with ``r.z`` and ``r.r`` in one collective, so every
        rank takes the same iterations.  None: the vectors are whole.
    Returns (x, info) with info = dict(iters, resnorm) as 0-d tensors."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        M = lambda r: r  # noqa: E731
    if reduce is None:
        reduce = lambda t: t  # noqa: E731
    x = x0
    r = b - A(x0)
    z = M(r)
    p = z
    rz, rr, bb = reduce(torch.stack([_dot(r, z), _dot(r, r), _dot(b, b)]))
    tol2 = max(rtol * float(torch.sqrt(bb)), atol) ** 2
    k = 0
    while k < maxiter and float(rr) > tol2:
        Ap = A(p)
        pAp = reduce(_dot(p, Ap).reshape(1))[0]
        alpha = rz / torch.where(pAp == 0, torch.ones_like(pAp), pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new, rr = reduce(torch.stack([_dot(r, z), _dot(r, r)]))
        beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
        p = z + beta * p
        rz = rz_new
        k += 1
    return x, {
        "iters": torch.tensor(k, dtype=torch.int32, device=b.device),
        "resnorm": torch.sqrt(rr),
    }


def cg_fixed_iters(A, b, x0=None, M=None, iters=50):
    """CG with a fixed iteration count: no host read and no early exit, so
    autograd differentiates through the whole loop (``A`` and ``M`` any
    differentiable callables, a kernel wrapper with its autograd rule
    included).  A zero ``p.Ap`` or ``r.z`` divides by 1 instead, so a
    converged solve keeps its iterate."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        M = lambda r: r  # noqa: E731
    x = x0
    r = b - A(x0)
    z = M(r)
    p = z
    rz = _dot(r, z)
    for _ in range(iters):
        Ap = A(p)
        pAp = _dot(p, Ap)
        alpha = rz / torch.where(pAp == 0, torch.ones_like(pAp), pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = _dot(r, z)
        beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
        p = z + beta * p
        rz = rz_new
    return x


def estimate_lmax(A, Minner, shape_like, dtype, iters=12, safety=1.1, device=None,
                  reduce=None, offset=0):
    """Largest eigenvalue of the preconditioned operator M⁻¹A (M = Jacobi or
    block-Jacobi) by power iteration from the deterministic start vector
    sin(0.7 i + 0.3), as the reference's ``estimate_lmax``.

    The estimate parameterizes the Chebyshev preconditioner only: it never
    changes the solution CG converges to, so it is computed without a
    graph (the reference's ``stop_gradient``).  ``reduce`` and ``offset``
    under node sharding: the vectors hold a rank's rows, the start vector
    is the rows of the whole one from flat index ``offset`` on, and every
    norm is this rank's partial sum reduced over the ranks."""
    if reduce is None:
        reduce = lambda t: t  # noqa: E731
    n = 1
    for s in shape_like:
        n *= s

    def norm(v):
        return torch.sqrt(reduce(_dot(v, v).reshape(1))[0])

    with torch.no_grad():
        i = torch.arange(offset, offset + n, dtype=dtype, device=device)
        v = torch.sin(i * 0.7 + 0.3).reshape(shape_like)
        v = v / norm(v)
        for _ in range(iters):
            w = Minner(A(v))
            nrm = norm(w)
            v = w / torch.clamp(nrm, min=1e-300)
    return nrm * safety


def make_chebyshev_precond(A, Minner, lmax, degree, lmin_factor=1.0 / 30.0):
    """Chebyshev polynomial preconditioner z = p_k(M⁻¹A) M⁻¹ r (the
    reference's ``make_chebyshev_precond``; Saad, Iterative Methods, alg.
    12.1): a fixed-degree Chebyshev iteration on the interval
    [lmin_factor lmax, lmax] of the M⁻¹A spectrum, ``Minner`` the inner
    (Jacobi or block-Jacobi) preconditioner.  A fixed polynomial in A
    composed with a symmetric M is a symmetric preconditioner, so plain CG
    stays valid; each application costs ``degree - 1`` matvecs.

    An even degree is rounded up to odd: above the targeted lmax the
    residual polynomial of an even degree can make lam p(lam) < 0, an
    indefinite preconditioner; an odd one keeps it positive for every lam
    > 0, so the estimate's safety factor moves the convergence rate only."""
    if degree % 2 == 0:
        degree = degree + 1
    lmin = lmin_factor * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta

    def M(r):
        z = Minner(r) / theta
        d = z
        rho = 1.0 / sigma1
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            resid = Minner(r - A(z))
            d = rho_new * rho * d + (2.0 * rho_new / delta) * resid
            z = z + d
            rho = rho_new
        return z

    return M
