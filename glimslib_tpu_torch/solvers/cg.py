"""Preconditioned conjugate gradients (counterpart of
``glimslib_tpu/solvers/cg.py:pcg``).

The solver of the unstructured lane's pcg branch (``solvers/coupled.py``)
and the plain reference of the whole-solve CUDA kernels in
``ops/fused_cg.py``: the same update order and the same stopping rule,
``rr <= max(rtol * |b|, atol)**2`` or ``maxiter``.  The loop reads ``rr``
on the host once per iteration; the kernels do not.
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
