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


def pcg(A, b, x0=None, M=None, rtol=1e-10, atol=0.0, maxiter=500):
    """Solve A x = b with preconditioned CG.

    A : callable(x) -> tensor, symmetric positive definite action
    M : callable(r) -> tensor, preconditioner (approx A^{-1})
    Returns (x, info) with info = dict(iters, resnorm) as 0-d tensors."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        M = lambda r: r  # noqa: E731
    x = x0
    r = b - A(x0)
    z = M(r)
    p = z
    rz = _dot(r, z)
    tol2 = max(rtol * float(torch.sqrt(_dot(b, b))), atol) ** 2
    k = 0
    while k < maxiter and float(_dot(r, r)) > tol2:
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
        k += 1
    return x, {
        "iters": torch.tensor(k, dtype=torch.int32, device=b.device),
        "resnorm": torch.sqrt(_dot(r, r)),
    }
