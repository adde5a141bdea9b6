"""Matrix-free Newton for nonlinear residual systems (counterpart of
``glimslib_tpu/solvers/newton.py``).

Newton-CG on ``residual(x) = 0``: the Jacobian action is the
``torch.func.jvp`` of the residual at the current iterate, the linear
solve is :func:`~glimslib_tpu_torch.solvers.cg.pcg` with an optional
Jacobi diagonal.  Convergence: ||F|| below ``max(rtol ||F(x0)||,
atol)``.  A step whose residual norm is not finite or exceeds 1e8
(||F(x0)|| + 1) is rejected: the iterate stays and the loop stops, and
the result is reported as not converged.  The loop is a Python loop
that reads the residual norm on the host once an iteration.
"""

from __future__ import annotations

import math

import torch

from glimslib_tpu_torch.solvers.cg import pcg


def newton(residual, x0, precond_diag=None, rtol=1e-8, atol=1e-10, maxiter=25,
           cg_rtol=1e-10, cg_maxiter=1000):
    """Solve ``residual(x) = 0`` by Newton-CG from ``x0``.

    ``residual``: callable x -> tensor shaped like x, differentiable by
    ``torch.func.jvp``; ``precond_diag``: optional diagonal (shaped like
    x) for Jacobi-preconditioned CG.  Returns ``(x, converged, info)``
    with ``converged`` a Python bool and ``info`` = {"fnorm": float,
    "iters": int}."""
    M = None if precond_diag is None else (lambda r: r / precond_diag)
    f0 = float(torch.linalg.vector_norm(residual(x0)))
    ftol = max(rtol * f0, atol)
    x, fnorm, k, stalled = x0, f0, 0, False
    while k < maxiter and fnorm > ftol and not stalled:
        r = residual(x)
        xk = x

        def A(v):
            return torch.func.jvp(residual, (xk,), (v,))[1]

        dx, _ = pcg(A, -r, M=M, rtol=cg_rtol, maxiter=cg_maxiter)
        x_new = x + dx
        fnorm_new = float(torch.linalg.vector_norm(residual(x_new)))
        stalled = not math.isfinite(fnorm_new) or fnorm_new > 1e8 * (f0 + 1.0)
        if not stalled:
            x, fnorm = x_new, fnorm_new
        k += 1
    return x, fnorm <= ftol and not stalled, {"fnorm": fnorm, "iters": k}
