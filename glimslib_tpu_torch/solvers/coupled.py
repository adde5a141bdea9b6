"""The coupled implicit-Euler step, forward only (counterpart of
``glimslib_tpu/solvers/coupled.py``).

The monolithic Jacobian of the coupled system is block-triangular (R_c
does not depend on u), so one Newton solve of it is exactly: Newton-CG on
the scalar c-block, then one SPD CG solve of the elasticity block with c
known.  Dirichlet conditions are enforced by masked projection.

This slice ports the branch the lattice lane takes: both linear solves go
through whole-solve PCG callables (``rd_cg``, ``el_cg``), with no warm
starts, no mixed-precision refinement and no Chebyshev preconditioning.
The Newton loop reads its residual norm on the host once per iteration;
the CG loops run inside their kernels.  The implicit-function-theorem
adjoint waits for the adjoint slice.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class StepConfig(NamedTuple):
    newton_rtol: float = 1e-9
    newton_atol: float = 1e-12
    newton_maxiter: int = 25
    cg_rtol: float = 1e-12
    cg_atol: float = 0.0
    cg_maxiter: int = 2000
    # Chebyshev degree on top of (block-)Jacobi; the port runs <= 1 only
    precond_degree: int = 0
    # mixed-precision refinement: not ported, True raises
    refine_f64: bool = False
    # The reference's refine_cg_rtol, rd_cg_rtol (inexact-Newton forcing)
    # and rd_modified_newton (chord method) are not fields here: its fused
    # whole-solve lattice path, the one ported, reads none of them.


def make_step(
    rd_residual: Callable,  # (c, c_prev, theta, t) -> (n,)
    el_residual: Callable,  # (u, c, theta, t) -> (n, d)
    mask_c,  # (n,) bool tensor
    mask_u,  # (n, d) bool tensor
    bc_values_c: Callable,  # (t) -> (n,)
    bc_values_u: Callable,  # (t) -> (n, d)
    config: StepConfig,
    rd_cg: Callable,  # (theta, c, rhs) -> (dc, info)
    el_cg: Callable,  # (theta, rhs) -> (du, info)
):
    """Build ``step(theta, u_prev, c_prev, t) -> (u, c, converged, n_newton)``.

    ``converged`` is a 0-d bool tensor on the state's device (it stays
    there: the elasticity CG's result is never read on the host);
    ``n_newton`` is a Python int."""
    cfg = config
    if rd_cg is None or el_cg is None:
        raise NotImplementedError(
            "only the whole-solve (rd_cg/el_cg) lattice branch is ported"
        )
    if cfg.refine_f64:
        raise NotImplementedError("refine_f64 (mixed-precision refinement) is not ported")
    if cfg.precond_degree > 1:
        raise NotImplementedError("Chebyshev preconditioning (precond_degree > 1) is not ported")

    def step(theta, u_prev, c_prev, t):
        gc = bc_values_c(t)
        gu = bc_values_u(t)

        # ---- c-block: Newton-CG ------------------------------------------
        def resid_c(c):
            return torch.where(mask_c, c - gc, rd_residual(c, c_prev, theta, t))

        c = torch.where(mask_c, gc, c_prev)
        r = resid_c(c)
        f0 = float(torch.linalg.vector_norm(r))
        ftol = max(cfg.newton_rtol * f0, cfg.newton_atol)
        fnorm, k, bad = f0, 0, False
        while k < cfg.newton_maxiter and fnorm > ftol and not bad:
            rhs = torch.where(mask_c, torch.zeros_like(r), -r)
            dc, _ = rd_cg(theta, c, rhs)
            c_new = c + dc
            r_new = resid_c(c_new)
            fn_new = float(torch.linalg.vector_norm(r_new))
            bad = not math.isfinite(fn_new) or fn_new > 1e10 * (f0 + 1.0)
            if not bad:
                c, r, fnorm = c_new, r_new, fn_new
            k += 1
        conv_c = fnorm <= max(ftol, cfg.newton_atol) and not bad

        # ---- u-block: one linear solve -----------------------------------
        u0 = torch.where(mask_u, gu, u_prev)
        ru = torch.where(mask_u, u0 - gu, el_residual(u0, c, theta, t))
        rhs_u = torch.where(mask_u, torch.zeros_like(ru), -ru)
        du, info_u = el_cg(theta, rhs_u)
        u = u0 + du
        # a stalled elasticity CG must freeze the trajectory like a failed
        # Newton: mirror pcg's own stopping test, plus finiteness
        tol_u = torch.clamp(cfg.cg_rtol * torch.linalg.vector_norm(rhs_u),
                            min=cfg.cg_atol)
        resnorm = info_u["resnorm"].to(tol_u.dtype)
        conv_u = torch.isfinite(resnorm) & (resnorm <= tol_u)
        return u, c, conv_u & conv_c, k

    return step
