"""The coupled implicit-Euler step, forward only (counterpart of
``glimslib_tpu/solvers/coupled.py``).

The monolithic Jacobian of the coupled system is block-triangular (R_c
does not depend on u), so one Newton solve of it is exactly: Newton-CG on
the scalar c-block, then one SPD CG solve of the elasticity block with c
known.  Dirichlet conditions are enforced by masked projection.

Two branches of the reference are ported:

- the lattice lane's whole-solve branch: both linear solves go through
  whole-solve PCG callables (``rd_cg``, ``el_cg``, the CUDA kernel
  ``stencil_pcg``), with no warm starts;
- the assembled-operator ``pcg`` branch of the unstructured lane:
  ``rd_jacobian`` / ``el_operator`` actions with ``rd_precond`` /
  ``el_precond``, the chord method (the rd Jacobian frozen at the step's
  start, from ``rd_jacobian_chord`` when given), inexact-Newton forcing
  (``rd_cg_rtol``), and extrapolated warm starts whose tolerances stay
  anchored at the unextrapolated points (``guess``, ``anchor_c``).

The Newton and CG loops read their residual norms on the host once per
iteration (the whole-solve kernels keep theirs on the device).  No
mixed-precision refinement, no Chebyshev preconditioning; the
implicit-function-theorem adjoint waits for the adjoint slice.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from glimslib_tpu_torch.solvers.cg import pcg


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
    # inexact-Newton forcing for the c-block CG of the pcg branch: 0.0
    # uses cg_rtol (the reference's refine_cg_rtol is not a field: it is
    # read by refinement only)
    rd_cg_rtol: float = 0.0
    # chord method on the pcg branch: the rd Jacobian frozen at the
    # step's start; Newton still converges on the exact residual
    rd_modified_newton: bool = True


def _masked_op(raw_op, mask):
    """Identity on masked dofs, raw_op on the free ones."""
    return lambda v: torch.where(mask, v, raw_op(torch.where(mask, 0.0, v)))


def make_step(
    rd_residual: Callable,  # (c, c_prev, theta, t) -> (n,)
    el_residual: Callable,  # (u, c, theta, t) -> (n, d)
    mask_c,  # (n,) bool tensor
    mask_u,  # (n, d) bool tensor
    bc_values_c: Callable,  # (t) -> (n,)
    bc_values_u: Callable,  # (t) -> (n, d)
    config: StepConfig,
    rd_cg: Callable = None,  # (theta, c, rhs) -> (dc, info)
    el_cg: Callable = None,  # (theta, rhs) -> (du, info)
    rd_jacobian: Callable = None,  # (theta, c) -> callable(v) = J_cc v
    el_operator: Callable = None,  # (theta) -> callable(u) = A_uu u
    rd_precond: Callable = None,  # (theta) -> callable(r) ~ J_cc^-1 r
    el_precond: Callable = None,  # (theta) -> callable(r) ~ A_uu^-1 r
    rd_jacobian_chord: Callable = None,  # cheaper frozen-Jacobian source
    record: Callable = None,  # (kind "rd" | "el", pcg info) per pcg solve
):
    """Build ``step(theta, u_prev, c_prev, t, guess=None, anchor_c=None)
    -> (u, c, converged, n_newton)``.

    ``guess`` = (u_guess, c_guess): extrapolated warm starts for the pcg
    branch (ignored by the whole-solve branch); ``anchor_c`` the
    caller's ||r_c(c_prev)||, which then replaces its evaluation.
    ``converged`` is a 0-d bool tensor on the state's device;
    ``n_newton`` is a Python int."""
    cfg = config
    whole_solve = rd_cg is not None and el_cg is not None
    assembled = None not in (rd_jacobian, el_operator, rd_precond, el_precond)
    if not (whole_solve or assembled):
        raise NotImplementedError(
            "make_step runs the whole-solve (rd_cg, el_cg) branch or the "
            "assembled-operator pcg branch (rd_jacobian, el_operator, "
            "rd_precond, el_precond)"
        )
    if cfg.refine_f64:
        raise NotImplementedError("refine_f64 (mixed-precision refinement) is not ported")
    if cfg.precond_degree > 1:
        raise NotImplementedError("Chebyshev preconditioning (precond_degree > 1) is not ported")
    freeze_jac = cfg.rd_modified_newton and not whole_solve
    chord_src = rd_jacobian_chord or rd_jacobian

    def _pcg(kind, A, b, M, rtol, atol):
        x, info = pcg(A, b, M=M, rtol=rtol, atol=atol, maxiter=cfg.cg_maxiter)
        if record is not None:
            record(kind, info)
        return x, info

    def step(theta, u_prev, c_prev, t, guess=None, anchor_c=None):
        gc = bc_values_c(t)
        gu = bc_values_u(t)
        warm = guess is not None and not whole_solve

        # ---- c-block: Newton-CG ------------------------------------------
        def resid_c(c):
            return torch.where(mask_c, c - gc, rd_residual(c, c_prev, theta, t))

        if not whole_solve:
            Mc = _masked_op(rd_precond(theta), mask_c)
        c = torch.where(mask_c, gc, c_prev)
        if warm and anchor_c is not None:
            f0 = float(anchor_c)
        else:
            r = resid_c(c)
            f0 = float(torch.linalg.vector_norm(r))
        ftol = max(cfg.newton_rtol * f0, cfg.newton_atol)
        if warm:
            # start at the extrapolated guess; ftol stays anchored at f0
            c = torch.where(mask_c, gc, guess[1])
            r = resid_c(c)
            f0 = float(torch.linalg.vector_norm(r))
        A_frozen = _masked_op(chord_src(theta, c), mask_c) if freeze_jac else None

        fnorm, k, bad = f0, 0, False
        while k < cfg.newton_maxiter and fnorm > ftol and not bad:
            rhs = torch.where(mask_c, torch.zeros_like(r), -r)
            if whole_solve:
                dc, _ = rd_cg(theta, c, rhs)
            else:
                A = (A_frozen if freeze_jac
                     else _masked_op(rd_jacobian(theta, c), mask_c))
                dc, _ = _pcg("rd", A, rhs, Mc, cfg.rd_cg_rtol or cfg.cg_rtol,
                             cfg.cg_atol)
            c_new = c + dc
            r_new = resid_c(c_new)
            fn_new = float(torch.linalg.vector_norm(r_new))
            bad = not math.isfinite(fn_new) or fn_new > 1e10 * (f0 + 1.0)
            if not bad:
                c, r, fnorm = c_new, r_new, fn_new
            k += 1
        conv_c = fnorm <= max(ftol, cfg.newton_atol) and not bad

        # ---- u-block: one linear solve -----------------------------------
        def resid_u(u):
            return torch.where(mask_u, u - gu, el_residual(u, c, theta, t))

        u0 = torch.where(mask_u, gu, u_prev)
        ru = resid_u(u0)
        if warm:
            # CG tolerance anchored at ||r(u_prev)||; iterate from the guess
            anchor_u = torch.linalg.vector_norm(torch.where(mask_u, 0.0, ru))
            u0 = torch.where(mask_u, gu, guess[0])
            ru = resid_u(u0)
        rhs_u = torch.where(mask_u, torch.zeros_like(ru), -ru)
        if whole_solve:
            du, info_u = el_cg(theta, rhs_u)
        else:
            Au = _masked_op(el_operator(theta), mask_u)
            Mu = _masked_op(el_precond(theta), mask_u)
            if warm:
                atol = max(cfg.cg_rtol * float(anchor_u), cfg.cg_atol)
                du, info_u = _pcg("el", Au, rhs_u, Mu, 0.0, atol)
            else:
                du, info_u = _pcg("el", Au, rhs_u, Mu, cfg.cg_rtol, cfg.cg_atol)
        u = u0 + du
        # a stalled elasticity CG must freeze the trajectory like a failed
        # Newton: mirror pcg's own stopping test, plus finiteness
        rhs_norm = anchor_u if warm else torch.linalg.vector_norm(rhs_u)
        tol_u = torch.clamp(cfg.cg_rtol * rhs_norm, min=cfg.cg_atol)
        resnorm = info_u["resnorm"].to(tol_u.dtype)
        conv_u = torch.isfinite(resnorm) & (resnorm <= tol_u)
        return u, c, conv_u & conv_c, k

    return step
