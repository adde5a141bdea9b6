"""The coupled implicit-Euler step and its implicit-function-theorem
adjoint (counterpart of ``glimslib_tpu/solvers/coupled.py``).

The monolithic Jacobian of the coupled system is block-triangular (R_c
does not depend on u), so one Newton solve of it is exactly: Newton-CG on
the scalar c-block, then one SPD CG solve of the elasticity block with c
known.  Dirichlet conditions are enforced by masked projection.

Three branches of the reference are ported:

- the lattice lane's whole-solve branch: both linear solves go through
  whole-solve PCG callables (``rd_cg``, ``el_cg``, the CUDA kernel
  ``stencil_pcg``), with no warm starts;
- the assembled-operator ``pcg`` branch of the unstructured lane:
  ``rd_jacobian`` / ``el_operator`` actions with ``rd_precond`` /
  ``el_precond``, the chord method (the rd Jacobian frozen at the step's
  start, from ``rd_jacobian_chord`` when given), inexact-Newton forcing
  (``rd_cg_rtol``), and extrapolated warm starts whose tolerances stay
  anchored at the unextrapolated points (``guess``, ``anchor_c``);
- the matrix-free jvp branch (the reference's ``_masked_operator``),
  taken by a block whose operator is not given: its operator is the
  identity on masked dofs and, elsewhere, the ``torch.func.jvp`` of the
  masked WORKING-dtype residual at the current iterate (under refinement
  too: Newton measures the f64 residual, the jvp differentiates the
  working one), preconditioned by ``rd_precond`` / ``el_precond``; a jvp
  rd block's Jacobian is exact every Newton iteration.  The forward runs
  under ``no_grad``, which forward-mode AD ignores.

Outside the whole-solve branch each block takes its branch alone, as in
the reference (``coupled.py:255, 309, 366, 457, 478``): the assembled
operator where the model gives it, else the jvp, forward, refined and in
the adjoint, so a model may run its elasticity block on an assembled
operator beside a jvp rd block (the quad models under ``GLIMS_BELL=0`` or
``GLIMS_P2BELL=0``).  The chord method needs an assembled rd block.

The Newton and CG loops read their residual norms on the host once per
iteration (the whole-solve kernels keep theirs on the device).

Chebyshev preconditioning (``StepConfig.precond_degree > 1``, the
reference's ``coupled.py:247-260, 313-318, 370-376, 461-466, 490-495``):
on the pcg and jvp branches every solve, forward and adjoint, takes the
polynomial ``make_chebyshev_precond`` of its operator around the block's
(masked) preconditioner.  Its spectral bound is theta's ``_lmax_c`` /
``_lmax_u`` where the model precomputed them once a simulate (the
lattice), else a power iteration (``estimate_lmax``): the rd bound once
a step at the clamped ``c_prev`` on the exact Jacobian, the elasticity
bound once a solve.  The whole-solve branch never takes the polynomial.

Node sharding (``parallel/gspmd.py``, ``parallel/nodeshard.py``): with a
``reduce`` hook the state and every vector hold a rank's rows (from
global row ``row_start`` on), and every norm, sum, CG dot product and
power-iteration norm is this rank's partial sum reduced over the ranks,
so every convergence decision is the same on all of them.

Mixed-precision refinement (``refine_f64``, on an f32 state): the solves
stay in the working dtype, but Newton measures and corrects against the
f64 residuals ``rd_residual_hi`` / ``el_residual_hi`` (downcast), the rd
Jacobian is exact every iteration (no chord method), the elasticity
right side comes from the f64 residual, and one correction solve of the
f64 defect at ``refine_cg_rtol`` follows the elasticity solve (the
reference's ``coupled.py:203-233, 278-284, 353-362, 408-428``).  The f64
residuals read theta's physical coefficients only (keys without a
leading underscore), which are cast to f64 once a step.

Gradients (the reference's ``custom_vjp`` ``step_bwd``): where grad is
enabled and the state or a theta tensor requires it, the step runs as one
``torch.autograd.Function`` whose forward is the solve above under
``no_grad`` and whose backward, given (u_bar, c_bar) at the converged
(u, c), solves the two adjoint systems with the forward's own solvers
(the whole-solve kernels, or ``pcg`` with the EXACT rd Jacobian, never
the chord operator, or on the jvp branch the jvp operators at the
converged state, both blocks being symmetric) and takes the residual VJPs with
``torch.autograd.grad``:

    A_uu^T lam_u = u_bar
    J_cc^T lam_c = c_bar - (dR_u/dc)^T lam_u
    theta_bar = -(dR_u/dtheta^T lam_u + dR_c/dtheta^T lam_c)
    c_prev_bar = -(dR_c/dc_prev)^T lam_c,  u_prev_bar = 0

The warm-start guess and the anchored tolerance do not change the
converged state: they get no gradient.  Theta tensors that only feed
preconditioners get none either (nothing of the residuals reads them).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
from torch.autograd.function import once_differentiable

from glimslib_tpu_torch.solvers.cg import estimate_lmax, make_chebyshev_precond, pcg


class StepConfig(NamedTuple):
    newton_rtol: float = 1e-9
    newton_atol: float = 1e-12
    newton_maxiter: int = 25
    cg_rtol: float = 1e-12
    cg_atol: float = 0.0
    cg_maxiter: int = 2000
    # Chebyshev degree on top of the blocks' preconditioners (> 1: on; an
    # even degree is rounded up to odd)
    precond_degree: int = 0
    # mixed-precision refinement: f64 residuals around the working-dtype
    # solves, plus one elasticity correction solve (module docstring);
    # no effect on an f64 state
    refine_f64: bool = False
    # relative tolerance of that correction solve (0.0 uses cg_rtol): the
    # defect is already ~cg_rtol of the load, and 1e-2 reaches the
    # refinement's fixed point in the one pass
    refine_cg_rtol: float = 1e-2
    # inexact-Newton forcing for the c-block CG of the pcg branch: 0.0
    # uses cg_rtol
    rd_cg_rtol: float = 0.0
    # chord method on the pcg branch: the rd Jacobian frozen at the
    # step's start; Newton still converges on the exact residual
    rd_modified_newton: bool = True


def _masked_op(raw_op, mask):
    """Identity on masked dofs, raw_op on the free ones."""
    return lambda v: torch.where(mask, v, raw_op(torch.where(mask, 0.0, v)))


def _masked_operator(resid, x, mask):
    """The jvp branch's SPD operator: identity on masked dofs, the jvp of
    ``resid`` at ``x`` (P J P) elsewhere."""
    return _masked_op(lambda v: torch.func.jvp(resid, (x,), (v,))[1], mask)


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
    record: Callable = None,  # (kind "rd" | "el" | "el_refine" | "rd_adj" | "el_adj", info)
    rd_residual_hi: Callable = None,  # f64 residuals for refine_f64
    el_residual_hi: Callable = None,
    reduce: Callable = None,  # (t) -> t summed over the ranks (node sharding)
    row_start: int = 0,  # the global row of the vectors' first row (node sharding)
):
    """Build ``step(theta, u_prev, c_prev, t, guess=None, anchor_c=None)
    -> (u, c, converged, n_newton)``.

    ``guess`` = (u_guess, c_guess): extrapolated warm starts for the pcg
    branch (ignored by the whole-solve branch); ``anchor_c`` the
    caller's ||r_c(c_prev)||, which then replaces its evaluation.
    ``el_cg`` takes an ``rtol`` keyword for the refinement's correction
    solve.
    ``converged`` is a 0-d bool tensor on the state's device;
    ``n_newton`` is a Python int.  Differentiable in the state and in
    theta's floating tensors (module docstring).  Every linear solve,
    forward or adjoint, on either branch, is reported to ``record``."""
    cfg = config
    whole_solve = rd_cg is not None and el_cg is not None
    pcg_branch = (rd_cg is None and el_cg is None
                  and None not in (rd_precond, el_precond))
    if not (whole_solve or pcg_branch):
        raise ValueError(
            "make_step runs the whole-solve (rd_cg, el_cg) branch or the pcg "
            "branch (rd_precond, el_precond, with rd_jacobian and el_operator "
            "where a block has an assembled operator, else its jvp)"
        )
    # the pcg branch's blocks: assembled operator, else the jvp
    jvp_c = pcg_branch and rd_jacobian is None
    jvp_u = pcg_branch and el_operator is None
    if cfg.refine_f64 and None in (rd_residual_hi, el_residual_hi):
        raise ValueError("refine_f64 needs rd_residual_hi and el_residual_hi")
    chord_src = rd_jacobian_chord or rd_jacobian
    refine_rtol = cfg.refine_cg_rtol or cfg.cg_rtol

    if reduce is None:
        norm = torch.linalg.vector_norm
        total = torch.sum
    else:
        def norm(x):
            return torch.sqrt(reduce(torch.sum(x * x).reshape(1))[0])

        def total(x):
            return reduce(torch.sum(x).reshape(1))[0]

    def _recorded(kind, x_info):
        if record is not None:
            record(kind, x_info[1])
        return x_info

    def _pcg(kind, A, b, M, rtol, atol):
        return _recorded(kind, pcg(A, b, M=M, rtol=rtol, atol=atol,
                                   maxiter=cfg.cg_maxiter, reduce=reduce))

    cheb = cfg.precond_degree > 1 and not whole_solve

    def lmax(theta, key, A, M, x):
        """theta's precomputed spectral bound ``key``, else the power
        iteration's on ``A`` preconditioned by ``M`` (vectors like ``x``)."""
        if key in theta:
            return theta[key]
        return estimate_lmax(A, M, tuple(x.shape), x.dtype, device=x.device,
                             reduce=reduce, offset=row_start * x[0].numel())

    def poly(A, M, bound):
        """The Chebyshev polynomial preconditioner of ``A`` around ``M``."""
        return make_chebyshev_precond(A, M, bound, cfg.precond_degree)

    def solve(theta, u_prev, c_prev, t, guess=None, anchor_c=None):
        gc = bc_values_c(t)
        gu = bc_values_u(t)
        warm = guess is not None and not whole_solve
        refine = cfg.refine_f64 and c_prev.dtype != torch.float64
        # the accuracy mode keeps the exact Jacobian every Newton iteration:
        # the chord method lands just under ftol, which costs its margin
        freeze_jac = (cfg.rd_modified_newton and pcg_branch and not jvp_c
                      and not refine)

        # ---- c-block: Newton-CG ------------------------------------------
        def resid_c_work(c):
            return torch.where(mask_c, c - gc, rd_residual(c, c_prev, theta, t))

        # what Newton measures and corrects against: the working residual,
        # or (refine) the f64 one, downcast; the jvp branch differentiates
        # the working one
        if refine:
            f64 = torch.float64
            theta_hi = {k: v.to(f64) if (torch.is_tensor(v) and v.is_floating_point()
                                         and not k.startswith("_")) else v
                        for k, v in theta.items()}
            c_prev_hi = c_prev.to(f64)

            def resid_c(c):
                r = rd_residual_hi(c.to(f64), c_prev_hi, theta_hi, t)
                return torch.where(mask_c, (c - gc).to(f64), r).to(c.dtype)
        else:
            resid_c = resid_c_work

        if not whole_solve:
            Mc = _masked_op(rd_precond(theta), mask_c)
        c = torch.where(mask_c, gc, c_prev)
        if cheb:
            # the bound once a step, at the clamped c_prev, on the exact
            # Jacobian (the chord operator and the guess come after)
            A0 = (_masked_operator(resid_c_work, c, mask_c) if jvp_c
                  else _masked_op(rd_jacobian(theta, c), mask_c))
            lmax_c = lmax(theta, "_lmax_c", A0, Mc, c)
        if warm and anchor_c is not None:
            f0 = float(anchor_c)
        else:
            r = resid_c(c)
            f0 = float(norm(r))
        ftol = max(cfg.newton_rtol * f0, cfg.newton_atol)
        if warm:
            # start at the extrapolated guess; ftol stays anchored at f0
            c = torch.where(mask_c, gc, guess[1])
            r = resid_c(c)
            f0 = float(norm(r))
        A_frozen = _masked_op(chord_src(theta, c), mask_c) if freeze_jac else None

        fnorm, k, bad = f0, 0, False
        while k < cfg.newton_maxiter and fnorm > ftol and not bad:
            rhs = torch.where(mask_c, torch.zeros_like(r), -r)
            if whole_solve:
                dc, _ = _recorded("rd", rd_cg(theta, c, rhs))
            else:
                if jvp_c:
                    A = _masked_operator(resid_c_work, c, mask_c)
                else:
                    A = (A_frozen if freeze_jac
                         else _masked_op(rd_jacobian(theta, c), mask_c))
                dc, _ = _pcg("rd", A, rhs, poly(A, Mc, lmax_c) if cheb else Mc,
                             cfg.rd_cg_rtol or cfg.cg_rtol, cfg.cg_atol)
            c_new = c + dc
            r_new = resid_c(c_new)
            fn_new = float(norm(r_new))
            bad = not math.isfinite(fn_new) or fn_new > 1e10 * (f0 + 1.0)
            if not bad:
                c, r, fnorm = c_new, r_new, fn_new
            k += 1
        conv_c = fnorm <= max(ftol, cfg.newton_atol) and not bad

        # ---- u-block: one linear solve -----------------------------------
        def resid_u_work(u):
            return torch.where(mask_u, u - gu, el_residual(u, c, theta, t))

        if refine:
            c_hi = c.to(f64)

            def resid_u(u):
                r = el_residual_hi(u.to(f64), c_hi, theta_hi, t)
                return torch.where(mask_u, (u - gu).to(f64), r).to(u.dtype)
        else:
            resid_u = resid_u_work

        u0 = torch.where(mask_u, gu, u_prev)
        ru = resid_u(u0)
        if warm:
            # CG tolerance anchored at ||r(u_prev)||; iterate from the guess
            anchor_u = norm(torch.where(mask_u, 0.0, ru))
            u0 = torch.where(mask_u, gu, guess[0])
            ru = resid_u(u0)
        rhs_u = torch.where(mask_u, torch.zeros_like(ru), -ru)
        if whole_solve:
            du, info_u = _recorded("el", el_cg(theta, rhs_u))
        else:
            # the elasticity residual is affine in u: its jvp at u0 is A_uu
            Au = (_masked_operator(resid_u_work, u0, mask_u) if jvp_u
                  else _masked_op(el_operator(theta), mask_u))
            Mu = _masked_op(el_precond(theta), mask_u)
            if cheb:
                Mu = poly(Au, Mu, lmax(theta, "_lmax_u", Au, Mu, u0))
            if warm:
                atol = max(cfg.cg_rtol * float(anchor_u), cfg.cg_atol)
                du, info_u = _pcg("el", Au, rhs_u, Mu, 0.0, atol)
            else:
                du, info_u = _pcg("el", Au, rhs_u, Mu, cfg.cg_rtol, cfg.cg_atol)
        u = u0 + du
        # a stalled elasticity CG must freeze the trajectory like a failed
        # Newton: mirror pcg's own stopping test, plus finiteness
        rhs_norm = anchor_u if warm else norm(rhs_u)
        tol_u = torch.clamp(cfg.cg_rtol * rhs_norm, min=cfg.cg_atol)
        resnorm = info_u["resnorm"].to(tol_u.dtype)
        conv_u = torch.isfinite(resnorm) & (resnorm <= tol_u)
        if refine:
            # one correction solve of the f64 defect (classic iterative
            # refinement: the working-dtype operator solves the defect
            # equation, to refine_cg_rtol)
            ru2 = resid_u(u)
            rhs_u2 = torch.where(mask_u, torch.zeros_like(ru2), -ru2)
            if whole_solve:
                du2, _ = _recorded("el_refine", el_cg(theta, rhs_u2, rtol=refine_rtol))
            else:
                du2, _ = _pcg("el_refine", Au, rhs_u2, Mu, refine_rtol, cfg.cg_atol)
            u = u + du2
            conv_u = conv_u & torch.isfinite(total(du2))
        return u, c, conv_u & conv_c, k

    def adjoint(theta, c_prev, t, u, c, u_bar, c_bar, keys, need_c_prev):
        """step_bwd: (theta_bar {key: tensor or None}, c_prev_bar or None)
        for the converged (u, c) of ``solve(theta, u_prev, c_prev, t)``;
        ``keys`` the theta tensors whose cotangent is wanted."""
        gc = bc_values_c(t)
        gu = bc_values_u(t)
        # A_uu^T lam_u = u_bar (A_uu symmetric)
        rhs_u = torch.where(mask_u, torch.zeros_like(u_bar), u_bar)
        if whole_solve:
            lam_u, _ = _recorded("el_adj", el_cg(theta, rhs_u))
        else:
            if jvp_u:
                Au = _masked_operator(
                    lambda uu: torch.where(mask_u, uu - gu, el_residual(uu, c, theta, t)),
                    u, mask_u)
            else:
                Au = _masked_op(el_operator(theta), mask_u)
            Mu = _masked_op(el_precond(theta), mask_u)
            if cheb:
                Mu = poly(Au, Mu, lmax(theta, "_lmax_u", Au, Mu, u))
            lam_u, _ = _pcg("el_adj", Au, rhs_u, Mu, cfg.cg_rtol, cfg.cg_atol)
        # c_bar - (dR_u/dc)^T lam_u, and dR_u/dtheta^T lam_u
        with torch.enable_grad():
            th = {k: v.detach().requires_grad_(k in keys) if torch.is_tensor(v) else v
                  for k, v in theta.items()}
            c_g = c.detach().requires_grad_()
            r_u = torch.where(mask_u, u - gu, el_residual(u, c_g, th, t))
            g_u = torch.autograd.grad(r_u, [c_g] + [th[k] for k in keys], lam_u,
                                      allow_unused=True)
        rhs_c = c_bar if g_u[0] is None else c_bar - g_u[0]
        # J_cc^T lam_c = rhs_c with the exact Jacobian at the converged c
        rhs_c = torch.where(mask_c, torch.zeros_like(rhs_c), rhs_c)
        if whole_solve:
            lam_c, _ = _recorded("rd_adj", rd_cg(theta, c, rhs_c))
        else:
            if jvp_c:
                Ac = _masked_operator(
                    lambda cc: torch.where(mask_c, cc - gc,
                                           rd_residual(cc, c_prev, theta, t)),
                    c, mask_c)
            else:
                Ac = _masked_op(rd_jacobian(theta, c), mask_c)
            Mc = _masked_op(rd_precond(theta), mask_c)
            if cheb:
                Mc = poly(Ac, Mc, lmax(theta, "_lmax_c", Ac, Mc, c))
            lam_c, _ = _pcg("rd_adj", Ac, rhs_c, Mc, cfg.cg_rtol, cfg.cg_atol)
        # dR_c/dc_prev^T lam_c and dR_c/dtheta^T lam_c
        wrt = ([c_prev] if need_c_prev else []) + [th[k] for k in keys]
        g_c = [None] * len(wrt)
        if wrt:
            with torch.enable_grad():
                cp = c_prev.detach().requires_grad_(need_c_prev)
                if need_c_prev:
                    wrt[0] = cp
                r_c = torch.where(mask_c, c - gc, rd_residual(c, cp, th, t))
                if r_c.requires_grad:
                    g_c = list(torch.autograd.grad(r_c, wrt, lam_c,
                                                   allow_unused=True))
        c_prev_bar = None
        if need_c_prev:
            g = g_c.pop(0)
            c_prev_bar = torch.zeros_like(c_prev) if g is None else -g
        theta_bar = {}
        for k, a, b in zip(keys, g_u[1:], g_c):
            if a is None and b is None:
                theta_bar[k] = None
            else:
                theta_bar[k] = -(b if a is None else a if b is None else a + b)
        return theta_bar, c_prev_bar

    def step(theta, u_prev, c_prev, t, guess=None, anchor_c=None):
        if torch.is_grad_enabled():
            keys = sorted(k for k, v in theta.items()
                          if torch.is_tensor(v) and v.is_floating_point())
            vals = [theta[k] for k in keys]
            if any(x.requires_grad for x in (u_prev, c_prev, *vals)):
                static = {k: v for k, v in theta.items() if k not in set(keys)}
                if guess is not None:
                    guess = tuple(g.detach() for g in guess)
                if torch.is_tensor(anchor_c):
                    anchor_c = anchor_c.detach()
                return _ImplicitStep.apply(solve, adjoint, tuple(keys), static, t,
                                           guess, anchor_c, u_prev, c_prev, *vals)
        return solve(theta, u_prev, c_prev, t, guess, anchor_c)

    return step


class _ImplicitStep(torch.autograd.Function):
    """One implicit step, ``(u_prev, c_prev, *theta tensors) -> (u, c,
    converged, n_newton)``, differentiated by the implicit-function
    theorem (module docstring)."""

    @staticmethod
    def forward(ctx, solve, adjoint, keys, static, t, guess, anchor_c, u_prev, c_prev,
                *vals):
        theta = {**static, **dict(zip(keys, vals))}
        u, c, conv, k = solve(theta, u_prev, c_prev, t, guess, anchor_c)
        ctx.mark_non_differentiable(conv)
        ctx.adjoint, ctx.keys, ctx.static, ctx.t = adjoint, keys, static, t
        ctx.save_for_backward(u_prev, c_prev, u, c, *vals)
        return u, c, conv, k

    @staticmethod
    @once_differentiable
    def backward(ctx, u_bar, c_bar, _conv_bar, _k_bar):
        # saved outputs come back attached to this node: detached, so the
        # residual VJPs below differentiate nothing they do not need
        u_prev, c_prev, u, c, *vals = (x.detach() for x in ctx.saved_tensors)
        need = ctx.needs_input_grad
        theta = {**ctx.static, **dict(zip(ctx.keys, vals))}
        keys = [k for k, nd in zip(ctx.keys, need[9:]) if nd]
        theta_bar, c_prev_bar = ctx.adjoint(
            theta, c_prev, ctx.t, u, c, u_bar, c_bar, keys, need[8])
        u_prev_bar = torch.zeros_like(u_prev) if need[7] else None
        return (None,) * 7 + (u_prev_bar, c_prev_bar,
                              *(theta_bar.get(k) for k in ctx.keys))
