"""Time-dependent simulation, lattice lane (counterpart of
``glimslib_tpu/models/base.py``).

Same orchestration API as the reference:

    sim = Model(mesh, dtype=torch.float32, device="cuda")
    sim.setup_global_parameters(label_function=..., domain_names=...,
                                boundaries=..., dirichlet_bcs=...)
    sim.setup_model_parameters(iv_expression=..., ..., sim_time=...,
                               sim_time_step=...)
    u_traj, c_traj, ok, newton_iters = sim.run()

The hot path: offset-stencil operators (``ops/stencil.py``) built once per
simulate, the block-triangular Newton-CG step (``solvers/coupled.py``) with
both linear solves in the whole-solve CUDA PCG kernel, and streaming
residuals through the CUDA stencil kernel.  Solver non-convergence freezes
the carried state and flags the remaining steps, as in the reference.

``plain=True`` routes every stencil apply and whole-solve PCG through the
plain torch versions on any device: a reference run for checking the
kernels on the card.  Outside the slice (unstructured meshes, P2
concentration, sharding, refinement, Chebyshev preconditioning, von
Neumann BCs, time-dependent sources) the model raises
``NotImplementedError``.
"""

from __future__ import annotations

import logging
import types
from abc import ABC, abstractmethod
from typing import Dict

import numpy as np
import torch

from glimslib_tpu_torch import config
from glimslib_tpu_torch.core.bcs import BoundaryConditions
from glimslib_tpu_torch.core.functionspace import FunctionSpace
from glimslib_tpu_torch.core.params import Parameters
from glimslib_tpu_torch.core.subdomains import SubDomains
from glimslib_tpu_torch.ops import fused_cg, stencil_kernels
from glimslib_tpu_torch.ops.assembly import P1Kernels
from glimslib_tpu_torch.ops.stencil import StencilOperators
from glimslib_tpu_torch.solvers.coupled import StepConfig, make_step

logger = logging.getLogger(__name__)


def _kernel_ops(plain: bool):
    """The stencil applies and whole-solve PCGs the step calls: the kernel
    wrappers, or (``plain``) their plain torch versions."""
    sk, fc = stencil_kernels, fused_cg
    if plain:
        return types.SimpleNamespace(
            apply_scalar=sk.apply_scalar_plain, apply_vector=sk.apply_vector_plain,
            apply_coupling=sk.apply_coupling_plain,
            cg_scalar=fc.cg_scalar_plain, cg_vector=fc.cg_vector_plain,
        )
    return types.SimpleNamespace(
        apply_scalar=sk.apply_scalar, apply_vector=sk.apply_vector,
        apply_coupling=sk.apply_coupling,
        cg_scalar=fc.cg_scalar, cg_vector=fc.cg_vector,
    )


class Simulation(ABC):
    """Abstract time-dependent simulation (reference FenicsSimulation)."""

    SUBSPACE_DISPLACEMENT = 0
    SUBSPACE_CONCENTRATION = 1
    CONCENTRATION_DEGREE = 1

    def __init__(self, mesh, time_dependent=True, dtype=None, device=None,
                 plain=False):
        if mesh.lattice_strides is None:
            raise NotImplementedError(
                "the port runs lattice meshes only; the unstructured lane "
                "is not ported yet"
            )
        if self.CONCENTRATION_DEGREE != 1:
            raise NotImplementedError("P2 concentration is not ported yet")
        self.logger = logging.getLogger(type(self).__name__)
        self.mesh = mesh
        self.time_dependent = time_dependent
        self.dtype = config.resolve_dtype(dtype)
        self.device = config.resolve_device(device)
        self._k = _kernel_ops(plain)
        self.functionspace = FunctionSpace(mesh)
        self._define_model_params()
        self.kernels = P1Kernels(mesh, dtype=self.dtype, device=self.device)
        self._stencil_ops = None
        self._bc_cache = None
        # per-solve CG iteration counts (0-d tensors) of the last simulate
        self.solver_info = {"rd_cg_iters": [], "el_cg_iters": []}
        # solver tolerances scale with the working precision, as in the
        # reference (f32 cannot reach the f64 defaults); the 'reference'
        # profile's inexact-Newton forcing (rd_cg_rtol=1e-3) is dropped: the
        # reference's fused lattice path ignores it too
        profile = config.resolve_profile()
        if self.dtype == torch.float64:
            if profile == "reference":
                self.step_config = StepConfig(
                    newton_rtol=1e-8, cg_rtol=1e-5,
                    precond_degree=config.precond_degree,
                )
            else:
                self.step_config = StepConfig(precond_degree=config.precond_degree)
        elif profile == "reference":
            self.step_config = StepConfig(
                newton_rtol=1e-4, newton_atol=1e-5, cg_rtol=1e-5,
                cg_maxiter=1000, precond_degree=config.precond_degree,
                refine_f64=False,
            )
        else:
            self.step_config = StepConfig(
                newton_rtol=1e-4, newton_atol=1e-5, cg_rtol=1e-7,
                cg_maxiter=1000, precond_degree=config.precond_degree,
                refine_f64=config.resolve_refine_f64(self.dtype),
            )

    def use_sharding(self, *args, **kwargs):
        raise NotImplementedError("sharded execution is not ported yet")

    # -- abstract model surface ----------------------------------------------

    @abstractmethod
    def _define_model_params(self):
        self.required_params = []
        self.optional_params = []

    @abstractmethod
    def _setup_functionspace(self):
        ...

    @abstractmethod
    def make_theta(self, params: Dict):
        """Physical coefficients as tensors on the model's device.
        ``simulate`` augments them with derived operator planes
        (underscore keys) once per call."""

    @abstractmethod
    def rd_residual(self, c, c_prev, theta, t):
        ...

    @abstractmethod
    def el_residual(self, u, c, theta, t):
        ...

    @abstractmethod
    def rd_diag(self, theta):
        ...

    @abstractmethod
    def el_diag(self, theta):
        ...

    # -- global setup ---------------------------------------------------------

    def setup_global_parameters(self, label_function=None, subdomains=None,
                                domain_names=None, boundaries=None,
                                dirichlet_bcs=None, von_neumann_bcs=None):
        self.subdomains = SubDomains(self.mesh)
        self.subdomains.setup_subdomains(
            label_function=label_function, subdomains=subdomains
        )
        self.subdomains.setup_boundaries(
            tissue_map=domain_names, boundary_fct_dict=boundaries
        )
        self.subdomains.setup_measures()
        self._setup_functionspace()
        self.bcs = BoundaryConditions(self.functionspace, self.subdomains)
        self.bcs.setup_dirichlet_boundary_conditions(dirichlet_bcs)
        self.bcs.setup_von_neumann_boundary_conditions(von_neumann_bcs)
        self._bc_cache = None

    def setup_model_parameters(self, iv_expression, **kwargs):
        self._define_model_params()
        self.params = Parameters(
            self.functionspace, self.subdomains, time_dependent=self.time_dependent
        )
        self.params.set_initial_value_expressions(iv_expression)
        self.params.define_required_params(self.required_params)
        self.params.define_optional_params(self.optional_params)
        self.params.init_parameters(kwargs)

    # -- masks, operators, step ------------------------------------------------

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype or self.dtype, device=self.device)

    def _unused_node_mask(self):
        """Nodes no cell references: treated as zero-Dirichlet dofs."""
        used = np.zeros(self.mesh.n_nodes, dtype=bool)
        used[np.unique(self.mesh.cells.ravel())] = True
        return ~used

    def _bc_masks_and_values(self):
        """(mask_u, mask_c, gu(t), gc(t)) on the model's device."""
        if self._bc_cache is None:
            sd, sc = self.SUBSPACE_DISPLACEMENT, self.SUBSPACE_CONCENTRATION
            mask_u, vu = self.bcs.dirichlet_mask_and_values(sd)
            mask_c, vc = self.bcs.dirichlet_mask_and_values(sc)
            unused = self._unused_node_mask()
            mask_u = mask_u | unused[:, None]
            mask_c = mask_c | unused
            tdep = self.bcs.has_time_dependent_dirichlet
            vu0, vc0 = self._tensor(vu), self._tensor(vc)

            def gu(t):
                if not tdep:
                    return vu0
                return self._tensor(self.bcs.dirichlet_mask_and_values(sd, t)[1])

            def gc(t):
                if not tdep:
                    return vc0
                return self._tensor(self.bcs.dirichlet_mask_and_values(sc, t)[1])

            self._bc_cache = (
                self._tensor(mask_u, torch.bool), self._tensor(mask_c, torch.bool),
                gu, gc,
            )
        return self._bc_cache

    def _stencil_operators(self):
        """Offset-stencil operators and the two whole-solve PCG callables
        (reference base.py:1023-1192, lattice branch; the TPU's VMEM
        fit checks and streamed-kernel selection have no counterpart)."""
        ops = StencilOperators(self.mesh, dtype=self.dtype, device=self.device)
        self._stencil_ops = ops
        mask_u, mask_c, _, _ = self._bc_masks_and_values()
        cfg = self.step_config
        k = self._k

        def rd_cg(theta, c, rhs):
            W = theta["_Wrd_const"] + ops.build_rd_wc(
                c, theta["rho"], theta["dt"], conc_max=1.0
            )
            Wm = fused_cg.fold_mask_scalar(ops.offsets, W, mask_c)
            dc, info = k.cg_scalar(ops.offsets, Wm, theta["_invdM"], rhs,
                                   cfg.cg_rtol, cfg.cg_atol, cfg.cg_maxiter)
            self.solver_info["rd_cg_iters"].append(info["iters"])
            return dc, info

        def el_cg(theta, rhs):
            du, info = k.cg_vector(ops.offsets, theta["_WelM"], theta["_BinvM"],
                                   rhs, cfg.cg_rtol, cfg.cg_atol, cfg.cg_maxiter)
            self.solver_info["el_cg_iters"].append(info["iters"])
            return du, info

        return rd_cg, el_cg

    def _augment_theta_with_operators(self, theta):
        """Theta-only stencil planes and mask-folded solver state, built
        once per simulate and never in the time loop (reference
        base.py:1440-1503, lattice branch).  Keys: ``_Wel``/``_Binv``
        elasticity planes and block inverse, ``_WelM``/``_BinvM``/``_invdM``
        their mask-folded forms for the PCG kernels, ``_Wrd_const``/``_Mst``
        the constant rd planes, ``_Cuc`` the coupling planes, and the
        constant loads ``_rd_load``/``_el_load``."""
        ops = self._stencil_ops
        mask_u, mask_c, _, _ = self._bc_masks_and_values()
        n = self.mesh.n_nodes
        Wel = ops.build_elasticity(theta["mu"], theta["lam"])
        theta = dict(theta)
        theta["_Wel"] = Wel
        theta["_Binv"] = ops.block_jacobi_inverse(Wel)
        theta["_WelM"] = fused_cg.fold_mask_vector(ops.offsets, Wel, mask_u)
        theta["_BinvM"] = fused_cg.fold_mask_binv(theta["_Binv"], mask_u)
        theta["_invdM"] = fused_cg.fold_mask_invdiag(self.rd_diag(theta), mask_c)
        theta["_Wrd_const"] = ops.build_rd_jacobian_const(
            theta["D"], theta["rho"], theta["dt"]
        )
        theta["_Mst"] = ops.build_mass_planes()
        zeros = torch.zeros(n, dtype=self.dtype, device=self.device)
        load = self.kernels.rd_residual(
            zeros, zeros, theta["D"], theta["rho"], theta["dt"],
            source=theta["source"],
        )
        theta["_rd_load"] = -load  # the residual carried -dt s v
        theta["_Cuc"] = ops.build_coupling_uc(
            theta["mu"], theta["lam"], theta["coupling"]
        )
        lumped = self.kernels.lumped_mass()
        theta["_el_load"] = lumped[:, None] * theta["body_force"].expand(
            self.mesh.dim
        )[None, :]
        return theta

    def _build_step(self):
        mask_u, mask_c, gu, gc = self._bc_masks_and_values()
        rd_cg, el_cg = self._stencil_operators()
        return make_step(
            rd_residual=self.rd_residual, el_residual=self.el_residual,
            mask_c=mask_c, mask_u=mask_u, bc_values_c=gc, bc_values_u=gu,
            config=self.step_config, rd_cg=rd_cg, el_cg=el_cg,
        )

    def build_simulate_fn(self, n_steps: int, dt: float):
        """``simulate(theta, u0, c0) -> (u_traj, c_traj, ok, newton_iters)``
        with arrays (n_steps, ...) on the model's device (``newton_iters``
        on the host).  Once a step fails to converge, the state freezes and
        every later step is flagged (reference base.py:1843-1845)."""
        step = self._build_step()

        def simulate(theta, u0, c0):
            self.solver_info = {"rd_cg_iters": [], "el_cg_iters": []}
            theta = self._augment_theta_with_operators(theta)
            u_traj = torch.empty((n_steps,) + tuple(u0.shape), dtype=u0.dtype,
                                 device=u0.device)
            c_traj = torch.empty((n_steps,) + tuple(c0.shape), dtype=c0.dtype,
                                 device=c0.device)
            ok_traj = torch.empty(n_steps, dtype=torch.bool, device=c0.device)
            newton = []
            u_prev, c_prev = u0, c0
            ok = torch.ones((), dtype=torch.bool, device=c0.device)
            for i in range(n_steps):
                u, c, conv, n_newton = step(theta, u_prev, c_prev, (i + 1.0) * dt)
                ok = ok & conv
                u_prev = torch.where(ok, u, u_prev)
                c_prev = torch.where(ok, c, c_prev)
                u_traj[i] = u_prev
                c_traj[i] = c_prev
                ok_traj[i] = ok
                newton.append(n_newton)
            return u_traj, c_traj, ok_traj, torch.tensor(newton, dtype=torch.int32)

        return simulate

    def initial_state(self):
        """Projected initial values (u0, c0) as tensors, clamped to the
        Dirichlet data at t=0."""
        iv = self.params.create_initial_value_function()
        u0 = self._tensor(iv[self.SUBSPACE_DISPLACEMENT])
        c0 = self._tensor(iv[self.SUBSPACE_CONCENTRATION])
        mask_u, mask_c, gu, gc = self._bc_masks_and_values()
        return torch.where(mask_u, gu(0.0), u0), torch.where(mask_c, gc(0.0), c0)

    def run(self):
        """Run the configured schedule; returns the trajectory
        ``(u_traj, c_traj, ok, newton_iters)`` and sets ``self.solution``
        to the last converged state as numpy arrays.  File output is not
        ported yet."""
        u0, c0 = self.initial_state()
        theta = self.make_theta(self.params.as_dict())
        dt = float(self.params.sim_time_step)
        n_steps = int(round(float(self.params.sim_time) / dt + 1e-9))
        u_traj, c_traj, ok_traj, newton = self.build_simulate_fn(n_steps, dt)(
            theta, u0, c0
        )
        n_ok = int(ok_traj.sum())
        if n_ok < n_steps:
            self.logger.warning(
                "Solver did not converge at step %d -- simulation frozen "
                "from there", n_ok + 1,
            )
        last_u = u_traj[n_ok - 1] if n_ok else u0
        last_c = c_traj[n_ok - 1] if n_ok else c0
        self.solution = {0: last_u.cpu().numpy(), 1: last_c.cpu().numpy()}
        return u_traj, c_traj, ok_traj, newton
