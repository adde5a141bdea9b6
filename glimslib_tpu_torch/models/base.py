"""Time-dependent simulation (counterpart of
``glimslib_tpu/models/base.py``).

Same orchestration API as the reference:

    sim = Model(mesh, dtype=torch.float32)      # on the card by default
    sim.setup_global_parameters(label_function=..., domain_names=...,
                                boundaries=..., dirichlet_bcs=...)
    sim.setup_model_parameters(iv_expression=..., ..., sim_time=...,
                               sim_time_step=...)
    u_traj, c_traj, ok, newton_iters = sim.run()

Two operator lanes, chosen by the mesh:

- **Lattice meshes**: offset-stencil operators (``ops/stencil.py``) built
  once per simulate, the block-triangular Newton-CG step
  (``solvers/coupled.py``) with both linear solves in the whole-solve
  CUDA PCG kernel, and streaming residuals through the CUDA stencil
  kernel.
- **Unstructured meshes** (P1): supernode halo-ELL operators
  (``ops/bell.py``) assembled once per simulate, every matvec and
  supernode block-Jacobi apply through the CUDA batched-matvec kernel;
  ``pcg`` preconditioned by supernode block-Jacobi plus the two-level
  coarse level (``solvers/twolevel.py``, its factors in bf16 on f32
  runs), the chord method, linearly extrapolated warm starts with
  anchored tolerances and the algebraic rd anchor.  The frozen state
  (supernode inverses, coarse factors, and where the model's
  coefficients are class-wise constant the factored channel stacks of
  ``ops/bell_factored.py``) is built once per model at the set-up
  parameters (:meth:`runtime_aux`).
- **Quad models on unstructured meshes** (P2 concentration,
  ``CONCENTRATION_DEGREE = 2``): the same lane, with the concentration
  block on a second supernode plan over the P2 dofs (``ops/p2_ell.py``,
  s = 64): the assembled P2 rd Jacobian (constant planes plus the exact
  logistic correction, or its lumped row sums for the chord method), its
  supernode block-Jacobi ``_McSNP2`` without a coarse level, and the
  factored P2 channels; the residuals are the quadrature kernels of
  ``ops/p2.py``.  The elasticity block and its preconditioners are the P1
  lane's.

The lane's settings are the reference's defaults, fixed: supernodes of
32 nodes, aggregates of 64, the coarse factors truncated to max(2048,
3/5 of the coarse dimension) columns, the factored assembly wherever the
model gives class labels.  ``GLIMS_TWOLEVEL_MIN_NODES`` (default 4000)
sets the mesh size from which the two-level level is on.  On f32 models
the default step refines in f64 (``config.resolve_refine_f64``;
``solvers/coupled.py``).

Both lanes are differentiable: ``simulate`` keeps the autograd graph
through the time loop (each step is the implicit-function-theorem adjoint
of ``solvers/coupled.py``), so ``torch.autograd.grad`` of an objective of
the trajectory gives the reference's exact gradient (``optimize/``).

Solver non-convergence freezes the carried state and flags the remaining
steps, as in the reference.  ``plain=True`` routes every kernel call
through its plain torch version on any device: a reference run for
checking the kernels on the card.  Outside the port so far (the quad
models on lattice meshes, sharding, Chebyshev preconditioning, von
Neumann BCs, time-dependent sources) the model raises
``NotImplementedError``.
"""

from __future__ import annotations

import logging
import os
import time
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
from glimslib_tpu_torch.ops import (
    bell, bell_factored, bell_kernels, ell, fused_cg, p2_ell, stencil_kernels,
)
from glimslib_tpu_torch.ops.assembly import P1Kernels
from glimslib_tpu_torch.ops.stencil import StencilOperators
from glimslib_tpu_torch.solvers import twolevel
from glimslib_tpu_torch.solvers.coupled import StepConfig, make_step

logger = logging.getLogger(__name__)


def _kernel_ops(plain: bool):
    """The kernel calls the step makes: the kernel wrappers, or
    (``plain``) their plain torch versions (differentiated by torch's own
    VJPs; they ignore the wrappers' mirrored-plane cache)."""
    sk, fc, bk = stencil_kernels, fused_cg, bell_kernels
    if plain:
        return types.SimpleNamespace(
            apply_scalar_sum=lambda o, terms, b, cache=None: sk.apply_scalar_sum_plain(
                o, terms, b),
            apply_vector=lambda o, W, u, cache=None: sk.apply_vector_plain(o, W, u),
            apply_coupling=lambda o, C, c, cache=None: sk.apply_coupling_plain(o, C, c),
            cg_scalar=fc.cg_scalar_plain, cg_vector=fc.cg_vector_plain,
            bmv=bk.batched_matvec_plain,
        )
    return types.SimpleNamespace(
        apply_scalar_sum=sk.apply_scalar_sum, apply_vector=sk.apply_vector,
        apply_coupling=sk.apply_coupling,
        cg_scalar=fc.cg_scalar, cg_vector=fc.cg_vector,
        bmv=bk.batched_matvec,
    )


def _new_solver_info():
    """CG iteration counts by solve: the forward's rd (one a Newton
    iteration), elasticity (one a step) and refinement correction (one a
    step under refine_f64) solves, and the backward's adjoint solves (one
    of each a step)."""
    return {"rd_cg_iters": [], "el_cg_iters": [], "el_refine_cg_iters": [],
            "rd_adj_cg_iters": [], "el_adj_cg_iters": []}


def _coarse_k(dim_c):
    """Spectral-truncation width of a coarse factor: the reference's
    default, max(2048, 3/5 dim_c) columns, or None (the full factor)."""
    k = max(2048, (3 * dim_c) // 5)
    return k if k < dim_c else None


def default_step_config(dtype):
    """A model's default StepConfig for its working dtype: solver
    tolerances scale with the working precision, as in the reference (f32
    cannot reach the f64 defaults), under the solver profile
    (``config.resolve_profile``); on f32 the step refines in f64 unless
    ``GLIMS_REFINE_F64`` says otherwise."""
    profile = config.resolve_profile()
    if dtype == torch.float64:
        if profile == "reference":
            return StepConfig(newton_rtol=1e-8, cg_rtol=1e-5, rd_cg_rtol=1e-3,
                              precond_degree=config.precond_degree)
        return StepConfig(precond_degree=config.precond_degree)
    if profile == "reference":
        return StepConfig(
            newton_rtol=1e-4, newton_atol=1e-5, cg_rtol=1e-5, cg_maxiter=1000,
            rd_cg_rtol=1e-3, precond_degree=config.precond_degree, refine_f64=False,
        )
    return StepConfig(
        newton_rtol=1e-4, newton_atol=1e-5, cg_rtol=1e-7, cg_maxiter=1000,
        precond_degree=config.precond_degree,
        refine_f64=config.resolve_refine_f64(dtype),
    )


class Simulation(ABC):
    """Abstract time-dependent simulation (reference FenicsSimulation)."""

    SUBSPACE_DISPLACEMENT = 0
    SUBSPACE_CONCENTRATION = 1
    CONCENTRATION_DEGREE = 1

    def __init__(self, mesh, time_dependent=True, dtype=None, device=None,
                 plain=False):
        self.lattice = mesh.lattice_strides is not None
        self.quad = self.CONCENTRATION_DEGREE == 2
        if self.quad and self.lattice:
            # the reference runs quad models on lattice meshes on its
            # matrix-free jvp lane (no stencil builders for degree 2)
            raise NotImplementedError(
                "a quad (P2-concentration) model on a lattice-carrying mesh "
                "takes the matrix-free jvp lane, which is not ported: pass a "
                "mesh without lattice structure (Mesh.from_arrays)")
        self.logger = logging.getLogger(type(self).__name__)
        self.mesh = mesh
        self.time_dependent = time_dependent
        self.dtype = config.resolve_dtype(dtype)
        self.device = config.resolve_device(device)
        self._k = _kernel_ops(plain)
        self.functionspace = FunctionSpace(mesh, device=self.device)
        self._define_model_params()
        self.kernels = P1Kernels(mesh, dtype=self.dtype, device=self.device)
        self._stencil_ops = None
        self._bell_plan = None
        self._p2_plan = None
        self._agg_plan = None
        self._aux_cache = None
        self._bc_cache = None
        # per-solve CG iteration counts (0-d tensors) of the last simulate
        # and of its backward
        self.solver_info = _new_solver_info()
        self.step_config = default_step_config(self.dtype)

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

    def hi_residual_fns(self):
        """(rd_hi, el_hi): f64 residuals for mixed-precision refinement,
        or None (the model cannot refine)."""
        return None

    def theta_class_labels(self):
        """Per-cell class labels under which every per-cell coefficient
        of theta is constant within each class (the factored assembly's
        contract, ``ops/bell_factored.py``), or None."""
        return None

    def theta_class_support(self):
        """{coefficient name: set of class labels} where that coefficient
        can be nonzero; a name it lacks keeps every class."""
        return {}

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
        self._aux_cache = None

    def setup_model_parameters(self, iv_expression, **kwargs):
        self._define_model_params()
        self.params = Parameters(
            self.functionspace, self.subdomains, time_dependent=self.time_dependent
        )
        self.params.set_initial_value_expressions(iv_expression)
        self.params.define_required_params(self.required_params)
        self.params.define_optional_params(self.optional_params)
        self.params.init_parameters(kwargs)
        self._aux_cache = None

    # -- masks ------------------------------------------------------------------

    def _sync(self):
        """Wait for the card's queue (set-up seconds are wall time)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
            if not self.quad:
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

    # -- lattice lane: offset stencils and whole-solve PCG ------------------------

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
            # J_cc is symmetric: the adjoint solve is the same solve
            W = theta["_Wrd_const"] + ops.build_rd_wc(
                c, theta["rho"], theta["dt"], conc_max=1.0
            )
            Wm = fused_cg.fold_mask_scalar(ops.offsets, W, mask_c)
            return k.cg_scalar(ops.offsets, Wm, theta["_invdM"], rhs,
                               cfg.cg_rtol, cfg.cg_atol, cfg.cg_maxiter)

        def el_cg(theta, rhs, rtol=None):
            # rtol: the refinement's correction solve
            return k.cg_vector(ops.offsets, theta["_WelM"], theta["_BinvM"], rhs,
                               cfg.cg_rtol if rtol is None else rtol, cfg.cg_atol,
                               cfg.cg_maxiter)

        return rd_cg, el_cg

    def _augment_lattice(self, theta):
        """Theta-only stencil planes and mask-folded solver state (reference
        base.py:1440-1503, lattice branch).  Keys: ``_Wel``/``_Binv``
        elasticity planes and block inverse, ``_WelM``/``_BinvM``/``_invdM``
        their mask-folded forms for the PCG kernels, ``_Wrd_const``/``_Mst``
        the constant rd planes, ``_Cuc`` the coupling planes, the constant
        loads ``_rd_load``/``_el_load``, and ``_mirrors``, the cache of the
        transposed planes the backward applies.  The solver state is built
        without a graph: it feeds solvers only, so its cotangent is zero by
        design, as in the reference."""
        ops = self._stencil_ops
        mask_u, mask_c, _, _ = self._bc_masks_and_values()
        n = self.mesh.n_nodes
        Wel = ops.build_elasticity(theta["mu"], theta["lam"])
        theta["_Wel"] = Wel
        with torch.no_grad():
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
        theta["_el_load"] = self._body_load(theta)
        theta["_mirrors"] = stencil_kernels.MirrorCache(
            [theta[k] for k in ("_Mst", "_Cuc", "_Wel", "_Wrd_const")])
        return theta

    def _body_load(self, theta):
        """Constant body load ∫ b·v = lumped mass ⊗ body force, (n, d)."""
        lumped = self.kernels.lumped_mass()
        return lumped[:, None] * theta["body_force"].expand(self.mesh.dim)[None, :]

    # -- unstructured lane: supernode halo-ELL and two-level PCG ------------------

    def _get_bell_plan(self):
        if self._bell_plan is None:
            self._bell_plan = bell.BellPlan(self.mesh, s=32, device=self.device)
        return self._bell_plan

    def _get_p2_plan(self):
        """The supernode plan over the P2 dofs of a quad model (s = 64,
        the reference's default, base.py:492-509)."""
        if self._p2_plan is None:
            self._p2_plan = p2_ell.make_p2_plan(self.p2, s=64)
        return self._p2_plan

    def _mesh_arrays(self):
        return self.kernels.grads_T, self.kernels.vol

    def _twolevel_aggplan(self):
        """The coarse aggregation plan (64-node aggregates), or None on
        meshes below ``GLIMS_TWOLEVEL_MIN_NODES`` nodes (default 4000), as
        in the reference (base.py:704-733)."""
        if self.mesh.n_nodes < int(os.environ.get("GLIMS_TWOLEVEL_MIN_NODES",
                                                  "4000")):
            return None
        if self._agg_plan is None:
            self._agg_plan = twolevel.AggPlan(self.mesh, agg_size=64)
        return self._agg_plan

    def runtime_aux(self):
        """Frozen state of the unstructured lane, built once per model from
        the set-up parameters and cached (reference base.py:755-970): the
        supernode block-Jacobi inverses ``_BinvSN`` (nb, s d, s d) and
        ``_McSN`` (nb, s, s) (a quad model: ``_McSNP2`` (nb2, s2, s2) on
        the P2 plan), the factored channel stacks (:meth:`_factored_aux`),
        and, when the two-level level is on, its arrays
        (:meth:`_twolevel_aux`), the coarse factors in bf16 on f32 models.
        A preconditioner shapes iteration counts only, so freezing it
        across parameter updates never changes a solution.
        ``setup_seconds`` records what the build took, by part.  {} on
        lattice meshes."""
        if self.lattice:
            return {}
        if self._aux_cache is not None:
            return self._aux_cache
        theta0 = self.make_theta(self.params.as_dict())
        mask_u, mask_c, _, _ = self._bc_masks_and_values()
        times = {}
        t0 = time.perf_counter()
        bplan = self._get_bell_plan()
        times["bell_plan"] = time.perf_counter() - t0
        if self.quad:
            t0 = time.perf_counter()
            p2plan = self._get_p2_plan()
            times["p2_plan"] = time.perf_counter() - t0
        arrays = self._mesh_arrays()
        m0 = self.kernels._m0
        t0 = time.perf_counter()
        Wel = bell.build_bell_elasticity(bplan, arrays, theta0["mu"], theta0["lam"])
        aux = {"_BinvSN": bell.supernode_jacobi_inverse(
            bplan, bell.extract_self_blocks_vector(bplan, Wel), mask=mask_u)}
        del Wel
        if not self.quad:
            Wrd = bell.build_bell_rd_const(bplan, arrays, theta0["D"], theta0["rho"],
                                           theta0["dt"], m0)
            aux["_McSN"] = bell.supernode_jacobi_inverse(
                bplan, bell.extract_self_blocks_scalar(bplan, Wrd), mask=mask_c)
            del Wrd
        self._sync()
        times["supernode_jacobi"] = time.perf_counter() - t0
        if self.quad:
            t0 = time.perf_counter()
            Wrd2 = p2_ell.build_p2_rd_const(p2plan, self.p2, theta0["D"],
                                            theta0["rho"], theta0["dt"])
            aux["_McSNP2"] = bell.supernode_jacobi_inverse(
                p2plan, bell.extract_self_blocks_scalar(p2plan, Wrd2), mask=mask_c)
            del Wrd2
            self._sync()
            times["p2_supernode_jacobi"] = time.perf_counter() - t0
        aux.update(self._factored_aux(times))
        tl = self._twolevel_aux(theta0, times)
        if tl and self.dtype == torch.float32:
            # half the factors' memory traffic, the coarse apply's cost; the
            # Gram form stays PSD in any storage precision
            for k in ("_TLCfac", "_TLCfacS"):
                if k in tl:
                    tl[k] = tl[k].to(torch.bfloat16)
        aux.update(tl)
        self.setup_seconds = times
        self.logger.info("runtime aux built: %s", {k: f"{v:.2f} s"
                                                   for k, v in times.items()})
        self._aux_cache = aux
        return aux

    def _twolevel_aux(self, theta0, times):
        """The two-level level's frozen arrays at the parameters of
        ``theta0``, {} where the level is off: the coarse Gram factors
        ``_TLCfac`` / ``_TLCfacS`` in the working dtype and the masked mode
        matrices ``_TLMt`` (n_pad, d, q) / ``_TLMtS`` (n_pad, qs); the
        build's seconds go into ``times``."""
        agg = self._twolevel_aggplan()
        if agg is None:
            return {}
        mask_u, mask_c, _, _ = self._bc_masks_and_values()
        arrays = self._mesh_arrays()
        m0 = self.kernels._m0
        aux = {}
        t0 = time.perf_counter()
        eplan = ell.EllPlan(self.mesh, device=self.device)
        B = ell.build_ell_elasticity(eplan, arrays, theta0["mu"], theta0["lam"])
        Ac = twolevel.build_coarse(agg, eplan.adj_idx, B, mask_u)
        del B
        Acs = None
        if not self.quad:
            # the scalar level of the P1 rd solves (a quad model's P2
            # solves take supernode block-Jacobi alone, as in the reference)
            W = ell.build_ell_rd_const(eplan, arrays, theta0["D"], theta0["rho"],
                                       theta0["dt"], m0)
            Acs = twolevel.build_coarse_scalar(agg, eplan.adj_idx, W, mask_c)
            del W
        self._sync()
        times["coarse_build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        aux["_TLCfac"] = twolevel.coarse_inverse(Ac, k=_coarse_k(Ac.shape[0]))
        if Acs is not None:
            aux["_TLCfacS"] = twolevel.coarse_inverse(Acs, k=_coarse_k(Acs.shape[0]))
        self._sync()
        times["coarse_inverse"] = time.perf_counter() - t0
        f_u = 1.0 - mask_u.cpu().numpy().astype(np.float64)
        aux["_TLMt"] = self._tensor(agg.mode_matrix(f_u))
        if Acs is not None:
            f_c = 1.0 - mask_c.cpu().numpy().astype(np.float64)
            aux["_TLMtS"] = self._tensor(agg.mode_matrix_scalar(f_c))
        return aux

    def _factored_aux(self, times=None):
        """The frozen per-class channel stacks of the theta planes
        (``ops/bell_factored.py build_cache``; a quad model: the
        elasticity channels and the P2 rd channels of ``build_p2_cache``)
        where the model guarantees class-wise constant coefficients
        (:meth:`theta_class_labels`), {} otherwise.  Their build seconds
        go into ``times``."""
        labels = self.theta_class_labels()
        if labels is None:
            return {}
        times = {} if times is None else times
        support = self.theta_class_support()
        t0 = time.perf_counter()
        p1 = not self.quad
        out = bell_factored.build_cache(
            self._get_bell_plan(), self._mesh_arrays(), labels, self.kernels._m0,
            want_cuc=p1, want_rd=p1, want_mrd=p1, support=support)
        self._sync()
        times["factored"] = time.perf_counter() - t0
        if self.quad:
            t0 = time.perf_counter()
            out.update(bell_factored.build_p2_cache(self._get_p2_plan(), self.p2,
                                                    labels, support=support))
            self._sync()
            times["factored_p2"] = time.perf_counter() - t0
        return out

    def _augment_bell(self, theta):
        """Theta-only supernode halo-ELL planes (reference base.py:1223-1362,
        bell branch, canonical layout): ``_BellWel`` (nb, s, d, Kh, d),
        ``_BellCuc`` (nb, s, d, Kh), ``_BellWrdC`` and ``_BellMrd`` (nb, s,
        Kh), reduced from the factored channel stacks when theta carries
        them, else through one fused assembly; the constant loads
        ``_Bell_el_load`` and ``_Bell_rd_load``, and the supernode inverses
        ``_BinvSN``/``_McSN`` (without a graph) when the aux did not carry
        them.  A quad model's residuals are the quadrature kernels, so it
        takes ``_BellWel`` and ``_BinvSN`` only, and the P2 planes of
        :meth:`_augment_p2`."""
        if self.quad:
            return self._augment_p2(theta)
        bplan = self._get_bell_plan()
        arrays = self._mesh_arrays()
        m0 = self.kernels._m0
        mask_u, mask_c, _, _ = self._bc_masks_and_values()
        planes = bell_factored.planes_from_theta(theta, self.mesh.dim, want_cuc=True,
                                                 want_rd=True, want_mrd=True)
        if planes is None:
            planes = bell.assemble_fused(bplan, [
                bell.elasticity_entries(arrays, theta["mu"], theta["lam"]),
                bell.coupling_uc_entries(arrays, theta["mu"], theta["lam"],
                                         theta["coupling"]),
                bell.rd_const_entries(arrays, theta["D"], theta["rho"], theta["dt"],
                                      m0),
                bell.mass_entries(arrays, m0),
            ])
        Wel, Wc, Wrd, Mrd = planes
        theta["_BellWel"] = Wel.permute(0, 1, 3, 2, 4).contiguous()
        theta["_BellCuc"] = Wc.permute(0, 1, 3, 2).contiguous()
        theta["_BellWrdC"] = Wrd
        theta["_BellMrd"] = Mrd
        theta["_Bell_el_load"] = self._body_load(theta)
        zeros = torch.zeros(self.mesh.n_nodes, dtype=self.dtype, device=self.device)
        theta["_Bell_rd_load"] = -self.kernels.rd_residual(
            zeros, zeros, theta["D"], theta["rho"], theta["dt"],
            source=theta["source"],
        )  # r(0) = -dt s v
        with torch.no_grad():
            if "_BinvSN" not in theta:
                theta["_BinvSN"] = bell.supernode_jacobi_inverse(
                    bplan, bell.extract_self_blocks_vector(bplan, theta["_BellWel"]),
                    mask=mask_u)
            if "_McSN" not in theta:
                theta["_McSN"] = bell.supernode_jacobi_inverse(
                    bplan, bell.extract_self_blocks_scalar(bplan, Wrd), mask=mask_c)
        return theta

    def _augment_p2(self, theta):
        """A quad model's theta-only planes (reference base.py:1363-1421):
        ``_BellWel`` and ``_BinvSN`` as on the P1 lane, the P2 rd constant
        plane ``_P2BWrdC`` (nb2, s2, Kh2), reduced from the factored P2
        channels when theta carries them, else assembled, and ``_McSNP2``
        (without a graph) when the aux did not carry it."""
        bplan, p2plan = self._get_bell_plan(), self._get_p2_plan()
        mask_u, mask_c, _, _ = self._bc_masks_and_values()
        planes = bell_factored.planes_from_theta(theta, self.mesh.dim, want_cuc=False,
                                                 want_rd=False, want_mrd=False)
        if planes is None:
            planes = bell.assemble_fused(bplan, [bell.elasticity_entries(
                self._mesh_arrays(), theta["mu"], theta["lam"])])
        theta["_BellWel"] = planes[0].permute(0, 1, 3, 2, 4).contiguous()
        Wrd2 = bell_factored.p2_planes_from_theta(theta)
        if Wrd2 is None:
            Wrd2 = p2_ell.build_p2_rd_const(p2plan, self.p2, theta["D"], theta["rho"],
                                            theta["dt"])
        theta["_P2BWrdC"] = Wrd2
        with torch.no_grad():
            if "_BinvSN" not in theta:
                theta["_BinvSN"] = bell.supernode_jacobi_inverse(
                    bplan, bell.extract_self_blocks_vector(bplan, theta["_BellWel"]),
                    mask=mask_u)
            if "_McSNP2" not in theta:
                theta["_McSNP2"] = bell.supernode_jacobi_inverse(
                    p2plan, bell.extract_self_blocks_scalar(p2plan, Wrd2), mask=mask_c)
        return theta

    def _rd_builders(self):
        """(rd_jacobian, rd_jacobian_chord, rd_precond) of the pcg branch's
        concentration block: the P1 halo-ELL operators with their
        supernode block-Jacobi and the scalar coarse level, or (a quad
        model) the assembled P2 operators on the P2 plan with supernode
        block-Jacobi alone (reference base.py:617-659, :1671-1680)."""
        bmv = self._k.bmv
        if self.quad:
            p2plan, p2k = self._get_p2_plan(), self.p2

            def rd_jacobian(theta, c):
                W = theta["_P2BWrdC"] + p2_ell.build_p2_rd_wc(
                    p2plan, p2k, c, theta["rho"], theta["dt"], 1.0)
                return lambda v: bell.apply_bell_scalar(p2plan, W, v, bmv)

            def rd_jacobian_chord(theta, c):
                W = theta["_P2BWrdC"]
                dl = p2_ell.build_p2_rd_wc_lumped(p2k, c, theta["rho"], theta["dt"], 1.0)
                return lambda v: bell.apply_bell_scalar(p2plan, W, v, bmv) + dl * v

            def rd_precond(theta):
                Minv = theta["_McSNP2"]
                return lambda r: bell.apply_supernode_jacobi(p2plan, Minv, r, bmv)

            return rd_jacobian, rd_jacobian_chord, rd_precond

        bplan = self._get_bell_plan()
        arrays = self._mesh_arrays()
        kern = self.kernels
        agg = self._twolevel_aggplan()

        def rd_jacobian(theta, c):
            W = theta["_BellWrdC"] + bell.build_bell_rd_wc(
                bplan, arrays, kern.cells_flat, c, theta["rho"], theta["dt"],
                kern._t0, 1.0)
            return lambda v: bell.apply_bell_scalar(bplan, W, v, bmv)

        def rd_jacobian_chord(theta, c):
            # constant planes + the lumped logistic diagonal: skips the
            # per-step halo-ELL assembly of the exact correction
            W = theta["_BellWrdC"]
            dl = bell.build_bell_rd_wc_lumped(
                bplan, arrays, kern.cells_flat, c, theta["rho"], theta["dt"],
                kern._t0, 1.0)
            return lambda v: bell.apply_bell_scalar(bplan, W, v, bmv) + dl * v

        def rd_precond(theta):
            Minv = theta["_McSN"]
            base = lambda r: bell.apply_supernode_jacobi(bplan, Minv, r, bmv)  # noqa: E731
            if agg is None or "_TLCfacS" not in theta:
                return base
            return twolevel.make_twolevel_precond_scalar(
                agg, theta["_TLCfacS"], theta["_TLMtS"], base, theta.get("_TLCfacST"))

        return rd_jacobian, rd_jacobian_chord, rd_precond

    def _bell_builders(self):
        """Operator and preconditioner builders of the pcg branch
        (reference base.py:522-616 bell branch, :1580-1692)."""
        bplan = self._get_bell_plan()
        bmv = self._k.bmv
        agg = self._twolevel_aggplan()

        def el_operator(theta):
            W = theta["_BellWel"]
            return lambda u: bell.apply_bell_vector(bplan, W, u, bmv)

        def el_precond(theta):
            Binv = theta["_BinvSN"]
            base = lambda r: bell.apply_supernode_jacobi(bplan, Binv, r, bmv)  # noqa: E731
            if agg is None or "_TLCfac" not in theta:
                return base
            return twolevel.make_twolevel_precond(
                agg, theta["_TLCfac"], theta["_TLMt"], base, theta.get("_TLCfacT"))

        rd_jacobian, rd_jacobian_chord, rd_precond = self._rd_builders()
        return dict(rd_jacobian=rd_jacobian, el_operator=el_operator,
                    rd_precond=rd_precond, el_precond=el_precond,
                    rd_jacobian_chord=rd_jacobian_chord)

    def _streamed_mass_action(self, theta):
        """v -> M v through the assembled mass plane (feeds the algebraic
        rd anchor; a quad model's is its P2 mass action), or None on the
        lattice lane."""
        if self.quad:
            return self.concentration_mass_action
        if "_BellMrd" not in theta:
            return None
        bplan, Mrd, bmv = self._get_bell_plan(), theta["_BellMrd"], self._k.bmv
        return lambda v: bell.apply_bell_scalar(bplan, Mrd, v, bmv)

    # mass actions per subspace (the objective's L2 norms, optimize/)
    def concentration_mass_action(self, c):
        return self.kernels.mass_residual(c)

    def displacement_mass_action(self, u):
        return self.kernels.mass_vector_residual(u)

    # -- step and time loop ----------------------------------------------------

    def _augment_theta_with_operators(self, theta):
        """Theta-only operator planes, built once per simulate and never in
        the time loop."""
        theta = dict(theta)
        if self.lattice:
            return self._augment_lattice(theta)
        for key in ("_TLCfac", "_TLCfacS"):
            if key in theta and theta[key].dtype == torch.bfloat16:
                # row-major copies of the bf16 factors' transposes, for
                # the coarse term's first product (solvers/twolevel.py)
                theta[key + "T"] = theta[key].T.contiguous()
        return self._augment_bell(theta)

    def _build_step(self):
        mask_u, mask_c, gu, gc = self._bc_masks_and_values()

        def record(kind, info):
            self.solver_info[f"{kind}_cg_iters"].append(info["iters"])

        hi = self.hi_residual_fns() if self.step_config.refine_f64 else None
        common = dict(
            rd_residual=self.rd_residual, el_residual=self.el_residual,
            mask_c=mask_c, mask_u=mask_u, bc_values_c=gc, bc_values_u=gu,
            config=self.step_config, record=record,
            rd_residual_hi=hi[0] if hi else None, el_residual_hi=hi[1] if hi else None,
        )
        if self.lattice:
            rd_cg, el_cg = self._stencil_operators()
            return make_step(rd_cg=rd_cg, el_cg=el_cg, **common)
        return make_step(**self._bell_builders(), **common)

    def build_simulate_fn(self, n_steps: int, dt: float):
        """``simulate(theta, u0, c0, aux=None) -> (u_traj, c_traj, ok,
        newton_iters)`` with arrays (n_steps, ...) on the model's device
        (``newton_iters`` on the host).  ``aux`` (default
        :meth:`runtime_aux`) is merged into theta before the operators are
        built; keys it lacks are built per simulate.  Once a step fails to
        converge, the state freezes and every later step is flagged
        (reference base.py:1843-1845).

        On the unstructured lane each step starts from the linear
        extrapolation 2 x_k - x_{k-1} of the last two states, and, without
        concentration Dirichlet conditions, carries the Newton anchor
        ||r_c(c_prev)|| algebraically as ||M (c_k - c_{k-1})|| (reference
        base.py:1746-1886).  The anchor only scales tolerances: it is
        detached (the reference's ``stop_gradient``), so a frozen step's
        zero norm puts no NaN in a gradient.  The trajectory is stacked
        from the steps' outputs and keeps their graph."""
        step = self._build_step()
        warm = not self.lattice
        # the algebraic anchor is exact only when the concentration clamp
        # values are step-invariant: no concentration Dirichlet conditions
        no_c_dirichlet = not any(
            bc.subspace_id == self.SUBSPACE_CONCENTRATION
            for bc in self.bcs.dirichlet_bcs
        )
        _, mask_c, _, gc = self._bc_masks_and_values()

        def simulate(theta, u0, c0, aux=None):
            self.solver_info = _new_solver_info()
            theta = {**theta, **(self.runtime_aux() if aux is None else aux)}
            theta = self._augment_theta_with_operators(theta)
            mass_fn = (self._streamed_mass_action(theta)
                       if warm and no_c_dirichlet else None)
            anchor = None
            if mass_fn is not None:
                c0a = torch.where(mask_c, gc(dt), c0)
                r0a = torch.where(mask_c, 0.0, self.rd_residual(c0a, c0a, theta, dt))
                anchor = torch.linalg.vector_norm(r0a).detach()
            u_traj, c_traj, ok_traj, newton = [], [], [], []
            u_prev, c_prev, u_pp, c_pp = u0, c0, u0, c0
            ok = torch.ones((), dtype=torch.bool, device=c0.device)
            for i in range(n_steps):
                t = (i + 1.0) * dt
                if warm:
                    guess = (2.0 * u_prev - u_pp, 2.0 * c_prev - c_pp)
                    u, c, conv, n_newton = step(theta, u_prev, c_prev, t,
                                                guess, anchor)
                else:
                    u, c, conv, n_newton = step(theta, u_prev, c_prev, t)
                ok = ok & conv
                u_out = torch.where(ok, u, u_prev)
                c_out = torch.where(ok, c, c_prev)
                if anchor is not None:
                    # next step's ||r_c(c_out)|| = ||r_final - M dc||, with
                    # ||r_final|| <= ftol; a frozen step keeps its anchor
                    mdc = torch.where(mask_c, 0.0, mass_fn(c_out - c_prev))
                    anchor = torch.where(ok, torch.linalg.vector_norm(mdc),
                                         anchor).detach()
                u_pp, c_pp, u_prev, c_prev = u_prev, c_prev, u_out, c_out
                u_traj.append(u_out)
                c_traj.append(c_out)
                ok_traj.append(ok)
                newton.append(n_newton)
            return (torch.stack(u_traj), torch.stack(c_traj), torch.stack(ok_traj),
                    torch.tensor(newton, dtype=torch.int32))

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
