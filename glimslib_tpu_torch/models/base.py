"""Time-dependent simulation (counterpart of
``glimslib_tpu/models/base.py``).

Same orchestration API as the reference:

    sim = Model(mesh, dtype=torch.float32)      # on the card by default
    sim.setup_global_parameters(label_function=..., domain_names=...,
                                boundaries=..., dirichlet_bcs=...)
    sim.setup_model_parameters(iv_expression=..., ..., sim_time=...,
                               sim_time_step=...)
    solution = sim.run(save_method=None)     # {0: u, 1: c}; sim.results
    simulate = sim.build_simulate_fn(n_steps, dt)   # the trajectory as tensors
    u_traj, c_traj, ok, newton_iters = simulate(
        sim.make_theta(sim.params.as_dict()), *sim.initial_state())

Three operator lanes, chosen by the mesh and ``operator_mode``:

- **Lattice meshes**: offset-stencil operators (``ops/stencil.py``) built
  once per simulate, the block-triangular Newton-CG step
  (``solvers/coupled.py``) with both linear solves in the whole-solve
  CUDA PCG kernel, and streaming residuals through the CUDA stencil
  kernel.  With Chebyshev preconditioning (``precond_degree > 1``) the
  solves take the pcg branch on the stencil planes instead (every matvec
  a launch of the stencil kernel, extrapolated warm starts), as under
  node sharding, with the spectral bounds estimated once a simulate.
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
  ``ops/p2.py``, or with ``GLIMS_P2STREAM=1`` the streamed rd residual
  (:meth:`Simulation._p2_stream`: two ``bell_bmv`` matvecs of the P2
  planes and the quadratic term).  The elasticity block and its
  preconditioners are the P1 lane's.
- **The matrix-free jvp lane** (``operator_mode = "matrix-free"``, and
  the quad models on lattice meshes, as in the reference): no assembled
  operator, no stencil plane and no whole-solve kernel; each linear
  solve is ``pcg`` on the ``torch.func.jvp`` of the masked per-cell
  gather residuals (``ops/assembly.py P1Kernels``, ``ops/p2.py
  P2Kernels``), Jacobi on the rd block (``rd_diag``) and per-node (d, d)
  block-Jacobi on the elasticity block (``_BinvG``, hoisted once a
  simulate), without warm starts.  It launches no CUDA kernel.

- **The node block-ELL lane** (``GLIMS_BELL=0`` on an unstructured mesh,
  as in the reference): the elasticity operator and the P1 rd Jacobian
  assembled per node (``ops/ell.py``: one row gather and a multiply-sum a
  matvec, plain torch on every device), the gather residuals, Jacobi on
  the rd block and per-node block-Jacobi inside the two-level level on
  the elasticity block, no supernode state; a quad model's rd block on
  the jvp lane beside it.

A block whose equation carries a von Neumann facet term, or a
time-dependent source or body force, leaves the streamed residual for
the gather one on every lane (:meth:`Simulation._stencil_rd_residual_ok`,
:meth:`Simulation._stencil_el_residual_ok`); its solves keep the lane's
kernels.

The reference's switches are read with its names, values and meaning,
where it reads them (each plan on a mesh is cached by its sizes; the P2
dof layout is cached on the mesh, so a model under another
``GLIMS_P2_INTERLEAVE`` needs a mesh of its own): ``GLIMS_BELL`` (0: the
node block-ELL lane), ``GLIMS_BELL_S`` (supernode size, 32),
``GLIMS_P2_S`` (the P2 plan's, else ``GLIMS_BELL_S``, else 64),
``GLIMS_P2BELL`` (0: a quad model's rd block on the jvp lane),
``GLIMS_P2_INTERLEAVE`` (0: the canonical P2 dof order),
``GLIMS_P2_HALO_CHUNK`` and ``GLIMS_ASSEMBLE_CHUNK_SLOTS``
(``ops/bell.py``; both off where unset, unlike the reference's defaults),
``GLIMS_TWOLEVEL`` (0: no coarse level), ``GLIMS_TWOLEVEL_MIN_NODES``
(4000), ``GLIMS_TWOLEVEL_AGG`` (aggregate size, 64), ``GLIMS_COARSE_K``
(the coarse factors' width: auto, max(2048, 3/5 of the coarse
dimension); 0 the full factor; or an integer), ``GLIMS_TWOLEVEL_BF16``
(0: f32 coarse factors on f32 models), ``GLIMS_FACTORED`` (0: no
factored channel stacks), ``GLIMS_P2STREAM``; ``GLIMS_WARM_ORDER=3`` and
``GLIMS_ALG_ANCHOR=0`` change the warm starts
(:meth:`Simulation.build_simulate_fn`).  On f32 models the default step
refines in f64 (``config.resolve_refine_f64``; ``solvers/coupled.py``).

Both lanes are differentiable: ``simulate`` keeps the autograd graph
through the time loop (each step is the implicit-function-theorem adjoint
of ``solvers/coupled.py``), so ``torch.autograd.grad`` of an objective of
the trajectory gives the reference's exact gradient (``optimize/``).

Solver non-convergence freezes the carried state and flags the remaining
steps, as in the reference.  ``plain=True`` routes every kernel call
through its plain torch version on any device: a reference run for
checking the kernels on the card.  Quad models under the ``cells`` and
``nodes`` sharding modes raise ``NotImplementedError`` (the reference's
cannot run them either).

Sharding (:meth:`Simulation.use_sharding`) on every rank of a
``torch.distributed`` group.  Mode ``bell``: the model's supernode tables
live as this rank's slab of blocks, and its two-level factors and mode
matrices as its aggregates' rows; node vectors stay replicated.  Mode
``nodes`` on a lattice mesh: the rank owns a slab of node rows
(``parallel/gspmd.py``); its planes, state and solver vectors hold those
rows, each stencil apply reads them halo-padded through the halo form of
``stencil_apply``, and the solves take the reference's pcg branch with
every dot product reduced over the ranks; a gradient goes through the
halo exchange's transpose and the halo form's backward, and theta's
coefficients enter the slab work through ``parallel.shard.enter`` (their
cotangent summed over the ranks once); on the matrix-free lane the gather
residuals run on the slab's cells.  Mode ``cells``, and ``nodes`` on an
unstructured mesh: the model's kernels become the sharded element kernels
(``parallel/shard.py ShardedP1Kernels``, a rank's block of cells with
replicated vectors; ``parallel/nodeshard.py NodeShardedP1Kernels``, owned
rows and a ghost exchange) and the solves take the matrix-free jvp lane,
the jvp and the gradient passing through the collectives.  Von Neumann
conditions take this rank's share of their facets under ``cells`` and
``nodes`` (:meth:`Simulation._von_neumann_kernels`).
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
from glimslib_tpu_torch.parallel import shard
from glimslib_tpu_torch.solvers import twolevel
from glimslib_tpu_torch.solvers.cg import estimate_lmax
from glimslib_tpu_torch.solvers.coupled import StepConfig, _masked_op, make_step

logger = logging.getLogger(__name__)


def _kernel_ops(plain: bool):
    """The kernel calls the step makes: the kernel wrappers, or
    (``plain``) their plain torch versions (differentiated by torch's own
    VJPs; they ignore the wrappers' mirrored-plane cache)."""
    sk, fc, bk = stencil_kernels, fused_cg, bell_kernels
    if plain:
        return types.SimpleNamespace(
            apply_scalar_sum=lambda o, terms, b, cache=None, halo=0: (
                sk.apply_scalar_sum_plain(o, terms, b, halo)),
            apply_scalar=lambda o, W, v, cache=None, halo=0: sk.apply_scalar_plain(
                o, W, v, halo),
            apply_vector=lambda o, W, u, cache=None, halo=0: sk.apply_vector_plain(
                o, W, u, halo),
            apply_coupling=lambda o, C, c, cache=None, halo=0: sk.apply_coupling_plain(
                o, C, c, halo),
            cg_scalar=fc.cg_scalar_plain, cg_vector=fc.cg_vector_plain,
            bmv=bk.batched_matvec_plain,
        )
    return types.SimpleNamespace(
        apply_scalar_sum=sk.apply_scalar_sum, apply_scalar=sk.apply_scalar,
        apply_vector=sk.apply_vector, apply_coupling=sk.apply_coupling,
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
    """Spectral-truncation width of a coarse factor, or None (the full
    factor), by ``GLIMS_COARSE_K`` as in the reference (base.py:735-752):
    ``auto`` (the default) max(2048, 3/5 dim_c) columns, ``0`` the full
    factor, an integer that many columns (below dim_c)."""
    v = os.environ.get("GLIMS_COARSE_K", "auto").strip().lower()
    if v in ("auto", ""):
        k = max(2048, (3 * dim_c) // 5)
        return k if k < dim_c else None
    k = int(v)
    return k if 0 < k < dim_c else None


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
    # set by use_sharding: the mode and the mesh of ranks; under 'bell'
    # the model's own slab plans (never the plans its mesh caches)
    sharding_mode = None
    device_mesh = None
    _bell_slab = None
    _p2_slab = None
    _p2_sharded = False
    # set by use_sharding(mode='nodes'): this rank's node slab (lattice)
    _node_slab = None
    # set by use_sharding(mode='nodes'): this rank's rows (start, n_own,
    # n_total, own()): the lattice's slab or the unstructured kernels
    _node_rows = None
    # this rank's facet kernels of the von Neumann entries, by (name, hi)
    _vn_cache = None
    # the projected initial values, by the parameters' expressions
    _iv_cache = None
    # 'auto': the assembled lanes (stencil planes on a lattice, halo-ELL
    # planes elsewhere); 'matrix-free': the jvp lane everywhere
    operator_mode = "auto"

    def __init__(self, mesh, time_dependent=True, dtype=None, device=None,
                 plain=False):
        self.lattice = mesh.lattice_strides is not None
        self.quad = self.CONCENTRATION_DEGREE == 2
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
        self._plan_seconds = {}  # host seconds of each plan's build
        self._aux_cache = None
        self._bc_cache = None
        self._unused = None
        # per-solve CG iteration counts (0-d tensors) of the last simulate
        # and of its backward
        self.solver_info = _new_solver_info()
        self.step_config = default_step_config(self.dtype)

    @property
    def matrix_free(self):
        """True where the model takes the matrix-free jvp lane:
        ``operator_mode = "matrix-free"``, a quad model on a lattice mesh
        (the stencil operators are P1; reference base.py:1028-1029,
        :528-529), or sharded element kernels (``'cells'``, and ``'nodes'``
        on an unstructured mesh: the reference's gates on
        ``type(self.kernels)``, base.py:454-465, :530-531, :1030-1032)."""
        return (self.operator_mode == "matrix-free" or (self.quad and self.lattice)
                or self._sharded_kernels)

    @property
    def _sharded_kernels(self):
        """True under ``'cells'`` and under ``'nodes'`` on an unstructured
        mesh: the model's kernels are the sharded element kernels."""
        return self.sharding_mode == "cells" or (self.sharding_mode == "nodes"
                                                 and not self.lattice)

    def use_sharding(self, device_mesh=None, n_devices=None, mode="auto"):
        """Distribute the simulation over the ranks of a process group (the
        reference's ``use_sharding``, base.py:116-262, the analogue of
        running under ``mpirun``): every rank calls it, on the same model.

        ``device_mesh`` defaults to :func:`make_device_mesh` on the
        model's device, which needs an initialised group (``torchrun``, or
        ``parallel.run_ranks``).  ``mode="auto"`` decides as the reference
        does: ``'nodes'`` on a lattice mesh whose node count the world
        divides (not on the matrix-free lane), ``'bell'`` where the
        supernode halo-ELL path runs and the world divides its block
        count, else ``'cells'``, with the reference's warning naming why.

        ``'bell'``: every supernode table (operator planes, factored
        channel stacks, supernode inverses; the quad models' P2 tables
        too, unless the world does not divide their block count: then
        they stay replicated, with the reference's warning) is held as
        this rank's slab of nb / world blocks, and the two-level factors
        and mode matrices as its aggregates' rows; node vectors stay
        replicated, and each contraction gathers its slabs' rows.  The
        frozen state is rebuilt as slabs.  On the card it turns on
        ``torch.use_deterministic_algorithms`` (warn-only, uninitialised
        memory not filled) for the process: the ranks must compute their
        replicated work bit for bit alike to take the same solver paths.

        ``'nodes'`` on a lattice mesh (``n_nodes`` must divide by the
        world: pad with :func:`~glimslib_tpu_torch.core.mesh.pad_mesh_nodes`
        first): the rank owns n / world node rows
        (:class:`~glimslib_tpu_torch.parallel.gspmd.NodeSlab`).  Its
        stencil planes, masks, state and trajectory hold those rows; each
        stencil apply exchanges a halo of max |offset| rows and launches
        the halo form of ``stencil_apply``; the solves take the
        reference's pcg branch (the whole-solve kernel is off in this
        mode there too: Jacobi on the rd block, block-Jacobi on the
        elasticity block, extrapolated warm starts, the chord Jacobian
        where refine_f64 is off) with every norm and dot product reduced
        over the ranks.  On the matrix-free lane the gather residuals run
        on the slab's cells after one halo exchange, and the jvp
        differentiates through it.

        ``'nodes'`` on an unstructured mesh (the same divisibility):
        the owned/ghost node sharding of ``parallel/nodeshard.py``
        (:class:`~glimslib_tpu_torch.parallel.nodeshard.NodeShardedP1Kernels`;
        use a Morton-ordered mesh): the rank owns n / world rows and the
        cells touching them, and each residual exchanges the ghost rows it
        reads.  ``'cells'``: the element kernels on this rank's block of
        cells (:class:`~glimslib_tpu_torch.parallel.shard.ShardedP1Kernels`,
        the native graph partitioner), their node sums reduced over the
        ranks; node vectors stay replicated, and on the card it turns on
        deterministic algorithms as ``'bell'`` does.  Both swap the
        model's kernels and run the matrix-free jvp lane, as the
        reference's do: no assembled operator and no kernel of the port;
        Jacobi on the rd block, and on the elasticity block per-node
        block-Jacobi under ``'nodes'`` and point-Jacobi under ``'cells'``
        (its kernels have no ``elasticity_diag_blocks``).

        Under ``'nodes'`` ``build_simulate_fn``'s simulate takes and
        returns the rank's rows and ``run()`` gathers the fields; a
        gradient through simulate is the gradient of the ranks' summed
        objective, the same on every rank (the exchanges' transposes;
        theta's coefficients enter the rank's work through
        ``shard.enter``, their cotangent summed over the ranks once);
        ``optimize.InverseProblem`` reduces its objective over the ranks.
        Under ``'cells'`` the fields are replicated.

        Von Neumann conditions run in every mode: under ``'cells'`` a rank
        takes the facets whose owning cell lies in its block and adds
        their terms to its partial residual before the one sum over the
        ranks; under ``'nodes'`` the facets with a node among its rows,
        their terms on its rows (:meth:`_von_neumann_kernels`).  Quad
        models under ``'cells'`` and ``'nodes'`` raise
        ``NotImplementedError`` (the reference's quad models call
        ``elasticity_residual_cint``, which its sharded kernels lack).
        Returns the mesh."""
        if device_mesh is None:
            device_mesh = shard.make_device_mesh(n_devices, device=self.device)
        if device_mesh.device != shard.canonical_device(self.device):
            raise ValueError(f"the mesh of ranks is on {device_mesh.device}, the "
                             f"model on {self.device}")
        n_dev = device_mesh.world
        bell_ok = self._use_bell()
        if mode == "auto":
            if (self.lattice and not self.matrix_free
                    and self.mesh.n_nodes % n_dev == 0):
                mode = "nodes"
            elif bell_ok and self._get_bell_plan().nb % n_dev == 0:
                mode = "bell"
            else:
                mode = "cells"
                if self.matrix_free:
                    why = ("the assembled operators are off (operator_mode "
                           "'matrix-free', or a quad model on a lattice mesh)")
                elif self.lattice:
                    why = (f"lattice mesh with n_nodes={self.mesh.n_nodes} not "
                           f"divisible by {n_dev} devices (pad with "
                           "core.mesh.pad_mesh_nodes)")
                elif not bell_ok:
                    why = ("supernode halo-ELL path inactive (needs an "
                           "unstructured mesh, GLIMS_BELL != 0, and "
                           "operator_mode != 'matrix-free')")
                else:
                    why = (f"supernode block count {self._get_bell_plan().nb} not "
                           f"divisible by {n_dev} devices (use a power-of-two "
                           "device count)")
                self.logger.warning(
                    "use_sharding(mode='auto') fell back to the SLOW 'cells' lane "
                    "(replicated vectors, gather element kernels): %s", why)
        if mode in ("cells", "nodes"):
            self._refuse_sharded(mode)
        if mode == "bell":
            if not bell_ok:
                raise ValueError("mode='bell' needs the supernode halo-ELL path "
                                 "(unstructured mesh, GLIMS_BELL != 0, P1 kernels)")
            bplan = self._get_bell_plan()
            if bplan.nb % n_dev:
                raise ValueError(
                    f"supernode block count {bplan.nb} not divisible by {n_dev} "
                    "devices (BellPlan pads nb to a multiple of 8; use a "
                    "power-of-two device count)")
            self._deterministic_on_card()
            self._bell_slab = bell.SlabPlan(bplan, device_mesh)
            if self._use_p2_bell():
                p2plan = self._get_p2_plan()
                self._p2_sharded = p2plan.nb % n_dev == 0
                if self._p2_sharded:
                    self._p2_slab = bell.SlabPlan(p2plan, device_mesh)
                else:
                    self.logger.warning(
                        "P2 supernode block count %d not divisible by %d devices "
                        "— quad concentration tables stay replicated", p2plan.nb,
                        n_dev)
            # the frozen state is rebuilt as this rank's slabs
            self._aux_cache = None
        elif mode == "nodes" and self.lattice:
            from glimslib_tpu_torch.parallel.gspmd import NodeSlab

            # raises the reference's divisibility error (pad_mesh_nodes)
            slab = NodeSlab(self.mesh, device_mesh.rank, n_dev, device=self.device)
            self._node_slab = self._node_rows = slab
            self.kernels = P1Kernels(slab.local_mesh, dtype=self.dtype,
                                     device=self.device, rows=slab.own_rows)
            self._stencil_ops = None
        elif mode == "nodes":
            from glimslib_tpu_torch.parallel.nodeshard import NodeShardedP1Kernels

            # raises the reference's divisibility error (pad_mesh_nodes)
            self.kernels = NodeShardedP1Kernels(self.mesh, device_mesh, dtype=self.dtype,
                                                device=self.device)
            self._node_rows = self.kernels
        elif mode == "cells":
            self._deterministic_on_card()
            self.kernels = shard.ShardedP1Kernels(self.mesh, device_mesh, dtype=self.dtype,
                                                  device=self.device)
        else:
            raise ValueError(f"unknown sharding mode {mode!r}")
        if mode != "bell":
            self._kernels_hi = self._cell_mid = self._cell_mid_hi = None
            self._bc_cache = self._vn_cache = None
            self._aux_cache = None
        self.device_mesh = device_mesh
        self.sharding_mode = mode
        return device_mesh

    def _refuse_sharded(self, mode):
        """The models ``'cells'`` and ``'nodes'`` do not run."""
        if self.quad:
            raise NotImplementedError(
                f"use_sharding: mode={mode!r} on a quad model: the reference's quad "
                "models call kernels.elasticity_residual_cint, which its sharded "
                "kernels (ShardedP1Kernels, NodeShardedP1Kernels) do not have; use "
                "mode='bell' on an unstructured mesh, or run the model unsharded")

    def _deterministic_on_card(self):
        """On the card: deterministic algorithms for the process.  Every rank
        must compute the replicated work bit for bit alike, or the ranks'
        solvers stop at different iterations and their collectives part;
        on the card index_add_ and the backward of index_select add by
        atomics in no fixed order."""
        if self.device.type == "cuda":
            torch.use_deterministic_algorithms(True, warn_only=True)
            torch.utils.deterministic.fill_uninitialized_memory = False

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

    def run_for_adjoint(self, parameters, output_dir=None):
        """The subclasses' runner of one forward for a differentiable
        objective (the base model has none)."""
        raise NotImplementedError

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
        self.bcs = BoundaryConditions(self.functionspace, self.subdomains,
                                      dtype=self.dtype, device=self.device)
        self.bcs.setup_dirichlet_boundary_conditions(dirichlet_bcs)
        self.bcs.setup_von_neumann_boundary_conditions(von_neumann_bcs)
        self._bc_cache = self._vn_cache = None
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
        """Nodes no cell references: treated as zero-Dirichlet dofs (a quad
        model's P2 vertex dofs there too)."""
        if self._unused is None:
            used = np.zeros(self.mesh.n_nodes, dtype=bool)
            used[self.mesh.cells.ravel()] = True
            self._unused = ~used
        return self._unused

    # -- node sharding: a rank's rows -------------------------------------------

    def _own(self, x):
        """This rank's rows of a whole node array under node sharding, else
        ``x``."""
        return x if self._node_rows is None else self._node_rows.own(x)

    def _halo(self, *xs):
        """The halo-padded forms of node vectors (this rank's rows) under
        node sharding, in one exchange, else the vectors themselves."""
        if self._node_slab is None:
            return list(xs)
        from glimslib_tpu_torch.parallel.gspmd import halo_exchange_many

        return halo_exchange_many(self.device_mesh, self._node_slab, *xs)

    @property
    def _halo_rows(self):
        """The halo form's ``halo`` argument: H under node sharding, else 0."""
        return 0 if self._node_slab is None else self._node_slab.halo

    def _reduce(self):
        """The solvers' ``reduce`` hook under node sharding (a sum over the
        ranks), else None (under ``'cells'`` the vectors are replicated)."""
        return None if self._node_rows is None else self.device_mesh.all_reduce

    def _replicated_input(self, v):
        """theta's replicated coefficient ``v`` as an input of this rank's
        work outside the kernels (its von Neumann terms): under ``'cells'``
        and the unstructured ``'nodes'`` it enters (``shard.enter``: its
        cotangent summed over the ranks once); elsewhere theta is the
        model's own (the lattice's slab entered it once a simulate)."""
        return shard.enter(self.device_mesh, v) if self._sharded_kernels else v

    def _von_neumann_kernels(self, name, bc, hi=False):
        """The facet kernels of the von Neumann entry ``name`` and the
        cells whose coefficients its facets take (indices into theta's
        per-cell coefficients, a tensor): the entry's own, or under
        ``'cells'`` and ``'nodes'`` this rank's share, built once
        (``hi``: f64).  Under ``'cells'`` the rank takes the facets whose
        owning cell lies in its block, on the whole node vector: its term
        is a partial, summed over the ranks with the kernels' own.  Under
        ``'nodes'`` it takes the facets with a node among its rows, their
        nodes numbered in those rows, the others dropped: its term is its
        rows of the whole one, and on the lattice's slab the cells are the
        slab's."""
        if self._vn_cache is None:
            self._vn_cache = {}
        key = (name, hi)
        if key not in self._vn_cache:
            kern = self.bcs.von_neumann_kernels(bc, hi=hi)
            cells = np.asarray(bc["facet_cells"], dtype=np.int64)
            if self.sharding_mode == "cells":
                keep = np.flatnonzero(np.isin(cells, self.kernels.block_cells))
                kern, cells = bc["kernel_factory"](kern.dtype, keep=keep), cells[keep]
            elif self.sharding_mode == "nodes":
                rows = self._node_rows
                lo, hi_ = rows.start, rows.start + rows.n_own
                fn = kern.facet_nodes
                keep = np.flatnonzero(((fn >= lo) & (fn < hi_)).any(axis=1))
                node_map = np.full(self.mesh.n_nodes, rows.n_own, dtype=np.int64)
                node_map[lo:hi_] = np.arange(rows.n_own)
                kern = bc["kernel_factory"](kern.dtype, n_rows=rows.n_own, keep=keep,
                                            node_map=node_map)
                cells = cells[keep]
                if self._node_slab is not None:
                    # a facet with an owned node lies on a cell of the slab
                    cells = np.searchsorted(self._node_slab.cell_ids, cells)
            self._vn_cache[key] = (kern, torch.as_tensor(cells, device=self.device))
        return self._vn_cache[key]

    def _bc_masks_and_values(self):
        """(mask_u, mask_c, gu(t), gc(t)) on the model's device (this rank's
        rows under node sharding)."""
        if self._bc_cache is None:
            sd, sc = self.SUBSPACE_DISPLACEMENT, self.SUBSPACE_CONCENTRATION
            mask_u, vu = self.bcs.dirichlet_mask_and_values(sd)
            mask_c, vc = self.bcs.dirichlet_mask_and_values(sc)
            unused = self._unused_node_mask()
            mask_u = mask_u | unused[:, None]
            if self.quad:
                # an unused node's P2 vertex dof has a zero row; every edge
                # dof lies on a cell.  The JAX package leaves these unmasked
                # and gives NaN on such meshes
                mask_c = mask_c.copy()
                mask_c[self.p2.vertex_dof_ids(np.flatnonzero(unused))] = True
            else:
                mask_c = mask_c | unused
            tdep = self.bcs.has_time_dependent_dirichlet
            own = self._own
            vu0, vc0 = self._tensor(own(vu)), self._tensor(own(vc))

            def gu(t):
                if not tdep:
                    return vu0
                return self._tensor(own(self.bcs.dirichlet_mask_and_values(sd, t)[1]))

            def gc(t):
                if not tdep:
                    return vc0
                return self._tensor(own(self.bcs.dirichlet_mask_and_values(sc, t)[1]))

            self._bc_cache = (
                self._tensor(own(mask_u), torch.bool),
                self._tensor(own(mask_c), torch.bool), gu, gc,
            )
        return self._bc_cache

    # -- lattice lane: offset stencils and whole-solve PCG ------------------------

    def _get_stencil_ops(self):
        """The mesh's offset-stencil operators (on this rank's node slab
        under node sharding), built once: their plan and geometry do not
        depend on theta."""
        if self._stencil_ops is None:
            self._stencil_ops = StencilOperators(self.mesh, dtype=self.dtype,
                                                 device=self.device, slab=self._node_slab)
        return self._stencil_ops

    def _stencil_operators(self):
        """Offset-stencil operators and the two whole-solve PCG callables
        (reference base.py:1023-1192, lattice branch; the TPU's VMEM
        fit checks and streamed-kernel selection have no counterpart)."""
        ops = self._get_stencil_ops()
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

    @property
    def _lattice_pcg(self):
        """True where a lattice model takes the pcg branch on its stencil
        planes instead of the whole-solve kernels: under node sharding,
        and with Chebyshev preconditioning (``precond_degree > 1``), as the
        reference's ``fused_ok`` gate (base.py:1110-1115) decides."""
        return (self.lattice and not self.matrix_free
                and (self._node_slab is not None or self.step_config.precond_degree > 1))

    def _node_builders(self):
        """Operator and preconditioner builders of the lattice's pcg branch
        (reference base.py:1023-1192 where the whole-solve kernels are
        off), on this rank's node slab or, unsharded, on the whole mesh:
        the rd Jacobian ``_Wrd_const`` plus ``build_rd_wc`` planes of the
        (halo-padded) ``c``, the elasticity planes ``_Wel``, each applied
        through ``stencil_apply`` (its halo form after one halo exchange
        on a slab); Jacobi from ``rd_diag`` and block-Jacobi from
        ``_Binv`` on the (owned) rows."""
        ops = self._get_stencil_ops()
        k, h, halo = self._k, self._halo_rows, self._halo

        def rd_jacobian(theta, c):
            (c_h,) = halo(c)
            W = theta["_Wrd_const"] + ops.build_rd_wc(c_h, theta["rho"], theta["dt"],
                                                      conc_max=1.0)
            return lambda v: k.apply_scalar(ops.offsets, W, halo(v)[0], halo=h)

        def el_operator(theta):
            W = theta["_Wel"]
            return lambda u: k.apply_vector(ops.offsets, W, halo(u)[0], halo=h)

        def rd_precond(theta):
            diag = theta["_rd_diag"]
            return lambda r: r / diag

        def el_precond(theta):
            Binv = theta["_Binv"]
            return lambda r: ops.apply_block_jacobi(Binv, r)

        return dict(rd_jacobian=rd_jacobian, el_operator=el_operator,
                    rd_precond=rd_precond, el_precond=el_precond)

    def _augment_lattice(self, theta):
        """Theta-only stencil planes and mask-folded solver state (reference
        base.py:1440-1503, lattice branch).  Keys: ``_Wel``/``_Binv``
        elasticity planes and block inverse, ``_WelM``/``_BinvM``/``_invdM``
        their mask-folded forms for the PCG kernels (``_rd_diag``, the rd
        Jacobi diagonal, in their place on the pcg branch), ``_Wrd_const``/``_Mst``
        the constant rd planes, ``_Cuc`` the coupling planes, the constant
        loads ``_rd_load``/``_el_load`` (``_Mst``, ``_rd_load``, ``_Cuc``
        and ``_el_load`` only where that block's residual streams), and
        ``_mirrors``, the cache of the transposed planes the backward
        applies.  The solver state is built
        without a graph: it feeds solvers only, so its cotangent is zero by
        design, as in the reference.  Under node sharding every key holds
        this rank's rows and ``_mirrors`` builds the halo form's mirrored
        (extended) planes.  With Chebyshev preconditioning the spectral
        bounds ``_lmax_u`` / ``_lmax_c`` (:meth:`_lattice_lmax`)."""
        ops = self._stencil_ops
        mask_u, mask_c, _, _ = self._bc_masks_and_values()
        pcg = self._lattice_pcg
        Wel = ops.build_elasticity(theta["mu"], theta["lam"])
        theta["_Wel"] = Wel
        with torch.no_grad():
            # nodes no cell touches (an image's full lattice) have a zero
            # block: identity there, which the mask folding keeps
            unused = self._tensor(self._own(self._unused_node_mask()), torch.bool)
            theta["_Binv"] = ops.block_jacobi_inverse(Wel, unused[:, None])
            if pcg:
                theta["_rd_diag"] = self.rd_diag(theta)
            else:
                theta["_WelM"] = fused_cg.fold_mask_vector(ops.offsets, Wel, mask_u)
                theta["_BinvM"] = fused_cg.fold_mask_binv(theta["_Binv"], mask_u)
                theta["_invdM"] = fused_cg.fold_mask_invdiag(self.rd_diag(theta),
                                                             mask_c)
        theta["_Wrd_const"] = ops.build_rd_jacobian_const(
            theta["D"], theta["rho"], theta["dt"]
        )
        # the streamed residuals where no facet or time-dependent term
        # enters their block (else the gather residuals, reference
        # base.py:1501-1524)
        if self._stencil_rd_residual_ok():
            theta["_Mst"] = ops.build_mass_planes()
            # the kernels' node count: the halo-padded slab's under node sharding
            zeros = torch.zeros(self.kernels.n_nodes, dtype=self.dtype,
                                device=self.device)
            load = self.kernels.rd_residual(
                zeros, zeros, theta["D"], theta["rho"], theta["dt"],
                source=theta["source"],
            )
            theta["_rd_load"] = -load  # the residual carried -dt s v
        if self._stencil_el_residual_ok():
            theta["_Cuc"] = ops.build_coupling_uc(
                theta["mu"], theta["lam"], theta["coupling"]
            )
            theta["_el_load"] = self._body_load(theta)
        theta["_mirrors"] = stencil_kernels.MirrorCache(
            [theta[k] for k in ("_Mst", "_Cuc", "_Wel", "_Wrd_const") if k in theta])
        if self.step_config.precond_degree > 1:
            theta.update(self._lattice_lmax(theta))
        return theta

    def _lattice_lmax(self, theta):
        """The Chebyshev spectral bounds of the lattice, once a simulate
        (reference base.py:1504-1545): ``_lmax_u`` of the block-Jacobi
        elasticity operator by power iteration, and ``_lmax_c``, that of
        the constant rd planes under the Jacobi of their own diagonal plus
        the bound 2 dt max(rho) max(lumped / diag) of the logistic
        correction (its Jacobi-preconditioned row sums, c <= c_max).  Each
        apply goes through ``stencil_apply`` (its halo form on a slab,
        every norm and max then over the ranks).  Without a graph: the
        bounds shape the preconditioner only."""
        ops, k, h, halo = self._stencil_ops, self._k, self._halo_rows, self._halo
        mask_u, mask_c, _, _ = self._bc_masks_and_values()
        reduce = self._reduce()
        start = 0 if self._node_rows is None else self._node_rows.start
        n, d = mask_u.shape
        kw = dict(device=self.device, reduce=reduce)
        pcg = self._node_builders()
        with torch.no_grad():
            Wrd = theta["_Wrd_const"]
            Au = _masked_op(pcg["el_operator"](theta), mask_u)
            Mu = _masked_op(pcg["el_precond"](theta), mask_u)
            Ac = _masked_op(lambda v: k.apply_scalar(ops.offsets, Wrd, halo(v)[0], halo=h),
                            mask_c)
            diag_c = torch.where(mask_c, 1.0, Wrd[ops.offsets.index(0)])
            lmax_u = estimate_lmax(Au, Mu, (n, d), self.dtype, offset=start * d, **kw)
            lmax_const = estimate_lmax(Ac, lambda r: r / diag_c, (n,), self.dtype,
                                       offset=start, **kw)
            rho_max = torch.max(torch.atleast_1d(theta["rho"]))
            row_max = torch.max(torch.where(mask_c, 0.0, self.kernels.lumped_mass() / diag_c))
            if reduce is not None:
                # the slab's cells and rows: their maxima over the ranks
                rho_max, row_max = self.device_mesh.all_max(torch.stack([rho_max, row_max]))
            logistic = 2.0 * theta["dt"] * rho_max * row_max
        return {"_lmax_u": lmax_u, "_lmax_c": lmax_const + logistic}

    def _body_load(self, theta):
        """Constant body load ∫ b·v = lumped mass ⊗ body force, (n, d)."""
        lumped = self.kernels.lumped_mass()
        return lumped[:, None] * theta["body_force"].expand(self.mesh.dim)[None, :]

    # -- unstructured lane: supernode halo-ELL and two-level PCG ------------------

    def _mesh_plan(self, name, build, *sizes):
        """The plan ``name`` of this mesh on this device at ``sizes`` (its
        supernode size and halo chunk), built by ``build()`` once and
        cached on the (immutable) mesh object, as ``p2_dof_layout`` is: the
        sims of one mesh share it.  Its build seconds go into
        ``_plan_seconds`` of the sim that built it."""
        cache = getattr(self.mesh, "_plan_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(self.mesh, "_plan_cache", cache)
        key = (name, str(self.device)) + sizes
        if key not in cache:
            t0 = time.perf_counter()
            cache[key] = build()
            self._plan_seconds[name] = time.perf_counter() - t0
        return cache[key]

    def _use_bell(self):
        """The supernode halo-ELL lane (the reference's gate, base.py:454-465):
        an unstructured mesh off the matrix-free lane, unless
        ``GLIMS_BELL=0``, which puts the model on the node block-ELL lane
        (:meth:`_ell_builders`)."""
        return (os.environ.get("GLIMS_BELL", "1") != "0" and not self.lattice
                and not self.matrix_free)

    def _use_p2_bell(self):
        """A quad model's assembled P2 rd Jacobian on the P2 supernode plan
        (reference base.py:478-490): on the supernode lane unless
        ``GLIMS_P2BELL=0``, which leaves its rd block on the jvp lane beside
        the supernode elasticity block."""
        return (self.quad and self._use_bell()
                and os.environ.get("GLIMS_P2BELL", "1") != "0")

    def _get_bell_plan(self):
        """The mesh's supernode plan (``GLIMS_BELL_S`` nodes a supernode,
        default 32), or under block sharding this rank's slab of it
        (:class:`~glimslib_tpu_torch.ops.bell.SlabPlan`)."""
        if self._bell_slab is not None:
            return self._bell_slab
        if self._bell_plan is None:
            s = int(os.environ.get("GLIMS_BELL_S", "32"))
            self._bell_plan = self._mesh_plan(
                "bell_plan", lambda: bell.BellPlan(self.mesh, s=s, device=self.device), s)
        return self._bell_plan

    def _get_p2_plan(self):
        """The supernode plan over the P2 dofs of a quad model, or this
        rank's slab of it: s from ``GLIMS_P2_S``, else ``GLIMS_BELL_S``,
        else 64 (reference base.py:492-509), the halo chunk from
        ``GLIMS_P2_HALO_CHUNK`` (``ops/p2_ell.py p2_halo_chunk``)."""
        if self._p2_slab is not None:
            return self._p2_slab
        if self._p2_plan is None:
            s = int(os.environ.get("GLIMS_P2_S", os.environ.get("GLIMS_BELL_S", "64")))
            self._p2_plan = self._mesh_plan(
                "p2_plan", lambda: p2_ell.make_p2_plan(self.p2, s=s), s,
                p2_ell.p2_halo_chunk())
        return self._p2_plan

    def _get_ell_plan(self):
        """The mesh's node-adjacency ELL plan (the ``GLIMS_BELL=0`` lane's
        operators and the two-level coarse build)."""
        return self._mesh_plan("ell_plan", lambda: ell.EllPlan(self.mesh, device=self.device))

    def _coarse_slab(self):
        """This rank's aggregates of the two-level level, or None unsharded."""
        if self.sharding_mode != "bell":
            return None
        return twolevel.coarse_slab(self._twolevel_aggplan(), self.device_mesh)

    def _slab_input(self, theta):
        """theta's coefficients as inputs of this rank's slab tables
        (``parallel/shard.py enter``: their cotangent from the slab is
        summed over the ranks), or theta itself unsharded."""
        if self.sharding_mode != "bell":
            return theta
        mesh = self.device_mesh
        return {k: shard.enter(mesh, v) if torch.is_tensor(v) and not k.startswith("_")
                else v for k, v in theta.items()}

    def _mesh_arrays(self):
        return self.kernels.grads_T, self.kernels.vol

    def _twolevel_aggplan(self):
        """The coarse aggregation plan (``GLIMS_TWOLEVEL_AGG`` nodes an
        aggregate, default 64), or None under ``GLIMS_TWOLEVEL=0`` and on
        meshes below ``GLIMS_TWOLEVEL_MIN_NODES`` nodes (default 4000), as
        in the reference (base.py:703-733)."""
        if os.environ.get("GLIMS_TWOLEVEL", "1") == "0":
            return None
        if self.mesh.n_nodes < int(os.environ.get("GLIMS_TWOLEVEL_MIN_NODES",
                                                  "4000")):
            return None
        if self._agg_plan is None:
            self._agg_plan = twolevel.AggPlan(
                self.mesh, agg_size=int(os.environ.get("GLIMS_TWOLEVEL_AGG", "64")))
        return self._agg_plan

    def runtime_aux(self):
        """Frozen state of the unstructured lane, built once per model from
        the set-up parameters and cached (reference base.py:755-970): the
        supernode block-Jacobi inverses ``_BinvSN`` (nb, s d, s d) and
        ``_McSN`` (nb, s, s) (a quad model: ``_McSNP2`` (nb2, s2, s2) on
        the P2 plan), the factored channel stacks (:meth:`_factored_aux`),
        and, when the two-level level is on, its arrays
        (:meth:`_twolevel_aux`), the coarse factors in bf16 on f32 models
        unless ``GLIMS_TWOLEVEL_BF16=0``.  On the node block-ELL lane
        (``GLIMS_BELL=0``) the two-level arrays alone.  A preconditioner
        shapes iteration counts only, so freezing it across parameter
        updates never changes a solution.  ``setup_seconds`` records what
        the build took, by part, with the plans' build seconds (0 for a
        plan built before, by another sim of the mesh, or handed to the
        model).  {} on lattice meshes and on the matrix-free lane."""
        if self.lattice or self.matrix_free:
            return {}
        if self._aux_cache is not None:
            return self._aux_cache
        theta0 = self.make_theta(self.params.as_dict())
        if not self._use_bell():
            times = {}
            aux = self._twolevel_bf16(self._twolevel_aux(theta0, times))
            self._finish_aux(aux, times)
            return aux
        mask_u, mask_c, _, _ = self._bc_masks_and_values()
        bplan = self._get_bell_plan()
        times = {"bell_plan": self._plan_seconds.get("bell_plan", 0.0)}
        p2 = self._use_p2_bell()
        if p2:
            p2plan = self._get_p2_plan()
            times["p2_plan"] = self._plan_seconds.get("p2_plan", 0.0)
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
        if p2:
            t0 = time.perf_counter()
            Wrd2 = p2_ell.build_p2_rd_const(p2plan, self.p2, theta0["D"],
                                            theta0["rho"], theta0["dt"])
            aux["_McSNP2"] = bell.supernode_jacobi_inverse(
                p2plan, bell.extract_self_blocks_scalar(p2plan, Wrd2), mask=mask_c)
            del Wrd2
            self._sync()
            times["p2_supernode_jacobi"] = time.perf_counter() - t0
        aux.update(self._factored_aux(times))
        aux.update(self._twolevel_bf16(self._twolevel_aux(theta0, times)))
        self._finish_aux(aux, times)
        return aux

    def _twolevel_bf16(self, tl):
        """The two-level arrays with the coarse factors in bf16 on f32
        models, unless ``GLIMS_TWOLEVEL_BF16=0`` (reference base.py:807-811,
        :836-840): half the factors' memory traffic, the coarse apply's
        cost; the Gram form stays PSD in any storage precision."""
        if self.dtype == torch.float32 and os.environ.get("GLIMS_TWOLEVEL_BF16",
                                                          "1") != "0":
            for k in ("_TLCfac", "_TLCfacS"):
                if k in tl:
                    tl[k] = tl[k].to(torch.bfloat16)
        return tl

    def _finish_aux(self, aux, times):
        """Record and cache the frozen state ``aux`` built in ``times``."""
        self.setup_seconds = times
        self.logger.info("runtime aux built: %s", {k: f"{v:.2f} s"
                                                   for k, v in times.items()})
        self._aux_cache = aux

    def _twolevel_aux(self, theta0, times):
        """The two-level level's frozen arrays at the parameters of
        ``theta0``, {} where the level is off: the coarse Gram factors
        ``_TLCfac`` / ``_TLCfacS`` in the working dtype and the masked
        mode matrices ``_TLMt`` (n_pad, d, q) / ``_TLMtS`` (n_pad, qs); the
        build's seconds go into ``times``.  The level does not depend on
        the operator lane: its coarse matrices come from the node
        block-ELL values on either."""
        agg = self._twolevel_aggplan()
        if agg is None:
            return {}
        mask_u, mask_c, _, _ = self._bc_masks_and_values()
        arrays = self._mesh_arrays()
        m0 = self.kernels._m0
        aux = {}
        eplan = self._get_ell_plan()
        times["ell_plan"] = self._plan_seconds.get("ell_plan", 0.0)
        t0 = time.perf_counter()
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
        slab = self._coarse_slab()
        if slab is not None:
            # every rank builds the same factors from the same replicated
            # inputs and keeps its aggregates' rows of them
            _, a0, a1 = slab
            q, qs = twolevel.n_affine_modes(agg.d), twolevel.n_scalar_modes(agg.d)
            rows = {"_TLCfac": (a0 * q, a1 * q), "_TLCfacS": (a0 * qs, a1 * qs),
                    "_TLMt": (a0 * agg.m, a1 * agg.m), "_TLMtS": (a0 * agg.m, a1 * agg.m)}
            aux = {k: v[slice(*rows[k])].clone() for k, v in aux.items()}
        return aux

    def _factored_aux(self, times=None):
        """The frozen per-class channel stacks of the theta planes
        (``ops/bell_factored.py build_cache``; a quad model: the
        elasticity channels and the P2 rd channels of ``build_p2_cache``)
        where the model guarantees class-wise constant coefficients
        (:meth:`theta_class_labels`), {} otherwise.  Their build seconds
        go into ``times``.  {} under ``GLIMS_FACTORED=0``: every simulate
        then assembles its planes (reference base.py:858-864)."""
        if os.environ.get("GLIMS_FACTORED", "1") == "0":
            return {}
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
        if self._use_p2_bell():
            t0 = time.perf_counter()
            out.update(bell_factored.build_p2_cache(self._get_p2_plan(), self.p2,
                                                    labels, support=support,
                                                    want_mass=self._p2_stream()))
            self._sync()
            times["factored_p2"] = time.perf_counter() - t0
        return out

    def _augment_bell(self, theta):
        """Theta-only supernode halo-ELL planes (reference base.py:1223-1362,
        bell branch, canonical layout): ``_BellWel`` (nb, s, d, Kh, d),
        ``_BellCuc`` (nb, s, d, Kh), ``_BellWrdC`` and ``_BellMrd`` (nb, s,
        Kh), reduced from the factored channel stacks when theta carries
        them, else through one fused assembly; the constant loads
        ``_Bell_el_load`` and ``_Bell_rd_load`` (the coupling and mass
        planes and the loads only where that block's residual streams), and
        the supernode inverses
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
        th = self._slab_input(theta)
        want_cuc = self._stencil_el_residual_ok()
        want_mrd = self._stencil_rd_residual_ok()
        planes = bell_factored.planes_from_theta(th, self.mesh.dim, want_cuc=want_cuc,
                                                 want_rd=True, want_mrd=want_mrd)
        if planes is None:
            ents = [bell.elasticity_entries(arrays, th["mu"], th["lam"])]
            if want_cuc:
                ents.append(bell.coupling_uc_entries(arrays, th["mu"], th["lam"],
                                                     th["coupling"]))
            ents.append(bell.rd_const_entries(arrays, th["D"], th["rho"], th["dt"], m0))
            if want_mrd:
                ents.append(bell.mass_entries(arrays, m0))
            planes = bell.assemble_fused(bplan, ents)
        planes = list(planes)
        theta["_BellWel"] = planes.pop(0).permute(0, 1, 3, 2, 4).contiguous()
        if want_cuc:
            # the streamed elasticity residual R = A u + C c - load
            theta["_BellCuc"] = planes.pop(0).permute(0, 1, 3, 2).contiguous()
            theta["_Bell_el_load"] = self._body_load(theta)
        Wrd = theta["_BellWrdC"] = planes.pop(0)
        if want_mrd:
            # the streamed rd residual R = W_const c + quad(c) - M c_prev - load
            theta["_BellMrd"] = planes.pop(0)
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
        (without a graph) when the aux did not carry it.  With the
        streamed P2 residual (:meth:`_p2_stream`) also the P2 mass plane
        ``_P2BMrd`` and the constant load ``_P2B_rd_load``.  Under
        ``GLIMS_P2BELL=0`` the elasticity block's alone: the rd block is
        on the jvp lane."""
        bplan = self._get_bell_plan()
        mask_u, mask_c, _, _ = self._bc_masks_and_values()
        th = self._slab_input(theta)
        planes = bell_factored.planes_from_theta(th, self.mesh.dim, want_cuc=False,
                                                 want_rd=False, want_mrd=False)
        if planes is None:
            planes = bell.assemble_fused(bplan, [bell.elasticity_entries(
                self._mesh_arrays(), th["mu"], th["lam"])])
        theta["_BellWel"] = planes[0].permute(0, 1, 3, 2, 4).contiguous()
        if "_BinvSN" not in theta:
            with torch.no_grad():
                theta["_BinvSN"] = bell.supernode_jacobi_inverse(
                    bplan, bell.extract_self_blocks_vector(bplan, theta["_BellWel"]),
                    mask=mask_u)
        if not self._use_p2_bell():
            return theta
        p2plan = self._get_p2_plan()
        # replicated P2 tables (a world that does not divide their blocks)
        # take theta's own coefficients
        th2 = th if self._p2_sharded else theta
        p2_stream = self._p2_stream()
        planes2 = bell_factored.p2_planes_from_theta(th2, want_mass=p2_stream)
        if planes2 is None:
            ents2 = [p2_ell.const_entries(self.p2, th2["D"], th2["rho"], th2["dt"])]
            if p2_stream:
                ents2.append(p2_ell.p2_mass_entries(self.p2))
            planes2 = [bell.assemble_maybe_chunked(p2plan, e) for e in ents2]
        Wrd2 = theta["_P2BWrdC"] = planes2[0]
        if p2_stream:
            # the streamed P2 rd residual R = W_const c + q(c) - M c_prev - load
            theta["_P2BMrd"] = planes2[1]
            zeros = torch.zeros(self.p2.n_dofs, dtype=self.dtype, device=self.device)
            theta["_P2B_rd_load"] = -self.p2.rd_residual(
                zeros, zeros, theta["D"], theta["rho"], theta["dt"],
                source=theta["source"])  # r(0) = -dt s v
        if "_McSNP2" not in theta:
            with torch.no_grad():
                theta["_McSNP2"] = bell.supernode_jacobi_inverse(
                    p2plan, bell.extract_self_blocks_scalar(p2plan, Wrd2), mask=mask_c)
        return theta

    def _rd_builders(self):
        """(rd_jacobian, rd_jacobian_chord, rd_precond) of the pcg branch's
        concentration block: the P1 halo-ELL operators with their
        supernode block-Jacobi and the scalar coarse level, or (a quad
        model) the assembled P2 operators on the P2 plan with supernode
        block-Jacobi alone (reference base.py:617-659, :1671-1680), or
        under ``GLIMS_P2BELL=0`` no operator (the jvp lane) and Jacobi on
        ``rd_diag``."""
        bmv = self._k.bmv
        if self.quad and not self._use_p2_bell():
            return None, None, self._matrix_free_preconds()["rd_precond"]
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
                agg, theta["_TLCfacS"], theta["_TLMtS"], base, theta.get("_TLCfacST"),
                self._coarse_slab())

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
                agg, theta["_TLCfac"], theta["_TLMt"], base, theta.get("_TLCfacT"),
                self._coarse_slab())

        rd_jacobian, rd_jacobian_chord, rd_precond = self._rd_builders()
        return dict(rd_jacobian=rd_jacobian, el_operator=el_operator,
                    rd_precond=rd_precond, el_precond=el_precond,
                    rd_jacobian_chord=rd_jacobian_chord)

    def _augment_ell(self, theta):
        """The node block-ELL lane's theta-only state (``GLIMS_BELL=0``;
        reference base.py:1424-1439): the elasticity values ``_EllWel``
        (n, K, d, d), the P1 rd constant values ``_EllWrd`` (n, K) and the
        per-node block-Jacobi inverses ``_BinvG``, all without a graph
        (they feed the solvers only: the residuals are the gather ones)."""
        plan, arrays = self._get_ell_plan(), self._mesh_arrays()
        theta = self._augment_matrix_free(theta)
        with torch.no_grad():
            theta["_EllWel"] = ell.build_ell_elasticity(plan, arrays, theta["mu"],
                                                        theta["lam"])
            if not self.quad:
                theta["_EllWrd"] = ell.build_ell_rd_const(
                    plan, arrays, theta["D"], theta["rho"], theta["dt"],
                    self.kernels._m0)
        return theta

    def _ell_builders(self):
        """Operator and preconditioner builders of the node block-ELL lane
        (``GLIMS_BELL=0``; reference base.py:665-697, :1573-1712): the
        elasticity operator on ``_EllWel`` with per-node block-Jacobi
        (``_BinvG``) inside the two-level level where it is on, and, on P1
        models, the rd Jacobian ``_EllWrd`` plus the exact logistic
        correction of the iterate, frozen at the step's start by the chord
        method (no lumped chord operator), with Jacobi on ``rd_diag``.  A
        quad model's rd block takes the jvp lane.  Every matvec is
        ``ops/ell.py``'s row gather and multiply-sum."""
        plan, arrays, kern = self._get_ell_plan(), self._mesh_arrays(), self.kernels
        adj = plan.adj_idx
        agg = self._twolevel_aggplan()

        def el_operator(theta):
            B = theta["_EllWel"]
            return lambda u: ell.apply_ell_vector(adj, B, u)

        rd_jacobian = None
        if not self.quad:
            def rd_jacobian(theta, c):
                W = theta["_EllWrd"] + ell.build_ell_rd_wc(
                    plan, arrays, kern.cells_flat, c, theta["rho"], theta["dt"],
                    kern._t0, 1.0)
                return lambda v: ell.apply_ell_scalar(adj, W, v)

        pre = self._matrix_free_preconds()

        def el_precond(theta):
            base = pre["el_precond"](theta)
            if agg is None or "_TLCfac" not in theta:
                return base
            return twolevel.make_twolevel_precond(
                agg, theta["_TLCfac"], theta["_TLMt"], base, theta.get("_TLCfacT"),
                self._coarse_slab())

        return dict(rd_jacobian=rd_jacobian, el_operator=el_operator,
                    rd_precond=pre["rd_precond"], el_precond=el_precond)

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

    # mass actions per subspace (the objective's L2 norms, optimize/);
    # under node sharding of this rank's rows (the halo exchanged here)
    def concentration_mass_action(self, c):
        return self.kernels.mass_residual(self._halo(c)[0])

    def displacement_mass_action(self, u):
        return self.kernels.mass_vector_residual(self._halo(u)[0])

    # -- the gates of the streamed residuals (reference base.py:1547-1569) ------

    def _stencil_rd_residual_ok(self):
        """The streamed rd residual applies when the concentration equation
        has no facet integral and no time-dependent source."""
        if getattr(self, "_source_t", None) is not None:
            return False
        return not any(bc["subspace_id"] == self.SUBSPACE_CONCENTRATION
                       for bc in self.bcs.von_neumann_bcs.values())

    def _p2_stream(self):
        """The streamed P2 rd residual (``GLIMS_P2STREAM=1``, off by
        default; reference base.py:889-897, :1370-1416): a quad model's
        unstructured lane where the streamed rd residual applies."""
        return (self._use_p2_bell() and self._stencil_rd_residual_ok()
                and os.environ.get("GLIMS_P2STREAM", "0") == "1")

    def _stencil_el_residual_ok(self):
        """The streamed elasticity residual applies when nothing
        time-dependent or facet-integral enters the u-equation."""
        if getattr(self, "_body_force_t", None) is not None:
            return False
        return not any(bc["subspace_id"] == self.SUBSPACE_DISPLACEMENT
                       for bc in self.bcs.von_neumann_bcs.values())

    # -- the matrix-free jvp lane ------------------------------------------------

    def _augment_matrix_free(self, theta):
        """The jvp lane's theta-only state (reference base.py:1200-1221):
        ``_BinvG``, the inverses of the per-node (d, d) elasticity blocks,
        with Dirichlet and unreferenced nodes' blocks identity, built
        without a graph (it feeds the preconditioner only), where the
        kernels have ``elasticity_diag_blocks`` (the reference's
        ``hasattr`` gate: ``'cells'``'s kernels have not)."""
        if not hasattr(self.kernels, "elasticity_diag_blocks"):
            return theta
        mask_u, _, _, _ = self._bc_masks_and_values()
        with torch.no_grad():
            B = self.kernels.elasticity_diag_blocks(theta["mu"], theta["lam"])
            theta["_BinvG"] = self.kernels.block_jacobi_inverse_blocks(B, mask=mask_u)
        return theta

    def _matrix_free_preconds(self):
        """The jvp lane's preconditioners (reference base.py:1580-1625 with
        no assembled operator): Jacobi from ``rd_diag`` on the rd block,
        per-node block-Jacobi from ``_BinvG`` on the elasticity block, or
        where theta lacks it point-Jacobi from ``el_diag`` (reference
        solvers/coupled.py:346-350)."""
        kern = self.kernels

        def rd_precond(theta):
            diag = self.rd_diag(theta)
            return lambda r: r / diag

        def el_precond(theta):
            if "_BinvG" not in theta:
                diag = self.el_diag(theta)
                return lambda r: r / diag
            Binv = theta["_BinvG"]
            return lambda r: kern.apply_block_jacobi(Binv, r)

        return dict(rd_precond=rd_precond, el_precond=el_precond)

    # -- step and time loop ----------------------------------------------------

    def _augment_theta_with_operators(self, theta):
        """Theta-only operator planes, built once per simulate and never in
        the time loop."""
        theta = dict(theta)
        if self._node_slab is not None:
            # the replicated coefficients enter the slab work (their
            # cotangent, each rank's part, summed over the ranks once),
            # per-cell ones as the slab's cells
            ids = torch.as_tensor(self._node_slab.cell_ids, device=self.device)
            nc, mesh = self.mesh.n_cells, self.device_mesh
            for k, v in theta.items():
                if torch.is_tensor(v) and not k.startswith("_"):
                    v = shard.enter(mesh, v)
                    theta[k] = v[ids] if v.dim() == 1 and v.shape[0] == nc else v
        if self.matrix_free:
            return self._augment_matrix_free(theta)
        if self.lattice:
            return self._augment_lattice(theta)
        for key in ("_TLCfac", "_TLCfacS"):
            if key in theta and theta[key].dtype == torch.bfloat16:
                # row-major copies of the bf16 factors' transposes, for
                # the coarse term's first product (solvers/twolevel.py)
                theta[key + "T"] = theta[key].T.contiguous()
        if not self._use_bell():
            return self._augment_ell(theta)
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
            reduce=self._reduce(),
            row_start=0 if self._node_rows is None else self._node_rows.start,
        )
        if self.matrix_free:
            builders = self._matrix_free_preconds()
        elif self._lattice_pcg:
            builders = self._node_builders()
        elif self.lattice:
            rd_cg, el_cg = self._stencil_operators()
            builders = dict(rd_cg=rd_cg, el_cg=el_cg)
        elif self._use_bell():
            builders = self._bell_builders()
        else:
            builders = self._ell_builders()
        # extrapolated warm starts where both blocks have an assembled
        # operator and pcg owns the stopping rule (reference base.py:1684-1692)
        self._warm_start_ok = (builders.get("rd_jacobian") is not None
                               and builders.get("el_operator") is not None)
        return make_step(**builders, **common)

    def build_simulate_fn(self, n_steps: int, dt: float):
        """``simulate(theta, u0, c0, aux=None) -> (u_traj, c_traj, ok,
        newton_iters)`` with arrays (n_steps, ...) on the model's device
        (``newton_iters`` on the host).  ``aux`` (default
        :meth:`runtime_aux`) is merged into theta before the operators are
        built; keys it lacks are built per simulate.  Once a step fails to
        converge, the state freezes and every later step is flagged
        (reference base.py:1843-1845).

        Wherever the step takes the pcg branch with assembled operators on
        both blocks (the unstructured lanes, and the lattice under node
        sharding or Chebyshev preconditioning, the reference's
        ``_warm_start_ok``, base.py:1684-1692; not the matrix-free lane nor
        a quad model's jvp rd block) each step starts from the
        linear extrapolation 2 x_k - x_{k-1} of the last two states, or
        with ``GLIMS_WARM_ORDER=3`` the quadratic 3 x_k - 3 x_{k-1} +
        x_{k-2} (a failed step collapses the history to the frozen state,
        so later guesses start at it).  On the unstructured lane, without
        concentration Dirichlet conditions, the Newton anchor
        ||r_c(c_prev)|| is carried algebraically as ||M (c_k - c_{k-1})||
        (reference base.py:1746-1886; the lattice has no assembled mass
        plane for it) unless ``GLIMS_ALG_ANCHOR=0``, which leaves the step
        to evaluate the exact anchor itself.  Both switches are read once,
        here, when the function is built.  The anchor only scales
        tolerances: it is detached (the reference's ``stop_gradient``), so
        a frozen step's zero norm puts no NaN in a gradient.  The
        trajectory is stacked from the steps' outputs and keeps their
        graph.

        Under node sharding ``u0``, ``c0`` and the trajectory hold this
        rank's rows; a gradient through simulate is that of the ranks'
        summed objective, the same on every rank (:meth:`use_sharding`)."""
        step = self._build_step()
        warm = self._warm_start_ok
        # 2 = linear extrapolation, 3 = quadratic (reference base.py:1750-1756)
        quadratic = warm and int(os.environ.get("GLIMS_WARM_ORDER", "2")) >= 3
        alg_anchor = os.environ.get("GLIMS_ALG_ANCHOR", "1") != "0"
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
                       if warm and no_c_dirichlet and alg_anchor else None)
            anchor = None
            if mass_fn is not None:
                c0a = torch.where(mask_c, gc(dt), c0)
                r0a = torch.where(mask_c, 0.0, self.rd_residual(c0a, c0a, theta, dt))
                anchor = torch.linalg.vector_norm(r0a).detach()
            u_traj, c_traj, ok_traj, newton = [], [], [], []
            u_prev, c_prev, u_pp, c_pp, u_ppp, c_ppp = u0, c0, u0, c0, u0, c0
            ok = torch.ones((), dtype=torch.bool, device=c0.device)
            for i in range(n_steps):
                t = (i + 1.0) * dt
                if warm:
                    guess = ((3.0 * u_prev - 3.0 * u_pp + u_ppp,
                              3.0 * c_prev - 3.0 * c_pp + c_ppp) if quadratic
                             else (2.0 * u_prev - u_pp, 2.0 * c_prev - c_pp))
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
                if quadratic:
                    # a failed step collapses the history to the frozen state
                    u_ppp = torch.where(ok, u_pp, u_out)
                    c_ppp = torch.where(ok, c_pp, c_out)
                    u_pp = torch.where(ok, u_prev, u_out)
                    c_pp = torch.where(ok, c_prev, c_out)
                else:
                    u_pp, c_pp = u_prev, c_prev
                u_prev, c_prev = u_out, c_out
                u_traj.append(u_out)
                c_traj.append(c_out)
                ok_traj.append(ok)
                newton.append(n_newton)
            return (torch.stack(u_traj), torch.stack(c_traj), torch.stack(ok_traj),
                    torch.tensor(newton, dtype=torch.int32))

        return simulate

    def initial_state(self):
        """Projected initial values (u0, c0) as tensors, clamped to the
        Dirichlet data at t=0 (this rank's rows under node sharding).  The
        L2 projection runs once for the parameters' expressions."""
        p, cache = self.params, self._iv_cache
        if cache is None or cache[0] is not p or cache[1] is not p._iv_expressions:
            self._iv_cache = cache = (p, p._iv_expressions, p.create_initial_value_function())
        iv = cache[2]
        u0 = self._tensor(self._own(iv[self.SUBSPACE_DISPLACEMENT]))
        c0 = self._tensor(self._own(iv[self.SUBSPACE_CONCENTRATION]))
        mask_u, mask_c, gu, gc = self._bc_masks_and_values()
        return torch.where(mask_u, gu(0.0), u0), torch.where(mask_c, gc(0.0), c0)

    def run(self, keep_nth=1, save_method="xdmf", clear_all=False, plot=False,
            output_dir=None):
        """Run the configured schedule and record it (reference
        simulation_base.py:236-317, glimslib_tpu/models/base.py:1892-1974).

        Records t=0 first, then every ``keep_nth`` step up to the first
        step that did not converge, into ``self.results``
        (:class:`~glimslib_tpu_torch.core.results.Results` in
        ``output_dir``, default ``config.output_dir_simulation_tmp``);
        ``save_method`` None writes no per-step files, ``"vtk"`` a VTU a
        step and a PVD series, ``"xdmf"`` (needs h5py) XDMF + HDF5.  Then
        the series store (``solution_timeseries.npz``) and
        ``self.solution``, the last converged state as numpy arrays, which
        it returns; ``self.solver_info["newton_iters"]`` holds the Newton
        iterations a step beside the CG counts.  ``"xdmf"`` without h5py
        raises before any step runs.  ``plot=True`` on a 2D mesh writes a
        PNG a subspace a recorded step into ``<output_dir>/plots``
        (``<subspace>_<step:04d>.png``, the reference's
        ``Plotting.plot_all``); a 3D run plots nothing, as the reference's;
        without matplotlib it raises ``ImportError`` before any step runs
        or any file is written.  Under sharding every rank runs and
        records, and rank 0 alone writes files and plots.

        Where the parameters are tensors that require grad (the
        ``run_for_adjoint*`` runners given tensors), ``self.solution``
        holds the final (u, c) as tensors with their graph, the whole
        fields gathered differentiably under node sharding: the
        counterpart of the reference's taped solution.

        Differs from the reference: the trajectory comes to the host once,
        after the whole simulate (the trajectory's tensors come from
        :meth:`build_simulate_fn`), and the recorded steps are plotted
        after it."""
        from glimslib_tpu_torch.core.results import Results, _refuse_unwritable

        output_dir = output_dir or config.output_dir_simulation_tmp
        if self.mesh.dim == 3:
            plot = False
        if plot:
            from glimslib_tpu_torch.visualisation.config import require_matplotlib

            require_matplotlib()
        # every rank refuses what rank 0 would, before any collective
        _refuse_unwritable(save_method)
        writer = self.device_mesh is None or self.device_mesh.rank == 0
        if not writer:
            save_method, clear_all, plot = None, False, False
        self.logger.info("-- Computing solutions")
        self.results = Results(self.functionspace, self.subdomains,
                               output_dir=output_dir)
        self.results.save_solution_start(method=save_method, clear_all=clear_all)
        if plot:
            from glimslib_tpu_torch.visualisation.plotting import Plotting

            self.plotting = Plotting(
                self.results, output_dir=os.path.join(output_dir, "plots")
            )
        u0, c0 = self.initial_state()
        theta = self.make_theta(self.params.as_dict())
        dt = float(self.params.sim_time_step)
        n_steps = int(round(float(self.params.sim_time) / dt + 1e-9))
        u_traj, c_traj, ok_traj, newton = self.build_simulate_fn(n_steps, dt)(
            theta, u0, c0
        )
        # parameters that require grad (the run_for_adjoint runners given
        # tensors): the solution keeps its graph
        keep = u_traj.requires_grad or c_traj.requires_grad
        rows = self._node_rows
        if rows is not None:
            # the whole fields on every rank, from each rank's rows
            # (differentiable: a rank's rows of the replicated cotangent)
            whole = lambda x: shard.gather_rows(self.device_mesh, x, rows.start,  # noqa: E731
                                                rows.n_total)
            u_traj = whole(u_traj.movedim(1, 0)).movedim(0, 1)
            c_traj = whole(c_traj.movedim(1, 0)).movedim(0, 1)
            u0, c0 = whole(u0), whole(c0)
        self.solver_info["newton_iters"] = newton.numpy()
        self.logger.info("    - newton iterations per step: %s", newton.tolist())
        u_host = u_traj.detach().cpu().numpy()
        c_host = c_traj.detach().cpu().numpy()
        ok_host = ok_traj.cpu().numpy()
        u0_host = u0.cpu().numpy()
        c0_host = c0.cpu().numpy()

        recording_step = 0
        self.results.add_to_results(0.0, 0, 0, {0: u0_host, 1: c0_host})
        self.results.save_solution(0, 0.0, method=save_method)
        if plot:
            self.plotting.plot_all(0)
        n_ok = int(ok_host.sum())
        if n_ok < n_steps:
            self.logger.warning(
                "Solver did not converge at step %d -- simulation frozen "
                "from there", n_ok + 1,
            )
        for k in range(n_steps):
            time_step = k + 1
            if not ok_host[k]:
                break
            if time_step % keep_nth == 0:
                recording_step += 1
                t = (k + 1) * dt
                self.results.add_to_results(
                    t, time_step, recording_step, {0: u_host[k], 1: c_host[k]}
                )
                self.results.save_solution(recording_step, t, method=save_method)
                if plot:
                    self.plotting.plot_all(recording_step)
        self.results.save_solution_end(method=save_method)
        if writer:
            self.results.save_solution_hdf5()
        if keep:
            self.solution = {0: u_traj[n_ok - 1] if n_ok else u0,
                             1: c_traj[n_ok - 1] if n_ok else c0}
        else:
            self.solution = {0: u_host[n_ok - 1] if n_ok else u0_host,
                             1: c_host[n_ok - 1] if n_ok else c0_host}
        return self.solution

    # -- reload (reference simulation_base.py:319-325) ----------------------

    def reload_from_hdf5(self, path_to_hdf5, output_dir=None):
        """Reload a series store written by :meth:`run` into
        ``self.results`` (the reference's name; the archive is ``.npz``)."""
        from glimslib_tpu_torch.core.results import Results

        output_dir = output_dir or config.output_dir_simulation_tmp
        self.logger.info("-- Reloading from the series store")
        self.results = Results(
            self.functionspace, self.subdomains, output_dir=output_dir
        )
        self.results.data.load_from_hdf5(path_to_hdf5)

    def reload_from_orbax(self, path, output_dir=None):
        """The reference's reload of an Orbax checkpoint: Orbax is a JAX
        library, so this raises (reload the ``.npz`` store with
        :meth:`reload_from_hdf5`)."""
        from glimslib_tpu_torch.core.results import _ORBAX

        raise NotImplementedError(_ORBAX)

    # -- postprocess hook ----------------------------------------------------

    def init_postprocess(self, output_dir=None):
        from glimslib_tpu_torch.postprocess import PostProcessTumorGrowth

        self.postprocess = PostProcessTumorGrowth(
            self.results, self.params, output_dir=output_dir or "."
        )
        return self.postprocess
