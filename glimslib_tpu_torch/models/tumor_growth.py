"""Mechanically-coupled reaction-diffusion tumor-growth model (counterpart
of ``glimslib_tpu/models/tumor_growth.py``).

Weak forms (reference simulation_tumor_growth.py:110-122):

  F_m  = inner(sigma(u), eps(v)) dx - inner(sigma(v), c*k*I) dx
         - inner(body_force, v) dx
  F_rd = c v dx + dt D grad(c).grad(v) dx - c_prev v dx
         - dt rho c (1-c) v dx - dt source v dx

Both residuals are evaluated in their fully-streaming form: stencil
planes through the CUDA stencil kernel on a lattice, assembled halo-ELL
planes through the CUDA batched-matvec kernel on an unstructured mesh.
Mixed-precision refinement takes its f64 residuals from the per-cell
gather path of ``ops/assembly.py P1Kernels`` (:meth:`hi_residual_fns`).
Under node sharding each residual takes this rank's rows, exchanges the
halo of the fields it reads in one exchange, and returns the owned rows
(the halo form of the stencil kernel; the gather path on the slab's
cells).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from glimslib_tpu_torch import config
from glimslib_tpu_torch.core.params import TissueCoefficient
from glimslib_tpu_torch.models.base import Simulation
from glimslib_tpu_torch.ops import bell, forms
from glimslib_tpu_torch.ops.assembly import P1Kernels


class TumorGrowth(Simulation):
    def _define_model_params(self):
        self.required_params = ["diffusion", "coupling", "proliferation", "E", "poisson"]
        self.optional_params = ["body_force", "source_term"]

    def _setup_functionspace(self):
        # P1 vector x P1 scalar
        self.functionspace.init_function_space(
            [(1, 1), (0, 1)], {0: "displacement", 1: "concentration"}
        )

    def _per_cell(self, value):
        """Scalar stays scalar; TissueCoefficient/dict becomes per-cell; a
        tensor passes through with its graph."""
        if torch.is_tensor(value):
            return value.to(dtype=self.dtype, device=self.device)
        if isinstance(value, TissueCoefficient):
            return self._tensor(value.per_cell())
        if isinstance(value, dict):
            lookup = self.subdomains.tissue_value_array(value)
            return self._tensor(lookup[self.subdomains.cell_labels])
        return self._tensor(value)

    @staticmethod
    def _check_static(source, body_force):
        if callable(source) or callable(body_force):
            raise NotImplementedError(
                "time-dependent source terms and body forces are not ported yet"
            )

    def _body_force(self, bf):
        return self._tensor(np.zeros(self.mesh.dim) if bf is None else bf)

    def theta_class_labels(self):
        """The subdomain cell labels when every plane coefficient is a
        scalar or per-tissue (a dict, or a TissueCoefficient over the same
        labels): the factored assembly's contract
        (``ops/bell_factored.py``).  A raw per-cell array, a tensor or a
        callable returns None (dense assembly)."""
        import numbers

        sub_labels = np.asarray(self.subdomains.cell_labels)
        p = self.params.as_dict()
        for key in ("diffusion", "proliferation", "coupling", "E", "poisson"):
            v = p.get(key)
            if isinstance(v, (numbers.Number, dict)):
                continue
            if isinstance(v, TissueCoefficient) and np.array_equal(
                    np.asarray(v.cell_labels), sub_labels):
                continue
            return None
        return sub_labels

    def make_theta(self, params: Dict):
        src = params.get("source_term", 0.0)
        bf = params.get("body_force")
        self._check_static(src, bf)
        E = self._per_cell(params["E"])
        nu = self._per_cell(params["poisson"])
        return {
            "D": self._per_cell(params["diffusion"]),
            "rho": self._per_cell(params["proliferation"]),
            "coupling": self._per_cell(params["coupling"]),
            "mu": forms.compute_mu(E, nu),
            "lam": forms.compute_lambda(E, nu),
            "dt": self._tensor(float(params["sim_time_step"])),
            "body_force": self._body_force(bf),
            "source": self._per_cell(src),
        }

    # -- residuals (streaming stencil form) ----------------------------------

    def rd_residual(self, c, c_prev, theta, t):
        """Lattice: R = W_const c + wc(c) c / 2 - M c_prev - load.
        Unstructured: R = W_const c + dt rho / c_max ∫c²φ - M c_prev - load,
        two halo-ELL matvecs and the per-cell quadratic pull."""
        k = self._k
        if not self.lattice:
            bplan = self._get_bell_plan()
            lin = (bell.apply_bell_scalar(bplan, theta["_BellWrdC"], c, k.bmv)
                   - bell.apply_bell_scalar(bplan, theta["_BellMrd"], c_prev, k.bmv))
            quad = self.kernels.rd_quad_residual(c, theta["rho"], theta["dt"],
                                                 conc_max=1.0)
            return lin + quad - theta["_Bell_rd_load"]
        ops = self._stencil_ops
        c_h, cp_h = self._halo(c, c_prev)
        wc = ops.build_rd_wc(c_h, theta["rho"], theta["dt"], conc_max=1.0)
        # one launch of stencil_apply on the card
        return k.apply_scalar_sum(
            ops.offsets,
            ((theta["_Wrd_const"], c_h, 1.0), (wc, c_h, 0.5),
             (theta["_Mst"], cp_h, -1.0)),
            theta["_rd_load"], cache=theta.get("_mirrors"), halo=self._halo_rows,
        )

    def el_residual(self, u, c, theta, t):
        """R = W_el u + C_uc c - load (stencil planes on a lattice,
        halo-ELL matvecs on an unstructured mesh)."""
        k = self._k
        if not self.lattice:
            bplan = self._get_bell_plan()
            return (
                bell.apply_bell_vector(bplan, theta["_BellWel"], u, k.bmv)
                + bell.apply_bell_coupling(bplan, theta["_BellCuc"], c, k.bmv)
                - theta["_Bell_el_load"]
            )
        ops = self._stencil_ops
        mir, h = theta.get("_mirrors"), self._halo_rows
        u_h, c_h = self._halo(u, c)
        return (
            k.apply_vector(ops.offsets, theta["_Wel"], u_h, cache=mir, halo=h)
            + k.apply_coupling(ops.offsets, theta["_Cuc"], c_h, cache=mir, halo=h)
            - theta["_el_load"]
        )

    def rd_diag(self, theta):
        return self.kernels.rd_mass_stiffness_diag(theta["D"], theta["rho"], theta["dt"])

    def el_diag(self, theta):
        return self.kernels.elasticity_diag(theta["mu"], theta["lam"])

    # -- f64 residuals for mixed-precision refinement ------------------------

    def _get_kernels_hi(self):
        """An f64 :class:`P1Kernels` of the mesh (of this rank's node slab
        under node sharding) on the model's device, built once."""
        if getattr(self, "_kernels_hi", None) is None:
            slab = self._node_slab
            self._kernels_hi = P1Kernels(
                self.mesh if slab is None else slab.local_mesh, dtype=torch.float64,
                device=self.device, rows=None if slab is None else slab.own_rows)
        return self._kernels_hi

    def hi_residual_fns(self):
        """(rd_hi, el_hi): the same physics on the per-cell gather path
        with f64 geometry, the defect side of mixed-precision refinement
        (``StepConfig.refine_f64``).  The working-dtype path steers the
        solves; these define what converged means."""
        k64 = self._get_kernels_hi()

        def rd_hi(c, c_prev, theta, t):
            c, c_prev = self._halo(c, c_prev)
            return k64.rd_residual(c, c_prev, theta["D"], theta["rho"], theta["dt"],
                                   source=theta["source"], conc_max=1.0)

        def el_hi(u, c, theta, t):
            u, c = self._halo(u, c)
            return k64.elasticity_residual(u, c, theta["mu"], theta["lam"],
                                           theta["coupling"],
                                           body_force=theta["body_force"])

        return rd_hi, el_hi

    # -- adjoint runners (reference simulation_tumor_growth.py:142-170) ------
    # Given tensors that require grad, the returned solution keeps its
    # graph (Simulation.run), gathered differentiably under node sharding.

    def run_for_adjoint(self, parameters, output_dir=None):
        """Update (diffusion, proliferation, coupling) then run."""
        self.params.diffusion, self.params.proliferation, self.params.coupling = (
            parameters
        )
        self.run(keep_nth=1, save_method=None, clear_all=False, plot=False,
                 output_dir=output_dir or config.output_dir_simulation_tmp)
        return self.solution

    def run_for_adjoint2(self, parameters, output_dir=None):
        """2-parameter variant (diffusion, proliferation)."""
        self.params.diffusion, self.params.proliferation = parameters
        self.run(keep_nth=1, save_method=None, clear_all=False, plot=False,
                 output_dir=output_dir or config.output_dir_simulation_tmp)
        return self.solution
