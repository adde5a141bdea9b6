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
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from glimslib_tpu_torch.core.params import TissueCoefficient
from glimslib_tpu_torch.models.base import Simulation
from glimslib_tpu_torch.ops import bell, forms


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
        """Scalar stays scalar; TissueCoefficient/dict becomes per-cell."""
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
        if "_Bell_rd_load" in theta:
            bplan = self._get_bell_plan()
            lin = (bell.apply_bell_scalar(bplan, theta["_BellWrdC"], c, k.bmv)
                   - bell.apply_bell_scalar(bplan, theta["_BellMrd"], c_prev, k.bmv))
            quad = self.kernels.rd_quad_residual(c, theta["rho"], theta["dt"],
                                                 conc_max=1.0)
            return lin + quad - theta["_Bell_rd_load"]
        ops = self._stencil_ops
        wc = ops.build_rd_wc(c, theta["rho"], theta["dt"], conc_max=1.0)
        return (
            k.apply_scalar(ops.offsets, theta["_Wrd_const"], c)
            + 0.5 * k.apply_scalar(ops.offsets, wc, c)
            - k.apply_scalar(ops.offsets, theta["_Mst"], c_prev)
            - theta["_rd_load"]
        )

    def el_residual(self, u, c, theta, t):
        """R = W_el u + C_uc c - load (stencil planes on a lattice,
        halo-ELL matvecs on an unstructured mesh)."""
        k = self._k
        if "_Bell_el_load" in theta:
            bplan = self._get_bell_plan()
            return (
                bell.apply_bell_vector(bplan, theta["_BellWel"], u, k.bmv)
                + bell.apply_bell_coupling(bplan, theta["_BellCuc"], c, k.bmv)
                - theta["_Bell_el_load"]
            )
        ops = self._stencil_ops
        return (
            k.apply_vector(ops.offsets, theta["_Wel"], u)
            + k.apply_coupling(ops.offsets, theta["_Cuc"], c)
            - theta["_el_load"]
        )

    def rd_diag(self, theta):
        return self.kernels.rd_mass_stiffness_diag(theta["D"], theta["rho"], theta["dt"])

    def el_diag(self, theta):
        return self.kernels.elasticity_diag(theta["mu"], theta["lam"])
