"""Mechanically-coupled reaction-diffusion tumor-growth model (counterpart
of ``glimslib_tpu/models/tumor_growth.py``).

Weak forms (reference simulation_tumor_growth.py:110-122):

  F_m  = inner(sigma(u), eps(v)) dx - inner(sigma(v), c*k*I) dx
         - inner(body_force, v) dx - vonNeumann(v)
  F_rd = c v dx + dt D grad(c).grad(v) dx - c_prev v dx
         - dt rho c (1-c) v dx - dt source v dx - dt vonNeumann(D v)

Each residual takes the form the theta keys of the lane select, as the
reference's do: the fully-streaming form where theta carries its planes
(``_Mst`` / ``_Cuc`` on a lattice: stencil planes through the CUDA
stencil kernel; ``_Bell_rd_load`` / ``_Bell_el_load`` on an
unstructured mesh: halo-ELL planes through the CUDA batched-matvec
kernel), else the per-cell gather form of ``ops/assembly.py P1Kernels``
with the source, the body force and the von Neumann facet terms.  The
model leaves the streamed form of a block out of theta when that block
has a facet term or a time-dependent source or body force
(``models/base.py``), and the matrix-free lane never builds it.

A ``source_term`` or ``body_force`` may be a callable ``f(x, t)``: ``x``
the cell midpoints as a torch tensor (nc, dim) on the model's device
(f64 for refinement's defect residuals, else the model's dtype), ``t``
the step time (a float); it returns the per-cell values, (nc,) or (nc,
dim), and is evaluated inside each step.

Mixed-precision refinement takes its f64 residuals from the same gather
path with f64 tables (:meth:`hi_residual_fns`; the sharded kernels at
f64 under ``'cells'`` and the unstructured ``'nodes'``).  Under the
lattice's node sharding each residual takes this rank's rows, exchanges
the halo of the fields it reads in one exchange, and returns the owned
rows (the halo form of the stencil kernel; the gather path on the slab's
cells); under the unstructured one the sharded kernels exchange their
ghost rows themselves.
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

    def _body_force(self, bf):
        return self._tensor(np.zeros(self.mesh.dim) if bf is None else bf)

    # time-dependent source / body force: callables f(x_cell_midpoints, t)
    # evaluated inside the step (set by make_theta)
    _source_t = None
    _body_force_t = None

    def _midpoints(self, hi=False):
        """The cell midpoints (this rank's slab cells under node sharding)
        as a tensor on the model's device, f64 with ``hi``."""
        attr = "_cell_mid_hi" if hi else "_cell_mid"
        if getattr(self, attr, None) is None:
            mid = self.mesh.cell_midpoints
            if self._node_slab is not None:
                mid = mid[self._node_slab.cell_ids]
            setattr(self, attr, self._tensor(mid, torch.float64 if hi else None))
        return getattr(self, attr)

    def _at_midpoints(self, fn, t, hi):
        x = self._midpoints(hi)
        return torch.as_tensor(fn(x, t), dtype=x.dtype, device=x.device)

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
        # a callable source or body force is evaluated in each step at the
        # cell midpoints (the reference's Expression.t update)
        self._source_t = src if callable(src) else None
        self._body_force_t = bf if callable(bf) else None
        E = self._per_cell(params["E"])
        nu = self._per_cell(params["poisson"])
        return {
            "D": self._per_cell(params["diffusion"]),
            "rho": self._per_cell(params["proliferation"]),
            "coupling": self._per_cell(params["coupling"]),
            "mu": forms.compute_mu(E, nu),
            "lam": forms.compute_lambda(E, nu),
            "dt": self._tensor(float(params["sim_time_step"])),
            "body_force": self._body_force(None if callable(bf) else bf),
            "source": self._per_cell(0.0 if callable(src) else src),
        }

    # -- residuals -------------------------------------------------------------

    def _vn_rd_term(self, theta, t, hi=False):
        """sum over the concentration's von Neumann conditions of ∫ D q φ
        ds (the flux scaled by the owning cell's D, reference
        simulation_tumor_growth.py:120), or None; ``hi``: with the f64
        facet kernels.  Under ``'cells'`` and ``'nodes'`` this rank's share
        (:meth:`~glimslib_tpu_torch.models.base.Simulation._von_neumann_kernels`),
        D entering it as the kernels' coefficients do."""
        out = None
        for name, bc in self.bcs.von_neumann_bcs.items():
            if bc["subspace_id"] != self.SUBSPACE_CONCENTRATION:
                continue
            kern, cells = self._von_neumann_kernels(name, bc, hi=hi)
            shape = kern.value_coords.shape[:2]
            qv = torch.as_tensor(self.bcs.von_neumann_values(kern, bc["bc_value"], 1, t),
                                 dtype=kern.dtype, device=kern.device).expand(shape)
            D = self._replicated_input(theta["D"])
            qv = qv * D if D.dim() == 0 else qv * D[cells][:, None]
            term = kern.scalar_flux_residual(qv)
            out = term if out is None else out + term
        return out

    def _vn_el_term(self, t, hi=False):
        """sum over the displacement's von Neumann conditions of ∫ t·v ds
        (the tractions), or None; this rank's share as :meth:`_vn_rd_term`."""
        out = None
        for name, bc in self.bcs.von_neumann_bcs.items():
            if bc["subspace_id"] != self.SUBSPACE_DISPLACEMENT:
                continue
            kern, _ = self._von_neumann_kernels(name, bc, hi=hi)
            term = kern.traction_residual(
                self.bcs.von_neumann_values(kern, bc["bc_value"], self.mesh.dim, t))
            out = term if out is None else out + term
        return out

    def _rd_source(self, theta, t, hi):
        source = theta["source"]
        if self._source_t is not None:
            source = source + self._at_midpoints(self._source_t, t, hi)
        return source

    def _el_body_force(self, theta, t, hi):
        bf = theta["body_force"]
        if self._body_force_t is not None:
            bf = bf + self._at_midpoints(self._body_force_t, t, hi)
        return bf

    def _rd_gather(self, kern, c, c_prev, theta, t, hi=False):
        """The gather form: ``kern.rd_residual`` with the source at t,
        minus dt times the von Neumann term (under ``'cells'`` the rank's
        partial of it, added before the kernels' one sum over the ranks)."""
        c, c_prev = self._halo(c, c_prev)
        vn = self._vn_rd_term(theta, t, hi)
        facet = {}
        if vn is not None:
            vn = self._replicated_input(theta["dt"]) * vn
            if self.sharding_mode == "cells":
                facet, vn = {"facet": -vn}, None
        r = kern.rd_residual(c, c_prev, theta["D"], theta["rho"], theta["dt"],
                             source=self._rd_source(theta, t, hi), conc_max=1.0, **facet)
        return r if vn is None else r - vn

    def _el_gather(self, kern, u, c, theta, t, hi=False):
        """The gather form: ``kern.elasticity_residual`` with the body
        force at t, minus the tractions (under ``'cells'`` as
        :meth:`_rd_gather`)."""
        u, c = self._halo(u, c)
        vn = self._vn_el_term(t, hi)
        facet = {}
        if vn is not None and self.sharding_mode == "cells":
            facet, vn = {"facet": -vn}, None
        r = kern.elasticity_residual(u, c, theta["mu"], theta["lam"], theta["coupling"],
                                     body_force=self._el_body_force(theta, t, hi), **facet)
        return r if vn is None else r - vn

    def rd_residual(self, c, c_prev, theta, t):
        """Lattice streamed (``_Mst``): R = W_const c + wc(c) c / 2 - M
        c_prev - load.  Unstructured streamed (``_Bell_rd_load``): R =
        W_const c + dt rho / c_max ∫c²φ - M c_prev - load, two halo-ELL
        matvecs and the per-cell quadratic pull.  Else the gather form."""
        k = self._k
        if "_Bell_rd_load" in theta:
            bplan = self._get_bell_plan()
            lin = (bell.apply_bell_scalar(bplan, theta["_BellWrdC"], c, k.bmv)
                   - bell.apply_bell_scalar(bplan, theta["_BellMrd"], c_prev, k.bmv))
            quad = self.kernels.rd_quad_residual(c, theta["rho"], theta["dt"],
                                                 conc_max=1.0)
            return lin + quad - theta["_Bell_rd_load"]
        if "_Mst" not in theta:
            return self._rd_gather(self.kernels, c, c_prev, theta, t)
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
        """R = W_el u + C_uc c - load (stencil planes ``_Cuc`` on a
        lattice, halo-ELL matvecs ``_Bell_el_load`` on an unstructured
        mesh), else the gather form."""
        k = self._k
        if "_Bell_el_load" in theta:
            bplan = self._get_bell_plan()
            return (
                bell.apply_bell_vector(bplan, theta["_BellWel"], u, k.bmv)
                + bell.apply_bell_coupling(bplan, theta["_BellCuc"], c, k.bmv)
                - theta["_Bell_el_load"]
            )
        if "_Cuc" not in theta:
            return self._el_gather(self.kernels, u, c, theta, t)
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
        under the lattice's node sharding) on the model's device, built
        once; under ``'cells'`` and the unstructured ``'nodes'`` the
        sharded kernels at f64 over the same partition."""
        if getattr(self, "_kernels_hi", None) is None and self._sharded_kernels:
            self._kernels_hi = self.kernels.like(torch.float64)
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
            return self._rd_gather(k64, c, c_prev, theta, t, hi=True)

        def el_hi(u, c, theta, t):
            return self._el_gather(k64, u, c, theta, t, hi=True)

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
