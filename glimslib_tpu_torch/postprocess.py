"""Post-processing of recorded solutions: derived mechanical and growth
fields, and the cross-simulation Comparison (counterpart of
``glimslib_tpu/postprocess.py``).

- ``PostProcess`` (reference helper_classes.py:1521-1731): strain, stress,
  pressure, von Mises stress, traction on boundary facets, Jacobians,
  displacement norm, lumped-mass projection of cell fields to nodes, the
  deformed mesh;
- ``PostProcessTumorGrowth`` (l.1734-1940): stress from (E, nu), logistic
  growth, growth-induced strain and Jacobian, concentration in the
  deformed configuration, ``save_all``;
- ``PostProcessTumorGrowthBrain`` (l.1943-1972): per-tissue parameters;
- ``Comparison`` (l.1975-2036): errornorms between two simulations at
  their shared recording steps (a quad model's P2 concentration with the
  P2 mass matrix, as fenics.errornorm takes it; the JAX package applies
  the P1 mass to it and raises).

Every field is computed in torch at float64 on the results' device (the
function space's: the card unless the model was built on the CPU), as
the reference computes at f64, whatever the model's working dtype; each
post-processor builds its own f64 ``P1Kernels``.  Results come back as
numpy arrays.  ``Comparison.compare`` returns a dict of numpy columns
under the reference's column names, not a DataFrame: the port's workflow
path does not import pandas.  ``plot_all`` and ``plot_for_pub`` draw with
``visualisation/`` (matplotlib, imported when they draw).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from glimslib_tpu_torch.core.params import TissueCoefficient
from glimslib_tpu_torch.ops import forms
from glimslib_tpu_torch.ops.assembly import P1Kernels

logger = logging.getLogger(__name__)

F64 = torch.float64


def _np(x):
    return x.detach().cpu().numpy()


class PostProcess:
    """Base postprocessor over a Results instance (reference l.1521-1731)."""

    def __init__(self, results, params=None, output_dir="."):
        self.results = results
        self.params = params
        self.output_dir = output_dir
        self.mesh = results.mesh
        self.dim = self.mesh.dim
        self.device = results._functionspace.device
        self.kernels = P1Kernels(self.mesh, dtype=F64, device=self.device)
        self._lumped = self.kernels.lumped_mass()

    def _t(self, x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=F64,
                               device=self.device)

    # -- helpers -------------------------------------------------------------

    def get_recording_steps(self):
        return self.results.get_recording_steps()

    def _fields(self, recording_step):
        f = self.results.get_result(recording_step)
        if f is None:
            raise KeyError(f"no recording step {recording_step}")
        return f

    def get_displacement(self, recording_step):
        return np.asarray(self._fields(recording_step)[0])

    def get_concentration(self, recording_step):
        c = np.asarray(self._fields(recording_step)[1])
        if c.ndim == 1 and len(c) > self.mesh.n_nodes:
            # P2 field (quad models): the vertex dofs, in mesh-node order
            from glimslib_tpu_torch.ops.p2 import p2_dof_layout

            _, rank, _ = p2_dof_layout(self.mesh)
            return c[rank[: self.mesh.n_nodes]]
        return c

    def cell_to_node(self, cell_vals):
        """Lumped-mass L2 projection of a cellwise-constant field to P1."""
        v = self._t(cell_vals)
        k = self.kernels
        extra = v.shape[1:]
        w = (k.vol / (self.dim + 1)).reshape(-1, *([1] * len(extra))) * v
        acc = torch.zeros((self.mesh.n_nodes,) + tuple(extra), dtype=F64,
                          device=self.device)
        acc.index_add_(0, k.cells_flat, w.repeat(self.dim + 1, *([1] * len(extra))))
        return _np(acc / self._lumped.reshape(-1, *([1] * len(extra))))

    # -- kinematic / stress fields (reference l.1566-1610) -------------------

    def _grad_u(self, recording_step):
        return self.kernels.cell_vector_gradient(
            self._t(self.get_displacement(recording_step)))

    def _stress(self, recording_step, mu_cell, lam_cell):
        eps = forms.compute_strain(self._grad_u(recording_step))
        return forms.compute_stress(eps, self._t(mu_cell), self._t(lam_cell))

    def get_strain_tensor(self, recording_step):
        """Per-cell small-strain tensor (nc, d, d)."""
        return _np(forms.compute_strain(self._grad_u(recording_step)))

    def get_stress_tensor(self, recording_step, mu_cell, lam_cell):
        return _np(self._stress(recording_step, mu_cell, lam_cell))

    def get_pressure(self, recording_step, mu_cell, lam_cell):
        return _np(forms.compute_pressure_from_stress_tensor(
            self._stress(recording_step, mu_cell, lam_cell)))

    def get_van_mises_stress(self, recording_step, mu_cell, lam_cell):
        return _np(forms.compute_van_mises_stress(
            self._stress(recording_step, mu_cell, lam_cell), self.dim))

    def get_displacement_norm(self, recording_step):
        u = self._t(self.get_displacement(recording_step))
        return _np(torch.linalg.vector_norm(u, dim=1))

    def get_total_jacobian(self, recording_step):
        return _np(forms.compute_total_jacobian(self._grad_u(recording_step)))

    def get_traction_force(self, recording_step, mu_cell, lam_cell, facet_idx=None):
        """∫_Γ σ·n ds over boundary facets (reference l.1602-1610): the sum
        of per-facet stress (from the owning cell) times area and normal."""
        m = self.mesh
        if facet_idx is None:
            facet_idx = np.arange(len(m.boundary_facet_area))
        sig = self._stress(recording_step, mu_cell, lam_cell)
        own = torch.as_tensor(m.boundary_facet_cell[facet_idx], dtype=torch.int64,
                              device=self.device)
        n = self._t(m.boundary_facet_normal[facet_idx])
        a = self._t(m.boundary_facet_area[facet_idx])
        tract = torch.einsum("fab,fb->fa", sig[own], n)
        return _np((tract * a[:, None]).sum(dim=0))

    # -- ALE mesh warping (reference l.1712-1730) ---------------------------

    def deformed_mesh(self, recording_step, scale=1.0):
        """A new Mesh moved by the recorded displacement (reverse:
        scale=-1)."""
        return self.mesh.moved(scale * self.get_displacement(recording_step))

    def update_mesh_displacement(self, recording_step, reverse=False):
        """Stateful warp with exact round trip (reference
        update_mesh_displacement, helper_classes.py:1712-1730):
        ``reverse=False`` moves ``self.mesh`` by the recorded displacement,
        ``reverse=True`` restores the coordinates before the warp."""
        if reverse:
            prev = getattr(self, "_mesh_before_warp", None)
            if prev is None:
                logger.warning(
                    "update_mesh_displacement(reverse=True) without a prior "
                    "forward warp -- mesh left unchanged"
                )
                return self.mesh
            self.mesh = prev
            self._mesh_before_warp = None
            return self.mesh
        if getattr(self, "_mesh_before_warp", None) is None:
            self._mesh_before_warp = self.mesh
        self.mesh = self._mesh_before_warp.moved(
            self.get_displacement(recording_step)
        )
        return self.mesh


class PostProcessTumorGrowth(PostProcess):
    """Model-specific fields (reference l.1734-1940)."""

    def _percell(self, v):
        """A parameter as a per-cell array (scalars stay scalar)."""
        subdomains = getattr(self.params, "_subdomains", None)
        if isinstance(v, dict) and subdomains is not None:
            return subdomains.tissue_value_array(v)[subdomains.cell_labels]
        if isinstance(v, TissueCoefficient):
            return np.asarray(v.per_cell())
        return np.asarray(v, dtype=np.float64)

    def _material(self):
        """Per-cell (mu, lam) from params (scalars or per-tissue dicts)."""
        E = self._percell(getattr(self.params, "E", None))
        nu = self._percell(getattr(self.params, "poisson", None))
        return (np.asarray(forms.compute_mu(E, nu)),
                np.asarray(forms.compute_lambda(E, nu)))

    def get_stress(self, recording_step):
        mu, lam = self._material()
        return self.get_stress_tensor(recording_step, mu, lam)

    def get_pressure_field(self, recording_step):
        mu, lam = self._material()
        return self.get_pressure(recording_step, mu, lam)

    def get_van_mises(self, recording_step):
        mu, lam = self._material()
        return self.get_van_mises_stress(recording_step, mu, lam)

    def get_growth_logistic(self, recording_step):
        """rho*c*(1-c) nodal field (reference l.1746-1752)."""
        c = self._t(self.get_concentration(recording_step))
        rho = getattr(self.params, "proliferation",
                      getattr(self.params, "rho_WM", 0.0))
        if isinstance(rho, dict):
            sd = self.params._subdomains
            rho = self.cell_to_node(sd.tissue_value_array(rho)[sd.cell_labels])
        return _np(forms.compute_growth_logistic(c, self._t(rho), 1.0))

    def _coupling_per_cell(self):
        return self._t(self._percell(getattr(self.params, "coupling", 0.0)))

    def _cbar(self, recording_step):
        return self.kernels.cell_average(
            self._t(self.get_concentration(recording_step)))

    def get_growth_induced_strain(self, recording_step):
        return _np(forms.compute_growth_induced_strain(
            self._cbar(recording_step), self._coupling_per_cell(), self.dim))

    def get_growth_induced_jacobian(self, recording_step):
        gs = forms.compute_growth_induced_strain(
            self._cbar(recording_step), self._coupling_per_cell(), self.dim)
        return _np(forms.compute_growth_induced_jacobian(gs, self.dim))

    def get_concentration_deformed(self, recording_step):
        """Concentration mapped to the deformed configuration
        (reference l.1779-1786)."""
        return _np(forms.compute_concentration_deformed(
            self._cbar(recording_step), self._grad_u(recording_step),
            self._coupling_per_cell(), self.dim))

    # -- output (reference l.1827-1940) --------------------------------------

    def plot_all(self, deformed=False, selection=None, output_dir=None):
        from glimslib_tpu_torch.visualisation import plotting as plott

        outdir = output_dir or self.output_dir
        os.makedirs(outdir, exist_ok=True)
        steps = selection or self.get_recording_steps()
        for rs in steps:
            mesh = self.deformed_mesh(rs) if deformed else self.mesh
            tag = "deformed" if deformed else "reference"
            c = self.get_concentration(rs)
            u = self.get_displacement(rs)
            plott.plot_scalar_field(
                mesh, c, path=os.path.join(outdir, f"conc_{tag}_{rs:04d}.png"),
                title=f"concentration step {rs}",
            )
            plott.plot_vector_field(
                mesh, u, path=os.path.join(outdir, f"disp_{tag}_{rs:04d}.png"),
                title=f"displacement step {rs}",
            )
        return outdir

    def plot_for_pub(self, deformed=True, selection=None, output_dir=None):
        """Publication-style overlay figures: concentration contours on the
        (optionally deformed) domain with displacement quivers
        (reference plot_for_pub, helper_classes.py:1857-1920)."""
        import matplotlib.pyplot as plt

        from glimslib_tpu_torch.visualisation import helpers, plotting as plott

        outdir = output_dir or os.path.join(self.output_dir, "pub")
        os.makedirs(outdir, exist_ok=True)
        steps = selection or self.get_recording_steps()
        for rs in steps:
            mesh = self.deformed_mesh(rs) if deformed else self.mesh
            if mesh.dim != 2:
                continue
            fig, ax = plt.subplots(figsize=(6, 6))
            plott.plot_scalar_field(
                mesh, self.get_concentration(rs), ax=ax, cmap="inferno",
                colorbar=True, alpha=0.9,
            )
            plott.plot_vector_field(
                mesh, self.get_displacement(rs), ax=ax, color="w", alpha=0.6,
            )
            ax.set_axis_off()
            helpers.show_plot(
                os.path.join(outdir, f"pub_{rs:04d}.png"), fig
            )
        return outdir

    def save_all(self, save_method="vtk", output_dir=None, selection=None):
        """Re-export all recorded steps with derived fields as a VTU a step
        and a PVD series (reference l.1922-1940)."""
        from glimslib_tpu_torch.utils import vtk_utils

        outdir = output_dir or self.output_dir
        os.makedirs(outdir, exist_ok=True)
        series = []
        steps = selection or self.get_recording_steps()
        for rs in steps:
            fname = os.path.join(outdir, f"postprocess_{rs:06d}.vtu")
            vtk_utils.write_vtu(
                fname,
                self.mesh.points,
                self.mesh.cells,
                point_data={
                    "concentration": self.get_concentration(rs),
                    "displacement": self.get_displacement(rs),
                    "displacement_norm": self.get_displacement_norm(rs),
                    "van_mises": self.cell_to_node(self.get_van_mises(rs)),
                    "pressure": self.cell_to_node(self.get_pressure_field(rs)),
                    "jacobian": self.cell_to_node(self.get_total_jacobian(rs)),
                },
            )
            t = self.results.data.get_time_series("solution").get_time(rs)
            series.append((rs, t, os.path.basename(fname)))
        vtk_utils.write_pvd(os.path.join(outdir, "postprocess.pvd"), series)
        return outdir


class PostProcessTumorGrowthBrain(PostProcessTumorGrowth):
    """Per-tissue parameter mapping (reference l.1943-1972)."""

    TISSUE_KEYS = {"E": "E_%s", "poisson": "nu_%s"}

    def map_params(self):
        """Map E_*/nu_* scalars into per-tissue dicts for the generic
        postprocessor (reference map_params, l.1952-1972)."""
        p = self.params
        tissues = {"GM": "GM", "WM": "WM", "CSF": "CSF", "Ventricles": "VENT"}
        E = {name: getattr(p, f"E_{suffix}") for name, suffix in tissues.items()}
        nu = {name: getattr(p, f"nu_{suffix}") for name, suffix in tissues.items()}
        p.set_parameter("E", E)
        p.set_parameter("poisson", nu)

    def _material(self):
        if not hasattr(self.params, "E"):
            self.map_params()
        return super()._material()


class Comparison:
    """Field-level diff of two simulations at shared recording steps
    (reference helper_classes.py:1975-2036)."""

    def __init__(self, sim_a, sim_b=None, results_b=None):
        self.a = sim_a.results if hasattr(sim_a, "results") else sim_a
        self.b = (
            sim_b.results if (sim_b is not None and hasattr(sim_b, "results"))
            else (sim_b or results_b)
        )
        self.mesh = self.a.mesh
        self.device = self.a._functionspace.device
        self.kernels = P1Kernels(self.mesh, dtype=F64, device=self.device)
        self._p2 = None

    def _shared_steps(self):
        sa = set(self.a.get_recording_steps())
        sb = set(self.b.get_recording_steps())
        return sorted(sa & sb)

    def errornorm(self, fa, fb):
        """L2 norm of the difference, sqrt((a-b)^T M (a-b)), as
        fenics.errornorm for fields of one space (P1, or a scalar field
        longer than the nodes: P2)."""
        d = torch.as_tensor(np.asarray(fa, np.float64) - np.asarray(fb, np.float64),
                            device=self.device)
        if d.dim() == 1 and d.shape[0] > self.mesh.n_nodes:
            if self._p2 is None:
                from glimslib_tpu_torch.ops.p2 import P2Kernels

                self._p2 = P2Kernels(self.mesh, dtype=F64, device=self.device)
            md = self._p2.mass_residual(d)
        elif d.dim() == 1:
            md = self.kernels.mass_residual(d)
        else:
            md = self.kernels.mass_vector_residual(d)
        return float(torch.sqrt(torch.sum(d * md)))

    def max_difference(self, fa, fb):
        return float(np.abs(np.asarray(fa) - np.asarray(fb)).max())

    def compare(self, subspace_names=None):
        """Per-step, per-subspace errornorm and max difference: a dict of
        numpy columns ``recording_step``, ``errornorm_<name>``,
        ``maxdiff_<name>`` (reference compare(), l.2027-2035)."""
        names = subspace_names or {0: "displacement", 1: "concentration"}
        steps = self._shared_steps()
        cols = {"recording_step": np.asarray(steps, dtype=np.int64)}
        for sid, nm in names.items():
            cols[f"errornorm_{nm}"] = np.asarray([
                self.errornorm(self.a.get_result(rs)[sid], self.b.get_result(rs)[sid])
                for rs in steps], dtype=np.float64)
            cols[f"maxdiff_{nm}"] = np.asarray([
                self.max_difference(self.a.get_result(rs)[sid],
                                    self.b.get_result(rs)[sid])
                for rs in steps], dtype=np.float64)
        return cols
