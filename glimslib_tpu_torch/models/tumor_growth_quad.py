"""TumorGrowth with quadratic (P2) concentration (counterpart of
``glimslib_tpu/models/tumor_growth_quad.py``).

The same physics as :class:`~glimslib_tpu_torch.models.tumor_growth.TumorGrowth`;
only the concentration element degree changes to 2 (reference
simulation_tumor_growth_quad.py:69).  The residuals are the quadrature
kernels of ``ops/p2.py``; the elasticity block stays P1 and couples to
the concentration through its exact per-cell integral.  Dirichlet
conditions on the concentration constrain the facets' edge-midpoint dofs
too (``core/bcs.py``), and initial values are L2 projections onto the P2
space (``core/functionspace.py``).

Von Neumann fluxes on the concentration integrate over the facets'
trace element (``ops/p2.py P2FacetKernels``), scaled by dt times the
owning cell's D; tractions on the displacement take the P1 facet
kernels.  A callable source or body force is evaluated at the cell
midpoints in each step, as on the P1 model (the JAX package's quad model
leaves it out of its residuals).

On an unstructured mesh the model runs the unstructured lane: the
assembled P2 rd Jacobian on the P2 supernode plan.  On a lattice mesh
it runs the matrix-free jvp lane, as the reference's does (the stencil
operators are P1).  There ``GLIMS_P2STREAM=1`` (off by default) streams
the rd residual: R = W_const c - M c_prev + q(c) - load, two matvecs of
the assembled P2 planes through ``bell_bmv`` (the rd solve's route, the
rank's slab apply under block sharding) and the quadratic term of
``ops/p2_ell.py p2_cubic_residual``, in place of the quadrature gather
and scatter; a von Neumann term or a callable source keeps the
quadrature residual.
"""

from __future__ import annotations

import torch

from glimslib_tpu_torch.models.tumor_growth import TumorGrowth as _TumorGrowthP1
from glimslib_tpu_torch.ops import bell, p2_ell
from glimslib_tpu_torch.ops.p2 import P2Kernels


class TumorGrowth(_TumorGrowthP1):
    CONCENTRATION_DEGREE = 2

    def _setup_functionspace(self):
        # P1 vector x P2 scalar
        self.functionspace.init_function_space(
            [(1, 1), (0, 2)], {0: "displacement", 1: "concentration"}
        )
        self.p2 = P2Kernels(self.mesh, dtype=self.dtype, device=self.device)

    # -- residuals over the P2 concentration space ---------------------------

    def _p2_rd(self, p2k, c, c_prev, theta, t, hi=False):
        r = p2k.rd_residual(c, c_prev, theta["D"], theta["rho"], theta["dt"],
                            source=self._rd_source(theta, t, hi), conc_max=1.0)
        vn = self._vn_rd_term(theta, t, hi)
        return r if vn is None else r - theta["dt"] * vn

    def _p2_el(self, kern, p2k, u, c, theta, t, hi=False):
        r = kern.elasticity_residual_cint(
            u, p2k.cell_integral(c), theta["mu"], theta["lam"], theta["coupling"],
            body_force=self._el_body_force(theta, t, hi))
        vn = self._vn_el_term(t, hi)
        return r if vn is None else r - vn

    def rd_residual(self, c, c_prev, theta, t):
        if "_P2B_rd_load" in theta:
            # streamed (GLIMS_P2STREAM=1): the same degree-6 sums, re-associated
            plan, bmv = self._get_p2_plan(), self._k.bmv
            lin = (bell.apply_bell_scalar(plan, theta["_P2BWrdC"], c, bmv)
                   - bell.apply_bell_scalar(plan, theta["_P2BMrd"], c_prev, bmv))
            quad = p2_ell.p2_cubic_residual(self.p2, c, theta["rho"], theta["dt"], 1.0)
            return lin + quad - theta["_P2B_rd_load"]
        return self._p2_rd(self.p2, c, c_prev, theta, t)

    def el_residual(self, u, c, theta, t):
        return self._p2_el(self.kernels, self.p2, u, c, theta, t)

    def rd_diag(self, theta):
        return self.p2.rd_mass_stiffness_diag(theta["D"], theta["rho"], theta["dt"])

    def concentration_mass_action(self, c):
        return self.p2.mass_residual(c)

    # -- f64 residuals for mixed-precision refinement ------------------------

    def hi_residual_fns(self):
        """(rd_hi, el_hi): the same residuals with f64 kernels (an f64
        :class:`P2Kernels` and the f64 P1 elasticity kernels), the
        defect side of mixed-precision refinement."""
        if getattr(self, "_p2_hi", None) is None:
            self._p2_hi = P2Kernels(self.mesh, dtype=torch.float64, device=self.device)
        p2h = self._p2_hi
        k64 = self._get_kernels_hi()

        def rd_hi(c, c_prev, theta, t):
            return self._p2_rd(p2h, c, c_prev, theta, t, hi=True)

        def el_hi(u, c, theta, t):
            return self._p2_el(k64, p2h, u, c, theta, t, hi=True)

        return rd_hi, el_hi
