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

The model runs the unstructured lane only (``models/base.py``): the
assembled P2 rd Jacobian on the P2 supernode plan.  The reference's
streamed P2 residual (``GLIMS_P2STREAM``, off by default) is not ported.
"""

from __future__ import annotations

import torch

from glimslib_tpu_torch.models.tumor_growth import TumorGrowth as _TumorGrowthP1
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

    def rd_residual(self, c, c_prev, theta, t):
        return self.p2.rd_residual(c, c_prev, theta["D"], theta["rho"], theta["dt"],
                                   source=theta["source"], conc_max=1.0)

    def el_residual(self, u, c, theta, t):
        return self.kernels.elasticity_residual_cint(
            u, self.p2.cell_integral(c), theta["mu"], theta["lam"],
            theta["coupling"], body_force=theta["body_force"])

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
            return p2h.rd_residual(c, c_prev, theta["D"], theta["rho"], theta["dt"],
                                   source=theta["source"], conc_max=1.0)

        def el_hi(u, c, theta, t):
            return k64.elasticity_residual_cint(
                u, p2h.cell_integral(c), theta["mu"], theta["lam"], theta["coupling"],
                body_force=theta["body_force"])

        return rd_hi, el_hi
