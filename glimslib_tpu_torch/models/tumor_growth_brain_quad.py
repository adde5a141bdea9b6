"""TumorGrowthBrain with quadratic (P2) concentration (counterpart of
``glimslib_tpu/models/tumor_growth_brain_quad.py``): the per-tissue brain
model over a P1-vector x P2-scalar space, the model the reference's
optimization workflow drives (image_based_optimization.py:26).  The
per-tissue coefficients of
:class:`~glimslib_tpu_torch.models.tumor_growth_brain.TumorGrowthBrain`
with the P2 residuals of the quad model.

The reference's tied-parameter runners ``run_for_adjoint_{2,3,4,5}params``
drive its file output and are not ported.
"""

from __future__ import annotations

from glimslib_tpu_torch.models.tumor_growth_brain import TumorGrowthBrain as _BrainP1
from glimslib_tpu_torch.models.tumor_growth_quad import TumorGrowth as _Quad


class TumorGrowthBrain(_BrainP1):
    CONCENTRATION_DEGREE = 2

    # function space and residuals from the quad model
    _setup_functionspace = _Quad._setup_functionspace
    _p2_rd = _Quad._p2_rd
    _p2_el = _Quad._p2_el
    rd_residual = _Quad.rd_residual
    el_residual = _Quad.el_residual
    rd_diag = _Quad.rd_diag
    concentration_mass_action = _Quad.concentration_mass_action
    hi_residual_fns = _Quad.hi_residual_fns
