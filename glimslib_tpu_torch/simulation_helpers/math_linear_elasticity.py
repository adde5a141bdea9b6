"""Reference-compatible alias for ``glimslib/simulation_helpers/
math_linear_elasticity.py`` — the implementations live in
:mod:`glimslib_tpu_torch.ops.forms` (torch)."""

from glimslib_tpu_torch.ops.forms import (  # noqa: F401
    compute_concentration_deformed,
    compute_deviatoric_stress_tensor,
    compute_growth_induced_jacobian,
    compute_growth_induced_strain,
    compute_lambda,
    compute_mu,
    compute_pressure_from_stress_tensor,
    compute_strain,
    compute_stress,
    compute_total_jacobian,
    compute_van_mises_stress,
    u_norm,
)
