"""The reference-name modules of the port (``simulation/``,
``simulation_helpers/``) against the JAX package's: the same public names,
each resolving to the port's own object (never the JAX package's), and
the values of tests/test_unit_helpers.py:208-226."""

import importlib
import inspect

import numpy as np
import pytest

import glimslib_tpu_torch
from glimslib_tpu_torch.core.params import TissueCoefficient

MODULES = [
    "simulation", "simulation.config", "simulation.simulation_base",
    "simulation.simulation_tumor_growth", "simulation.simulation_tumor_growth_brain",
    "simulation.simulation_tumor_growth_brain_quad",
    "simulation.simulation_tumor_growth_quad", "simulation_helpers",
    "simulation_helpers.math_linear_elasticity",
    "simulation_helpers.math_reaction_diffusion",
]


def _public(module):
    names = getattr(module, "__all__", None)
    if names is None:
        names = [n for n, v in vars(module).items()
                 if not n.startswith("_") and not inspect.ismodule(v)]
    return sorted(names)


@pytest.mark.parametrize("name", MODULES)
def test_module_has_the_jax_packages_names_as_port_objects(name):
    port = importlib.import_module(f"glimslib_tpu_torch.{name}")
    ref = importlib.import_module(f"glimslib_tpu.{name}")
    if name == "simulation.config":
        # the root config re-exported, with the names the reference's
        # imports by name (the port's device and dtype settings differ)
        cfg = glimslib_tpu_torch.config
        assert port.USE_ADJOINT is ref.USE_ADJOINT is False
        assert (port.output_dir, port.output_dir_simulation_tmp) == (
            cfg.output_dir, cfg.output_dir_simulation_tmp)
        assert port.resolve_device is cfg.resolve_device
        return
    names = _public(ref)
    if hasattr(ref, "__all__"):
        assert port.__all__ == ref.__all__
    else:
        assert set(names) <= set(_public(port))
    for n in names:
        got = getattr(port, n)
        origin = getattr(got, "__module__", None) or getattr(got, "__name__", "")
        assert origin.startswith("glimslib_tpu_torch"), (n, origin)
        assert type(got) is type(getattr(ref, n)) or inspect.ismodule(got), n


def test_reference_compat_module_paths():
    """The port's counterpart of tests/test_unit_helpers.py:208-226."""
    from glimslib_tpu_torch.simulation_helpers import (
        DiscontinuousScalar,
        math_linear_elasticity as mle,
        math_reaction_diffusion as mrd,
    )
    from glimslib_tpu_torch.simulation.simulation_tumor_growth import TumorGrowth
    from glimslib_tpu_torch.simulation.simulation_tumor_growth_brain_quad import (
        TumorGrowthBrain,
    )

    assert DiscontinuousScalar is TissueCoefficient
    assert float(mle.compute_mu(1.0, 0.25)) == pytest.approx(0.4)
    assert float(mrd.compute_growth_logistic(0.5, 2.0, 1.0)) == pytest.approx(0.5)
    assert TumorGrowth.__name__ == "TumorGrowth"
    assert TumorGrowthBrain.CONCENTRATION_DEGREE == 2


def test_re_exports_are_the_port_models_and_helpers():
    from glimslib_tpu_torch import simulation, simulation_helpers as sh
    from glimslib_tpu_torch.models.base import Simulation
    from glimslib_tpu_torch.models.tumor_growth_brain import TumorGrowthBrain
    from glimslib_tpu_torch.postprocess import Comparison
    from glimslib_tpu_torch.visualisation.plotting import Plotting
    from glimslib_tpu.simulation_helpers import AnyDimPoint as jax_any_dim_point

    assert simulation.FenicsSimulation is Simulation
    assert simulation.TumorGrowthBrain is TumorGrowthBrain
    assert sh.Comparison is Comparison and sh.Plotting is Plotting
    for coords in ([1, 2], (0.5, 1.5, -2.0)):
        got, want = sh.AnyDimPoint(coords), jax_any_dim_point(coords)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_math_modules_match_the_jax_forms():
    """Every re-exported closed form on the same inputs as the JAX
    package's, at f64."""
    import torch
    import jax.numpy as jnp

    from glimslib_tpu.simulation_helpers import math_linear_elasticity as jax_mle
    from glimslib_tpu_torch.simulation_helpers import math_linear_elasticity as mle

    rng = np.random.default_rng(0)
    grad_u = 0.1 * rng.standard_normal((5, 2, 2))
    u = rng.standard_normal((7, 2))
    t, j = torch.as_tensor, jnp.asarray
    np.testing.assert_allclose(mle.u_norm(t(u)).numpy(), np.asarray(jax_mle.u_norm(j(u))),
                               rtol=1e-15)
    strain, strain_j = mle.compute_strain(t(grad_u)), jax_mle.compute_strain(j(grad_u))
    np.testing.assert_allclose(strain.numpy(), np.asarray(strain_j), rtol=1e-14)
    stress = mle.compute_stress(strain, 0.3, 1.2)
    stress_j = jax_mle.compute_stress(strain_j, 0.3, 1.2)
    np.testing.assert_allclose(stress.numpy(), np.asarray(stress_j), rtol=1e-14, atol=1e-16)
    np.testing.assert_allclose(mle.compute_van_mises_stress(stress, 2).numpy(),
                               np.asarray(jax_mle.compute_van_mises_stress(stress_j, 2)),
                               rtol=1e-13)
    np.testing.assert_allclose(mle.compute_total_jacobian(t(grad_u)).numpy(),
                               np.asarray(jax_mle.compute_total_jacobian(j(grad_u))),
                               rtol=1e-14)
    assert float(mle.compute_lambda(1.0, 0.25)) == pytest.approx(
        float(jax_mle.compute_lambda(1.0, 0.25)), rel=1e-15)
