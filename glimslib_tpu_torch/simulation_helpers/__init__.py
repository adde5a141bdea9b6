"""Reference-compatible module path: ``glimslib.simulation_helpers`` ->
``glimslib_tpu_torch.simulation_helpers`` (counterpart of
``glimslib_tpu/simulation_helpers/``).

Re-exports the helper classes under their reference names
(helper_classes.py) so migration from the reference is mechanical.
``Plotting`` imports no matplotlib until it draws, so this package
imports where matplotlib is absent."""

from glimslib_tpu_torch.core.bcs import BoundaryConditions, DirichletBC
from glimslib_tpu_torch.core.functionspace import FunctionSpace, SubSpaces
from glimslib_tpu_torch.core.params import Parameters, TissueCoefficient
from glimslib_tpu_torch.core.results import (
    Results,
    TimeSeriesData,
    TimeSeriesDataTimePoint,
    TimeSeriesMultiData,
)
from glimslib_tpu_torch.core.subdomains import SubDomains
from glimslib_tpu_torch.postprocess import (
    Comparison,
    PostProcess,
    PostProcessTumorGrowth,
    PostProcessTumorGrowthBrain,
)
from glimslib_tpu_torch.visualisation.plotting import Plotting

# the reference's DiscontinuousScalar (helper_classes.py:47-58): per-tissue
# coefficient dispatch — here a differentiable lookup-by-label gather
DiscontinuousScalar = TissueCoefficient


def AnyDimPoint(coords):
    """Dimension-agnostic point constructor (reference AnyDimPoint,
    helper_classes.py:23-45): here simply a float array of any length."""
    import numpy as np

    return np.asarray(coords, dtype=np.float64)

from glimslib_tpu_torch.simulation_helpers import math_linear_elasticity  # noqa: E402
from glimslib_tpu_torch.simulation_helpers import math_reaction_diffusion  # noqa: E402

__all__ = [
    "BoundaryConditions",
    "DirichletBC",
    "FunctionSpace",
    "SubSpaces",
    "Parameters",
    "TissueCoefficient",
    "DiscontinuousScalar",
    "Results",
    "TimeSeriesData",
    "TimeSeriesDataTimePoint",
    "TimeSeriesMultiData",
    "SubDomains",
    "Comparison",
    "PostProcess",
    "PostProcessTumorGrowth",
    "PostProcessTumorGrowthBrain",
    "Plotting",
    "math_linear_elasticity",
    "math_reaction_diffusion",
]
