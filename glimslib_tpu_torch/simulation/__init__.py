"""Reference-compatible module path: ``glimslib.simulation`` ->
``glimslib_tpu_torch.simulation`` (counterpart of
``glimslib_tpu/simulation/``; the models live in
:mod:`glimslib_tpu_torch.models`)."""

from glimslib_tpu_torch import config
from glimslib_tpu_torch.models.base import Simulation as FenicsSimulation
from glimslib_tpu_torch.models.tumor_growth import TumorGrowth
from glimslib_tpu_torch.models.tumor_growth_brain import TumorGrowthBrain

__all__ = ["config", "FenicsSimulation", "TumorGrowth", "TumorGrowthBrain"]
