"""Reference-compatible module path for ``glimslib/simulation/
simulation_base.py``."""

from glimslib_tpu_torch.models.base import Simulation as FenicsSimulation  # noqa: F401
