"""Reference-compatible module path for ``glimslib/simulation/
simulation_tumor_growth_brain.py``."""

from glimslib_tpu_torch.models.tumor_growth_brain import TumorGrowthBrain  # noqa: F401
